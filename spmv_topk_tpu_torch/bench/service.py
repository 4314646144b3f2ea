"""End-to-end approximate-similarity serving loop.

BASELINE.json config 5: a corpus resident across the mesh, streaming query
batches, recall@10 / recall@100 against the exact oracle, and latency
percentiles. The reference has no serving loop — its `reset()` + rerun
benchmark (host_spmv_bscsr.cpp:602-615) is the single-query seed of this;
here it becomes a sustained loop with percentile tracking. A batch's
latency is the host clock from ``query_batch`` through the readback of its
indices (``.cpu()``, which waits for the card).

Usage:
  python -m spmv_topk_tpu_torch.bench.service --rows 1000000 --batches 20
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from ..api import TopKSpMV
from ..config import TopKSpMVConfig
from ..eval import metrics
from ..formats.synthetic import create_sparse_matrix, create_query_batch
from ..ops.gold import topk_exact
from .harness import _host


def run_service(
    engine,
    coo,
    num_batches: int = 20,
    batch_size: int = 8,
    k: int = 100,
    oracle_every: int = 4,
    seed: int = 0,
):
    """Stream query batches through `engine` (TopKSpMV or
    ShardedBucketedTopKSpMV); returns latency percentiles and recall
    measured on a subsample (the oracle is O(nnz) per query)."""
    latencies = []
    recalls_10, recalls_100 = [], []
    for b in range(num_batches):
        batch = create_query_batch(batch_size, coo.num_cols, seed=seed + b)
        t0 = time.perf_counter()
        idx, vals = engine.query_batch(batch, k=k)
        idx = _host(idx)
        latencies.append((time.perf_counter() - t0) / batch_size)
        if b % oracle_every == 0:
            gi, _ = topk_exact(coo, batch[0], k)
            recalls_100.append(metrics.precision_at_k(gi[:100], idx[0][:100]))
            recalls_10.append(metrics.precision_at_k(gi[:10], idx[0][:10]))
    lat = np.array(latencies[1:]) * 1e3  # drop warm-up batch
    return dict(
        p50_ms=float(np.percentile(lat, 50)),
        p90_ms=float(np.percentile(lat, 90)),
        p99_ms=float(np.percentile(lat, 99)),
        qps=float(1e3 / np.percentile(lat, 50)),
        recall_at_10=float(np.mean(recalls_10)),
        recall_at_100=float(np.mean(recalls_100)),
        num_queries=num_batches * batch_size,
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--cols", type=int, default=1024)
    ap.add_argument("--deg", type=int, default=20)
    ap.add_argument("--dist", default="gamma")
    ap.add_argument("--batches", type=int, default=20)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("-k", type=int, default=100)
    ap.add_argument("--codec", default="f32")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engine (cpu: the kernels' "
                         "plain versions)")
    args = ap.parse_args()

    coo = create_sparse_matrix(args.rows, args.cols, args.deg, args.dist, seed=1)
    cfg = TopKSpMVConfig(k=args.k, max_cols=max(args.cols, 128),
                         query_codec=args.codec)
    engine = TopKSpMV(coo, cfg, device=args.device)
    stats = run_service(engine, coo, args.batches, args.batch_size, args.k)
    print(json.dumps(stats))


if __name__ == "__main__":
    main()
