"""Multi-host corpus sharding (run one process per host).

  COORDINATOR_ADDRESS=host0:1234 NUM_PROCESSES=2 PROCESS_ID=<i> \\
      python -m spmv_topk_tpu_torch.examples.multihost

Each process packs only the rows of its own devices of the global mesh.
On a single machine this still runs (one process, every local card; with
--device cpu one CPU shard).
"""

import argparse
import sys

import torch

import spmv_topk_tpu_torch as pt
from spmv_topk_tpu_torch.formats import create_sample_vector, create_sparse_matrix
from spmv_topk_tpu_torch.parallel import (global_mesh, initialize_multihost,
                                          local_shard_rows)
from spmv_topk_tpu_torch.parallel.sharded_buckets import ShardedBucketedTopKSpMV


def main(rows: int = 1_000_000, device="cuda") -> int:
    device = torch.device(device)
    # no-op without COORDINATOR_ADDRESS (gloo on the CPU, NCCL on cards)
    initialize_multihost(device_type=device.type)
    mesh = global_mesh(None if device.type == "cuda" else [device])
    print("mesh devices:", len(mesh))

    # every process generates the same corpus from its seed and keeps its
    # own rows
    corpus = create_sparse_matrix(rows, 1024, 20, "gamma", seed=0)
    lo, hi = local_shard_rows(rows, mesh)
    engine = ShardedBucketedTopKSpMV(corpus.row_slice(lo, hi),
                                     pt.TopKSpMVConfig(k=100), mesh=mesh,
                                     local_rows=(lo, rows))
    idx, vals = engine.query(create_sample_vector(1024, seed=1))
    print("top-5:", idx[:5].cpu().numpy(), vals[:5].cpu().numpy())
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    sys.exit(main(args.rows, args.device))
