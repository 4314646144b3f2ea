"""Quickstart: build an engine from a synthetic corpus and query it.

  python -m spmv_topk_tpu_torch.examples.quickstart [--rows N] [--device cpu]
"""

import argparse
import os
import sys
import tempfile

import numpy as np

import spmv_topk_tpu_torch as pt
from spmv_topk_tpu_torch.formats import create_sample_vector, create_sparse_matrix


def _top5(t):
    return t[:5].cpu().numpy()


def main(rows: int = 1_000_000, device="cuda") -> int:
    # `rows` sparse embeddings, 1024 dims, ~20 nnz each (gamma-skewed
    # degrees)
    corpus = create_sparse_matrix(rows, 1024, 20, "gamma", seed=0)

    # Build once: packs the stream on the host and leaves it resident on
    # the device.
    engine = pt.TopKSpMV(corpus, pt.TopKSpMVConfig(k=100), device=device)

    # Query many times (the reference's reset() loop, for free).
    for i in range(3):
        q = create_sample_vector(1024, seed=i)
        idx, vals = engine.query(q)
        print(f"query {i}: top-5 rows {_top5(idx)} "
              f"scores {_top5(vals).round(4)}")

    # Batched queries share each read of the stream (a multi-query sweep).
    batch = np.stack([create_sample_vector(1024, seed=10 + i)
                      for i in range(16)])
    idx, vals = engine.query_batch(batch)
    print("batch:", tuple(idx.shape))

    # Not sure which codec/config? Let the library measure it on a sample:
    #   cfg, report = pt.autotune(corpus, k=100, target_precision=0.98)
    #   engine = pt.TopKSpMV(corpus, cfg, device="cuda")

    # Fast mode: the h16 codec packs 2 nnz per word (half the bytes of the
    # one-nnz codecs); the rescore pool re-ranks the top-400 candidates
    # with exact f32 dot products on the host CSR, so the served top-k is
    # exact in practice.
    fast = pt.TopKSpMV(corpus, pt.TopKSpMVConfig(
        k=100, query_codec="h16", width_quantum=4, rescore_pool=400),
        device=device)
    q0 = create_sample_vector(1024, seed=0)
    print("fast top-5:", _top5(fast.query(q0)[0]))

    # Persist the packed engine: serving restarts skip the re-pack. (A
    # load()ed engine has no host CSR, so query it with rescore_pool=0 or
    # pass matrix= to rescore.)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "corpus_packed.npz")
        fast.save(path)
        reloaded = pt.TopKSpMV.load(path, device=device)
    print("reloaded top-5:", _top5(reloaded.query(q0, rescore_pool=0)[0]))

    # Batched serving when the dense form fits the device (2 bytes an
    # entry in bf16): dense products and a per-block top-k.
    dense = pt.DenseTopKSpMV(corpus, pt.TopKSpMVConfig(k=100), device=device)
    idx, vals = dense.query_batch(batch)
    print("dense batch:", tuple(idx.shape))
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    sys.exit(main(args.rows, args.device))
