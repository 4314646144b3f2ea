"""One-command MTX search: parse -> autotune -> serve -> accuracy.

  python -m spmv_topk_tpu_torch.examples.mtx_search matrix.mtx [k] [--no-autotune]
  python -m spmv_topk_tpu_torch.examples.mtx_search --synthetic-glove [k]

The end-to-end flow of the reference benchmark hosts (readMtx ->
create_sample_vector -> SpMV -> gold check, host_spmv_bscsr.cpp:510-707)
as a library user would run it:

  1. parse the MTX file (native C++ parser when built, formats/mtx.py),
  2. autotune an engine config on a corpus sample (tune.autotune),
  3. build the matrix-resident engine and serve queries,
  4. report precision/NDCG against the exact CPU gold per query.

--synthetic-glove generates a GloVe-shaped corpus (2.2M x 300, ~25 nnz
per row — test_spmv_topk.py:28-32's real dataset geometry; --rows
changes its height) when no MTX file is at hand. --device cpu runs the
kernels' plain versions.
"""

import argparse
import os
import sys
import time

import numpy as np

import spmv_topk_tpu_torch as pt
from spmv_topk_tpu_torch.eval.metrics import ndcg, precision_at_k
from spmv_topk_tpu_torch.formats import (create_query_batch,
                                         create_sparse_matrix, read_mtx)
from spmv_topk_tpu_torch.ops.gold import topk_exact


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter,
        epilog=__doc__.split("\n", 2)[2])
    ap.add_argument("matrix", nargs="?", help="MTX file path")
    ap.add_argument("k", nargs="?", type=int, default=100)
    ap.add_argument("--no-autotune", action="store_true")
    ap.add_argument("--synthetic-glove", action="store_true")
    ap.add_argument("--rows", type=int, default=2_200_000,
                    help="rows of the --synthetic-glove corpus")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    k = args.k

    t0 = time.time()
    if args.synthetic_glove:
        print(f"generating a GloVe-shaped corpus ({args.rows} x 300, "
              "deg 25)...")
        corpus = create_sparse_matrix(args.rows, 300, 25, "gamma", seed=7)
        name = "synthetic-glove"
    else:
        if args.matrix is None or not os.path.exists(args.matrix):
            ap.print_help()
            return 2
        name = args.matrix
        corpus = read_mtx(name)
    parse_s = time.time() - t0
    print(f"{name}: {corpus.num_rows} x {corpus.num_cols}, "
          f"{corpus.nnz} nnz ({parse_s:.1f} s)")

    if args.no_autotune:
        cfg = pt.TopKSpMVConfig(k=k)
        print("config: defaults (f32 codec, slice layout)")
    else:
        t0 = time.time()
        cfg, report = pt.autotune(corpus, k=k, target_precision=0.98,
                                  device=args.device)
        print(f"autotune ({time.time() - t0:.1f} s): "
              f"codec={cfg.query_codec} layout={cfg.fused_layout} "
              f"quantum={cfg.width_quantum} fold_tile={cfg.fold_tile} "
              f"rescore_pool={cfg.rescore_pool}")

    t0 = time.time()
    engine = pt.TopKSpMV(corpus, cfg, device=args.device)
    print(f"packed in {time.time() - t0:.1f} s "
          f"({engine.bytes_per_nnz:.2f} B/nnz on device)")

    queries = create_query_batch(5, corpus.num_cols, seed=0)
    times, precs, ndcgs = [], [], []
    for i, q in enumerate(queries):
        t0 = time.time()
        idx, vals = engine.query(q)
        idx, vals = idx.cpu().numpy(), vals.cpu().numpy()
        times.append(time.time() - t0)
        gi, gv = topk_exact(corpus, q, k)
        precs.append(precision_at_k(gi, idx))
        ndcgs.append(ndcg(gi, idx))
        if i == 0:
            for r, v in list(zip(idx, vals))[:5]:
                print(f"  row {r:10d}  score {v:.6f}")
    # the first query may load (or build) the kernels' library; steady
    # state is the rest
    print(f"query wall: first {times[0] * 1e3:.1f} ms (incl. the kernels' "
          f"first load), then {np.mean(times[1:]) * 1e3:.2f} ms mean "
          "(host clock through the readback)")
    print(f"precision@{k} vs exact gold: {np.mean(precs):.4f}   "
          f"NDCG: {np.mean(ndcgs):.5f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
