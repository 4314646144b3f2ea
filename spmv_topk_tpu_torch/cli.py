"""Command-line benchmark entry point.

The analog of the reference hosts' CLI (``struct Options``, the
reference's options.hpp:37-133) and their main benchmark
loop (host_spmv_bscsr.cpp:510-707), with the JAX package's flags
(``spmv_topk_tpu/cli.py``):

  python -m spmv_topk_tpu_torch -m data/matrix.mtx -k 100 -t 30
  python -m spmv_topk_tpu_torch --synthetic 1000000 1024 20 gamma --codec i8s
  python -m spmv_topk_tpu_torch --synthetic 2000 256 8 gamma --device cpu

Flags follow the reference where meaningful: -m matrix, -k top-k
(default 20, options.hpp:28), -t num tests (default 3), -d debug prints,
-v ignore matrix values (pattern treatment). FPGA-only flags (xclbin,
block/grid size) are replaced by the engine's knobs (--codec,
--fused-layout, --width-quantum, --fold-tile, --lane-k). --device picks
the torch device: ``cuda`` (the default) runs the CUDA kernels, ``cpu``
their plain PyTorch versions; there is no fallback from one to the other.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(prog="spmv_topk_tpu_torch")
    ap.add_argument("-m", "--matrix", help="MTX file path")
    ap.add_argument("--synthetic", nargs=4, metavar=("ROWS", "COLS", "DEG", "DIST"),
                    help="generate a synthetic matrix instead of -m")
    ap.add_argument("-k", type=int, default=20)
    ap.add_argument("-t", "--num-tests", type=int, default=3)
    ap.add_argument("-d", "--debug", action="store_true")
    ap.add_argument("-v", "--ignore-values", action="store_true",
                    help="treat the matrix as pattern (all values 1)")
    ap.add_argument("--codec", default="f32",
                    choices=["f32", "int8x4", "i8s", "i4s", "h16"])
    ap.add_argument("--autotune", action="store_true",
                    help="measure codec candidates on a corpus sample and "
                         "use the fastest config meeting --target-precision "
                         "(overrides --codec/--rescore-pool)")
    ap.add_argument("--target-precision", type=float, default=0.98)
    ap.add_argument("--lane-k", type=int, default=8)
    ap.add_argument("--fused-layout", default="slice",
                    choices=["slice", "octet"],
                    help="fused stream word order (octet = slice-"
                         "transposed, the headline layout; pair with "
                         "--width-quantum 2)")
    ap.add_argument("--width-quantum", type=int, default=8,
                    choices=[1, 2, 4, 8],
                    help="slice-width granularity (finer = less padding)")
    ap.add_argument("--fold-tile", type=int, default=1,
                    choices=[1, 2, 4, 8],
                    help="slices per Top-K fold (8 = production strided "
                         "fold; pair with --rescore-pool)")
    ap.add_argument("--rescore-pool", type=int, default=None,
                    help="exact host CSR re-ranking of the top-N device "
                         "candidates (restores ~exact ranking for the "
                         "quantized codecs; try 4-8x k)")
    ap.add_argument("--engine", default="sparse",
                    choices=["sparse", "dense"],
                    help="dense = bf16 cuBLAS products + a per-block "
                         "top-k (batched serving; requires the dense form "
                         "to fit the card)")
    ap.add_argument("--mesh", action="store_true",
                    help="shard across every visible CUDA device (with "
                         "--device cpu: one CPU shard)")
    ap.add_argument("--csv", help="write the per-iteration CSV here")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (the CUDA kernels) or cpu "
                         "(their plain versions)")
    args = ap.parse_args(argv)

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda needs a visible CUDA device (pass "
                 "--device cpu to run the kernels' plain versions)")

    from .api import TopKSpMV
    from .bench.harness import run_benchmark
    from .config import TopKSpMVConfig
    from .formats import create_sparse_matrix, read_mtx

    if args.synthetic:
        rows, cols, deg, dist = args.synthetic
        coo = create_sparse_matrix(int(rows), int(cols), int(deg), dist, seed=1)
    elif args.matrix:
        coo = read_mtx(args.matrix, read_values=not args.ignore_values)
    else:
        ap.error("provide -m or --synthetic")

    if args.autotune:
        from .tune import autotune

        cfg, report = autotune(coo, k=args.k,
                               target_precision=args.target_precision,
                               device=device)
        if args.debug:
            for r in report:
                print(r)
        print(f"autotune: codec={cfg.query_codec} "
              f"layout={cfg.fused_layout} quantum={cfg.width_quantum} "
              f"fold_tile={cfg.fold_tile} rescore_pool={cfg.rescore_pool}")
    else:
        cfg = TopKSpMVConfig(
            k=args.k, lane_k=args.lane_k,
            query_codec=args.codec,
            fused_layout=args.fused_layout,
            width_quantum=args.width_quantum,
            fold_tile=args.fold_tile,
            max_cols=max(128, -(-coo.num_cols // 128) * 128),
            # pattern matrices (-v: all values 1) are tie-heavy: keep the
            # reference's exact first-of-ties argmin semantics for them
            tie_safe_topk=args.ignore_values,
            rescore_pool=args.rescore_pool,
        )
    mesh = None
    if args.mesh:
        from .parallel import make_mesh

        mesh = make_mesh() if device.type == "cuda" else make_mesh([device])
    if args.engine == "dense":
        from .ops.dense import DenseTopKSpMV
        from .parallel.sharded_dense import ShardedDenseTopKSpMV

        engine = (ShardedDenseTopKSpMV(coo, cfg, mesh=mesh) if args.mesh
                  else DenseTopKSpMV(coo, cfg, device=device))
    elif args.mesh:
        from .parallel.sharded_buckets import ShardedBucketedTopKSpMV

        engine = ShardedBucketedTopKSpMV(coo, cfg, mesh=mesh)
    else:
        engine = TopKSpMV(coo, cfg, device=device)

    res = run_benchmark(engine, coo, num_tests=args.num_tests, k=args.k,
                        debug=args.debug)
    if args.csv:
        with open(args.csv, "w") as f:
            f.write(res.csv)
    print(
        f"exec {res.mean_exec_ms:.3f} +- {res.std_exec_ms:.3f} ms; "
        f"precision {res.mean_precision:.4f}; "
        f"{res.nnz_per_sec / 1e9:.2f} GNNZ/s over {coo.nnz} nnz"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
