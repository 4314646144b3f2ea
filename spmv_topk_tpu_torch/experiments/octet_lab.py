"""Octet (slice-transposed) layout A/B against the slice layout.

The counterpart of experiments/octet_lab.py on the card. The octet layout
(``formats/sell_buckets.fuse_buckets_octet``: chunk j holds word j of
eight strided slices) streams any width in whole chunks, so quantum-1
widths cost no split; this driver measures the single-query sweep's
slope (Gnnz/s) of

  slice-q2   the h16 slice engine, quantum 2, fold 8 (K7)
  octet-q2   the same widths, transposed stream (K1)
  octet-q1   quantum-1 widths (K1)

and with ``--batch`` the batch sweep of slice-q2 (K8) and octet-q2 (K6)
in groups of 16, 32 and 64 (``--only slice|octet`` keeps one layout).

    python -m spmv_topk_tpu_torch.experiments.octet_lab [--rows N]
        [--reps R] [--batch] [--only LAYOUT] [--device cpu]

(The JAX lab's LAB_ROWS, LAB_REPS, LAB_BATCH and LAB_ONLY are the flags
here.)
"""

from __future__ import annotations

from . import _drivers as D

COLS = D.COLS
DEG = D.DEG
SINGLE = (4, 104)             # short, long queries of a single slope
BATCH_GROUPS = (2, 12)        # short, long groups of a batch slope
BATCH_QS = (16, 32, 64)
SINGLE_VARIANTS = (("slice-q2", "slice", 2), ("octet-q2", "octet", 2),
                   ("octet-q1", "octet", 1))
BATCH_VARIANTS = (("slice-q2", "slice"), ("octet-q2", "octet"))


def base_config(layout, quantum):
    return D.h16_config(num_partitions=1, fused_layout=layout,
                        width_quantum=quantum, fused_block_sublanes=1024,
                        fold_tile=8, rescore_pool=400)


def make_runner(eng, n_queries):
    """run_n over n_queries single-query tables (seed 2)."""
    return D.single_runner(eng, D.query_tables(eng, n_queries, seed=2))


def make_batch_runner(eng, n_groups, Q):
    """run_n over n_groups groups of Q queries' tables (seed 4)."""
    return D.batch_runner(eng, D.group_tables(eng, Q, n_groups, seed=4))


def measure_batch(name, eng, nnz, Q, reps=7):
    short, long_ = BATCH_GROUPS
    run_n = make_batch_runner(eng, long_, Q)
    warm_s = D.warm(run_n, short, long_)
    slopes = sorted(s / Q for s in D.slopes(dict(r=run_n), short, long_,
                                            reps)["r"])
    per_query = slopes[len(slopes) // 2]
    return D.emit(dict(lab="octet_lab", variant=f"batch-{name}", Q=Q,
                       ms_per_query=per_query * 1e3,
                       gnnz_per_sec_per_query=nnz / per_query / 1e9,
                       warm_s=warm_s, device=D.device_name(eng.device)))


def measure(name, eng, nnz, reps=7):
    short, long_ = SINGLE
    run_n = make_runner(eng, long_)
    warm_s = D.warm(run_n, short, long_)
    slopes = sorted(D.slopes(dict(r=run_n), short, long_, reps)["r"])
    per_query = slopes[len(slopes) // 2]
    return D.emit(dict(lab="octet_lab", variant=name,
                       ms_per_query=per_query * 1e3,
                       gnnz_per_sec=nnz / per_query / 1e9,
                       words_per_nnz=eng.bytes_per_nnz / 4, warm_s=warm_s,
                       device=D.device_name(eng.device)))


def _flags(ap):
    ap.add_argument("--reps", type=int, default=7,
                    help="slopes a median is taken of (default %(default)s)")
    ap.add_argument("--batch", action="store_true",
                    help="time the batch sweeps instead")
    ap.add_argument("--only", default="",
                    help="batch mode: the layouts whose name holds this")


def main(argv=None):
    args = D.parse_args(argv, __doc__, 2_000_000, _flags)
    coo = D.corpus(args.rows)
    nnz = coo.nnz
    out = [D.emit(dict(lab="octet_lab", rows=args.rows, cols=COLS, deg=DEG,
                       nnz=nnz, device=D.device_name(args.device)))]
    if args.batch:
        res = {}
        for name, layout in BATCH_VARIANTS:
            if args.only and args.only not in layout:
                continue
            eng, _ = D.build(coo, base_config(layout, 2), args.device)
            for Q in BATCH_QS:
                r = measure_batch(name, eng, nnz, Q, args.reps)
                res[f"{name}/Q{Q}"] = r["gnnz_per_sec_per_query"]
                out.append(r)
            del eng
        for Q in BATCH_QS:
            s, o = res.get(f"slice-q2/Q{Q}"), res.get(f"octet-q2/Q{Q}")
            if s and o:
                out.append(D.emit(dict(lab="octet_lab", Q=Q,
                                       octet_vs_slice=o / s)))
        return out
    res = {}
    for name, layout, q in SINGLE_VARIANTS:
        eng, pack_s = D.build(coo, base_config(layout, q), args.device)
        out.append(D.emit(dict(lab="octet_lab", variant=name, pack_s=pack_s,
                               **D.geometry(eng))))
        r = measure(name, eng, nnz, args.reps)
        res[name] = r["gnnz_per_sec"]
        out.append(r)
        del eng
    s = res.get("slice-q2")
    for name, g in res.items():
        if s and name != "slice-q2":
            out.append(D.emit(dict(lab="octet_lab", variant=name,
                                   vs_slice_q2=g / s)))
    return out


if __name__ == "__main__":
    main()
