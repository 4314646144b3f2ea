"""Octet single-query sweep: block size and bucket count variants.

The counterpart of experiments/octet_block_lab.py on the card: the h16
octet engine's single-query sweep (K1) with larger blocks (fewer of
them) and coarser width quanta (fewer buckets), in interleaved slopes:

  octet-q1-b1024   the headline's widths at quantum 1 (control)
  octet-q1-b2048   half the blocks
  octet-q1-b4096   a quarter of the blocks
  octet-q2-b1024   about half the buckets (quantum-2 widths)
  octet-q4-b1024, octet-q8-b1024   fewer still

The JAX lab loads bench.py's cached 10M-row corpus and engines; this one
generates the same corpus (``--rows`` x 1024, degree 20, gamma, seed 1)
and packs each engine in the run.

    python -m spmv_topk_tpu_torch.experiments.octet_block_lab [variant ...]
        [--rows N] [--device cpu]
"""

from __future__ import annotations

import numpy as np

from . import _drivers as D

ROWS, COLS, DEG = 10_000_000, D.COLS, D.DEG
SHORT, LONG, REPS = 4, 304, 5

VARIANTS = {
    "octet-q1-b1024": dict(width_quantum=1, fused_block_sublanes=1024),
    "octet-q1-b2048": dict(width_quantum=1, fused_block_sublanes=2048),
    "octet-q1-b4096": dict(width_quantum=1, fused_block_sublanes=4096),
    "octet-q2-b1024": dict(width_quantum=2, fused_block_sublanes=1024),
    "octet-q4-b1024": dict(width_quantum=4, fused_block_sublanes=1024),
    "octet-q8-b1024": dict(width_quantum=8, fused_block_sublanes=1024),
}


def corpus(rows=ROWS):
    return D.corpus(rows)


def engine(coo, name, kw, device="cuda"):
    """(variant ``name``'s engine, seconds to pack and upload)."""
    cfg = D.h16_config(fused_layout="octet", fold_tile=8, **kw)
    return D.build(coo, cfg, device)


def runner(eng, n_queries):
    """run_n over n_queries single-query tables (seed 2)."""
    return D.single_runner(eng, D.query_tables(eng, n_queries, seed=2))


def main(argv=None):
    args = D.parse_args(argv, __doc__, ROWS, lambda ap: ap.add_argument(
        "variants", nargs="*", metavar="variant",
        help=f"of {list(VARIANTS)} (default all)"))
    names = args.variants or list(VARIANTS)
    unknown = sorted(set(names) - set(VARIANTS))
    if unknown:
        raise SystemExit(f"octet_block_lab: unknown variant(s) {unknown}; "
                         f"the variants are {list(VARIANTS)}")
    coo = corpus(args.rows)
    nnz = coo.nnz
    out = [D.emit(dict(lab="octet_block_lab", rows=args.rows, nnz=nnz))]
    engs, pairs = {}, {}
    for name in names:
        engs[name], pack_s = engine(coo, name, VARIANTS[name], args.device)
        pairs[name] = runner(engs[name], LONG)
        out.append(D.emit(dict(lab="octet_block_lab", variant=name,
                               pack_s=pack_s, **D.geometry(engs[name]),
                               warm_s=D.warm(pairs[name], SHORT, LONG))))
    # interleave reps across variants so the card's drift cancels
    for n, slopes in D.slopes(pairs, SHORT, LONG, REPS).items():
        per_q = float(np.median(slopes))
        out.append(D.emit(dict(lab="octet_block_lab", variant=n,
                               ms_per_query=per_q * 1e3,
                               gnnz_per_sec=nnz / per_q / 1e9,
                               device=D.device_name(args.device))))
    return out


if __name__ == "__main__":
    main()
