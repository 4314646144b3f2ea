"""Octet single-query sweep: one launch per bucket vs the one-launch sweep.

The counterpart of experiments/octet_multicall_lab.py on the card. The
JAX lab compares the octet kernel's fused dispatch (one ``pallas_call``
carrying a predicate per bucket) with one ``pallas_call`` per bucket
merged by a per-lane top-K over the stacked candidates (JAX
``config.octet_multicall``). The port's K1 sweeps every bucket in one
launch and does not read ``octet_multicall``; its wrapper takes any rows
of the bucket plan, so the multicall arm here is K1 launched once a
bucket (that bucket's plan row and real count) and the B stacked
(lane_k, 128) buffers merged by ``ops.kernel.merge_lane_topk``: the JAX
lab's arm on the card, with no new kernel.

Correctness first, as the JAX lab checks it: per lane, the top 4
distinct scores of the two arms are equal (the buffers' other slots may
hold other members of a tie). Then interleaved slopes of both arms.

The JAX lab loads bench.py's cached 10M-row corpus and octet-q2 engine;
this one generates the same corpus (``--rows`` x 1024, degree 20, gamma,
seed 1) and packs that engine (h16, octet, quantum 2, fold 8, 1024-row
blocks, pool 400) in the run.

    python -m spmv_topk_tpu_torch.experiments.octet_multicall_lab [reps]
        [--rows N] [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import LANES
from ..ops.kernel import merge_lane_topk, topk_spmv_fused_octet_device
from . import _drivers as D

ROWS, COLS, DEG = 10_000_000, D.COLS, D.DEG
SHORT, LONG = 4, 304
DISTINCT = 4          # top distinct scores a lane compared


def corpus(rows=ROWS):
    return D.corpus(rows)


def multicall_candidates(eng, table):
    """K1 launched once a bucket (its plan row and real count), the B
    stacked buffers merged per lane: (lane_k, 128) values and tags."""
    cfg = eng.config
    outs = [topk_spmv_fused_octet_device(
        eng.words, table, eng.nreal[b:b + 1], eng.plan_rows[b:b + 1],
        cfg=cfg, block_sublanes=eng.fused.block_sublanes)
        for b in range(eng.plan_rows.shape[0])]
    return merge_lane_topk(torch.cat([v for v, _ in outs]),
                           torch.cat([t for _, t in outs]), cfg.lane_k)


def top_distinct(values, n=DISTINCT):
    """Per lane, the n largest distinct finite scores of a (lane_k, 128)
    buffer, as sorted lists."""
    v = values.cpu().numpy()
    return [sorted({float(x) for x in v[:, lane] if x > -1e30},
                   reverse=True)[:n] for lane in range(LANES)]


def runner(eng, n_queries, sweep):
    """run_n over n_queries single-query tables (seed 2) through
    ``sweep(table)``."""
    return D.single_runner(eng, D.query_tables(eng, n_queries, seed=2),
                           sweep)


def main(argv=None):
    args = D.parse_args(argv, __doc__, ROWS, lambda ap: ap.add_argument(
        "reps", nargs="?", type=int, default=5,
        help="interleaved slopes a median is taken of (default 5)"))
    coo = corpus(args.rows)
    nnz = coo.nnz
    cfg = D.h16_config(fused_layout="octet", width_quantum=2,
                       fused_block_sublanes=1024, fold_tile=8,
                       rescore_pool=400)
    eng, pack_s = D.build(coo, cfg, args.device)
    out = [D.emit(dict(lab="octet_multicall_lab", rows=args.rows, nnz=nnz,
                       pack_s=pack_s, **D.geometry(eng)))]

    arms = dict(onecall=eng.table_candidates,
                multicall=lambda t: multicall_candidates(eng, t))
    q = D.query_tables(eng, 1, seed=3)[0]
    tops = {name: top_distinct(sweep(q)[0]) for name, sweep in arms.items()}
    bad = [lane for lane in range(LANES)
           if tops["onecall"][lane] != tops["multicall"][lane]]
    if bad:
        raise SystemExit(f"octet_multicall_lab: the arms' top {DISTINCT} "
                         f"distinct scores differ in lanes {bad[:8]}")
    out.append(D.emit(dict(lab="octet_multicall_lab", correctness=(
        f"per-lane top-{DISTINCT} distinct scores identical ({LANES} "
        "lanes; other slots may differ only at score ties)"),
        launches_per_query=dict(onecall=1,
                                multicall=int(eng.plan_rows.shape[0])))))

    pairs = {}
    for name, sweep in arms.items():
        pairs[name] = runner(eng, LONG, sweep)
        out.append(D.emit(dict(lab="octet_multicall_lab", arm=name,
                               warm_s=D.warm(pairs[name], SHORT, LONG))))
    for n, slopes in D.slopes(pairs, SHORT, LONG, args.reps).items():
        per_q = float(np.median(slopes))
        out.append(D.emit(dict(lab="octet_multicall_lab", arm=n,
                               ms_per_query=per_q * 1e3,
                               gnnz_per_sec=nnz / per_q / 1e9,
                               reps_ms=[s * 1e3 for s in slopes],
                               device=D.device_name(args.device))))
    return out


if __name__ == "__main__":
    main()
