"""A/B: width_quantum 1 vs 2 on the card.

The counterpart of experiments/q1_ab.py. The padding arithmetic
(``padding_lab``) projects fewer words per nnz at quantum 1; this driver
measures the h16 slice engine's sweeps at both quanta on one corpus: the
single-query sweep (K7) and the batch sweep in groups of 32 (K8), their
padding and bucket counts, the first runs' time (the kernels' library
loaded), and a precision@100 spot check of ``query()`` against the exact
top-100.

    python -m spmv_topk_tpu_torch.experiments.q1_ab [--rows N] [--device cpu]
"""

from __future__ import annotations

import numpy as np

from . import _drivers as D

QB = 32                       # queries a batch group
SINGLE = (4, 304, 7)          # short, long, reps of the single-query slope
BATCH = (2, 12, 5)            # short, long (groups), reps of the batch slope


def build(coo, quantum, device="cuda"):
    cfg = D.h16_config(width_quantum=quantum, fused_block_sublanes=1024,
                       fold_tile=8, rescore_pool=400)
    eng, pack_s = D.build(coo, cfg, device)
    return eng, cfg, pack_s


def measure(coo, quantum, device="cuda"):
    eng, cfg, pack_s = build(coo, quantum, device)
    s_short, s_long, s_reps = SINGLE
    b_short, b_long, b_reps = BATCH
    single = D.single_runner(eng, D.query_tables(eng, s_long, seed=2))
    batch = D.batch_runner(eng, D.group_tables(eng, QB, b_long, seed=4))
    warm_s = D.warm(single, s_short, s_long) + D.warm(batch, b_short, b_long)
    per_q = float(np.median(D.slopes(dict(s=single), s_short, s_long,
                                     s_reps)["s"]))
    per_qb = float(np.median(D.slopes(dict(b=batch), b_short, b_long,
                                      b_reps)["b"])) / QB
    return D.emit(dict(
        lab="q1_ab", quantum=quantum, rows=coo.num_rows, nnz=coo.nnz,
        padding=eng.fused.padding_ratio, buckets=len(eng.fused.plan),
        pack_s=pack_s, warm_s=warm_s, single_ms=per_q * 1e3,
        single_gnnz_per_sec=coo.nnz / per_q / 1e9,
        batch_queries=QB, batch_ms_per_query=per_qb * 1e3,
        batch_gnnz_per_sec_per_query=coo.nnz / per_qb / 1e9,
        precision_at_100=D.precision_at_100(eng, coo, seed=3),
        device=D.device_name(eng.device)))


def main(argv=None):
    args = D.parse_args(argv, __doc__, 1_000_000)
    coo = D.corpus(args.rows)
    return [measure(coo, quantum, args.device) for quantum in (2, 1)]


if __name__ == "__main__":
    main()
