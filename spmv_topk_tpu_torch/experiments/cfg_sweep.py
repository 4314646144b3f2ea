"""Pack-geometry sweep: quantum x block size x fold on the bench matrix.

The counterpart of experiments/cfg_sweep.py on the card. Separates the
effects of (a) width_quantum (2 vs 4: fewer padding bytes vs more work a
word), (b) fused_block_sublanes (512 vs 1024: smaller block tails vs more
blocks), (c) fold_tile, on the h16 slice engine's single-query sweep
(K7), each slope beside the stream floor of the same words (K3,
``ops/streamprobe.py``) timed in turns with it, so the card's drift
cancels in their ratio.

    python -m spmv_topk_tpu_torch.experiments.cfg_sweep [q,tgt[,tile] ...]
        [--rows N] [--device cpu]        e.g. 2,512 4,1024,8
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import LANES
from ..ops.streamprobe import stream_words_device
from ..utils.profiling import held_runner
from . import _drivers as D

CASES = ((2, 1024, 1), (2, 1024, 8))
SHORT, LONG, REPS = 4, 104, 9


def measure(coo, quantum, tgt, tile=1, device="cuda"):
    cfg = D.h16_config(width_quantum=quantum, fused_block_sublanes=tgt,
                       fold_tile=tile, rescore_pool=400)
    eng, pack_s = D.build(coo, cfg, device)
    sweep = D.single_runner(eng, D.query_tables(eng, LONG, seed=2))
    salts = torch.arange(LONG * LANES, dtype=torch.int32,
                         device=eng.device).reshape(LONG, 1, LANES)
    floor = held_runner(eng.device,
                        lambda i: stream_words_device(eng.words, salts[i]))
    warm_s = D.warm(sweep, SHORT, LONG) + D.warm(floor, SHORT, LONG)
    reps = D.slopes(dict(sweep=sweep, floor=floor), SHORT, LONG, REPS)
    per = float(np.median(reps["sweep"]))
    fl = float(np.median(reps["floor"]))
    ratio = float(np.median([f / k for k, f in zip(reps["sweep"],
                                                   reps["floor"])]))
    gb = eng.hbm_bytes / 1e9
    return D.emit(dict(
        lab="cfg_sweep", quantum=quantum, tgt=tgt, tile=tile,
        rows=coo.num_rows, nnz=coo.nnz, per_query_ms=per * 1e3,
        gnnz_per_sec=coo.nnz / per / 1e9, gbps=gb / per,
        floor_ms=fl * 1e3, floor_gbps=gb / fl, ratio=ratio,
        padding=eng.fused.padding_ratio, pack_s=pack_s, warm_s=warm_s,
        device=D.device_name(eng.device)))


def main(argv=None):
    args = D.parse_args(argv, __doc__, 1_000_000, lambda ap: ap.add_argument(
        "cases", nargs="*", metavar="q,tgt[,tile]",
        help="geometries to measure (default 2,1024,1 2,1024,8)"))
    cases = [tuple(int(x) for x in a.split(",")) for a in args.cases] \
        or CASES
    coo = D.corpus(args.rows)
    return [measure(coo, *case, device=args.device) for case in cases]


if __name__ == "__main__":
    main()
