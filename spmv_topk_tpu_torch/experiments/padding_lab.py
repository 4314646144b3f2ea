"""Padding decomposition of the h16 fused stream (host arithmetic only).

The counterpart of experiments/padding_lab.py: breaks the packed h16
stream's words per nnz (degree-20 gamma corpus, seed 1, quantum-2 widths
in 1024-row blocks) into its sources, from the corpus degree profile. The
h16 floor is 0.5 words/nnz (2 nnz per 32-bit word):

    word_floor       odd-degree rows: a row with odd degree leaves its
                     last word half empty (halves belong to one row)
    slice_max        + the widest of a slice's 128 rows (sigma-sort makes
                     this near the floor)
    ladder           + width quantization (``_quantize_w``): the biggest
                     reducible term
    promoted         + merging narrow runs into wider ones under the
                     padding budget (budget_frac of the packed rows)
    stream           + block geometry: in-block remainders
                     (block_remainder) and last-block tails (block_tails)
    buckets          the bucket count after promotion

``decompose`` runs on the host and gives the JAX function's numbers, for
the same arguments, number for number; the port's packer
(``formats/sell_buckets.py``) is the JAX packer's.

    python -m spmv_topk_tpu_torch.experiments.padding_lab [--rows N]
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from ..config import LANES
from ..formats.sell_buckets import _quantize_w

GAMMA_K = 3
# (quantum, budget_frac) of each decomposition main() prints
CASES = ((2, 0.01), (1, 0.01), (1, 0.005))


def decompose(num_rows=10_000_000, avg=20, quantum=2, budget_frac=0.01,
              tgt=1024, seed=1):
    rng = np.random.default_rng(seed)
    deg = np.maximum(rng.gamma(GAMMA_K, avg / GAMMA_K, num_rows)
                     .astype(np.int64), 1)
    deg = np.minimum(deg, 1024)
    nnz = deg.sum()
    halfnnz = nnz / 2
    wdeg = -(-deg // 2)

    def wpn(subl):  # words per nnz
        return subl * LANES / halfnnz * 0.5

    out = {"word_floor": wdeg.sum() / halfnnz * 0.5}
    perm = np.argsort(-wdeg, kind="stable")
    ns = -(-num_rows // LANES)
    wp = np.concatenate([wdeg[perm],
                         np.zeros(ns * LANES - num_rows, np.int64)])
    sw = wp.reshape(ns, LANES).max(axis=1)
    out["slice_max"] = wpn(sw.sum())

    swq = np.array([_quantize_w(int(w), quantum)
                    for w in np.maximum(-(-sw // quantum) * quantum,
                                        quantum)], np.int64)
    out["ladder"] = wpn(swq.sum())

    budget = max(16, int(swq.sum() * budget_frac))
    sw2 = swq.copy()
    i, cur, n = 0, None, len(sw2)
    while i < n:
        j = i
        w = int(sw2[i])
        while j < n and sw2[j] == w:
            j += 1
        cost = (j - i) * (cur - w) if cur is not None else None
        if cost is not None and cost <= budget:
            sw2[i:j] = cur
            budget -= cost
        else:
            cur = w
        i = j
    out["promoted"] = wpn(sw2.sum())

    tot = rem = tails = 0
    i = buckets = 0
    while i < n:
        j = i
        w = int(sw2[i])
        while j < n and sw2[j] == w:
            j += 1
        nsl = j - i
        buckets += 1
        if w <= tgt:
            spb = tgt // w
            nb = -(-nsl // spb)
            tot += nb * tgt
            rem += nb * (tgt - spb * w)
            tails += (nb * spb - nsl) * w
        else:
            bps = -(-w // tgt)
            tot += nsl * bps * tgt
            rem += nsl * (bps * tgt - w)
        i = j
    out["stream"] = wpn(tot)
    out["block_remainder"] = wpn(rem)
    out["block_tails"] = wpn(tails)
    out["buckets"] = buckets
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=10_000_000,
                    help="corpus rows (default %(default)s)")
    args = ap.parse_args(argv)
    results = []
    for quantum, frac in CASES:
        d = decompose(args.rows, quantum=quantum, budget_frac=frac)
        results.append(dict(rows=args.rows, quantum=quantum,
                            budget_frac=frac,
                            **{k: (float(v) if isinstance(v, float)
                                   else int(v)) for k, v in d.items()}))
        print(json.dumps(results[-1]), flush=True)
    return results


if __name__ == "__main__":
    main()
