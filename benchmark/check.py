"""The comparison that decides ``correct``.

A sample of the answers that the timed path served in the window, drawn
from the seed and spread evenly over it, is held against the plain
reference (``benchmark/reference``) in the precision the configuration
states. Three numbers, each with its limit from the cell's file
(``benchmark/cells/<workload>.json``):

- ``bad_answers``: sampled answers that are malformed (not k rows, a row
  outside the matrix or repeated, a value that is not finite, values not
  in descending order). Exact: its limit is 0.
- ``score_gap``: the widest gap between a served value and the
  reference's score of the served row, as a share of the query's best
  reference score. It catches a value computed in another precision, or
  a row id altered after its value was taken.
- ``rank_gap``: the widest gap by which a served row's reference score
  lies below the reference's k-th best score, as a share of the query's
  best score. It catches a row that does not belong in the top k.

Besides, every answer of the window is checked for its form
(``malformed``), and a request that raised counts as failed.
"""

from __future__ import annotations

import numpy as np

NUMBERS = ("bad_answers", "score_gap", "rank_gap")


def malformed(idx: np.ndarray, vals: np.ndarray, k: int,
              num_rows: int) -> np.ndarray:
    """(S,) bool: which of S answers, (S, k) rows and values, are not
    well formed."""
    idx = np.asarray(idx)
    vals = np.asarray(vals)
    if idx.ndim != 2 or idx.shape[1] != k or vals.shape != idx.shape:
        return np.ones(max(len(idx), 1), bool)
    bad = ((idx < 0) | (idx >= num_rows)).any(axis=1)
    bad |= ~np.isfinite(vals).all(axis=1)
    bad |= (np.diff(vals, axis=1) > 0).any(axis=1)
    srt = np.sort(idx, axis=1)
    bad |= (srt[:, 1:] == srt[:, :-1]).any(axis=1)
    return bad


def why_malformed(idx: np.ndarray, vals: np.ndarray, k: int,
                  num_rows: int) -> str:
    """What is wrong with one answer: (k,) rows and values."""
    idx, vals = np.asarray(idx), np.asarray(vals)
    if idx.shape != (k,) or vals.shape != (k,):
        return f"shapes {idx.shape} and {vals.shape}, not ({k},)"
    out = []
    off = idx[(idx < 0) | (idx >= num_rows)]
    if len(off):
        out.append(f"rows outside the matrix {off[:4].tolist()}")
    if not np.isfinite(vals).all():
        out.append(f"values not finite at {np.flatnonzero(~np.isfinite(vals))[:4].tolist()}")
    up = np.flatnonzero(np.diff(vals) > 0)
    if len(up):
        out.append(f"values rise at {up[:4].tolist()}")
    u, c = np.unique(idx, return_counts=True)
    for r in u[c > 1][:4]:
        at = np.flatnonzero(idx == r).tolist()
        out.append(f"row {int(r)} at {at} with values {vals[at].tolist()}")
    return "; ".join(out)


def sample_positions(total: int, count: int, seed: int) -> np.ndarray:
    """``min(count, total)`` positions among ``total`` answers, one drawn
    from the seed in each of as many equal strata (so spread evenly over
    the window)."""
    n = min(count, total)
    if n <= 0:
        return np.zeros(0, np.int64)
    rng = np.random.default_rng(seed)
    lo = (np.arange(n) * total) // n
    hi = (np.arange(1, n + 1) * total) // n
    return lo + (rng.random(n) * (hi - lo)).astype(np.int64)


def numbers(idx, vals, of_served, kth, best, k: int, num_rows: int) -> dict:
    """The compared numbers of S sampled answers: served rows ``idx`` and
    values ``vals`` (S, k); the reference's score of each served row
    ``of_served`` (S, k), k-th best ``kth`` and best ``best`` (S,)."""
    idx = np.asarray(idx)
    vals = np.asarray(vals, np.float64)
    bad = malformed(idx, vals, k, num_rows)
    out = {"bad_answers": int(bad.sum()), "score_gap": float("nan"),
           "rank_gap": float("nan")}
    good = ~bad
    if bad.size != len(idx) or not good.any():
        return out
    ref = np.asarray(of_served, np.float64)[good]
    scale = np.abs(np.asarray(best, np.float64)[good])[:, None]
    scale = np.where(scale > 0, scale, 1.0)
    out["score_gap"] = float((np.abs(vals[good] - ref) / scale).max())
    below = np.asarray(kth, np.float64)[good][:, None] - ref
    out["rank_gap"] = float((np.maximum(below, 0.0) / scale).max())
    return out


def verdict(nums: dict, limits: dict) -> tuple[bool, list[str]]:
    """(correct, one line per number: its name, value and limit)."""
    ok, lines = True, []
    for name in NUMBERS:
        v, lim = nums[name], limits[name]
        passed = v == v and v <= lim    # a nan never passes
        ok &= passed
        lines.append(f"{name} {v!r} limit {lim!r} "
                     f"{'ok' if passed else 'FAIL'}")
    return ok, lines


def precision_at(served: np.ndarray, exact: np.ndarray, k: int) -> float:
    """Mean over queries of |served top-k & exact top-k| / k."""
    hits = [len(set(s[:k].tolist()) & set(e[:k].tolist()))
            for s, e in zip(np.asarray(served), np.asarray(exact))]
    return float(np.mean(hits)) / k if hits else float("nan")
