"""Ranking-quality metrics and benchmark statistics.

The metrics of ``spmv_topk_tpu.eval.metrics``, carried over; they
re-implement the reference design's evaluation suite:
  - precision = |intersection| / K (host_spmv_bscsr.cpp:646-648)
  - NDCG with linear relevance DIM - i
    (normalized_discounted_cumulative_gain, evaluation_utils.hpp:112-148)
  - bounded NDCG / edit distance / positional errors @ bounds
    (evaluation_utils.hpp:153-269)
  - Kendall tau (plot_errors.py:304-331 uses scipy.stats.kendalltau)
  - mean / st_dev with warm-up skip (evaluation_utils.hpp:274-297)
"""

from __future__ import annotations

import numpy as np


def precision_at_k(golden, test) -> float:
    golden = list(np.asarray(golden).tolist())
    test = list(np.asarray(test).tolist())
    k = len(golden)
    return len(set(golden) & set(test)) / k if k else 1.0


def ndcg(golden, test) -> float:
    """Exact formula of evaluation_utils.hpp:112-148: relevance of the i-th
    golden item is DIM - i; test relevance is looked up by item; both are
    discounted by log2(|golden_rel - DIM| + 2)."""
    golden = np.asarray(golden)
    test = np.asarray(test)
    dim = len(golden)
    rank = {int(v): dim - i for i, v in enumerate(test)}
    dcg = idcg = 0.0
    for i, v in enumerate(golden):
        golden_rel = dim - i
        test_rel = rank.get(int(v), 0)
        disc = np.log2(abs(golden_rel - dim) + 2)
        dcg += test_rel / disc
        idcg += golden_rel / disc
    return dcg / idcg if idcg else 1.0


def kendall_tau(golden, test) -> float:
    """Kendall rank correlation over the union of both lists, items absent
    from a list ranked last (the convention of plot_errors.py:304-331)."""
    from scipy.stats import kendalltau

    golden = list(np.asarray(golden).tolist())
    test = list(np.asarray(test).tolist())
    items = sorted(set(golden) | set(test))
    n = len(items)
    g_rank = {v: i for i, v in enumerate(golden)}
    t_rank = {v: i for i, v in enumerate(test)}
    g = [g_rank.get(v, n) for v in items]
    t = [t_rank.get(v, n) for v in items]
    tau = kendalltau(g, t).statistic
    return float(tau) if tau == tau else 1.0


def edit_distance(golden, test) -> int:
    """Levenshtein distance over index sequences (evaluation_utils.hpp:186-200)."""
    s1 = list(np.asarray(golden).tolist())
    s2 = list(np.asarray(test).tolist())
    prev = list(range(len(s2) + 1))
    for i, a in enumerate(s1, 1):
        cur = [i]
        for j, b in enumerate(s2, 1):
            cur.append(min(prev[j] + 1, cur[-1] + 1, prev[j - 1] + (a != b)))
        prev = cur
    return prev[-1]


def count_positional_errors(golden, test) -> int:
    """Positions where the two rankings disagree (evaluation_utils.hpp:239-269)."""
    golden = np.asarray(golden)
    test = np.asarray(test)
    return int(np.sum(golden != test[: len(golden)]))


def bounded(metric, golden, test, bounds=(10, 20, 50)):
    """Apply a metric at several cut-offs (evaluation_utils.hpp:153-237)."""
    out = []
    for b in bounds:
        if b > len(golden):
            break
        out.append(metric(golden[:b], test[:b]))
    return out


def mean(values, skip: int = 2) -> float:
    """Mean with warm-up skip (evaluation_utils.hpp:274-283)."""
    v = np.asarray(values, dtype=np.float64)
    v = v[min(skip, max(len(v) - 1, 0)):]
    return float(v.mean()) if len(v) else float("nan")


def st_dev(values, skip: int = 2) -> float:
    """Population standard deviation with warm-up skip
    (evaluation_utils.hpp:286-297)."""
    v = np.asarray(values, dtype=np.float64)
    v = v[min(skip, max(len(v) - 1, 0)):]
    return float(v.std()) if len(v) else float("nan")
