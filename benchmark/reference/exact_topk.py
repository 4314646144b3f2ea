"""The plain reference: Top-K rows of A @ q from the corpus's CSR.

Plain PyTorch (a sparse CSR times a dense block, float64), independent
of the program: it is handed the corpus's raw arrays and the raw f32
queries, and works out everything else itself, the precision the
configuration states included:

- ``values``: ``"f32"`` keeps the matrix values, ``"bf16"`` rounds each
  to bfloat16 (round to nearest even), as the configuration's
  ``value_format`` stores them;
- ``query``: ``"f32"`` keeps the query; ``"bf16"`` rounds it to bfloat16;
  ``"i8s"`` / ``"int8x4"`` quantize it symmetrically to integers in
  [-127, 127] with the scale max|q| / 127 in float32, ``"i4s"`` to
  [-7, 7] with max|q| / 7 (float32 quotients correctly rounded, round
  half to even), and multiply back.

Every product and sum is then taken in float64, so the scores are the
exact scores of the stated precision, and ``"f32"`` / ``"f32"`` gives the
exact float32 answer.
"""

from __future__ import annotations

import torch

QUERY_LEVELS = {"i8s": 127.0, "int8x4": 127.0, "i4s": 7.0}


def csr(indptr, cols, vals, num_rows: int, num_cols: int, values: str):
    """The corpus as a float64 CSR tensor, values in the stated precision."""
    if values == "bf16":
        v = vals.to(torch.bfloat16).to(torch.float64)
    elif values == "f32":
        v = vals.to(torch.float64)
    else:
        raise ValueError(f"no reference for matrix values {values!r}")
    return torch.sparse_csr_tensor(indptr.to(torch.int64),
                                   cols.to(torch.int64), v,
                                   size=(num_rows, num_cols),
                                   check_invariants=False)


def effective_query(q: torch.Tensor, query: str) -> torch.Tensor:
    """(S, C) float32 queries -> (S, C) float64 as the stated precision
    sees them."""
    q = q.to(torch.float32)
    if query == "f32":
        return q.to(torch.float64)
    if query == "bf16":
        return q.to(torch.bfloat16).to(torch.float64)
    if query in QUERY_LEVELS:
        lv = QUERY_LEVELS[query]
        # float32 quotients, correctly rounded: each taken in float64 and
        # rounded once to float32 (a device's float32 division by a
        # scalar may multiply by its reciprocal instead)
        scale = (q.abs().amax(dim=1, keepdim=True).double() / lv).float()
        scale = torch.where(scale == 0, torch.ones_like(scale), scale)
        x = (q.double() / scale.double()).float()
        qi = torch.round(x).clamp_(-lv, lv)                   # half to even
        return qi.to(torch.float64) * scale.to(torch.float64)
    raise ValueError(f"no reference for query precision {query!r}")


def scores(matrix, q_eff: torch.Tensor, block: int = 32):
    """Yield (start, (b, num_rows) float64 scores) for blocks of queries."""
    for s in range(0, q_eff.shape[0], block):
        qb = q_eff[s:s + block].to(matrix.device)
        yield s, (matrix @ qb.T.contiguous()).T.contiguous()


def topk(matrix, q_eff: torch.Tensor, k: int, block: int = 32):
    """Exact top-k of each query: (rows int64, scores float64), (S, k),
    scores descending."""
    rows, vals = [], []
    for _, sc in scores(matrix, q_eff, block):
        v, i = torch.topk(sc, k, dim=1)
        rows.append(i)
        vals.append(v)
    return torch.cat(rows), torch.cat(vals)


def judge_inputs(matrix, q_eff: torch.Tensor, served_rows: torch.Tensor,
                 k: int, block: int = 32):
    """What the comparison needs of each query, in the stated precision:
    the score of each served row (S, k) (rows outside the matrix score
    nan), the k-th best score (S,) and the best score (S,)."""
    n = matrix.shape[0]
    served_rows = served_rows.to(torch.int64)
    of_served, kth, best = [], [], []
    for s, sc in scores(matrix, q_eff, block):
        r = served_rows[s:s + sc.shape[0]].to(sc.device)
        ok = (r >= 0) & (r < n)
        got = torch.gather(sc, 1, r.clamp(0, n - 1))
        of_served.append(torch.where(ok, got, torch.full_like(got, float("nan"))))
        top = torch.topk(sc, k, dim=1).values
        kth.append(top[:, -1])
        best.append(top[:, 0])
    return torch.cat(of_served), torch.cat(kth), torch.cat(best)
