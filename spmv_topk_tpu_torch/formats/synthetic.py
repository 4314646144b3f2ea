"""Synthetic embedding-matrix generator.

The same generator as ``spmv_topk_tpu.formats.synthetic``: the same seed
gives a bit-identical corpus in both packages. Per-row degree is
Uniform[d/2, 1.5d] or Gamma(k=3, theta=d/3) clipped to >= 1, column
indices are random and sorted per row, values are uniform [0, 1) and
L2-normalized per row.
"""

from __future__ import annotations

import numpy as np

from .coo import CooMatrix

GAMMA_K = 3.0


def create_sparse_matrix(
    num_rows: int,
    num_cols: int,
    average_degree: int,
    distribution: str = "uniform",
    l2_norm: bool = True,
    seed: int | None = None,
) -> CooMatrix:
    rng = np.random.default_rng(seed)

    if distribution == "uniform":
        min_degree = average_degree // 2
        max_degree = int(average_degree * 1.5)
        degrees = rng.integers(min_degree, max_degree + 1, num_rows)
    elif distribution == "gamma":
        degrees = np.maximum(
            rng.gamma(GAMMA_K, average_degree / GAMMA_K, num_rows).astype(np.int64), 1
        )
    else:
        raise ValueError(f"unknown distribution {distribution!r}")
    degrees = np.minimum(degrees, num_cols)

    total_nnz = int(degrees.sum())
    rows = np.repeat(np.arange(num_rows, dtype=np.int32), degrees)

    # Duplicate columns within a row are allowed (they just add). Rows are
    # already grouped ascending, so one flat sort of (row << col_bits | col)
    # keys sorts every row's columns.
    cols = rng.integers(0, num_cols, total_nnz, dtype=np.int32)
    col_bits = max(int(num_cols - 1).bit_length(), 1)
    keys = rows.astype(np.int64)
    keys <<= col_bits
    keys |= cols
    del cols
    keys.sort(kind="stable")
    keys &= (1 << col_bits) - 1
    cols = keys.astype(np.int32)
    del keys

    vals = rng.random(total_nnz, dtype=np.float32)
    if l2_norm:
        # segmented L2 normalization per row, f32 with in-place passes
        starts = np.zeros(num_rows + 1, dtype=np.int64)
        np.cumsum(degrees, out=starts[1:])
        sq = np.add.reduceat(vals * vals, starts[:-1][degrees > 0])
        inv = np.ones(num_rows, dtype=np.float32)
        inv[degrees > 0] = 1.0 / np.sqrt(sq, dtype=np.float32)
        vals *= np.repeat(inv, degrees)

    m = CooMatrix(rows, cols, vals, num_rows, num_cols)
    m._sorted = True  # constructed row-major sorted above
    return m


def create_sample_vector(
    num_cols: int,
    l2_norm: bool = True,
    uniform: bool = False,
    seed: int | None = None,
) -> np.ndarray:
    """Random dense query vector: uniform [0, 1) entries, optionally
    L2-normalized."""
    rng = np.random.default_rng(seed)
    if uniform:
        vec = np.full(num_cols, 1.0 / num_cols, dtype=np.float32)
    else:
        vec = rng.random(num_cols, dtype=np.float32)
    if l2_norm:
        vec = vec / np.linalg.norm(vec)
    return vec.astype(np.float32)


def create_query_batch(
    num_queries: int, num_cols: int, l2_norm: bool = True, seed: int | None = None
) -> np.ndarray:
    rng = np.random.default_rng(seed)
    q = rng.random((num_queries, num_cols), dtype=np.float32)
    if l2_norm:
        q = q / np.linalg.norm(q, axis=1, keepdims=True)
    return q.astype(np.float32)
