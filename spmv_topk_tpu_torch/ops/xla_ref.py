"""Reference Top-K SpMV implementations outside the kernels.

The counterparts of ``spmv_topk_tpu.ops.xla_ref``:
  1. ``sell_scores_np`` / ``topk_spmv_sell_xla``: NumPy oracles of the
     kernels' per-slice scores over a SellMatrix or a BucketedSellMatrix
     (bit-identical to the JAX package's, the same NumPy code);
  2. ``topk_spmv_segment_xla``: the two-phase baseline, a full SpMV then a
     Top-K. In the JAX package it is an XLA ``segment_sum`` and
     ``lax.top_k``; here ``index_add_`` and ``torch.topk`` (library calls:
     it is a baseline, not a port of a kernel), on the device of
     ``query``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import LANES
from ..formats.sell import SellMatrix


def sell_scores_np(m: SellMatrix, query: np.ndarray) -> np.ndarray:
    """NumPy model of the kernels' per-slice scores, one per row (NaN for
    rows absent from the stream).

    f32 products of bf16-decoded values against the f32 query, summed per
    lane: each chunk's 8 rows, then the chunk sums in order.
    """
    from ..formats.sell_buckets import BucketedSellMatrix

    if isinstance(m, BucketedSellMatrix):
        return _bucketed_scores_np(m, query)
    w = m.words.view(np.uint32)
    cols = (w >> 16).astype(np.int64)
    vals = (w << 16).view(np.float32)
    prods = np.where(w != 0, vals * query[cols].astype(np.float32), 0.0)

    scores = np.full(m.num_rows, np.nan, np.float32)
    S = m.config.chunk_sublanes
    cpb = m.config.block_sublanes // S
    for p in range(m.num_partitions):
        c0 = p * m.part_blocks * cpb
        sub0 = c0 * S
        acc = np.zeros(LANES, np.float32)
        for ci in range(m.part_blocks * cpb):
            lo = sub0 + ci * S
            acc += prods[lo:lo + S].sum(axis=0, dtype=np.float32)
            meta = int(m.meta[c0 + ci])
            if meta & 1:
                t = meta >> 1
                ids = m.row_ids[t]
                real = ids >= 0
                scores[ids[real]] = acc[real]
                acc[:] = 0.0
    return scores


def _bucketed_scores_np(m, query: np.ndarray) -> np.ndarray:
    """Per-row scores of the bucketed layout. Like the kernels it reads
    ``width // chunk_sublanes`` chunks of each slice, so a bucket whose
    width is not a multiple of the chunk loses its last width % 8 rows."""
    scores = np.full(m.num_rows, np.nan, np.float32)
    for b in m.buckets:
        w = b.words.view(np.uint32)
        cols = (w >> 16).astype(np.int64)
        vals = (w << 16).view(np.float32)
        prods = np.where(w != 0, vals * query[cols].astype(np.float32), 0.0)
        S = m.config.chunk_sublanes
        for j in range(b.num_slices):
            t = b.slice_base + j
            # accumulate in the kernel's order: S-sublane partials
            acc = np.zeros(prods.shape[1], np.float32)
            for u in range(b.width // S):
                lo = j * b.width + u * S
                acc += prods[lo:lo + S].sum(axis=0, dtype=np.float32)
            ids = m.row_ids[t]
            real = ids >= 0
            scores[ids[real]] = acc[real]
    return scores


def topk_spmv_segment_xla(rows, cols, vals, query, num_rows: int, k: int):
    """Two-phase Top-K SpMV: the full SpMV by a scatter-add of the nnz
    products into ``num_rows`` sums (``index_add_``), then ``torch.topk``.
    rows, cols, vals, query: arrays or tensors; runs on query's device
    (the CPU for an array). Returns (indices int32, values f32), each
    (k,), values descending."""
    query = torch.as_tensor(query, dtype=torch.float32)
    dev = query.device
    rows = torch.as_tensor(rows, device=dev).long()
    cols = torch.as_tensor(cols, device=dev).long()
    vals = torch.as_tensor(vals, dtype=torch.float32, device=dev)
    scores = torch.zeros(num_rows, dtype=torch.float32, device=dev)
    scores.index_add_(0, rows, vals * query[cols])
    v, i = torch.topk(scores, k)
    return i.to(torch.int32), v


def topk_spmv_sell_xla(m: SellMatrix, query: np.ndarray, k: int):
    """Oracle Top-K over SellMatrix semantics (NumPy scores + exact top-k)."""
    scores = sell_scores_np(m, query)
    scores = np.where(np.isnan(scores), -np.inf, scores)
    k = min(k, m.num_rows)
    part = np.argpartition(-scores, k - 1)[:k]
    order = np.argsort(-scores[part], kind="stable")
    idx = part[order]
    return idx.astype(np.int32), scores[idx].astype(np.float32)
