"""Exact CPU oracles ("gold" algorithms), NumPy.

The golds of ``spmv_topk_tpu.ops.gold``, carried over: counterparts of
the reference FPGA design's gold suite (gold_algorithms.hpp):

  - spmv_gold (:6-18)                      -> spmv_exact
  - multi_spmv_gold (:21-35)               -> spmm_exact
  - spmv_coo_gold_top_k (:189-246)         -> topk_streaming_gold
  - update_top_k (:249-272)                -> _update_top_k
  - spmv_coo_gold_top_k_packet (:277-362)  -> topk_bscsr_packet_gold
                                              (on BscsrPartition data)

``topk_exact`` is the ground-truth argsort oracle. The streaming and
packet golds keep the reference's argmin-replacement tie behaviour (>=
comparisons, the last writer wins on equal values).
"""

from __future__ import annotations

import numpy as np

from typing import TYPE_CHECKING

from ..formats.coo import CooMatrix

if TYPE_CHECKING:  # avoid a formats.bscsr <-> ops cycle at import time
    from ..formats.bscsr import BscsrPartition


def spmv_exact(coo: CooMatrix, vec: np.ndarray) -> np.ndarray:
    """Dense result of A @ vec in float64-accumulated float32."""
    out = np.zeros(coo.num_rows, dtype=np.float64)
    np.add.at(out, coo.rows, coo.vals.astype(np.float64) * vec[coo.cols])
    return out.astype(np.float32)


def spmm_exact(coo: CooMatrix, queries: np.ndarray) -> np.ndarray:
    """A @ queries.T for a (Q, C) query batch -> (Q, N)."""
    return np.stack([spmv_exact(coo, q) for q in queries])


def topk_exact(coo: CooMatrix, vec: np.ndarray, k: int):
    """Ground-truth Top-K (indices, values), sorted by descending value,
    ties broken by ascending row index (stable)."""
    scores = spmv_exact(coo, vec)
    return topk_of_scores(scores, k)


def topk_of_scores(scores: np.ndarray, k: int):
    k = min(k, len(scores))
    part = np.argpartition(-scores, k - 1)[:k]
    order = np.argsort(-scores[part], kind="stable")
    idx = part[order]
    return idx.astype(np.int32), scores[idx].astype(np.float32)


def _update_top_k(res_idx, res_val, state, row, value):
    """Argmin-replacement update: state = [worst_idx, worst_val]; replaces
    the current worst slot when value >= worst, then rescans for the new
    worst."""
    worst_idx, worst_val = state
    if value >= worst_val:
        res_idx[int(worst_idx)] = row
        res_val[int(worst_idx)] = value
        j = int(np.argmin(res_val))
        state[0] = j
        state[1] = res_val[j]


def topk_streaming_gold(coo: CooMatrix, vec: np.ndarray, k: int):
    """Streaming Top-K with a running row accumulator: one pass over the
    nnz in row-major order, per-row sums, argmin-replacement Top-K.
    Returns (indices, values) in buffer order, unsorted."""
    res_idx = np.zeros(k, dtype=np.int64)
    res_val = np.zeros(k, dtype=np.float32)
    state = [0, np.float32(0.0)]

    scattered = vec[coo.cols].astype(np.float32)
    curr_row = int(coo.rows[0])
    curr_out = np.float32(0.0)
    for i in range(coo.nnz):
        r = int(coo.rows[i])
        contrib = np.float32(coo.vals[i] * scattered[i])
        if r == curr_row:
            curr_out = np.float32(curr_out + contrib)
        else:
            _update_top_k(res_idx, res_val, state, curr_row, curr_out)
            curr_row = r
            curr_out = contrib
    if curr_out >= state[1]:
        res_idx[int(state[0])] = curr_row
        res_val[int(state[0])] = curr_out
    return res_idx.astype(np.int32), res_val


def topk_bscsr_packet_gold(
    part: BscsrPartition,
    vec: np.ndarray,
    k: int,
    limited_finished_rows: int | None = None,
):
    """Packet-accurate Top-K gold over a BS-CSR partition: per-packet
    segmented sums from the prefix counts, cross-packet row stitching by
    the new-row bit, and optionally the LIMITED_FINISHED_ROWS
    approximation (only the first LFR finished rows of each packet enter
    the Top-K). Returns (indices, values) in buffer order."""
    B = part.packet_size
    lfr = B if limited_finished_rows is None else limited_finished_rows

    res_idx = np.zeros(k, dtype=np.int64)
    res_val = np.zeros(k, dtype=np.float32)
    state = [0, np.float32(0.0)]

    # The row whose tail may continue into the next packet, and its
    # partial sum so far.
    carry_row = part.first_row
    carry_val = np.float32(0.0)

    for p in range(part.num_packets):
        boundaries = part.x[p]
        n_valid = min(B, part.num_nnz - p * B)
        prods = (part.vals[p, :n_valid] * vec[part.cols[p, :n_valid]]).astype(np.float32)

        # Segment sums within the packet: segment j covers nnz positions
        # [boundaries[j-1], boundaries[j]); rows are consecutive within a
        # packet (the format assumes no empty rows).
        seg_of = np.searchsorted(boundaries, np.arange(n_valid), side="right")
        num_segments = int(seg_of[-1]) + 1
        seg_sums = np.zeros(num_segments, dtype=np.float32)
        for j in range(n_valid):  # sequential f32 adds, the HLS order
            seg_sums[seg_of[j]] = np.float32(seg_sums[seg_of[j]] + prods[j])

        # A row is "finished" only when a later row appears inside the
        # same packet, so all segments but the last are finished.
        num_finished = num_segments - 1

        # Cross-packet stitching. Packet 0 always merges (carry_val is 0).
        if p == 0 or not part.new_row[p]:
            seg_sums[0] = np.float32(seg_sums[0] + carry_val)
            base_row = carry_row
        else:
            _update_top_k(res_idx, res_val, state, carry_row, carry_val)
            base_row = carry_row + 1

        # LIMITED_FINISHED_ROWS: only the first LFR finished rows of a
        # packet enter the Top-K.
        for j in range(min(num_finished, lfr)):
            _update_top_k(res_idx, res_val, state, base_row + j, seg_sums[j])

        carry_row = base_row + num_segments - 1
        carry_val = seg_sums[num_segments - 1]

    # Final row.
    if carry_val >= state[1]:
        res_idx[int(state[0])] = carry_row
        res_val[int(state[0])] = carry_val
    return res_idx.astype(np.int32), res_val


def pagerank_gold(
    coo: CooMatrix,
    alpha: float = 0.85,
    max_err: float = 1e-6,
    max_iter: int = 100,
):
    """PageRank gold (pagerank_golden, gold_algorithms.hpp:397-432): power
    iteration with dangling-node redistribution and an L2 convergence
    check. Returns (pr_vector, iterations)."""
    n = coo.num_rows
    pr = np.full(n, 1.0 / n, dtype=np.float32)
    dangling = np.ones(n, dtype=np.float32)
    dangling[np.unique(coo.rows)] = 0.0  # rows with no out-edges (as stored)
    shift_base = (1.0 - alpha) / n
    for it in range(1, max_iter + 1):
        spmv = spmv_exact(coo, pr)
        dangling_contrib = float(dangling @ pr)
        shift = shift_base + alpha * dangling_contrib / n
        new_pr = (alpha * spmv + shift).astype(np.float32)
        err = float(np.sum((new_pr - pr) ** 2))
        pr = new_pr
        if err <= max_err:
            break
    return pr, it
