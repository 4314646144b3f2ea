"""SELL-128-sigma: the single-stream packed format with per-chunk metadata.

The packer of ``spmv_topk_tpu.formats.sell``, carried over bit for bit:
rows are degree-sorted (sigma sort) and cut into slices of 128 rows, one
row per lane; slice t owns a (W_t, 128) slab whose lane l holds the nnz of
the slice's l-th row stacked along rows, column-sorted, zero-padded to
W_t (the slice's largest degree, rounded up to ``chunk_sublanes``). Each
nnz is one int32 word, (col << 16) | bf16(value). Every chunk of
``chunk_sublanes`` rows has a metadata word (slice_index << 1) | is_last,
and ``row_ids[t, l]`` maps (slice, lane) back to the row (-1 for padding
lanes). Partitions are contiguous slice ranges padded to equal block
counts.

The engines of this package run the bucketed layout
(``sell_buckets.py``); this format serves the NumPy oracles of
``ops/xla_ref.py`` and round-trip tests.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..config import LANES, TopKSpMVConfig, DEFAULT_CONFIG
from .coo import CooMatrix
from ..ops.fixedpoint import quantize as quantize_values, bf16_bits


@dataclasses.dataclass
class SellMatrix:
    """A packed SELL-128 matrix (host arrays)."""

    words: np.ndarray       # (total_sublanes, 128) int32: (col<<16)|bf16(val)
    meta: np.ndarray        # (total_subchunks,) int32: (slice_idx<<1)|is_end
    row_ids: np.ndarray     # (num_slices, 128) int32, -1 = padding lane
    slice_offsets: np.ndarray  # (num_slices + 1,) int64 sub-chunk offsets
    part_blocks: int        # blocks per partition
    num_rows: int
    num_cols: int
    num_nnz: int            # real nnz (excluding padding)
    config: TopKSpMVConfig

    @property
    def num_slices(self) -> int:
        return self.row_ids.shape[0]

    @property
    def num_partitions(self) -> int:
        return self.config.num_partitions

    @property
    def padded_nnz(self) -> int:
        return int(self.words.shape[0]) * LANES

    @property
    def hbm_bytes(self) -> int:
        return int(self.words.nbytes)

    @property
    def padding_ratio(self) -> float:
        return self.padded_nnz / max(self.num_nnz, 1)


def pack_sell(coo: CooMatrix, config: TopKSpMVConfig = DEFAULT_CONFIG) -> SellMatrix:
    """Pack a COO matrix into SELL-128 form (vectorized NumPy, or the
    native plan and scatter when the runtime is built), split into
    ``config.num_partitions`` contiguous slice ranges balanced by chunk
    count."""
    if coo.num_cols > config.max_cols:
        raise ValueError(
            f"matrix has {coo.num_cols} cols > config.max_cols={config.max_cols}"
        )
    if not coo.is_sorted_row_major():
        coo = coo.sort_row_major()

    S = config.chunk_sublanes
    blk_sub = config.block_sublanes
    P = config.num_partitions

    from ..utils import native

    degrees = coo.row_degrees()
    num_slices = -(-coo.num_rows // LANES)
    pad_rows = num_slices * LANES - coo.num_rows
    vals_q = quantize_values(coo.vals, config.value_format)

    row_start = np.zeros(coo.num_rows + 1, dtype=np.int64)
    np.cumsum(degrees, out=row_start[1:])

    plan = native.sell_plan(degrees, S, config.sigma_sort)
    if plan is not None:
        perm, rank_of_row, slice_w = plan
    else:
        # sigma-sort: stable degree-descending permutation of rows.
        perm = (
            np.argsort(-degrees, kind="stable")
            if config.sigma_sort
            else np.arange(coo.num_rows)
        )
        rank_of_row = np.empty(coo.num_rows, dtype=np.int64)
        rank_of_row[perm] = np.arange(coo.num_rows)
        # Slice widths: max degree within each slice, rounded up to S.
        deg_padded = np.concatenate([degrees[perm], np.zeros(pad_rows, np.int32)])
        slice_w = deg_padded.reshape(num_slices, LANES).max(axis=1)
        slice_w = np.maximum(-(-slice_w // S) * S, S)

    perm_padded = np.concatenate([perm, np.full(pad_rows, -1, np.int64)])
    row_ids = perm_padded.reshape(num_slices, LANES).astype(np.int32)

    slice_sub_offsets = np.zeros(num_slices + 1, dtype=np.int64)
    np.cumsum(slice_w, out=slice_sub_offsets[1:])
    total_sub = int(slice_sub_offsets[-1])

    # Destination coordinates for every nnz:
    #   lane   = rank of its row inside its slice
    #   sublane = slice_offset + index of the nnz within its row
    words = native.sell_scatter(
        coo.rows, coo.cols, vals_q, row_start, rank_of_row,
        slice_sub_offsets, total_sub,
    )
    if words is None:
        slice_of_row = rank_of_row // LANES
        lane_of_row = rank_of_row % LANES
        within_row = np.arange(coo.nnz, dtype=np.int64) - row_start[coo.rows]
        dest_sub = slice_sub_offsets[slice_of_row[coo.rows]] + within_row
        dest_lane = lane_of_row[coo.rows]
        words = np.zeros((total_sub, LANES), dtype=np.uint32)
        payload = (
            (coo.cols.astype(np.uint32) << 16)
            | bf16_bits(vals_q).astype(np.uint32)
        )
        words[dest_sub, dest_lane] = payload
        words = words.view(np.int32)

    # Sub-chunk metadata: slice index + last-sub-chunk-of-slice flag.
    slice_chunks = (slice_w // S).astype(np.int64)
    total_chunks = int(slice_chunks.sum())
    chunk_slice = np.repeat(np.arange(num_slices, dtype=np.int64), slice_chunks)
    chunk_end_pos = np.cumsum(slice_chunks) - 1
    is_end = np.zeros(total_chunks, dtype=np.int64)
    is_end[chunk_end_pos] = 1
    meta = ((chunk_slice << 1) | is_end).astype(np.int32)

    # Partition into P contiguous slice ranges balanced by sub-chunk count,
    # then pad every partition to the same whole number of blocks.
    chunks_per_block = blk_sub // S
    cum_chunks = np.cumsum(slice_chunks)
    inner = np.searchsorted(
        cum_chunks, total_chunks / P * np.arange(1, P), side="left"
    ) + 1
    bounds = np.concatenate([[0], inner, [num_slices]]).astype(np.int64)
    if np.any(np.diff(bounds) < 1):
        raise ValueError(
            f"cannot split {num_slices} slices into {P} non-empty partitions"
        )

    part_chunk_counts = [
        int(slice_chunks[bounds[p]:bounds[p + 1]].sum()) for p in range(P)
    ]
    part_blocks = -(-max(part_chunk_counts) // chunks_per_block)

    out_words = np.zeros((P * part_blocks * blk_sub, LANES), dtype=np.int32)
    out_meta = np.zeros(P * part_blocks * chunks_per_block, dtype=np.int32)
    chunk_off = np.concatenate([[0], np.cumsum(slice_chunks)])
    for p in range(P):
        src_c0 = int(chunk_off[bounds[p]])
        src_c1 = int(chunk_off[bounds[p + 1]])
        dst_c0 = p * part_blocks * chunks_per_block
        n_c = src_c1 - src_c0
        out_words[dst_c0 * S:(dst_c0 + n_c) * S] = words[src_c0 * S:src_c1 * S]
        out_meta[dst_c0:dst_c0 + n_c] = meta[src_c0:src_c1]
        # Padding chunks: slice index of the last real slice, no end flag —
        # they accumulate zeros into a never-folded accumulator.
        if n_c < part_blocks * chunks_per_block:
            last_slice = int(bounds[p + 1] - 1)
            out_meta[dst_c0 + n_c:dst_c0 + part_blocks * chunks_per_block] = last_slice << 1

    return SellMatrix(
        words=out_words,
        meta=out_meta,
        row_ids=row_ids,
        slice_offsets=slice_sub_offsets,
        part_blocks=part_blocks,
        num_rows=coo.num_rows,
        num_cols=coo.num_cols,
        num_nnz=coo.nnz,
        config=config,
    )


def unpack_sell(m: SellMatrix) -> CooMatrix:
    """Round-trip a SellMatrix back to sorted COO."""
    S = m.config.chunk_sublanes
    chunks_per_block = m.config.block_sublanes // S
    rows_l, cols_l, vals_l = [], [], []
    for p in range(m.num_partitions):
        c0 = p * m.part_blocks * chunks_per_block
        for ci in range(m.part_blocks * chunks_per_block):
            meta = int(m.meta[c0 + ci])
            t = meta >> 1
            w = m.words[(c0 + ci) * S:(c0 + ci + 1) * S].view(np.uint32)
            payload = w != 0
            if not payload.any():
                continue
            sub, lane = np.nonzero(payload)
            rows_l.append(m.row_ids[t, lane])
            cols_l.append((w[sub, lane] >> 16).astype(np.int32))
            vals_l.append(
                (w[sub, lane].astype(np.uint32) << 16).view(np.float32)
            )
    rows = np.concatenate(rows_l)
    cols = np.concatenate(cols_l)
    vals = np.concatenate(vals_l)
    keep = rows >= 0
    return CooMatrix(
        rows[keep], cols[keep], vals[keep], m.num_rows, m.num_cols
    ).sort_row_major()
