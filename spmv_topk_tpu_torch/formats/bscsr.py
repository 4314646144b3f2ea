"""Classic BS-CSR packet format (host side, NumPy).

The packet encoder of ``spmv_topk_tpu.formats.bscsr``, carried over: the
reference FPGA design's packets (``packet_coo_partition``,
host_spmv_bscsr.cpp:189-248; the 512-bit layout of fpga_utils.hpp:264-365)
in struct-of-arrays form, so that ``ops/gold.py``'s packet-accurate Top-K
gold can run over them. The device streams of this package are the SELL
buckets (``sell_buckets.py``); this format is an oracle only.

Fields per packet of B nnz:
  cols[p, j]   column index of nnz j
  vals[p, j]   value of nnz j (reduced precision)
  x[p, j]      prefix count: nnz covered by the first (j+1) row segments
               of the packet
  new_row[p]   True iff the packet starts a new row
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..config import ValueFormat, F32
from .coo import CooMatrix
from ..ops.fixedpoint import quantize as quantize_values

# Reference packet geometry, types.hpp:61-73: with 32-bit values
# B = (512 - 1) // (32 + 10 + 4) = 11; with 20-bit values B = 15.
DEFAULT_PACKET_SIZE = 11


@dataclasses.dataclass
class BscsrPartition:
    """One row partition's packet stream."""

    cols: np.ndarray      # (num_packets, B) int32
    vals: np.ndarray      # (num_packets, B) float32 (already quantized)
    x: np.ndarray         # (num_packets, B) int32 prefix counts
    new_row: np.ndarray   # (num_packets,) bool
    first_row: int
    last_row: int
    num_nnz: int
    packet_size: int

    @property
    def num_packets(self) -> int:
        return self.cols.shape[0]


def pack_bscsr_partition(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    packet_size: int = DEFAULT_PACKET_SIZE,
    prev_last_row: int = 0,
) -> BscsrPartition:
    """Pack one sorted COO partition into BS-CSR packets.

    ``prev_last_row`` is the last row of the preceding partition; it
    decides the first packet's new-row bit.
    """
    B = packet_size
    nnz = len(rows)
    if nnz == 0:
        raise ValueError("empty partition")
    num_packets = -(-nnz // B)
    pad = num_packets * B - nnz

    rows_p = np.concatenate([rows, np.full(pad, -1, np.int32)]).reshape(num_packets, B)
    cols_p = np.concatenate([cols, np.zeros(pad, np.int32)]).reshape(num_packets, B)
    vals_p = np.concatenate([vals, np.zeros(pad, np.float32)]).reshape(num_packets, B)

    valid = rows_p >= 0

    # new-row bit: does entry 0 of this packet start a new row? (compared
    # with the running row, after the first packet the previous packet's
    # last row)
    prev_last = np.empty(num_packets, np.int32)
    prev_last[0] = prev_last_row
    prev_last[1:] = rows_p[:-1, -1]  # partitions are padded only in the last packet
    new_row = rows_p[:, 0] != prev_last

    # Row-segment boundaries within each packet: boundary after position
    # j-1 iff the row changes between j-1 and j.
    x = np.zeros((num_packets, B), np.int32)
    for p in range(num_packets):
        pos = 0
        run = 1
        for j in range(1, B):
            if valid[p, j - 1]:
                if rows_p[p, j] == rows_p[p, j - 1]:
                    run += 1
                else:
                    x[p, pos] = run
                    run = 1
                    pos += 1
            else:
                x[p, pos] = 0
                pos += 1
        if valid[p, B - 1]:
            x[p, pos] = run
        x[p] = np.cumsum(x[p])

    return BscsrPartition(
        cols=cols_p, vals=vals_p, x=x, new_row=new_row,
        first_row=int(rows[0]), last_row=int(rows[-1]), num_nnz=nnz,
        packet_size=B,
    )


def pack_bscsr(
    coo: CooMatrix,
    num_partitions: int = 1,
    packet_size: int = DEFAULT_PACKET_SIZE,
    value_format: ValueFormat = F32,
) -> list[BscsrPartition]:
    """Row-partition a sorted COO matrix into contiguous blocks of
    ceil(num_rows / P) rows and pack each partition."""
    if not coo.is_sorted_row_major():
        coo = coo.sort_row_major()
    vals = quantize_values(coo.vals, value_format)
    rows_per_part = -(-coo.num_rows // num_partitions)
    parts = []
    prev_last = 0
    for p in range(num_partitions):
        part_idx = coo.rows // rows_per_part == p
        if not np.any(part_idx):
            raise ValueError(f"partition {p} is empty; use fewer partitions")
        packed = pack_bscsr_partition(
            coo.rows[part_idx], coo.cols[part_idx], vals[part_idx],
            packet_size, prev_last,
        )
        prev_last = packed.last_row
        parts.append(packed)
    return parts


def unpack_bscsr_partition(p: BscsrPartition) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Reconstruct (rows, cols, vals) from a packet stream: rows recovered
    from the prefix counts and new-row bits."""
    B = p.packet_size
    rows_out = np.empty(p.num_nnz, np.int32)
    curr_row = p.first_row
    n = 0
    for pk in range(p.num_packets):
        if pk > 0 and p.new_row[pk]:
            curr_row += 1
        boundaries = p.x[pk]
        seg_of = np.zeros(B, np.int32)
        for j in range(B):
            seg_of[j] = np.searchsorted(boundaries, j, side="right")
        # positions before the first boundary belong to segment 0, etc.
        take = min(B, p.num_nnz - n)
        rows_out[n:n + take] = curr_row + seg_of[:take]
        if take == B:
            curr_row += seg_of[B - 1]
        n += take
    cols_out = p.cols.reshape(-1)[: p.num_nnz]
    vals_out = p.vals.reshape(-1)[: p.num_nnz]
    return rows_out, cols_out, vals_out
