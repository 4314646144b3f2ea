"""Bucketed uniform-width SELL-128 and its octet (slice-transposed) stream.

The host packer of ``spmv_topk_tpu.formats.sell_buckets``, carried over
for the octet layout: the same corpus and config give bit-identical
``words``, ``nreal``, ``plan``, ``row_ids`` and ``value_scale`` in both
packages, so a snapshot of one serves the other.

  - rows are degree-sorted (sigma sort) and cut into 128-row slices, one
    row per lane; slice widths W (words per row) are quantized to a
    ladder, and each run of equal-W slices is a *bucket*;
  - ``fuse_buckets_octet`` re-lays every bucket slice-transposed: chunk j
    of octet o holds word j of the eight member slices o + m*stride,
    m = 0..7, one per sublane, so a sweep that adds up W decoded chunks
    has each member's 128 row scores in its row m.

The slice layout (``fuse_buckets``) and the partitioned packer are not
part of the port yet (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..config import LANES, TopKSpMVConfig, DEFAULT_CONFIG
from .coo import CooMatrix
from ..ops.fixedpoint import quantize as quantize_values, bf16_bits

# Quantized slice widths: multiples of the 8-sublane chunk with ~1.25
# geometric spacing above 64 (bounded padding from quantization).
W_LADDER = [8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192,
            224, 256, 320, 384, 448, 512, 640, 768, 896, 1024, 1280, 1536,
            1792, 2048, 2560, 3072, 4096, 8192, 16384, 32768]
# quantum 4: every multiple of 4 below 128
W_LADDER_Q4 = sorted(set(list(range(4, 129, 4)) + W_LADDER))
# quantum 2: every even width below 32, multiples of 4 to 64
W_LADDER_Q2 = sorted(set(
    list(range(2, 33, 2)) + list(range(32, 65, 4)) + W_LADDER_Q4))
# quantum 1: every width below 32, even to 64, multiples of 4 to 128
W_LADDER_Q1 = sorted(set(
    list(range(1, 33)) + list(range(32, 65, 2)) + list(range(64, 129, 4))
    + W_LADDER_Q2))


def _quantize_w(w: int, quantum: int = 8) -> int:
    ladder = (W_LADDER_Q1 if quantum == 1
              else W_LADDER_Q2 if quantum == 2
              else W_LADDER_Q4 if quantum == 4 else W_LADDER)
    for q in ladder:
        if w <= q:
            return q
    return -(-w // 8) * 8


@dataclasses.dataclass
class SellBucket:
    """One uniform-W run of slices."""

    words: np.ndarray        # (num_blocks * block_sublanes, 128) int32
    width: int               # W: sublanes per slice
    block_sublanes: int      # sublanes per block (multiple of W)
    num_blocks: int
    slice_base: int          # global index of the bucket's first slice
    num_slices: int          # real slices (before block padding)


@dataclasses.dataclass
class BucketedSellMatrix:
    buckets: list
    row_ids: np.ndarray      # (num_slices_total + 1, 128); last row all -1
    num_rows: int
    num_cols: int
    num_nnz: int
    config: TopKSpMVConfig
    value_scale: float = 1.0  # h16: global 6-bit value quantization scale
    #   (kernel scores are integer sums; multiply by value_scale *
    #   query_scale to recover dot-product units)


@dataclasses.dataclass(frozen=True)
class OctetBucket:
    """Descriptor of one bucket of the octet (slice-transposed) stream.

    Member m of octet o is slice o + m * stride of the bucket. Narrow
    octets (blocks_per_octet == 1) sit octets_per_block to a block; a wide
    octet (8 * width > block) spans blocks_per_octet whole blocks.
    """

    width: int               # member slice width (sublanes) = chunks/octet
    octets_per_block: int    # octets per block (1 in wide mode)
    blocks_per_octet: int    # 1 normally; >1 when chunk_sublanes*width > block
    stride: int              # slice-id stride between octet members
    slice_base: int
    blk_start: int
    num_blocks: int


# column order of the plan array in snapshots (api.TopKSpMV.save)
OCTET_PLAN_FIELDS = ("width", "octets_per_block", "blocks_per_octet",
                     "stride", "slice_base", "blk_start", "num_blocks")


def octet_plan_array(plan) -> np.ndarray:
    """(B, 7) int64 snapshot form of a tuple of OctetBucket."""
    return np.array([[getattr(p, f) for f in OCTET_PLAN_FIELDS]
                     for p in plan], np.int64).reshape(-1, 7)


def octet_plan_from_array(arr) -> tuple:
    return tuple(OctetBucket(**{f: int(v) for f, v in
                                zip(OCTET_PLAN_FIELDS, row)})
                 for row in np.asarray(arr))


@dataclasses.dataclass
class FusedSellMatrix:
    """All buckets re-laid into one uniform-block word stream."""

    words: np.ndarray        # (total_blocks * block_sublanes, 128) int32
    plan: tuple              # tuple[OctetBucket, ...]
    nreal: np.ndarray        # (num_buckets, 1) int32: real slices per bucket
    block_sublanes: int
    num_blocks: int
    row_ids: np.ndarray
    num_rows: int
    num_cols: int
    num_nnz: int
    value_scale: float = 1.0  # see BucketedSellMatrix.value_scale

    @property
    def hbm_bytes(self) -> int:
        return int(self.words.nbytes)

    @property
    def padding_ratio(self) -> float:
        """Packed words per nnz."""
        return self.words.size / max(self.num_nnz, 1)


def fuse_buckets_octet(m: BucketedSellMatrix,
                       block_sublanes: int = 1024) -> FusedSellMatrix:
    """Re-lay a bucketed matrix into the slice-transposed (octet) stream.

    Chunk j of an octet holds word j of eight strided slices, one per
    sublane, so accumulating W chunks yields an (8, 128) tile whose row m
    is slice (o + m*stride)'s 128 row scores. Block-tail sublanes left by
    octets_per_block * 8W < block_sublanes are zero and never read.
    """
    tgt = block_sublanes
    S = m.config.chunk_sublanes
    plan = []
    chunks = []
    nreal = []
    blk = 0
    for b in m.buckets:
        W = b.width
        n_sl = b.num_slices
        G = -(-n_sl // S)                      # octets (= member stride)
        if G == 0:
            continue
        src = np.zeros((S * G, W, LANES), np.int32)
        src[:n_sl] = b.words[: n_sl * W].reshape(n_sl, W, LANES)
        # member (o, m) = slice o + m*G: (S, G, W, L)[m, o] -> (G, W, S, L)
        octs = np.ascontiguousarray(
            src.reshape(S, G, W, LANES).transpose(1, 2, 0, 3)
        ).reshape(G, S * W, LANES)
        del src
        if S * W <= tgt:
            opb = tgt // (S * W)
            bpo = 1
            nb = -(-G // opb)
            buf = np.zeros((nb * tgt, LANES), np.int32)
            buf3 = buf.reshape(nb, tgt, LANES)
            nfull = G // opb
            if nfull:
                buf3[:nfull, : opb * S * W] = octs[: nfull * opb].reshape(
                    nfull, opb * S * W, LANES)
            rem = G - nfull * opb
            if rem:
                buf3[nfull, : rem * S * W] = octs[nfull * opb:].reshape(
                    rem * S * W, LANES)
        else:
            opb = 1
            bpo = -(-(S * W) // tgt)
            nb = G * bpo
            buf = np.zeros((nb * tgt, LANES), np.int32)
            buf.reshape(G, bpo * tgt, LANES)[:, : S * W] = octs
        plan.append(OctetBucket(
            width=W, octets_per_block=opb, blocks_per_octet=bpo,
            stride=G, slice_base=b.slice_base, blk_start=blk,
            num_blocks=nb,
        ))
        chunks.append(buf)
        nreal.append(n_sl)
        blk += nb

    words = np.concatenate(chunks) if chunks else \
        np.zeros((0, LANES), np.int32)
    return FusedSellMatrix(
        words=words, plan=tuple(plan),
        nreal=np.asarray(nreal, np.int32).reshape(-1, 1),
        block_sublanes=tgt, num_blocks=blk,
        row_ids=m.row_ids, num_rows=m.num_rows, num_cols=m.num_cols,
        num_nnz=m.num_nnz, value_scale=m.value_scale,
    )


def pack_sell_buckets(
    coo: CooMatrix, config: TopKSpMVConfig = DEFAULT_CONFIG,
) -> BucketedSellMatrix:
    """Pack a COO matrix into uniform-width SELL-128 buckets."""
    if coo.num_cols > config.max_cols:
        raise ValueError(
            f"matrix has {coo.num_cols} cols > config.max_cols={config.max_cols}"
        )
    if not coo.is_sorted_row_major():
        coo = coo.sort_row_major()
    from ..utils import native

    S = config.chunk_sublanes
    tgt = config.block_sublanes
    h16 = config.query_codec == "h16"

    degrees = coo.row_degrees()
    num_slices = -(-coo.num_rows // LANES)
    pad_rows = num_slices * LANES - coo.num_rows
    vals_q = None if h16 else quantize_values(coo.vals, config.value_format)

    row_start = np.zeros(coo.num_rows + 1, dtype=np.int64)
    np.cumsum(degrees, out=row_start[1:])

    if h16:
        # two consecutive nnz of a row per 32-bit word: slice widths, plan
        # and scatter all work on WORD degrees ceil(d/2); values are 6-bit
        # signed with one global scale
        vmax = float(np.max(np.abs(coo.vals))) if coo.nnz else 1.0
        value_scale = (vmax / 31.0) or 1.0
        plan_degrees = (-(-degrees // 2)).astype(np.int32)
    else:
        value_scale = 1.0
        plan_degrees = degrees

    Q = config.width_quantum
    plan = native.sell_plan(plan_degrees, Q, config.sigma_sort)
    if plan is not None:
        perm, rank_of_row, slice_w = plan
    else:
        perm = (np.argsort(-plan_degrees, kind="stable") if config.sigma_sort
                else np.arange(coo.num_rows))
        rank_of_row = np.empty(coo.num_rows, dtype=np.int64)
        rank_of_row[perm] = np.arange(coo.num_rows)
        deg_padded = np.concatenate(
            [plan_degrees[perm], np.zeros(pad_rows, np.int32)])
        slice_w = deg_padded.reshape(num_slices, LANES).max(axis=1)
        slice_w = np.maximum(-(-slice_w // Q) * Q, Q)

    # Quantize widths to the ladder; sigma-sorted slices make equal-W runs
    # contiguous.
    slice_wq = np.array([_quantize_w(int(w), Q) for w in slice_w], np.int64)

    # Merge runs into the previous (wider) one while a global padding
    # budget (~1% of the packed sublanes) lasts: fewer buckets, bounded
    # widening.
    if config.sigma_sort and num_slices > 1:
        budget = max(2 * S, int(slice_wq.sum()) // 100)
        i = 0
        cur_w = None
        while i < num_slices:
            j = i
            w = int(slice_wq[i])
            while j < num_slices and slice_wq[j] == w:
                j += 1
            cost = (j - i) * (cur_w - w) if cur_w is not None else None
            if cost is not None and cost <= budget:
                slice_wq[i:j] = cur_w
                budget -= cost
            else:
                cur_w = w
            i = j

    perm_padded = np.concatenate([perm, np.full(pad_rows, -1, np.int64)])
    row_ids = np.concatenate([
        perm_padded.reshape(num_slices, LANES),
        np.full((1, LANES), -1, np.int64),           # sentinel slice
    ]).astype(np.int32)

    slice_off = np.zeros(num_slices + 1, dtype=np.int64)
    np.cumsum(slice_wq, out=slice_off[1:])
    total_sub = int(slice_off[-1])

    # Scatter all nnz once into the quantized-width global slab.
    if h16:
        words = _scatter_h16(coo, degrees, row_start, rank_of_row,
                             slice_off, total_sub, value_scale)
    else:
        words = native.sell_scatter(
            coo.rows, coo.cols, vals_q, row_start, rank_of_row, slice_off,
            total_sub,
        )
    if words is None:
        slice_of_row = rank_of_row // LANES
        lane_of_row = rank_of_row % LANES
        within_row = np.arange(coo.nnz, dtype=np.int64) - row_start[coo.rows]
        dest_sub = slice_off[slice_of_row[coo.rows]] + within_row
        dest_lane = lane_of_row[coo.rows]
        w32 = np.zeros((total_sub, LANES), dtype=np.uint32)
        w32[dest_sub, dest_lane] = (
            (coo.cols.astype(np.uint32) << 16)
            | bf16_bits(vals_q).astype(np.uint32)
        )
        words = w32.view(np.int32)

    # Sign-layout codecs move per-word gather arithmetic into the packed
    # word's high half (lane | shift-amount | table-row sign bit).
    if config.query_codec in ("i8s", "i4s"):
        from ..ops.quantized_query import encode_words_sign_layout

        words = encode_words_sign_layout(words, config.query_codec)

    # Cut into buckets = contiguous equal-W runs.
    buckets = []
    t = 0
    while t < num_slices:
        W = int(slice_wq[t])
        t_end = t
        while t_end < num_slices and slice_wq[t_end] == W:
            t_end += 1
        n_sl = t_end - t
        spb = max(1, tgt // W)
        block_sub = spb * W
        num_blocks = -(-n_sl // spb)
        sub0 = int(slice_off[t])
        sub1 = int(slice_off[t_end])
        bw = np.zeros((num_blocks * block_sub, LANES), np.int32)
        bw[: sub1 - sub0] = words[sub0:sub1]
        buckets.append(SellBucket(
            words=bw, width=W, block_sublanes=block_sub,
            num_blocks=num_blocks, slice_base=t, num_slices=n_sl,
        ))
        t = t_end

    return BucketedSellMatrix(
        buckets=buckets, row_ids=row_ids,
        num_rows=coo.num_rows, num_cols=coo.num_cols, num_nnz=coo.nnz,
        config=config, value_scale=value_scale,
    )


def _scatter_h16(coo: CooMatrix, degrees, row_start, rank_of_row,
                 slice_off, total_sub, value_scale: float) -> np.ndarray:
    """Pair-pack the COO for the h16 codec.

    Word layout (2 nnz per int32):
      bits [ 0:10)  col of nnz 2p      [10:16)  val6 of nnz 2p
      bits [16:26)  col of nnz 2p+1    [26:32)  val6 of nnz 2p+1
    val6 = two's-complement round(val / value_scale) in [-31, 31]; an odd
    row degree leaves the high half 0 (val6=0 contributes nothing).

    Runs in the native threaded scatter when it is built; this NumPy body
    is the fallback, and its temporaries are ~9x the packed size.
    """
    from ..utils import native

    nw = native.h16_scatter(
        np.ascontiguousarray(coo.rows, np.int32),
        np.ascontiguousarray(coo.cols, np.int32),
        np.ascontiguousarray(coo.vals, np.float32),
        np.ascontiguousarray(row_start, np.int64),
        np.ascontiguousarray(rank_of_row, np.int64),
        np.ascontiguousarray(slice_off, np.int64),
        total_sub, value_scale)
    if nw is not None:
        return nw
    v6 = np.clip(np.rint(coo.vals * np.float32(1.0 / value_scale)),
                 -31, 31).astype(np.int32)
    halves = (coo.cols.astype(np.uint32)
              | ((v6 & 0x3F).astype(np.uint32) << np.uint32(10)))
    del v6

    pair_degrees = -(-degrees.astype(np.int64) // 2)
    pair_start = np.zeros(coo.num_rows + 1, np.int64)
    np.cumsum(pair_degrees, out=pair_start[1:])
    total_pairs = int(pair_start[-1])

    within = np.arange(coo.nnz, dtype=np.int64)
    within -= row_start[coo.rows]
    pid = pair_start[coo.rows] + (within >> 1)
    hi = (within & 1).astype(bool)
    del within
    pw = np.zeros(total_pairs, np.uint32)
    pw[pid[~hi]] = halves[~hi]            # exactly one low half per pair
    pw[pid[hi]] |= halves[hi] << np.uint32(16)
    del pid, hi, halves

    pair_rows = np.repeat(
        np.arange(coo.num_rows, dtype=np.int32), pair_degrees)
    rk = rank_of_row[pair_rows]
    dest_sub = np.arange(total_pairs, dtype=np.int64)
    dest_sub -= pair_start[pair_rows]
    del pair_rows
    dest_sub += slice_off[rk // LANES]
    w32 = np.zeros((total_sub, LANES), np.uint32)
    w32[dest_sub, rk % LANES] = pw
    return w32.view(np.int32)
