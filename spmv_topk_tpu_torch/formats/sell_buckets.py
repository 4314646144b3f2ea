"""Bucketed uniform-width SELL-128 and its two fused streams.

The host packer of ``spmv_topk_tpu.formats.sell_buckets``, carried over:
the same corpus and config give bit-identical
``words``, ``nreal``, ``plan``, ``row_ids`` and ``value_scale`` in both
packages, so a snapshot of one serves the other.

  - rows are degree-sorted (sigma sort) and cut into 128-row slices, one
    row per lane; slice widths W (words per row) are quantized to a
    ladder, and each run of equal-W slices is a *bucket*. The h16 codec
    packs two nnz per word; the other codecs one (col << 16 | bf16);
  - ``fuse_buckets`` (``fused_layout="slice"``) re-lays the buckets into
    one stream of uniform blocks: a slice's W words sit on W consecutive
    rows, ``slices_per_block`` slices to a block, or one wide slice over
    ``blocks_per_slice`` blocks (``FusedBucket``);
  - ``fuse_buckets_octet`` (``fused_layout="octet"``) re-lays every
    bucket slice-transposed: chunk j of octet o holds word j of the eight
    member slices o + m*stride, m = 0..7, one per sublane, so a sweep that
    adds up W decoded chunks has each member's 128 row scores in its row m
    (``OctetBucket``);
  - ``pack_fused_partitions`` (``num_partitions > 1``) packs P row
    partitions with either stream on one common plan skeleton
    (``PartitionedFusedMatrix``).
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

    @property
    def slices_per_block(self) -> int:
        return self.block_sublanes // self.width


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

    @property
    def num_slices(self) -> int:
        return self.row_ids.shape[0] - 1

    @property
    def hbm_bytes(self) -> int:
        return sum(int(b.words.nbytes) for b in self.buckets)

    @property
    def padded_nnz(self) -> int:
        return sum(b.words.shape[0] * LANES for b in self.buckets)

    @property
    def padding_ratio(self) -> float:
        return self.padded_nnz / max(self.num_nnz, 1)


@dataclasses.dataclass(frozen=True)
class FusedBucket:
    """Descriptor of one bucket of the slice-layout fused stream.

    Narrow buckets (width <= block) hold slices_per_block slices per
    block, slice j of a block on rows j*width .. (j+1)*width - 1; a wide
    bucket (width > block) spans blocks_per_slice blocks per slice, its
    words on the span's first width rows.
    """

    width: int
    slices_per_block: int
    blocks_per_slice: int
    slice_base: int
    blk_start: int
    num_blocks: int


# column order of the slice plan array in snapshots (api.TopKSpMV.save)
SLICE_PLAN_FIELDS = ("width", "slices_per_block", "blocks_per_slice",
                     "slice_base", "blk_start", "num_blocks")


def slice_plan_array(plan) -> np.ndarray:
    """(B, 6) int64 snapshot form of a tuple of FusedBucket."""
    return np.array([[getattr(p, f) for f in SLICE_PLAN_FIELDS]
                     for p in plan], np.int64).reshape(-1, 6)


def slice_plan_from_array(arr) -> tuple:
    return tuple(FusedBucket(**{f: int(v) for f, v in
                                zip(SLICE_PLAN_FIELDS, row)})
                 for row in np.asarray(arr))


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
    plan: tuple              # tuple[FusedBucket, ...] (slice layout) or
    #                          tuple[OctetBucket, ...] (octet layout)
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
    def num_slices(self) -> int:
        return self.row_ids.shape[0] - 1

    @property
    def padding_ratio(self) -> float:
        """Packed words per nnz."""
        return self.words.size / max(self.num_nnz, 1)


def fuse_buckets(m: BucketedSellMatrix, block_sublanes: int = 1024,
                 skeleton: "list | None" = None) -> FusedSellMatrix:
    """Re-lay a bucketed matrix into the slice-layout fused stream.

    Each bucket pairs with its own plan entry positionally (with
    sigma_sort=False several buckets may share a width). Narrow buckets
    pack slices_per_block = block // width consecutive slices per block;
    wide ones put each slice on the first width rows of
    blocks_per_slice = ceil(width / block) blocks. Rows past the real
    slices are zero.

    skeleton: (width, num_blocks, slice_base) triples to conform to (the
    partitions of ``pack_fused_partitions`` share one): buckets are keyed
    by width, which must be unique; a width this matrix lacks becomes a
    bucket of zero blocks with no real slice, block counts are padded up,
    and slice_base follows the skeleton's numbering.
    """
    tgt = block_sublanes
    if skeleton is None:
        shape = [(b.width, None, b.slice_base, b) for b in m.buckets]
    else:
        have = {}
        for b in m.buckets:
            if b.width in have:
                raise ValueError(
                    "fuse_buckets(skeleton=...) needs unique bucket widths "
                    f"(width {b.width} appears twice; pack with "
                    "sigma_sort=True for partitioned engines)")
            have[b.width] = b
        shape = [(w, nb, sb, have.get(w)) for w, nb, sb in skeleton]

    plan = []
    chunks = []
    nreal = []
    blk = 0
    for W, want_blocks, slice_base, b in shape:
        if W <= tgt:
            spb, bps = tgt // W, 1
        else:
            spb, bps = 1, -(-W // tgt)
        n_sl = b.num_slices if b is not None else 0
        nb = -(-n_sl // spb) if bps == 1 else n_sl * bps
        if want_blocks is not None:
            assert nb <= want_blocks, (W, nb, want_blocks)
            nb = want_blocks
        if nb == 0:
            continue
        buf = np.zeros((nb * tgt, LANES), np.int32)
        if b is not None:
            src3 = b.words[: n_sl * W].reshape(n_sl, W, LANES)
            if bps == 1:
                buf3 = buf.reshape(nb, tgt, LANES)
                nfull = n_sl // spb
                if nfull:
                    buf3[:nfull, : spb * W] = src3[: nfull * spb].reshape(
                        nfull, spb * W, LANES)
                rem = n_sl - nfull * spb
                if rem:
                    buf3[nfull, : rem * W] = src3[nfull * spb:].reshape(
                        rem * W, LANES)
            else:
                # a skeleton may pad blocks past the real slices
                buf[: n_sl * bps * tgt].reshape(
                    n_sl, bps * tgt, LANES)[:, :W] = src3
        plan.append(FusedBucket(
            width=W, slices_per_block=spb, blocks_per_slice=bps,
            slice_base=slice_base, blk_start=blk, num_blocks=nb))
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


def fuse_buckets_octet(m: BucketedSellMatrix, block_sublanes: int = 1024,
                       skeleton: "list | None" = None) -> FusedSellMatrix:
    """Re-lay a bucketed matrix into the slice-transposed (octet) stream.

    Chunk j of an octet holds word j of eight strided slices, one per
    sublane, so accumulating W chunks yields an (8, 128) tile whose row m
    is slice (o + m*stride)'s 128 row scores. Block-tail sublanes left by
    octets_per_block * 8W < block_sublanes are zero and never read.

    skeleton: (width, num_octets, slice_base) triples to conform to (the
    partitions of ``pack_fused_partitions`` share one): the member stride
    becomes the skeleton's num_octets, a width this matrix lacks becomes a
    bucket with no real slice, and slice_base follows the skeleton's
    numbering (chunk_sublanes * num_octets ids per width).
    """
    tgt = block_sublanes
    S = m.config.chunk_sublanes
    if skeleton is None:
        shape = [(b.width, None, b.slice_base, b) for b in m.buckets]
    else:
        have = {}
        for b in m.buckets:
            if b.width in have:
                raise ValueError(
                    "fuse_buckets_octet(skeleton=...) needs unique bucket "
                    f"widths (width {b.width} appears twice; pack with "
                    "sigma_sort=True for partitioned/sharded engines)")
            have[b.width] = b
        shape = [(w, g, sb, have.get(w)) for w, g, sb in skeleton]
    plan = []
    chunks = []
    nreal = []
    blk = 0
    for W, want_G, slice_base, b in shape:
        n_sl = b.num_slices if b is not None else 0
        G = -(-n_sl // S)                      # octets (= member stride)
        if want_G is not None:
            assert G <= want_G, (W, G, want_G)
            G = want_G
        if G == 0:
            continue
        src = np.zeros((S * G, W, LANES), np.int32)
        if n_sl:
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
            stride=G, slice_base=slice_base, blk_start=blk,
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


@dataclasses.dataclass
class PartitionedFusedMatrix:
    """P row-partition streams sharing one fused plan skeleton.

    Partition p's blocks follow partition p - 1's in ``words``; every
    partition has the same plan (the skeleton) and its own real-slice
    counts. Slice tags are partition-local: the sweeps add p *
    part_slices, so they resolve against the stacked ``row_ids``, whose
    rows hold global row numbers.
    """

    words: np.ndarray        # (P * num_blocks * block_sublanes, 128) int32
    plan: tuple              # shared tuple[FusedBucket | OctetBucket, ...]
    nreal: np.ndarray        # (P, num_buckets, 1) int32
    row_ids: np.ndarray      # (P * part_slices, 128) int32
    num_partitions: int
    part_slices: int         # total_slices + 1 (incl. sentinel) per partition
    block_sublanes: int
    num_blocks: int          # blocks per partition
    num_rows: int
    num_cols: int
    num_nnz: int
    value_scale: float = 1.0

    @property
    def hbm_bytes(self) -> int:
        return int(self.words.nbytes)

    @property
    def padding_ratio(self) -> float:
        return self.words.size / max(self.num_nnz, 1)


def pack_fused_partitions(
    coo: CooMatrix, config: TopKSpMVConfig, num_partitions: int,
    octet: bool = False,
) -> PartitionedFusedMatrix:
    """Pack ``coo`` as P contiguous row partitions of ceil(rows / P) rows
    with one common fused skeleton: per width, the most blocks (slice
    layout) or octets (``octet``: the member stride) any partition needs.
    A partition that lacks a width gets a bucket of that width with no
    real slice. h16 values share one global scale, so every partition's
    scores are in the same units."""
    P = num_partitions
    tgt = config.fused_block_sublanes
    if not coo.is_sorted_row_major():
        coo = coo.sort_row_major()

    vscale = None
    if config.query_codec == "h16":
        vmax = float(np.max(np.abs(coo.vals))) if coo.nnz else 0.0
        vscale = ((vmax or 1.0) / 31.0) or 1.0

    rows_per = -(-coo.num_rows // P)
    packs = []
    for p in range(P):
        lo = p * rows_per
        hi = min(lo + rows_per, coo.num_rows)
        local = coo.row_slice(lo, hi)
        if local.num_rows <= 0 or local.nnz == 0:
            raise ValueError(
                f"partition {p} is empty ({P} partitions over "
                f"{coo.num_rows} rows) — lower config.num_partitions")
        packs.append((lo, pack_sell_buckets(local, config,
                                            value_scale=vscale)))

    by_width: dict[int, int] = {}
    if octet:
        S = config.chunk_sublanes
        for _, m in packs:
            for b in m.buckets:
                g = -(-b.num_slices // S)
                by_width[b.width] = max(by_width.get(b.width, 0), g)
        skeleton = []
        base = 0
        for w in sorted(by_width, reverse=True):
            g = by_width[w]
            skeleton.append((w, g, base))
            base += S * g   # each width entry reserves S*G slice ids
        total_slices = base
        fused = [fuse_buckets_octet(m, block_sublanes=tgt,
                                    skeleton=skeleton)
                 for _, m in packs]
    else:
        for _, m in packs:
            for q in fuse_buckets(m, block_sublanes=tgt).plan:
                by_width[q.width] = max(by_width.get(q.width, 0),
                                        q.num_blocks)
        skeleton = []
        base = 0
        for w in sorted(by_width, reverse=True):
            nb = by_width[w]
            skeleton.append((w, nb, base))
            spb = tgt // w if w <= tgt else 1
            bps = 1 if w <= tgt else -(-w // tgt)
            base += (nb * spb) if bps == 1 else (nb // bps)
        total_slices = base
        fused = [fuse_buckets(m, block_sublanes=tgt, skeleton=skeleton)
                 for _, m in packs]
    plan = fused[0].plan
    num_blocks = fused[0].num_blocks
    nb_words = max(f.words.shape[0] for f in fused)

    words = np.zeros((P * nb_words, LANES), np.int32)
    nreal = np.zeros((P, len(plan), 1), np.int32)
    row_ids = np.full((P * (total_slices + 1), LANES), -1, np.int32)
    for p, ((row0, m), f) in enumerate(zip(packs, fused)):
        assert f.plan == plan, "skeleton plans must agree"
        words[p * nb_words: p * nb_words + f.words.shape[0]] = f.words
        nreal[p, :, 0] = f.nreal[:, 0]
        r0 = p * (total_slices + 1)
        for q, n_sl in zip(plan, f.nreal[:, 0]):
            if n_sl == 0:
                continue
            src = next(b for b in m.buckets if b.width == q.width)
            ids = m.row_ids[src.slice_base:src.slice_base + int(n_sl)].copy()
            ids[ids >= 0] += row0
            row_ids[r0 + q.slice_base: r0 + q.slice_base + int(n_sl)] = ids
    return PartitionedFusedMatrix(
        words=words, plan=plan, nreal=nreal, row_ids=row_ids,
        num_partitions=P, part_slices=total_slices + 1,
        block_sublanes=tgt, num_blocks=num_blocks,
        num_rows=coo.num_rows, num_cols=coo.num_cols, num_nnz=coo.nnz,
        value_scale=vscale if vscale is not None else 1.0,
    )


def pack_sell_buckets(
    coo: CooMatrix, config: TopKSpMVConfig = DEFAULT_CONFIG,
    target_block_sublanes: int | None = None,
    value_scale: float | None = None,
) -> BucketedSellMatrix:
    """Pack a COO matrix into uniform-width SELL-128 buckets.

    target_block_sublanes: rows per block of every bucket (None:
    ``config.block_sublanes``). value_scale: h16 only, the global 6-bit
    value quantization scale; None computes it from this matrix
    (partitions pass the whole matrix's, ``pack_fused_partitions``)."""
    if coo.num_cols > config.max_cols:
        raise ValueError(
            f"matrix has {coo.num_cols} cols > config.max_cols={config.max_cols}"
        )
    if not coo.is_sorted_row_major():
        coo = coo.sort_row_major()
    from ..utils import native

    S = config.chunk_sublanes
    tgt = target_block_sublanes or config.block_sublanes
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
        if value_scale is None:
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
