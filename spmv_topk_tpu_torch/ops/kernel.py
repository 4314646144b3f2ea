"""The device sweeps of the two fused streams (kernels K1, K6, K4 on the
octet stream; K7, K8, K9 on the slice stream), the per-bucket ops over
one bucket of ``pack_sell_buckets`` (K11, K12, K13), their per-lane
merge and ``finalize_topk``.

Query codecs. Every sweep takes every codec of the config (``h16``,
``f32``, ``int8x4``, ``i8s``, ``i4s``): a word's product against the query
table is ``prod_h16`` (two nnz per word, int32), ``prod_f32``,
``prod_int8x4`` or ``prod_sign`` (one nnz, the bf16 value times the
decoded query entry in float32); ``_table_spec`` gives each codec's table
and ``KERNEL_CODECS`` the kernels' codec argument. h16 sums are int32,
exact in any order. The float codecs are summed in a fixed order, each
product and each add rounded, the same in a kernel and its plain version
(bit-equal): on the octet stream the JAX kernels' own order (K1 and K4 two
alternating accumulators per block, K6 one; a wide octet's block sums
added in block order), on the slice stream row order (``_row_sum``).

Octet stream. Each sweep adds up, for every octet of the slice-transposed
stream (formats/sell_buckets.py::fuse_buckets_octet), its W decoded
chunks into 8 member scores per lane:

  - ``topk_spmv_fused_octet_device`` (K1, one query) harvests the top 3
    of the 8 (or all 8 with ``fold_tile=1``) into per-lane (value, slice)
    buffers of ``lane_k`` entries, which merge into one ``(lane_k, 128)``
    pair (on the card in the same launch; ``octet_topk_slots_plain`` is
    that kernel on its slots);
  - ``topk_spmv_fused_batch_octet_device`` (K6) does the same for Q
    queries at once: ``(Q, lane_k, 128)`` pairs (h16: every word read
    once for up to 32 queries, the merge on the card;
    ``octet_topk_batch_slots_plain`` is that kernel on its slots);
  - ``spmv_fused_scores_octet_device`` (K4) writes the 8 member scores
    themselves, in slice order or, scaled, straight to row order: plain
    SpMV.

Slice stream (formats/sell_buckets.py::fuse_buckets). A slice's W words sit on W consecutive rows; each sweep
adds up every slice's W decoded words into its 128 row scores (one
lane per row):

  - ``topk_spmv_fused_device`` (K7, one query) harvests the slice scores
    into per-lane buffers: every slice (``fold_tile=1``), or the top 2 of
    each strided sub-tile of ``fold_tile`` slices, as the JAX kernel
    does (``slice_work``); they merge into one ``(lane_k, 128)`` pair on
    the card in the same launch (``slice_topk_slots_plain`` is that
    kernel on its slots);
  - ``topk_spmv_fused_batch_device`` (K8) folds every slice of Q queries,
    whatever ``fold_tile`` is (the JAX batch kernel has no tiled fold),
    the stream read once a pass of queries and the merge on the card
    (``slice_topk_batch_slots_plain`` is that kernel on its slots);
  - ``spmv_fused_scores_device`` (K9) writes the slice scores, in slice
    order or, scaled, straight to row order: plain SpMV.

On a CUDA tensor each wrapper launches its kernel from ``csrc/`` (K1
``octet_topk.cuh``, K6 ``octet_topk_batch.cuh`` and, for h16,
``octet_topk_batch_h16.cu``, K4 ``octet_scores.cu``, K7
``slice_topk.cuh``, K8 ``slice_topk_batch.cuh``, K9 ``slice_scores.cu``,
the codecs in ``codecs.cuh``; they replace the pallas_calls of
``spmv_topk_tpu/ops/kernel.py``). K1, K7, K8, K13 and K6 h16 merge their
slots' buffers on the card, in the same launch (``csrc/lane_merge.cuh``);
the other Top-K sweeps merge their per-CUDA-block buffers with one per-lane
``torch.topk``, the same algebra as the JAX package's per-lane
``lax.top_k`` over its per-bucket buffers. On a
CPU tensor each runs its plain PyTorch version (``octet_topk_plain``, ``octet_topk_batch_plain``, ``octet_scores_plain``,
``slice_topk_plain``, ``slice_topk_batch_plain``, ``slice_scores_plain``),
which the tests hold against the JAX package and the card holds the
kernel against.

Plan rows: the kernels read the bucket plan from an int32 tensor, ``(B,
8)`` for the octet stream (``octet_plan_rows``, columns
``PLAN_COLUMNS``) and ``(B, 6)`` for the slice stream
(``slice_plan_rows``, columns ``SLICE_PLAN_COLUMNS``).

Per-bucket ops (the JAX package's ``_bucket_scores_kernel``,
``_bucket_kernel_batch``, ``_bucket_kernel``): ``spmv_bucket_scores_device``
(K11, ``csrc/bucket_scores.cu``) writes one bucket's slice scores,
``topk_spmv_bucket_device`` (K13, ``csrc/bucket_topk.cu``) and
``topk_spmv_bucket_batch_device`` (K12, ``csrc/bucket_topk_batch.cuh``)
harvest them into per-lane buffers with global slice tags; plain versions
``bucket_scores_plain``, ``bucket_topk_plain``, ``bucket_topk_batch_plain``
(and ``bucket_topk_slots_plain``, K13 on its kernel's slots, with
``lane_merge_plain``, its merge on the card).
Their codec is a keyword of its own, and they sum in the JAX kernels'
order (``_bucket_sums``).

Partitions (kernels K10a-K10d of the JAX package, and its partitioned
K4/K9 grids): with ``num_partitions`` P > 1 the words are P equal runs
of blocks on one plan (formats/sell_buckets.py::PartitionedFusedMatrix),
``nreal`` is ``(P, B, 1)``, and a slice tag of partition p is offset by
``p * part_slices`` so that it resolves against the stacked ``row_ids``.
Each wrapper sweeps every partition in one launch (the partition is the
CUDA grid's y index) and keeps a Top-K pool per partition: the sweeps
return ``(P, lane_k, 128)`` (``(Q, P, lane_k, 128)`` for a batch), never
merged across partitions, and the SpMV sweeps write ``(P * part_slices,
128)`` rows. With P = 1 the shapes have no partition axis.
"""

from __future__ import annotations

import array
import contextlib
import functools
import math

import numpy as np
import torch

from ..config import LANES, TopKSpMVConfig
from . import _build

NEG_INF = float("-inf")
_INT32_MAX = 2**31 - 1

# Sentinel floor of the Top-K buffers: real scores of L2-normalized
# embeddings are O(1), so anything at or below this is an unfilled slot
# (finalize_topk masks on it).
TOPK_FLOOR = -1e38

PLAN_COLUMNS = ("width", "octets_per_block", "blocks_per_octet", "stride",
                "slice_base", "blk_start", "num_blocks", "octet_start")

# Top-K buffer depths the CUDA kernels are instantiated for
KERNEL_LANE_K = (4, 8, 16)
# K13 (csrc/bucket_topk.cu) and K1 (csrc/octet_topk.cuh): 128-thread
# groups (slots) a CUDA block
BUCKET_GROUPS = 4
K1_GROUPS = 4
# K1's deal of octets to slots (k1_deal): an octet's work beside its
# chunks, in chunks (locating, masking and harvesting it); the kernel's
# compile-time kOctetCost (csrc/octet_topk.cuh) is the same number
K1_OCTET_COST = 1
# K7 (csrc/slice_topk.cuh): 128-thread slots a CUDA block (its grid is
# K1's, ``octet_grid``), and its deal of work items to slots (k7_deal):
# an item's work beside its real members' rows (each member's in whole
# chunks of K7_CHUNK_ROWS, as the kernel reads them), in rows; the
# kernel's compile-time kItemCost and kChunkRows are the same numbers
K7_GROUPS = 4
K7_ITEM_COST = 16
K7_CHUNK_ROWS = 8
# K8 (csrc/slice_topk_batch.cuh): the queries a pass reads the stream
# once for, by codec (h16's table packs up to 32, H16x32; the float
# codecs' tables sit side by side, 8 or 16), and the rows of a member a
# load batch reads (kUnroll: a wide slice's block sums close after whole
# batches)
K8_PASS_QUERIES = {"h16": (8, 16, 32), "f32": (8, 16), "f32_global": (8,),
                   "int8x4": (8, 16), "i8s": (8, 16), "i4s": (8, 16),
                   "int8x4_global": (8,)}
K8_UNROLL = 4
# K9 (csrc/slice_scores.cu): warps a CUDA block, each summing a slice at a
# time (its kWarps)
K9_WARPS = 16
# (C entry point, device index, its arguments) -> a kernel's resident
# blocks an SM (_resident_blocks); (kernel, device index, stream) -> the
# workspace and tickets of K13, K12, K6, K1, K7, K8 and K3
# (_merge_workspace)
_OCCUPANCY = {}
_MERGE_WORKSPACE = {}
# CUDA blocks per SM of the sweep K4, and the slots of the batch
# sweeps that merged with torch.topk before K8, K6 and K12 read the stream
# once a pass (``batch_grid``: the old kernels that experiments/
# k8_ablation.py, k6_ablation.py and k12_ablation.py time; each slot owned
# one set of lane buffers, so this also set their merge width, slots *
# lane_k per lane)
_BLOCKS_PER_SM = 8
_HARVEST = 3   # octet fold: top 3 of the 8 members per lane
# Those old kernels' subgroups: the queries of one CUDA block, 4 when
# cfg.batch_subgroup is 0 and at most 8 (their h16 table entry packs 8
# queries' nibbles, csrc/codecs.cuh::H16Batch). No kernel of the package
# reads cfg.batch_subgroup: it never changed the JAX kernels' results
BATCH_SUBGROUP = 4
MAX_BATCH_SUBGROUP = 8
# K6 h16 (csrc/octet_topk_batch_h16.cu): queries a pass reads the stream
# once for, and the stream lanes of a CUDA block by lane_k (kBlockLanes:
# 128 / that many blocks share a slot's octets)
H16_PASS_QUERIES = 32
H16_BLOCK_LANES = {4: 64, 8: 64, 16: 32}
# K6 for the other codecs (csrc/octet_topk_batch.cuh): the queries a pass
# reads the stream once for, by kernel codec: f32 on FloatPass tables,
# int8x4, i8s and i4s on Bf16Pass tables (8 or 16); f32 and int8x4 tables
# too large for those read from global memory (FloatPass, 8). Bf16Pass
# passes of 32 (blocks of 32 lanes for their buffers' room, 8 warps an SM)
# took 3-8% longer a group of 32 than two passes of 16 on the H100
# (experiments/k6_ablation.py pass32); a group of 8 took 28% less in a
# pass of 8 than in one of 16
K6_PASS_QUERIES = {"f32": (8, 16), "f32_global": (8,), "int8x4": (8, 16),
                   "int8x4_global": (8,), "i8s": (8, 16), "i4s": (8, 16)}
# K12 (csrc/bucket_topk_batch.cuh): h16 on K8's H16Pass tables in passes
# of 8 or 16; the other codecs on K6's tables in passes of 8 (their sums,
# one a query and row of a chunk, fill a thread's registers at 8)
K12_PASS_QUERIES = dict({c: (8,) for c in K6_PASS_QUERIES}, h16=(8, 16))
# columns a query table entry holds (ops/quantized_query.py): f32 one
# value, int8x4 and i8s 4 bytes, i4s 8 nibbles (each a column of K6's
# Bf16Pass table); h16's one table row holds every column
TABLE_FIELDS = {"f32": 1, "int8x4": 4, "i8s": 4, "i4s": 8}
# plain versions decode at most ~16M words at once (bounds the int64
# gather indices)
_STEP_WORDS = 1 << 24

SLICE_PLAN_COLUMNS = ("width", "slices_per_block", "blocks_per_slice",
                      "slice_base", "blk_start", "num_blocks")
# The kernels' codec argument is an index in this table (csrc/codecs.cuh,
# enum Codec, in the same order): the config's codecs, and f32 with its
# tables read from global memory (a table past a CUDA block's shared
# memory, ``tables_in_smem``), and int8x4 with its tables read from
# global memory (the batch sweeps K6, K8 and K12 only: their pass tables
# past shared memory)
KERNEL_CODECS = ("h16", "f32", "f32_global", "int8x4", "i8s", "i4s",
                 "int8x4_global")
# the sign-layout codecs' final arithmetic shift (``prod_sign``)
SIGN_SHIFTS = {"i8s": 24, "i4s": 28}
# summation orders of the octet sweeps' float codecs: K1 and K4 add the
# even and the odd chunks of a block in two accumulators (PAIRS), K6 a
# block's chunks in one (CHAIN), as the JAX kernels do
PAIRS, CHAIN = "pairs", "chain"
_S = 8          # rows per chunk of the JAX kernels (cfg.chunk_sublanes)
_RUN = 8        # slices per work item where each slice is folded alone
# The JAX slice kernel folds in tiles only where it unrolled a block's
# slice loop: at most this many chunk steps per block
# (spmv_topk_tpu/ops/kernel.py:576, :648)
_UNROLL_CHUNKS = 128
# work-item modes of the slice sweeps (csrc/slice_common.cuh, Mode)
WIDE, RUNS, TILED = range(3)


def topk_init(lane_k: int) -> np.ndarray:
    """(lane_k,) distinct finite sentinels, all below TOPK_FLOOR: the
    non-tie-safe update needs distinct slots, or the all-tied first update
    would fill the whole buffer with one candidate. Float32 arithmetic,
    as in the JAX package's ``_topk_init``."""
    return (np.float32(-2.8e38)
            - np.arange(lane_k, dtype=np.float32) * np.float32(1e32))


def octet_plan_rows(plan, num_blocks: int) -> np.ndarray:
    """int32 (B, 8) plan table of a tuple of OctetBucket.

    Raises if the buckets do not tile blocks [0, num_blocks) in order:
    the kernel trusts this table for every address it reads."""
    rows = []
    blk = octets = 0
    for pb in plan:
        if pb.blk_start != blk:
            raise ValueError(f"plan bucket at block {pb.blk_start}, "
                             f"expected {blk}")
        if pb.blocks_per_octet == 1:
            need = -(-pb.stride // pb.octets_per_block)
        else:
            need = pb.stride * pb.blocks_per_octet
        if need != pb.num_blocks:
            raise ValueError(f"bucket of width {pb.width} holds "
                             f"{pb.num_blocks} blocks, its octets need {need}")
        rows.append([pb.width, pb.octets_per_block, pb.blocks_per_octet,
                     pb.stride, pb.slice_base, pb.blk_start, pb.num_blocks,
                     octets])
        blk += pb.num_blocks
        octets += pb.stride
    if blk != num_blocks:
        raise ValueError(f"plan covers {blk} blocks of {num_blocks}")
    if octets >= 2**31:
        raise ValueError("more than 2^31 octets")
    return np.asarray(rows, np.int32).reshape(-1, len(PLAN_COLUMNS))


def prod_h16(w: torch.Tensor, table_row: torch.Tensor) -> torch.Tensor:
    """Per-word score contribution of the h16 codec: two nnz per word.

    Each 16-bit half is col[0:10) | val6[10:16); the query entry of col
    is the signed nibble (col >> 7) of table word (col & 127). Returns
    v0*q0 + v1*q1 in int32. The lane indices are masked; the shifts
    that feed a mask need no logical shift (the mask drops the
    sign-extended bits), and the value shifts are arithmetic on purpose.
    """
    i0 = (w & 0x7F).long()
    i1 = ((w >> 16) & 0x7F).long()
    g0 = table_row[i0]
    g1 = table_row[i1]
    nw = ~w
    sh0 = (nw >> 5) & 28            # 28 - 4 * (col0 >> 7)
    sh1 = (nw >> 21) & 28
    n0 = (g0 << sh0) >> 28          # nibble to the top, sign-extend down
    n1 = (g1 << sh1) >> 28
    v0 = (w << 16) >> 26
    v1 = w >> 26
    return v0 * n0 + v1 * n1


def _octet_tiles(words, row, block_sublanes, S):
    """(G, W, S, 128) view of one bucket: chunk j of octet o, member m."""
    W, opb, bpo, G, _, blk_start, nb, _ = row
    bs = block_sublanes
    blocks = words[blk_start * bs:(blk_start + nb) * bs]
    if bpo == 1:
        return blocks.reshape(nb, bs, LANES)[:, :opb * S * W].reshape(
            nb * opb, W, S, LANES)[:G]
    return blocks.reshape(G, bpo * bs, LANES)[:, :S * W].reshape(
        G, W, S, LANES)


def _octet_sums(words, table, row, block_sublanes, S, codec="h16",
                sum_order=PAIRS):
    """Yield (o0, sums) over one bucket: the member sums (g, S, 128) of
    octets o0 .. o0 + g - 1, a bounded number of words at a time. h16:
    int32 sums. The float codecs: float32 sums of each block span of the
    octet's chunks (all of them for a narrow octet), in two accumulators of
    the even and the odd chunks added together (PAIRS, K1 and K4) or in one
    (CHAIN, K6), each from 0; a wide octet's span sums added in block order
    from 0 (the JAX kernels' carry)."""
    W, G = row[0], row[3]
    tiles = _octet_tiles(words, row, block_sublanes, S)
    prod = codec_prod(codec)
    per = max(1, _STEP_WORDS // (W * S * LANES))
    span = block_sublanes // S
    for o0 in range(0, G, per):
        p = prod(tiles[o0:o0 + per], table)                  # (g, W, S, L)
        if codec == "h16":
            yield o0, p.sum(dim=1)
            continue
        parts = []
        for j0 in range(0, W, span):
            blk = p[:, j0:j0 + span]
            parts.append(_row_sum(blk[:, 0::2], 1) + _row_sum(blk[:, 1::2], 1)
                         if sum_order == PAIRS else _row_sum(blk, 1))
        yield o0, parts[0] if len(parts) == 1 else _row_sum(
            torch.stack(parts, dim=1), 1)


def _partitions(words, nreal, num_partitions: int):
    """[(words, nreal)] of each partition of a partition-major stream: P
    equal runs of ``words`` rows, ``nreal`` (P, B, 1), or (B, 1) when P
    is 1."""
    rows = words.shape[0] // num_partitions
    nr = nreal.reshape(num_partitions, -1)
    return [(words[p * rows:(p + 1) * rows], nr[p])
            for p in range(num_partitions)]


def _per_partition(one, words, table, nreal, plan_rows, num_partitions,
                   part_slices, **kw):
    """Single-partition plain sweep ``one`` over each partition, its tags
    offset by p * part_slices: (topv, topt) of (lane_k, 128) for one
    partition, (P, lane_k, 128) for P > 1 (a pool per partition)."""
    outs = [one(w, table, n, plan_rows, tag_offset=p * part_slices, **kw)
            for p, (w, n) in enumerate(_partitions(words, nreal,
                                                   num_partitions))]
    if num_partitions == 1:
        return outs[0]
    return torch.stack([v for v, _ in outs]), torch.stack([t for _, t in outs])


def octet_topk_plain(words, table, nreal, plan_rows, *,
                     num_partitions: int = 1, part_slices: int = 0, **kw):
    """Plain PyTorch version of the octet sweep: (topv, topt), each
    (lane_k, 128) ((P, lane_k, 128) with num_partitions P > 1), values
    sorted descending per lane. Keywords: lane_k, fold_tile, tie_safe,
    block_sublanes, chunk_sublanes (8), codec (h16), sum_order (PAIRS, K1's;
    CHAIN is K6's, ``_octet_sums``).

    Harvests the same candidates as the kernel and gives each lane its
    exact top-``lane_k`` of them, the initial sentinels included (``-inf``
    when ``tie_safe``, else ``topk_init``). That equals the sequential
    argmin replacement whenever values are distinct; at exact ties the
    replacement order decides which tied candidates (and, without
    ``tie_safe``, how many copies) stay, so only values above a lane's
    smallest kept value are comparable entry for entry.
    """
    return _per_partition(_octet_topk_one, words, table, nreal, plan_rows,
                          num_partitions, part_slices, **kw)


def _octet_topk_one(words, table, nreal, plan_rows, *, lane_k: int,
                    fold_tile: int, tie_safe: bool, block_sublanes: int,
                    chunk_sublanes: int = 8, codec: str = "h16",
                    sum_order: str = PAIRS, tag_offset: int = 0):
    """``octet_topk_plain`` of one partition, tags offset by tag_offset
    (the buffers' initial tags stay 0, as in the kernels)."""
    S = chunk_sublanes
    dev = words.device
    miota = torch.arange(S, device=dev, dtype=torch.int32).view(1, S, 1)
    cand_v, cand_t = [], []
    for b, row in enumerate(plan_rows.tolist()):
        G, slice_base = row[3], row[4] + tag_offset
        n_real = int(nreal.reshape(-1)[b])
        for o0, sums in _octet_sums(words, table, row, block_sublanes, S,
                                    codec, sum_order):
            acc = sums.to(torch.float32)                       # (g, S, L)
            oidx = torch.arange(o0, o0 + acc.shape[0], device=dev,
                                dtype=torch.int32).view(-1, 1, 1)
            member = oidx + miota * G                          # slice - base
            sc = torch.where(member < n_real, acc,
                             torch.full_like(acc, NEG_INF))
            if fold_tile == 1:
                cand_v.append(sc.reshape(-1, LANES))
                cand_t.append((slice_base + member).expand_as(sc)
                              .reshape(-1, LANES))
                continue
            for m1, sl in _harvest(sc, 1, _HARVEST):
                cand_v.append(m1.reshape(-1, LANES))
                cand_t.append((slice_base + oidx + sl * G).reshape(-1, LANES))
    return _merge_with_init(cand_v, cand_t, lane_k, tie_safe, dev)


def _harvest(sc, dim: int, rounds: int):
    """Yield ``rounds`` times the maximum along ``dim`` and the lowest
    index holding it, masking that entry to -inf each time (the JAX
    kernels' max / first-argmax fold). Both keep ``dim`` with size 1.

    As in the JAX kernels (``jnp.max``), a NaN score makes the maximum
    NaN: no index holds it (the index is the size of ``dim``), nothing is
    masked, and every round of that tile yields NaN, which the buffers
    never admit (``_merge_with_init``), so a NaN keeps the tile's other
    scores out of the harvest too."""
    n = sc.shape[dim]
    shape = [1] * sc.dim()
    shape[dim] = n
    iota = torch.arange(n, device=sc.device, dtype=torch.int32).view(shape)
    for _ in range(rounds):
        m = sc.amax(dim=dim, keepdim=True)
        sl = torch.where(sc == m, iota, n).amin(dim=dim, keepdim=True)
        yield m, sl
        sc = torch.where(iota == sl, NEG_INF, sc)


def _merge_with_init(cand_v, cand_t, lane_k, tie_safe, dev):
    """Per-lane top-``lane_k`` of the candidates and the buffers' initial
    entries (-inf when ``tie_safe``, else ``topk_init``'s sentinels). A
    NaN candidate never enters, as in the kernels' argmin replacement
    (``score >= minimum`` is false): it counts as -inf, below every
    sentinel, and where it ties a -inf slot only that slot's tag (loose
    at -inf anyway) can differ."""
    cand_v = [torch.where(torch.isnan(v), NEG_INF, v) for v in cand_v]
    if tie_safe:
        init = torch.full((lane_k, LANES), NEG_INF, device=dev)
    else:
        init = torch.from_numpy(topk_init(lane_k)).to(dev).view(-1, 1) \
            .expand(lane_k, LANES)
    tags0 = torch.zeros((lane_k, LANES), dtype=torch.int32, device=dev)
    return merge_lane_topk(torch.cat(cand_v + [init]),
                           torch.cat(cand_t + [tags0]), lane_k)


def octet_topk_batch_plain(words, tables, nreal, plan_rows, **kw):
    """Plain PyTorch version of the multi-query sweep: ``octet_topk_plain``
    in K6's summation order (CHAIN) for each query of the (Q, rows, 128)
    tables -> (topv, topt), each (Q, lane_k, 128) ((Q, P, lane_k, 128)
    with P > 1 partitions). Keyword arguments as for ``octet_topk_plain``
    but sum_order."""
    outs = [octet_topk_plain(words, t, nreal, plan_rows, sum_order=CHAIN,
                             **kw) for t in tables]
    return torch.stack([v for v, _ in outs]), torch.stack([t for _, t in outs])


def octet_topk_batch_slots_plain(words, tables, nreal, plan_rows, *,
                                 num_slots: int, lane_k: int, fold_tile: int,
                                 tie_safe: bool, block_sublanes: int,
                                 codec: str, num_partitions: int = 1,
                                 part_slices: int = 0,
                                 chunk_sublanes: int = 8,
                                 merged: bool = True):
    """Plain version of K6 (K10d with P > 1 partitions) as the kernels
    compute it, every codec (h16: ``csrc/octet_topk_batch_h16.cu``; the
    others: ``csrc/octet_topk_batch.cuh``), on ``num_slots`` slots a
    partition and pass (``k6_launch``): for each query of the (Q, rows,
    128) tables of ``codec`` and each partition, the octets' member scores
    in K6's order (CHAIN, ``_octet_sums``: h16 exact int32 sums, the other
    codecs one float accumulator a member from 0 in chunk order, a block
    span at a time, a wide octet's span sums added in block order), and
    slot j harvests the plan's octets j, j + num_slots, ... that hold a
    real member, in order, into lane buffers from ``topk_init``'s entries
    (-inf when ``tie_safe``): the top 3 of the 8 members (each member with
    ``fold_tile`` 1) by argmin replacement (when score >= the minimum: the
    first slot holding it when tie-safe, else every one); then
    ``lane_merge_plain`` over every slot's entries, the initial ones
    included -> (topv, topt), each (Q, lane_k, 128) ((Q, P, lane_k, 128)
    for P > 1 partitions), tags offset by p * part_slices in partition p.
    The kernels give these pairs bit for bit, tags and ties included,
    however the queries split into passes: on any data for h16 and f32,
    and for int8x4, i8s and i4s on words whose field shift the packer
    wrote (``encode_words_sign_layout``: an i8s shift a multiple of 8, an
    i4s shift a multiple of 4; int8x4's is by its decode), which the
    kernel's pass tables assume (csrc/codecs.cuh::Bf16Pass). With
    ``merged`` False, each slot's buffer in the merge's order, (Q, P,
    slots, lane_k, 128), as the kernels' unmerged launch leaves them.
    Against ``octet_topk_batch_plain``: the same values whenever the
    buffers are tie-safe, and the same (value, tag) pairs above each
    lane's smallest kept value."""
    outs = [_slot_pools(words, table, nreal, plan_rows, num_slots=num_slots,
                        lane_k=lane_k, fold_tile=fold_tile, tie_safe=tie_safe,
                        block_sublanes=block_sublanes, S=chunk_sublanes,
                        codec=codec, sum_order=CHAIN, runs=False,
                        num_partitions=num_partitions,
                        part_slices=part_slices, merged=merged)
            for table in tables]
    return torch.stack([v for v, _ in outs]), torch.stack([t for _, t in outs])


def octet_topk_slots_plain(words, table, nreal, plan_rows, *, num_slots: int,
                           lane_k: int, fold_tile: int, tie_safe: bool,
                           block_sublanes: int, codec: str = "h16",
                           num_partitions: int = 1, part_slices: int = 0,
                           chunk_sublanes: int = 8, merged: bool = True):
    """Plain version of K1 (K10b with P > 1 partitions) as the kernel
    computes it, on ``num_slots`` slots a partition (``octet_topk_grid``):
    each slot takes a contiguous run of the partition's octets
    (``k1_deal``) and harvests those that hold a real member, in order,
    into lane buffers
    from ``topk_init``'s entries (-inf when ``tie_safe``): the top 3 of the
    8 member scores (each member with ``fold_tile`` 1), summed in K1's
    order (PAIRS, ``_octet_sums``), by argmin replacement (when score >=
    the minimum: the first slot holding it when tie-safe, else every one);
    then ``lane_merge_plain`` over every slot's entries, the initial ones
    included -> (topv, topt), each (lane_k, 128) ((P, lane_k, 128) for P >
    1), tags offset by p * part_slices in partition p. The kernel gives
    these pairs bit for bit on any data, tags and ties included; with
    ``merged`` False, each slot's buffer in the merge's order, (P, slots,
    lane_k, 128), as the kernel's unmerged launch leaves them. Against
    ``octet_topk_plain``: the same values whenever the buffers are
    tie-safe, and the same (value, tag) pairs above each lane's smallest
    kept value."""
    return _slot_pools(words, table, nreal, plan_rows, num_slots=num_slots,
                       lane_k=lane_k, fold_tile=fold_tile, tie_safe=tie_safe,
                       block_sublanes=block_sublanes, S=chunk_sublanes,
                       codec=codec, sum_order=PAIRS, runs=True,
                       num_partitions=num_partitions, part_slices=part_slices,
                       merged=merged)


def _slot_pools(words, table, nreal, plan_rows, *, num_partitions,
                part_slices, merged, lane_k, one=None, **kw):
    """The slot plain of one query table (``one`` of each partition, by
    default ``_octet_slots_one``): merged, (lane_k, 128) ((P, lane_k, 128)
    for P > 1); else each slot's sorted buffer, (P, slots, lane_k, 128)."""
    one = one or _octet_slots_one
    parts = [one(w, table, n, plan_rows, lane_k=lane_k,
                 tag_offset=p * part_slices, **kw)
             for p, (w, n) in enumerate(_partitions(words, nreal,
                                                    num_partitions))]
    if merged:
        parts = [lane_merge_plain(v, t, lane_k) for v, t in parts]
        if num_partitions == 1:
            return parts[0]
    else:
        parts = [_sorted_lists(v, t) for v, t in parts]
    return torch.stack([v for v, _ in parts]), torch.stack([t for _, t in parts])


def _sorted_lists(v, t):
    """Each (K, 128) buffer of (..., K, 128) values and tags in the
    merge's order (value descending, then tag ascending; no NaN), as
    ``lane_merge_plain`` sorts one."""
    o = torch.argsort(t, dim=-2, stable=True)
    v, t = v.gather(-2, o), t.gather(-2, o)
    o = torch.argsort(v, dim=-2, descending=True, stable=True)
    return v.gather(-2, o), t.gather(-2, o)


def octet_real_chunks(plan_rows, nreal) -> torch.Tensor:
    """Each octet's chunks (its bucket's width) in plan order, 0 for an
    octet with no real member, which the sweeps skip: (octets,) int64 on
    the CPU, for one partition's ``nreal`` (B, 1)."""
    n_real = nreal.reshape(-1).tolist()
    return torch.cat([
        torch.full((row[3],), row[0], dtype=torch.long)
        * (torch.arange(row[3]) < n_real[b])
        for b, row in enumerate(plan_rows.tolist())])


def k1_deal(plan_rows, nreal, num_slots: int,
            octet_cost: int = K1_OCTET_COST) -> torch.Tensor:
    """K1's static deal (``csrc/octet_topk.cuh::slot_walk``): the slot of
    each of one partition's octets, in plan order, (octets,) int64 on the
    CPU. Each of the ``num_slots`` slots takes a contiguous run of about
    equal work, an octet's work w(o) its chunks plus ``octet_cost`` (0
    when it holds no real member); octet o goes to the slot holding its
    work's midpoint, floor((2 c(o) + w(o)) * num_slots / (2 C)), c(o) the
    work before it and C the partition's. The kernel deals with
    K1_OCTET_COST; other costs are for measuring the deal."""
    chunks = octet_real_chunks(plan_rows, nreal)
    work = (chunks + octet_cost) * (chunks > 0)
    mid2 = 2 * torch.cumsum(work, 0) - work   # twice each midpoint
    return (mid2 * num_slots // max(2 * int(work.sum()), 1)).clamp(
        max=num_slots - 1)


def _octet_slots_one(words, table, nreal, plan_rows, *, num_slots, lane_k,
                     fold_tile, tie_safe, block_sublanes, S, tag_offset,
                     codec, sum_order, runs):
    """The slot plains' slots of one query and one partition, before the
    merge: (values, tags), each (num_slots, lane_k, 128). The plan's
    octets go to the slots one a slot in turn (octets j, j + num_slots,
    ... to slot j: K6 h16), or (``runs``: K1) by ``k1_deal``."""
    dev = words.device
    K = lane_k
    miota = torch.arange(S, device=dev, dtype=torch.int32).view(1, S, 1)
    # each octet's harvest steps in plan order: (octets, steps, 1, 128)
    scores, tags, real = [], [], []
    for b, row in enumerate(plan_rows.tolist()):
        G, base = row[3], row[4] + tag_offset
        n_real = int(nreal.reshape(-1)[b])
        sc = torch.cat([x for _, x in _octet_sums(
            words, table, row, block_sublanes, S, codec, sum_order)]).float()
        oidx = torch.arange(G, device=dev, dtype=torch.int32).view(-1, 1, 1)
        member = oidx + miota * G
        sc = torch.where(member < n_real, sc, torch.full_like(sc, NEG_INF))
        if fold_tile == 1:
            steps = [(sc[:, m:m + 1], base + member[:, m:m + 1])
                     for m in range(S)]
        else:
            steps = [(m1, base + oidx + sl * G)
                     for m1, sl in _harvest(sc, 1, _HARVEST)]
        scores.append(torch.stack([v for v, _ in steps], dim=1))
        tags.append(torch.stack([t.int().expand_as(v) for v, t in steps],
                                dim=1))
        real.append(oidx.view(-1) < n_real)
    scores, tags, real = torch.cat(scores), torch.cat(tags), torch.cat(real)
    n = scores.shape[0]
    # slot of each octet and its turn within the slot: (turns, slots) of
    # octet indices, n (an octet that is not real) where a slot has none
    if runs:
        slot = k1_deal(plan_rows, nreal, num_slots).to(dev)
        turn = torch.arange(n, device=dev) - torch.searchsorted(
            slot, slot, right=False)
    else:
        slot = torch.arange(n, device=dev) % num_slots
        turn = torch.arange(n, device=dev) // num_slots
    turns = int(turn.max()) + 1 if n else 0
    order = torch.full((turns, num_slots), n, dtype=torch.long, device=dev)
    order[turn, slot] = torch.arange(n, device=dev)
    pad = lambda x: torch.cat([x, x.new_zeros((1, *x.shape[1:]))])  # noqa: E731
    scores, tags, real = pad(scores)[order], pad(tags)[order], pad(real)[order]
    init = (torch.full((K,), NEG_INF, device=dev) if tie_safe else
            torch.from_numpy(topk_init(K)).to(dev))
    v = init.view(1, K, 1).expand(num_slots, K, LANES).clone()
    t = torch.zeros((num_slots, K, LANES), dtype=torch.int32, device=dev)
    kslot = torch.arange(K, device=dev).view(1, K, 1)
    for i in range(turns):
        ok = real[i].view(num_slots, 1, 1)
        for step in range(scores.shape[2]):
            score = scores[i, :, step]
            cur = v.amin(dim=1, keepdim=True)
            hit = v == cur
            if tie_safe:
                hit = kslot == hit.int().argmax(dim=1, keepdim=True)
            rep = hit & (score >= cur) & ok
            v = torch.where(rep, score, v)
            t = torch.where(rep, tags[i, :, step], t)
    return v, t


def octet_scores_plain(words, table, nreal, plan_rows, *, num_slices: int,
                       block_sublanes: int, chunk_sublanes: int = 8,
                       num_partitions: int = 1, codec: str = "h16",
                       row_ids=None, scale: float = 1.0, out=None):
    """Plain PyTorch version of the octet SpMV: (num_slices, 128) f32, row
    s holding slice s's 128 unscaled row scores (K1's sums). Member m of
    octet o of a bucket is slice slice_base + o + m * stride; rows of no
    real slice (the sentinel slice) stay 0. With P partitions, partition
    p's slices fill rows p * part_slices .., part_slices = num_slices / P.

    With ``row_ids`` ((num_slices, 128) int32) the row-order form: those
    scores scaled into ``out`` (``scores_to_rows``), which it returns."""
    S = chunk_sublanes
    sc = torch.zeros((num_slices, LANES), dtype=torch.float32,
                     device=words.device)
    part_slices = num_slices // num_partitions
    for p, (w, nr) in enumerate(_partitions(words, nreal, num_partitions)):
        for b, row in enumerate(plan_rows.tolist()):
            slice_base = p * part_slices + row[4]
            n_real = int(nr[b])
            sums = torch.cat([s for _, s in _octet_sums(w, table, row,
                                                         block_sublanes, S,
                                                         codec)])
            # (octet, member) -> (member, octet): the flat index is the slice
            sc[slice_base:slice_base + n_real] = sums.transpose(
                0, 1).reshape(-1, LANES)[:n_real].to(torch.float32)
    return sc if row_ids is None else scores_to_rows(sc, row_ids, scale, out)


def score_factor(scale) -> float:
    """The float32 factor the row-order stores multiply each score by:
    ``scale`` rounded to float32, as torch rounds a Python scalar before it
    multiplies a float32 tensor by it."""
    return float(np.float32(scale))


def scores_to_rows(sc, row_ids, scale, out):
    """Slice-order scores (num_slices, 128) into row order, the plain form
    of K4's and K9's row-order store: out[row] = sc[s, lane] * factor
    (``score_factor(scale)``, one rounded float32 multiply) for each slice
    lane whose row row_ids[s, lane] is >= 0; other rows of ``out`` are left.
    Returns ``out``."""
    rows = row_ids.reshape(-1).long()
    keep = rows >= 0
    out[rows[keep]] = sc.reshape(-1)[keep] * score_factor(scale)
    return out


def merge_lane_topk(topv, topt, lane_k: int, lead: int = 0):
    """Per-lane top-``lane_k`` over stacked candidates ((..., 128) values
    and tags) -> (lane_k, 128) pair, values sorted descending. The first
    ``lead`` axes are kept apart (queries, partitions): (*lead axes, ...,
    128) -> (*lead axes, lane_k, 128)."""
    shape = (*topv.shape[:lead], -1, LANES)
    allv = topv.reshape(shape)
    allt = topt.reshape(shape)
    mv, mi = torch.topk(allv, lane_k, dim=lead)
    return mv, torch.gather(allt, lead, mi)


def _table_spec(cfg: TopKSpMVConfig):
    """(rows, dtype) of one query table of the codec (``pack_query_table``:
    h16 one int4x8 row; the others a row of 128 entries of TABLE_FIELDS
    columns: f32 128 columns, int8x4 and i8s 512, i4s 1024)."""
    codec = cfg.query_codec
    per_row = cfg.max_cols if codec == "h16" else LANES * TABLE_FIELDS[codec]
    dtype = torch.float32 if cfg.query_codec == "f32" else torch.int32
    return -(-cfg.max_cols // per_row), dtype


def tables_in_smem(table_bytes: int, smem_limit: int) -> int:
    """How many query tables of ``table_bytes`` bytes a CUDA block can
    hold in ``smem_limit`` bytes of shared memory: the largest power of two
    up to MAX_BATCH_SUBGROUP (the old batch sweeps sized their tables for
    their subgroup rounded up to one, and cut the subgroup to it), or 0
    when not even one fits: the sweeps then gather from the tables in
    global memory (f32 only, codec "f32_global": no other codec's table
    comes near; the batch sweeps K6, K8 and K12 size theirs with
    ``k6_pass``, ``k8_pass``, ``k12_pass``)."""
    if table_bytes > smem_limit:
        return 0
    fit = 1
    while fit < MAX_BATCH_SUBGROUP and 2 * fit * table_bytes <= smem_limit:
        fit *= 2
    return fit


# per CUDA device index: (SM count, shared memory a block may opt in to)
_DEVICE_INFO = {}
# (device index, codec, table rows) -> _kernel_codec's answer
_KERNEL_CODEC = {}


def _device_info(dev):
    """(SM count, opt-in shared memory bytes a block) of CUDA ``dev``,
    read once per device."""
    info = _DEVICE_INFO.get(dev.index)
    if info is None:
        props = torch.cuda.get_device_properties(dev)
        info = _DEVICE_INFO[dev.index] = (
            props.multi_processor_count, props.shared_memory_per_block_optin)
    return info


def _kernel_codec(dev, codec: str, rows: int):
    """(codec argument of the kernels, tables per CUDA block) on ``dev``
    for a table of ``rows`` rows: the codec's index in KERNEL_CODECS and
    ``tables_in_smem`` of its table (h16's batch sweeps repack a
    subgroup's 512-byte tables into one of 4 KB: always 8); with none, f32
    read from global memory and a subgroup of any size."""
    key = (dev.index, codec, rows)
    got = _KERNEL_CODEC.get(key)
    if got is not None:
        return got
    fit = tables_in_smem(rows * LANES * 4, _device_info(dev)[1])
    if fit:
        got = KERNEL_CODECS.index(codec), fit
    elif codec != "f32":
        raise ValueError(f"a {codec} table of {rows} rows does not fit "
                         "shared memory")
    else:
        got = KERNEL_CODECS.index("f32_global"), MAX_BATCH_SUBGROUP
    _KERNEL_CODEC[key] = got
    return got


def _check_inputs(words, nreal, plan_rows, block_sublanes, num_partitions,
                  *named, plan_cols=len(PLAN_COLUMNS)):
    """Raise unless words (P equal runs of whole blocks), nreal ((B, 1),
    or (P, B, 1) for P > 1 partitions), plan_rows ((B, plan_cols)) and
    each (name, tensor, shape[, dtype]) of ``named`` are contiguous
    tensors of those shapes (int32 unless a dtype is given) on one CUDA
    device. Returns the device's SM count."""
    dev = words.device
    if dev.type != "cuda":
        raise ValueError(f"words on {dev}: the kernels need CUDA")
    B = plan_rows.shape[0]
    P = num_partitions
    if P < 1:
        raise ValueError(f"num_partitions={P}")
    for name, t, shape, *dtype in (
            ("words", words, (words.shape[0], LANES)),
            ("nreal", nreal, (B, 1) if P == 1 else (P, B, 1)),
            ("plan_rows", plan_rows, (B, plan_cols)), *named):
        dtype = dtype[0] if dtype else torch.int32
        if t.device != dev or t.dtype != dtype or \
                tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name}: need contiguous {dtype} {shape} on "
                             f"{dev}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    if words.shape[0] % (P * block_sublanes):
        raise ValueError(f"words rows are not {P} runs of whole blocks")
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _sweep_blocks(sms: int, part_rows: int, num_partitions: int) -> int:
    """CUDA blocks per partition of the sweep K4 (K1 and K7 have their own
    grid, ``octet_grid``, K9 ``slice_scores_grid``): the card's sms *
    _BLOCKS_PER_SM shared among the partitions, and no more than a
    partition has chunks (every octet holds at least one)."""
    return max(1, min(-(-sms * _BLOCKS_PER_SM // num_partitions),
                      part_rows // _S))


def _launch(dev, name, *args):
    """Call C entry point ``name`` of the kernel library with ``args``
    and ``dev``'s current stream; raise if the launch failed."""
    lib = _build.lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, name)(*args, stream)
    _build.check(err, name)


def _check_lane_k(lane_k):
    if lane_k not in KERNEL_LANE_K:
        raise ValueError(f"lane_k={lane_k}: the kernels are built for "
                         f"{KERNEL_LANE_K}")


def _check_sweep(lane_k, fold_tile, chunk_sublanes):
    _check_lane_k(lane_k)
    if chunk_sublanes != 8 or fold_tile not in (1, 8):
        raise ValueError("the octet kernels need chunk_sublanes=8 and "
                         "fold_tile 1 or 8")


def _sweep_kw(cfg: TopKSpMVConfig, block_sublanes: int) -> dict:
    return dict(lane_k=cfg.lane_k, fold_tile=cfg.fold_tile,
                tie_safe=bool(cfg.tie_safe_topk), block_sublanes=block_sublanes,
                chunk_sublanes=cfg.chunk_sublanes, codec=cfg.query_codec)


def _part_slices(num_partitions: int, part_slices: int) -> int:
    """The tag offset between partitions: part_slices for P > 1, 0 for
    one partition."""
    if num_partitions > 1 and part_slices < 1:
        raise ValueError(f"{num_partitions} partitions need part_slices "
                         f">= 1, got {part_slices}")
    return part_slices if num_partitions > 1 else 0


def topk_spmv_fused_octet_device(words, table, nreal, plan_rows, *,
                                 cfg: TopKSpMVConfig, block_sublanes: int,
                                 num_partitions: int = 1,
                                 part_slices: int = 0):
    """Octet sweep: per-lane (topv, topt) candidates (K1; with P =
    num_partitions > 1, K10b).

    words: (P * num_blocks * block_sublanes, 128) int32 octet stream.
    table: the query table of cfg.query_codec (``pack_query_table``;
    ``_table_spec``: (1, 128) int32 for h16, (max_cols / 128, 128) float32
    for f32, (rows, 128) int32 for int8x4, i8s, i4s).
    nreal: (B, 1) int32 real slices per bucket; (P, B, 1) for P > 1.
    plan_rows: (B, 8) int32 plan table (octet_plan_rows).
    part_slices: slice tags per partition (P > 1): partition p's tags are
    offset by p * part_slices.
    Returns (topv f32, topt i32), each (lane_k, 128) ((P, lane_k, 128)
    for P > 1), sorted descending.

    CPU tensors run the plain version; CUDA tensors launch the kernel, one
    launch that returns the merged pair (``_octet_topk_cuda``).
    """
    kw = _sweep_kw(cfg, block_sublanes)
    ps = _part_slices(num_partitions, part_slices)
    if words.device.type == "cpu":
        return octet_topk_plain(words, table, nreal, plan_rows,
                                num_partitions=num_partitions,
                                part_slices=ps, **kw)
    return _octet_topk_cuda(words, table, nreal, plan_rows, num_partitions,
                            ps, cfg, block_sublanes)


def _octet_topk_cuda(words, table, nreal, plan_rows, P, part_slices, cfg,
                     block_sublanes, *, unmerged=False):
    """K1's launch on CUDA tensors, for ``topk_spmv_fused_octet_device``
    (which passes P and the tag offset; the sweep's codec, lane_k, fold and
    buffers are cfg's, as ``octet_topk_grid`` reads them): one
    launch that returns the merged pair, its lane merge on the card
    (``octet_topk_slots_plain`` on ``octet_topk_grid``'s slots computes
    what it gives), and no torch op after it; with ``unmerged`` each slot's
    buffer, sorted (value descending, then tag ascending), (P, slots,
    lane_k, 128) values and tags, the merge not run, for timing the sweep
    alone. The merge's lists reuse the table's shared memory once the
    sweep is done, so a table keeps the block's whole opt-in budget
    (``_kernel_codec``)."""
    B = plan_rows.shape[0]
    K = cfg.lane_k
    rows, dtype = _table_spec(cfg)
    _check_inputs(words, nreal, plan_rows, block_sublanes, P,
                  ("table", table, (rows, LANES), dtype))
    _check_sweep(K, cfg.fold_tile, cfg.chunk_sublanes)
    dev = words.device
    arg, _ = _kernel_codec(dev, cfg.query_codec, rows)
    part_rows = words.shape[0] // P
    blocks, slots = octet_topk_grid(dev, cfg, part_rows, P)
    sets = _merge_sets(blocks)
    lib = _build.lib()
    with (contextlib.nullcontext() if torch.cuda.current_device() == dev.index
          else torch.cuda.device(dev)):
        stream = torch._C._cuda_getCurrentRawStream(dev.index)
        if unmerged:
            ws = torch.empty(P * slots * 2 * K * LANES, dtype=torch.int32,
                             device=dev)
            tickets = torch.zeros(1, dtype=torch.int32, device=dev)
        else:
            ws, tickets = _merge_workspace("k1", dev, stream,
                                           P * (blocks + sets) * 2 * K * LANES,
                                           P * (1 + sets))
        lists = ws.numel() // (2 * K * LANES)
        out_v = torch.empty((P, K, LANES), dtype=torch.float32, device=dev)
        out_t = torch.empty((P, K, LANES), dtype=torch.int32, device=dev)
        # the arguments as int64 values, in csrc/octet_topk.cu's order
        args = array.array("q", (
            words.data_ptr(), table.data_ptr(), nreal.data_ptr(),
            plan_rows.data_ptr(), B, block_sublanes, rows, arg, K,
            int(cfg.fold_tile == 1), int(bool(cfg.tie_safe_topk)), blocks, P,
            part_rows, part_slices, int(not unmerged), ws.data_ptr(), lists,
            tickets.data_ptr(), tickets.numel(), out_v.data_ptr(),
            out_t.data_ptr(), stream))
        err = lib.octet_topk(args.buffer_info()[0])
    _build.check(err, "octet_topk")
    topk_spmv_fused_octet_device.launches += 1
    if unmerged:
        n = P * slots * K * LANES
        return (ws[:n].view(torch.float32).view(P, slots, K, LANES),
                ws[lists * K * LANES:][:n].view(P, slots, K, LANES))
    if P == 1:
        return out_v[0], out_t[0]
    return out_v, out_t


def octet_grid(sms: int, partitions: int = 1, per_sm: int = 1,
               chunks: int | None = None):
    """K1's grid (``csrc/octet_topk.cuh``): (CUDA blocks, slots) a
    partition. One resident wave: the card's ``sms`` x ``per_sm`` blocks
    (the occupancy API's resident blocks an SM) shared among the
    partitions, rounded down, at least one; no more blocks than give each
    of a partition's ``chunks`` chunks a slot (an octet holds at least
    one). A block is K1_GROUPS slots of 128 lanes, each a lane buffer of
    lane_k entries, so a lane's merge takes slots * lane_k entries."""
    blocks = max(1, sms * per_sm // partitions)
    if chunks is not None:
        blocks = max(1, min(blocks, -(-chunks // K1_GROUPS)))
    return blocks, blocks * K1_GROUPS


def octet_topk_grid(dev, cfg: TopKSpMVConfig, part_rows: int,
                    num_partitions: int = 1):
    """K1's (CUDA blocks, slots) a partition on CUDA ``dev`` for cfg's
    codec, lane_k, fold and buffers, on partitions of ``part_rows`` rows
    of words: ``octet_grid`` of the kernel's resident blocks an SM."""
    rows, _ = _table_spec(cfg)
    arg, _ = _kernel_codec(dev, cfg.query_codec, rows)
    per_sm = _resident_blocks(dev, "octet_topk_occupancy", arg, cfg.lane_k,
                              int(cfg.fold_tile == 1),
                              int(bool(cfg.tie_safe_topk)), rows)
    return octet_grid(_device_info(dev)[0], num_partitions, per_sm,
                      part_rows // cfg.chunk_sublanes)


def _resident_blocks(dev, entry: str, *args) -> int:
    """Resident CUDA blocks an SM of a kernel on ``dev``, from the
    occupancy API through the C entry point ``entry(*args)`` (K13's
    ``bucket_topk_occupancy``, K1's ``octet_topk_occupancy``), read once
    per (entry, device, arguments)."""
    key = (entry, dev.index, *args)
    n = _OCCUPANCY.get(key)
    if n is None:
        with torch.cuda.device(dev):
            n = getattr(_build.lib(), entry)(*args)
        if n < 1:
            raise RuntimeError(f"{entry}{args}: occupancy {n}")
        _OCCUPANCY[key] = n
    return n


topk_spmv_fused_octet_device.launches = 0


def batch_grid(num_queries: int, subgroup: int, sms: int, chunks: int,
               partitions: int = 1):
    """The grid of the batch sweeps before K8, K6 and K12 read the stream
    once a pass (the old kernels of experiments/k8_ablation.py,
    k6_ablation.py and k12_ablation.py): (queries per CUDA block,
    subgroups, slots per partition).

    ``subgroup`` is cfg.batch_subgroup (0: BATCH_SUBGROUP), capped at
    MAX_BATCH_SUBGROUP and at the query count. The stream is read once
    per subgroup. Slots are sized so that slots * subgroups * partitions
    fills the card as K1's grid does, with at least one slot per SM over
    the partitions, and no more slots than a partition has chunks; each
    slot writes lane_k * 128 (value, tag) pairs per query, so a group's
    buffers are Q * partitions * slots * lane_k * 1 KiB."""
    sub = min(subgroup or BATCH_SUBGROUP, MAX_BATCH_SUBGROUP, num_queries)
    n_sub = -(-num_queries // sub)
    slots = max(-(-sms // partitions),
                -(-sms * _BLOCKS_PER_SM // (n_sub * partitions)))
    return sub, n_sub, max(1, min(slots, chunks))


def octet_h16_grid(num_queries: int, sms: int, partitions: int = 1,
                   lane_k: int = 8):
    """K6 h16's grid (``csrc/octet_topk_batch_h16.cu``): (passes, slots).

    A pass sweeps the stream once for up to H16_PASS_QUERIES queries; the
    passes, partitions and the 128 / H16_BLOCK_LANES[lane_k] lane groups
    of a slot are CUDA blocks of their own, one an SM: slots per partition
    and pass are the SMs over those (rounded down, so that no block waits
    for a second wave), at least one. Each slot writes lane_k * 128
    (value, tag) pairs per query."""
    passes = -(-num_queries // H16_PASS_QUERIES)
    groups = LANES // H16_BLOCK_LANES[lane_k]
    return passes, max(1, sms // (groups * partitions * passes))


def topk_spmv_fused_batch_octet_device(words, tables, nreal, plan_rows, *,
                                       cfg: TopKSpMVConfig,
                                       block_sublanes: int,
                                       num_partitions: int = 1,
                                       part_slices: int = 0):
    """Multi-query octet sweep (K6; with P > 1 partitions, K10d).

    tables: (Q, rows, 128) query tables of cfg.query_codec
    (``pack_query_tables``); the other arguments as for
    ``topk_spmv_fused_octet_device``. Returns (topv f32, topt i32), each
    (Q, lane_k, 128) ((Q, P, lane_k, 128) for P > 1), sorted descending
    per lane: each query's candidates are those of the single-query sweep
    (for the float codecs, summed in K6's order, CHAIN).
    ``cfg.batch_subgroup`` is not read.

    CPU tensors run the plain version; CUDA tensors launch the kernel, one
    launch that returns the merged pairs (``octet_topk_batch_cuda``: the
    stream read once a pass of queries, ``k6_launch``, and the lane merge
    on the card).
    """
    kw = _sweep_kw(cfg, block_sublanes)
    ps = _part_slices(num_partitions, part_slices)
    if words.device.type == "cpu":
        return octet_topk_batch_plain(words, tables, nreal, plan_rows,
                                      num_partitions=num_partitions,
                                      part_slices=ps, **kw)
    return octet_topk_batch_cuda(words, tables, nreal, plan_rows,
                                 num_partitions, ps, cfg, **kw)


def k6_smem_bytes(codec: str, pass_queries: int, lane_k: int,
                  table_rows: int) -> int:
    """K6's dynamic shared memory a block (csrc/batch_sweep.cuh::Smem) for
    a kernel codec but h16 (KERNEL_CODECS) and pass: the pass's table (f32
    the tables side by side, FloatPass; none for f32_global and
    int8x4_global; int8x4, i8s and i4s a bf16 value a field and query,
    Bf16Pass), the member sums, the (lane, query) buffers, their minima
    and the harvest queue."""
    Q = pass_queries
    cols = table_rows * LANES
    if codec.endswith("_global"):
        table = 0
    elif codec == "f32":
        table = 4 * Q * cols
    else:
        table = 2 * Q * TABLE_FIELDS[codec] * cols
    return _pass_smem_bytes(codec, Q, lane_k, table)


def k6_pass(codec: str, num_queries: int, lane_k: int, table_rows: int,
            smem_limit: int, pass_queries: int | None = None):
    """K6's (kernel codec, queries a pass) for ``num_queries`` queries of
    the config's ``codec`` but h16: passes of 8, or 16 for more than 8
    queries; a pass whose table does not fit ``smem_limit`` bytes beside
    the rest (``k6_smem_bytes``) takes the next smaller one: 8, then f32
    and int8x4 tables are read from global memory (``f32_global``,
    ``int8x4_global``, in passes of 8; i8s and i4s tables are at most 2
    rows). ``pass_queries`` forces the pass (one of
    K6_PASS_QUERIES[codec], the table in shared memory)."""
    if pass_queries is not None:
        if pass_queries not in K6_PASS_QUERIES[codec]:
            raise ValueError(f"a {codec} pass of {pass_queries} queries: K6 "
                             f"takes {K6_PASS_QUERIES[codec]}")
        if k6_smem_bytes(codec, pass_queries, lane_k,
                         table_rows) > smem_limit:
            raise ValueError(f"a {codec} pass of {pass_queries} queries "
                             f"and {table_rows} table rows does not fit "
                             "shared memory")
        return codec, pass_queries
    first = 8 if num_queries <= 8 else 16
    for qp in (16, 8):
        if qp <= first and \
                k6_smem_bytes(codec, qp, lane_k, table_rows) <= smem_limit:
            return codec, qp
    if codec not in ("f32", "int8x4"):
        raise ValueError(f"a {codec} table of {table_rows} rows does not fit "
                         "shared memory")
    return f"{codec}_global", 8


def k6_launch(dev, cfg: TopKSpMVConfig, num_queries: int, partitions: int,
              pass_queries: int | None = None):
    """K6's launch shape on CUDA ``dev`` for cfg's codec and lane_k:
    (kernel codec, queries a pass, passes, slots). h16 reads the stream
    once a pass of H16_PASS_QUERIES (``octet_h16_grid``); the other codecs
    in ``k6_pass``'s passes."""
    sms, limit = _device_info(dev)
    if cfg.query_codec == "h16":
        if pass_queries not in (None, H16_PASS_QUERIES):
            raise ValueError(f"K6 h16 takes passes of {H16_PASS_QUERIES}")
        return ("h16", H16_PASS_QUERIES,
                *octet_h16_grid(num_queries, sms, partitions, cfg.lane_k))
    rows, _ = _table_spec(cfg)
    codec, qp = k6_pass(cfg.query_codec, num_queries, cfg.lane_k, rows,
                        limit, pass_queries)
    return (codec, qp, *pass_grid(num_queries, sms, qp, cfg.lane_k, codec,
                                  partitions))


def octet_topk_batch_cuda(words, tables, nreal, plan_rows, P, part_slices,
                          cfg, *, lane_k, fold_tile, tie_safe,
                          block_sublanes, chunk_sublanes, codec,
                          unmerged=False, pass_queries=None):
    """K6's launch on CUDA tensors, for ``topk_spmv_fused_batch_octet_device``
    (which passes P, the tag offset and the config's sweep keywords): one
    launch that returns the merged pairs, its lane merge on the card
    (``octet_topk_batch_slots_plain`` on ``k6_launch``'s slots computes
    what it gives), and no torch op after it; with ``unmerged`` each slot's
    buffers, sorted (value descending, then tag ascending), (Q, P, slots,
    lane_k, 128) values and tags, the merge not run, for timing the sweep
    alone. h16 runs ``csrc/octet_topk_batch_h16.cu``, the other codecs
    ``csrc/octet_topk_batch.cuh`` (``pass_queries`` forces their pass,
    ``k6_pass``)."""
    B = plan_rows.shape[0]
    Q = tables.shape[0]
    if Q < 1:
        raise ValueError("no queries")
    rows, dtype = _table_spec(cfg)
    _check_inputs(words, nreal, plan_rows, block_sublanes, P,
                  ("tables", tables, (Q, rows, LANES), dtype))
    _check_sweep(lane_k, fold_tile, chunk_sublanes)
    dev = words.device
    part_rows = words.shape[0] // P
    kcodec, qp, passes, slots = k6_launch(dev, cfg, Q, P, pass_queries)
    sets = _merge_sets(slots)
    lists = Q * P * (slots + sets)
    # a ticket per set and a last one, for every block of a slot (at most
    # 4), partition and pass
    tickets = passes * P * 4 * (1 + sets)
    with (contextlib.nullcontext() if torch.cuda.current_device() == dev.index
          else torch.cuda.device(dev)):
        stream = torch._C._cuda_getCurrentRawStream(dev.index)
        if unmerged:
            ws = torch.empty(lists * 2 * lane_k * LANES, dtype=torch.int32,
                             device=dev)
            ticket = torch.zeros(tickets, dtype=torch.int32, device=dev)
        else:
            ws, ticket = _merge_workspace("k6", dev, stream,
                                          lists * 2 * lane_k * LANES, tickets)
        lists = ws.numel() // (2 * lane_k * LANES)
        out_v = torch.empty((Q, P, lane_k, LANES), dtype=torch.float32,
                            device=dev)
        out_t = torch.empty((Q, P, lane_k, LANES), dtype=torch.int32,
                            device=dev)
        common = (words.data_ptr(), tables.data_ptr(), nreal.data_ptr(),
                  plan_rows.data_ptr(), B, block_sublanes)
        if kcodec == "h16":
            err = _build.lib().octet_topk_batch_h16(
                *common, lane_k, int(fold_tile == 1), int(tie_safe), Q, slots,
                P, part_rows, part_slices, int(not unmerged), ws.data_ptr(),
                lists, ticket.data_ptr(), ticket.numel(), out_v.data_ptr(),
                out_t.data_ptr(), stream)
            name = "octet_topk_batch_h16"
        else:
            # the arguments as int64 values, in csrc/octet_topk_batch.cu's
            # order
            args = array.array("q", (
                *common, rows, KERNEL_CODECS.index(kcodec), lane_k,
                int(fold_tile == 1), int(tie_safe), Q, qp, slots, P,
                part_rows, part_slices, int(not unmerged), ws.data_ptr(),
                lists, ticket.data_ptr(), ticket.numel(), out_v.data_ptr(),
                out_t.data_ptr(), stream))
            err = _build.lib().octet_topk_batch(args.buffer_info()[0])
            name = "octet_topk_batch"
    _build.check(err, name)
    topk_spmv_fused_batch_octet_device.launches += 1
    if unmerged:
        n = Q * P * slots * lane_k * LANES
        return (ws[:n].view(torch.float32).view(Q, P, slots, lane_k, LANES),
                ws[lists * lane_k * LANES:][:n].view(Q, P, slots, lane_k,
                                                     LANES))
    if P == 1:
        return out_v.view(Q, lane_k, LANES), out_t.view(Q, lane_k, LANES)
    return out_v, out_t


def _merge_sets(lists: int) -> int:
    """The sets of a lane merge on the card over ``lists`` lists (K6 h16's
    slots, K1's blocks): ceil(lists / ceil(sqrt(lists)))
    (csrc/lane_merge.cuh::set_size_of)."""
    size = math.isqrt(lists - 1) + 1 if lists > 1 else 1
    return -(-lists // size)


topk_spmv_fused_batch_octet_device.launches = 0


def spmv_fused_scores_octet_device(words, table, nreal, plan_rows, *,
                                   cfg: TopKSpMVConfig, block_sublanes: int,
                                   num_slices: int, num_partitions: int = 1,
                                   row_ids=None, scale: float = 1.0,
                                   out=None):
    """Plain SpMV over the octet stream (K4, over every partition when
    P = num_partitions > 1): (num_slices, 128) f32, row s the unscaled
    scores of slice s's 128 rows (rows of no real slice are 0), summed as
    K1 sums them. Arguments as for ``topk_spmv_fused_octet_device``;
    num_slices is ``row_ids.shape[0]``, P * part_slices for P partitions.

    With ``row_ids`` ((num_slices, 128) int32, -1 for no row) and ``out``
    (a float32 vector that every row id indexes) the kernel stores in row
    order instead: out[row] = score * ``score_factor(scale)`` for each slice
    lane's row, other entries left as they are (a zero fill makes A @ q);
    returns ``out``.

    CPU tensors run the plain version; CUDA tensors launch the kernel.
    """
    if num_slices % num_partitions:
        raise ValueError(f"{num_slices} slices in {num_partitions} "
                         "partitions")
    kw = dict(num_slices=num_slices, block_sublanes=block_sublanes,
              chunk_sublanes=cfg.chunk_sublanes,
              num_partitions=num_partitions, codec=cfg.query_codec)
    if (row_ids is None) != (out is None):
        raise ValueError("the row-order store takes row_ids and out")
    if words.device.type == "cpu":
        return octet_scores_plain(words, table, nreal, plan_rows, **kw,
                                  row_ids=row_ids, scale=scale, out=out)
    return _octet_scores_cuda(words, table, nreal, plan_rows, cfg, **kw,
                              row_ids=row_ids, scale=scale, out=out)


def _row_store(row_ids, out, num_slices: int, dev):
    """(row_ids pointer, out) of a launch: 0 and a zeroed (num_slices,
    128) f32 slice-order output without row_ids; else both checked (row
    ids (num_slices, 128) int32, out a float32 vector, contiguous on
    ``dev``)."""
    if row_ids is None:
        return 0, torch.zeros((num_slices, LANES), dtype=torch.float32,
                              device=dev)
    for name, t, dtype, ok in (
            ("row_ids", row_ids, torch.int32,
             tuple(row_ids.shape) == (num_slices, LANES)),
            ("out", out, torch.float32, out.dim() == 1)):
        if t.device != dev or t.dtype != dtype or not ok or \
                not t.is_contiguous():
            raise ValueError(f"{name}: need a contiguous {dtype} tensor "
                             f"on {dev} of the row-order shape, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    return row_ids.data_ptr(), out


def _octet_scores_cuda(words, table, nreal, plan_rows, cfg, *, num_slices,
                       block_sublanes, chunk_sublanes, num_partitions, codec,
                       row_ids=None, scale=1.0, out=None):
    B = plan_rows.shape[0]
    P = num_partitions
    rows, dtype = _table_spec(cfg)
    sms = _check_inputs(words, nreal, plan_rows, block_sublanes, P,
                        ("table", table, (rows, LANES), dtype))
    if chunk_sublanes != 8:
        raise ValueError("the octet kernels need chunk_sublanes=8")
    dev = words.device
    arg, _ = _kernel_codec(dev, cfg.query_codec, rows)
    part_rows = words.shape[0] // P
    nblk = _sweep_blocks(sms, part_rows, P)
    ids, out = _row_store(row_ids, out, num_slices, dev)
    _launch(dev, "octet_scores", words.data_ptr(), table.data_ptr(),
            nreal.data_ptr(), plan_rows.data_ptr(), B, block_sublanes, rows,
            arg, nblk, P, part_rows, num_slices // P, out.data_ptr(), ids,
            score_factor(scale))
    spmv_fused_scores_octet_device.launches += 1
    return out


spmv_fused_scores_octet_device.launches = 0


# --------------------------------------------------------------- slice stream

def slice_plan_rows(plan, num_blocks: int, nreal,
                    block_sublanes: int) -> np.ndarray:
    """int32 (B, 6) plan table of a tuple of FusedBucket (columns
    SLICE_PLAN_COLUMNS); nreal: the real slices of each bucket, (B, 1),
    or (P, B, 1) for P partitions on one plan.

    Raises if the buckets do not tile blocks [0, num_blocks) in order, if
    a bucket's blocks cannot hold a partition's slices (ceil(nreal / spb)
    narrow, nreal * bps wide; a shared skeleton may hold more, which the
    kernels skip), if a wide bucket's blocks are not whole slices, or if
    its slices do not fit its blocks: the kernels trust this table for
    every address they read."""
    nreal = np.asarray(nreal).reshape(-1)
    if not plan or nreal.size % len(plan):
        raise ValueError(f"{nreal.size} real-slice counts for "
                         f"{len(plan)} buckets")
    nreal = nreal.reshape(-1, len(plan))
    rows = []
    blk = 0
    for b, pb in enumerate(plan):
        W, spb, bps = pb.width, pb.slices_per_block, pb.blocks_per_slice
        n = int(nreal[:, b].max(initial=0))
        if pb.blk_start != blk:
            raise ValueError(f"plan bucket at block {pb.blk_start}, "
                             f"expected {blk}")
        if min(W, spb, bps) < 1 or nreal[:, b].min(initial=0) < 0:
            raise ValueError(f"bucket geometry {pb}")
        if bps == 1:
            fits, need = spb * W <= block_sublanes, -(-n // spb)
        else:
            fits = spb == 1 and W <= bps * block_sublanes and \
                pb.num_blocks % bps == 0
            need = n * bps
        if not fits:
            raise ValueError(f"bucket of width {W} does not fit its blocks "
                             f"of {block_sublanes} rows")
        if need > pb.num_blocks:
            raise ValueError(f"bucket of width {W} holds {pb.num_blocks} "
                             f"blocks, its {n} slices need {need}")
        rows.append([W, spb, bps, pb.slice_base, pb.blk_start,
                     pb.num_blocks])
        blk += pb.num_blocks
    if blk != num_blocks:
        raise ValueError(f"plan covers {blk} blocks of {num_blocks}")
    return np.asarray(rows, np.int32).reshape(-1, len(SLICE_PLAN_COLUMNS))


def slice_work(row, fold_tile: int):
    """How the slice sweeps cut one bucket into work items (the kernels
    do the same in csrc/slice_common.cuh::Bucket, and give an item's
    members by members_of): (mode, units, per_unit, Gp, Ps, nper).

    A unit is one block of a narrow bucket or one slice of a wide one
    (WIDE: the slice, folded alone, its partial sums carried over its
    blocks in float32 as the JAX kernel does). Narrow buckets:
      - TILED, the JAX kernel's tiled fold (fold_tile > 1 and the block's
        slice loop unrolled there, ``_UNROLL_CHUNKS``): a period of Ps =
        8 / gcd(W, 8) slices spans whole chunks (Ps = 1 when 8 divides
        W); sub-tile (g, s), g < Gp = ceil(nper / fold_tile), holds slice
        s of periods g, g + Gp, ... (at most fold_tile of the block's nper
        whole periods) and harvests their top 2. The block's last
        spb - nper * Ps slices are work items of one slice each;
      - RUNS otherwise: runs of ``_RUN`` consecutive slices, every slice
        folded (or written) alone."""
    W, spb, bps, nb = row[0], row[1], row[2], row[5]
    if bps > 1:
        return WIDE, nb // bps, 1, 0, 0, 0
    Ps = _S // math.gcd(W, _S)
    nper = spb // Ps
    if fold_tile > 1 and nper * (Ps * W // _S) <= _UNROLL_CHUNKS:
        Gp = -(-nper // fold_tile)
        return TILED, nb, Gp * Ps + spb - nper * Ps, Gp, Ps, nper
    return RUNS, nb, -(-spb // _RUN), 0, 0, 0


def slice_work_items(plan_rows, fold_tile: int) -> int:
    """Work items of a whole slice plan (``slice_work``)."""
    return sum(units * per for _, units, per, *_ in
               (slice_work(r, fold_tile) for r in plan_rows.tolist()))


def prod_f32(w: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Per-word score contribution of the f32 codec: one nnz per word.

    The word is col[16:32) | bf16 value[0:16); the value is ``w << 16``
    reinterpreted as f32, times the query entry of col in the (TR, 128)
    f32 table. As in the JAX package's gather (``_gather_from_bcs``), lane
    col & 127 of table row col >> 7 is read, and of row 0 when that row
    does not exist."""
    col = (w >> 16) & 0xFFFF
    idx = torch.where((col >> 7) < table.shape[0], col, col & 0x7F)
    return _bf16_value(w) * table.reshape(-1)[idx.long()]


def prod_int8x4(w: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Per-word score contribution of the int8x4 codec: one nnz per word.

    The word is col[16:32) | bf16 value[0:16) against (TR, 128) int32 rows
    of 4 biased bytes (``pack_query_int8``): lane (w >> 16) & 127 of row
    w >> 25 (col >> 9), or of row 0 past the table; byte (w >> 20) & 24
    ((col >> 7) & 3); the value times (byte - 128) in float32
    (``_gather_from_bcs_int8``)."""
    row = (w >> 25) & 0x7F
    row = torch.where(row < table.shape[0], row, 0)
    g = table.reshape(-1)[(row * LANES + ((w >> 16) & 0x7F)).long()]
    byte = (g >> ((w >> 20) & 24)) & 0xFF
    return _bf16_value(w) * (byte - 128).to(torch.float32)


def prod_sign(w: torch.Tensor, table: torch.Tensor,
              shift: int) -> torch.Tensor:
    """Per-word score contribution of the sign-layout codecs (i8s: shift
    24, i4s: 28; ``encode_words_sign_layout``): one nnz per word.

    Lane (w >> 16) & 127 of table row 1 when w < 0 and the (TR, 128) int32
    table has that row, else of row 0; the entry shifted left by
    (w >> 24) & 31 and arithmetically right by ``shift`` (a signed byte or
    nibble), times the bf16 value in float32 (``_gather_from_bcs_sign``)."""
    row = ((w < 0) & (table.shape[0] > 1)).to(torch.int32)
    sel = table.reshape(-1)[(row * LANES + ((w >> 16) & 0x7F)).long()]
    q = (sel << ((w >> 24) & 31)) >> shift
    return _bf16_value(w) * q.to(torch.float32)


def _bf16_value(w: torch.Tensor) -> torch.Tensor:
    return (w << 16).view(torch.float32)


def codec_prod(codec: str):
    """(words, table) -> per-word products of a codec: int32 for h16
    (against the table's one row), float32 for the others."""
    if codec == "h16":
        return lambda w, table: prod_h16(w, table.reshape(-1)[:LANES])
    if codec == "f32":
        return prod_f32
    if codec == "int8x4":
        return prod_int8x4
    if codec in SIGN_SHIFTS:
        return functools.partial(prod_sign, shift=SIGN_SHIFTS[codec])
    raise ValueError(f"unknown query codec {codec!r}")


def _row_sum(p: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over ``dim`` in index order, one rounded float32 add at a time
    from 0 (the kernels' order, csrc/slice_scores.cu::span_sums)."""
    acc = p.new_zeros(p.shape[:dim] + p.shape[dim + 1:])
    for r in range(p.shape[dim]):
        acc = acc + p.select(dim, r)
    return acc


def _bucket_scores(words, table, row, codec: str, block_sublanes: int):
    """f32 scores of one bucket's slices in slice order, ((units * spb,
    128) narrow, every slice of its blocks including the last block's
    padding slices; (units, 128) wide).

    h16 sums are exact integers converted once, and once per block for
    a wide slice, whose block sums then add up in float32 in block order
    (the JAX kernel's carry). The float codecs' sums run in row order, each
    product and each add rounded (``_row_sum``), as the kernels add them,
    so their scores are bit-equal to these on any data."""
    W, spb, bps, _, blk_start, nb = row
    bs = block_sublanes
    prod = codec_prod(codec)
    total = torch.sum if codec == "h16" else _row_sum
    blocks = words[blk_start * bs:(blk_start + nb) * bs]
    out = []
    if bps == 1:
        tiles = blocks.reshape(nb, bs, LANES)[:, :spb * W].reshape(
            nb * spb, W, LANES)
        per = max(1, _STEP_WORDS // (W * LANES))
        for s0 in range(0, nb * spb, per):
            out.append(total(prod(tiles[s0:s0 + per], table), dim=1)
                       .to(torch.float32))
        return torch.cat(out)
    tiles = blocks.reshape(nb // bps, bps, bs, LANES)
    per = max(1, _STEP_WORDS // (bps * bs * LANES))
    for s0 in range(0, nb // bps, per):
        part = total(prod(tiles[s0:s0 + per], table), dim=2).to(
            torch.float32)
        acc = torch.zeros_like(part[:, 0])
        for k in range(bps):
            acc = acc + part[:, k]
        out.append(acc)
    return torch.cat(out)


def slice_scores_plain(words, table, nreal, plan_rows, *, num_slices: int,
                       block_sublanes: int, codec: str,
                       num_partitions: int = 1, row_ids=None,
                       scale: float = 1.0, out=None):
    """Plain PyTorch version of the slice-stream SpMV: (num_slices, 128)
    f32, row s holding slice s's 128 unscaled row scores; rows of no real
    slice (the sentinel slice) stay 0. With P partitions, partition p's
    slices fill rows p * part_slices .., part_slices = num_slices / P.

    With ``row_ids`` ((num_slices, 128) int32) the row-order form: those
    scores scaled into ``out`` (``scores_to_rows``), which it returns."""
    sc = torch.zeros((num_slices, LANES), dtype=torch.float32,
                     device=words.device)
    part_slices = num_slices // num_partitions
    for p, (w, nr) in enumerate(_partitions(words, nreal, num_partitions)):
        for b, row in enumerate(plan_rows.tolist()):
            n = int(nr[b])
            base = p * part_slices + row[3]
            sc[base:base + n] = _bucket_scores(
                w, table, row, codec, block_sublanes)[:n]
    return sc if row_ids is None else scores_to_rows(sc, row_ids, scale, out)


def slice_topk_plain(words, table, nreal, plan_rows, *,
                     num_partitions: int = 1, part_slices: int = 0, **kw):
    """Plain PyTorch version of the slice sweep (K7; K10a with P > 1
    partitions): (topv, topt), each (lane_k, 128) ((P, lane_k, 128) for
    P > 1), values sorted descending per lane. Keywords: lane_k,
    fold_tile, tie_safe, block_sublanes, codec.

    The slice scores (padding slices of a bucket's last block at -inf)
    harvested as ``slice_work`` says: every slice, or the top 2 of each
    sub-tile (lowest member index among ties). Each lane keeps its exact
    top-``lane_k`` of the candidates and the initial sentinels (-inf
    when ``tie_safe``, else ``topk_init``), which equals the sequential
    argmin replacement whenever values are distinct; at exact ties only
    values above a lane's smallest kept value are comparable entry for
    entry (see ``octet_topk_plain``)."""
    return _per_partition(_slice_topk_one, words, table, nreal, plan_rows,
                          num_partitions, part_slices, **kw)


def _slice_topk_one(words, table, nreal, plan_rows, *, lane_k: int,
                    fold_tile: int, tie_safe: bool, block_sublanes: int,
                    codec: str, tag_offset: int = 0):
    """``slice_topk_plain`` of one partition, tags offset by tag_offset."""
    dev = words.device
    cand_v, cand_t = [], []
    for b, row in enumerate(plan_rows.tolist()):
        spb, base = row[1], row[3] + tag_offset
        n = int(nreal.reshape(-1)[b])
        sc = _bucket_scores(words, table, row, codec, block_sublanes)
        ids = torch.arange(sc.shape[0], device=dev,
                           dtype=torch.int32).view(-1, 1)
        sc = torch.where(ids < n, sc, NEG_INF)
        mode, units, _, Gp, Ps, nper = slice_work(row, fold_tile)
        if mode != TILED:
            cand_v.append(sc)
            cand_t.append((base + ids).expand_as(sc))
            continue
        sc = sc.reshape(units, spb, LANES)
        u0 = base + spb * torch.arange(units, device=dev,
                                       dtype=torch.int32).view(-1, 1, 1)
        # periods p = m * Gp + g of sub-tile (g, s): (units, m, g, s, lane)
        per = sc[:, :nper * Ps].reshape(units, nper, Ps, LANES)
        per = torch.cat([per, per.new_full(
            (units, Gp * fold_tile - nper, Ps, LANES), NEG_INF)], dim=1)
        per = per.reshape(units, fold_tile, Gp, Ps, LANES)
        g = torch.arange(Gp, device=dev, dtype=torch.int32).view(
            1, 1, -1, 1, 1)
        s = torch.arange(Ps, device=dev, dtype=torch.int32).view(
            1, 1, 1, -1, 1)
        for m, sl in _harvest(per, 1, 2):
            cand_v.append(m.reshape(-1, LANES))
            cand_t.append((u0.view(-1, 1, 1, 1, 1) + Ps * (g + sl * Gp) + s)
                          .reshape(-1, LANES))
        j = torch.arange(nper * Ps, spb, device=dev,
                         dtype=torch.int32).view(1, -1, 1)
        cand_v.append(sc[:, nper * Ps:].reshape(-1, LANES))
        cand_t.append((u0 + j).expand(units, -1, LANES).reshape(-1, LANES))
    return _merge_with_init(cand_v, cand_t, lane_k, tie_safe, dev)


def slice_topk_batch_plain(words, tables, nreal, plan_rows, **kw):
    """Plain PyTorch version of the multi-query slice sweep (K8):
    ``slice_topk_plain`` with every slice folded (fold_tile 1) for each
    query of the (Q, TR, 128) tables -> (topv, topt), each (Q, lane_k,
    128) ((Q, P, lane_k, 128) with P > 1 partitions, K10c). Keyword
    arguments as for ``slice_topk_plain`` but fold_tile."""
    outs = [slice_topk_plain(words, t, nreal, plan_rows, fold_tile=1, **kw)
            for t in tables]
    return torch.stack([v for v, _ in outs]), torch.stack([t for _, t in outs])


def slice_topk_batch_slots_plain(words, tables, nreal, plan_rows, *,
                                 num_slots: int, lane_k: int, tie_safe: bool,
                                 block_sublanes: int, codec: str = "f32",
                                 num_partitions: int = 1,
                                 part_slices: int = 0, merged: bool = True):
    """Plain version of K8 (K10c with P > 1 partitions) as the kernel
    computes it, on ``num_slots`` slots a partition and pass (``pass_grid``):
    for each query of the (Q, TR, 128) tables, ``slice_topk_slots_plain``
    at fold_tile 1 (K7's deal, ``k7_deal``; every slice harvested alone,
    an item's real members in turn), tags offset by p * part_slices in
    partition p -> (topv, topt), each (Q, lane_k, 128) ((Q, P, lane_k,
    128) for P > 1); with ``merged`` False each slot's sorted buffer, (Q,
    P, slots, lane_k, 128), as the kernel's unmerged launch leaves them.
    The kernel gives these pairs bit for bit on any data, tags and ties
    included, however its queries split into passes. Against
    ``slice_topk_batch_plain``: the same values whenever the buffers are
    tie-safe, and the same (value, tag) pairs above each lane's smallest
    kept value."""
    outs = [slice_topk_slots_plain(
        words, t, nreal, plan_rows, num_slots=num_slots, lane_k=lane_k,
        fold_tile=1, tie_safe=tie_safe, block_sublanes=block_sublanes,
        codec=codec, num_partitions=num_partitions, part_slices=part_slices,
        merged=merged) for t in tables]
    return torch.stack([v for v, _ in outs]), torch.stack([t for _, t in outs])


def _slice_items(row, n_real: int, fold_tile: int):
    """The work items of one slice bucket (plan row ``row``, ``n_real``
    real slices) in the kernels' order (``slice_work``; csrc/
    slice_common.cuh::members_of): (members, nr, top2), numpy. members (items,
    _RUN) int64: each item's member slices, bucket-relative, in member
    order, -1 past its count; nr (items,): its real members (slices below
    n_real, a prefix of its members); top2 (items,): a sub-tile, which
    gives the top 2 of its real members, where every other item gives
    each."""
    mode, units, per, Gp, Ps, nper = slice_work(row, fold_tile)
    spb = row[1]
    if mode == WIDE:
        members = np.full((units, _RUN), -1, np.int64)
        members[:, 0] = np.arange(units)
        top2 = np.zeros(units, bool)
    else:
        unit = np.full((per, _RUN), -1, np.int64)   # the items of a unit
        tiles = np.zeros(per, bool)
        for gi in range(per):
            if mode == RUNS:
                j0, dj, count = gi * _RUN, 1, min(_RUN, spb - gi * _RUN)
            elif gi < Gp * Ps:               # sub-tile (g, s)
                g, sub = divmod(gi, Ps)
                j0, dj = Ps * g + sub, Ps * Gp
                count = min(fold_tile, -(-(nper - g) // Gp))
                tiles[gi] = True
            else:                            # a block's last slices
                j0, dj, count = nper * Ps + gi - Gp * Ps, 1, 1
            unit[gi, :count] = j0 + dj * np.arange(count)
        first = spb * np.arange(units).reshape(-1, 1, 1)
        members = np.where(unit >= 0, unit + first, -1).reshape(-1, _RUN)
        top2 = np.tile(tiles, units)
    nr = ((members >= 0) & (members < n_real)).sum(axis=1)
    return members, nr, top2


def k7_item_work(plan_rows, nreal, fold_tile: int):
    """Each of one partition's slice work items in plan order (``nreal``:
    its (B, 1) real slices): (rows, work), (items,) int64 numpy: its real
    members' rows (nr * W) and its work in K7's deal, nr times W rounded
    up to whole chunks of K7_CHUNK_ROWS, plus K7_ITEM_COST; 0 with no real
    member (the kernel skips it)."""
    n_real = torch.as_tensor(nreal).reshape(-1).tolist()
    rows, work = [], []
    for b, row in enumerate(plan_rows.tolist()):
        nr = _slice_items(row, n_real[b], fold_tile)[1].astype(np.int64)
        chunked = -(-row[0] // K7_CHUNK_ROWS) * K7_CHUNK_ROWS
        rows.append(nr * row[0])
        work.append(np.where(nr > 0, nr * chunked + K7_ITEM_COST, 0))
    return np.concatenate(rows), np.concatenate(work)


def k7_deal(plan_rows, nreal, num_slots: int, fold_tile: int) -> torch.Tensor:
    """K7's static deal (``csrc/slice_topk.cuh::slot_walk``): the slot of
    each of one partition's work items, in plan order, (items,) int64 on
    the CPU. Each of the ``num_slots`` slots takes a contiguous run of
    about equal work, an item's work w(g) its real members' rows in whole
    chunks plus K7_ITEM_COST (0 with no real member, ``k7_item_work``);
    item g goes to the slot holding its work's midpoint, floor((2 c(g) +
    w(g)) * num_slots / (2 C)), c(g) the work before it and C the
    partition's."""
    _, work = k7_item_work(plan_rows, nreal, fold_tile)
    mid2 = 2 * np.cumsum(work) - work   # twice each midpoint
    slot = mid2 * num_slots // max(2 * int(work.sum()), 1)
    return torch.from_numpy(np.minimum(slot, num_slots - 1))


def slice_topk_slots_plain(words, table, nreal, plan_rows, *, num_slots: int,
                           lane_k: int, fold_tile: int, tie_safe: bool,
                           block_sublanes: int, codec: str = "f32",
                           num_partitions: int = 1, part_slices: int = 0,
                           merged: bool = True):
    """Plain version of K7 (K10a with P > 1 partitions) as the kernel
    computes it, on ``num_slots`` slots a partition (``slice_topk_grid``):
    each slot takes a contiguous run of the partition's work items
    (``k7_deal``) and harvests those with a real member, in order, into
    lane buffers from ``topk_init``'s entries (-inf when ``tie_safe``): a
    sub-tile's top 2 of its real members (lowest member among ties;
    nothing when one is NaN), every other item each real member in turn,
    the scores summed as ``_bucket_scores`` sums them, by argmin
    replacement (when score >= the minimum: the first slot holding it
    when tie-safe, else every one); then ``lane_merge_plain`` over every
    slot's entries, the initial ones included -> (topv, topt), each
    (lane_k, 128) ((P, lane_k, 128) for P > 1), tags offset by p *
    part_slices in partition p. The kernel gives these pairs bit for bit
    on any data, tags and ties included; with ``merged`` False, each
    slot's buffer in the merge's order, (P, slots, lane_k, 128), as the
    kernel's unmerged launch leaves them. Against ``slice_topk_plain``:
    the same values whenever the buffers are tie-safe, and the same
    (value, tag) pairs above each lane's smallest kept value."""
    return _slot_pools(words, table, nreal, plan_rows, one=_slice_slots_one,
                       num_slots=num_slots, lane_k=lane_k,
                       fold_tile=fold_tile, tie_safe=tie_safe,
                       block_sublanes=block_sublanes, codec=codec,
                       num_partitions=num_partitions, part_slices=part_slices,
                       merged=merged)


def _slice_slots_one(words, table, nreal, plan_rows, *, num_slots, lane_k,
                     fold_tile, tie_safe, block_sublanes, codec, tag_offset):
    """``slice_topk_slots_plain``'s slots of one query and one partition,
    before the merge: (values, tags), each (num_slots, lane_k, 128)."""
    dev = words.device
    K = lane_k
    n_real = nreal.reshape(-1).tolist()
    # each item's harvest steps in plan order: (items, _RUN, 128) scores,
    # tags and whether the step is taken
    scores, tags, valid, nrs = [], [], [], []
    for b, row in enumerate(plan_rows.tolist()):
        members, nr, top2 = _slice_items(row, n_real[b], fold_tile)
        nrs.append(nr)
        sc = _bucket_scores(words, table, row, codec, block_sublanes)
        m = torch.from_numpy(members).to(dev)
        real = torch.from_numpy(np.arange(_RUN) < nr[:, None]).to(dev)
        v = torch.where(real[..., None], sc[m.clamp(min=0)], NEG_INF)
        t = (row[3] + tag_offset + m).int()[..., None].expand_as(v)
        ok = real[..., None].expand_as(v)
        # a sub-tile: its top 2, both left out where a real member is NaN
        nan = (torch.isnan(v) & real[..., None]).any(dim=1, keepdim=True)
        top_v, top_t, top_ok = [], [], []
        for i, (m1, sl) in enumerate(_harvest(v, 1, 2)):
            top_v.append(m1)
            top_t.append(t.gather(1, sl.clamp(max=_RUN - 1).long()))
            top_ok.append(~nan & torch.from_numpy(nr > i).to(dev).view(
                -1, 1, 1))
        pad = _RUN - 2
        tile = torch.from_numpy(top2).to(dev).view(-1, 1, 1)
        scores.append(torch.where(tile, torch.cat(
            top_v + [v[:, :pad]], dim=1), v))
        tags.append(torch.where(tile, torch.cat(top_t + [t[:, :pad]], dim=1),
                                t))
        valid.append(torch.where(tile, torch.cat(
            top_ok + [torch.zeros_like(ok[:, :pad])], dim=1), ok))
    scores, tags, valid = torch.cat(scores), torch.cat(tags), torch.cat(valid)
    slot = k7_deal(plan_rows, nreal, num_slots, fold_tile)
    # the items with a real member (the kernel skips the others) by slot
    keep = torch.from_numpy(np.concatenate(nrs) > 0)
    slot = slot[keep].to(dev)
    keep = keep.to(dev)
    scores, tags, valid = scores[keep], tags[keep], valid[keep]
    n = scores.shape[0]
    turn = torch.arange(n, device=dev) - torch.searchsorted(slot, slot)
    turns = int(turn.max()) + 1 if n else 0
    order = torch.full((turns, num_slots), n, dtype=torch.long, device=dev)
    order[turn, slot] = torch.arange(n, device=dev)
    pad = lambda x: torch.cat([x, x.new_zeros((1, *x.shape[1:]))])  # noqa: E731
    scores, tags, valid = (pad(x)[order] for x in (scores, tags, valid))
    taken = valid.any(dim=-1).nonzero()[:, 2]   # the steps some lane takes
    steps = int(taken.max()) + 1 if taken.numel() else 0
    init = (torch.full((K,), NEG_INF, device=dev) if tie_safe else
            torch.from_numpy(topk_init(K)).to(dev))
    v = init.view(1, K, 1).expand(num_slots, K, LANES).clone()
    t = torch.zeros((num_slots, K, LANES), dtype=torch.int32, device=dev)
    kslot = torch.arange(K, device=dev).view(1, K, 1)
    for i in range(turns):
        for step in range(steps):
            score = scores[i, :, step].unsqueeze(1)
            cur = v.amin(dim=1, keepdim=True)
            hit = v == cur
            if tie_safe:
                hit = kslot == hit.int().argmax(dim=1, keepdim=True)
            rep = hit & (score >= cur) & valid[i, :, step].unsqueeze(1)
            v = torch.where(rep, score, v)
            t = torch.where(rep, tags[i, :, step].unsqueeze(1), t)
    return v, t


def slice_topk_grid(dev, cfg: TopKSpMVConfig, part_rows: int,
                    num_partitions: int = 1):
    """K7's (CUDA blocks, slots) a partition on CUDA ``dev`` for cfg's
    codec, lane_k and buffers, on partitions of ``part_rows`` rows of
    words: ``octet_grid`` (K7_GROUPS slots a block, as K1's) of the
    kernel's resident blocks an SM, no more blocks than give each chunk
    of rows a slot."""
    rows, _ = _table_spec(cfg)
    arg, _ = _kernel_codec(dev, cfg.query_codec, rows)
    per_sm = _resident_blocks(dev, "slice_topk_occupancy", arg, cfg.lane_k,
                              int(bool(cfg.tie_safe_topk)), rows)
    return octet_grid(_device_info(dev)[0], num_partitions, per_sm,
                      part_rows // _S)


def _slice_topk_cuda(words, table, nreal, plan_rows, P, part_slices, cfg,
                     block_sublanes, *, unmerged=False):
    """K7's launch on CUDA tensors, for ``topk_spmv_fused_device`` (which
    passes P and the tag offset; the sweep's codec, lane_k, fold and
    buffers are cfg's, as ``slice_topk_grid`` reads them): one launch that
    returns the merged pair, its lane merge on the card
    (``slice_topk_slots_plain`` on ``slice_topk_grid``'s slots computes
    what it gives), and no torch op after it; with ``unmerged`` each
    slot's buffer, sorted (value descending, then tag ascending), (P,
    slots, lane_k, 128) values and tags, the merge not run, for timing
    the sweep alone. The merge's lists reuse the table's shared memory
    once the sweep is done, so a table keeps the block's whole opt-in
    budget (``_kernel_codec``)."""
    B = plan_rows.shape[0]
    K = cfg.lane_k
    rows, dtype = _table_spec(cfg)
    if block_sublanes % K7_CHUNK_ROWS:
        # a wide slice's block sums close after whole chunks
        raise ValueError(f"block_sublanes={block_sublanes}: K7 reads a "
                         f"member's rows in chunks of {K7_CHUNK_ROWS}, so "
                         "its blocks must hold whole chunks")
    _check_inputs(words, nreal, plan_rows, block_sublanes, P,
                  ("table", table, (rows, LANES), dtype),
                  plan_cols=len(SLICE_PLAN_COLUMNS))
    _check_lane_k(K)
    if cfg.fold_tile not in (1, 2, 4, 8):
        raise ValueError(f"fold_tile={cfg.fold_tile}: K7 takes 1, 2, 4 "
                         "or 8")
    dev = words.device
    arg, _ = _kernel_codec(dev, cfg.query_codec, rows)
    part_rows = words.shape[0] // P
    blocks, slots = slice_topk_grid(dev, cfg, part_rows, P)
    sets = _merge_sets(blocks)
    lib = _build.lib()
    with (contextlib.nullcontext() if torch.cuda.current_device() == dev.index
          else torch.cuda.device(dev)):
        stream = torch._C._cuda_getCurrentRawStream(dev.index)
        if unmerged:
            ws = torch.empty(P * slots * 2 * K * LANES, dtype=torch.int32,
                             device=dev)
            tickets = torch.zeros(1, dtype=torch.int32, device=dev)
        else:
            ws, tickets = _merge_workspace("k7", dev, stream,
                                           P * (blocks + sets) * 2 * K * LANES,
                                           P * (1 + sets))
        lists = ws.numel() // (2 * K * LANES)
        out_v = torch.empty((P, K, LANES), dtype=torch.float32, device=dev)
        out_t = torch.empty((P, K, LANES), dtype=torch.int32, device=dev)
        # the arguments as int64 values, in csrc/slice_topk.cu's order
        args = array.array("q", (
            words.data_ptr(), table.data_ptr(), nreal.data_ptr(),
            plan_rows.data_ptr(), B, block_sublanes, rows, arg, K,
            cfg.fold_tile, int(bool(cfg.tie_safe_topk)), blocks, P,
            part_rows, part_slices, int(not unmerged), ws.data_ptr(), lists,
            tickets.data_ptr(), tickets.numel(), out_v.data_ptr(),
            out_t.data_ptr(), stream))
        err = lib.slice_topk(args.buffer_info()[0])
    _build.check(err, "slice_topk")
    topk_spmv_fused_device.launches += 1
    if unmerged:
        n = P * slots * K * LANES
        return (ws[:n].view(torch.float32).view(P, slots, K, LANES),
                ws[lists * K * LANES:][:n].view(P, slots, K, LANES))
    if P == 1:
        return out_v[0], out_t[0]
    return out_v, out_t


def _check_slice(cfg: TopKSpMVConfig) -> None:
    if cfg.chunk_sublanes != _S:
        raise ValueError(f"the slice sweeps need chunk_sublanes={_S}")


def topk_spmv_fused_device(words, table, nreal, plan_rows, *,
                           cfg: TopKSpMVConfig, block_sublanes: int,
                           num_partitions: int = 1, part_slices: int = 0):
    """Slice sweep (K7; with P = num_partitions > 1, K10a): per-lane
    (topv, topt) candidates of one query.

    words: (P * num_blocks * block_sublanes, 128) int32 slice stream.
    table: the query table of cfg.query_codec (``_table_spec``, as for
    ``topk_spmv_fused_octet_device``). nreal: (B, 1) int32 real slices per bucket; (P,
    B, 1) for P > 1. plan_rows: (B, 6) int32 plan table
    (slice_plan_rows). part_slices: slice tags per partition (P > 1).
    Returns (topv f32, topt i32), each (lane_k, 128) ((P, lane_k, 128)
    for P > 1), sorted descending.

    CPU tensors run the plain version; CUDA tensors launch the kernel, one
    launch that returns the merged pair (``_slice_topk_cuda``; an f32
    table larger than a CUDA block's shared memory is read from global
    memory, ``tables_in_smem``).
    """
    _check_slice(cfg)
    P = num_partitions
    ps = _part_slices(P, part_slices)
    if words.device.type == "cpu":
        return slice_topk_plain(words, table, nreal, plan_rows,
                                num_partitions=P, part_slices=ps,
                                lane_k=cfg.lane_k, fold_tile=cfg.fold_tile,
                                tie_safe=bool(cfg.tie_safe_topk),
                                block_sublanes=block_sublanes,
                                codec=cfg.query_codec)
    return _slice_topk_cuda(words, table, nreal, plan_rows, P, ps, cfg,
                            block_sublanes)


topk_spmv_fused_device.launches = 0


def topk_spmv_fused_batch_device(words, tables, nreal, plan_rows, *,
                                 cfg: TopKSpMVConfig, block_sublanes: int,
                                 num_partitions: int = 1,
                                 part_slices: int = 0):
    """Multi-query slice sweep (K8; with P = num_partitions > 1, K10c).

    tables: (Q, rows, 128) query tables of cfg.query_codec
    (``pack_query_tables``); the other arguments as for
    ``topk_spmv_fused_device``. Returns (topv f32, topt i32), each (Q,
    lane_k, 128) ((Q, P, lane_k, 128) for P > 1), sorted descending per
    lane. Every slice is folded, whatever ``cfg.fold_tile`` is (as in the
    JAX batch kernel), and ``cfg.batch_subgroup`` is not read.

    CPU tensors run the plain version; CUDA tensors launch the kernel, one
    launch that returns the merged pairs (``_slice_topk_batch_cuda``: the
    stream read once a pass of up to 32 h16 or 16 other queries,
    ``k8_pass``, and the lane merge on the card).
    """
    _check_slice(cfg)
    P = num_partitions
    ps = _part_slices(P, part_slices)
    if words.device.type == "cpu":
        return slice_topk_batch_plain(
            words, tables, nreal, plan_rows, num_partitions=P, part_slices=ps,
            lane_k=cfg.lane_k, tie_safe=bool(cfg.tie_safe_topk),
            block_sublanes=block_sublanes, codec=cfg.query_codec)
    return _slice_topk_batch_cuda(words, tables, nreal, plan_rows, P, ps, cfg,
                                  block_sublanes)


def batch_block_lanes(pass_queries: int, lane_k: int, codec: str) -> int:
    """Stream lanes of one of the batch sweeps' CUDA blocks, K8's and K6's
    (csrc/batch_sweep.cuh::kBlockLanes; K6 h16's kBlockLanes): 64, or 32
    where a pass's (lane, query) buffers need the room (h16 at lane_k 16,
    the other codecs past 128 entries a lane); 128 / that many blocks
    share a slot."""
    wide = lane_k <= 8 if codec == "h16" else pass_queries * lane_k <= 128
    return 64 if wide else 32


def k8_smem_bytes(codec: str, pass_queries: int, lane_k: int,
                  table_rows: int) -> int:
    """K8's dynamic shared memory a block (csrc/slice_topk_batch.cuh::
    Smem) for a kernel codec (KERNEL_CODECS) and pass: the pass's table
    (h16's 16 KB; the float codecs' tables side by side, none for
    f32_global and int8x4_global), the member sums, the (lane, query)
    buffers, their minima and the harvest queue."""
    table = (16 * 1024 if codec == "h16" else 0 if codec.endswith("_global")
             else 4 * pass_queries * table_rows * LANES)
    return _pass_smem_bytes(codec, pass_queries, lane_k, table)


def _pass_smem_bytes(codec: str, pass_queries: int, lane_k: int,
                     table: int) -> int:
    """csrc/batch_sweep.cuh::Smem's bytes: a table of ``table`` bytes,
    16-byte aligned, then each (lane, query)'s member sums, buffer of
    lane_k (value, tag) pairs, minimum and queue entry."""
    L = batch_block_lanes(pass_queries, lane_k, codec)
    return -(-table // 16) * 16 + pass_queries * L * (
        4 * 8 + 8 * lane_k + 4 + 2)


def k8_pass(codec: str, num_queries: int, lane_k: int, table_rows: int,
            smem_limit: int, pass_queries: int | None = None):
    """K8's (kernel codec, queries a pass) for ``num_queries`` queries of
    the config's ``codec``: h16 in passes of 8, 16 or 32 (the fewest that
    hold the queries, as K6 h16's), the other codecs of 8, or 16 for more
    than 8 queries; an f32 or int8x4 pass whose tables do not fit
    ``smem_limit`` bytes beside the rest (``k8_smem_bytes``) takes 8
    queries, and past that the tables are read from global memory
    (``f32_global``, ``int8x4_global``, in passes of 8; h16's table is one
    row, i8s's and i4s's at most 2). ``pass_queries`` forces the pass (one
    of K8_PASS_QUERIES[codec])."""
    sizes = K8_PASS_QUERIES[codec]
    if pass_queries is None:
        pass_queries = next((n for n in sizes if n >= num_queries), sizes[-1])
    elif pass_queries not in sizes:
        raise ValueError(f"a {codec} pass of {pass_queries} queries: K8 "
                         f"takes {sizes}")
    if k8_smem_bytes(codec, pass_queries, lane_k, table_rows) <= smem_limit:
        return codec, pass_queries
    if codec not in ("f32", "int8x4"):
        raise ValueError(f"a {codec} table of {table_rows} rows does not fit "
                         "shared memory")
    if k8_smem_bytes(codec, 8, lane_k, table_rows) <= smem_limit:
        return codec, 8
    return f"{codec}_global", 8


def pass_grid(num_queries: int, sms: int, pass_queries: int, lane_k: int,
              codec: str = "h16", partitions: int = 1):
    """The grid of the batch sweeps that read the stream once a pass, K8
    (``csrc/slice_topk_batch.cuh``) and K6 (``csrc/octet_topk_batch.cuh``):
    (passes, slots). A pass sweeps the stream once for up to
    ``pass_queries`` queries; the passes, partitions and the 128 /
    ``batch_block_lanes`` lane groups of a slot are CUDA blocks of their
    own, one an SM: slots per partition and pass are the SMs over those
    (rounded down, so that no block waits for a second wave), at least
    one. Each slot writes lane_k * 128 (value, tag) pairs per query to the
    merge."""
    passes = -(-num_queries // pass_queries)
    groups = LANES // batch_block_lanes(pass_queries, lane_k, codec)
    return passes, max(1, sms // (groups * partitions * passes))


def k8_launch(dev, cfg: TopKSpMVConfig, num_queries: int, partitions: int,
              pass_queries: int | None = None):
    """K8's launch shape on CUDA ``dev`` for cfg's codec and lane_k:
    (kernel codec, queries a pass, passes, slots)."""
    sms, limit = _device_info(dev)
    rows, _ = _table_spec(cfg)
    codec, qp = k8_pass(cfg.query_codec, num_queries, cfg.lane_k, rows,
                        limit, pass_queries)
    return (codec, qp,
            *pass_grid(num_queries, sms, qp, cfg.lane_k, codec, partitions))


def _slice_topk_batch_cuda(words, tables, nreal, plan_rows, P, part_slices,
                           cfg, block_sublanes, *, unmerged=False):
    """K8's launch on CUDA tensors, for ``topk_spmv_fused_batch_device``
    (which passes P and the tag offset; codec, lane_k and buffers are
    cfg's): one launch that returns the merged pairs, its lane merge on the
    card (``slice_topk_batch_slots_plain`` on ``k8_launch``'s slots
    computes what it gives), and no torch op after it; with ``unmerged``
    each slot's buffers, sorted (value descending, then tag ascending),
    (Q, P, slots, lane_k, 128) values and tags, the merge not run, for
    timing the sweep alone."""
    B = plan_rows.shape[0]
    Q = tables.shape[0]
    K = cfg.lane_k
    if Q < 1:
        raise ValueError("no queries")
    if block_sublanes % K8_UNROLL or (cfg.query_codec == "h16"
                                      and block_sublanes > 65535):
        # a wide slice's block sums close after whole load batches; h16's
        # packed sums stay exact below 65,535 words
        raise ValueError(f"block_sublanes={block_sublanes}: K8 needs a "
                         f"multiple of {K8_UNROLL} (h16: at most 65,535)")
    rows, dtype = _table_spec(cfg)
    _check_inputs(words, nreal, plan_rows, block_sublanes, P,
                  ("tables", tables, (Q, rows, LANES), dtype),
                  plan_cols=len(SLICE_PLAN_COLUMNS))
    _check_lane_k(K)
    dev = words.device
    codec, qp, passes, slots = k8_launch(dev, cfg, Q, P)
    sets = _merge_sets(slots)
    lists = Q * P * (slots if unmerged else slots + sets)
    tickets = passes * P * 4 * (1 + sets)
    lib = _build.lib()
    with (contextlib.nullcontext() if torch.cuda.current_device() == dev.index
          else torch.cuda.device(dev)):
        stream = torch._C._cuda_getCurrentRawStream(dev.index)
        if unmerged:
            ws = torch.empty(lists * 2 * K * LANES, dtype=torch.int32,
                             device=dev)
            ticket = torch.zeros(1, dtype=torch.int32, device=dev)
        else:
            ws, ticket = _merge_workspace("k8", dev, stream,
                                          lists * 2 * K * LANES, tickets)
        lists = ws.numel() // (2 * K * LANES)
        out_v = torch.empty((Q, P, K, LANES), dtype=torch.float32, device=dev)
        out_t = torch.empty((Q, P, K, LANES), dtype=torch.int32, device=dev)
        # the arguments as int64 values, in csrc/slice_topk_batch.cu's order
        args = array.array("q", (
            words.data_ptr(), tables.data_ptr(), nreal.data_ptr(),
            plan_rows.data_ptr(), B, block_sublanes, rows,
            KERNEL_CODECS.index(codec), K, int(bool(cfg.tie_safe_topk)), Q,
            qp, slots, P, words.shape[0] // P, part_slices,
            int(not unmerged), ws.data_ptr(), lists, ticket.data_ptr(),
            ticket.numel(), out_v.data_ptr(), out_t.data_ptr(), stream))
        err = lib.slice_topk_batch(args.buffer_info()[0])
    _build.check(err, "slice_topk_batch")
    topk_spmv_fused_batch_device.launches += 1
    if unmerged:
        n = Q * P * slots * K * LANES
        return (ws[:n].view(torch.float32).view(Q, P, slots, K, LANES),
                ws[lists * K * LANES:][:n].view(Q, P, slots, K, LANES))
    if P == 1:
        return out_v.view(Q, K, LANES), out_t.view(Q, K, LANES)
    return out_v, out_t


topk_spmv_fused_batch_device.launches = 0


def spmv_fused_scores_device(words, table, nreal, plan_rows, *,
                             cfg: TopKSpMVConfig, block_sublanes: int,
                             num_slices: int, num_partitions: int = 1,
                             row_ids=None, scale: float = 1.0, out=None):
    """Plain SpMV over the slice stream (K9, over every partition when
    P = num_partitions > 1): (num_slices, 128) f32, row s the unscaled
    scores of slice s's 128 rows (rows of no real slice are 0).
    Arguments as for ``topk_spmv_fused_device``; num_slices is
    ``row_ids.shape[0]``, P * part_slices for P partitions.

    With ``row_ids`` ((num_slices, 128) int32, -1 for no row) and ``out``
    (a float32 vector that every row id indexes) the kernel stores in row
    order instead: out[row] = score * ``score_factor(scale)`` for each slice
    lane's row, other entries left as they are (a zero fill makes A @ q);
    returns ``out``.

    CPU tensors run the plain version; CUDA tensors launch the kernel.
    """
    _check_slice(cfg)
    P = num_partitions
    if num_slices % P:
        raise ValueError(f"{num_slices} slices in {P} partitions")
    if (row_ids is None) != (out is None):
        raise ValueError("the row-order store takes row_ids and out")
    if words.device.type == "cpu":
        return slice_scores_plain(words, table, nreal, plan_rows,
                                  num_slices=num_slices,
                                  block_sublanes=block_sublanes,
                                  codec=cfg.query_codec, num_partitions=P,
                                  row_ids=row_ids, scale=scale, out=out)
    B = plan_rows.shape[0]
    rows, dtype = _table_spec(cfg)
    _check_inputs(words, nreal, plan_rows, block_sublanes, P,
                  ("table", table, (rows, LANES), dtype),
                  plan_cols=len(SLICE_PLAN_COLUMNS))
    dev = words.device
    codec, _ = _kernel_codec(dev, cfg.query_codec, rows)
    ids, out = _row_store(row_ids, out, num_slices, dev)
    blocks = slice_scores_grid(dev, cfg, num_slices // P, P,
                               row_order=bool(ids))
    lib = _build.lib()
    with (contextlib.nullcontext() if torch.cuda.current_device() == dev.index
          else torch.cuda.device(dev)):
        # the arguments as int64 values, in csrc/slice_scores.cu's order
        args = array.array("q", (
            words.data_ptr(), table.data_ptr(), nreal.data_ptr(),
            plan_rows.data_ptr(), B, block_sublanes, rows, codec, blocks, P,
            words.shape[0] // P, num_slices // P, out.data_ptr(), ids,
            int(np.float32(score_factor(scale)).view(np.uint32)),
            torch._C._cuda_getCurrentRawStream(dev.index)))
        err = lib.slice_scores(args.buffer_info()[0])
    _build.check(err, "slice_scores")
    spmv_fused_scores_device.launches += 1
    return out


def slice_scores_grid(dev, cfg: TopKSpMVConfig, part_slices: int,
                      num_partitions: int = 1,
                      row_order: bool = False) -> int:
    """K9's CUDA blocks a partition on CUDA ``dev`` for cfg's codec and a
    store form (``csrc/slice_scores.cu``): one resident wave, the card's
    SMs x the occupancy API's resident blocks an SM shared among the
    partitions, at least one, and no more than give each of a
    partition's ``part_slices`` slices a warp (K9_WARPS a block)."""
    rows, _ = _table_spec(cfg)
    arg, _ = _kernel_codec(dev, cfg.query_codec, rows)
    per_sm = _resident_blocks(dev, "slice_scores_occupancy", arg, rows,
                              int(row_order))
    blocks = max(1, _device_info(dev)[0] * per_sm // num_partitions)
    return max(1, min(blocks, -(-part_slices // K9_WARPS)))


spmv_fused_scores_device.launches = 0


# ------------------------------------------------------------ per-bucket ops
# One bucket of pack_sell_buckets (formats/sell_buckets.py::SellBucket):
# num_blocks * slices_per_block slices of ``width`` rows each, slice s on
# rows s * width .. (s + 1) * width - 1 (a block holds slices_per_block
# consecutive slices), padding slices past the bucket's real count zero.
# As the JAX kernels do, every op reads only width // 8 chunks of 8 rows
# of a slice: with width_quantum < 8 a width that is not a multiple of 8
# loses its last width % 8 rows, and a width below 8 scores 0.

def _halving_sum(acc):
    """(n, 8, 128) -> (n, 128): the 8 rows added as a halving tree,
    ((r0 + r4) + (r2 + r6)) + ((r1 + r5) + (r3 + r7)), each add rounded:
    the order in which XLA's CPU backend reduces the JAX kernels' (8, 128)
    accumulator over its rows (``jnp.sum(acc, axis=0)``) in most
    interpret-mode programs (index order left the quantized codecs a few
    ulps apart in most of them; XLA fuses a few programs otherwise)."""
    b = acc[:, :4] + acc[:, 4:]
    c = b[:, :2] + b[:, 2:]
    return c[:, 0] + c[:, 1]


def _bucket_sums(words, table, *, width: int, num_slices: int, codec: str,
                 pairs: bool):
    """f32 scores (num_slices, 128) of a bucket's first ``num_slices``
    slices, in the per-bucket kernels' order. h16: int32 sums (exact in
    any order) converted once. The float codecs: for each of the 8 rows
    of a chunk, its products summed over the chunks in chunk order, in
    two accumulators by chunk parity added together (``pairs``: K11 and
    K13, ``_bucket_kernel``'s two alternating accumulators) or in one
    (K12), each from 0; then the 8 row sums by ``_halving_sum``
    (csrc/bucket_common.cuh::halving_sum)."""
    chunks = width // _S
    prod = codec_prod(codec)
    per = max(1, _STEP_WORDS // (width * LANES))
    out = [torch.zeros((0, LANES), dtype=torch.float32, device=words.device)]
    for s0 in range(0, num_slices, per):
        n = min(per, num_slices - s0)
        tiles = words[s0 * width:(s0 + n) * width].reshape(
            n, width, LANES)[:, :chunks * _S].reshape(n, chunks, _S, LANES)
        p = prod(tiles, table)                              # (n, chunks, 8, L)
        if codec == "h16":
            out.append(p.sum(dim=(1, 2)).to(torch.float32))
            continue
        acc = (_row_sum(p[:, 0::2], 1) + _row_sum(p[:, 1::2], 1) if pairs
               else _row_sum(p, 1))
        out.append(_halving_sum(acc))
    return torch.cat(out)


def bucket_scores_plain(words, table, *, width: int, slices_per_block: int,
                        num_blocks: int, codec: str = "f32"):
    """Plain PyTorch version of the per-bucket SpMV (K11): (num_blocks *
    slices_per_block, 128) f32, row s the unscaled scores of slice s,
    padding slices included (zero words score 0)."""
    return _bucket_sums(words, table, width=width,
                        num_slices=num_blocks * slices_per_block,
                        codec=codec, pairs=True)


def _bucket_topk_one(words, table, num_real, *, lane_k: int, tie_safe: bool,
                     width: int, slices_per_block: int, slice_base: int,
                     num_blocks: int, codec: str, pairs: bool):
    n = min(max(int(num_real.reshape(-1)[0]), 0),
            num_blocks * slices_per_block)
    sc = _bucket_sums(words, table, width=width, num_slices=n, codec=codec,
                      pairs=pairs)
    tags = slice_base + torch.arange(n, device=words.device,
                                     dtype=torch.int32).view(-1, 1)
    return _merge_with_init([sc], [tags.expand_as(sc)], lane_k, tie_safe,
                            words.device)


def bucket_topk_plain(words, table, num_real, *, lane_k: int, tie_safe: bool,
                      width: int, slices_per_block: int, slice_base: int,
                      num_blocks: int, codec: str = "f32"):
    """Plain PyTorch version of the per-bucket Top-K (K13): (topv, topt),
    each (lane_k, 128), values sorted descending per lane, tags the global
    slice ids slice_base + s.

    Each lane keeps its exact top-``lane_k`` of the real slices' scores
    (s < num_real) and the initial sentinels (-inf when ``tie_safe``, else
    ``topk_init``). The JAX kernel also folds the padding slices, at -inf:
    that changes no value, only which tag a -inf slot of a tie-safe buffer
    holds. As for the fused sweeps, this equals the sequential argmin
    replacement whenever values are distinct; at exact ties only values
    above a lane's smallest kept value are comparable entry for entry."""
    return _bucket_topk_one(words, table, num_real, lane_k=lane_k,
                            tie_safe=tie_safe, width=width,
                            slices_per_block=slices_per_block,
                            slice_base=slice_base, num_blocks=num_blocks,
                            codec=codec, pairs=True)


def lane_merge_plain(vals, tags, lane_k: int):
    """Plain version of K13's lane merge on the card (csrc/bucket_topk.cu,
    ``merge``): each lane's first ``lane_k`` of the stacked (..., 128)
    entries in the order value descending, then tag ascending -> (topv,
    topt), each (lane_k, 128). That order is total on (value, tag)
    pairs, so the result does not depend on how the entries are grouped or
    ordered (the kernel merges its slots in a tree), and at a tie the
    smaller tag stays. A NaN is never kept: it ranks after every entry, as
    an empty place does (-inf, int32 max), which a lane of fewer than
    ``lane_k`` entries keeps."""
    v = vals.reshape(-1, LANES)
    t = tags.reshape(-1, LANES).to(torch.int32)
    short = lane_k - v.shape[0]
    if short > 0:
        v = torch.cat([v, v.new_full((short, LANES), NEG_INF)])
        t = torch.cat([t, t.new_full((short, LANES), _INT32_MAX)])
    nan = torch.isnan(v)
    v = torch.where(nan, NEG_INF, v)
    t = torch.where(nan, _INT32_MAX, t)
    # tag ascending, then a stable sort by value descending
    o = torch.argsort(t, dim=0, stable=True)
    v, t = v.gather(0, o), t.gather(0, o)
    o = torch.argsort(v, dim=0, descending=True, stable=True)[:lane_k]
    return v.gather(0, o), t.gather(0, o)


def bucket_topk_slots_plain(words, table, num_real, *, lane_k: int,
                            tie_safe: bool, width: int,
                            slices_per_block: int, slice_base: int,
                            num_blocks: int, num_slots: int,
                            codec: str = "f32"):
    """Plain version of K13 as the kernel computes it, on ``num_slots``
    slots (``_bucket_topk_slots``): slot j folds the real slices j, j +
    num_slots, ... in order into lane buffers from ``topk_init``'s entries
    (-inf when ``tie_safe``) by argmin replacement (when score >= the
    minimum: the first slot holding it when tie-safe, else every one);
    then ``lane_merge_plain`` over every slot's entries, the initial ones
    included -> (topv, topt), each (lane_k, 128). The kernel gives these
    pairs bit for bit on any data, tags and ties included. Against
    ``bucket_topk_plain``: equal values wherever the tie-safe buffers keep
    no duplicate, which holds always when tie-safe; without tie-safety
    ties can fill a slot's buffer with copies of one candidate, and a lane
    of fewer than lane_k real candidates keeps the initial entries of
    every slot."""
    K = lane_k
    dev = words.device
    n = min(max(int(num_real.reshape(-1)[0]), 0),
            num_blocks * slices_per_block)
    sc = _bucket_sums(words, table, width=width, num_slices=n, codec=codec,
                      pairs=True)
    init = (torch.full((K,), NEG_INF, device=dev) if tie_safe else
            torch.from_numpy(topk_init(K)).to(dev))
    tv = init.view(1, K, 1).expand(num_slots, K, LANES).clone()
    tt = torch.zeros((num_slots, K, LANES), dtype=torch.int32, device=dev)
    kslot = torch.arange(K, device=dev).view(1, K, 1)
    for s0 in range(0, n, num_slots):
        m = min(num_slots, n - s0)
        score = sc[s0:s0 + m].view(m, 1, LANES)
        cur = tv[:m].amin(dim=1, keepdim=True)
        hit = tv[:m] == cur
        if tie_safe:
            hit = kslot == hit.int().argmax(dim=1, keepdim=True)
        rep = hit & (score >= cur)
        tags = (slice_base + s0 + torch.arange(
            m, device=dev, dtype=torch.int32)).view(m, 1, 1)
        tv[:m] = torch.where(rep, score, tv[:m])
        tt[:m] = torch.where(rep, tags, tt[:m])
    return lane_merge_plain(tv, tt, K)


def bucket_topk_batch_plain(words, tables, num_real, **kw):
    """Plain PyTorch version of the multi-query per-bucket Top-K (K12):
    ``bucket_topk_plain`` for each query of the (Q, rows, 128) tables, its
    sums in K12's order (one accumulator per query) -> (topv, topt), each
    (Q, lane_k, 128). Keyword arguments as for ``bucket_topk_plain``."""
    outs = [_bucket_topk_one(words, t, num_real, pairs=False, **kw)
            for t in tables]
    return torch.stack([v for v, _ in outs]), torch.stack([t for _, t in outs])


def bucket_topk_batch_slots_plain(words, tables, num_real, *, lane_k: int,
                                  tie_safe: bool, width: int,
                                  slices_per_block: int, slice_base: int,
                                  num_blocks: int, num_slots: int,
                                  codec: str = "f32", merged: bool = True):
    """Plain version of K12 as the kernel computes it, on ``num_slots``
    slots (``k12_launch``): for each query of the (Q, rows, 128) tables,
    the real slices' scores in K12's order (``_bucket_sums``, one
    accumulator a row); the real slices form runs of 8 (the last may be
    shorter), slot j of S takes runs j R / S .. (j + 1) R / S - 1 of the R
    runs and folds their slices in order into lane buffers from
    ``topk_init``'s entries (-inf when ``tie_safe``) by argmin replacement
    (when score >= the minimum: the first slot holding it when tie-safe,
    else every one); then ``lane_merge_plain`` over every slot's entries,
    the initial ones included -> (topv, topt), each (Q, lane_k, 128).
    With ``merged`` False, each slot's buffer in the merge's order, (Q,
    slots, lane_k, 128), as the kernel's unmerged launch leaves them. The
    kernel gives these pairs bit for bit, tags and ties included, however
    its queries split into passes: on any data for h16 and f32, and for
    int8x4, i8s and i4s on the packer's words, which its Bf16Pass tables
    assume (``octet_topk_batch_slots_plain``). Against
    ``bucket_topk_batch_plain``: the same values whenever the buffers are
    tie-safe, and the same (value, tag) pairs above each lane's smallest
    kept value."""
    K, S = lane_k, num_slots
    dev = words.device
    n = min(max(int(num_real.reshape(-1)[0]), 0),
            num_blocks * slices_per_block)
    sc = torch.stack([_bucket_sums(words, t, width=width, num_slices=n,
                                   codec=codec, pairs=False)
                      for t in tables])                     # (Q, n, 128)
    Q = sc.shape[0]
    runs = -(-n // _RUN)
    j = torch.arange(S, device=dev)
    first = j * runs // S * _RUN
    length = ((j + 1) * runs // S * _RUN).clamp(max=n) - first
    init = (torch.full((K,), NEG_INF, device=dev) if tie_safe else
            torch.from_numpy(topk_init(K)).to(dev))
    tv = init.view(1, 1, K, 1).expand(Q, S, K, LANES).clone()
    tt = torch.zeros((Q, S, K, LANES), dtype=torch.int32, device=dev)
    kslot = torch.arange(K, device=dev).view(1, 1, K, 1)
    for step in range(int(length.max()) if n else 0):
        live = (step < length).view(1, S, 1, 1)
        s = (first + step).clamp(max=n - 1)
        score = sc[:, s].unsqueeze(2)                       # (Q, S, 1, 128)
        cur = tv.amin(dim=2, keepdim=True)
        hit = tv == cur
        if tie_safe:
            hit = kslot == hit.int().argmax(dim=2, keepdim=True)
        rep = hit & (score >= cur) & live
        tv = torch.where(rep, score, tv)
        tt = torch.where(rep, (slice_base + s).int().view(1, S, 1, 1), tt)
    if not merged:
        return _sorted_lists(tv, tt)
    outs = [lane_merge_plain(v, t, K) for v, t in zip(tv, tt)]
    return torch.stack([v for v, _ in outs]), torch.stack([t for _, t in outs])


def _check_bucket(words, num_slices: int, width: int, codec: str, name,
                  tables, lead, *extra):
    """Raise unless ``words`` is a contiguous int32 (num_slices * width,
    128) tensor on a CUDA device and ``tables`` ((*lead, rows, 128),
    float32 for f32, else int32) and each (name, tensor, shape) of
    ``extra`` (int32) are contiguous tensors on the same device, the
    table's rows ones the codec takes. Returns (table rows, SM count)."""
    dev = words.device
    if dev.type != "cuda":
        raise ValueError(f"words on {dev}: the kernels need CUDA")
    if min(num_slices, width) < 1:
        raise ValueError(f"bucket of {num_slices} slices of width {width}")
    if codec not in KERNEL_CODECS or codec.endswith("_global"):
        raise ValueError(f"unknown query codec {codec!r}")
    rows = tables.shape[-2] if tables.dim() == len(lead) + 2 else 0
    limit = 1 if codec == "h16" else 2 if codec in SIGN_SHIFTS else None
    if rows < 1 or (limit and rows > limit):
        raise ValueError(f"{name}: a {codec} table of shape "
                         f"{tuple(tables.shape)}")
    dtype = torch.float32 if codec == "f32" else torch.int32
    for what, t, shape, want in (
            ("words", words, (num_slices * width, LANES), torch.int32),
            (name, tables, (*lead, rows, LANES), dtype),
            *(e + (torch.int32,) for e in extra)):
        if t.device != dev or t.dtype != want or \
                t.shape != shape or not t.is_contiguous():
            raise ValueError(f"{what}: need contiguous {want} {shape} on "
                             f"{dev}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    return rows, _device_info(dev)[0]


def spmv_bucket_scores_device(words, table, *, cfg: TopKSpMVConfig,
                              width: int, slices_per_block: int,
                              num_blocks: int, codec: str = "f32"):
    """Plain SpMV over one bucket (K11): (num_blocks * slices_per_block,
    128) f32, row s the unscaled scores of the bucket's slice s in slice
    order; no Top-K and no real-slice mask (padding slices score 0).

    words: (num_blocks * slices_per_block * width, 128) int32, one bucket
    of ``pack_sell_buckets`` (``SellBucket.words``). table: one query's
    table of ``codec`` (``pack_query_table``: (1, 128) int32 for h16,
    (max_cols / 128, 128) float32 for f32, int32 rows for int8x4, i8s,
    i4s); its rows are read whatever they are, as in the JAX kernel.
    ``codec`` is a keyword of its own, not cfg.query_codec.

    CPU tensors run the plain version; CUDA tensors launch the kernel,
    K13's sweep on one resident wave of 128-thread groups
    (``_bucket_scores_slots``), a programmatic dependent launch: it stores
    its scores once the stream's previous kernel has completed.
    """
    _check_slice(cfg)
    n = num_blocks * slices_per_block
    if words.device.type == "cpu":
        return bucket_scores_plain(words, table, width=width,
                                   slices_per_block=slices_per_block,
                                   num_blocks=num_blocks, codec=codec)
    rows, _ = _check_bucket(words, n, width, codec, "table", table, ())
    dev = words.device
    arg, _ = _kernel_codec(dev, codec, rows)
    out = torch.empty((n, LANES), dtype=torch.float32, device=dev)
    _launch(dev, "bucket_scores", words.data_ptr(), table.data_ptr(), n,
            width, rows, arg, _bucket_scores_slots(dev, arg, rows, n),
            out.data_ptr())
    spmv_bucket_scores_device.launches += 1
    return out


def _bucket_scores_slots(dev, arg: int, rows: int, num_slices: int) -> int:
    """K11's 128-thread groups (csrc/bucket_scores.cu): ``_bucket_blocks``
    of the kernel's resident blocks an SM from the occupancy API. Its
    scores do not depend on them."""
    per_sm = _resident_blocks(dev, "bucket_scores_occupancy", arg, rows)
    return _bucket_blocks(_device_info(dev)[0], num_slices, per_sm)


spmv_bucket_scores_device.launches = 0


def _bucket_blocks(sms: int, num_slices: int, per_sm: int = 1) -> int:
    """K13's slots (and K11's groups) on a card of ``sms`` SMs: one
    resident wave of ``per_sm`` blocks an SM (the occupancy API's answer:
    1 for every build, whose launch bounds give a thread up to 128
    registers) of BUCKET_GROUPS slots, no more than the bucket has
    slices."""
    return max(1, min(sms * BUCKET_GROUPS * per_sm, num_slices))


def topk_spmv_bucket_device(words, table, num_real, *, cfg: TopKSpMVConfig,
                            num_groups: int, width: int,
                            slices_per_block: int, slice_base: int,
                            num_blocks: int, codec: str = "f32",
                            cuda_blocks: int | None = None):
    """Per-bucket Top-K of one query (K13): (topv f32, topt i32), each
    (lane_k, 128), sorted descending per lane; tags are global slice ids
    slice_base + s, so the buffers of every bucket stack and finalize
    together (``finalize_topk`` with the matrix's ``row_ids``).

    words and table as for ``spmv_bucket_scores_device``; num_real: (1, 1)
    int32, the bucket's real slices (slices at or past it are left out).
    num_groups is accepted and unused: as in the JAX kernel, the table's
    rows decide. cfg gives lane_k and tie_safe_topk.

    CPU tensors run the plain version; CUDA tensors launch the kernel, one
    launch that returns the final pair (the lane merge runs on the card,
    ``bucket_topk_slots_plain`` computes what it gives) and reads
    num_real on the card. The launch is a programmatic dependent launch:
    when the stream's previous kernel is K13 too, this one's sweep starts
    during that one's merge (it reads nothing that launch writes); after
    any other kernel it starts when that completes. ``cuda_blocks`` forces
    the grid (by default one resident wave), for tests.
    """
    del num_groups
    _check_slice(cfg)
    K = cfg.lane_k
    tie_safe = bool(cfg.tie_safe_topk)
    if words.device.type == "cpu":
        return bucket_topk_plain(words, table, num_real, lane_k=K,
                                 tie_safe=tie_safe, width=width,
                                 slices_per_block=slices_per_block,
                                 slice_base=slice_base, num_blocks=num_blocks,
                                 codec=codec)
    n = num_blocks * slices_per_block
    rows, _ = _check_bucket(words, n, width, codec, "table", table, (),
                            ("num_real", num_real, (1, 1)))
    _check_lane_k(K)
    dev = words.device
    arg, _ = _kernel_codec(dev, codec, rows)
    slots = _bucket_topk_slots(dev, arg, K, rows, n, cuda_blocks)
    blocks = -(-slots // BUCKET_GROUPS)
    lib = _build.lib()
    with (contextlib.nullcontext() if torch.cuda.current_device() == dev.index
          else torch.cuda.device(dev)):
        stream = torch._C._cuda_getCurrentRawStream(dev.index)
        ws, tickets = _merge_workspace("k13", dev, stream,
                                       4 * blocks * K * LANES, blocks + 1)
        out_v = torch.empty((K, LANES), dtype=torch.float32, device=dev)
        out_t = torch.empty((K, LANES), dtype=torch.int32, device=dev)
        # the arguments as int64 values, in csrc/bucket_topk.cu's order:
        # one ctypes argument costs a few microseconds less than 20
        args = array.array("q", (
            words.data_ptr(), table.data_ptr(), num_real.data_ptr(), n,
            width, rows, arg, K, int(tie_safe), slice_base, slots,
            ws.data_ptr(),
            ws.numel() // (2 * K * LANES), tickets.data_ptr(),
            tickets.numel(), out_v.data_ptr(), out_t.data_ptr(), stream))
        err = lib.bucket_topk(args.buffer_info()[0])
    _build.check(err, "bucket_topk")
    topk_spmv_bucket_device.launches += 1
    return out_v, out_t


def _bucket_topk_slots(dev, arg: int, lane_k: int, rows: int,
                       num_slices: int, cuda_blocks=None):
    """K13's slots (csrc/bucket_topk.cu): ``_bucket_blocks`` of the
    kernel's resident blocks an SM from the occupancy API (the non-tie-
    safe buffers depend on the slots at ties), or ``cuda_blocks`` x
    BUCKET_GROUPS; no more than the bucket's slices."""
    if cuda_blocks is not None:
        if cuda_blocks < 1:
            raise ValueError(f"cuda_blocks={cuda_blocks}: need >= 1")
        return max(1, min(cuda_blocks * BUCKET_GROUPS, num_slices))
    per_sm = _resident_blocks(dev, "bucket_topk_occupancy", arg, lane_k,
                              rows)
    return _bucket_blocks(_device_info(dev)[0], num_slices, per_sm)


def _merge_workspace(kind: str, dev, stream: int, words: int, tickets: int):
    """The merge workspace (int32, at least ``words`` entries) and tickets
    (at least ``tickets`` zeros, which each launch leaves 0) of the lane
    merges on the card, K13's (``kind`` "k13"), K12's ("k12"), K6's
    ("k6"), K1's ("k1"), K7's ("k7") or K8's ("k8"), or of K3's sum
    ("k3", its accumulator and ticket), on
    ``dev`` for launches on ``stream``: allocated once per (kind, device,
    stream) and grown when a launch needs more."""
    key = (kind, dev.index, stream)
    have = _MERGE_WORKSPACE.get(key)
    if have is None or have[0].numel() < words or have[1].numel() < tickets:
        if have is not None:
            words = max(words, have[0].numel())
            tickets = max(tickets, have[1].numel())
        have = _MERGE_WORKSPACE[key] = (
            torch.empty(words, dtype=torch.int32, device=dev),
            torch.zeros(tickets, dtype=torch.int32, device=dev))
    return have


topk_spmv_bucket_device.launches = 0


def topk_spmv_bucket_batch_device(words, tables, num_real, *,
                                  cfg: TopKSpMVConfig, width: int,
                                  slices_per_block: int, slice_base: int,
                                  num_blocks: int, codec: str = "f32"):
    """Per-bucket Top-K of Q queries (K12): (topv f32, topt i32), each
    (Q, lane_k, 128), sorted descending per lane. tables: (Q, rows, 128)
    tables of ``codec`` (``pack_query_tables``); the other arguments as
    for ``topk_spmv_bucket_device``. Each query's sums run in one
    accumulator (the JAX batch kernel's order), so its values can differ
    from K13's in the last bits. ``cfg.batch_subgroup`` is not read.

    CPU tensors run the plain version; CUDA tensors launch the kernel, one
    launch that returns the final pairs, its lane merge on the card
    (``_bucket_topk_batch_cuda``: the bucket read once a pass of queries,
    ``k12_launch``; ``bucket_topk_batch_slots_plain`` on its slots
    computes what it gives), and no torch op after it. The launch is a
    programmatic dependent launch, as K13's.
    """
    _check_slice(cfg)
    kw = dict(lane_k=cfg.lane_k, tie_safe=bool(cfg.tie_safe_topk),
              width=width, slices_per_block=slices_per_block,
              slice_base=slice_base, num_blocks=num_blocks, codec=codec)
    if words.device.type == "cpu":
        return bucket_topk_batch_plain(words, tables, num_real, **kw)
    return _bucket_topk_batch_cuda(words, tables, num_real, **kw)


def k12_pass(codec: str, num_queries: int, lane_k: int, table_rows: int,
             smem_limit: int):
    """K12's (kernel codec, queries a pass) for ``num_queries`` queries of
    ``codec`` (K12_PASS_QUERIES): h16 in passes of 8, or 16 for more than
    8 queries (K8's H16Pass tables, 16 KB); the other codecs in passes of
    8 on K6's tables (``k6_pass``: FloatPass for f32, Bf16Pass for int8x4,
    i8s and i4s, f32 and int8x4 tables past shared memory from global
    memory)."""
    if codec != "h16":
        return k6_pass(codec, 8, lane_k, table_rows, smem_limit)
    return codec, 8 if num_queries <= 8 else 16


def k12_launch(dev, codec: str, num_queries: int, lane_k: int,
               table_rows: int, num_slices: int):
    """K12's launch shape on CUDA ``dev`` for a bucket of ``num_slices``
    slices: (kernel codec, queries a pass, passes, slots). The passes
    (``k12_pass``) and the slots of a pass are ``pass_grid``'s (one CUDA
    block an SM), no more slots than the bucket has runs of 8 slices."""
    sms, limit = _device_info(dev)
    kcodec, qp = k12_pass(codec, num_queries, lane_k, table_rows, limit)
    passes, slots = pass_grid(num_queries, sms, qp, lane_k, kcodec)
    return kcodec, qp, passes, max(1, min(slots, -(-num_slices // _RUN)))


def _bucket_topk_batch_cuda(words, tables, num_real, *, lane_k: int,
                            tie_safe: bool, width: int,
                            slices_per_block: int, slice_base: int,
                            num_blocks: int, codec: str, unmerged=False):
    """K12's launch on CUDA tensors (``topk_spmv_bucket_batch_device``'s
    keywords): one launch that returns the merged pairs, (Q, lane_k, 128);
    with ``unmerged`` each slot's buffers, sorted (value descending, then
    tag ascending), (Q, slots, lane_k, 128) values and tags, the merge not
    run, for timing the sweep alone."""
    Q = tables.shape[0] if tables.dim() == 3 else 0
    if Q < 1:
        raise ValueError(f"tables of shape {tuple(tables.shape)}: need "
                         "(Q >= 1, rows, 128)")
    n = num_blocks * slices_per_block
    rows, _ = _check_bucket(words, n, width, codec, "tables", tables, (Q,),
                            ("num_real", num_real, (1, 1)))
    _check_lane_k(lane_k)
    if codec == "h16" and width > 65535:
        raise ValueError(f"an h16 bucket of width {width}: K12's packed "
                         "sums stay exact up to 65,535 words a slice")
    K = lane_k
    dev = words.device
    kcodec, qp, passes, slots = k12_launch(dev, codec, Q, K, rows, n)
    sets = _merge_sets(slots)
    lists = Q * (slots if unmerged else slots + sets)
    tickets = passes * 4 * (1 + sets)
    with (contextlib.nullcontext() if torch.cuda.current_device() == dev.index
          else torch.cuda.device(dev)):
        stream = torch._C._cuda_getCurrentRawStream(dev.index)
        if unmerged:   # no ticket read: nothing to zero between launches
            ws = torch.empty(lists * 2 * K * LANES, dtype=torch.int32,
                             device=dev)
            ticket = torch.empty(1, dtype=torch.int32, device=dev)
        else:
            ws, ticket = _merge_workspace("k12", dev, stream,
                                          lists * 2 * K * LANES, tickets)
        lists = ws.numel() // (2 * K * LANES)
        out_v = torch.empty((Q, K, LANES), dtype=torch.float32, device=dev)
        out_t = torch.empty((Q, K, LANES), dtype=torch.int32, device=dev)
        # the arguments as int64 values, in csrc/bucket_topk_batch.cu's order
        args = array.array("q", (
            words.data_ptr(), tables.data_ptr(), num_real.data_ptr(), n,
            width, rows, KERNEL_CODECS.index(kcodec), K, int(tie_safe),
            slice_base, Q, qp, slots, int(not unmerged), ws.data_ptr(),
            lists, ticket.data_ptr(), ticket.numel(), out_v.data_ptr(),
            out_t.data_ptr(), stream))
        err = _build.lib().bucket_topk_batch(args.buffer_info()[0])
    _build.check(err, "bucket_topk_batch")
    topk_spmv_bucket_batch_device.launches += 1
    if unmerged:
        m = Q * slots * K * LANES
        return (ws[:m].view(torch.float32).view(Q, slots, K, LANES),
                ws[lists * K * LANES:][:m].view(Q, slots, K, LANES))
    return out_v, out_t


topk_spmv_bucket_batch_device.launches = 0


def finalize_topk_batch(topv, topt, row_ids, k: int):
    """Global Top-K merge of each query's per-lane candidates.

    topv/topt: (Q, ..., 128). Maps (slice, lane) to a row through
    ``row_ids``, clamps slice tags into the sentinel (-1) row, masks
    entries at or below TOPK_FLOOR and rows of -1, and takes each query's
    top-k. Returns (rows int32, values f32), each (Q, k), values
    descending; a k larger than the candidate pool is clamped to the pool.
    The counterpart of the JAX package's ``vmap(finalize_topk)``.
    """
    Q = topv.shape[0]
    L = row_ids.shape[1]
    flat_v = topv.reshape(Q, -1)
    flat_t = topt.reshape(Q, -1).clamp(0, row_ids.shape[0] - 1).long()
    lane = torch.arange(L, device=topv.device).repeat(flat_v.shape[1] // L)
    rows = row_ids.reshape(-1)[flat_t * L + lane]
    valid = (rows >= 0) & (flat_v > TOPK_FLOOR)
    masked = torch.where(valid, flat_v, torch.full_like(flat_v, NEG_INF))
    vals, pos = torch.topk(masked, min(k, masked.shape[1]), dim=1)
    return torch.gather(rows, 1, pos), vals


def finalize_topk(topv, topt, row_ids, k: int):
    """``finalize_topk_batch`` of one query: (lane_k, 128) candidates ->
    (rows int32, values f32), each (k,)."""
    rows, vals = finalize_topk_batch(topv[None], topt[None], row_ids, k)
    return rows[0], vals[0]
