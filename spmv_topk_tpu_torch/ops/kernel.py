"""Octet Top-K sweep (kernel K1), its per-lane merge and ``finalize_topk``.

``topk_spmv_fused_octet_device`` is the device sweep of the single-query
path: every octet of the slice-transposed stream (formats/sell_buckets.py::
fuse_buckets_octet) adds up its W decoded h16 chunks into 8 member
scores per lane, harvests the top 3 of the 8 (or all 8 with
``fold_tile=1``) into per-lane (value, slice) buffers of ``lane_k``
entries, and the buffers merge into one ``(lane_k, 128)`` pair.

  - On a CUDA tensor it launches ``csrc/octet_topk.cu`` (which replaces
    ``spmv_topk_tpu/ops/kernel.py::_fused_kernel_octet`` and its
    ``_octet_multicall`` dispatch), then merges the per-CUDA-block
    buffers with one per-lane ``torch.topk``, the same algebra as the
    JAX package's per-lane ``lax.top_k`` over its per-bucket buffers.
  - On a CPU tensor it runs ``octet_topk_plain``, the plain PyTorch
    version of the same function, which the tests hold against the JAX
    package and the card holds the kernel against.

Plan rows: the kernel reads the bucket plan from an int32 ``(B, 8)``
tensor (``octet_plan_rows``) with columns ``PLAN_COLUMNS``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import LANES, TopKSpMVConfig
from . import _build

NEG_INF = float("-inf")

# Sentinel floor of the Top-K buffers: real scores of L2-normalized
# embeddings are O(1), so anything at or below this is an unfilled slot
# (finalize_topk masks on it).
TOPK_FLOOR = -1e38

PLAN_COLUMNS = ("width", "octets_per_block", "blocks_per_octet", "stride",
                "slice_base", "blk_start", "num_blocks", "octet_start")

# Top-K buffer depths the CUDA kernel is instantiated for
KERNEL_LANE_K = (4, 8, 16)
# CUDA blocks per SM of the sweep: each block owns one set of lane
# buffers, so this also sets the merge width (blocks * lane_k per lane)
_BLOCKS_PER_SM = 8
_HARVEST = 3   # octet fold: top 3 of the 8 members per lane


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


def octet_topk_plain(words, table, nreal, plan_rows, *, lane_k: int,
                     fold_tile: int, tie_safe: bool, block_sublanes: int,
                     chunk_sublanes: int = 8):
    """Plain PyTorch version of the octet sweep: (topv, topt), each
    (lane_k, 128), values sorted descending per lane.

    Harvests the same candidates as the kernel and gives each lane its
    exact top-``lane_k`` of them, the initial sentinels included (``-inf``
    when ``tie_safe``, else ``topk_init``). That equals the sequential
    argmin replacement whenever values are distinct; at exact ties the
    replacement order decides which tied candidates (and, without
    ``tie_safe``, how many copies) stay, so only values above a lane's
    smallest kept value are comparable entry for entry.
    """
    S = chunk_sublanes
    dev = words.device
    tab = table.reshape(-1)[:LANES]
    miota = torch.arange(S, device=dev, dtype=torch.int32).view(1, S, 1)
    cand_v, cand_t = [], []
    # at most ~16M words decoded at once (bounds the int64 gather indices)
    step_words = 1 << 24
    for b, row in enumerate(plan_rows.tolist()):
        W, G, slice_base = row[0], row[3], row[4]
        n_real = int(nreal.reshape(-1)[b])
        tiles = _octet_tiles(words, row, block_sublanes, S)
        per = max(1, step_words // (W * S * LANES))
        for o0 in range(0, G, per):
            t = tiles[o0:o0 + per]
            acc = prod_h16(t, tab).sum(dim=1).to(torch.float32)  # (g, S, L)
            oidx = torch.arange(o0, o0 + t.shape[0], device=dev,
                                dtype=torch.int32).view(-1, 1, 1)
            member = oidx + miota * G                          # slice - base
            sc = torch.where(member < n_real, acc,
                             torch.full_like(acc, NEG_INF))
            if fold_tile == 1:
                cand_v.append(sc.reshape(-1, LANES))
                cand_t.append((slice_base + member).expand_as(sc)
                              .reshape(-1, LANES))
                continue
            for _ in range(_HARVEST):
                m1 = sc.amax(dim=1, keepdim=True)
                sl = torch.where(sc == m1, miota, S).amin(dim=1, keepdim=True)
                cand_v.append(m1.reshape(-1, LANES))
                cand_t.append((slice_base + oidx + sl * G).reshape(-1, LANES))
                sc = torch.where(miota == sl, NEG_INF, sc)
    if tie_safe:
        init = torch.full((lane_k, LANES), NEG_INF, device=dev)
    else:
        init = torch.from_numpy(topk_init(lane_k)).to(dev).view(-1, 1) \
            .expand(lane_k, LANES)
    tags0 = torch.zeros((lane_k, LANES), dtype=torch.int32, device=dev)
    return merge_lane_topk(torch.cat(cand_v + [init]),
                           torch.cat(cand_t + [tags0]), lane_k)


def merge_lane_topk(topv, topt, lane_k: int):
    """Per-lane top-``lane_k`` over stacked candidates ((..., 128) values
    and tags) -> (lane_k, 128) pair, values sorted descending."""
    allv = topv.reshape(-1, LANES)
    allt = topt.reshape(-1, LANES)
    mv, mi = torch.topk(allv, lane_k, dim=0)
    return mv, torch.gather(allt, 0, mi)


def topk_spmv_fused_octet_device(words, table, nreal, plan_rows, *,
                                 cfg: TopKSpMVConfig, block_sublanes: int):
    """Octet sweep of the h16 stream: per-lane (topv, topt) candidates.

    words: (num_blocks * block_sublanes, 128) int32 octet stream.
    table: (1, 128) int32 h16 query table (int4x8).
    nreal: (B, 1) int32 real slices per bucket.
    plan_rows: (B, 8) int32 plan table (octet_plan_rows).
    Returns (topv f32, topt i32), each (lane_k, 128), sorted descending.

    CPU tensors run the plain version; CUDA tensors launch the kernel.
    """
    if cfg.query_codec != "h16":
        raise NotImplementedError(
            f"query_codec={cfg.query_codec!r}: the octet sweep is ported for "
            "h16 only (ROADMAP.md Queue 1 item 5, other query codecs)")
    kw = dict(lane_k=cfg.lane_k, fold_tile=cfg.fold_tile,
              tie_safe=bool(cfg.tie_safe_topk), block_sublanes=block_sublanes,
              chunk_sublanes=cfg.chunk_sublanes)
    if words.device.type == "cpu":
        return octet_topk_plain(words, table, nreal, plan_rows, **kw)
    return _octet_topk_cuda(words, table, nreal, plan_rows, **kw)


def _octet_topk_cuda(words, table, nreal, plan_rows, *, lane_k, fold_tile,
                     tie_safe, block_sublanes, chunk_sublanes):
    dev = words.device
    if dev.type != "cuda":
        raise ValueError(f"words on {dev}: the octet kernel needs CUDA")
    B = plan_rows.shape[0]
    for name, t, shape in (("words", words, (words.shape[0], LANES)),
                           ("table", table, (1, LANES)),
                           ("nreal", nreal, (B, 1)),
                           ("plan_rows", plan_rows, (B, len(PLAN_COLUMNS)))):
        if t.device != dev or t.dtype != torch.int32 or \
                tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name}: need contiguous int32 {shape} on {dev},"
                             f" got {t.dtype} {tuple(t.shape)} on {t.device}")
    if lane_k not in KERNEL_LANE_K:
        raise ValueError(f"lane_k={lane_k}: the kernel is built for "
                         f"{KERNEL_LANE_K}")
    if chunk_sublanes != 8 or fold_tile not in (1, 8):
        raise ValueError("the octet kernel needs chunk_sublanes=8 and "
                         "fold_tile 1 or 8")
    if words.shape[0] % block_sublanes:
        raise ValueError("words rows are not a whole number of blocks")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # every octet holds >= 1 chunk: no more blocks than chunks
    nblk = max(1, min(sms * _BLOCKS_PER_SM, words.shape[0] // chunk_sublanes))
    out_v = torch.empty((nblk, lane_k, LANES), dtype=torch.float32,
                        device=dev)
    out_t = torch.empty((nblk, lane_k, LANES), dtype=torch.int32, device=dev)
    lib = _build.lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.octet_topk_h16(
            words.data_ptr(), table.data_ptr(), nreal.data_ptr(),
            plan_rows.data_ptr(), B, block_sublanes, lane_k,
            int(fold_tile == 1), int(tie_safe), nblk,
            out_v.data_ptr(), out_t.data_ptr(), stream)
    _build.check(err, "octet_topk_h16")
    topk_spmv_fused_octet_device.launches += 1
    return merge_lane_topk(out_v, out_t, lane_k)


topk_spmv_fused_octet_device.launches = 0


def finalize_topk(topv, topt, row_ids, k: int):
    """Global Top-K merge of the per-lane candidates.

    Maps (slice, lane) to a row through ``row_ids``, clamps slice tags
    into the sentinel (-1) row, masks entries at or below TOPK_FLOOR and
    rows of -1, and takes the global top-k. Returns (rows int32, values
    f32), values descending; a k larger than the candidate pool is
    clamped to the pool.
    """
    L = row_ids.shape[1]
    flat_v = topv.reshape(-1)
    flat_t = topt.reshape(-1).clamp(0, row_ids.shape[0] - 1).long()
    lane = torch.arange(L, device=topv.device).repeat(flat_v.numel() // L)
    rows = row_ids.reshape(-1)[flat_t * L + lane]
    valid = (rows >= 0) & (flat_v > TOPK_FLOOR)
    masked = torch.where(valid, flat_v, torch.full_like(flat_v, NEG_INF))
    vals, pos = torch.topk(masked, min(k, masked.numel()))
    return rows[pos], vals
