"""Batch lab (L1) on the H100: the structure of the multi-query h16 decode
(experiments/batch_lab.py), each variant timed beside the stream probe K3
on the same words.

Q (LAB_Q, 16) queries share one h16 stream: a slice's score for query q
is the int32 sum of its words' two products val * nibble against query
q's int4x8 row, converted once, and each query folds its slice scores
into its own buffer by the fast fold (every minimum slot replaced when
score >= minimum). Variants:

  cur       chunk-outer, Q live accumulators, the full decode per query
            (the query-independent part repeated; the compiler may share
            it)
  shared    the same with the query-independent decode written once a
            word
  nofold    ``shared`` without the Top-K fold: the sum over the queries of
            a slice's scores into query 0's slots (running maximum)
  sub2/4/8  queries in subgroups of 2, 4, 8: the words read again and the
            shared decode recomputed for each subgroup
  tilefold  ``shared`` with a strided tile-8 fold: each tile of up to 8
            slices (slices gi, gi + G, ..., G = ceil(SPB / 8)) gives its
            top 2 (lowest member among ties), folded by the fast fold

W (LAB_W, 16) rows per slice, SPB (LAB_SPB, 1024 // W) slices per block,
NB (LAB_NB, 2048 here: 1 GiB of words at W = 16) blocks. A gather index
is the field's low 7 bits, as the TPU's lane gather reads it (the JAX lab
gathers the raw word outside its interpret mode).

A fast-fold buffer's LANE_K slots stay equal (they start equal, and every
slot holding the minimum is replaced), so the kernel keeps one (value,
tag) pair a query and lane; ``batch_lab_device`` returns the LANE_K slots
the TPU keeps, merged over the CUDA blocks (``_common.merge_fast``: each
slot the maximum, tagged with the largest tag holding it, which is the
tag the sequential fold leaves). ``batch_lab_device`` launches
``csrc/lab_batch.cu`` on a CUDA tensor and ``batch_lab_plain`` runs on a
CPU tensor.

    python -m spmv_topk_tpu_torch.experiments.batch_lab [variant ...]
        [--device cpu]      (env LAB_Q, LAB_W, LAB_SPB, LAB_NB)
"""

from __future__ import annotations

import torch

from ._common import (CHUNK, LANE_K, LANES, NEG_INF, batch_lab_data,
                      check_tables, check_words, cuda_blocks, drive, env_int,
                      fast_fold_seq, int_scores, merge_fast, parse_args)
from .h16_lab import decode_nsh

# variant -> (structure, query subgroup); the order is csrc/lab_batch.cu's
# enum Variant
VARIANTS = {"cur": ("cur", 0), "shared": ("shared", 0),
            "nofold": ("nofold", 0), "sub2": ("sub", 2), "sub4": ("sub", 4),
            "sub8": ("sub", 8), "tilefold": ("tilefold", 0)}
TILE = 8
KERNEL_QUERIES = (4, 16)       # the query counts the kernel is built for
DEFAULT_NB = 2048              # 1 GiB of words at W = 16, SPB = 64


def _check(words, tables, variant, W, SPB, S):
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    if S != CHUNK:
        raise ValueError(f"the lab reads chunks of {CHUNK} rows, got S={S}")
    nb = check_words(words, W * SPB)
    check_tables(tables, words.device)
    return nb


def tile_candidates(scores, SPB: int):
    """tilefold's candidates of (n, 128) slice scores of blocks of SPB
    slices, in fold order: (values, tags), each (P, 128). Each tile (lab
    block i, gi < G) holds slices gi + m * G < SPB and gives its maximum
    and, with two members or more, the maximum of the others, each at the
    lowest member holding it (batch_lab.py:149-189)."""
    n = scores.shape[0]
    nb, G = n // SPB, -(-SPB // TILE)
    m = torch.arange(TILE, device=scores.device)
    j = torch.arange(G, device=scores.device).view(-1, 1) + m * G  # (G, 8)
    valid = j < SPB
    blk = scores.reshape(nb, SPB, LANES)
    tile = torch.where(valid[None, :, :, None],
                       blk[:, j.clamp(max=SPB - 1)], NEG_INF)  # (nb,G,8,L)
    mi = m.view(1, 1, -1, 1)
    m1 = tile.amax(2, keepdim=True)
    s1 = torch.where(tile == m1, mi, TILE).amin(2, keepdim=True)
    rest = torch.where(mi == s1, NEG_INF, tile)
    m2 = rest.amax(2, keepdim=True)
    s2 = torch.where(rest == m2, mi, TILE).amin(2, keepdim=True)
    t0 = (torch.arange(nb, device=scores.device).view(-1, 1) * SPB
          + torch.arange(G, device=scores.device)).view(nb, G, 1, 1)
    vals = torch.cat([m1, m2], 2)                               # (nb,G,2,L)
    tags = (t0 + torch.cat([s1, s2], 2) * G).to(torch.int32)
    # a tile of one member folds its maximum only
    two = valid.sum(1).view(1, G, 1, 1) > torch.arange(
        2, device=scores.device).view(1, 1, -1, 1)
    vals = torch.where(two, vals, NEG_INF)
    return vals.reshape(-1, LANES), tags.reshape(-1, LANES)


def batch_lab_plain(words, tables, *, variant: str, W: int = 16,
                    SPB: int = 64, S: int = CHUNK):
    """Plain PyTorch version of the lab: (tv, tt), each (Q, 8, 128), every
    query's LANE_K equal slots (nofold: query 0's the running maximum of
    the slices' score sums over the queries, the others -inf; tags 0).
    words: (NB * W * SPB, 128) int32; tables: (Q, 128) int32."""
    _check(words, tables, variant, W, SPB, S)
    mode, _ = VARIANTS[variant]
    Q, dev = tables.shape[0], words.device
    tv = torch.full((Q, LANES), NEG_INF, device=dev)
    tt = torch.zeros((Q, LANES), dtype=torch.int32, device=dev)
    if mode == "nofold":
        tot = int_scores(words, lambda t: sum(
            decode_nsh(t, tables[q:q + 1]) for q in range(Q)), W=W)
        tv[0] = tot.amax(0)
    else:
        for q in range(Q):
            sc = int_scores(words, lambda t, q=q: decode_nsh(
                t, tables[q:q + 1]), W=W)
            if mode == "tilefold":
                vals, tags = tile_candidates(sc, SPB)
            else:
                vals, tags = sc, torch.arange(
                    sc.shape[0], dtype=torch.int32, device=dev).view(
                        -1, 1).expand_as(sc)
            tv[q], tt[q] = fast_fold_seq(vals, tags)
    return (tv[:, None].expand(Q, LANE_K, LANES).contiguous(),
            tt[:, None].expand(Q, LANE_K, LANES).contiguous())


def batch_lab_device(words, tables, *, variant: str, W: int = 16,
                     SPB: int = 64, S: int = CHUNK, blocks=None,
                     unmerged: bool = False):
    """The lab kernel (csrc/lab_batch.cu) on a CUDA tensor: (tv, tt) as
    ``batch_lab_plain``, which a CPU tensor runs. ``blocks``: the CUDA
    block count (default ``_common.cuda_blocks``). ``unmerged``: the
    kernel's (value, tag) pair of each CUDA block, query and lane,
    (blocks, Q, 1, 128) each (on the CPU, the plain result's first slot
    as one block)."""
    nb = _check(words, tables, variant, W, SPB, S)
    Q = tables.shape[0]
    if words.device.type == "cpu":
        tv, tt = batch_lab_plain(words, tables, variant=variant, W=W,
                                 SPB=SPB, S=S)
        return (tv[None, :, :1], tt[None, :, :1]) if unmerged else (tv, tt)
    if Q not in KERNEL_QUERIES:
        raise ValueError(f"Q={Q}: the kernel is built for {KERNEL_QUERIES} "
                         f"queries")
    from ..ops.kernel import _launch

    nblk = cuda_blocks(words.device, nb, blocks)
    out_v = torch.empty((nblk, Q, 1, LANES), dtype=torch.float32,
                        device=words.device)
    out_t = torch.empty((nblk, Q, 1, LANES), dtype=torch.int32,
                        device=words.device)
    _launch(words.device, "lab_batch", words.data_ptr(), tables.data_ptr(),
            nb, W, SPB, Q, list(VARIANTS).index(variant), nblk,
            out_v.data_ptr(), out_t.data_ptr())
    batch_lab_device.launches += 1
    if unmerged:
        return out_v, out_t
    v, t = merge_fast(out_v, out_t)
    return (v.expand(Q, LANE_K, LANES).contiguous(),
            t.expand(Q, LANE_K, LANES).contiguous())


batch_lab_device.launches = 0


def main(argv=None):
    names, dev = parse_args(argv, list(VARIANTS), list(VARIANTS), __doc__)
    Q, W = env_int("LAB_Q", 16), env_int("LAB_W", 16)
    SPB = env_int("LAB_SPB", max(1, 1024 // W))
    nb = env_int("LAB_NB", DEFAULT_NB)
    words, tables = (torch.from_numpy(a).to(dev)
                     for a in batch_lab_data(nb, W * SPB, Q))

    def call(name, unmerged=False):
        return batch_lab_device(words, tables, variant=name, W=W, SPB=SPB,
                                unmerged=unmerged)

    return drive("batch_lab", names, words, nb, 2, call,
                 lambda name: call(name, unmerged=True), queries=Q)


if __name__ == "__main__":
    main()
