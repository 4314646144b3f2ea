"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Marked ``cuda``; every test skips where torch sees no CUDA device. This
file imports no jax, so it runs on a GPU host without the JAX package
(``--noconftest`` skips tests/conftest.py, which imports jax):

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Kernels: K1 (single-query octet sweep; with its lane merge on the card,
held bit for bit to ``octet_topk_slots_plain``, tags included), K6
(multi-query octet sweep),
K4 (octet SpMV), K3 (stream probe, one launch a call), on the slice
stream K7 (single-query sweep; its lane merge on the card, held bit for
bit to ``slice_topk_slots_plain``, tags included), K8 (multi-query sweep)
and K9 (SpMV; K4 and K9 in slice order and in row order, and
``scores()`` against the path before the row-order store), and all six
on partitioned streams (K10a-d and the partitioned K4/K9), with every
query codec (int8x4, i8s, i4s on both streams, f32 on the octet stream),
and the per-bucket ops K11, K13, K12 over pack_sell_buckets' buckets (K12
and K13 with their lane merge on the card, held bit for bit to
``bucket_topk_batch_slots_plain`` and ``bucket_topk_slots_plain``, tags
included). Tolerances:
none against the plain versions. h16 scores are int32 sums converted to
f32 once, so with tie-safe buffers the per-lane sorted values are
bit-equal, and (value, slice) pairs are equal above each lane's smallest
kept value; the SpMV kernels' per-slice scores are bit-equal; the stream
checksum is an exact int32 sum. f32 too is held bit for bit, on
integer-valued and on real data: the plain versions sum in the kernels'
order (see the slice section).
"""

import dataclasses

import numpy as np
import pytest
import torch

import spmv_topk_tpu_torch as pt
from spmv_topk_tpu_torch.formats import (create_query_batch,
                                         create_sparse_matrix)
from spmv_topk_tpu_torch.ops import kernel as pkernel
from spmv_topk_tpu_torch.ops import streamprobe as pstream
from spmv_topk_tpu_torch.ops.quantized_query import pack_query_tables

pytestmark = pytest.mark.cuda

HEADLINE = dict(k=100, lane_k=8, max_cols=1024, query_codec="h16",
                fused_layout="octet", width_quantum=2, fold_tile=8,
                rescore_pool=400, block_sublanes=512,
                fused_block_sublanes=1024)


@pytest.fixture(scope="module")
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def corpus():
    return (create_sparse_matrix(20_000, 1024, 20, "gamma", seed=21),
            create_query_batch(2, 1024, seed=22))


def _tables(qs, dev):
    tabs, _ = pack_query_tables(qs, "h16")
    return torch.from_numpy(tabs).to(dev)


def _lanes_equal(kv, kt, pv, pt_):
    kv, kt, pv, pt_ = (x.cpu().numpy() for x in (kv, kt, pv, pt_))
    np.testing.assert_array_equal(kv, pv)
    for lane in range(kv.shape[1]):
        floor = pv[:, lane].min()
        a = sorted(zip(kv[kv[:, lane] > floor, lane].tolist(),
                       kt[kv[:, lane] > floor, lane].tolist()))
        b = sorted(zip(pv[pv[:, lane] > floor, lane].tolist(),
                       pt_[pv[:, lane] > floor, lane].tolist()))
        assert a == b, f"lane {lane}"


def _pools_equal(kv, kt, pv, pt_):
    """``_lanes_equal`` for each (lane_k, 128) pool of (..., lane_k, 128)
    buffers (queries, partitions)."""
    assert kv.shape == pv.shape
    shape = (-1, *kv.shape[-2:])
    for args in zip(*(x.reshape(shape) for x in (kv, kt, pv, pt_))):
        _lanes_equal(*args)


@pytest.mark.parametrize("fbs,fold,lane_k", [(1024, 8, 8), (1024, 1, 8),
                                             (64, 8, 8), (1024, 8, 16),
                                             (1024, 8, 4)])
def test_octet_kernel_matches_plain(gpu, corpus, fbs, fold, lane_k):
    coo, qs = corpus
    cfg = pt.TopKSpMVConfig(**dict(HEADLINE, fused_block_sublanes=fbs,
                                   fold_tile=fold, lane_k=lane_k,
                                   tie_safe_topk=True))
    eng = pt.TopKSpMV(coo, cfg, device=gpu)
    table, _ = eng._table(qs[0])
    args = (eng.words, table, eng.nreal, eng.plan_rows)
    before = pkernel.topk_spmv_fused_octet_device.launches
    kv, kt = pkernel.topk_spmv_fused_octet_device(
        *args, cfg=cfg, block_sublanes=fbs)
    assert pkernel.topk_spmv_fused_octet_device.launches == before + 1
    pv, pt_ = pkernel.octet_topk_plain(
        *args, lane_k=lane_k, fold_tile=fold, tie_safe=True,
        block_sublanes=fbs)
    torch.cuda.synchronize()
    _lanes_equal(kv, kt, pv, pt_)


def _emulate_production(eng, table, cfg, nblk):
    """Merged production (non-tie-safe) buffers of a sweep of nblk CUDA
    blocks (slots) that grid-stride over the octets: block b harvests
    octets b, b + nblk, ... in turn into its buffers, where every slot
    holding the minimum is replaced, from distinct sentinels."""
    gpu = eng.words.device
    K, L, S = cfg.lane_k, 128, 8
    init = torch.from_numpy(pkernel.topk_init(K)).to(gpu).view(1, K, 1)
    miota = torch.arange(S, device=gpu).view(1, S, 1)
    # each octet's harvest steps in global octet order: (n_oct, steps, 1, L)
    scores, tags = [], []
    for b, row in enumerate(eng.plan_rows.tolist()):
        G, base = row[3], row[4]
        t = pkernel._octet_tiles(eng.words, row, cfg.fused_block_sublanes, S)
        sc = pkernel.prod_h16(t, table.reshape(-1)).sum(dim=1).float()
        member = torch.arange(G, device=gpu).view(-1, 1, 1) + miota * G
        sc = torch.where(member < int(eng.nreal[b, 0]), sc, float("-inf"))
        steps = []
        if cfg.fold_tile == 1:
            steps = [(sc[:, m:m + 1], member[:, m:m + 1] + base)
                     for m in range(S)]
        else:
            for _ in range(3):
                m1 = sc.amax(dim=1, keepdim=True)
                sl = torch.where(sc == m1, miota, S).amin(dim=1, keepdim=True)
                steps.append((m1, base + member[:, :1] + sl * G))
                sc = torch.where(miota == sl, float("-inf"), sc)
        scores.append(torch.stack([v for v, _ in steps], dim=1))
        tags.append(torch.stack([g.int().expand_as(v) for v, g in steps],
                                dim=1))
    scores, tags = torch.cat(scores), torch.cat(tags)
    # blocks left without an octet hand in their initial buffers
    tv = init.expand(nblk, K, L).clone()
    tt = torch.zeros((nblk, K, L), dtype=torch.int32, device=gpu)
    for g0 in range(0, scores.shape[0], nblk):
        n = min(nblk, scores.shape[0] - g0)
        v, t = tv[:n], tt[:n]
        for step in range(scores.shape[1]):
            score, tag = scores[g0:g0 + n, step], tags[g0:g0 + n, step]
            cur = v.amin(dim=1, keepdim=True)
            rep = (v == cur) & (score >= cur)
            v = torch.where(rep, score, v)
            t = torch.where(rep, tag.expand_as(t), t)
        tv[:n], tt[:n] = v, t
    return pkernel.merge_lane_topk(tv, tt, K)


@pytest.mark.parametrize("fold", [8, 1])
def test_octet_kernel_non_tie_safe(gpu, corpus, fold):
    """The production buffers (tie_safe_topk=False: every slot holding the
    minimum is replaced, from distinct sentinels). This corpus has fewer
    octets than the kernel has slots (``octet_topk_grid``), so each slot
    harvests at most one octet into fresh buffers: emulate that per octet,
    then merge."""
    coo, qs = corpus
    cfg = pt.TopKSpMVConfig(**dict(HEADLINE, fold_tile=fold))
    assert not cfg.tie_safe_topk
    eng = pt.TopKSpMV(coo, cfg, device=gpu)
    _, nblk = pkernel.octet_topk_grid(gpu, cfg, eng.words.shape[0])
    table, _ = eng._table(qs[1])
    kv, kt = pkernel.topk_spmv_fused_octet_device(
        eng.words, table, eng.nreal, eng.plan_rows, cfg=cfg,
        block_sublanes=cfg.fused_block_sublanes)
    ev, et = _emulate_production(eng, table, cfg, nblk)
    torch.cuda.synchronize()
    _lanes_equal(kv, kt, ev, et)


# K1 (csrc/octet_topk.cuh): one launch, its lane merge on the card;
# octet_topk_slots_plain on octet_topk_grid's slots computes what it gives.
# (lane_k, fold_tile, fused block sublanes); 64 makes wide octets
K1_GEOMS = [(8, 8, 1024), (4, 1, 1024), (16, 8, 64)]


def _k1_slots_plain(eng, cfg, table, merged=True):
    P = cfg.num_partitions
    _, slots = pkernel.octet_topk_grid(eng.words.device, cfg,
                                       eng.words.shape[0] // P, P)
    return pkernel.octet_topk_slots_plain(
        eng.words, table, eng.nreal, eng.plan_rows, num_slots=slots,
        lane_k=cfg.lane_k, fold_tile=cfg.fold_tile,
        tie_safe=bool(cfg.tie_safe_topk),
        block_sublanes=cfg.fused_block_sublanes, codec=cfg.query_codec,
        merged=merged, **eng.partition_kw)


def _k1_check(eng, cfg, table):
    """K1 against its slot plain, merged (one launch) and unmerged, bit
    for bit, tags included; tie-safe, its values those of
    ``octet_topk_plain`` too."""
    args = (eng.words, table, eng.nreal, eng.plan_rows)
    bs = cfg.fused_block_sublanes
    before = pkernel.topk_spmv_fused_octet_device.launches
    kv, kt = pkernel.topk_spmv_fused_octet_device(
        *args, cfg=cfg, block_sublanes=bs, **eng.partition_kw)
    assert pkernel.topk_spmv_fused_octet_device.launches == before + 1
    pv, pt_ = _k1_slots_plain(eng, cfg, table)
    torch.cuda.synchronize()
    P = cfg.num_partitions
    assert kv.shape == (*((P,) if P > 1 else ()), cfg.lane_k, 128)
    assert torch.equal(kv, pv) and torch.equal(kt, pt_)
    uv, ut = pkernel._octet_topk_cuda(
        *args, P, eng.partition_kw.get("part_slices", 0), cfg, bs,
        unmerged=True)
    sv, st = _k1_slots_plain(eng, cfg, table, merged=False)
    torch.cuda.synchronize()
    assert torch.equal(uv, sv) and torch.equal(ut, st)
    if cfg.tie_safe_topk:
        _pools_equal(kv, kt, *pkernel.octet_topk_plain(
            *args, lane_k=cfg.lane_k, fold_tile=cfg.fold_tile, tie_safe=True,
            block_sublanes=bs, codec=cfg.query_codec, **eng.partition_kw))


@pytest.mark.parametrize("tie_safe", [False, True])
@pytest.mark.parametrize("P", [1, 3])
@pytest.mark.parametrize("lane_k,fold,fbs", K1_GEOMS,
                         ids=[f"k{k}_fold{f}_fbs{b}" for k, f, b in K1_GEOMS])
@pytest.mark.parametrize("codec", ["h16", "f32", "int8x4", "i8s", "i4s"])
def test_k1_matches_slots_plain(gpu, corpus, codec, lane_k, fold, fbs, P,
                                tie_safe):
    """K1 (K10b at P = 3) on production and tie-safe buffers, every codec,
    lane_k 4, 8 and 16, fold 1 and 8, wide octets."""
    cfg = pt.TopKSpMVConfig(**dict(
        HEADLINE, query_codec=codec, rescore_pool=None, lane_k=lane_k,
        fold_tile=fold, fused_block_sublanes=fbs, num_partitions=P,
        tie_safe_topk=tie_safe))
    eng = pt.TopKSpMV(corpus[0], cfg, device=gpu)
    if fbs == 64:
        assert any(p.blocks_per_octet > 1 for p in eng.fused.plan)
    table, _ = eng._table(corpus[1][0])
    _k1_check(eng, cfg, table)


@pytest.mark.parametrize("tie_safe", [False, True])
@pytest.mark.parametrize("cols", ["limit", "past_limit", "65536"])
def test_k1_f32_tables_at_and_past_shared_memory(gpu, cols, tie_safe):
    """f32 tables as wide as a CUDA block's shared memory holds (58,112
    columns on the H100: the merge's lists reuse the table's bytes, so it
    stays in shared memory) and past it (codec "f32_global"), on one
    partition and on two: K1 against its slot plain."""
    limit = torch.cuda.get_device_properties(gpu).shared_memory_per_block_optin
    ncols = {"limit": limit // 512 * 128,
             "past_limit": limit // 512 * 128 + 128, "65536": 65536}[cols]
    assert pkernel.tables_in_smem(4 * ncols, limit) == int(cols == "limit")
    coo = create_sparse_matrix(3000, ncols, 20, "gamma", seed=43)
    q = create_query_batch(1, ncols, seed=44)[0]
    for P in (1, 2):
        cfg = pt.TopKSpMVConfig(**dict(
            HEADLINE, query_codec="f32", max_cols=ncols, rescore_pool=None,
            tie_safe_topk=tie_safe, num_partitions=P))
        eng = pt.TopKSpMV(coo, cfg, device=gpu)
        table, _ = eng._table(q)
        _k1_check(eng, cfg, table)


def test_k1_back_to_back_launches(gpu, corpus):
    """20 launches back to back on one stream (each merge's tickets left
    0 for the next) equal the launches run alone."""
    cfg = pt.TopKSpMVConfig(**dict(HEADLINE, rescore_pool=None))
    eng = pt.TopKSpMV(corpus[0], cfg, device=gpu)
    qs = create_query_batch(20, 1024, seed=45)
    alone = []
    for q in qs:
        alone.append(eng.candidates(q))
        torch.cuda.synchronize()
    chained = [eng.candidates(q) for q in qs]
    torch.cuda.synchronize()
    for (av, at), (cv, ct) in zip(alone, chained):
        assert torch.equal(av, cv) and torch.equal(at, ct)


@pytest.mark.parametrize("fbs,fold,lane_k", [(1024, 8, 8), (1024, 1, 8),
                                             (64, 8, 8), (1024, 8, 16),
                                             (1024, 8, 4)])
@pytest.mark.parametrize("Q,subgroup", [(1, 0), (5, 2), (32, 0)])
def test_batch_kernel_matches_plain(gpu, corpus, fbs, fold, lane_k, Q,
                                    subgroup):
    """K6 with tie-safe buffers against its plain version, per query; Q=5
    in subgroups of 2 leaves an uneven last subgroup."""
    coo, _ = corpus
    cfg = pt.TopKSpMVConfig(**dict(HEADLINE, fused_block_sublanes=fbs,
                                   fold_tile=fold, lane_k=lane_k,
                                   tie_safe_topk=True,
                                   batch_subgroup=subgroup))
    eng = pt.TopKSpMV(coo, cfg, device=gpu)
    tables = _tables(create_query_batch(Q, 1024, seed=23), gpu)
    args = (eng.words, tables, eng.nreal, eng.plan_rows)
    before = pkernel.topk_spmv_fused_batch_octet_device.launches
    kv, kt = pkernel.topk_spmv_fused_batch_octet_device(
        *args, cfg=cfg, block_sublanes=fbs)
    assert pkernel.topk_spmv_fused_batch_octet_device.launches == before + 1
    pv, pt_ = pkernel.octet_topk_batch_plain(
        *args, lane_k=lane_k, fold_tile=fold, tie_safe=True,
        block_sublanes=fbs)
    torch.cuda.synchronize()
    assert kv.shape == (Q, lane_k, 128)
    for q in range(Q):
        _lanes_equal(kv[q], kt[q], pv[q], pt_[q])


@pytest.mark.parametrize("subgroup", [1, 3, 8])
def test_batch_kernel_ignores_subgroup(gpu, corpus, subgroup):
    """Every subgroup size (each rounds up to a kernel instantiation of 1,
    2, 4 or 8 live queries) gives each query its single-query candidates."""
    coo, _ = corpus
    cfg = pt.TopKSpMVConfig(**dict(HEADLINE, tie_safe_topk=True,
                                   batch_subgroup=subgroup))
    eng = pt.TopKSpMV(coo, cfg, device=gpu)
    qs = create_query_batch(7, 1024, seed=24)
    kv, kt = eng.batch_candidates(_tables(qs, gpu))
    for q in range(7):
        sv, st = eng.candidates(qs[q])
        _lanes_equal(kv[q], kt[q], sv, st)


@pytest.mark.parametrize("fold", [8, 1])
def test_batch_kernel_non_tie_safe(gpu, corpus, fold):
    """K6's production buffers against the emulation of its grid (h16:
    ``octet_h16_grid``'s slots, each harvesting its octets in turn)."""
    coo, _ = corpus
    cfg = pt.TopKSpMVConfig(**dict(HEADLINE, fold_tile=fold))
    assert not cfg.tie_safe_topk
    eng = pt.TopKSpMV(coo, cfg, device=gpu)
    qs = create_query_batch(6, 1024, seed=25)
    tables = _tables(qs, gpu)
    sms = torch.cuda.get_device_properties(gpu).multi_processor_count
    _, slots = pkernel.octet_h16_grid(6, sms, lane_k=cfg.lane_k)
    kv, kt = eng.batch_candidates(tables)
    for q in range(6):
        ev, et = _emulate_production(eng, tables[q], cfg, slots)
        _lanes_equal(kv[q], kt[q], ev, et)


# K6 h16 (csrc/octet_topk_batch_h16.cu): (lane_k, fold_tile, fused block
# sublanes); 64 makes wide octets
H16_GEOMS = [(8, 8, 1024), (4, 1, 1024), (16, 8, 64)]


def _h16_batch_check(gpu, coo, Q, seed, **kw):
    """K6 h16 with tie-safe buffers against octet_topk_batch_plain on Q
    queries: one launch, every pool's sorted values bit-equal and its
    (value, tag) pairs equal above each lane's floor."""
    cfg = pt.TopKSpMVConfig(**dict(HEADLINE, tie_safe_topk=True, **kw))
    eng = pt.TopKSpMV(coo, cfg, device=gpu)
    tables = _tables(create_query_batch(Q, 1024, seed=seed), gpu)
    args = (eng.words, tables, eng.nreal, eng.plan_rows)
    bs = cfg.fused_block_sublanes
    before = pkernel.topk_spmv_fused_batch_octet_device.launches
    kv, kt = pkernel.topk_spmv_fused_batch_octet_device(
        *args, cfg=cfg, block_sublanes=bs, **eng.partition_kw)
    assert pkernel.topk_spmv_fused_batch_octet_device.launches == before + 1
    pv, pt_ = pkernel.octet_topk_batch_plain(
        *args, lane_k=cfg.lane_k, fold_tile=cfg.fold_tile, tie_safe=True,
        block_sublanes=bs, **eng.partition_kw)
    torch.cuda.synchronize()
    P = cfg.num_partitions
    assert kv.shape == (Q, *((P,) if P > 1 else ()), cfg.lane_k, 128)
    _pools_equal(kv, kt, pv, pt_)


@pytest.mark.parametrize("lane_k,fold,fbs", H16_GEOMS,
                         ids=[f"k{k}_fold{f}_fbs{b}" for k, f, b in H16_GEOMS])
@pytest.mark.parametrize("Q", [1, 7, 32, 33, 64])
def test_h16_batch_passes_match_plain(gpu, corpus, lane_k, fold, fbs, Q):
    """K6 h16 reads the stream once per pass of up to 32 queries: 1 and 7
    queries in a pass of 8, 32 in one of 32, 33 and 64 in two passes."""
    _h16_batch_check(gpu, corpus[0], Q, 26, lane_k=lane_k, fold_tile=fold,
                     fused_block_sublanes=fbs)


@pytest.mark.parametrize("P", [2, 3])
@pytest.mark.parametrize("Q,lane_k,fold", [(7, 8, 8), (33, 16, 1),
                                           (64, 4, 8)])
def test_h16_batch_partitions_match_plain(gpu, corpus, P, Q, lane_k, fold):
    """K10d h16: a pool per partition, the partition the grid's y index."""
    _h16_batch_check(gpu, corpus[0], Q, 27, lane_k=lane_k, fold_tile=fold,
                     num_partitions=P)


def _h16_engine(gpu, coo, **kw):
    cfg = pt.TopKSpMVConfig(**dict(HEADLINE, **kw))
    return pt.TopKSpMV(coo, cfg, device=gpu), cfg


def _h16_slots_plain(eng, cfg, tables, merged=True):
    sms = torch.cuda.get_device_properties(eng.words.device) \
        .multi_processor_count
    _, slots = pkernel.octet_h16_grid(tables.shape[0], sms,
                                      cfg.num_partitions, cfg.lane_k)
    return pkernel.octet_topk_batch_slots_plain(
        eng.words, tables, eng.nreal, eng.plan_rows, num_slots=slots,
        lane_k=cfg.lane_k, fold_tile=cfg.fold_tile,
        tie_safe=bool(cfg.tie_safe_topk),
        block_sublanes=cfg.fused_block_sublanes, codec="h16", merged=merged,
        **eng.partition_kw)


H16_SLOT_CASES = [(7, dict()), (33, dict(fold_tile=1)),
                  (32, dict(fused_block_sublanes=64, lane_k=16)),
                  (7, dict(num_partitions=2)),
                  (33, dict(num_partitions=3, lane_k=4))]


@pytest.mark.parametrize("tie_safe", [False, True])
@pytest.mark.parametrize("Q,kw", H16_SLOT_CASES,
                         ids=[f"q{q}_" + "_".join(f"{k}{v}" for k, v in
                                                  kw.items())
                              for q, kw in H16_SLOT_CASES])
def test_h16_batch_matches_slots_plain(gpu, corpus, Q, kw, tie_safe):
    """K6 h16 merged on the card against its slot plain
    (``octet_topk_batch_slots_plain`` on the kernel's grid): values and
    tags bit for bit, ties included, the production buffers too; and the
    unmerged launch's sorted slot buffers the same."""
    eng, cfg = _h16_engine(gpu, corpus[0], tie_safe_topk=tie_safe, **kw)
    tables = _tables(create_query_batch(Q, 1024, seed=28), gpu)
    kv, kt = eng.batch_candidates(tables)
    pv, pt_ = _h16_slots_plain(eng, cfg, tables)
    torch.cuda.synchronize()
    assert torch.equal(kv, pv) and torch.equal(kt, pt_)
    uv, ut = pkernel.octet_topk_batch_cuda(
        eng.words, tables, eng.nreal, eng.plan_rows, cfg.num_partitions,
        eng.partition_kw.get("part_slices", 0), cfg,
        **pkernel._sweep_kw(cfg, cfg.fused_block_sublanes), unmerged=True)
    sv, st = _h16_slots_plain(eng, cfg, tables, merged=False)
    torch.cuda.synchronize()
    assert torch.equal(uv, sv) and torch.equal(ut, st)


def test_h16_batch_back_to_back_launches(gpu, corpus):
    """20 launches back to back on one stream (each merge's tickets left
    0 for the next) equal the launches run alone."""
    eng, cfg = _h16_engine(gpu, corpus[0])
    groups = [_tables(create_query_batch(32, 1024, seed=100 + i), gpu)
              for i in range(20)]
    alone = []
    for tables in groups:
        alone.append(eng.batch_candidates(tables))
        torch.cuda.synchronize()
    chained = [eng.batch_candidates(tables) for tables in groups]
    torch.cuda.synchronize()
    for (av, at), (cv, ct) in zip(alone, chained):
        assert torch.equal(av, cv) and torch.equal(at, ct)


# K6 for the other codecs (csrc/octet_topk_batch.cuh): its queries' passes
# (8 or 16), lane_k, fold, wide octets of 8- and 3-chunk spans, partitions
K6_CODEC_CASES = [(7, dict()), (33, dict(fold_tile=1)),
                  (32, dict(fused_block_sublanes=64, lane_k=16)),
                  (17, dict(fused_block_sublanes=24, lane_k=4)),
                  (7, dict(num_partitions=2)),
                  (33, dict(num_partitions=3, lane_k=4))]


@pytest.mark.parametrize("tie_safe", [False, True])
@pytest.mark.parametrize("Q,kw", K6_CODEC_CASES,
                         ids=[f"q{q}_" + "_".join(f"{k}{v}" for k, v in
                                                  kw.items())
                              for q, kw in K6_CODEC_CASES])
@pytest.mark.parametrize("codec", ["f32", "int8x4", "i8s", "i4s"])
def test_k6_codec_batch_matches_slots_plain(gpu, corpus, codec, Q, kw,
                                            tie_safe):
    """K6 of each codec but h16 merged on the card against its slot plain
    (``octet_topk_batch_slots_plain`` on ``k6_launch``'s grid): values and
    tags bit for bit, ties included, the production buffers too; and the
    unmerged launch's sorted slot buffers the same."""
    eng, cfg = _h16_engine(gpu, corpus[0], query_codec=codec,
                           rescore_pool=None, tie_safe_topk=tie_safe, **kw)
    tables = _slice_tables(cfg, create_query_batch(Q, 1024, seed=28), gpu)
    kv, kt = eng.batch_candidates(tables)
    *_, slots = pkernel.k6_launch(eng.words.device, cfg, Q,
                                  cfg.num_partitions)
    plain = dict(num_slots=slots, lane_k=cfg.lane_k, fold_tile=cfg.fold_tile,
                 tie_safe=tie_safe, block_sublanes=cfg.fused_block_sublanes,
                 codec=codec, **eng.partition_kw)
    args = (eng.words, tables, eng.nreal, eng.plan_rows)
    pv, pt_ = pkernel.octet_topk_batch_slots_plain(*args, **plain)
    torch.cuda.synchronize()
    assert torch.equal(kv, pv) and torch.equal(kt, pt_)
    uv, ut = pkernel.octet_topk_batch_cuda(
        *args, cfg.num_partitions, eng.partition_kw.get("part_slices", 0),
        cfg, **pkernel._sweep_kw(cfg, cfg.fused_block_sublanes),
        unmerged=True)
    sv, st = pkernel.octet_topk_batch_slots_plain(*args, merged=False,
                                                  **plain)
    torch.cuda.synchronize()
    assert torch.equal(uv, sv) and torch.equal(ut, st)


@pytest.mark.parametrize("P", [1, 2])
@pytest.mark.parametrize("codec", ["h16", "f32", "int8x4", "i8s", "i4s"])
def test_k6_merges_on_the_card(gpu, corpus, codec, P, monkeypatch):
    """K6 (K10d) of every codec returns its merged pairs from its one
    launch: with ``torch.topk`` and ``merge_lane_topk`` made to raise, the
    wrapper still gives the slot plain's pairs, and its counter counts
    one launch."""
    eng, cfg = _h16_engine(gpu, corpus[0], query_codec=codec,
                           num_partitions=P)
    tables = _slice_tables(cfg, create_query_batch(20, 1024, seed=29), gpu)
    args = (eng.words, tables, eng.nreal, eng.plan_rows)
    *_, slots = pkernel.k6_launch(eng.words.device, cfg, 20, P)
    pv, pt_ = pkernel.octet_topk_batch_slots_plain(
        *args, num_slots=slots, lane_k=cfg.lane_k, fold_tile=cfg.fold_tile,
        tie_safe=bool(cfg.tie_safe_topk),
        block_sublanes=cfg.fused_block_sublanes, codec=codec,
        **eng.partition_kw)

    def refuse(*a, **k):
        raise AssertionError("a torch merge ran on K6's path")

    monkeypatch.setattr(torch, "topk", refuse)
    monkeypatch.setattr(pkernel, "merge_lane_topk", refuse)
    before = pkernel.topk_spmv_fused_batch_octet_device.launches
    kv, kt = pkernel.topk_spmv_fused_batch_octet_device(
        *args, cfg=cfg, block_sublanes=cfg.fused_block_sublanes,
        **eng.partition_kw)
    torch.cuda.synchronize()
    monkeypatch.undo()
    assert pkernel.topk_spmv_fused_batch_octet_device.launches == before + 1
    assert torch.equal(kv, pv) and torch.equal(kt, pt_)


@pytest.mark.parametrize("codec", ["f32", "i4s"])
def test_k6_codec_batch_back_to_back_launches(gpu, corpus, codec):
    """20 launches of K6 back to back on one stream (each merge's tickets
    left 0 for the next) equal the launches run alone."""
    eng, cfg = _h16_engine(gpu, corpus[0], query_codec=codec)
    groups = [_slice_tables(cfg, create_query_batch(32, 1024, seed=100 + i),
                            gpu) for i in range(20)]
    alone = []
    for tables in groups:
        alone.append(eng.batch_candidates(tables))
        torch.cuda.synchronize()
    chained = [eng.batch_candidates(tables) for tables in groups]
    torch.cuda.synchronize()
    for (av, at), (cv, ct) in zip(alone, chained):
        assert torch.equal(av, cv) and torch.equal(at, ct)


@pytest.mark.parametrize("nibble", [-8, 7])
def test_h16_batch_extreme_values(gpu, corpus, nibble):
    """The packed sums at their extremes: every value of the stream -32
    and every query nibble -8 (the largest product, 256) or 7 (the
    largest biased operands of the packed dp2a), on the corpus with one
    row of all 1024 columns added (its octet the widest the packer makes
    here), wide octets too: K6 h16 bit-equal to the plain int32 sums."""
    from spmv_topk_tpu_torch.formats import CooMatrix

    coo = corpus[0]
    n = coo.num_rows
    rows = np.concatenate([coo.rows, np.full(1024, n, coo.rows.dtype)])
    cols = np.concatenate([coo.cols, np.arange(1024, dtype=coo.cols.dtype)])
    vals = np.concatenate([coo.vals, np.ones(1024, coo.vals.dtype)])
    wide = CooMatrix(rows, cols, vals, n + 1, coo.num_cols)
    word = np.array([(nibble & 0xF) * 0x11111111], np.uint32).view(np.int32)
    table = torch.full((33, 1, 128), int(word[0]), dtype=torch.int32,
                       device=gpu)
    for fbs in (1024, 64):
        cfg = pt.TopKSpMVConfig(**dict(HEADLINE, tie_safe_topk=True,
                                       fused_block_sublanes=fbs))
        eng = pt.TopKSpMV(wide, cfg, device=gpu)
        w = eng.words
        # each half col[0:10) | val6[10:16): a nonzero half gets value -32
        lo, hi = w & 0xFFFF, (w >> 16) & 0xFFFF
        lo = torch.where(lo != 0, (lo & 0x3FF) | 0x8000, 0)
        hi = torch.where(hi != 0, (hi & 0x3FF) | 0x8000, 0)
        words = (lo | (hi << 16)).contiguous()
        args = (words, table, eng.nreal, eng.plan_rows)
        kv, kt = pkernel.topk_spmv_fused_batch_octet_device(
            *args, cfg=cfg, block_sublanes=fbs)
        pv, pt_ = pkernel.octet_topk_batch_plain(
            *args, lane_k=cfg.lane_k, fold_tile=cfg.fold_tile,
            tie_safe=True, block_sublanes=fbs)
        torch.cuda.synchronize()
        if nibble == -8:   # the added row: 1024 products of -32 * -8
            assert float(pv.max()) == 1024 * 256
        _pools_equal(kv, kt, pv, pt_)


@pytest.mark.parametrize("fbs,wq", [(1024, 2), (64, 2), (64, 1)])
def test_scores_kernel_matches_plain(gpu, corpus, fbs, wq):
    coo, qs = corpus
    cfg = pt.TopKSpMVConfig(**dict(HEADLINE, fused_block_sublanes=fbs,
                                   width_quantum=wq))
    eng = pt.TopKSpMV(coo, cfg, device=gpu)
    if fbs == 64:
        assert any(p.blocks_per_octet > 1 for p in eng.fused.plan)
    table, _ = eng._table(qs[0])
    args = (eng.words, table, eng.nreal, eng.plan_rows)
    n = eng.row_ids.shape[0]
    before = pkernel.spmv_fused_scores_octet_device.launches
    got = pkernel.spmv_fused_scores_octet_device(
        *args, cfg=cfg, block_sublanes=fbs, num_slices=n)
    assert pkernel.spmv_fused_scores_octet_device.launches == before + 1
    want = pkernel.octet_scores_plain(*args, num_slices=n,
                                      block_sublanes=fbs)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_stream_kernel_matches_plain(gpu, corpus):
    coo, _ = corpus
    eng = pt.TopKSpMV(coo, pt.TopKSpMVConfig(**HEADLINE), device=gpu)
    salt = torch.arange(128, dtype=torch.int32, device=gpu).reshape(1, 128)
    got = pstream.stream_words_device(eng.words, salt)
    want = pstream.stream_words_plain(eng.words, salt)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("chunks", [1, 3, 1055, 1057, 109_696])
def test_stream_kernel_chunk_counts(gpu, chunks):
    """K3 on 1, 3, one under and one over two blocks an SM's worth of
    chunks (132 SMs) and the headline corpus's 109,696, words near the
    int32 limits (the sums wrap) and a salt that varies by lane and call:
    its plain version's checksum, one launch a call."""
    rng = np.random.default_rng(chunks)
    words = torch.from_numpy(rng.choice(
        np.array([2**31 - 1, -2**31, 2**31 - 2, -2**31 + 1, 7, -3],
                 np.int32), (chunks * 8, 128))).to(gpu)
    for call in range(3):
        salt = torch.from_numpy(rng.integers(-2**31, 2**31, (1, 128)).astype(
            np.int32)).to(gpu)
        before = pstream.stream_words_device.launches
        got = pstream.stream_words_device(words, salt)
        assert pstream.stream_words_device.launches == before + 1
        torch.cuda.synchronize()
        assert torch.equal(got, pstream.stream_words_plain(words, salt)), call


def test_query_on_gpu_matches_cpu(gpu, corpus):
    """The rescored top-100 on the card equals the plain path's on the
    CPU (both re-rank their pools exactly on the host)."""
    coo, qs = corpus
    cfg = pt.TopKSpMVConfig(**HEADLINE)
    on_gpu = pt.TopKSpMV(coo, cfg, device=gpu)
    on_cpu = pt.TopKSpMV(coo, cfg, device="cpu")
    for q in qs:
        gi, gv = on_gpu.query(q)
        ci, cv = on_cpu.query(q)
        assert gi.device.type == "cuda"
        np.testing.assert_array_equal(gi.cpu().numpy(), ci.numpy())
        np.testing.assert_array_equal(gv.cpu().numpy(), cv.numpy())


def test_query_batch_and_scores_on_gpu_match_cpu(gpu, corpus):
    """query_batch (rescored and not) and scores() on the card equal the
    plain path's on the CPU, through K6 and K4."""
    coo, qs = corpus
    cfg = pt.TopKSpMVConfig(**HEADLINE)
    on_gpu = pt.TopKSpMV(coo, cfg, device=gpu)
    on_cpu = pt.TopKSpMV(coo, cfg, device="cpu")
    batch = create_query_batch(5, 1024, seed=26)
    k6 = pkernel.topk_spmv_fused_batch_octet_device.launches
    k4 = pkernel.spmv_fused_scores_octet_device.launches
    gi, gv = on_gpu.query_batch(batch, group_size=2)
    assert gi.device.type == "cuda"
    ci, cv = on_cpu.query_batch(batch, group_size=2)
    np.testing.assert_array_equal(gi.cpu().numpy(), ci.numpy())
    np.testing.assert_array_equal(gv.cpu().numpy(), cv.numpy())
    assert pkernel.topk_spmv_fused_batch_octet_device.launches == k6 + 3
    gs = on_gpu.scores(qs[0])
    assert gs.device.type == "cuda"
    np.testing.assert_array_equal(gs.cpu().numpy(),
                                  on_cpu.scores(qs[0]).numpy())
    assert pkernel.spmv_fused_scores_octet_device.launches == k4 + 1


# ---------------------------------------------------------------- slice stream
# K7 (single-query sweep), K8 (multi-query sweep) and K9 (SpMV) of the
# slice layout. h16 as above; f32 on integer-valued data (values and
# queries in [-8, 8], exact in bf16, every partial sum an exact f32) and
# on real data: the plain versions add a slice's products in row order,
# each rounded, as the kernels do, so f32 is bit-equal either way.

SLICE_BENCH = dict(k=100, lane_k=8, max_cols=1024, query_codec="h16",
                   fused_layout="slice", width_quantum=2, fold_tile=8,
                   rescore_pool=400, block_sublanes=512,
                   fused_block_sublanes=1024)
SLICE_DEFAULT = dict(k=100)
# (name, config, integer-valued data)
SLICE_CASES = [
    ("h16_fold8", dict(SLICE_BENCH), False),
    ("h16_fold1", dict(SLICE_BENCH, fold_tile=1), False),
    ("f32_fold1", dict(SLICE_DEFAULT), True),
    ("f32_fold8", dict(SLICE_DEFAULT, fold_tile=8), True),
    ("f32_fold1_real", dict(SLICE_DEFAULT), False),
    ("h16_wide", dict(SLICE_BENCH, fused_block_sublanes=32), False),
    ("f32_wide", dict(SLICE_DEFAULT, fused_block_sublanes=32), True),
    ("h16_unroll", dict(SLICE_BENCH, fused_block_sublanes=2048), False),
]


@pytest.fixture(scope="module")
def int_corpus(corpus):
    coo, _ = corpus
    rng = np.random.default_rng(27)
    vals = rng.integers(-8, 9, coo.nnz).astype(np.float32)
    qs = rng.integers(-8, 9, (33, 1024)).astype(np.float32)
    return pt.CooMatrix(coo.rows, coo.cols, vals, coo.num_rows,
                        coo.num_cols), qs


def _slice_engine(gpu, corpus, int_corpus, kw, integer, **extra):
    coo = int_corpus[0] if integer else corpus[0]
    cfg = pt.TopKSpMVConfig(**dict(kw, **extra))
    return pt.TopKSpMV(coo, cfg, device=gpu), cfg


def _slice_queries(int_corpus, integer, n, seed):
    return int_corpus[1][:n] if integer else create_query_batch(n, 1024,
                                                                seed=seed)


def _slice_tables(cfg, qs, dev):
    tabs, _ = pack_query_tables(qs, cfg.query_codec)
    return torch.from_numpy(tabs).to(dev)


def _plain_kw(cfg, tie_safe):
    return dict(lane_k=cfg.lane_k, tie_safe=tie_safe,
                block_sublanes=cfg.fused_block_sublanes,
                codec=cfg.query_codec)


def _k8_slots_equal(eng, tables, cfg):
    """The engine's batch sweep with production buffers
    (tie_safe_topk=False) on the tables' queries against its slot plain
    on its grid, bit for bit, tags included: K8 (K10c) against
    ``slice_topk_batch_slots_plain`` on ``k8_launch``'s slots on the slice
    layout, K6 (K10d) against ``octet_topk_batch_slots_plain`` on
    ``k6_launch``'s on the octet layout; its unmerged launch's slots,
    merged by ``lane_merge_plain``, give the pairs its merge on the card
    gave."""
    prod = dataclasses.replace(cfg, tie_safe_topk=False)
    P = cfg.num_partitions
    bs = cfg.fused_block_sublanes
    args = (eng.words, tables, eng.nreal, eng.plan_rows)
    ps = eng.partition_kw.get("part_slices", 0)
    if cfg.fused_layout == "octet":
        kv, kt = pkernel.topk_spmv_fused_batch_octet_device(
            *args, cfg=prod, block_sublanes=bs, **eng.partition_kw)
        *_, slots = pkernel.k6_launch(eng.words.device, prod,
                                      tables.shape[0], P)
        pv, pt_ = pkernel.octet_topk_batch_slots_plain(
            *args, num_slots=slots, fold_tile=cfg.fold_tile,
            **_plain_kw(prod, False), **eng.partition_kw)
        uv, ut = pkernel.octet_topk_batch_cuda(
            *args, P, ps, prod, **pkernel._sweep_kw(prod, bs), unmerged=True)
    else:
        kv, kt = pkernel.topk_spmv_fused_batch_device(*args, cfg=prod,
                                                      block_sublanes=bs,
                                                      **eng.partition_kw)
        *_, slots = pkernel.k8_launch(eng.words.device, prod,
                                      tables.shape[0], P)
        pv, pt_ = pkernel.slice_topk_batch_slots_plain(
            *args, num_slots=slots, **_plain_kw(prod, False),
            **eng.partition_kw)
        uv, ut = pkernel._slice_topk_batch_cuda(*args, P, ps, prod, bs,
                                                unmerged=True)
    torch.cuda.synchronize()
    assert torch.equal(kv, pv) and torch.equal(kt, pt_)
    merged = [pkernel.lane_merge_plain(v, t, cfg.lane_k)
              for v, t in zip(uv.flatten(0, 1), ut.flatten(0, 1))]
    assert torch.equal(torch.stack([v for v, _ in merged]).view(kv.shape),
                       kv)
    assert torch.equal(torch.stack([t for _, t in merged]).view(kt.shape),
                       kt)


@pytest.mark.parametrize("lane_k", [8, 16, 4])
@pytest.mark.parametrize("name,kw,integer", SLICE_CASES,
                         ids=[c[0] for c in SLICE_CASES])
def test_slice_kernel_matches_plain(gpu, corpus, int_corpus, name, kw,
                                    integer, lane_k):
    eng, cfg = _slice_engine(gpu, corpus, int_corpus, kw, integer,
                             lane_k=lane_k, tie_safe_topk=True)
    modes = {pkernel.slice_work(r, cfg.fold_tile)[0]
             for r in eng.plan_rows.tolist()}
    if "wide" in name:
        assert pkernel.WIDE in modes
    if name == "h16_unroll":
        assert modes == {pkernel.RUNS}
    table, _ = eng._table(_slice_queries(int_corpus, integer, 1, 22)[0])
    args = (eng.words, table, eng.nreal, eng.plan_rows)
    before = pkernel.topk_spmv_fused_device.launches
    kv, kt = pkernel.topk_spmv_fused_device(
        *args, cfg=cfg, block_sublanes=cfg.fused_block_sublanes)
    assert pkernel.topk_spmv_fused_device.launches == before + 1
    pv, pt_ = pkernel.slice_topk_plain(*args, fold_tile=cfg.fold_tile,
                                       **_plain_kw(cfg, True))
    torch.cuda.synchronize()
    _lanes_equal(kv, kt, pv, pt_)


@pytest.mark.parametrize("Q,subgroup", [(1, 0), (5, 2), (32, 0), (33, 0)])
@pytest.mark.parametrize("name,kw,integer,lane_k", [
    ("h16_fold8", SLICE_BENCH, False, 8),
    ("f32_fold1", SLICE_DEFAULT, True, 8),
    ("h16_wide", dict(SLICE_BENCH, fused_block_sublanes=32), False, 16),
    ("f32_wide", dict(SLICE_DEFAULT, fused_block_sublanes=32), True, 4),
    ("f32_wide_real", dict(SLICE_DEFAULT, fused_block_sublanes=32), False,
     8)],
    ids=["h16_fold8", "f32_fold1", "h16_wide_k16", "f32_wide_k4",
         "f32_wide_real"])
def test_slice_batch_kernel_matches_plain(gpu, corpus, int_corpus, name, kw,
                                          integer, lane_k, Q, subgroup):
    """K8 with tie-safe buffers against its plain version, per query
    (subgroups shape nothing; 33 queries split into passes, the last of
    one query); with production buffers bit for bit against its slot
    plain, and its merge on the card against its unmerged slots."""
    eng, cfg = _slice_engine(gpu, corpus, int_corpus, kw, integer,
                             lane_k=lane_k, tie_safe_topk=True,
                             batch_subgroup=subgroup)
    tables = _slice_tables(cfg, _slice_queries(int_corpus, integer, Q, 23),
                           gpu)
    args = (eng.words, tables, eng.nreal, eng.plan_rows)
    before = pkernel.topk_spmv_fused_batch_device.launches
    kv, kt = pkernel.topk_spmv_fused_batch_device(
        *args, cfg=cfg, block_sublanes=cfg.fused_block_sublanes)
    assert pkernel.topk_spmv_fused_batch_device.launches == before + 1
    pv, pt_ = pkernel.slice_topk_batch_plain(*args,
                                             **_plain_kw(cfg, True))
    torch.cuda.synchronize()
    assert kv.shape == (Q, lane_k, 128)
    for q in range(Q):
        _lanes_equal(kv[q], kt[q], pv[q], pt_[q])
    _k8_slots_equal(eng, tables, cfg)


@pytest.mark.parametrize("integer", [False, True], ids=["h16", "f32"])
@pytest.mark.parametrize("subgroup", [1, 3, 8])
def test_slice_batch_kernel_ignores_subgroup(gpu, corpus, int_corpus,
                                             subgroup, integer):
    """Every subgroup size gives each query the candidates of K7 with
    every slice folded (fold_tile 1: K8 folds every slice); the production
    buffers do not depend on it either (K8's grid does not read it), bit
    for bit against the slot plain."""
    kw = SLICE_DEFAULT if integer else SLICE_BENCH
    eng, cfg = _slice_engine(gpu, corpus, int_corpus, kw, integer,
                             fold_tile=1, tie_safe_topk=True,
                             batch_subgroup=subgroup)
    qs = _slice_queries(int_corpus, integer, 7, 24)
    tables = _slice_tables(cfg, qs, gpu)
    kv, kt = eng.batch_candidates(tables)
    for q in range(7):
        sv, st = eng.candidates(qs[q])
        _lanes_equal(kv[q], kt[q], sv, st)
    _k8_slots_equal(eng, tables, cfg)
    bs = dict(block_sublanes=cfg.fused_block_sublanes)
    args = (eng.words, tables, eng.nreal, eng.plan_rows)
    prod = dataclasses.replace(cfg, tie_safe_topk=False)
    got = pkernel.topk_spmv_fused_batch_device(*args, cfg=prod, **bs)
    want = pkernel.topk_spmv_fused_batch_device(
        *args, cfg=dataclasses.replace(prod, batch_subgroup=0), **bs)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def _emulate_slice_production(eng, table, cfg, nblk, fold_tile, deal):
    """Merged production (non-tie-safe) buffers of a slice sweep whose
    nblk slots harvest the work items (ops/kernel.py::slice_work) dealt
    them (``deal``: the slot of each item, ``k7_deal``; K7's and K8's) in
    order: every slot holding the minimum is replaced, from distinct
    sentinels; a sub-tile gives its top 2, any other item each real slice
    in order."""
    gpu = eng.words.device
    K, L = cfg.lane_k, 128
    init = torch.from_numpy(pkernel.topk_init(K)).to(gpu).view(K, 1)
    bufs_v, bufs_t = [], []
    slot_of = iter(deal.tolist())
    dealt = {}   # slot -> its buffers
    for b, row in enumerate(eng.plan_rows.tolist()):
        W, spb, bps, base = row[:4]
        n = int(eng.nreal[b, 0])
        sc = pkernel._bucket_scores(eng.words, table, row, cfg.query_codec,
                                    cfg.fused_block_sublanes)
        mode, units, per, Gp, Ps, nper = pkernel.slice_work(row, fold_tile)
        for u in range(units):
            for gi in range(per):
                top2 = mode == pkernel.TILED and gi < Gp * Ps
                if mode == pkernel.WIDE:
                    members = [u]
                elif mode == pkernel.RUNS:
                    members = list(range(u * spb + gi * 8,
                                         u * spb + min(spb, gi * 8 + 8)))
                elif top2:
                    g, s = divmod(gi, Ps)
                    cnt = min(fold_tile, -(-(nper - g) // Gp))
                    members = [u * spb + Ps * (g + m * Gp) + s
                               for m in range(cnt)]
                else:
                    members = [u * spb + nper * Ps + gi - Gp * Ps]
                real = torch.tensor([t for t in members if t < n],
                                    dtype=torch.long, device=gpu)
                steps = []
                if top2 and len(real) > 1:
                    for m1, sl in pkernel._harvest(sc[real], 0, 2):
                        steps.append((m1, base + real[sl.long()]))
                else:
                    steps = [(sc[t:t + 1], base + t) for t in real.tolist()]
                fresh = init.expand(K, L).clone(), torch.zeros(
                    (K, L), dtype=torch.int32, device=gpu)
                slot = next(slot_of)
                tv, tt = dealt.get(slot, fresh)
                for score, tag in steps:
                    cur = tv.amin(dim=0, keepdim=True)
                    rep = (tv == cur) & (score >= cur)
                    tv = torch.where(rep, score, tv)
                    tt = torch.where(rep, torch.as_tensor(
                        tag, device=gpu).int().expand(K, L), tt)
                dealt[slot] = tv, tt
    for slot in sorted(dealt):   # the slots without an item come below
        bufs_v.append(dealt[slot][0])
        bufs_t.append(dealt[slot][1])
    assert len(bufs_v) <= nblk
    for _ in range(nblk - len(bufs_v)):
        bufs_v.append(init.expand(K, L))
        bufs_t.append(torch.zeros((K, L), dtype=torch.int32, device=gpu))
    return pkernel.merge_lane_topk(torch.cat(bufs_v), torch.cat(bufs_t), K)


@pytest.mark.parametrize("name,kw,integer", [
    ("h16_fold8", SLICE_BENCH, False), ("h16_fold1", dict(SLICE_BENCH,
                                                          fold_tile=1), False),
    ("f32_fold1", SLICE_DEFAULT, True)], ids=["h16_fold8", "h16_fold1",
                                              "f32_fold1"])
def test_slice_kernels_non_tie_safe(gpu, corpus, int_corpus, name, kw,
                                    integer):
    """K7's and K8's production buffers (tie_safe_topk=False) against the
    per-work-item emulation: K7's slots harvest their runs of items
    (``k7_deal`` on ``slice_topk_grid``'s slots) in order, K8's theirs at
    fold_tile 1 (``k7_deal`` on ``k8_launch``'s slots); K8 against its
    slot plain too."""
    eng, cfg = _slice_engine(gpu, corpus, int_corpus, kw, integer,
                             tie_safe_topk=False)
    _, nblk = pkernel.slice_topk_grid(gpu, cfg, eng.words.shape[0])
    qs = _slice_queries(int_corpus, integer, 3, 25)
    table, _ = eng._table(qs[0])
    kv, kt = pkernel.topk_spmv_fused_device(
        eng.words, table, eng.nreal, eng.plan_rows, cfg=cfg,
        block_sublanes=cfg.fused_block_sublanes)
    ev, et = _emulate_slice_production(
        eng, table, cfg, nblk, cfg.fold_tile,
        deal=pkernel.k7_deal(eng.plan_rows, eng.nreal, nblk, cfg.fold_tile))
    _lanes_equal(kv, kt, ev, et)
    tables = _slice_tables(cfg, qs, gpu)
    *_, slots = pkernel.k8_launch(gpu, cfg, 3, 1)
    bv, bt = eng.batch_candidates(tables)
    for q in range(3):
        ev, et = _emulate_slice_production(
            eng, tables[q], cfg, slots, 1,
            deal=pkernel.k7_deal(eng.plan_rows, eng.nreal, slots, 1))
        _lanes_equal(bv[q], bt[q], ev, et)
    _k8_slots_equal(eng, tables, cfg)


@pytest.mark.parametrize("name,kw,integer", [
    ("h16", SLICE_BENCH, False), ("h16_wide", dict(SLICE_BENCH,
                                                   fused_block_sublanes=32),
                                  False),
    ("f32", SLICE_DEFAULT, True), ("f32_wide", dict(SLICE_DEFAULT,
                                                    fused_block_sublanes=32),
                                   True)],
    ids=["h16", "h16_wide", "f32", "f32_wide"])
def test_slice_scores_kernel_matches_plain(gpu, corpus, int_corpus, name, kw,
                                           integer):
    eng, cfg = _slice_engine(gpu, corpus, int_corpus, kw, integer)
    table, _ = eng._table(_slice_queries(int_corpus, integer, 1, 26)[0])
    args = (eng.words, table, eng.nreal, eng.plan_rows)
    n = eng.row_ids.shape[0]
    before = pkernel.spmv_fused_scores_device.launches
    got = pkernel.spmv_fused_scores_device(
        *args, cfg=cfg, block_sublanes=cfg.fused_block_sublanes,
        num_slices=n)
    assert pkernel.spmv_fused_scores_device.launches == before + 1
    want = pkernel.slice_scores_plain(
        *args, num_slices=n, block_sublanes=cfg.fused_block_sublanes,
        codec=cfg.query_codec)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


# K9 and K4 in both store forms (slice order, and row order: each slice
# lane's score times the scale at its row id), every codec, on one and two
# partitions, with wide slices and wide octets, on a corpus with a row of
# no nnz: each kernel bit for bit against its plain version, and scores()
# bit for bit against the path before the row-order store (the kernel's
# slice order, then an int64 copy of row_ids, torch.where, the multiply by
# the scale and scatter_ into a zero fill, on the card).
SCORES_GEOMETRIES = {
    ("slice", "narrow"): dict(fused_layout="slice", width_quantum=2,
                              fused_block_sublanes=1024),
    ("slice", "wide"): dict(fused_layout="slice", width_quantum=2,
                            fused_block_sublanes=32),
    ("octet", "narrow"): dict(fused_layout="octet", width_quantum=2,
                              fused_block_sublanes=1024),
    ("octet", "wide"): dict(fused_layout="octet", width_quantum=1,
                            fused_block_sublanes=64),
}
SCORES_CODECS = ("h16", "f32", "int8x4", "i8s", "i4s")
EMPTY_ROW = 7


@pytest.fixture(scope="module")
def gappy_corpus(corpus):
    coo, qs = corpus
    keep = coo.rows != EMPTY_ROW
    return pt.CooMatrix(coo.rows[keep], coo.cols[keep], coo.vals[keep],
                        coo.num_rows, coo.num_cols), qs


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("partitions", [1, 2])
@pytest.mark.parametrize("codec", SCORES_CODECS)
@pytest.mark.parametrize("layout,geometry", list(SCORES_GEOMETRIES))
def test_scores_store_forms_match_plain(gpu, gappy_corpus, layout, geometry,
                                        codec, partitions):
    coo, qs = gappy_corpus
    cfg = pt.TopKSpMVConfig(k=100, lane_k=8, max_cols=1024,
                            query_codec=codec, rescore_pool=None,
                            num_partitions=partitions,
                            **SCORES_GEOMETRIES[(layout, geometry)])
    eng = pt.TopKSpMV(coo, cfg, device=gpu)
    if geometry == "wide":
        assert any((p.blocks_per_slice if layout == "slice"
                    else p.blocks_per_octet) > 1 for p in eng.fused.plan)
    wrapper, plain = (
        (pkernel.spmv_fused_scores_device, pkernel.slice_scores_plain)
        if layout == "slice" else
        (pkernel.spmv_fused_scores_octet_device, pkernel.octet_scores_plain))
    table, scale = eng._table(qs[0])
    factor = scale * eng._value_scale
    args = (eng.words, table, eng.nreal, eng.plan_rows)
    kw = dict(block_sublanes=cfg.fused_block_sublanes,
              num_slices=eng.row_ids.shape[0], num_partitions=partitions)

    def rows():
        return dict(row_ids=eng.row_ids, scale=factor,
                    out=torch.zeros(eng.num_rows, device=gpu))

    before = wrapper.launches
    ks = wrapper(*args, cfg=cfg, **kw)
    kr = wrapper(*args, cfg=cfg, **kw, **rows())
    assert wrapper.launches == before + 2
    ps = plain(*args, codec=codec, **kw)
    pr = plain(*args, codec=codec, **kw, **rows())
    got = eng.scores(qs[0])
    assert wrapper.launches == before + 3
    ids = eng.row_ids.reshape(-1).long()
    want = torch.zeros(eng.num_rows + 1, device=gpu)
    want.scatter_(0, torch.where(ids >= 0, ids, eng.num_rows),
                  ks.reshape(-1) * factor)
    torch.cuda.synchronize()
    assert torch.equal(_bits(ks), _bits(ps))
    assert torch.equal(_bits(kr), _bits(pr))
    assert torch.equal(_bits(got), _bits(want[:eng.num_rows]))
    assert float(got[EMPTY_ROW]) == 0.0 and bool((got != 0).any())


def test_slice_engines_on_gpu_match_cpu(gpu, corpus):
    """bench.py's batch engine: query (rescored), query_batch and scores()
    on the card equal the plain path's on the CPU. The default engine
    (f32, real values) too: the plain versions sum in the kernels' order,
    so values are bit-equal, and index sets equal above the k-th value
    (the production buffers may keep another row tied at it)."""
    coo, qs = corpus
    batch = create_query_batch(5, 1024, seed=28)
    cfg = pt.TopKSpMVConfig(**SLICE_BENCH)
    on_gpu = pt.TopKSpMV(coo, cfg, device=gpu)
    on_cpu = pt.TopKSpMV(coo, cfg, device="cpu")
    counts = [w.launches for w in (pkernel.topk_spmv_fused_device,
                                   pkernel.topk_spmv_fused_batch_device,
                                   pkernel.spmv_fused_scores_device)]
    for a, b in zip(on_gpu.query(qs[0]), on_cpu.query(qs[0])):
        np.testing.assert_array_equal(a.cpu().numpy(), b.numpy())
    for a, b in zip(on_gpu.query_batch(batch, group_size=2),
                    on_cpu.query_batch(batch, group_size=2)):
        assert a.device.type == "cuda"
        np.testing.assert_array_equal(a.cpu().numpy(), b.numpy())
    np.testing.assert_array_equal(on_gpu.scores(qs[0]).cpu().numpy(),
                                  on_cpu.scores(qs[0]).numpy())
    assert [w.launches for w in (pkernel.topk_spmv_fused_device,
                                 pkernel.topk_spmv_fused_batch_device,
                                 pkernel.spmv_fused_scores_device)] == \
        [counts[0] + 1, counts[1] + 3, counts[2] + 1]

    cfg = pt.TopKSpMVConfig(**SLICE_DEFAULT)
    on_gpu = pt.TopKSpMV(coo, cfg, device=gpu)
    on_cpu = pt.TopKSpMV(coo, cfg, device="cpu")
    for (gi, gv), (ci, cv) in ((on_gpu.query(qs[1]), on_cpu.query(qs[1])),
                               *zip(zip(*on_gpu.query_batch(batch)),
                                    zip(*on_cpu.query_batch(batch)))):
        gi, gv, ci, cv = (x.cpu().numpy() for x in (gi, gv, ci, cv))
        np.testing.assert_array_equal(gv, cv)
        assert set(gi[gv > cv[-1]].tolist()) == set(ci[cv > cv[-1]].tolist())
    np.testing.assert_array_equal(on_gpu.scores(qs[1]).cpu().numpy(),
                                  on_cpu.scores(qs[1]).numpy())


def test_slice_f32_kernels_take_wide_tables(gpu):
    """2048 columns: a 16-row f32 table, and K8's eight side-by-side
    tables need 64 KB of shared memory (past the 48 KB default)."""
    coo = create_sparse_matrix(5000, 2048, 20, "gamma", seed=31)
    rng = np.random.default_rng(32)
    coo = pt.CooMatrix(coo.rows, coo.cols,
                       rng.integers(-8, 9, coo.nnz).astype(np.float32),
                       coo.num_rows, coo.num_cols)
    qs = rng.integers(-8, 9, (8, 2048)).astype(np.float32)
    cfg = pt.TopKSpMVConfig(k=100, max_cols=2048, tie_safe_topk=True,
                            batch_subgroup=8)
    eng = pt.TopKSpMV(coo, cfg, device=gpu)
    table, _ = eng._table(qs[0])
    assert table.shape == (16, 128) and table.dtype == torch.float32
    args = (eng.words, table, eng.nreal, eng.plan_rows)
    kw = dict(block_sublanes=cfg.fused_block_sublanes)
    kv, kt = pkernel.topk_spmv_fused_device(*args, cfg=cfg, **kw)
    pv, pt_ = pkernel.slice_topk_plain(*args, fold_tile=1,
                                       **_plain_kw(cfg, True))
    _lanes_equal(kv, kt, pv, pt_)
    tables = _slice_tables(cfg, qs, gpu)
    bargs = (eng.words, tables, eng.nreal, eng.plan_rows)
    bv, bt = pkernel.topk_spmv_fused_batch_device(*bargs, cfg=cfg, **kw)
    bpv, bpt = pkernel.slice_topk_batch_plain(*bargs,
                                              **_plain_kw(cfg, True))
    for q in range(8):
        _lanes_equal(bv[q], bt[q], bpv[q], bpt[q])
    _k8_slots_equal(eng, tables, cfg)
    n = eng.row_ids.shape[0]
    got = pkernel.spmv_fused_scores_device(*args, cfg=cfg, num_slices=n,
                                           **kw)
    want = pkernel.slice_scores_plain(*args, num_slices=n, codec="f32",
                                      **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("cols", ["16384", "limit"])
def test_slice_f32_kernels_at_the_shared_memory_limit(gpu, cols):
    """16384 columns: a 64 KB f32 table, two of them a CUDA block's shared
    memory holds; the widest table that fits alone (58112 columns on the
    H100). K7, K8 (5 queries: its pass of 8 tables does not fit beside
    its buffers, so it reads them from global memory) and K9 against their
    plain versions, bit-equal; K8's production buffers against its slot
    plain."""
    limit = torch.cuda.get_device_properties(gpu).shared_memory_per_block_optin
    ncols = 16384 if cols == "16384" else limit // 512 * 128
    fit = pkernel.tables_in_smem(4 * ncols, limit)
    assert fit == (2 if cols == "16384" else 1)
    coo = create_sparse_matrix(3000, ncols, 20, "gamma", seed=33)
    qs = create_query_batch(5, ncols, seed=34)
    cfg = pt.TopKSpMVConfig(k=100, max_cols=ncols, tie_safe_topk=True)
    eng = pt.TopKSpMV(coo, cfg, device=gpu)
    table, _ = eng._table(qs[0])
    args = (eng.words, table, eng.nreal, eng.plan_rows)
    kw = dict(block_sublanes=cfg.fused_block_sublanes)
    kv, kt = pkernel.topk_spmv_fused_device(*args, cfg=cfg, **kw)
    pv, pt_ = pkernel.slice_topk_plain(*args, fold_tile=1,
                                       **_plain_kw(cfg, True))
    _lanes_equal(kv, kt, pv, pt_)
    bargs = (eng.words, _slice_tables(cfg, qs, gpu), eng.nreal,
             eng.plan_rows)
    bv, bt = pkernel.topk_spmv_fused_batch_device(*bargs, cfg=cfg, **kw)
    bpv, bpt = pkernel.slice_topk_batch_plain(*bargs,
                                              **_plain_kw(cfg, True))
    for q in range(5):
        _lanes_equal(bv[q], bt[q], bpv[q], bpt[q])
    _k8_slots_equal(eng, bargs[1], cfg)
    n = eng.row_ids.shape[0]
    got = pkernel.spmv_fused_scores_device(*args, cfg=cfg, num_slices=n,
                                           **kw)
    want = pkernel.slice_scores_plain(*args, num_slices=n, codec="f32",
                                      **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("P", [1, 2])
@pytest.mark.parametrize("cols", ["past_limit", "65536"])
def test_slice_f32_tables_past_shared_memory_read_global(gpu, cols, P):
    """One column group more than a CUDA block's shared memory holds, and
    the f32 column field's 65,536: no table fits, so K7, K8 (5 queries,
    a pass of 8) and K9 gather from the tables in global memory, bit-equal
    to their plain versions, on one partition and on two (K8's production
    buffers to its slot plain); the engine's query, query_batch and
    scores launch them."""
    limit = torch.cuda.get_device_properties(gpu).shared_memory_per_block_optin
    ncols = limit // 512 * 128 + 128 if cols == "past_limit" else 65536
    assert pkernel.tables_in_smem(4 * ncols, limit) == 0
    coo = create_sparse_matrix(3000, ncols, 20, "gamma", seed=35)
    qs = create_query_batch(5, ncols, seed=36)
    cfg = pt.TopKSpMVConfig(k=100, max_cols=ncols, tie_safe_topk=True,
                            num_partitions=P)
    eng = pt.TopKSpMV(coo, cfg, device=gpu)
    table, _ = eng._table(qs[0])
    args = (eng.words, table, eng.nreal, eng.plan_rows)
    bs = dict(block_sublanes=cfg.fused_block_sublanes)
    kv, kt = pkernel.topk_spmv_fused_device(*args, cfg=cfg, **bs,
                                            **eng.partition_kw)
    pv, pt_ = pkernel.slice_topk_plain(*args, fold_tile=1,
                                       **eng.partition_kw,
                                       **_plain_kw(cfg, True))
    _pools_equal(kv, kt, pv, pt_)
    bargs = (eng.words, _slice_tables(cfg, qs, gpu), eng.nreal,
             eng.plan_rows)
    bv, bt = pkernel.topk_spmv_fused_batch_device(*bargs, cfg=cfg, **bs,
                                                  **eng.partition_kw)
    bpv, bpt = pkernel.slice_topk_batch_plain(*bargs, **eng.partition_kw,
                                              **_plain_kw(cfg, True))
    _pools_equal(bv, bt, bpv, bpt)
    _k8_slots_equal(eng, bargs[1], cfg)
    n = eng.row_ids.shape[0]
    got = pkernel.spmv_fused_scores_device(*args, cfg=cfg, num_slices=n,
                                           num_partitions=P, **bs)
    want = pkernel.slice_scores_plain(*args, num_slices=n, codec="f32",
                                      num_partitions=P, **bs)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    wrappers = (pkernel.topk_spmv_fused_device,
                pkernel.topk_spmv_fused_batch_device,
                pkernel.spmv_fused_scores_device)
    before = [w.launches for w in wrappers]
    idx, _ = eng.query(qs[0])
    bidx, _ = eng.query_batch(qs)
    sc = eng.scores(qs[0])
    assert idx.shape == (100,) and bidx.shape == (5, 100)
    assert torch.isfinite(sc).all()
    assert [w.launches - b for w, b in zip(wrappers, before)] == [1, 1, 1]


# K7 (csrc/slice_topk.cuh): one launch, its lane merge on the card;
# slice_topk_slots_plain on slice_topk_grid's slots computes what it gives.
# (lane_k, fold_tile, fused block sublanes): tiled sub-tiles (fold 8 and
# 2), runs (fold 1; fold 4 past the unroll threshold at 2048), wide
# slices (32)
K7_GEOMS = [(8, 8, 1024), (4, 1, 1024), (16, 2, 32), (8, 4, 2048)]
# each codec's width quantum (its engines': bench.py, the default, c3)
K7_QUANTUM = dict(h16=2, f32=8, int8x4=4, i8s=4, i4s=4)


def _k7_slots_plain(eng, cfg, table, merged=True):
    P = cfg.num_partitions
    _, slots = pkernel.slice_topk_grid(eng.words.device, cfg,
                                       eng.words.shape[0] // P, P)
    return pkernel.slice_topk_slots_plain(
        eng.words, table, eng.nreal, eng.plan_rows, num_slots=slots,
        lane_k=cfg.lane_k, fold_tile=cfg.fold_tile,
        tie_safe=bool(cfg.tie_safe_topk),
        block_sublanes=cfg.fused_block_sublanes, codec=cfg.query_codec,
        merged=merged, **eng.partition_kw)


def _k7_check(eng, cfg, table):
    """K7 against its slot plain, merged (one launch) and unmerged, bit
    for bit, tags included; tie-safe, its values those of
    ``slice_topk_plain`` too."""
    args = (eng.words, table, eng.nreal, eng.plan_rows)
    bs = cfg.fused_block_sublanes
    before = pkernel.topk_spmv_fused_device.launches
    kv, kt = pkernel.topk_spmv_fused_device(
        *args, cfg=cfg, block_sublanes=bs, **eng.partition_kw)
    assert pkernel.topk_spmv_fused_device.launches == before + 1
    pv, pt_ = _k7_slots_plain(eng, cfg, table)
    torch.cuda.synchronize()
    P = cfg.num_partitions
    assert kv.shape == (*((P,) if P > 1 else ()), cfg.lane_k, 128)
    assert torch.equal(kv, pv) and torch.equal(kt, pt_)
    uv, ut = pkernel._slice_topk_cuda(
        *args, P, eng.partition_kw.get("part_slices", 0), cfg, bs,
        unmerged=True)
    sv, st = _k7_slots_plain(eng, cfg, table, merged=False)
    torch.cuda.synchronize()
    assert torch.equal(uv, sv) and torch.equal(ut, st)
    if cfg.tie_safe_topk:
        _pools_equal(kv, kt, *pkernel.slice_topk_plain(
            *args, lane_k=cfg.lane_k, fold_tile=cfg.fold_tile, tie_safe=True,
            block_sublanes=bs, codec=cfg.query_codec, **eng.partition_kw))


@pytest.mark.parametrize("tie_safe", [False, True])
@pytest.mark.parametrize("P", [1, 3])
@pytest.mark.parametrize("lane_k,fold,fbs", K7_GEOMS,
                         ids=[f"k{k}_fold{f}_fbs{b}" for k, f, b in K7_GEOMS])
@pytest.mark.parametrize("codec", list(K7_QUANTUM))
def test_k7_matches_slots_plain(gpu, corpus, codec, lane_k, fold, fbs, P,
                                tie_safe):
    """K7 (K10a at P = 3) on production and tie-safe buffers, every codec,
    lane_k 4, 8 and 16, the three kinds of work item (tiled sub-tiles at
    fold 8 and 2; runs at fold 1 and past the unroll threshold; wide
    slices)."""
    cfg = pt.TopKSpMVConfig(
        k=100, lane_k=lane_k, max_cols=1024, query_codec=codec,
        fused_layout="slice", width_quantum=K7_QUANTUM[codec],
        fold_tile=fold, block_sublanes=512, fused_block_sublanes=fbs,
        num_partitions=P, tie_safe_topk=tie_safe)
    eng = pt.TopKSpMV(corpus[0], cfg, device=gpu)
    modes = {pkernel.slice_work(r, fold)[0] for r in eng.plan_rows.tolist()}
    want = {1024: pkernel.TILED if fold > 1 else pkernel.RUNS,
            32: pkernel.WIDE, 2048: pkernel.RUNS}[fbs]
    assert want in modes
    if fbs == 2048:
        assert modes == {pkernel.RUNS}
    table, _ = eng._table(corpus[1][0])
    _k7_check(eng, cfg, table)


@pytest.mark.parametrize("tie_safe", [False, True])
@pytest.mark.parametrize("cols", ["limit", "past_limit", "65536"])
def test_k7_f32_tables_at_and_past_shared_memory(gpu, cols, tie_safe):
    """f32 tables as wide as a CUDA block's shared memory holds (58,112
    columns on the H100: the merge's lists reuse the table's bytes, so it
    stays in shared memory) and past it (codec "f32_global"), on one
    partition and on two: K7 against its slot plain."""
    limit = torch.cuda.get_device_properties(gpu).shared_memory_per_block_optin
    ncols = {"limit": limit // 512 * 128,
             "past_limit": limit // 512 * 128 + 128, "65536": 65536}[cols]
    assert pkernel.tables_in_smem(4 * ncols, limit) == int(cols == "limit")
    coo = create_sparse_matrix(3000, ncols, 20, "gamma", seed=46)
    q = create_query_batch(1, ncols, seed=47)[0]
    for P in (1, 2):
        cfg = pt.TopKSpMVConfig(k=100, max_cols=ncols, num_partitions=P,
                                tie_safe_topk=tie_safe)
        eng = pt.TopKSpMV(coo, cfg, device=gpu)
        table, _ = eng._table(q)
        _k7_check(eng, cfg, table)


def test_k7_back_to_back_launches(gpu, corpus):
    """20 launches back to back on one stream (each merge's tickets left
    0 for the next) equal the launches run alone."""
    eng = pt.TopKSpMV(corpus[0], pt.TopKSpMVConfig(**SLICE_DEFAULT),
                      device=gpu)
    qs = create_query_batch(20, 1024, seed=48)
    alone = []
    for q in qs:
        alone.append(eng.candidates(q))
        torch.cuda.synchronize()
    chained = [eng.candidates(q) for q in qs]
    torch.cuda.synchronize()
    for (av, at), (cv, ct) in zip(alone, chained):
        assert torch.equal(av, cv) and torch.equal(at, ct)


# ------------------------------------------------------------- partitions
# K10a-d: K7, K8, K1, K6 with a partition axis, and the partitioned K4 and
# K9, on engines of P row partitions on one plan skeleton. A pool per
# partition: (P, lane_k, 128) and (Q, P, lane_k, 128), each partition's
# tags offset by p * part_slices.

# (name, config, integer-valued data)
PART_CASES = [
    ("octet_h16", dict(HEADLINE, tie_safe_topk=True, num_partitions=3),
     False),
    ("octet_h16_fold1", dict(HEADLINE, fold_tile=1, tie_safe_topk=True,
                             num_partitions=2), False),
    ("octet_h16_wide", dict(HEADLINE, fused_block_sublanes=64,
                            tie_safe_topk=True, num_partitions=2), False),
    ("slice_h16", dict(SLICE_BENCH, tie_safe_topk=True, num_partitions=3),
     False),
    ("slice_h16_wide", dict(SLICE_BENCH, fused_block_sublanes=32,
                            tie_safe_topk=True, num_partitions=2), False),
    ("slice_f32_int", dict(SLICE_DEFAULT, tie_safe_topk=True,
                           num_partitions=4), True),
    ("slice_f32_real", dict(SLICE_DEFAULT, tie_safe_topk=True,
                            num_partitions=2), False),
]


def _part_view(eng, p):
    """Partition p of a partitioned engine as an engine-like view (words,
    nreal (B, 1), plan_rows) for the single-partition emulations."""
    from types import SimpleNamespace

    P = eng.config.num_partitions
    rows = eng.words.shape[0] // P
    return SimpleNamespace(words=eng.words[p * rows:(p + 1) * rows],
                           nreal=eng.nreal[p], plan_rows=eng.plan_rows)


@pytest.mark.parametrize("lane_k", [8, 16, 4])
@pytest.mark.parametrize("name,kw,integer", PART_CASES,
                         ids=[c[0] for c in PART_CASES])
def test_partition_kernels_match_plain(gpu, corpus, int_corpus, name, kw,
                                       integer, lane_k):
    """K10a/b (one query), K10c/d (5 queries: one short pass) and the
    partitioned K4/K9 against their plain versions: sorted values
    bit-equal, (value, tag) pairs above each lane's floor, scores
    bit-equal; K10c's and K10d's production buffers against their slot
    plains; at least one partition holds a bucket with no real slice."""
    eng, cfg = _slice_engine(gpu, corpus, int_corpus, kw, integer,
                             lane_k=lane_k, batch_subgroup=2)
    P = cfg.num_partitions
    if name != "slice_f32_real":
        assert (eng.nreal == 0).any()
    octet = cfg.fused_layout == "octet"
    qs = _slice_queries(int_corpus, integer, 6, 29)
    table, _ = eng._table(qs[0])
    args = (eng.words, table, eng.nreal, eng.plan_rows)
    bargs = (eng.words, _slice_tables(cfg, qs[1:], gpu), eng.nreal,
             eng.plan_rows)
    bs = cfg.fused_block_sublanes
    parts = eng.partition_kw
    pkw = dict(lane_k=lane_k, tie_safe=True, block_sublanes=bs, **parts)
    n = eng.row_ids.shape[0]
    if octet:
        sweeps = (pkernel.topk_spmv_fused_octet_device,
                  pkernel.topk_spmv_fused_batch_octet_device,
                  pkernel.spmv_fused_scores_octet_device)
        pkw["fold_tile"] = cfg.fold_tile
        plain = (pkernel.octet_topk_plain(*args, **pkw),
                 pkernel.octet_topk_batch_plain(*bargs, **pkw),
                 pkernel.octet_scores_plain(*args, num_slices=n,
                                            block_sublanes=bs,
                                            num_partitions=P))
    else:
        sweeps = (pkernel.topk_spmv_fused_device,
                  pkernel.topk_spmv_fused_batch_device,
                  pkernel.spmv_fused_scores_device)
        pkw["codec"] = cfg.query_codec
        plain = (pkernel.slice_topk_plain(*args, fold_tile=cfg.fold_tile,
                                          **pkw),
                 pkernel.slice_topk_batch_plain(*bargs, **pkw),
                 pkernel.slice_scores_plain(*args, num_slices=n,
                                            block_sublanes=bs,
                                            codec=cfg.query_codec,
                                            num_partitions=P))
    before = [w.launches for w in sweeps]
    kv, kt = sweeps[0](*args, cfg=cfg, block_sublanes=bs, **parts)
    bv, bt = sweeps[1](*bargs, cfg=cfg, block_sublanes=bs, **parts)
    ks = sweeps[2](*args, cfg=cfg, block_sublanes=bs, num_slices=n,
                   num_partitions=P)
    torch.cuda.synchronize()
    assert [w.launches - b for w, b in zip(sweeps, before)] == [1, 1, 1]
    assert kv.shape == (P, lane_k, 128) and bv.shape == (5, P, lane_k, 128)
    _pools_equal(kv, kt, *plain[0])
    _pools_equal(bv, bt, *plain[1])
    assert torch.equal(ks, plain[2])
    _k8_slots_equal(eng, bargs[1], cfg)


def _offset_real(tv, tt, off):
    """Tags of real entries (above the sentinels) moved up by off."""
    return torch.where(tv > pkernel.TOPK_FLOOR, tt + off, tt)


@pytest.mark.parametrize("name,kw,integer", [
    ("octet_fold8", dict(HEADLINE, num_partitions=2), False),
    ("octet_fold1", dict(HEADLINE, fold_tile=1, num_partitions=3), False),
    ("slice_h16_fold8", dict(SLICE_BENCH, num_partitions=2), False),
    ("slice_h16_fold1", dict(SLICE_BENCH, fold_tile=1, num_partitions=3),
     False),
    ("slice_f32", dict(SLICE_DEFAULT, num_partitions=2), True)],
    ids=["octet_fold8", "octet_fold1", "slice_h16_fold8", "slice_h16_fold1",
         "slice_f32"])
def test_partition_kernels_non_tie_safe(gpu, corpus, int_corpus, name, kw,
                                        integer):
    """K10a-d's production buffers (tie_safe_topk=False) against the
    per-octet and per-work-item emulations, partition by partition: each
    partition has fewer octets than it has slots (K10b's,
    ``octet_topk_grid``; K10d h16's slots harvest their octets in turn,
    as ``_emulate_production`` does); K10a's slots (``slice_topk_grid``)
    and K10c's (``k8_launch``, at fold_tile 1) harvest their runs of
    items (``k7_deal``)."""
    eng, cfg = _slice_engine(gpu, corpus, int_corpus, kw, integer,
                             tie_safe_topk=False)
    P = cfg.num_partitions
    sms = torch.cuda.get_device_properties(gpu).multi_processor_count
    part_rows = eng.words.shape[0] // P
    qs = _slice_queries(int_corpus, integer, 3, 30)
    tables = _slice_tables(cfg, qs, gpu)
    octet = cfg.fused_layout == "octet"
    if octet:
        _, nblk = pkernel.octet_topk_grid(gpu, cfg, part_rows, P)
        _, slots = pkernel.octet_h16_grid(3, sms, P, cfg.lane_k)
    else:
        _, nblk = pkernel.slice_topk_grid(gpu, cfg, part_rows, P)
        *_, slots = pkernel.k8_launch(gpu, cfg, 3, P)
    table, _ = eng._table(qs[0])
    kv, kt = eng.candidates(qs[0])
    bv, bt = eng.batch_candidates(tables)
    for p in range(P):
        view = _part_view(eng, p)
        off = p * eng.partition_kw["part_slices"]
        for got_v, got_t, tab, blocks, fold, single in (
                (kv[p], kt[p], table, nblk, cfg.fold_tile, True),
                *((bv[q, p], bt[q, p], tables[q], slots,
                   cfg.fold_tile if octet else 1, False) for q in range(3))):
            if octet:
                ev, et = _emulate_production(
                    view, tab, dataclasses.replace(cfg, fold_tile=fold),
                    blocks)
            else:
                ev, et = _emulate_slice_production(
                    view, tab, cfg, blocks, fold,
                    deal=pkernel.k7_deal(view.plan_rows, view.nreal, blocks,
                                         fold))
            _lanes_equal(got_v, got_t, ev, _offset_real(ev, et, off))


@pytest.mark.parametrize("name,kw", [
    ("octet_headline", dict(HEADLINE, num_partitions=2)),
    ("slice_bench", dict(SLICE_BENCH, num_partitions=3)),
    ("default", dict(SLICE_DEFAULT, num_partitions=2))],
    ids=["octet_headline", "slice_bench", "default"])
def test_partitioned_engines_on_gpu_match_cpu(gpu, corpus, name, kw):
    """query, query_batch (groups of 2, a tail group) and scores of
    partitioned engines on the card equal the plain path's on the CPU:
    the rescored engines' top 100 bit for bit, the default engine's
    values bit-equal and its rows above the k-th value."""
    coo, qs = corpus
    batch = create_query_batch(5, 1024, seed=31)
    cfg = pt.TopKSpMVConfig(**kw)
    on_gpu = pt.TopKSpMV(coo, cfg, device=gpu)
    on_cpu = pt.TopKSpMV(coo, cfg, device="cpu")
    pairs = [(on_gpu.query(qs[0]), on_cpu.query(qs[0])),
             *zip(zip(*on_gpu.query_batch(batch, group_size=2)),
                  zip(*on_cpu.query_batch(batch, group_size=2)))]
    for (gi, gv), (ci, cv) in pairs:
        assert gi.device.type == "cuda"
        gi, gv, ci, cv = (x.cpu().numpy() for x in (gi, gv, ci, cv))
        np.testing.assert_array_equal(gv, cv)
        if cfg.rescore_pool:
            np.testing.assert_array_equal(gi, ci)
        else:
            assert set(gi[gv > cv[-1]].tolist()) == \
                set(ci[cv > cv[-1]].tolist())
    np.testing.assert_array_equal(on_gpu.scores(qs[1]).cpu().numpy(),
                                  on_cpu.scores(qs[1]).numpy())


# ---------------------------------------------------------------- codecs
# The quantized query codecs (int8x4, i8s, i4s) on both streams and f32 on
# the octet stream, through every sweep: K1/K7 (one query), K6/K8 (5
# queries: one short pass; K6's split passes: test_k6_codec_batch_matches_
# slots_plain), K4/K9, on one partition and on two (K10a-d).
# The plain versions add in the kernels' order, each product and add
# rounded, so everything is held bit for bit, on real values.

CODEC_CASES = [("octet", "f32"), ("octet", "int8x4"), ("octet", "i8s"),
               ("octet", "i4s"), ("slice", "int8x4"), ("slice", "i8s"),
               ("slice", "i4s")]


def _sweeps(octet):
    if octet:
        return (pkernel.topk_spmv_fused_octet_device,
                pkernel.topk_spmv_fused_batch_octet_device,
                pkernel.spmv_fused_scores_octet_device)
    return (pkernel.topk_spmv_fused_device,
            pkernel.topk_spmv_fused_batch_device,
            pkernel.spmv_fused_scores_device)


def _codec_agree(eng, cfg, q, qs):
    """The three sweeps of eng under cfg (tie-safe) against their plain
    versions: pools and scores bit-equal; one launch each; K8's or K6's
    (K10c's, K10d's) production buffers against its slot plain."""
    octet = cfg.fused_layout == "octet"
    bs = cfg.fused_block_sublanes
    P = cfg.num_partitions
    parts = eng.partition_kw
    table, _ = eng._table(q)
    args = (eng.words, table, eng.nreal, eng.plan_rows)
    bargs = (eng.words, _slice_tables(cfg, qs, eng.device), eng.nreal,
             eng.plan_rows)
    n = eng.row_ids.shape[0]
    pkw = dict(lane_k=cfg.lane_k, tie_safe=True, block_sublanes=bs,
               codec=cfg.query_codec, **parts)
    if octet:
        plain = (pkernel.octet_topk_plain(*args, fold_tile=cfg.fold_tile,
                                          **pkw),
                 pkernel.octet_topk_batch_plain(*bargs,
                                                fold_tile=cfg.fold_tile,
                                                **pkw),
                 pkernel.octet_scores_plain(*args, num_slices=n,
                                            block_sublanes=bs,
                                            num_partitions=P,
                                            codec=cfg.query_codec))
    else:
        plain = (pkernel.slice_topk_plain(*args, fold_tile=cfg.fold_tile,
                                          **pkw),
                 pkernel.slice_topk_batch_plain(*bargs, **pkw),
                 pkernel.slice_scores_plain(*args, num_slices=n,
                                            block_sublanes=bs,
                                            codec=cfg.query_codec,
                                            num_partitions=P))
    sweeps = _sweeps(octet)
    before = [w.launches for w in sweeps]
    kv, kt = sweeps[0](*args, cfg=cfg, block_sublanes=bs, **parts)
    bv, bt = sweeps[1](*bargs, cfg=cfg, block_sublanes=bs, **parts)
    ks = sweeps[2](*args, cfg=cfg, block_sublanes=bs, num_slices=n,
                   num_partitions=P)
    torch.cuda.synchronize()
    assert [w.launches - b for w, b in zip(sweeps, before)] == [1, 1, 1]
    _pools_equal(kv, kt, *plain[0])
    _pools_equal(bv, bt, *plain[1])
    assert torch.equal(ks, plain[2])
    if not octet:
        _k8_slots_equal(eng, bargs[1], cfg)


@pytest.mark.parametrize("P", [1, 2])
@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
@pytest.mark.parametrize("layout,codec", CODEC_CASES,
                         ids=[f"{a}_{b}" for a, b in CODEC_CASES])
def test_codec_kernels_match_plain(gpu, corpus, layout, codec, wide, P):
    """Every sweep of each (layout, codec) against its plain version, the
    octet ones at fold 8 on narrow blocks and fold 1 with wide octets."""
    octet = layout == "octet"
    base = HEADLINE if octet else SLICE_BENCH
    fbs = (64 if octet else 32) if wide else 1024
    cfg = pt.TopKSpMVConfig(**dict(
        base, query_codec=codec, rescore_pool=None, tie_safe_topk=True,
        batch_subgroup=2, fused_block_sublanes=fbs, num_partitions=P,
        fold_tile=1 if octet and wide else base["fold_tile"]))
    eng = pt.TopKSpMV(corpus[0], cfg, device=gpu)
    if wide:
        assert any((p.blocks_per_octet if octet else p.blocks_per_slice) > 1
                   for p in eng.fused.plan)
    qs = create_query_batch(6, 1024, seed=37)
    _codec_agree(eng, cfg, qs[0], qs[1:])


@pytest.mark.parametrize("layout", ["octet", "slice"])
@pytest.mark.parametrize("codec,cols", [("int8x4", 1536), ("i4s", 2048),
                                        ("i8s", 1024)])
def test_codec_kernels_take_multi_row_tables(gpu, layout, codec, cols):
    """Tables of more than one row: int8x4 at 1536 columns (3 rows, the
    row select w >> 25), i4s at 2048 and i8s at 1024 (2 rows, the sign
    select), every sweep against its plain version."""
    coo = create_sparse_matrix(5000, cols, 20, "gamma", seed=38)
    base = HEADLINE if layout == "octet" else SLICE_BENCH
    cfg = pt.TopKSpMVConfig(**dict(base, query_codec=codec, max_cols=cols,
                                   rescore_pool=None, tie_safe_topk=True,
                                   batch_subgroup=2))
    eng = pt.TopKSpMV(coo, cfg, device=gpu)
    qs = create_query_batch(6, cols, seed=39)
    assert eng._table(qs[0])[0].shape[0] == (3 if codec == "int8x4" else 2)
    _codec_agree(eng, cfg, qs[0], qs[1:])


@pytest.mark.parametrize("name", ["c3", "c8"])
def test_codec_engines_on_gpu_match_cpu(gpu, corpus, name):
    """The deployments c3 (i8s, quantum 4) and c8 (i4s, quantum 4, pool
    400) of bench/full_eval.py: query, query_batch (groups of 2, a tail
    group) and scores on the card equal the plain path's on the CPU."""
    coo, qs = corpus
    kw = dict(k=100, query_codec="i8s", width_quantum=4)
    if name == "c8":
        kw.update(query_codec="i4s", rescore_pool=400)
    cfg = pt.TopKSpMVConfig(**kw)
    on_gpu = pt.TopKSpMV(coo, cfg, device=gpu)
    on_cpu = pt.TopKSpMV(coo, cfg, device="cpu")
    batch = create_query_batch(5, 1024, seed=40)
    pairs = [(on_gpu.query(qs[0]), on_cpu.query(qs[0])),
             *zip(zip(*on_gpu.query_batch(batch, group_size=2)),
                  zip(*on_cpu.query_batch(batch, group_size=2)))]
    for (gi, gv), (ci, cv) in pairs:
        assert gi.device.type == "cuda"
        gi, gv, ci, cv = (x.cpu().numpy() for x in (gi, gv, ci, cv))
        np.testing.assert_array_equal(gv, cv)
        if cfg.rescore_pool:
            np.testing.assert_array_equal(gi, ci)
        else:
            assert set(gi[gv > cv[-1]].tolist()) == \
                set(ci[cv > cv[-1]].tolist())
    np.testing.assert_array_equal(on_gpu.scores(qs[1]).cpu().numpy(),
                                  on_cpu.scores(qs[1]).numpy())


@pytest.mark.parametrize("P", [1, 2])
def test_octet_f32_tables_past_shared_memory_read_global(gpu, P):
    """The octet stream with f32 tables of 65,536 columns (256 KB, past a
    CUDA block's shared memory): K1, K6 (10 queries: passes of 8 and 2) and
    K4 gather from the tables in global memory (codec "f32_global"),
    bit-equal to their plain versions, on one partition and on two."""
    limit = torch.cuda.get_device_properties(gpu).shared_memory_per_block_optin
    assert pkernel.tables_in_smem(4 * 65536, limit) == 0
    coo = create_sparse_matrix(3000, 65536, 20, "gamma", seed=41)
    cfg = pt.TopKSpMVConfig(**dict(HEADLINE, query_codec="f32", max_cols=65536,
                                   rescore_pool=None, tie_safe_topk=True,
                                   batch_subgroup=2, num_partitions=P))
    eng = pt.TopKSpMV(coo, cfg, device=gpu)
    qs = create_query_batch(11, 65536, seed=42)
    _codec_agree(eng, cfg, qs[0], qs[1:])


@pytest.mark.parametrize("tie_safe", [False, True])
@pytest.mark.parametrize("P", [1, 2])
@pytest.mark.parametrize("layout", ["octet", "slice"])
def test_int8x4_batch_tables_past_shared_memory_read_global(gpu, layout, P,
                                                            tie_safe):
    """int8x4 tables of 32,768 columns (64 rows): no pass table of K6 or
    K8 fits a CUDA block's shared memory beside its buffers, so both read
    the tables from global memory (kernel codec "int8x4_global"; 10
    queries: passes of 8 and 2), merged on the card and unmerged, bit for
    bit against their slot plain, tags included, the production buffers
    too."""
    ncols, Q = 32768, 10
    coo = create_sparse_matrix(3000, ncols, 20, "gamma", seed=43)
    kw = dict(k=100, max_cols=ncols, query_codec="int8x4", width_quantum=4,
              rescore_pool=None, tie_safe_topk=tie_safe, num_partitions=P)
    octet = layout == "octet"
    cfg = pt.TopKSpMVConfig(**(dict(HEADLINE, **kw) if octet else kw))
    eng = pt.TopKSpMV(coo, cfg, device=gpu)
    tables = _slice_tables(cfg, create_query_batch(Q, ncols, seed=44), gpu)
    launch = pkernel.k6_launch if octet else pkernel.k8_launch
    codec, qp, passes, slots = launch(gpu, cfg, Q, P)
    assert (codec, qp, passes) == ("int8x4_global", 8, 2)
    kv, kt = eng.batch_candidates(tables)
    args = (eng.words, tables, eng.nreal, eng.plan_rows)
    plain_kw = dict(num_slots=slots, lane_k=cfg.lane_k, tie_safe=tie_safe,
                    block_sublanes=cfg.fused_block_sublanes, codec="int8x4",
                    **eng.partition_kw)
    tag_offset = (P, eng.partition_kw.get("part_slices", 0), cfg)
    if octet:
        plain = pkernel.octet_topk_batch_slots_plain
        plain_kw["fold_tile"] = cfg.fold_tile
        uv, ut = pkernel.octet_topk_batch_cuda(
            *args, *tag_offset,
            **pkernel._sweep_kw(cfg, cfg.fused_block_sublanes),
            unmerged=True)
    else:
        plain = pkernel.slice_topk_batch_slots_plain
        uv, ut = pkernel._slice_topk_batch_cuda(
            *args, *tag_offset, cfg.fused_block_sublanes, unmerged=True)
    pv, pt_ = plain(*args, **plain_kw)
    sv, st = plain(*args, merged=False, **plain_kw)
    torch.cuda.synchronize()
    assert torch.equal(kv, pv) and torch.equal(kt, pt_)
    assert torch.equal(uv, sv) and torch.equal(ut, st)


# ------------------------------------------------------------ per-bucket ops
# K11 (spmv_bucket_scores_device), K13 (topk_spmv_bucket_device) and K12
# (topk_spmv_bucket_batch_device) over every bucket of pack_sell_buckets,
# against their plain versions: the plain versions add in the kernels'
# order (ops/kernel.py::_bucket_sums), so scores and tie-safe pools are
# held bit for bit on real values, for every codec.

from spmv_topk_tpu_torch.formats import CooMatrix  # noqa: E402
from spmv_topk_tpu_torch.formats.sell_buckets import pack_sell_buckets  # noqa: E402
from spmv_topk_tpu_torch.ops.quantized_query import pack_query_table  # noqa: E402

# name -> (codec, columns, width_quantum, dense rows): the dense rows
# (degree 700-1000) give the corpus a bucket of one slice per block, wider
# than the 512-row block target for the one-nnz codecs
BUCKET_CASES = {
    "h16": ("h16", 1024, 8, True),
    "f32": ("f32", 1024, 8, True),
    "int8x4": ("int8x4", 1024, 8, True),
    "i8s": ("i8s", 1024, 8, True),
    "i4s": ("i4s", 1024, 8, True),
    "f32_quantum2": ("f32", 1024, 2, False),
    "int8x4_1536_cols": ("int8x4", 1536, 8, False),
    "i4s_2048_cols": ("i4s", 2048, 8, False),
    "f32_65536_cols": ("f32", 65536, 8, False),
    "int8x4_65536_cols": ("int8x4", 65536, 8, False),
}


def _with_dense_rows(coo, degrees, seed):
    """coo with one row more per degree, each of that many nnz."""
    rng = np.random.default_rng(seed)
    rows, cols, vals = [coo.rows], [coo.cols], [coo.vals]
    for i, d in enumerate(degrees):
        rows.append(np.full(d, coo.num_rows + i, np.int32))
        cols.append(np.sort(rng.choice(coo.num_cols, d, replace=False)))
        vals.append(rng.standard_normal(d).astype(np.float32) * 0.1)
    return CooMatrix(np.concatenate(rows), np.concatenate(cols),
                     np.concatenate(vals), coo.num_rows + len(degrees),
                     coo.num_cols)


@pytest.fixture(scope="module")
def bucket_packs():
    """name -> (config, BucketedSellMatrix, 6 queries), built on first use."""
    cache = {}

    def get(name):
        if name not in cache:
            codec, cols, quantum, dense = BUCKET_CASES[name]
            rows = 3000 if cols > 2048 else 12_000
            coo = create_sparse_matrix(rows, cols, 20, "gamma", seed=43)
            if dense:
                coo = _with_dense_rows(coo, (700, 900, 1000), 44)
            cfg = pt.TopKSpMVConfig(k=100, max_cols=cols, query_codec=codec,
                                    width_quantum=quantum, block_sublanes=512,
                                    tie_safe_topk=True, batch_subgroup=2)
            cache[name] = (cfg, pack_sell_buckets(coo, cfg),
                           create_query_batch(6, cols, seed=45))
        return cache[name]

    return get


def _bucket_args(b, dev):
    spb = b.block_sublanes // b.width
    kw = dict(width=b.width, slices_per_block=spb, num_blocks=b.num_blocks)
    return (torch.from_numpy(b.words).to(dev),
            torch.tensor([[b.num_slices]], dtype=torch.int32, device=dev), kw)


@pytest.mark.parametrize("lane_k", [8, 16, 4])
@pytest.mark.parametrize("name", list(BUCKET_CASES))
def test_bucket_kernels_match_plain(gpu, bucket_packs, name, lane_k):
    """K11, K13 and K12 (5 queries, a pass of 8) over every bucket,
    tie-safe, against their plain versions: scores bit-equal, pools
    bit-equal with equal (value, tag) pairs above each lane's floor; one
    launch each per bucket."""
    cfg, m, qs = bucket_packs(name)
    cfg = dataclasses.replace(cfg, lane_k=lane_k)
    codec = cfg.query_codec
    table = torch.from_numpy(pack_query_table(qs[0], codec)[0]).to(gpu)
    tables = _slice_tables(cfg, qs[1:], gpu)
    ops = (pkernel.spmv_bucket_scores_device, pkernel.topk_spmv_bucket_device,
           pkernel.topk_spmv_bucket_batch_device)
    before = [op.launches for op in ops]
    for b in m.buckets:
        words, nreal, kw = _bucket_args(b, gpu)
        tk = dict(kw, slice_base=b.slice_base, codec=codec)
        ks = ops[0](words, table, cfg=cfg, codec=codec, **kw)
        kv, kt = ops[1](words, table, nreal, cfg=cfg, num_groups=1, **tk)
        bv, bt = ops[2](words, tables, nreal, cfg=cfg, **tk)
        pkw = dict(tk, lane_k=lane_k, tie_safe=True)
        torch.cuda.synchronize()
        assert torch.equal(ks, pkernel.bucket_scores_plain(
            words, table, codec=codec, **kw))
        _lanes_equal(kv, kt, *pkernel.bucket_topk_plain(words, table, nreal,
                                                        **pkw))
        _pools_equal(bv, bt, *pkernel.bucket_topk_batch_plain(
            words, tables, nreal, **pkw))
    n = len(m.buckets)
    assert [op.launches - b for op, b in zip(ops, before)] == [n, n, n]
    if BUCKET_CASES[name][3]:
        assert any(b.block_sublanes == b.width for b in m.buckets)
        if codec != "h16":
            assert max(b.width for b in m.buckets) > 512
    assert any(b.num_slices < b.num_blocks * (b.block_sublanes // b.width)
               for b in m.buckets), "a last block holds padding slices"
    if name == "f32_quantum2":
        assert any(b.width % 8 for b in m.buckets)
    if name == "f32_65536_cols":
        limit = torch.cuda.get_device_properties(
            gpu).shared_memory_per_block_optin
        assert pkernel.tables_in_smem(4 * 65536, limit) == 0


def _emulate_bucket_production(words, table, nreal, cfg, kw, nblk):
    """Merged production (non-tie-safe) buffers of a per-bucket Top-K whose
    nblk CUDA blocks (slots) take slices in turn, block j slices j, j +
    nblk, ...: each block folds its real slices in order into fresh
    buffers (distinct sentinels, every slot holding the minimum replaced),
    then one per-lane merge."""
    K, L = cfg.lane_k, 128
    n = min(int(nreal[0, 0]), kw["num_blocks"] * kw["slices_per_block"])
    sc = pkernel._bucket_sums(words, table, width=kw["width"], num_slices=n,
                              codec=kw["codec"], pairs=True)
    tv = torch.from_numpy(pkernel.topk_init(K)).to(words.device).view(
        1, K, 1).expand(nblk, K, L).clone()
    tt = torch.zeros((nblk, K, L), dtype=torch.int32, device=words.device)
    for s0 in range(0, n, nblk):
        m = min(nblk, n - s0)
        score = sc[s0:s0 + m].view(m, 1, L)
        cur = tv[:m].amin(dim=1, keepdim=True)
        rep = (tv[:m] == cur) & (score >= cur)
        tags = (kw["slice_base"] + s0 + torch.arange(
            m, device=words.device, dtype=torch.int32)).view(m, 1, 1)
        tv[:m] = torch.where(rep, score, tv[:m])
        tt[:m] = torch.where(rep, tags.expand(m, K, L), tt[:m])
    return pkernel.merge_lane_topk(tv, tt, K)


@pytest.mark.parametrize("name", ["h16", "f32", "i4s"])
def test_bucket_kernels_non_tie_safe(gpu, bucket_packs, name):
    """K13's and K12's production buffers (tie_safe_topk=False) over every
    bucket against the per-CUDA-block emulation (K13) and K12's plain
    version on its slots (``bucket_topk_batch_slots_plain``: each query's
    runs of 8 slices dealt to the kernel's slots)."""
    cfg, m, qs = bucket_packs(name)
    cfg = dataclasses.replace(cfg, tie_safe_topk=False)
    codec = cfg.query_codec
    table = torch.from_numpy(pack_query_table(qs[0], codec)[0]).to(gpu)
    tables = _slice_tables(cfg, qs[1:], gpu)
    sms = torch.cuda.get_device_properties(gpu).multi_processor_count
    for b in m.buckets:
        words, nreal, kw = _bucket_args(b, gpu)
        tk = dict(kw, slice_base=b.slice_base, codec=codec)
        n = kw["num_blocks"] * kw["slices_per_block"]
        kv, kt = pkernel.topk_spmv_bucket_device(words, table, nreal, cfg=cfg,
                                                 num_groups=1, **tk)
        ev, et = _emulate_bucket_production(words, table, nreal, cfg, tk,
                                            pkernel._bucket_blocks(sms, n))
        _lanes_equal(kv, kt, ev, et)
        bv, bt = pkernel.topk_spmv_bucket_batch_device(words, tables, nreal,
                                                       cfg=cfg, **tk)
        ev, et = _k12_slots_plain(words, tables, nreal, cfg, tk)
        for q in range(len(tables)):
            _lanes_equal(bv[q], bt[q], ev[q], et[q])


def test_bucket_wrappers_refuse_bad_inputs(gpu, bucket_packs):
    """The CUDA wrappers raise on what the kernels do not take: words of
    another length, an h16 table of two rows, a num_real of another
    shape, an unbuilt lane_k."""
    cfg, m, qs = bucket_packs("h16")
    b = m.buckets[-1]
    words, nreal, kw = _bucket_args(b, gpu)
    table = torch.from_numpy(pack_query_table(qs[0], "h16")[0]).to(gpu)
    tk = dict(kw, slice_base=b.slice_base, codec="h16")
    with pytest.raises(ValueError, match="words"):
        pkernel.topk_spmv_bucket_device(words[:-1], table, nreal, cfg=cfg,
                                        num_groups=1, **tk)
    with pytest.raises(ValueError, match="h16 table"):
        pkernel.spmv_bucket_scores_device(words, table.repeat(2, 1), cfg=cfg,
                                          codec="h16", **kw)
    with pytest.raises(ValueError, match="num_real"):
        pkernel.topk_spmv_bucket_device(words, table, nreal.view(1), cfg=cfg,
                                        num_groups=1, **tk)
    with pytest.raises(ValueError, match="lane_k"):
        pkernel.topk_spmv_bucket_device(
            words, table, nreal, cfg=dataclasses.replace(cfg, lane_k=12),
            num_groups=1, **tk)


# ------------------------------------------- K13's grid and its card merge
# K13 returns its final pair from one launch: its slots' buffers merge on
# the card (csrc/bucket_topk.cu). bucket_topk_slots_plain computes what it
# gives on the kernel's slots, tags and ties included, so the kernel is
# held to it bit for bit, tie-safe or not, on grids forced to 1 and 3
# blocks and on the default wave; tie-safe, to bucket_topk_plain too.

def _k13(words, table, nreal, cfg, tk, **kw):
    return pkernel.topk_spmv_bucket_device(words, table, nreal, cfg=cfg,
                                           num_groups=1, **tk, **kw)


def _k13_slots(words, table, cfg, tk, cuda_blocks=None):
    """The slots K13 runs on for this bucket and grid."""
    arg, _ = pkernel._kernel_codec(words.device, tk["codec"],
                                   table.shape[0])
    n = tk["num_blocks"] * tk["slices_per_block"]
    return pkernel._bucket_topk_slots(words.device, arg, cfg.lane_k,
                                      table.shape[0], n, cuda_blocks)


def _k13_agree(words, table, nreal, cfg, tk, cuda_blocks=None):
    kv, kt = _k13(words, table, nreal, cfg, tk, cuda_blocks=cuda_blocks)
    pkw = dict(tk, lane_k=cfg.lane_k, tie_safe=bool(cfg.tie_safe_topk))
    sv, st = pkernel.bucket_topk_slots_plain(
        words, table, nreal, num_slots=_k13_slots(
            words, table, cfg, tk, cuda_blocks), **pkw)
    torch.cuda.synchronize()
    assert torch.equal(kv, sv) and torch.equal(kt, st)
    if cfg.tie_safe_topk:
        _lanes_equal(kv, kt, *pkernel.bucket_topk_plain(words, table, nreal,
                                                        **pkw))
    return kv, kt


@pytest.mark.parametrize("tie_safe", [True, False], ids=["tie_safe",
                                                         "production"])
@pytest.mark.parametrize("grid", [1, 3, None], ids=["1", "3", "wave"])
@pytest.mark.parametrize("name", list(BUCKET_CASES))
def test_bucket_topk_merge_on_the_card(gpu, bucket_packs, name, grid,
                                       tie_safe):
    """K13 over every bucket, on 1, 3 and a wave of CUDA blocks, equal to
    its plain version on the kernel's slots, bit for bit; the h16 buckets
    are full of ties."""
    cfg, m, qs = bucket_packs(name)
    cfg = dataclasses.replace(cfg, tie_safe_topk=tie_safe)
    codec = cfg.query_codec
    table = torch.from_numpy(pack_query_table(qs[0], codec)[0]).to(gpu)
    before = pkernel.topk_spmv_bucket_device.launches
    for b in m.buckets:
        words, nreal, kw = _bucket_args(b, gpu)
        _k13_agree(words, table, nreal, cfg,
                   dict(kw, slice_base=b.slice_base, codec=codec), grid)
    assert pkernel.topk_spmv_bucket_device.launches - before == len(
        m.buckets)


def test_bucket_topk_back_to_back(gpu, bucket_packs):
    """50 launches in a row on one workspace and its tickets give the same
    pair each time (each launch's last blocks reset the tickets), on the
    largest bucket and on a wave forced to 3 blocks; then every bucket's
    launch in turn, 10 rounds with nothing between the launches (each
    overlapping the one before), give each bucket's pair of a launch
    alone (a synchronize after each: nothing to overlap)."""
    cfg, m, qs = bucket_packs("f32")
    table = torch.from_numpy(pack_query_table(qs[0], "f32")[0]).to(gpu)
    b = max(m.buckets, key=lambda b: b.num_blocks * b.block_sublanes)
    words, nreal, kw = _bucket_args(b, gpu)
    tk = dict(kw, slice_base=b.slice_base, codec="f32")
    for grid in (None, 3):
        first = _k13_agree(words, table, nreal, cfg, tk, grid)
        runs = [_k13(words, table, nreal, cfg, tk, cuda_blocks=grid)
                for _ in range(50)]
        torch.cuda.synchronize()
        for v, t in runs:
            assert torch.equal(v, first[0]) and torch.equal(t, first[1])
    args = []
    for b in m.buckets:
        words, nreal, kw = _bucket_args(b, gpu)
        args.append((words, nreal, dict(kw, slice_base=b.slice_base,
                                        codec="f32")))
    alone = []
    for words, nreal, tk in args:
        alone.append(_k13(words, table, nreal, cfg, tk))
        torch.cuda.synchronize()
    runs = [[_k13(words, table, nreal, cfg, tk) for words, nreal, tk in args]
            for _ in range(10)]
    torch.cuda.synchronize()
    for run in runs:
        for (v, t), (av, at) in zip(run, alone):
            assert torch.equal(v, av) and torch.equal(t, at)


@pytest.mark.parametrize("tie_safe", [True, False], ids=["tie_safe",
                                                         "production"])
@pytest.mark.parametrize("name", ["h16", "f32", "f32_65536_cols"])
def test_bucket_topk_num_real(gpu, bucket_packs, name, tie_safe):
    """num_real of 0 (every lane keeps its initial entries), 1 and all of
    the bucket's slices, read on the card; the padding slices past the
    real count stay out."""
    cfg, m, qs = bucket_packs(name)
    cfg = dataclasses.replace(cfg, tie_safe_topk=tie_safe)
    codec = cfg.query_codec
    table = torch.from_numpy(pack_query_table(qs[0], codec)[0]).to(gpu)
    b = max(m.buckets, key=lambda b: b.num_blocks * b.block_sublanes)
    words, _, kw = _bucket_args(b, gpu)
    tk = dict(kw, slice_base=b.slice_base, codec=codec)
    n = kw["num_blocks"] * kw["slices_per_block"]
    for real in (0, 1, b.num_slices, n):
        nreal = torch.tensor([[real]], dtype=torch.int32, device=gpu)
        kv, kt = _k13_agree(words, table, nreal, cfg, tk)
        if real == 0:
            assert (kv == float("-inf")).all() if tie_safe else \
                (kv <= pkernel.TOPK_FLOOR).all()
            assert not kt.any()


# ------------------------------------------ K12 and K11 on K13's design
# K12 reads each bucket once a pass of 8 or 16 queries and returns its
# final pairs from one launch a bucket, its lane merge on the card
# (csrc/bucket_topk_batch.cuh); bucket_topk_batch_slots_plain computes
# what it gives on the kernel's slots, tags and ties included. K11 sums
# with K13's sweep. Both are programmatic dependent launches, as K13 is.

def _k12(words, tables, nreal, cfg, tk):
    return pkernel.topk_spmv_bucket_batch_device(words, tables, nreal,
                                                 cfg=cfg, **tk)


def _k12_slots_plain(words, tables, nreal, cfg, tk, merged=True):
    """K12's plain version on the slots its kernel runs on this bucket."""
    n = tk["num_blocks"] * tk["slices_per_block"]
    *_, slots = pkernel.k12_launch(words.device, tk["codec"],
                                   tables.shape[0], cfg.lane_k,
                                   tables.shape[1], n)
    return pkernel.bucket_topk_batch_slots_plain(
        words, tables, nreal, lane_k=cfg.lane_k,
        tie_safe=bool(cfg.tie_safe_topk), num_slots=slots, merged=merged,
        **tk)


K12_SHAPES = [(1, 8), (5, 4), (5, 8), (5, 16), (33, 8)]


@pytest.mark.parametrize("tie_safe", [True, False], ids=["tie_safe",
                                                         "production"])
@pytest.mark.parametrize("Q,lane_k", K12_SHAPES,
                         ids=[f"q{q}_k{k}" for q, k in K12_SHAPES])
@pytest.mark.parametrize("name", list(BUCKET_CASES))
def test_k12_matches_slots_plain(gpu, bucket_packs, name, Q, lane_k,
                                 tie_safe):
    """K12 over every bucket equal to its plain version on the kernel's
    slots, bit for bit, tags included, merged on the card and the
    unmerged launch's sorted slots: 1, 5 and 33 queries (passes of 8 and
    16, the last of one query), lane_k 4, 8 and 16, every codec, quantum
    2, a bucket of one slice per block, f32 and int8x4 at 65,536 columns
    (tables in global memory); one launch a bucket."""
    cfg, m, _ = bucket_packs(name)
    cfg = dataclasses.replace(cfg, tie_safe_topk=tie_safe, lane_k=lane_k)
    codec = cfg.query_codec
    tables = _slice_tables(cfg, create_query_batch(
        Q, BUCKET_CASES[name][1], seed=46), gpu)
    before = pkernel.topk_spmv_bucket_batch_device.launches
    for b in m.buckets:
        words, nreal, kw = _bucket_args(b, gpu)
        tk = dict(kw, slice_base=b.slice_base, codec=codec)
        kv, kt = _k12(words, tables, nreal, cfg, tk)
        uv, ut = pkernel._bucket_topk_batch_cuda(
            words, tables, nreal, lane_k=lane_k, tie_safe=tie_safe,
            unmerged=True, **tk)
        pv, pt_ = _k12_slots_plain(words, tables, nreal, cfg, tk)
        sv, st = _k12_slots_plain(words, tables, nreal, cfg, tk,
                                  merged=False)
        torch.cuda.synchronize()
        assert kv.shape == (Q, lane_k, 128)
        assert torch.equal(kv, pv) and torch.equal(kt, pt_)
        assert torch.equal(uv, sv) and torch.equal(ut, st)
    assert pkernel.topk_spmv_bucket_batch_device.launches - before == \
        2 * len(m.buckets)


@pytest.mark.parametrize("name", ["h16", "f32", "int8x4", "i8s", "i4s"])
def test_k12_merges_on_the_card(gpu, bucket_packs, name, monkeypatch):
    """K12 returns its merged pairs from its one launch a bucket: with
    ``torch.topk`` and ``merge_lane_topk`` made to raise, the wrapper
    still gives the slot plain's pairs, and its counter counts one
    launch a bucket."""
    cfg, m, qs = bucket_packs(name)
    cfg = dataclasses.replace(cfg, tie_safe_topk=False)
    codec = cfg.query_codec
    tables = _slice_tables(cfg, qs, gpu)
    args, want = [], []
    for b in m.buckets:
        words, nreal, kw = _bucket_args(b, gpu)
        tk = dict(kw, slice_base=b.slice_base, codec=codec)
        args.append((words, nreal, tk))
        want.append(_k12_slots_plain(words, tables, nreal, cfg, tk))

    def refuse(*a, **k):
        raise AssertionError("a torch merge ran on K12's path")

    monkeypatch.setattr(torch, "topk", refuse)
    monkeypatch.setattr(pkernel, "merge_lane_topk", refuse)
    before = pkernel.topk_spmv_bucket_batch_device.launches
    got = [_k12(words, tables, nreal, cfg, tk) for words, nreal, tk in args]
    torch.cuda.synchronize()
    monkeypatch.undo()
    assert pkernel.topk_spmv_bucket_batch_device.launches - before == \
        len(m.buckets)
    for (kv, kt), (pv, pt_) in zip(got, want):
        assert torch.equal(kv, pv) and torch.equal(kt, pt_)


def test_k12_back_to_back(gpu, bucket_packs):
    """50 launches in a row on the largest bucket (one workspace and its
    tickets, each launch's last blocks resetting them) give the same pairs
    each time; then every bucket's launch in turn, 10 rounds with nothing
    between the launches (each overlapping the one before), give each
    bucket's pairs of a launch alone."""
    cfg, m, qs = bucket_packs("f32")
    cfg = dataclasses.replace(cfg, tie_safe_topk=False)
    tables = _slice_tables(cfg, qs, gpu)
    args = []
    for b in m.buckets:
        words, nreal, kw = _bucket_args(b, gpu)
        args.append((words, nreal, dict(kw, slice_base=b.slice_base,
                                        codec="f32")))
    big = max(args, key=lambda a: a[0].shape[0])
    first = _k12(big[0], tables, big[1], cfg, big[2])
    runs = [_k12(big[0], tables, big[1], cfg, big[2]) for _ in range(50)]
    torch.cuda.synchronize()
    for v, t in runs:
        assert torch.equal(v, first[0]) and torch.equal(t, first[1])
    alone = []
    for words, nreal, tk in args:
        alone.append(_k12(words, tables, nreal, cfg, tk))
        torch.cuda.synchronize()
    runs = [[_k12(words, tables, nreal, cfg, tk)
             for words, nreal, tk in args] for _ in range(10)]
    torch.cuda.synchronize()
    for run in runs:
        for (v, t), (av, at) in zip(run, alone):
            assert torch.equal(v, av) and torch.equal(t, at)


@pytest.mark.parametrize("name", ["h16", "f32", "f32_65536_cols"])
def test_k11_back_to_back(gpu, bucket_packs, name):
    """K11 over every bucket, 10 rounds with nothing between the launches
    (each overlapping the one before), bit for bit its plain version's
    scores; then K13, K12 and K11 interleaved bucket by bucket, 5 rounds,
    each equal to its launch alone."""
    cfg, m, qs = bucket_packs(name)
    codec = cfg.query_codec
    table = torch.from_numpy(pack_query_table(qs[0], codec)[0]).to(gpu)
    tables = _slice_tables(cfg, qs[1:], gpu)
    args = []
    for b in m.buckets:
        words, nreal, kw = _bucket_args(b, gpu)
        args.append((words, nreal, kw))

    def k11(words, kw):
        return pkernel.spmv_bucket_scores_device(words, table, cfg=cfg,
                                                 codec=codec, **kw)

    def three(words, nreal, kw):
        tk = dict(kw, slice_base=0, codec=codec)
        return (pkernel.topk_spmv_bucket_device(words, table, nreal, cfg=cfg,
                                                num_groups=1, **tk),
                _k12(words, tables, nreal, cfg, tk), k11(words, kw))

    want = [pkernel.bucket_scores_plain(words, table, codec=codec, **kw)
            for words, _, kw in args]
    runs = [[k11(words, kw) for words, _, kw in args] for _ in range(10)]
    torch.cuda.synchronize()
    for run in runs:
        for got, w in zip(run, want):
            assert torch.equal(got, w)
    alone = []
    for a in args:
        alone.append(three(*a))
        torch.cuda.synchronize()
    runs = [[three(*a) for a in args] for _ in range(5)]
    torch.cuda.synchronize()
    for run in runs:
        for got, a in zip(run, alone):
            (kv, kt), (bv, bt), ks = got
            (av, at), (cv, ct), s = a
            assert torch.equal(kv, av) and torch.equal(kt, at)
            assert torch.equal(bv, cv) and torch.equal(bt, ct)
            assert torch.equal(ks, s)


# ------------------------------------------------ a slice that scores NaN
# The kernels never admit a NaN score, and a NaN member of an octet or a
# sub-tile keeps that harvest's other members out, as the JAX kernels'
# jnp.max does; the plain versions follow both (tests/test_torch_kernel.py
# holds them to the interpret-mode JAX kernels on the same stream). Here
# the kernels against the plain versions on that stream: integer-valued
# data with query entries NaN, +inf and -inf read by a few rows only.

NAN_COLS = (1021, 1022, 1023)
NAN_BASE = dict(k=100, lane_k=8, max_cols=1024, query_codec="f32",
                width_quantum=2, tie_safe_topk=True, block_sublanes=64,
                fused_block_sublanes=128, batch_subgroup=2)


def _nan_corpus(rows=1200, seed=5):
    """tests/test_torch_kernel.py::nan_corpus as a CooMatrix."""
    from spmv_topk_tpu_torch.formats import CooMatrix

    coo = create_sparse_matrix(rows, 1024, 20, "gamma", seed=seed)
    rng = np.random.default_rng(seed + 1)
    cols = np.where(coo.cols >= NAN_COLS[0], coo.cols - 3, coo.cols)
    vals = rng.integers(-8, 9, coo.nnz).astype(np.float32)
    picked = rng.choice(rows, 40, replace=False)
    extra = ([(r, NAN_COLS[0]) for r in picked[:12]]
             + [(r, c) for r in picked[12:24] for c in NAN_COLS[1:]]
             + [(r, NAN_COLS[1]) for r in picked[24:32]]
             + [(r, NAN_COLS[2]) for r in picked[32:]])
    er, ec = (np.array(x, np.int32) for x in zip(*extra))
    r = np.concatenate([coo.rows, er])
    c = np.concatenate([cols, ec])
    v = np.concatenate([vals, np.full(len(er), 2.0, np.float32)])
    order = np.lexsort((c, r))
    return CooMatrix(r[order], c[order], v[order], rows, 1024)


def _nan_tables(num):
    q = np.random.default_rng(9).integers(-4, 5, (num, 1024)).astype(
        np.float32)
    q[:, NAN_COLS[0]] = np.nan
    q[:, NAN_COLS[1]] = np.inf
    q[:, NAN_COLS[2]] = -np.inf
    return q.reshape(num, 8, 128)


@pytest.mark.parametrize("layout,fold", [("octet", 8), ("octet", 1),
                                         ("slice", 8), ("slice", 1)])
def test_kernels_rank_nan_as_plain(gpu, layout, fold):
    from spmv_topk_tpu_torch.formats.sell_buckets import (
        fuse_buckets, fuse_buckets_octet, pack_sell_buckets)

    cfg = pt.TopKSpMVConfig(**dict(NAN_BASE, fused_layout=layout,
                                   fold_tile=fold))
    octet = layout == "octet"
    f = (fuse_buckets_octet if octet else fuse_buckets)(
        pack_sell_buckets(_nan_corpus(), cfg), block_sublanes=128)
    rows = (pkernel.octet_plan_rows(f.plan, f.num_blocks) if octet else
            pkernel.slice_plan_rows(f.plan, f.num_blocks, f.nreal, 128))
    words, nreal, rows = (torch.from_numpy(a).to(gpu)
                          for a in (f.words, f.nreal, rows))
    tabs = torch.from_numpy(_nan_tables(3)).to(gpu)
    single = (pkernel.topk_spmv_fused_octet_device if octet
              else pkernel.topk_spmv_fused_device)
    batch = (pkernel.topk_spmv_fused_batch_octet_device if octet
             else pkernel.topk_spmv_fused_batch_device)
    kw = dict(lane_k=8, tie_safe=True, block_sublanes=128, codec="f32")
    kv, kt = single(words, tabs[0], nreal, rows, cfg=cfg, block_sublanes=128)
    pv, pt_ = (pkernel.octet_topk_plain if octet else
               pkernel.slice_topk_plain)(words, tabs[0], nreal, rows,
                                         fold_tile=fold, **kw)
    torch.cuda.synchronize()
    assert not torch.isnan(kv).any() and (kv == np.inf).any()
    _lanes_equal(kv, kt, pv, pt_)
    bv, bt = batch(words, tabs, nreal, rows, cfg=cfg, block_sublanes=128)
    if octet:
        kw["fold_tile"] = fold
    qv, qt = (pkernel.octet_topk_batch_plain if octet else
              pkernel.slice_topk_batch_plain)(words, tabs, nreal, rows, **kw)
    torch.cuda.synchronize()
    assert not torch.isnan(bv).any()
    _pools_equal(bv, bt, qv, qt)


# ---------------------------------------------------------------- the labs
# The measurement labs' kernels (csrc/lab_*.cu) against their plain
# versions on the labs' own random words (NaN, inf and denormal values,
# gather fields past 127, shift amounts past 31) and, for the float labs,
# on them with integer, real and tiny values (experiments/_common.py::
# with_values; tiny values make the flush of denormals decide the scores):
# values bit-equal with NaN where NaN, (value, tag) pairs equal above each
# lane's smallest kept value; fold_lab's nofold bit-equal slot for slot.
# Three geometries: one of a single chunk a slice, and one on 3 CUDA blocks
# (``blocks``), each folding 16-17 lab blocks into one buffer, as the
# kernels do at full size (4096 lab blocks on 1056 CUDA blocks).

from spmv_topk_tpu_torch.experiments import _common as lab_data  # noqa: E402
from spmv_topk_tpu_torch.experiments import (fold_lab, fused_lab,  # noqa: E402
                                             h16_lab, kernel_lab)

LAB_GEOMS = {"w32": dict(W=32, SPB=16, NB=40), "w8": dict(W=8, SPB=4, NB=300),
             "strided": dict(W=24, SPB=4, NB=50, blocks=3)}


LAB_DATA = ("lab", *lab_data.CHECK_KINDS)


def _lab_kernel_inputs(dev, g, data="lab"):
    words, table, table_i = lab_data.kernel_lab_data(g["NB"],
                                                     g["W"] * g["SPB"], seed=5)
    if data != "lab":
        words, table_i, table = lab_data.with_values(data, words, table_i,
                                                     table, seed=6)
    return (torch.from_numpy(words).to(dev),
            kernel_lab.lab_tables(table, table_i, dev))


@pytest.mark.parametrize("data", LAB_DATA)
@pytest.mark.parametrize("geom", list(LAB_GEOMS))
@pytest.mark.parametrize("fold", kernel_lab.FOLDS)
@pytest.mark.parametrize("variant", list(kernel_lab.VARIANTS))
def test_kernel_lab_matches_plain(gpu, variant, fold, geom, data):
    g = LAB_GEOMS[geom]
    words, tabs = _lab_kernel_inputs(gpu, g, data)
    kw = dict(variant=variant, fold=fold, W=g["W"], SPB=g["SPB"])
    before = kernel_lab.kernel_lab_device.launches
    kv, kt = kernel_lab.kernel_lab_device(words, tabs[variant],
                                          blocks=g.get("blocks"), **kw)
    assert kernel_lab.kernel_lab_device.launches == before + 1
    pv, pt_ = kernel_lab.kernel_lab_plain(words, tabs[variant], **kw)
    torch.cuda.synchronize()
    _lanes_equal(kv, kt, pv, pt_)


@pytest.mark.parametrize("data", LAB_DATA)
@pytest.mark.parametrize("geom", list(LAB_GEOMS))
@pytest.mark.parametrize("fold", fused_lab.FOLDS)
@pytest.mark.parametrize("variant", fused_lab.MODES)
def test_fused_lab_matches_plain(gpu, variant, fold, geom, data):
    """Ragged counts: v_smem and v_branch mask slices."""
    g = LAB_GEOMS[geom]
    words, table, _ = lab_data.fused_lab_data(g["NB"], g["W"] * g["SPB"],
                                              g["SPB"], 3, seed=6)
    if data != "lab":
        words, table, _ = lab_data.with_values(data, words, table, seed=7)
    per = g["NB"] // 3
    nreal = np.array([[g["NB"] * g["SPB"] - 7], [per * g["SPB"] - 3],
                      [per * g["SPB"] + 1]], np.int32)
    args = [torch.from_numpy(a).to(gpu) for a in (words, table, nreal)]
    kw = dict(variant=variant, fold=fold, W=g["W"], SPB=g["SPB"])
    before = fused_lab.fused_lab_device.launches
    kv, kt = fused_lab.fused_lab_device(*args, blocks=g.get("blocks"), **kw)
    assert fused_lab.fused_lab_device.launches == before + 1
    pv, pt_ = fused_lab.fused_lab_plain(*args, **kw)
    torch.cuda.synchronize()
    _lanes_equal(kv, kt, pv, pt_)


def test_fused_lab_v_prod_matches_plain(gpu):
    """v_prod is K7 (int8x4, not tie-safe) on the lab's three-bucket plan:
    against K7's plain version on finite values (the plain version ranks
    a NaN score first, the kernel never admits one)."""
    g = LAB_GEOMS["w32"]
    words, table, nreal = lab_data.fused_lab_data(g["NB"], g["W"] * g["SPB"],
                                                  g["SPB"], 3, seed=7)
    words = words & np.int32(~0x4000)         # exponents below 128: finite
    args = [torch.from_numpy(a).to(gpu) for a in (words, table, nreal)]
    before = pkernel.topk_spmv_fused_device.launches
    kv, kt = fused_lab.fused_lab_device(*args, variant="v_prod")
    assert pkernel.topk_spmv_fused_device.launches == before + 1
    pv, pt_ = fused_lab.fused_lab_plain(*args, variant="v_prod")
    torch.cuda.synchronize()
    _lanes_equal(kv, kt, pv, pt_)


@pytest.mark.parametrize("geom", list(LAB_GEOMS))
@pytest.mark.parametrize("variant", list(h16_lab.VARIANTS))
def test_h16_lab_matches_plain(gpu, variant, geom):
    g = LAB_GEOMS[geom]
    words, table = (torch.from_numpy(a).to(gpu) for a in
                    lab_data.h16_lab_data(g["NB"], g["W"] * g["SPB"], seed=8))
    kw = dict(variant=variant, W=g["W"], SPB=g["SPB"])
    before = h16_lab.h16_lab_device.launches
    kv, kt = h16_lab.h16_lab_device(words, table, blocks=g.get("blocks"),
                                    **kw)
    assert h16_lab.h16_lab_device.launches == before + 1
    pv, pt_ = h16_lab.h16_lab_plain(words, table, **kw)
    torch.cuda.synchronize()
    _lanes_equal(kv, kt, pv, pt_)


@pytest.mark.parametrize("cut", [0, 5, 10**6], ids=["all", "ragged", "past"])
@pytest.mark.parametrize("geom", list(LAB_GEOMS))
@pytest.mark.parametrize("variant", fold_lab.VARIANTS)
def test_fold_lab_matches_plain(gpu, variant, geom, cut):
    """limit = every slice, all but 5 (the last lab block cut), or past
    the end."""
    g = LAB_GEOMS[geom]
    words, table = (torch.from_numpy(a).to(gpu) for a in
                    lab_data.h16_lab_data(g["NB"], g["W"] * g["SPB"], seed=9))
    limit = g["NB"] * g["SPB"] - cut if cut < 10**6 else cut
    kw = dict(variant=variant, W=g["W"], SPB=g["SPB"])
    before = fold_lab.fold_lab_device.launches
    kv, kt = fold_lab.fold_lab_device(words, table, limit,
                                      blocks=g.get("blocks"), **kw)
    assert fold_lab.fold_lab_device.launches == before + 1
    pv, pt_ = fold_lab.fold_lab_plain(words, table, limit, **kw)
    torch.cuda.synchronize()
    if variant == "nofold":
        assert torch.equal(kv, pv) and torch.equal(kt, pt_)
    else:
        _lanes_equal(kv, kt, pv, pt_)


def test_lab_unmerged_buffers_merge_to_the_wrapper(gpu):
    """``unmerged`` returns one buffer a CUDA block (what the labs time as
    the kernel alone); merged per lane they are the wrapper's result."""
    g = LAB_GEOMS["strided"]
    words, tabs = _lab_kernel_inputs(gpu, g, "real")
    kw = dict(variant="int8", fold="exact", W=g["W"], SPB=g["SPB"],
              blocks=g["blocks"])
    bv, bt = kernel_lab.kernel_lab_device(words, tabs["int8"], unmerged=True,
                                          **kw)
    assert bv.shape == bt.shape == (g["blocks"], 8, 128)
    kv, kt = kernel_lab.kernel_lab_device(words, tabs["int8"], **kw)
    mv, mt = lab_data.merge(bv, bt)
    torch.cuda.synchronize()
    assert torch.equal(mv, kv) and torch.equal(mt, kt)
    hw, ht = (torch.from_numpy(a).to(gpu) for a in
              lab_data.h16_lab_data(g["NB"], g["W"] * g["SPB"], seed=9))
    limit = g["NB"] * g["SPB"] - 5
    fv, _ = fold_lab.fold_lab_device(hw, ht, limit, variant="nofold",
                                     W=g["W"], SPB=g["SPB"], blocks=3,
                                     unmerged=True)
    nv, _ = fold_lab.fold_lab_device(hw, ht, limit, variant="nofold",
                                     W=g["W"], SPB=g["SPB"], blocks=3)
    torch.cuda.synchronize()
    assert torch.equal(fv[(limit - 1) // g["SPB"] % 3], nv)


def test_lab_wrappers_refuse_bad_inputs(gpu):
    g = LAB_GEOMS["w8"]
    words, tabs = _lab_kernel_inputs(gpu, g)
    kw = dict(W=g["W"], SPB=g["SPB"])
    with pytest.raises(ValueError, match="chunks of 8"):
        kernel_lab.kernel_lab_device(words, tabs["int8"], variant="int8",
                                     S=4, **kw)
    with pytest.raises(ValueError, match="table"):
        kernel_lab.kernel_lab_device(words, tabs["int8"].float(),
                                     variant="int8", **kw)
    with pytest.raises(ValueError, match="words"):
        h16_lab.h16_lab_device(words[:-8], tabs["h16"], variant="cur", **kw)


# --------------------------------------------------- the labs L1, L2, L6, L8
# batch_lab, dma_lab, i16_probe and mxu_gather_lab: each kernel against its
# plain version, bit for bit (integer sums; dma_lab's float sum in the
# kernel's order of its CUDA blocks), on the labs' own data and for
# dma_lab on check values, in two geometries and on 3 CUDA blocks.

from spmv_topk_tpu_torch.experiments import (batch_lab, dma_lab,  # noqa: E402
                                             i16_probe, mxu_gather_lab)

BATCH_GEOMS = {"w16": dict(W=16, SPB=64, NB=20, Q=16),
               "w8": dict(W=8, SPB=9, NB=50, Q=4),
               "strided": dict(W=24, SPB=12, NB=30, Q=16, blocks=3)}


@pytest.mark.parametrize("geom", list(BATCH_GEOMS))
@pytest.mark.parametrize("variant", list(batch_lab.VARIANTS))
def test_batch_lab_matches_plain(gpu, variant, geom):
    """Values and tags equal slot for slot: the merge keeps the last slice
    holding each query's maximum, as the sequential fold does."""
    g = BATCH_GEOMS[geom]
    words, tables = (torch.from_numpy(a).to(gpu) for a in
                     lab_data.batch_lab_data(g["NB"], g["W"] * g["SPB"],
                                             g["Q"], seed=11))
    kw = dict(variant=variant, W=g["W"], SPB=g["SPB"])
    before = batch_lab.batch_lab_device.launches
    kv, kt = batch_lab.batch_lab_device(words, tables,
                                        blocks=g.get("blocks"), **kw)
    assert batch_lab.batch_lab_device.launches == before + 1
    pv, pt_ = batch_lab.batch_lab_plain(words, tables, **kw)
    torch.cuda.synchronize()
    assert kv.shape == (g["Q"], 8, 128)
    assert torch.equal(kv, pv) and torch.equal(kt, pt_)
    assert torch.isfinite(kv[0]).all()


DMA_GEOMS = {"default": dict(total=4 * 8192), "strided": dict(
    total=2 * 8192, blocks=3)}


@pytest.mark.parametrize("data", LAB_DATA)
@pytest.mark.parametrize("geom", list(DMA_GEOMS))
@pytest.mark.parametrize("case", dma_lab.CASES,
                         ids=[dma_lab.name(*c) for c in dma_lab.CASES])
def test_dma_lab_matches_plain(gpu, case, geom, data):
    g = DMA_GEOMS[geom]
    words, table = lab_data.dma_lab_data(g["total"], seed=12)
    if data != "lab":
        words, table = dma_lab.check_data(data, words, seed=13)
    words, table = (torch.from_numpy(a).to(gpu) for a in (words, table))
    bs, t = case
    nblk = lab_data.cuda_blocks(gpu, g["total"] // bs, g.get("blocks"))
    before = dma_lab.dma_lab_device.launches
    got = dma_lab.dma_lab_device(words, table, bs=bs, t=t,
                                 blocks=g.get("blocks"))
    assert dma_lab.dma_lab_device.launches == before + 1
    part = dma_lab.dma_lab_device(words, table, bs=bs, t=t,
                                  blocks=g.get("blocks"), unmerged=True)
    want = dma_lab.dma_lab_plain(words, table, bs=bs, t=t, blocks=nblk)
    torch.cuda.synchronize()
    assert part.shape == (nblk, 8, 128)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    if data != "lab":
        assert torch.isfinite(got).all()


I16_GEOMS = {"small": dict(NB=8, SUB32=64),
             "strided": dict(NB=20, SUB32=32, blocks=3)}


@pytest.mark.parametrize("geom", list(I16_GEOMS))
@pytest.mark.parametrize("variant", i16_probe.VARIANTS)
def test_i16_probe_matches_plain(gpu, variant, geom):
    g = I16_GEOMS[geom]
    w32, w16, t32, t16 = (torch.from_numpy(a).to(gpu) for a in
                          lab_data.i16_probe_data(g["NB"], g["SUB32"],
                                                  seed=14))
    words, table = (w32, t32) if "32" in variant else (w16, t16)
    salt = (torch.arange(128, device=gpu) * 37 - 2000).to(
        words.dtype).reshape(1, 128)
    kw = dict(variant=variant, sub32=g["SUB32"])
    before = i16_probe.i16_probe_device.launches
    got = i16_probe.i16_probe_device(words, table, salt,
                                     blocks=g.get("blocks"), **kw)
    assert i16_probe.i16_probe_device.launches == before + 1
    want = i16_probe.i16_probe_plain(words, table, salt, **kw)
    torch.cuda.synchronize()
    assert got.dtype == words.dtype and torch.equal(got, want)


MXU_GEOMS = {"lab": dict(REPS=32, Q=16), "strided": dict(REPS=64, Q=4,
                                                          blocks=3)}


@pytest.mark.parametrize("geom", list(MXU_GEOMS))
def test_mxu_gather_lab_matches_plain(gpu, geom):
    g = MXU_GEOMS[geom]
    words, tables, tabq = (torch.from_numpy(a).to(gpu) for a in
                           lab_data.mxu_lab_data(g["REPS"], g["Q"], seed=15))
    before = mxu_gather_lab.mxu_vpu_device.launches
    got = mxu_gather_lab.mxu_vpu_device(words, tables, blocks=g.get("blocks"))
    assert mxu_gather_lab.mxu_vpu_device.launches == before + 1
    want = mxu_gather_lab.mxu_vpu_plain(words, tables)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    # the one-hot arm: plain torch on either device, one nonzero product
    # an output, so the card's matmul equals the CPU's
    torch.backends.cuda.matmul.allow_tf32 = False
    oh = mxu_gather_lab.mxu_onehot(words, tabq)
    np.testing.assert_array_equal(
        oh.cpu().numpy(),
        mxu_gather_lab.mxu_onehot(words.cpu(), tabq.cpu()).numpy())


@pytest.mark.parametrize("blocks", [None, 3, 1])
@pytest.mark.parametrize("Q", [4, 16])
@pytest.mark.parametrize("chunks", [32, 64, 512, 1000])
def test_mxu_one_launch_merges_on_the_card(gpu, chunks, Q, blocks):
    """L8's call is one launch returning the (Q, 128) result, bit for bit
    ``mxu_vpu_plain``, on its default grid (1000 chunks: 8000 rows that
    the wave's blocks do not divide) and on 3 and 1 blocks; two calls back
    to back, so that a counter the kernel left set would show."""
    words, tables, _ = (torch.from_numpy(a).to(gpu) for a in
                        lab_data.mxu_lab_data(chunks, Q, seed=chunks + Q))
    want = mxu_gather_lab.mxu_vpu_plain(words, tables)
    for _ in range(2):
        before = mxu_gather_lab.mxu_vpu_device.launches
        got = mxu_gather_lab.mxu_vpu_device(words, tables, blocks=blocks)
        assert mxu_gather_lab.mxu_vpu_device.launches == before + 1
        torch.cuda.synchronize()
        assert got.shape == (Q, 128) and got.dtype == torch.float32
        assert torch.equal(got, want)
    stream = torch.cuda.current_stream(gpu).cuda_stream
    assert not mxu_gather_lab._workspace(gpu, stream, Q).any()


def test_labs2_wrappers_refuse_bad_inputs(gpu):
    words, tables = (torch.from_numpy(a).to(gpu) for a in
                     lab_data.batch_lab_data(2, 16 * 8, 3, seed=1))
    with pytest.raises(ValueError, match="Q=3"):
        batch_lab.batch_lab_device(words, tables, variant="cur", W=16, SPB=8)
    with pytest.raises(ValueError, match="tables"):
        batch_lab.batch_lab_device(words, tables.float(), variant="cur",
                                   W=16, SPB=8)
    with pytest.raises(ValueError, match="BS"):
        dma_lab.dma_lab_device(words, torch.ones((1, 128), device=gpu),
                               bs=1024, t=3)
    with pytest.raises(ValueError, match="words"):
        i16_probe.i16_probe_device(words, words[:8], words[:1],
                                   variant="s16")
    with pytest.raises(ValueError, match="Q=3"):
        mxu_gather_lab.mxu_vpu_device(words, tables)


# ------------------------------------------ L9, the dense and sharded engines

from spmv_topk_tpu_torch.experiments import pack16_lab  # noqa: E402
from spmv_topk_tpu_torch.ops import dense as pdense  # noqa: E402
from spmv_topk_tpu_torch.parallel import (ShardedDenseTopKSpMV,  # noqa: E402
                                          ShardedTopKSpMV, distributed,
                                          make_mesh)


def _bits(t):
    """A tile's bit pattern (NaN-safe equality)."""
    return t.view(torch.int16) if t.element_size() == 2 else \
        t.view(torch.int32)


@pytest.mark.parametrize("grid", [512, 7, 133])
@pytest.mark.parametrize("name", pack16_lab.NAMES)
def test_pack16_kernel_matches_plain(gpu, name, grid):
    """L9 bit for bit: on the lab's tile and on x + 3 (chains that run to
    inf and NaN for the floats, wrap for the integers), at the lab's 512
    copies and at copy counts that leave the grid's warps uneven; every
    copy wrote the same bits into its own tile."""
    x = pack16_lab.pack16_data()[name].to(gpu)
    for xi in (x, x + 3):
        want = pack16_lab.pack16_plain(xi)
        before = pack16_lab.pack16_device.launches
        got = pack16_lab.pack16_device(xi, grid=grid)
        assert pack16_lab.pack16_device.launches == before + 1
        torch.cuda.synchronize()
        assert got.dtype == xi.dtype and torch.equal(_bits(got), _bits(want))
        tiles = got._base
        assert tiles.shape == (grid, *xi.shape)
        assert torch.equal(_bits(tiles), _bits(want).expand_as(_bits(tiles)))


def test_pack16_held_clock(gpu):
    """The diagnostic launch: one block on every SM, a clock the card can
    hold (0.5-2.5 GHz), blocks that start before the first one ends."""
    x = pack16_lab.pack16_data()["int16_16"].to(gpu)
    c = pack16_lab.held_clock(x)
    assert c["held_clock_blocks"] == pack16_lab.pack16_blocks(gpu)
    assert c["held_clock_max_blocks_an_sm"] == 1
    assert 0.5e9 < c["held_clock_hz"] < 2.5e9
    assert 0 <= c["held_clock_last_start_ns"] < c["held_clock_first_end_ns"]
    with pytest.raises(ValueError, match="clocks"):
        pack16_lab.pack16_device(x, clocks=torch.zeros((3, 4),
                                                       dtype=torch.int64,
                                                       device=gpu))


def test_pack16_refuses_other_tiles(gpu):
    with pytest.raises(RuntimeError, match="lab_pack16"):
        pack16_lab.pack16_device(torch.ones((24, 128), device=gpu))
    with pytest.raises(ValueError):
        pack16_lab.pack16_device(torch.ones((8, 128), dtype=torch.float64,
                                            device=gpu))


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_dense_engine_on_card(gpu, dtype):
    """The card's densify equals the NumPy densify bit for bit; its block
    products (cuBLAS bf16 -> f32, int8 -> int32) against the plain
    products (float32 of the bf16 values with TF32 off; exact float64
    integer sums): int8 bit for bit, bf16 to rtol 1e-5 (another order of
    the same exact float32 products)."""
    coo = create_sparse_matrix(5000, 512, 12, "gamma", seed=95)
    qs = create_query_batch(5, 512, seed=96)
    cfg = pt.TopKSpMVConfig(k=40, max_cols=512)
    eng = pt.DenseTopKSpMV(coo, cfg, device=gpu, block_rows=2048,
                           dtype=dtype)
    cpu = pt.DenseTopKSpMV(coo, cfg, device="cpu", block_rows=2048,
                           dtype=dtype)
    if dtype == "int8":
        assert torch.equal(eng._A.cpu(), cpu._A)
        assert torch.equal(eng._scales.cpu(), cpu._scales)
    else:
        assert torch.equal(eng._A.cpu().float(), cpu._A)
    bi, bv = eng.query_batch(qs)
    if dtype == "int8":
        qi, qsc = pdense.quantize_queries_int8(qs, gpu)
        pi, pv = pdense.dense_topk_batch(eng._A, qi, eng.num_rows,
                                         eng._scales, qsc, k=40,
                                         block_rows=2048, plain=True)
        np.testing.assert_array_equal(bv.cpu().numpy(), pv.cpu().numpy())
        oi, ov = cpu.query_batch(qs)        # the CPU engine: the same sums
        np.testing.assert_array_equal(bv.cpu().numpy(), ov.numpy())
    else:
        pi, pv = pdense.dense_topk_batch(
            eng._A, torch.from_numpy(qs).to(gpu), eng.num_rows, k=40,
            block_rows=2048, plain=True)
        np.testing.assert_allclose(bv.cpu().numpy(), pv.cpu().numpy(),
                                   rtol=1e-5, atol=1e-6)
    for j in range(len(qs)):
        kth = float(pv[j, -1]) + 1e-5 * abs(float(pv[j, -1])) + 1e-6
        a, b = bi[j].cpu().numpy(), pi[j].cpu().numpy()
        av, bvv = bv[j].cpu().numpy(), pv[j].cpu().numpy()
        assert set(a[av > kth].tolist()) == set(b[bvv > kth].tolist())
    # Q = 1 pads to 8 rows for torch._int_mm
    i1, v1 = eng.query(qs[0])
    assert i1.shape == (40,) and torch.isfinite(v1).all()


def test_sharded_engines_on_card(gpu):
    """Four shards on one card: the same answers as the CPU mesh (the
    kernels equal their plain versions bit for bit) and, tie-safe, as the
    card's TopKSpMV on four partitions."""
    coo = create_sparse_matrix(8000, 1024, 16, "gamma", seed=97)
    qs = create_query_batch(5, 1024, seed=98)
    for cfg in (dict(HEADLINE, fused_block_sublanes=256),
                dict(k=50, max_cols=1024, fused_block_sublanes=256,
                     num_partitions=2)):
        c = pt.TopKSpMVConfig(**cfg)
        card = ShardedTopKSpMV(coo, c, mesh=make_mesh([gpu] * 4))
        host = ShardedTopKSpMV(coo, c, mesh=make_mesh(["cpu"] * 4))
        for a, b in zip(card.query(qs[0]), host.query(qs[0])):
            assert torch.equal(a.cpu(), b)
        for a, b in zip(card.query_batch(qs, group_size=2),
                        host.query_batch(qs, group_size=2)):
            assert torch.equal(a.cpu(), b)
    dense = ShardedDenseTopKSpMV(coo, pt.TopKSpMVConfig(k=30, max_cols=1024),
                                 mesh=make_mesh([gpu] * 4), dtype="int8")
    one = pt.DenseTopKSpMV(coo, pt.TopKSpMVConfig(k=30, max_cols=1024),
                           device=gpu, dtype="int8")
    np.testing.assert_array_equal(dense.query_batch(qs)[1].cpu().numpy(),
                                  one.query_batch(qs)[1].cpu().numpy())


def test_sharded_nccl_world_of_one(gpu):
    """exchange_skeleton=True over an NCCL group of one process: the
    exchange's collectives run on the card, the answers are unchanged."""
    import socket

    import torch.distributed as dist

    coo = create_sparse_matrix(4000, 1024, 16, "gamma", seed=99)
    q = create_query_batch(1, 1024, seed=100)[0]
    cfg = pt.TopKSpMVConfig(**HEADLINE)
    plain = ShardedTopKSpMV(coo, cfg, mesh=make_mesh([gpu] * 2))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    distributed.initialize_multihost(f"127.0.0.1:{port}", 1, 0,
                                     device_type="cuda")
    try:
        assert dist.get_backend() == "nccl"
        eng = ShardedTopKSpMV(coo, cfg, mesh=make_mesh([gpu] * 2),
                              exchange_skeleton=True)
        for a, b in zip(eng.query(q), plain.query(q)):
            assert torch.equal(a, b)
    finally:
        dist.destroy_process_group()
