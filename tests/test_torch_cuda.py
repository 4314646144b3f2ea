"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Marked ``cuda``; every test skips where torch sees no CUDA device. This
file imports no jax, so it runs on a GPU host without the JAX package
(``--noconftest`` skips tests/conftest.py, which imports jax):

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Kernels: K1 (single-query octet sweep), K6 (multi-query octet sweep),
K4 (octet SpMV) and K3 (stream probe). Tolerances: none. h16 scores are
int32 sums converted to f32 once, so with tie-safe buffers the per-lane
sorted values are bit-equal, and (value, slice) pairs are equal above
each lane's smallest kept value; K4's per-slice scores are bit-equal;
the stream checksum is an exact int32 sum.
"""

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
    """Merged production (non-tie-safe) buffers of a sweep whose nblk
    CUDA blocks each harvest at most one octet into fresh buffers: every
    slot holding the minimum is replaced, from distinct sentinels."""
    gpu = eng.words.device
    rows = eng.plan_rows.tolist()
    n_oct = rows[-1][7] + rows[-1][3]
    assert n_oct <= nblk
    K, L, S = cfg.lane_k, 128, 8
    init = torch.from_numpy(pkernel.topk_init(K)).to(gpu).view(1, K, 1)
    # blocks left without an octet hand in their initial buffers
    bufs_v = [init.expand(nblk - n_oct, K, L)]
    bufs_t = [torch.zeros((nblk - n_oct, K, L), dtype=torch.int32,
                          device=gpu)]
    miota = torch.arange(S, device=gpu).view(1, S, 1)
    for b, row in enumerate(rows):
        G, base = row[3], row[4]
        t = pkernel._octet_tiles(eng.words, row, cfg.fused_block_sublanes, S)
        sc = pkernel.prod_h16(t, table.reshape(-1)).sum(dim=1).float()
        member = torch.arange(G, device=gpu).view(-1, 1, 1) + miota * G
        sc = torch.where(member < int(eng.nreal[b, 0]), sc, float("-inf"))
        tv = init.expand(G, K, L).clone()
        tt = torch.zeros((G, K, L), dtype=torch.int32, device=gpu)
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
        for score, tag in steps:
            cur = tv.amin(dim=1, keepdim=True)
            rep = (tv == cur) & (score >= cur)
            tv = torch.where(rep, score, tv)
            tt = torch.where(rep, tag.int().expand_as(tt), tt)
        bufs_v.append(tv)
        bufs_t.append(tt)
    return pkernel.merge_lane_topk(torch.cat(bufs_v), torch.cat(bufs_t), K)


@pytest.mark.parametrize("fold", [8, 1])
def test_octet_kernel_non_tie_safe(gpu, corpus, fold):
    """The production buffers (tie_safe_topk=False: every slot holding the
    minimum is replaced, from distinct sentinels). This corpus has fewer
    octets than the kernel has CUDA blocks, so each block harvests at most
    one octet into fresh buffers: emulate that per octet, then merge."""
    coo, qs = corpus
    cfg = pt.TopKSpMVConfig(**dict(HEADLINE, fold_tile=fold))
    assert not cfg.tie_safe_topk
    eng = pt.TopKSpMV(coo, cfg, device=gpu)
    sms = torch.cuda.get_device_properties(gpu).multi_processor_count
    nblk = min(sms * pkernel._BLOCKS_PER_SM, eng.words.shape[0] // 8)
    table, _ = eng._table(qs[1])
    kv, kt = pkernel.topk_spmv_fused_octet_device(
        eng.words, table, eng.nreal, eng.plan_rows, cfg=cfg,
        block_sublanes=cfg.fused_block_sublanes)
    ev, et = _emulate_production(eng, table, cfg, nblk)
    torch.cuda.synchronize()
    _lanes_equal(kv, kt, ev, et)


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
    """K6's production buffers against the per-octet emulation: the
    corpus has fewer octets than each subgroup has slots of CUDA blocks."""
    coo, _ = corpus
    cfg = pt.TopKSpMVConfig(**dict(HEADLINE, fold_tile=fold))
    assert not cfg.tie_safe_topk
    eng = pt.TopKSpMV(coo, cfg, device=gpu)
    qs = create_query_batch(6, 1024, seed=25)
    tables = _tables(qs, gpu)
    sms = torch.cuda.get_device_properties(gpu).multi_processor_count
    _, _, slots = pkernel.batch_grid(6, cfg.batch_subgroup, sms,
                                     eng.words.shape[0] // 8)
    kv, kt = eng.batch_candidates(tables)
    for q in range(6):
        ev, et = _emulate_production(eng, tables[q], cfg, slots)
        _lanes_equal(kv[q], kt[q], ev, et)


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
