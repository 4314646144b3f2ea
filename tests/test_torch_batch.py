"""The port's batch serving (``query_batch``, kernel K6) against the JAX
package's on the CPU.

The port runs the plain version of K6 here; the JAX engines run their
Pallas batch kernel in interpret mode. Three interpret-mode programs in
all, each compiled once in the module fixture:
  - the un-rescored, tie-safe engine (fused blocks of 128, fold 8,
    batch_subgroup 2): ``batch_candidates_traceable`` on 3 queries, and
    ``query_batch`` of 5 queries in groups of 3 (the tail group pads to
    the same shape);
  - the same sweep with fused blocks of 64 and fold 1 (wide octets);
  - the headline engine (rescore pool 400): ``query_batch`` of 5 in
    groups of 3.
Tolerances:
  - ``pack_query_tables``: bit-identical (NumPy on both sides);
  - per-lane candidates with tie-safe buffers: h16 scores are int32 sums
    converted to f32 once, so per-lane sorted values are bit-equal and
    (value, slice) pairs equal above each lane's smallest kept value;
  - rescored ``query_batch``: both packages re-rank the same pools with
    the same native rescore in f32: indices equal, values rtol=1e-6;
  - un-rescored, tie-safe ``query_batch``: the same integer sums times
    the same f32 scales, so values are bit-equal and the row sets equal
    above the k-th value.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import spmv_topk_tpu as jt
from spmv_topk_tpu.formats import create_sparse_matrix as jax_matrix
from spmv_topk_tpu.ops import kernel as jkernel
from spmv_topk_tpu.ops.quantized_query import (
    pack_query_tables as jpack_tables)

import spmv_topk_tpu_torch as pt
from spmv_topk_tpu_torch import api as papi
from spmv_topk_tpu_torch.formats import (create_query_batch,
                                         create_sparse_matrix)
from spmv_topk_tpu_torch.ops import kernel as pkernel
from spmv_topk_tpu_torch.ops.quantized_query import (
    pack_query_tables as ppack_tables)

HEADLINE = dict(k=100, lane_k=8, max_cols=1024, query_codec="h16",
                fused_layout="octet", width_quantum=2, fold_tile=8,
                rescore_pool=400, block_sublanes=64,
                fused_block_sublanes=128)
# un-rescored: tie_safe_topk resolves True; an uneven subgroup (2 + 1)
RAW = dict(HEADLINE, rescore_pool=None, batch_subgroup=2)
WIDE = dict(RAW, fused_block_sublanes=64, fold_tile=1)
NUM_QUERIES, GROUP = 5, 3


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _padded(qs):
    out = np.zeros((len(qs), 1024), np.float32)
    out[:, : qs.shape[1]] = qs
    return out


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("batch")
    coo = create_sparse_matrix(3000, 1024, 20, "gamma", seed=5)
    jcoo = jax_matrix(3000, 1024, 20, "gamma", seed=5)
    qs = create_query_batch(NUM_QUERIES, 1024, seed=31)
    tabs, _ = jpack_tables(_padded(qs[:3]), "h16")
    out = dict(coo=coo, qs=qs, tabs=tabs, dir=d, cand={})
    for name, kw in (("raw", RAW), ("wide", WIDE)):
        jeng = jt.TopKSpMV(jcoo, jt.TopKSpMVConfig(**kw))
        tv, tt = jeng.batch_candidates_traceable(jnp.asarray(tabs))
        out["cand"][name] = (jeng.fused, np.asarray(tv), np.asarray(tt))
        if name == "raw":
            out["jraw"] = tuple(map(np.asarray, jeng.query_batch(
                qs, group_size=GROUP)))
    jeng = jt.TopKSpMV(jcoo, jt.TopKSpMVConfig(**HEADLINE))
    out["jeng"] = jeng
    out["jq"] = tuple(map(np.asarray, jeng.query_batch(qs, group_size=GROUP)))
    jeng.save(str(d / "jax.npz"))
    out["peng"] = pt.TopKSpMV(coo, pt.TopKSpMVConfig(**HEADLINE),
                              device="cpu")
    return out


def _assert_lanes_match(jv, jt_, pv, pt_):
    np.testing.assert_array_equal(-np.sort(-jv, axis=0), pv)
    for lane in range(jv.shape[1]):
        floor = pv[:, lane].min()
        a = sorted(zip(jv[:, lane][jv[:, lane] > floor].tolist(),
                       jt_[:, lane][jv[:, lane] > floor].tolist()))
        b = sorted(zip(pv[:, lane][pv[:, lane] > floor].tolist(),
                       pt_[:, lane][pv[:, lane] > floor].tolist()))
        assert a == b, f"lane {lane}"


@pytest.mark.parametrize("codec,cols", [("h16", 1024), ("i4s", 2048),
                                        ("i8s", 1024), ("int8x4", 1536),
                                        ("f32", 256)])
def test_pack_query_tables_matches_jax(codec, cols):
    """Bit-identical tables and float32 scales, an all-zero query
    included (its scale is 1)."""
    qs = np.random.default_rng(cols).standard_normal((4, cols)).astype(
        np.float32)
    qs[2] = 0.0
    jtab, jscale = jpack_tables(qs, codec)
    ptab, pscale = ppack_tables(qs, codec)
    assert ptab.dtype == jtab.dtype and pscale.dtype == jscale.dtype
    np.testing.assert_array_equal(jtab, ptab)
    np.testing.assert_array_equal(jscale, pscale)
    assert pscale[2] == 1.0


@pytest.mark.parametrize("case", ["raw", "wide"])
def test_batch_plain_matches_pallas(ref, case):
    """octet_topk_batch_plain against the JAX batch sweep, per query: fold
    8 with fused blocks of 128, and fold 1 with wide octets."""
    f, jv, jt_ = ref["cand"][case]
    cfg = pt.TopKSpMVConfig(**(RAW if case == "raw" else WIDE))
    if case == "wide":
        assert any(p.blocks_per_octet > 1 for p in f.plan)
    rows = torch.from_numpy(pkernel.octet_plan_rows(f.plan, f.num_blocks))
    pv, pt_ = pkernel.octet_topk_batch_plain(
        torch.from_numpy(f.words), torch.from_numpy(ref["tabs"]),
        torch.from_numpy(f.nreal), rows, lane_k=8, fold_tile=cfg.fold_tile,
        tie_safe=True, block_sublanes=f.block_sublanes)
    assert pv.shape == (3, 8, 128) and pt_.dtype == torch.int32
    assert jv.shape == pv.shape
    for q in range(3):
        assert np.isfinite(pv[q].numpy()).any()
        _assert_lanes_match(jv[q], jt_[q], pv[q].numpy(), pt_[q].numpy())


def _stream(ref, case):
    f = ref["cand"][case][0]
    return (torch.from_numpy(f.words), torch.from_numpy(ref["tabs"]),
            torch.from_numpy(f.nreal),
            torch.from_numpy(pkernel.octet_plan_rows(f.plan, f.num_blocks))), f


@pytest.mark.parametrize("slots", [1, 4, 33])
@pytest.mark.parametrize("case", ["raw", "wide"])
def test_slots_plain_matches_pallas(ref, case, slots):
    """K6 h16's slot plain (each slot harvesting its octets in turn, then
    the lane merge) with tie-safe buffers against the JAX batch sweep."""
    _, jv, jt_ = ref["cand"][case]
    cfg = pt.TopKSpMVConfig(**(RAW if case == "raw" else WIDE))
    args, f = _stream(ref, case)
    sv, st = pkernel.octet_topk_batch_slots_plain(
        *args, num_slots=slots, lane_k=8, fold_tile=cfg.fold_tile,
        tie_safe=True, block_sublanes=f.block_sublanes, codec="h16")
    assert sv.shape == (3, 8, 128) and st.dtype == torch.int32
    for q in range(3):
        _assert_lanes_match(jv[q], jt_[q], sv[q].numpy(), st[q].numpy())


@pytest.mark.parametrize("tie_safe", [True, False])
@pytest.mark.parametrize("case", ["raw", "wide"])
def test_slots_plain_merges_its_unmerged_slots(ref, case, tie_safe):
    """The merged pairs are the lane merge of the unmerged slots' (each
    already in the merge's order); with tie-safe buffers their values are
    octet_topk_batch_plain's."""
    cfg = pt.TopKSpMVConfig(**(RAW if case == "raw" else WIDE))
    args, f = _stream(ref, case)
    kw = dict(num_slots=5, lane_k=8, fold_tile=cfg.fold_tile,
              tie_safe=tie_safe, block_sublanes=f.block_sublanes,
              codec="h16")
    sv, st = pkernel.octet_topk_batch_slots_plain(*args, **kw)
    uv, ut = pkernel.octet_topk_batch_slots_plain(*args, merged=False, **kw)
    assert uv.shape == (3, 1, 5, 8, 128)
    for q in range(3):
        for j in range(5):
            mv, mt = pkernel.lane_merge_plain(uv[q, 0, j], ut[q, 0, j], 8)
            assert torch.equal(mv, uv[q, 0, j]) and torch.equal(mt, ut[q, 0, j])
        mv, mt = pkernel.lane_merge_plain(uv[q, 0], ut[q, 0], 8)
        assert torch.equal(mv, sv[q]) and torch.equal(mt, st[q])
    if tie_safe:
        pv, _ = pkernel.octet_topk_batch_plain(
            *args, lane_k=8, fold_tile=cfg.fold_tile, tie_safe=True,
            block_sublanes=f.block_sublanes)
        assert torch.equal(pv, sv)


def test_octet_h16_grid():
    """K6 h16: a pass per 32 queries; the SMs over the lane groups (2
    blocks of 64 lanes a slot at lane_k 4 and 8, 4 of 32 at 16),
    partitions and passes, rounded down, at least one slot."""
    assert pkernel.octet_h16_grid(32, 132) == (1, 66)
    assert pkernel.octet_h16_grid(32, 132, lane_k=16) == (1, 33)
    assert pkernel.octet_h16_grid(1, 132, lane_k=4) == (1, 66)
    assert pkernel.octet_h16_grid(33, 132) == (2, 33)
    assert pkernel.octet_h16_grid(64, 132, lane_k=16) == (2, 16)
    assert pkernel.octet_h16_grid(7, 132, 2) == (1, 33)
    assert pkernel.octet_h16_grid(7, 132, 3, 16) == (1, 11)
    assert pkernel.octet_h16_grid(32, 3) == (1, 1)
    # the merge's sets: ceil(slots / ceil(sqrt(slots)))
    assert [pkernel._merge_sets(n) for n in (1, 2, 4, 5, 16, 33)] == \
        [1, 1, 2, 2, 4, 6]


def test_batch_wrapper_on_cpu_runs_plain_without_launch(ref):
    f, jv, jt_ = ref["cand"]["raw"]
    cfg = pt.TopKSpMVConfig(**RAW)
    before = pkernel.topk_spmv_fused_batch_octet_device.launches
    pv, pt_ = pkernel.topk_spmv_fused_batch_octet_device(
        torch.from_numpy(f.words), torch.from_numpy(ref["tabs"]),
        torch.from_numpy(f.nreal),
        torch.from_numpy(pkernel.octet_plan_rows(f.plan, f.num_blocks)),
        cfg=cfg, block_sublanes=f.block_sublanes)
    assert pkernel.topk_spmv_fused_batch_octet_device.launches == before
    for q in range(3):
        _assert_lanes_match(jv[q], jt_[q], pv[q].numpy(), pt_[q].numpy())


def test_batch_wrapper_on_other_device_raises():
    """Off the CPU the wrapper launches the kernel or raises."""
    cfg = pt.TopKSpMVConfig(**RAW)
    meta = dict(dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        pkernel.topk_spmv_fused_batch_octet_device(
            torch.empty((128, 128), **meta), torch.empty((2, 1, 128), **meta),
            torch.empty((1, 1), **meta), torch.empty((1, 8), **meta),
            cfg=cfg, block_sublanes=128)


def test_query_batch_matches_reference(ref):
    """Rescored, 5 queries in groups of 3: the port runs its tail group
    at its real size (2), the JAX package pads it."""
    ji, jv = ref["jq"]
    pi, pv = ref["peng"].query_batch(ref["qs"], group_size=GROUP)
    assert pi.dtype == torch.int32 and pv.dtype == torch.float32
    assert pi.shape == (NUM_QUERIES, 100) and (_np(pi) >= 0).all()
    np.testing.assert_array_equal(ji, _np(pi))
    np.testing.assert_allclose(jv, _np(pv), rtol=1e-6)


def test_raw_query_batch_matches_reference(ref):
    """Un-rescored with tie-safe buffers: bit-equal scaled values (float32
    query scales on both sides), the same rows above the k-th value."""
    peng = pt.TopKSpMV(ref["coo"], pt.TopKSpMVConfig(**RAW), device="cpu")
    assert peng.config.tie_safe_topk
    ji, jv = ref["jraw"]
    pi, pv = map(_np, peng.query_batch(ref["qs"], group_size=GROUP))
    for q in range(NUM_QUERIES):
        np.testing.assert_array_equal(jv[q], pv[q])
        kth = pv[q, -1]
        assert set(ji[q][jv[q] > kth].tolist()) == \
            set(pi[q][pv[q] > kth].tolist())


@pytest.mark.parametrize("group_size", [1, 2, 5, 8])
def test_query_batch_ignores_grouping(ref, group_size):
    """Every grouping, tail groups included, gives the results of groups
    of 3 (which equal the JAX package's)."""
    pi, pv = ref["peng"].query_batch(ref["qs"], group_size=group_size)
    np.testing.assert_array_equal(ref["jq"][0], _np(pi))
    np.testing.assert_allclose(ref["jq"][1], _np(pv), rtol=1e-6)


def test_query_batch_agrees_with_query(ref):
    """Rescored results are exact dot products of the same pools, so
    batch and single queries agree row for row."""
    peng = ref["peng"]
    bi, bv = map(_np, peng.query_batch(ref["qs"], k=50, group_size=4))
    assert bi.shape == (NUM_QUERIES, 50)
    for q in range(NUM_QUERIES):
        si, sv = map(_np, peng.query(ref["qs"][q], k=50))
        np.testing.assert_array_equal(si, bi[q])
        np.testing.assert_array_equal(sv, bv[q])


def test_jax_snapshot_serves_query_batch(ref):
    peng = pt.TopKSpMV.load(str(ref["dir"] / "jax.npz"), device="cpu",
                            matrix=ref["coo"])
    pi, pv = peng.query_batch(ref["qs"], group_size=GROUP)
    np.testing.assert_array_equal(ref["jq"][0], _np(pi))
    np.testing.assert_allclose(ref["jq"][1], _np(pv), rtol=1e-6)


def test_from_reference_arrays_serves_query_batch(ref):
    jeng = ref["jeng"]
    f = jeng.fused
    meta = dict(config=dataclasses.asdict(jeng.config),
                block_sublanes=f.block_sublanes, num_blocks=f.num_blocks,
                num_rows=f.num_rows, num_cols=f.num_cols,
                num_nnz=f.num_nnz, value_scale=f.value_scale)
    plan = np.array([dataclasses.astuple(p) for p in f.plan], np.int64)
    peng = pt.TopKSpMV.from_reference_arrays(
        f.words, f.nreal, f.row_ids, plan, meta, device="cpu",
        matrix=ref["coo"])
    pi, _ = peng.query_batch(ref["qs"], group_size=GROUP)
    np.testing.assert_array_equal(ref["jq"][0], _np(pi))


def test_rescore_overlaps_next_sweep(ref, monkeypatch):
    """Group g's pool reaches the thread pool only after group g+1's
    sweep has been enqueued, and the last group's after the loop."""
    peng = ref["peng"]
    events = []

    class Recorder:
        def submit(self, fn, idx, vec, k):
            events.append("rescore")
            fut = __import__("concurrent.futures").futures.Future()
            fut.set_result(fn(idx, vec, k))
            return fut

    sweep = peng.batch_candidates

    def recorded_sweep(tables):
        events.append(f"sweep{tables.shape[0]}")
        return sweep(tables)

    monkeypatch.setattr(peng, "batch_candidates", recorded_sweep)
    monkeypatch.setattr(papi, "rescore_executor", lambda holder: Recorder())
    pi, _ = peng.query_batch(ref["qs"], group_size=2)
    assert events == ["sweep2", "sweep2", "rescore", "rescore", "sweep1",
                      "rescore", "rescore", "rescore"]
    np.testing.assert_array_equal(ref["jq"][0], _np(pi))


def test_rescore_executor_is_cached_per_engine(ref):
    peng = ref["peng"]
    ex = papi.rescore_executor(peng)
    assert papi.rescore_executor(peng) is ex


def test_query_batch_rejects_bad_shapes(ref):
    peng = ref["peng"]
    with pytest.raises(ValueError, match="shape"):
        peng.query_batch(ref["qs"][:, :100])
    with pytest.raises(ValueError, match="shape"):
        peng.query_batch(ref["qs"][0])
    with pytest.raises(ValueError, match="shape"):
        peng.query_batch(ref["qs"][:0])
    with pytest.raises(ValueError, match="group_size"):
        peng.query_batch(ref["qs"], group_size=0)


@pytest.mark.parametrize("seed,k", [(0, 100), (1, 2000)])
def test_finalize_topk_batch_matches_jax_vmap(seed, k):
    """The JAX package's vmap(finalize_topk): equal values, equal row sets
    above each query's k-th value."""
    rng = np.random.default_rng(seed)
    Q, K, slices = 3, 8, 40
    topv = rng.integers(-50, 50, (Q, K, 128)).astype(np.float32)
    topv[rng.random((Q, K, 128)) < 0.1] = pkernel.topk_init(K)[0]
    topt = rng.integers(0, slices + 5, (Q, K, 128)).astype(np.int32)
    row_ids = rng.permutation(slices * 128).reshape(slices, 128).astype(
        np.int32)
    row_ids[-3:] = -1
    fin = jax.jit(jax.vmap(lambda tv, tt, rid: jkernel.finalize_topk(
        tv, tt, rid, k=k), in_axes=(0, 0, None)))
    ji, jv = map(np.asarray, fin(jnp.asarray(topv), jnp.asarray(topt),
                                 jnp.asarray(row_ids)))
    pi, pv = map(_np, pkernel.finalize_topk_batch(
        torch.from_numpy(topv), torch.from_numpy(topt),
        torch.from_numpy(row_ids), k=k))
    np.testing.assert_array_equal(jv, pv)
    for q in range(Q):
        kth = pv[q, -1]
        assert set(ji[q][jv[q] > kth].tolist()) == \
            set(pi[q][pv[q] > kth].tolist())


def test_batch_grid():
    """Subgroups of cfg.batch_subgroup queries (0: 4, at most 8 and at
    most Q); at least one octet slot per SM, no more than chunks."""
    assert pkernel.batch_grid(32, 0, 132, 10**6) == (4, 8, 132)
    assert pkernel.batch_grid(5, 2, 132, 10**6) == (2, 3, 352)
    assert pkernel.batch_grid(1, 0, 132, 10**6) == (1, 1, 1056)
    assert pkernel.batch_grid(3, 64, 132, 10**6) == (3, 1, 1056)
    assert pkernel.batch_grid(32, 64, 132, 10**6) == (8, 4, 264)
    assert pkernel.batch_grid(32, 0, 132, 40) == (4, 8, 40)
