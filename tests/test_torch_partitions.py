"""The port's partitioned engines (``num_partitions`` > 1: kernels K10a-d
and the partitioned K4/K9) against the JAX package on the CPU.

A partitioned engine packs P contiguous row partitions on one plan
skeleton (``pack_fused_partitions``) and keeps a Top-K pool per
partition: (P, lane_k, 128) candidates, (Q, P, lane_k, 128) for a batch.
The port runs the plain versions of its kernels here; the JAX package
runs its Pallas kernels in interpret mode, every program once, in the
module fixture. Tolerances, as in tests/test_torch_slice.py:
  - the pack is NumPy on both sides: bit-identical arrays;
  - h16: int32 sums converted to f32, so per-lane values, top-k values
    and ``scores()`` are bit-equal, and (value, slice) pairs equal above
    each lane's smallest kept value (tie-safe buffers);
  - f32 on integer-valued data (every partial sum exact): bit-equal;
  - f32 on real values: the two packages add a slice's products in
    different orders, so values agree to rtol 1e-6 (``scores()`` with
    atol 1e-6 for sums that cancel to near 0) and index sets above the
    k-th value less that margin.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import spmv_topk_tpu as jt
import spmv_topk_tpu.config as jcfg
from spmv_topk_tpu.formats import CooMatrix as JCoo
from spmv_topk_tpu.formats import create_sparse_matrix as jax_matrix
from spmv_topk_tpu.formats.sell_buckets import (
    pack_fused_partitions as jpack_parts)
from spmv_topk_tpu.ops import kernel as jkernel
from spmv_topk_tpu.ops.quantized_query import (pack_query_table,
                                               pack_query_tables)

import spmv_topk_tpu_torch as pt
from spmv_topk_tpu_torch.formats import (CooMatrix, create_query_batch,
                                         create_sparse_matrix)
from spmv_topk_tpu_torch.formats.sell_buckets import (
    PartitionedFusedMatrix, octet_plan_array, pack_fused_partitions,
    slice_plan_array)
from spmv_topk_tpu_torch.ops import kernel as pkernel

ROWS, COLS = 3000, 1024
GEOM = dict(block_sublanes=64, fused_block_sublanes=128)
# un-rescored h16 engines (tie_safe_topk resolves True) and the default
# f32 slice engine, each partitioned
OCTET = dict(k=100, lane_k=8, max_cols=1024, query_codec="h16",
             fused_layout="octet", width_quantum=2, fold_tile=8, **GEOM)
SLICE_H16 = dict(OCTET, fused_layout="slice")
DEFAULT = dict(k=100, **GEOM)
ENGINES = {"octet_p3": dict(OCTET, num_partitions=3),
           "slice_h16_p4": dict(SLICE_H16, num_partitions=4),
           "default_p2": dict(DEFAULT, num_partitions=2)}
# kernel level, tie-safe: (config, integer-valued data, queries; 0 is
# the single-query sweep). Small blocks give wide slices and octets.
KERNELS = {
    "K10a_slice_h16_wide": (dict(SLICE_H16, num_partitions=3,
                                 fused_block_sublanes=32), False, 0),
    "K10b_octet_h16_wide": (dict(OCTET, num_partitions=2,
                                 fused_block_sublanes=64), False, 0),
    "K10c_slice_f32_int": (dict(DEFAULT, num_partitions=2,
                                tie_safe_topk=True), True, 3),
    "K10d_octet_h16_fold1": (dict(OCTET, num_partitions=3, fold_tile=1),
                             False, 3),
}
QUERY_SEEDS = (11, 12, 13)


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _integer_valued(coo, jax_side):
    """The corpus with integer values in [-8, 8] (exact in bf16)."""
    vals = np.random.default_rng(7).integers(-8, 9, coo.nnz).astype(
        np.float32)
    cls = JCoo if jax_side else CooMatrix
    return cls(coo.rows, coo.cols, vals, coo.num_rows, coo.num_cols)


def _int_queries(n, seed):
    return np.random.default_rng(seed).integers(-8, 9, (n, COLS)).astype(
        np.float32)


def _corpora(integer):
    coo = create_sparse_matrix(ROWS, COLS, 20, "gamma", seed=5)
    jcoo = jax_matrix(ROWS, COLS, 20, "gamma", seed=5)
    if integer:
        return _integer_valued(coo, False), _integer_valued(jcoo, True)
    return coo, jcoo


def _part_kw(f):
    return dict(num_partitions=f.num_partitions, part_slices=f.part_slices)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("parts")
    out = dict(dir=d, kernels={}, eng={})
    # kernel level: the JAX part devices on the JAX package's pack
    for name, (kw, integer, Q) in KERNELS.items():
        cfg = jcfg.TopKSpMVConfig(**kw)
        f = jpack_parts(_corpora(integer)[1], cfg, cfg.num_partitions,
                        octet=cfg.fused_layout == "octet")
        octet = cfg.fused_layout == "octet"
        geo = dict(cfg=cfg, plan=f.plan, block_sublanes=f.block_sublanes,
                   num_blocks=f.num_blocks, interpret=True,
                   codec=cfg.query_codec, **_part_kw(f))
        qs = (_int_queries(max(Q, 1), 3) if integer
              else create_query_batch(max(Q, 1), COLS, seed=3))
        if Q:
            tabs, _ = pack_query_tables(qs, cfg.query_codec)
            dev = (jkernel.topk_spmv_fused_batch_octet_part_device if octet
                   else jkernel.topk_spmv_fused_batch_part_device)
        else:
            tabs, _ = pack_query_table(qs[0], cfg.query_codec)
            dev = (jkernel.topk_spmv_fused_octet_part_device if octet
                   else jkernel.topk_spmv_fused_part_device)
        tv, tt = dev(jnp.asarray(f.words), jnp.asarray(tabs),
                     jnp.asarray(f.nreal), **geo)
        out["kernels"][name] = (f, tabs, np.asarray(tv), np.asarray(tt))

    # engine level: query, query_batch (3 queries in groups of 2: a tail
    # group) and scores, on 3 seeds
    coo, jcoo = _corpora(False)
    qs = {s: create_query_batch(1, COLS, seed=s)[0] for s in QUERY_SEEDS}
    batch = np.stack(list(qs.values()))
    out.update(coo=coo, qs=qs, batch=batch)
    for name, kw in ENGINES.items():
        jeng = jt.TopKSpMV(jcoo, jt.TopKSpMVConfig(**kw))
        res = dict(jeng=jeng)
        res["q"] = {s: tuple(map(np.asarray, jeng.query(q)))
                    for s, q in qs.items()}
        res["qb"] = tuple(map(np.asarray, jeng.query_batch(batch,
                                                           group_size=2)))
        res["scores"] = {s: np.asarray(jeng.scores(q)) for s, q in qs.items()}
        jeng.save(str(d / f"{name}.npz"))
        out["eng"][name] = res
    # the port's snapshot of the octet engine, queried by the JAX package
    peng = pt.TopKSpMV(coo, pt.TopKSpMVConfig(**ENGINES["octet_p3"]),
                       device="cpu")
    peng.save(str(d / "port.npz"))
    jloaded = jt.TopKSpMV.load(str(d / "port.npz"))
    out["jloaded_q"] = {s: tuple(map(np.asarray, jloaded.query(q)))
                        for s, q in qs.items()}
    # f32 on integer-valued data: the default engine's programs again
    icoo, ijcoo = _corpora(True)
    jint = jt.TopKSpMV(ijcoo, jt.TopKSpMVConfig(**ENGINES["default_p2"]))
    iq = _int_queries(1, 5)[0]
    out["int"] = dict(coo=icoo, q=iq,
                      query=tuple(map(np.asarray, jint.query(iq))),
                      scores=np.asarray(jint.scores(iq)))
    return out


def _assert_lanes_match(jv, jt_, pv, pt_):
    """Sorted values bit-equal, (value, tag) pairs above each lane's
    floor equal, for each (lane_k, 128) buffer of a leading axis."""
    if jv.ndim > 2:
        assert jv.shape == pv.shape
        for a, b, c, e in zip(jv, jt_, pv, pt_):
            _assert_lanes_match(a, b, c, e)
        return
    np.testing.assert_array_equal(-np.sort(-jv, axis=0), pv)
    for lane in range(jv.shape[1]):
        floor = pv[:, lane].min()
        a = sorted(zip(jv[:, lane][jv[:, lane] > floor].tolist(),
                       jt_[:, lane][jv[:, lane] > floor].tolist()))
        b = sorted(zip(pv[:, lane][pv[:, lane] > floor].tolist(),
                       pt_[:, lane][pv[:, lane] > floor].tolist()))
        assert a == b, f"lane {lane}"


# ------------------------------------------------------------------- pack

@pytest.mark.parametrize("P", [2, 3, 4])
@pytest.mark.parametrize("layout,codec", [("octet", "h16"), ("octet", "f32"),
                                          ("slice", "h16"), ("slice", "f32")])
def test_pack_fused_partitions_bit_identical(layout, codec, P):
    """The partitioned pack of both packages, with 32-row blocks (wide
    slices; wide octets above width 4): words, nreal, row_ids, plan,
    part_slices and value_scale equal; and some partition has a bucket
    with no real slice (a width it lacks, kept by the shared skeleton)."""
    kw = dict(k=100, max_cols=1024, query_codec=codec, fused_layout=layout,
              width_quantum=2, block_sublanes=32, fused_block_sublanes=32)
    octet = layout == "octet"
    coo, jcoo = _corpora(False)
    jf = jpack_parts(jcoo, jcfg.TopKSpMVConfig(**kw), P, octet=octet)
    pf = pack_fused_partitions(coo, pt.TopKSpMVConfig(**kw), P, octet=octet)
    assert isinstance(pf, PartitionedFusedMatrix)
    for name in ("words", "nreal", "row_ids"):
        np.testing.assert_array_equal(getattr(jf, name), getattr(pf, name))
    assert pf.nreal.shape == (P, len(pf.plan), 1)
    assert pf.row_ids.shape == (P * pf.part_slices, 128)
    assert pf.words.shape[0] == P * pf.num_blocks * pf.block_sublanes
    assert [dataclasses.astuple(p) for p in jf.plan] == \
        [dataclasses.astuple(p) for p in pf.plan]
    for name in ("num_partitions", "part_slices", "block_sublanes",
                 "num_blocks", "num_rows", "num_cols", "num_nnz",
                 "value_scale"):
        assert getattr(jf, name) == getattr(pf, name), name
    assert (pf.nreal == 0).any()
    wide = [p.blocks_per_octet if octet else p.blocks_per_slice
            for p in pf.plan]
    assert max(wide) > 1
    # the plan tables the kernels read accept every partition's counts
    if octet:
        pkernel.octet_plan_rows(pf.plan, pf.num_blocks)
    else:
        pkernel.slice_plan_rows(pf.plan, pf.num_blocks, pf.nreal,
                                pf.block_sublanes)


def test_pack_rejects_empty_partitions_and_unsorted_slices():
    """An empty partition raises in both packages, as does the slice
    layout without sigma_sort (the skeleton needs unique widths); the
    octet layout refuses sigma_sort=False with partitions in its config."""
    coo = create_sparse_matrix(5, 64, 3, "uniform", seed=1)
    jcoo = jax_matrix(5, 64, 3, "uniform", seed=1)
    kw = dict(k=4, max_cols=128, **GEOM)
    for pack, cfg, m in ((pack_fused_partitions, pt.TopKSpMVConfig, coo),
                         (jpack_parts, jcfg.TopKSpMVConfig, jcoo)):
        with pytest.raises(ValueError, match="empty"):
            pack(m, cfg(**kw), 4)
    coo, jcoo = _corpora(False)
    kw = dict(DEFAULT, sigma_sort=False, num_partitions=2)
    for pack, cfg, m in ((pack_fused_partitions, pt.TopKSpMVConfig, coo),
                         (jpack_parts, jcfg.TopKSpMVConfig, jcoo)):
        with pytest.raises(ValueError, match="unique"):
            pack(m, cfg(**kw), 2)
    with pytest.raises(ValueError, match="unique"):
        pt.TopKSpMV(coo, pt.TopKSpMVConfig(**kw), device="cpu")
    for cfg in (pt.TopKSpMVConfig, jcfg.TopKSpMVConfig):
        with pytest.raises(ValueError, match="sigma_sort"):
            cfg(**dict(OCTET, sigma_sort=False, num_partitions=2))


# ---------------------------------------------------------------- kernels

@pytest.mark.parametrize("name", list(KERNELS))
def test_partition_plain_matches_pallas(ref, name):
    """Plain K10a-d against topk_spmv_fused_part_device and its three
    siblings: a pool per partition, tags offset by p * part_slices."""
    kw, integer, Q = KERNELS[name]
    f, tabs, jv, jt_ = ref["kernels"][name]
    cfg = pt.TopKSpMVConfig(**kw)
    P = cfg.num_partitions
    octet = cfg.fused_layout == "octet"
    rows = torch.from_numpy(
        pkernel.octet_plan_rows(f.plan, f.num_blocks) if octet
        else pkernel.slice_plan_rows(f.plan, f.num_blocks, f.nreal,
                                     f.block_sublanes))
    if "wide" in name:
        assert any((p.blocks_per_octet if octet else p.blocks_per_slice) > 1
                   for p in f.plan)
    args = (torch.from_numpy(f.words), torch.from_numpy(tabs),
            torch.from_numpy(f.nreal), rows)
    kw = dict(lane_k=cfg.lane_k, tie_safe=True,
              block_sublanes=f.block_sublanes, **_part_kw(f))
    if octet:
        kw["fold_tile"] = cfg.fold_tile
        plain = (pkernel.octet_topk_batch_plain if Q
                 else pkernel.octet_topk_plain)
    else:
        kw["codec"] = cfg.query_codec
        if Q:
            plain = pkernel.slice_topk_batch_plain
        else:
            plain = pkernel.slice_topk_plain
            kw["fold_tile"] = cfg.fold_tile
    pv, pt_ = plain(*args, **kw)
    assert pv.shape == ((Q, P) if Q else (P,)) + (cfg.lane_k, 128)
    assert jv.shape == pv.shape
    _assert_lanes_match(jv, jt_, pv.numpy(), pt_.numpy())
    # partition p's tags lie in [p * part_slices, (p + 1) * part_slices)
    v = pv.numpy().reshape(-1, P, cfg.lane_k, 128)
    t = pt_.numpy().reshape(v.shape)
    for p in range(P):
        tp = t[:, p][v[:, p] > -np.inf]
        assert len(tp) and ((tp >= p * f.part_slices)
                            & (tp < (p + 1) * f.part_slices)).all()


def test_partition_wrappers_on_cpu_run_plain(ref):
    """The wrappers take the plain versions on CPU tensors and keep the
    partition axis; a pool per partition is not merged across them."""
    f, tabs, jv, jt_ = ref["kernels"]["K10b_octet_h16_wide"]
    cfg = pt.TopKSpMVConfig(**KERNELS["K10b_octet_h16_wide"][0])
    args = (torch.from_numpy(f.words), torch.from_numpy(tabs),
            torch.from_numpy(f.nreal),
            torch.from_numpy(pkernel.octet_plan_rows(f.plan, f.num_blocks)))
    before = pkernel.topk_spmv_fused_octet_device.launches
    pv, pt_ = pkernel.topk_spmv_fused_octet_device(
        *args, cfg=cfg, block_sublanes=f.block_sublanes, **_part_kw(f))
    assert pkernel.topk_spmv_fused_octet_device.launches == before
    assert pv.shape == (2, 8, 128)
    _assert_lanes_match(jv, jt_, pv.numpy(), pt_.numpy())
    with pytest.raises(ValueError, match="part_slices"):
        pkernel.topk_spmv_fused_octet_device(
            *args, cfg=cfg, block_sublanes=f.block_sublanes,
            num_partitions=2)


# ---------------------------------------------------------------- engines

@pytest.mark.parametrize("seed", QUERY_SEEDS)
@pytest.mark.parametrize("name", list(ENGINES))
def test_query_and_scores_match_reference(ref, name, seed):
    peng = pt.TopKSpMV(ref["coo"], pt.TopKSpMVConfig(**ENGINES[name]),
                       device="cpu")
    P = peng.config.num_partitions
    tv, tt = peng.candidates(ref["qs"][seed])
    assert tv.shape == (P, peng.config.lane_k, 128)
    ji, jv = ref["eng"][name]["q"][seed]
    pi, pv = map(_np, peng.query(ref["qs"][seed]))
    js = ref["eng"][name]["scores"][seed]
    ps = _np(peng.scores(ref["qs"][seed]))
    if peng.config.query_codec == "h16":
        np.testing.assert_array_equal(jv, pv)
        kth = pv[-1]
        assert set(ji[jv > kth].tolist()) == set(pi[pv > kth].tolist())
        np.testing.assert_array_equal(js, ps)
        return
    np.testing.assert_allclose(jv, pv, rtol=1e-6)
    margin = pv[-1] + 1e-6 * np.abs(pv[-1])
    assert set(ji[jv > margin].tolist()) == set(pi[pv > margin].tolist())
    np.testing.assert_allclose(js, ps, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", list(ENGINES))
def test_query_batch_matches_reference(ref, name):
    """3 queries in groups of 2 (the tail group runs at its real size in
    the port, padded in the JAX package); candidates (Q, P, lane_k, 128)."""
    peng = pt.TopKSpMV(ref["coo"], pt.TopKSpMVConfig(**ENGINES[name]),
                       device="cpu")
    cfg = peng.config
    tabs, _ = pack_query_tables(ref["batch"], cfg.query_codec)
    tv, _ = peng.batch_candidates(torch.from_numpy(tabs))
    assert tv.shape == (3, cfg.num_partitions, cfg.lane_k, 128)
    ji, jv = ref["eng"][name]["qb"]
    pi, pv = map(_np, peng.query_batch(ref["batch"], group_size=2))
    assert pi.shape == (3, 100)
    for j in range(3):
        if cfg.query_codec == "h16":
            np.testing.assert_array_equal(jv[j], pv[j])
            margin = pv[j, -1]
        else:
            np.testing.assert_allclose(jv[j], pv[j], rtol=1e-6)
            margin = pv[j, -1] + 1e-6 * np.abs(pv[j, -1])
        assert set(ji[j][jv[j] > margin].tolist()) == \
            set(pi[j][pv[j] > margin].tolist())


def test_f32_bit_equal_on_integer_data(ref):
    peng = pt.TopKSpMV(ref["int"]["coo"],
                       pt.TopKSpMVConfig(**ENGINES["default_p2"]),
                       device="cpu")
    ji, jv = ref["int"]["query"]
    pi, pv = map(_np, peng.query(ref["int"]["q"]))
    np.testing.assert_array_equal(jv, pv)
    assert set(ji[jv > pv[-1]].tolist()) == set(pi[pv > pv[-1]].tolist())
    got = _np(peng.scores(ref["int"]["q"]))
    np.testing.assert_array_equal(ref["int"]["scores"], got)
    assert (got == np.rint(got)).all() and np.abs(got).max() > 0


@pytest.mark.parametrize("layout", ["slice", "octet"])
def test_partitioned_matches_unpartitioned(layout):
    """The JAX package's property (tests/test_fused.py::
    test_partitioned_matches_unpartitioned) in the port: P=3 and P=1
    engines return the same top-k on the same matrix (octet: h16 with
    tie-safe buffers, the values bit-equal)."""
    coo = create_sparse_matrix(1500, 256, 10, "uniform", seed=152)
    q = create_query_batch(1, 256, seed=153)[0]
    kw = dict(k=30, max_cols=256, block_sublanes=64, fused_block_sublanes=64)
    if layout == "octet":
        kw.update(query_codec="h16", fused_layout="octet", width_quantum=2,
                  fold_tile=8)
    i1, v1 = map(_np, pt.TopKSpMV(coo, pt.TopKSpMVConfig(**kw),
                                  device="cpu").query(q))
    i3, v3 = map(_np, pt.TopKSpMV(
        coo, pt.TopKSpMVConfig(**kw, num_partitions=3), device="cpu").query(q))
    np.testing.assert_array_equal(np.sort(i1), np.sort(i3))
    np.testing.assert_allclose(np.sort(v1), np.sort(v3), atol=1e-6)


# -------------------------------------------------------------- snapshots

@pytest.mark.parametrize("name", list(ENGINES))
def test_jax_snapshot_loads_in_port(ref, name):
    peng = pt.TopKSpMV.load(str(ref["dir"] / f"{name}.npz"), device="cpu")
    assert peng.config == pt.TopKSpMVConfig(**ENGINES[name])
    assert isinstance(peng.fused, PartitionedFusedMatrix)
    built = pt.TopKSpMV(ref["coo"], pt.TopKSpMVConfig(**ENGINES[name]),
                        device="cpu")
    for buf in ("words", "nreal", "row_ids", "plan_rows"):
        np.testing.assert_array_equal(_np(getattr(peng, buf)),
                                      _np(getattr(built, buf)))
    seed = QUERY_SEEDS[0]
    for a, b in zip(peng.query(ref["qs"][seed]),
                    built.query(ref["qs"][seed])):
        np.testing.assert_array_equal(_np(a), _np(b))


def test_port_snapshot_loads_in_jax(ref):
    for seed in QUERY_SEEDS:
        np.testing.assert_array_equal(ref["jloaded_q"][seed][0],
                                      ref["eng"]["octet_p3"]["q"][seed][0])
    with np.load(ref["dir"] / "port.npz") as z, \
            np.load(ref["dir"] / "octet_p3.npz") as y:
        for name in ("words", "nreal", "row_ids", "plan", "meta"):
            np.testing.assert_array_equal(z[name], y[name])


@pytest.mark.parametrize("name", ["octet_p3", "default_p2"])
def test_from_reference_arrays_with_partitions(ref, name):
    jeng = ref["eng"][name]["jeng"]
    f = jeng.fused
    meta = dict(config=dataclasses.asdict(jeng.config),
                block_sublanes=f.block_sublanes, num_blocks=f.num_blocks,
                num_rows=f.num_rows, num_cols=f.num_cols,
                num_nnz=f.num_nnz, value_scale=f.value_scale,
                num_partitions=f.num_partitions, part_slices=f.part_slices)
    plan = np.array([dataclasses.astuple(p) for p in f.plan], np.int64)
    peng = pt.TopKSpMV.from_reference_arrays(
        f.words, f.nreal, f.row_ids, plan, meta, device="cpu")
    array = octet_plan_array if name == "octet_p3" else slice_plan_array
    np.testing.assert_array_equal(array(peng.fused.plan), plan)
    assert peng.fused.nreal.shape == f.nreal.shape
    assert peng.hbm_bytes == jeng.hbm_bytes
    seed = QUERY_SEEDS[1]
    ji, jv = ref["eng"][name]["q"][seed]
    pi, pv = map(_np, peng.query(ref["qs"][seed]))
    np.testing.assert_allclose(jv, pv, rtol=1e-6)
    with pytest.raises(ValueError, match="num_partitions"):
        pt.TopKSpMV.from_reference_arrays(
            f.words, f.nreal, f.row_ids, plan,
            dict(meta, num_partitions=1), device="cpu")
