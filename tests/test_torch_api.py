"""The port's TopKSpMV against the JAX package's, end to end on the CPU.

The headline configuration (h16 codec, octet stream, width quantum 2,
top-3-of-8 fold, rescore pool 400) at test size. The port runs the plain
versions of its kernels here; the JAX engine runs its Pallas kernels in
interpret mode. Tolerances:
  - rescored query(): both packages re-rank the same 400-row pool with
    the same native csr_rescore in f32, so indices must be equal and
    values equal to rtol=1e-6 (the pool sets may differ only at h16
    score ties far below the top 100);
  - un-rescored query() with tie-safe buffers: the h16 scores are exact
    integer sums times the same f32 scale, so values are bit-equal and
    the row sets equal above the k-th value.
All JAX work runs once per module, in the fixture.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import spmv_topk_tpu as jt
from spmv_topk_tpu.formats import create_sparse_matrix as jax_matrix
from spmv_topk_tpu.formats.sell_buckets import OctetBucket

import spmv_topk_tpu_torch as pt
from spmv_topk_tpu_torch.formats import (create_query_batch,
                                         create_sparse_matrix)
from spmv_topk_tpu_torch.formats.sell_buckets import octet_plan_array
from spmv_topk_tpu_torch.ops import kernel as pkernel

HEADLINE = dict(k=100, lane_k=8, max_cols=1024, query_codec="h16",
                fused_layout="octet", width_quantum=2, fold_tile=8,
                rescore_pool=400, block_sublanes=64,
                fused_block_sublanes=128)
RAW = dict(HEADLINE, rescore_pool=None)   # tie_safe_topk resolves True
QUERY_SEEDS = (11, 12, 13)


def _np(t):
    return np.asarray(t.cpu().numpy() if isinstance(t, torch.Tensor) else t)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("snap")
    # the same corpus from the same seed, in each package's container
    coo = create_sparse_matrix(3000, 1024, 20, "gamma", seed=5)
    jcoo = jax_matrix(3000, 1024, 20, "gamma", seed=5)
    qs = {s: create_query_batch(1, 1024, seed=s)[0] for s in QUERY_SEEDS}
    jeng = jt.TopKSpMV(jcoo, jt.TopKSpMVConfig(**HEADLINE))
    jraw = jt.TopKSpMV(jcoo, jt.TopKSpMVConfig(**RAW))
    peng = pt.TopKSpMV(coo, pt.TopKSpMVConfig(**HEADLINE), device="cpu")
    out = dict(coo=coo, qs=qs, jeng=jeng, peng=peng, dir=d)
    out["jq"] = {s: tuple(map(np.asarray, jeng.query(q)))
                 for s, q in qs.items()}
    out["jraw"] = {s: tuple(map(np.asarray, jraw.query(q)))
                   for s, q in qs.items()}
    jeng.save(str(d / "jax.npz"))
    peng.save(str(d / "port.npz"))
    jloaded = jt.TopKSpMV.load(str(d / "port.npz"), matrix=jcoo)
    out["jloaded_q"] = {s: tuple(map(np.asarray, jloaded.query(q)))
                        for s, q in qs.items()}
    return out


@pytest.mark.parametrize("seed", QUERY_SEEDS)
def test_query_matches_reference(ref, seed):
    ji, jv = ref["jq"][seed]
    pi, pv = ref["peng"].query(ref["qs"][seed])
    assert pi.dtype == torch.int32 and pv.dtype == torch.float32
    assert pi.shape == (100,) and (_np(pi) >= 0).all()
    np.testing.assert_array_equal(ji, _np(pi))
    np.testing.assert_allclose(jv, _np(pv), rtol=1e-6)


@pytest.mark.parametrize("seed", QUERY_SEEDS)
def test_raw_query_matches_reference(ref, seed):
    """Un-rescored path with tie-safe buffers: scaled h16 scores."""
    peng = pt.TopKSpMV(ref["coo"], pt.TopKSpMVConfig(**RAW), device="cpu")
    assert peng.config.tie_safe_topk
    ji, jv = ref["jraw"][seed]
    pi, pv = map(_np, peng.query(ref["qs"][seed]))
    np.testing.assert_array_equal(jv, pv)
    kth = pv[-1]
    assert set(ji[jv > kth].tolist()) == set(pi[pv > kth].tolist())


def test_jax_snapshot_loads_in_port(ref):
    peng = pt.TopKSpMV.load(str(ref["dir"] / "jax.npz"), device="cpu",
                            matrix=ref["coo"])
    assert peng.config == ref["peng"].config
    for seed in QUERY_SEEDS:
        ji, jv = ref["jq"][seed]
        pi, pv = peng.query(ref["qs"][seed])
        np.testing.assert_array_equal(ji, _np(pi))
        np.testing.assert_allclose(jv, _np(pv), rtol=1e-6)


def test_port_snapshot_loads_in_jax(ref):
    for seed in QUERY_SEEDS:
        np.testing.assert_array_equal(ref["jloaded_q"][seed][0],
                                      ref["jq"][seed][0])
    with np.load(ref["dir"] / "port.npz") as z, \
            np.load(ref["dir"] / "jax.npz") as y:
        for name in ("words", "nreal", "row_ids", "plan", "meta"):
            np.testing.assert_array_equal(z[name], y[name])


def test_snapshot_without_matrix_disables_rescore(ref):
    with pytest.warns(UserWarning, match="rescore_pool disabled"):
        peng = pt.TopKSpMV.load(str(ref["dir"] / "jax.npz"), device="cpu")
    assert peng.config.rescore_pool is None
    idx, vals = peng.query(ref["qs"][QUERY_SEEDS[0]])
    assert idx.shape == (100,) and np.isfinite(_np(vals)).all()


def test_from_reference_arrays(ref):
    jeng = ref["jeng"]
    f = jeng.fused
    assert all(isinstance(p, OctetBucket) for p in f.plan)
    meta = dict(config=dataclasses.asdict(jeng.config),
                block_sublanes=f.block_sublanes, num_blocks=f.num_blocks,
                num_rows=f.num_rows, num_cols=f.num_cols,
                num_nnz=f.num_nnz, value_scale=f.value_scale)
    plan = np.array([dataclasses.astuple(p) for p in f.plan], np.int64)
    peng = pt.TopKSpMV.from_reference_arrays(
        f.words, f.nreal, f.row_ids, plan, meta, device="cpu",
        matrix=ref["coo"])
    np.testing.assert_array_equal(octet_plan_array(peng.fused.plan), plan)
    assert isinstance(peng, torch.nn.Module)
    assert {n for n, _ in peng.named_buffers()} == \
        {"words", "nreal", "row_ids", "plan_rows"}
    assert peng.device == torch.device("cpu")
    assert peng.hbm_bytes == jeng.hbm_bytes
    assert peng.bytes_per_nnz == jeng.bytes_per_nnz
    seed = QUERY_SEEDS[1]
    np.testing.assert_array_equal(ref["jq"][seed][0],
                                  _np(peng(ref["qs"][seed])[0]))


def test_query_shape_and_k_override(ref):
    peng = ref["peng"]
    q = ref["qs"][QUERY_SEEDS[0]]
    with pytest.raises(ValueError, match="shape"):
        peng.query(q[:100])
    idx, vals = peng.query(q, k=10)
    np.testing.assert_array_equal(_np(idx), ref["jq"][QUERY_SEEDS[0]][0][:10])
    assert (np.diff(_np(vals)) <= 0).all()


@pytest.mark.parametrize("kw", [
    pytest.param(dict(fused_layout="slice", query_codec="i8s"),
                 id="kw0-item 5"),
    pytest.param(dict(query_codec="f32"), id="kw1-item 5"),
    pytest.param(dict(query_codec="i4s"), id="kw2-item 5"),
    pytest.param(dict(fused_layout="slice", query_codec="int8x4"),
                 id="kw3-item 5"),
    pytest.param(dict(num_partitions=2, query_codec="i4s"), id="kw4-item 8"),
    pytest.param(dict(fused_layout="slice", num_partitions=2,
                      query_codec="i8s"), id="kw5-item 8")])
def test_unported_configs_raise(kw):
    """The configurations that raised before every codec ran in the port
    build, and answer a query with the plain path's top 100: the
    un-rescored query() equals finalize_topk of the plain sweep, scaled by
    the query scale. The name and ids are those of the earlier test that
    held these configurations to NotImplementedError; they are kept so the
    test keeps its identity."""
    coo = create_sparse_matrix(300, 256, 8, "gamma", seed=1)
    cfg = pt.TopKSpMVConfig(**dict(HEADLINE, **kw))
    eng = pt.TopKSpMV(coo, cfg, device="cpu")
    q = create_query_batch(1, 256, seed=2)[0]
    idx, vals = map(_np, eng.query(q, rescore_pool=0))
    table, scale = eng._table(q)
    kw = dict(lane_k=cfg.lane_k, fold_tile=cfg.fold_tile,
              tie_safe=bool(cfg.tie_safe_topk),
              block_sublanes=cfg.fused_block_sublanes,
              codec=cfg.query_codec, **eng.partition_kw)
    plain = (pkernel.octet_topk_plain if cfg.fused_layout == "octet"
             else pkernel.slice_topk_plain)
    tv, tt = plain(eng.words, table, eng.nreal, eng.plan_rows, **kw)
    pi, pv = map(_np, pkernel.finalize_topk(tv, tt, eng.row_ids, k=100))
    np.testing.assert_array_equal(idx, pi)
    np.testing.assert_array_equal(vals, pv * np.float32(scale))
    assert (idx >= 0).all() and np.isfinite(vals).all()


@pytest.mark.parametrize("layout", ["octet", "slice"])
def test_unported_entry_points_raise(layout):
    """Each sweep takes each codec's query table (``_table_spec``: rows and
    dtype) and returns its shapes: candidates (lane_k, 128), a batch's
    (Q, lane_k, 128), scores (num_slices, 128). The name is that of the
    earlier test that held the sweeps to NotImplementedError for the codecs
    not yet ported; it is kept so the test keeps its identity."""
    coo = create_sparse_matrix(300, 256, 8, "gamma", seed=1)
    eng = pt.TopKSpMV(coo, pt.TopKSpMVConfig(**dict(
        HEADLINE, fused_layout=layout)), device="cpu")
    n = eng.row_ids.shape[0]
    bs = eng.fused.block_sublanes
    if layout == "octet":
        sweeps = (pkernel.topk_spmv_fused_octet_device,
                  pkernel.topk_spmv_fused_batch_octet_device,
                  pkernel.spmv_fused_scores_octet_device)
    else:
        sweeps = (pkernel.topk_spmv_fused_device,
                  pkernel.topk_spmv_fused_batch_device,
                  pkernel.spmv_fused_scores_device)
    for codec in ("h16", "f32", "int8x4", "i8s", "i4s"):
        cfg = dataclasses.replace(eng.config, query_codec=codec)
        rows, dtype = pkernel._table_spec(cfg)
        table = torch.zeros((rows, 128), dtype=dtype)
        args = (eng.words, table, eng.nreal, eng.plan_rows)
        tv, tt = sweeps[0](*args, cfg=cfg, block_sublanes=bs)
        assert tv.shape == tt.shape == (cfg.lane_k, 128), codec
        bv, _ = sweeps[1](args[0], torch.stack([table] * 2), *args[2:],
                          cfg=cfg, block_sublanes=bs)
        assert bv.shape == (2, cfg.lane_k, 128), codec
        sc = sweeps[2](*args, cfg=cfg, block_sublanes=bs, num_slices=n)
        assert sc.shape == (n, 128) and sc.dtype == torch.float32, codec


@pytest.mark.parametrize("codec,cols", [("i8s", 1152), ("i4s", 2176),
                                        ("int4", None)],
                         ids=["i8s_past_1024", "i4s_past_2048", "unknown"])
def test_codec_limits_raise(codec, cols):
    """The config's own limits still refuse a codec: i8s past 1024
    columns, i4s past 2048 (also when the engine widens max_cols to the
    matrix), and a codec that does not exist."""
    match = "unknown query codec" if cols is None else codec
    with pytest.raises(ValueError, match=match):
        pt.TopKSpMVConfig(**dict(HEADLINE, query_codec=codec,
                                 max_cols=cols or 1024))
    if cols:
        coo = create_sparse_matrix(300, cols, 8, "gamma", seed=1)
        with pytest.raises(ValueError, match=match):
            pt.TopKSpMV(coo, pt.TopKSpMVConfig(**dict(
                HEADLINE, query_codec=codec)), device="cpu")


def test_device_is_required():
    coo = create_sparse_matrix(300, 256, 8, "gamma", seed=1)
    with pytest.raises(TypeError):
        pt.TopKSpMV(coo, pt.TopKSpMVConfig(**HEADLINE))


def test_import_leaves_jax_out():
    """Every module of the port (walked with pkgutil), the measurement labs,
    the command line (``__main__`` too), the evaluation tools, the
    experiment drivers and the examples included, imports neither jax nor
    the JAX package, nor pandas or matplotlib (the card's host has
    neither); a lab, tool or example parses no arguments and needs no
    card at import."""
    code = ("import importlib, pkgutil, sys, spmv_topk_tpu_torch as p; "
            "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
            "p.__name__ + '.')]; "
            "[importlib.import_module(m) for m in mods]; "
            "want = {p.__name__ + '.' + m for m in ('api', 'ops.kernel', "
            "'ops.gold', 'ops.xla_ref', 'formats.sell', 'formats.bscsr', "
            "'formats.mtx', 'topk.merge', 'eval.metrics', "
            "'eval.accuracy_model', 'utils.native', 'experiments._common', "
            "'experiments.kernel_lab', 'experiments.fused_lab', "
            "'experiments.h16_lab', 'experiments.fold_lab', "
            "'experiments.batch_lab', 'experiments.dma_lab', "
            "'experiments.i16_probe', 'experiments.mxu_gather_lab', "
            "'cli', '__main__', 'tune', 'utils.profiling', 'bench.harness', "
            "'bench.sweep', 'bench.service', 'bench.cpu_baseline', "
            "'bench.capacity', 'bench.accuracy_sweep', 'bench.full_eval', "
            "'bench.plots', 'experiments._drivers', 'experiments.padding_lab', "
            "'experiments.cfg_sweep', 'experiments.q1_ab', "
            "'experiments.octet_lab', 'experiments.octet_batch_lab', "
            "'experiments.octet_block_lab', 'experiments.octet_multicall_lab', "
            "'examples.quickstart', 'examples.mtx_search', "
            "'examples.multihost')}; "
            "assert want <= set(mods), sorted(want - set(mods)); "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib')) or m == 'spmv_topk_tpu' or "
            "m.startswith('spmv_topk_tpu.') or m in ('pandas', "
            "'matplotlib')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
