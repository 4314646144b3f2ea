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


@pytest.mark.parametrize("kw,match", [
    (dict(fused_layout="slice"), "item 7"),
    (dict(query_codec="f32"), "item 5"),
    (dict(query_codec="i4s"), "item 5"),
    (dict(num_partitions=2), "item 8")])
def test_unported_configs_raise(kw, match):
    coo = create_sparse_matrix(300, 256, 8, "gamma", seed=1)
    cfg = pt.TopKSpMVConfig(**dict(HEADLINE, **kw))
    with pytest.raises(NotImplementedError, match=match):
        pt.TopKSpMV(coo, cfg, device="cpu")


def test_unported_entry_points_raise(ref):
    peng = ref["peng"]
    q = ref["qs"][QUERY_SEEDS[0]]
    with pytest.raises(NotImplementedError, match="item 6"):
        peng.query_batch(q[None])
    with pytest.raises(NotImplementedError, match="item 4"):
        peng.scores(q)


def test_device_is_required():
    coo = create_sparse_matrix(300, 256, 8, "gamma", seed=1)
    with pytest.raises(TypeError):
        pt.TopKSpMV(coo, pt.TopKSpMVConfig(**HEADLINE))


def test_import_leaves_jax_out():
    """The port imports neither jax nor the JAX package."""
    code = ("import sys, spmv_topk_tpu_torch, spmv_topk_tpu_torch.api, "
            "spmv_topk_tpu_torch.ops.kernel, "
            "spmv_topk_tpu_torch.ops.streamprobe, "
            "spmv_topk_tpu_torch.formats; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib')) or m == 'spmv_topk_tpu' or "
            "m.startswith('spmv_topk_tpu.')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
