"""The port's plain SpMV (``scores``, kernel K4) against the JAX package's
on the CPU.

The port runs the plain version of K4 here; the JAX engines run their
Pallas scores kernel in interpret mode: two programs, width quantum 2
with fused blocks of 128 (the headline geometry at test size) and width
quantum 1 with fused blocks of 64 (wide octets), each compiled once in
the module fixture. Tolerances: none. h16 scores are int32 sums
converted to f32 once and multiplied by the same f32 scale in both
packages, so ``scores()`` must be bit-equal, on a built engine and on a
snapshot the JAX package wrote.
"""

import dataclasses

import numpy as np
import pytest
import torch

import spmv_topk_tpu as jt
from spmv_topk_tpu.formats import create_sparse_matrix as jax_matrix

import spmv_topk_tpu_torch as pt
from spmv_topk_tpu_torch.formats import (create_query_batch,
                                         create_sparse_matrix)
from spmv_topk_tpu_torch.ops import kernel as pkernel

HEADLINE = dict(k=100, lane_k=8, max_cols=1024, query_codec="h16",
                fused_layout="octet", width_quantum=2, fold_tile=8,
                rescore_pool=400, block_sublanes=64,
                fused_block_sublanes=128)
GEOMETRIES = {"q2": HEADLINE,
              "q1_wide": dict(HEADLINE, width_quantum=1,
                              fused_block_sublanes=64)}
QUERY_SEEDS = (41, 42)


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("scores")
    coo = create_sparse_matrix(3000, 1024, 20, "gamma", seed=5)
    jcoo = jax_matrix(3000, 1024, 20, "gamma", seed=5)
    qs = {s: create_query_batch(1, 1024, seed=s)[0] for s in QUERY_SEEDS}
    out = dict(coo=coo, qs=qs, js={}, jeng={})
    for name, kw in GEOMETRIES.items():
        jeng = jt.TopKSpMV(jcoo, jt.TopKSpMVConfig(**kw))
        out["jeng"][name] = jeng
        out["js"][name] = {s: np.asarray(jeng.scores(q))
                           for s, q in qs.items()}
        jeng.save(str(d / f"{name}.npz"))
    out["dir"] = d
    return out


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_scores_match_reference(ref, geometry):
    peng = pt.TopKSpMV(ref["coo"], pt.TopKSpMVConfig(**GEOMETRIES[geometry]),
                       device="cpu")
    if geometry == "q1_wide":
        assert any(p.blocks_per_octet > 1 for p in peng.fused.plan)
    for s, q in ref["qs"].items():
        got = peng.scores(q)
        assert got.dtype == torch.float32 and got.shape == (3000,)
        np.testing.assert_array_equal(ref["js"][geometry][s], _np(got))


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_jax_snapshot_scores_match_reference(ref, geometry):
    """A snapshot the JAX package wrote serves scores() with no rescore
    matrix: scores read only the packed stream."""
    with pytest.warns(UserWarning, match="rescore_pool disabled"):
        peng = pt.TopKSpMV.load(str(ref["dir"] / f"{geometry}.npz"),
                                device="cpu")
    for s, q in ref["qs"].items():
        np.testing.assert_array_equal(ref["js"][geometry][s],
                                      _np(peng.scores(q)))


def test_from_reference_arrays_serves_scores(ref):
    jeng = ref["jeng"]["q2"]
    f = jeng.fused
    meta = dict(config=dataclasses.asdict(jeng.config),
                block_sublanes=f.block_sublanes, num_blocks=f.num_blocks,
                num_rows=f.num_rows, num_cols=f.num_cols,
                num_nnz=f.num_nnz, value_scale=f.value_scale)
    plan = np.array([dataclasses.astuple(p) for p in f.plan], np.int64)
    peng = pt.TopKSpMV.from_reference_arrays(
        f.words, f.nreal, f.row_ids, plan, meta, device="cpu",
        matrix=ref["coo"])
    s = QUERY_SEEDS[0]
    np.testing.assert_array_equal(ref["js"]["q2"][s],
                                  _np(peng.scores(ref["qs"][s])))


def test_batch_candidates_score_what_scores_does(ref):
    """Each batched query's un-rescored candidates carry the integer sums
    that scores() gives their rows. The two scale them differently (the
    batch path by a float32 query scale times value_scale in float32,
    scores() by a float64 one), so the sums are compared, and the scaled
    values to float32 rounding."""
    cfg = pt.TopKSpMVConfig(**dict(HEADLINE, rescore_pool=None))
    peng = pt.TopKSpMV(ref["coo"], cfg, device="cpu")
    qs = np.stack([ref["qs"][s] for s in QUERY_SEEDS])
    bi, bv = map(_np, peng.query_batch(qs, group_size=2))
    _, bscales = pt.ops.quantized_query.pack_query_tables(qs, "h16")
    for j, q in enumerate(qs):
        sc = _np(peng.scores(q))
        _, sscale = pt.ops.quantized_query.pack_query_table(q, "h16")
        assert (bi[j] >= 0).all()
        np.testing.assert_allclose(bv[j], sc[bi[j]], rtol=2e-7)
        vs = peng.fused.value_scale
        np.testing.assert_array_equal(
            np.rint(bv[j] / (np.float32(bscales[j]) * np.float32(vs))),
            np.rint(sc[bi[j]] / np.float32(sscale * vs)))


def test_scores_wrapper_on_cpu_runs_plain_without_launch(ref):
    """The wrapper takes the plain version on CPU tensors; its rows are
    slice order, and rows of no real slice (the sentinel) stay 0."""
    peng = pt.TopKSpMV(ref["coo"], pt.TopKSpMVConfig(**HEADLINE),
                       device="cpu")
    table, _ = peng._table(ref["qs"][QUERY_SEEDS[0]])
    before = pkernel.spmv_fused_scores_octet_device.launches
    out = pkernel.spmv_fused_scores_octet_device(
        peng.words, table, peng.nreal, peng.plan_rows, cfg=peng.config,
        block_sublanes=peng.fused.block_sublanes,
        num_slices=peng.row_ids.shape[0])
    assert pkernel.spmv_fused_scores_octet_device.launches == before
    assert out.shape == (peng.row_ids.shape[0], 128)
    assert (out[-1] == 0).all()
    plain = pkernel.octet_scores_plain(
        peng.words, table, peng.nreal, peng.plan_rows,
        num_slices=peng.row_ids.shape[0],
        block_sublanes=peng.fused.block_sublanes)
    assert torch.equal(out, plain)
    meta = dict(dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        pkernel.spmv_fused_scores_octet_device(
            torch.empty((128, 128), **meta), torch.empty((1, 128), **meta),
            torch.empty((1, 1), **meta), torch.empty((1, 8), **meta),
            cfg=peng.config, block_sublanes=128, num_slices=2)


def test_scores_track_exact_spmv(ref):
    """h16 values are 6-bit and the query 4-bit: scores() follows the
    exact f32 product to within that quantization."""
    peng = pt.TopKSpMV(ref["coo"], pt.TopKSpMVConfig(**HEADLINE),
                       device="cpu")
    q = ref["qs"][QUERY_SEEDS[1]]
    exact = ref["coo"].to_scipy_csr() @ q
    got = _np(peng.scores(q))
    assert np.corrcoef(exact, got)[0, 1] > 0.99
    with pytest.raises(ValueError, match="shape"):
        peng.scores(q[:10])
