"""Host side of the PyTorch port against the JAX package: config, corpus
generation, the h16 octet pack and the query table.

All of it is NumPy on both sides, so every comparison is exact: the same
seed and config must give bit-identical arrays, or a snapshot of one
package would not serve the other.
"""

import dataclasses

import numpy as np
import pytest

import spmv_topk_tpu.config as jcfg
from spmv_topk_tpu.formats import synthetic as jsyn
from spmv_topk_tpu.formats.sell_buckets import (fuse_buckets as jfuse_slice,
                                                fuse_buckets_octet as jfuse,
                                                pack_sell_buckets as jpack)
from spmv_topk_tpu.ops.quantized_query import (
    pack_query_table as jpack_query)

import spmv_topk_tpu_torch.config as pcfg
from spmv_topk_tpu_torch.formats import coo as pcoo
from spmv_topk_tpu_torch.formats import synthetic as psyn
from spmv_topk_tpu_torch.formats.sell_buckets import (
    fuse_buckets as pfuse_slice, fuse_buckets_octet as pfuse,
    octet_plan_array, octet_plan_from_array, pack_sell_buckets as ppack,
    slice_plan_array, slice_plan_from_array)
from spmv_topk_tpu_torch.ops.quantized_query import (
    pack_query_table as ppack_query)
from spmv_topk_tpu_torch.utils import native

# The headline config (bench.py) with the small test geometry set
# explicitly: tests/conftest.py shrinks only the JAX config's defaults.
HEADLINE = dict(k=100, lane_k=8, max_cols=1024, query_codec="h16",
                fused_layout="octet", width_quantum=2, fold_tile=8,
                rescore_pool=400, block_sublanes=64,
                fused_block_sublanes=128)
# 32-sublane blocks: every bucket wider than 4 words has wide octets
WIDE = dict(HEADLINE, block_sublanes=32, fused_block_sublanes=32)


# the slice layout: the default engine (f32 codec, quantum 8) and
# bench.py's batch engine (h16, quantum 2), at test geometry
SLICE = dict(k=100, block_sublanes=64, fused_block_sublanes=128)
SLICE_H16 = dict(SLICE, query_codec="h16", width_quantum=2, fold_tile=8,
                 rescore_pool=400)


def _pack_both(kw, rows=3000, seed=5):
    jc, pc = jcfg.TopKSpMVConfig(**kw), pcfg.TopKSpMVConfig(**kw)
    a = jsyn.create_sparse_matrix(rows, 1024, 20, "gamma", seed=seed)
    b = psyn.create_sparse_matrix(rows, 1024, 20, "gamma", seed=seed)
    slice_ = kw.get("fused_layout", "slice") == "slice"
    jf = (jfuse_slice if slice_ else jfuse)(
        jpack(a, jc), block_sublanes=kw["fused_block_sublanes"])
    pf = (pfuse_slice if slice_ else pfuse)(
        ppack(b, pc), block_sublanes=kw["fused_block_sublanes"])
    return jf, pf


@pytest.mark.parametrize("kw", [
    {}, dict(query_codec="h16", rescore_pool=400), dict(fused_layout="octet",
                                                        fold_tile=8),
    dict(tie_safe_topk=True, width_quantum=1)])
def test_config_asdict_identical(kw):
    """Same fields, defaults and tie-safe resolution: one snapshot's
    meta["config"] builds the same config in both packages (geometry set
    explicitly: the JAX defaults are shrunk under this test suite)."""
    kw = dict(kw, block_sublanes=64, fused_block_sublanes=128)
    j, p = jcfg.TopKSpMVConfig(**kw), pcfg.TopKSpMVConfig(**kw)
    assert dataclasses.asdict(j) == dataclasses.asdict(p)
    assert [f.name for f in dataclasses.fields(j)] == \
        [f.name for f in dataclasses.fields(p)]


@pytest.mark.parametrize("kw", [
    dict(max_cols=1000), dict(query_codec="h16", max_cols=2048),
    dict(width_quantum=3), dict(fused_layout="octet", fold_tile=4),
    dict(fused_layout="octet", num_partitions=2, sigma_sort=False),
    dict(layout="streamed"), dict(query_codec="bogus")])
def test_config_validation_identical(kw):
    with pytest.raises(ValueError):
        jcfg.TopKSpMVConfig(**kw)
    with pytest.raises(ValueError):
        pcfg.TopKSpMVConfig(**kw)


@pytest.mark.parametrize("dist,seed", [("gamma", 1), ("gamma", 11),
                                       ("uniform", 2)])
def test_corpus_identical(dist, seed):
    a = jsyn.create_sparse_matrix(2000, 1024, 20, dist, seed=seed)
    b = psyn.create_sparse_matrix(2000, 1024, 20, dist, seed=seed)
    for name in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    assert (a.num_rows, a.num_cols) == (b.num_rows, b.num_cols)
    np.testing.assert_array_equal(
        jsyn.create_query_batch(4, 1024, seed=seed),
        psyn.create_query_batch(4, 1024, seed=seed))
    np.testing.assert_array_equal(
        jsyn.create_sample_vector(1024, seed=seed),
        psyn.create_sample_vector(1024, seed=seed))


@pytest.mark.parametrize("kw", [HEADLINE, WIDE], ids=["headline", "wide"])
def test_octet_pack_bit_identical(kw):
    jf, pf = _pack_both(kw)
    np.testing.assert_array_equal(jf.words, pf.words)
    np.testing.assert_array_equal(jf.nreal, pf.nreal)
    np.testing.assert_array_equal(jf.row_ids, pf.row_ids)
    assert [dataclasses.astuple(p) for p in jf.plan] == \
        [dataclasses.astuple(p) for p in pf.plan]
    assert jf.value_scale == pf.value_scale
    assert (jf.block_sublanes, jf.num_blocks) == \
        (pf.block_sublanes, pf.num_blocks)
    if kw is WIDE:
        assert any(p.blocks_per_octet > 1 for p in pf.plan)


@pytest.mark.parametrize("kw", [
    SLICE, dict(SLICE, width_quantum=2), dict(SLICE, width_quantum=1),
    dict(SLICE, fused_block_sublanes=32), SLICE_H16,
    dict(SLICE_H16, fused_block_sublanes=32)],
    ids=["f32_q8", "f32_q2", "f32_q1", "f32_q8_wide", "h16_q2",
         "h16_q2_wide"])
def test_slice_pack_bit_identical(kw):
    """fuse_buckets and the f32 word pack (col << 16 | bf16) against the
    JAX package's, narrow and wide buckets."""
    jf, pf = _pack_both(kw)
    np.testing.assert_array_equal(jf.words, pf.words)
    np.testing.assert_array_equal(jf.nreal, pf.nreal)
    np.testing.assert_array_equal(jf.row_ids, pf.row_ids)
    assert [dataclasses.astuple(p) for p in jf.plan] == \
        [dataclasses.astuple(p) for p in pf.plan]
    assert jf.value_scale == pf.value_scale
    assert (jf.block_sublanes, jf.num_blocks) == \
        (pf.block_sublanes, pf.num_blocks)
    wide = any(p.blocks_per_slice > 1 for p in pf.plan)
    assert wide == (kw["fused_block_sublanes"] == 32)


def test_slice_plan_array_roundtrip():
    _, pf = _pack_both(SLICE_H16)
    arr = slice_plan_array(pf.plan)
    assert arr.shape == (len(pf.plan), 6) and arr.dtype == np.int64
    assert slice_plan_from_array(arr) == pf.plan


def test_native_and_numpy_f32_pack_agree(monkeypatch):
    """The native f32 scatter and its NumPy path pack the same words."""
    assert native.available(), native.load_error
    _, with_native = _pack_both(SLICE, rows=1500, seed=9)
    monkeypatch.setattr(native, "_load", lambda: None)
    _, without = _pack_both(SLICE, rows=1500, seed=9)
    np.testing.assert_array_equal(with_native.words, without.words)
    np.testing.assert_array_equal(with_native.row_ids, without.row_ids)


def test_plan_array_roundtrip():
    _, pf = _pack_both(HEADLINE)
    arr = octet_plan_array(pf.plan)
    assert arr.shape == (len(pf.plan), 7) and arr.dtype == np.int64
    assert octet_plan_from_array(arr) == pf.plan


def test_native_and_numpy_pack_agree(monkeypatch):
    """The native h16 scatter and plan and their NumPy paths pack the
    same words (the NumPy body is the fallback when the runtime does not
    build)."""
    assert native.available(), native.load_error
    _, with_native = _pack_both(HEADLINE, rows=1500, seed=9)
    monkeypatch.setattr(native, "_load", lambda: None)
    _, without = _pack_both(HEADLINE, rows=1500, seed=9)
    np.testing.assert_array_equal(with_native.words, without.words)
    np.testing.assert_array_equal(with_native.row_ids, without.row_ids)


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_query_table_identical(seed):
    q = psyn.create_sample_vector(1024, seed=seed)
    jt, js = jpack_query(q, "h16")
    pt, ps = ppack_query(q, "h16")
    np.testing.assert_array_equal(jt, pt)
    assert jt.dtype == pt.dtype == np.int32 and jt.shape == (1, 128)
    assert js == ps
    jt, js = jpack_query(q, "f32")
    pt, ps = ppack_query(q, "f32")
    np.testing.assert_array_equal(jt, pt)
    assert pt.dtype == np.float32 and pt.shape == (8, 128)
    assert js == ps == 1.0


def test_coo_scipy_roundtrip():
    m = psyn.create_sparse_matrix(500, 256, 8, "gamma", seed=3)
    assert m.is_sorted_row_major()
    csr = m.to_scipy_csr()
    back = pcoo.from_scipy(csr)
    np.testing.assert_array_equal(back.cols, m.cols)
    np.testing.assert_allclose(csr.toarray(), m.to_scipy().toarray())
    shuffled = pcoo.CooMatrix(m.rows[::-1], m.cols[::-1], m.vals[::-1],
                              m.num_rows, m.num_cols)
    assert not shuffled.is_sorted_row_major()
    np.testing.assert_array_equal(shuffled.sort_row_major().cols, m.cols)
