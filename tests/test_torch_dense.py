"""The port's dense engine (``spmv_topk_tpu_torch.ops.dense``) against the
JAX package's (``spmv_topk_tpu.ops.dense``) on the CPU.

Both densify with the same NumPy code, and the port's on-device densify
(``densify_device``, the engine's path on a card) is held to it here on
CPU tensors: bit-identical arrays. Off the TPU both engines widen bf16 to
float32 and take an exact top-k per block (JAX's ``approx_max_k`` is a
sort and slice there). Tolerances:
  - int8: integer sums, one float32 multiply by each scale: values bit
    for bit on any data;
  - bf16: bit for bit on exact-sum data (small-integer matrix values and
    queries, every partial sum exact in float32), to rtol 1e-6 on real
    data (torch.mm and XLA's dot add the products in other orders);
  - rows equal above the k-th value (the two top-k may keep different
    rows among ties at the k-th value);
  - with the exact rescore, values bit for bit (the same CSR sums).
"""

import numpy as np
import pytest
import torch

import spmv_topk_tpu as jt
from spmv_topk_tpu.formats import CooMatrix as JCoo
from spmv_topk_tpu.ops import dense as jdense

import spmv_topk_tpu_torch as pt
from spmv_topk_tpu_torch.formats import (CooMatrix, create_query_batch,
                                         create_sample_vector,
                                         create_sparse_matrix)
from spmv_topk_tpu_torch.ops import dense as pdense

from rescore_paths import load_both_natives

CPU = torch.device("cpu")
COLS = 256


@pytest.fixture(scope="module", autouse=True)
def _native_rescore():
    """Both packages rescore through their native runtimes, before any
    engine is built (rescore_paths.py: the JAX package's build races
    between test workers, and its NumPy path differs by an ulp)."""
    load_both_natives()


def _jcoo(coo):
    return JCoo(coo.rows, coo.cols, coo.vals, coo.num_rows, coo.num_cols)


def _integer_valued(coo, seed):
    """coo with small nonzero integer values (exact in bf16)."""
    rng = np.random.default_rng(seed)
    v = rng.integers(1, 9, coo.nnz) * rng.choice([-1, 1], coo.nnz)
    return CooMatrix(coo.rows, coo.cols, v.astype(np.float32),
                     coo.num_rows, coo.num_cols)


def _int_queries(n, seed):
    return np.random.default_rng(seed).integers(
        -8, 9, (n, COLS)).astype(np.float32)


def _same_top(idx, vals, ref_idx, ref_vals, rtol, what=""):
    idx, vals = np.asarray(idx), np.asarray(vals)
    ref_idx, ref_vals = np.asarray(ref_idx), np.asarray(ref_vals)
    if rtol:
        np.testing.assert_allclose(vals, ref_vals, rtol=rtol, atol=1e-7,
                                   err_msg=what)
    else:
        np.testing.assert_array_equal(vals, ref_vals, err_msg=what)
    kth = ref_vals[-1] + rtol * abs(ref_vals[-1]) + (1e-7 if rtol else 0)
    assert set(idx[vals > kth].tolist()) == \
        set(ref_idx[ref_vals > kth].tolist()), what


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_densify_bit_identical(dtype):
    coo = create_sparse_matrix(700, COLS, 8, "gamma", seed=401)
    if dtype == "bf16":
        got = pdense.densify_bf16(coo, row_block=300)
        np.testing.assert_array_equal(
            got, jdense.densify_bf16(_jcoo(coo), row_block=300))
        dev, _ = pdense.densify_device(coo, "bf16", CPU, 1024, row_block=300)
        assert dev.dtype == torch.bfloat16 and dev.shape == (1024, COLS)
        np.testing.assert_array_equal(
            dev[:700].view(torch.int16).numpy().view(np.uint16), got)
        assert not dev[700:].view(torch.int16).any()
    else:
        got, sc = pdense.densify_int8(coo, row_block=300)
        ref, rsc = jdense.densify_int8(_jcoo(coo), row_block=300)
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(sc, rsc)
        dev, dsc = pdense.densify_device(coo, "int8", CPU, 1024,
                                         row_block=300)
        np.testing.assert_array_equal(dev[:700].numpy(), got)
        np.testing.assert_array_equal(dsc[:700].numpy(), sc)
        assert not dev[700:].any() and (dsc[700:] == 1).all()


def test_densify_device_sums_duplicates():
    """Duplicate (row, col) entries are summed, as to_scipy() sums them
    for the NumPy densify; an empty row scales by 1."""
    rows = np.array([0, 0, 0, 2, 2], np.int32)
    cols = np.array([3, 3, 7, 1, 1], np.int32)
    vals = np.array([0.5, 0.25, -1.0, 3.0, -0.125], np.float32)
    coo = CooMatrix(rows, cols, vals, 3, COLS)
    for dtype in ("bf16", "int8"):
        ref = (pdense.densify_bf16(coo) if dtype == "bf16"
               else pdense.densify_int8(coo))
        got, sc = pdense.densify_device(coo, dtype, CPU)
        if dtype == "bf16":
            np.testing.assert_array_equal(
                got.view(torch.int16).numpy().view(np.uint16), ref)
        else:
            np.testing.assert_array_equal(got.numpy(), ref[0])
            np.testing.assert_array_equal(sc.numpy(), ref[1])


def test_quantize_queries_bit_identical():
    qs = create_query_batch(4, COLS, seed=402)
    qs[1] = 0.0
    qi, sc = pdense.quantize_queries_int8(qs)
    ri, rsc = jdense.quantize_queries_int8(qs)
    np.testing.assert_array_equal(qi.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(sc.numpy(), np.asarray(rsc))


@pytest.mark.parametrize("data", ["exact", "real"])
@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_dense_topk_batch_matches_jax(dtype, data):
    """The block sweep with pad rows (1100 real rows in blocks of 512)."""
    coo = create_sparse_matrix(1100, COLS, 9, "gamma", seed=403)
    qs = create_query_batch(3, COLS, seed=404)
    if data == "exact":
        coo, qs = _integer_valued(coo, 405), _int_queries(3, 406)
    if dtype == "int8":
        bits, sc = pdense.densify_int8(coo)
        pad = (-bits.shape[0]) % 512
        bits = np.concatenate([bits, np.zeros((pad, COLS), np.int8)])
        sc = np.concatenate([sc, np.ones(pad, np.float32)])
        qi, qsc = pdense.quantize_queries_int8(qs)
        gi, gv = pdense.dense_topk_batch(
            torch.from_numpy(bits), qi, 1100, torch.from_numpy(sc), qsc,
            k=30, block_rows=512)
        ji, jsc = jdense.quantize_queries_int8(qs)
        ri, rv = jdense.dense_topk_batch(bits, ji, 1100, sc, jsc, k=30,
                                         block_rows=512)
        rtol = 0.0
    else:
        bits = pdense.densify_bf16(coo)
        pad = (-bits.shape[0]) % 512
        bits = np.concatenate([bits, np.zeros((pad, COLS), np.uint16)])
        A = (bits.astype(np.uint32) << 16).view(np.float32)
        gi, gv = pdense.dense_topk_batch(
            torch.from_numpy(A), torch.from_numpy(qs), 1100, k=30,
            block_rows=512)
        ri, rv = jdense.dense_topk_batch(A, qs, 1100, k=30, block_rows=512)
        rtol = 0.0 if data == "exact" else 1e-6
    assert gi.dtype == torch.int32 and tuple(gi.shape) == (3, 30)
    for j in range(3):
        _same_top(gi[j], gv[j], np.asarray(ri)[j], np.asarray(rv)[j], rtol,
                  f"query {j}")


ENGINE_ROWS = 3000


@pytest.fixture(scope="module")
def corpus():
    coo = create_sparse_matrix(ENGINE_ROWS, COLS, 10, "gamma", seed=410)
    return coo, create_query_batch(4, COLS, seed=411)


@pytest.mark.parametrize("pool", [None, 120])
@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_engine_matches_jax(corpus, dtype, pool):
    coo, qs = corpus
    kw = dict(block_rows=1024, dtype=dtype)
    cfg = dict(k=25, max_cols=COLS, rescore_pool=pool)
    eng = pt.DenseTopKSpMV(coo, pt.TopKSpMVConfig(**cfg), device=CPU, **kw)
    ref = jt.DenseTopKSpMV(_jcoo(coo), jt.TopKSpMVConfig(**cfg), **kw)
    assert eng.block_rows == ref.block_rows
    assert eng.recall_target == ref.recall_target
    assert eng.hbm_bytes == ref.hbm_bytes
    bi, bv = eng.query_batch(qs)
    ri, rv = map(np.asarray, ref.query_batch(qs))
    rtol = 1e-6 if dtype == "bf16" and not pool else 0.0
    for j in range(len(qs)):
        _same_top(bi[j], bv[j], ri[j], rv[j], rtol, f"query {j}")
    # one query against the batch: a float32 product of one row may add
    # in another order than one of four (gemv against gemm)
    i0, v0 = eng.query(qs[0])
    _same_top(i0, v0, bi[0].numpy(), bv[0].numpy(),
              1e-6 if dtype == "bf16" else 0.0, "query() and the batch")
    # the engine from the JAX engine's arrays serves the same answers
    scales = None if ref._scales is None else np.asarray(ref._scales)
    back = pt.DenseTopKSpMV.from_reference_arrays(
        np.asarray(ref._A), scales, num_rows=ENGINE_ROWS,
        config=pt.TopKSpMVConfig(**cfg), device=CPU,
        block_rows=ref.block_rows, recall_target=ref.recall_target,
        matrix=coo)
    assert back.dtype == dtype and back.hbm_bytes == eng.hbm_bytes
    for a, b in zip(back.query_batch(qs), (bi, bv)):
        assert torch.equal(a, b)


def test_int8_halves_bytes_and_recall_rule(corpus):
    coo, _ = corpus
    cfg = pt.TopKSpMVConfig(k=25, max_cols=COLS)
    e8 = pt.DenseTopKSpMV(coo, cfg, device=CPU, block_rows=1024,
                          dtype="int8")
    e16 = pt.DenseTopKSpMV(coo, cfg, device=CPU, block_rows=1024)
    assert e8.hbm_bytes * 2 == e16.hbm_bytes == 2 * 3072 * COLS
    assert e16.recall_target == 0.98            # 3 blocks
    e4 = pt.DenseTopKSpMV(coo, cfg, device=CPU, block_rows=512)
    assert e4.recall_target == 0.95             # 6 blocks
    big = pt.DenseTopKSpMV(coo, cfg, device=CPU)  # capped to the corpus
    assert big.block_rows == 3072


def test_memory_guard(corpus):
    coo, _ = corpus
    cfg = pt.TopKSpMVConfig(k=25, max_cols=COLS)
    with pytest.raises(ValueError, match="budget"):
        pt.DenseTopKSpMV(coo, cfg, device=CPU, hbm_budget_bytes=1000)
    # int8 fits a budget the bf16 form does not
    need16 = 2 * 3072 * COLS
    with pytest.raises(ValueError, match="budget"):
        pt.DenseTopKSpMV(coo, cfg, device=CPU, hbm_budget_bytes=need16 - 1)
    pt.DenseTopKSpMV(coo, cfg, device=CPU, hbm_budget_bytes=need16 - 1,
                     dtype="int8")
    assert pdense.device_budget(CPU) is None
    with pytest.raises(ValueError, match="dtype"):
        pt.DenseTopKSpMV(coo, cfg, device=CPU, dtype="fp8")


def test_pad_rows_do_not_displace_negative_scores():
    """Pad rows score 0 from zero vectors; with all-negative real scores
    they must not displace real rows (tests/test_dense.py's case)."""
    rng = np.random.default_rng(120)
    n, d = 1100, 6          # 1100 rows -> pads to 2048 at block 1024
    rows = np.repeat(np.arange(n, dtype=np.int32), d)
    cols = np.concatenate(
        [rng.choice(COLS, d, replace=False) for _ in range(n)]).astype(
            np.int32)
    vals = -np.abs(rng.standard_normal(n * d)).astype(np.float32)
    coo = CooMatrix(rows, cols, vals, n, COLS).sort_row_major()
    q = np.abs(rng.standard_normal(COLS)).astype(np.float32)
    for dtype in ("bf16", "int8"):
        eng = pt.DenseTopKSpMV(coo, pt.TopKSpMVConfig(k=30, max_cols=COLS),
                               device=CPU, block_rows=1024, dtype=dtype)
        idx, vals_out = eng.query(q)
        assert (idx >= 0).all() and (vals_out < 0).all()
        ref = jt.DenseTopKSpMV(_jcoo(coo), jt.TopKSpMVConfig(
            k=30, max_cols=COLS), block_rows=1024, dtype=dtype)
        ri, rv = map(np.asarray, ref.query(q))
        _same_top(idx, vals_out, ri, rv, 1e-6 if dtype == "bf16" else 0.0)
    # k past the real rows: the pad rows' slots come back as -1
    tiny = create_sparse_matrix(20, COLS, 5, "uniform", seed=7)
    eng = pt.DenseTopKSpMV(tiny, pt.TopKSpMVConfig(k=30, max_cols=COLS),
                           device=CPU)
    idx, _ = eng.query(create_sample_vector(COLS, seed=8))
    assert (idx[:20] >= 0).all() and (idx[20:] == -1).all()


def test_from_reference_arrays_rejects():
    cfg = pt.TopKSpMVConfig(k=5, max_cols=COLS)
    kw = dict(num_rows=10, config=cfg, device=CPU, block_rows=16,
              recall_target=0.98)
    with pytest.raises(ValueError, match="scales"):
        pt.DenseTopKSpMV.from_reference_arrays(
            np.zeros((16, COLS), np.int8), **kw)
    with pytest.raises(ValueError, match="not bf16"):
        pt.DenseTopKSpMV.from_reference_arrays(
            np.full((16, COLS), 1.1, np.float32), **kw)
    with pytest.raises(ValueError, match="multiple"):
        pt.DenseTopKSpMV.from_reference_arrays(
            np.zeros((20, COLS), np.uint16), **kw)
    eng = pt.DenseTopKSpMV.from_reference_arrays(
        np.zeros((16, COLS), np.uint16), **kw)
    assert eng.dtype == "bf16" and eng.device == CPU
