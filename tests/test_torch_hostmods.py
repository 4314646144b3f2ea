"""The port's copies of the JAX package's NumPy host modules, held to their
originals bit for bit on the same inputs: formats/sell.py, formats/bscsr.py,
formats/mtx.py, formats/coo.py (from_dense, to_dense), ops/gold.py,
ops/xla_ref.py (its NumPy oracles; its segment baseline, torch in the port,
to rounding), topk/merge.py, eval/metrics.py and eval/accuracy_model.py.
"""

import dataclasses
import gzip

import numpy as np
import pytest
import torch

import spmv_topk_tpu.config as jcfg
from spmv_topk_tpu.eval import accuracy_model as jacc
from spmv_topk_tpu.eval import metrics as jmetrics
from spmv_topk_tpu.formats import CooMatrix as JCoo
from spmv_topk_tpu.formats import bscsr as jbscsr
from spmv_topk_tpu.formats import coo as jcoo_mod
from spmv_topk_tpu.formats import create_sparse_matrix as jax_matrix
from spmv_topk_tpu.formats import mtx as jmtx
from spmv_topk_tpu.formats import sell as jsell
from spmv_topk_tpu.formats.sell_buckets import pack_sell_buckets as jpack
from spmv_topk_tpu.ops import gold as jgold
from spmv_topk_tpu.ops import xla_ref as jxla
from spmv_topk_tpu.topk import merge_candidates_host as jmerge

import spmv_topk_tpu_torch as pt
import spmv_topk_tpu_torch.eval as peval
from spmv_topk_tpu_torch import formats as pformats
from spmv_topk_tpu_torch import ops as pops
from spmv_topk_tpu_torch import topk as ptopk
from spmv_topk_tpu_torch.eval import accuracy_model as pacc
from spmv_topk_tpu_torch.eval import metrics as pmetrics
from spmv_topk_tpu_torch.formats import CooMatrix, create_sparse_matrix
from spmv_topk_tpu_torch.formats import bscsr as pbscsr
from spmv_topk_tpu_torch.formats import mtx as pmtx
from spmv_topk_tpu_torch.formats import sell as psell
from spmv_topk_tpu_torch.formats.sell_buckets import pack_sell_buckets
from spmv_topk_tpu_torch.ops import gold as pgold
from spmv_topk_tpu_torch.ops import xla_ref as pxla

ROWS, COLS = 600, 128


def _corpora(rows=ROWS, cols=COLS, deg=8, seed=3):
    return (jax_matrix(rows, cols, deg, "gamma", seed=seed),
            create_sparse_matrix(rows, cols, deg, "gamma", seed=seed))


def _query(cols=COLS, seed=4):
    return np.random.default_rng(seed).standard_normal(cols).astype(
        np.float32)


def _same(a, b):
    """Equal field by field: arrays bit for bit (NaN where NaN), the rest
    by ==; dataclasses (configs aside, which differ by package) and
    sequences recursively."""
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        for f in dataclasses.fields(a):
            if f.name != "config":
                _same(getattr(a, f.name), getattr(b, f.name))
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b and type(a) is type(b), (a, b)


# what each package's __init__ exports (spmv_topk_tpu/formats/__init__.py,
# ops/__init__.py, topk/__init__.py, eval/__init__.py)
EXPORTS = {
    "formats": ("CooMatrix", "from_scipy", "from_dense", "read_mtx",
                "write_mtx", "create_sparse_matrix", "create_sample_vector",
                "create_query_batch", "pack_bscsr", "pack_bscsr_partition",
                "unpack_bscsr_partition", "BscsrPartition", "pack_sell",
                "unpack_sell", "SellMatrix"),
    "ops": ("gold", "fixedpoint", "xla_ref", "finalize_topk"),
    "topk": ("finalize_topk", "merge_candidates_host"),
    "eval": ("metrics", "closed_form_precision", "monte_carlo_precision"),
}


@pytest.mark.parametrize("package", list(EXPORTS))
def test_exports_match_the_jax_package(package):
    """formats, ops, topk and eval export what the JAX package's do."""
    import importlib

    jmod = importlib.import_module(f"spmv_topk_tpu.{package}")
    pmod = importlib.import_module(f"spmv_topk_tpu_torch.{package}")
    for name in EXPORTS[package]:
        assert hasattr(jmod, name), name
        assert hasattr(pmod, name), name
    assert ptopk.finalize_topk is pops.kernel.finalize_topk


@pytest.mark.parametrize("P", [1, 2])
def test_pack_sell_matches(P):
    jc, pc = _corpora()
    kw = dict(k=10, max_cols=COLS, num_partitions=P, block_sublanes=32)
    jm = jsell.pack_sell(jc, jcfg.TopKSpMVConfig(**kw))
    pm = psell.pack_sell(pc, pt.TopKSpMVConfig(**kw))
    _same(jm, pm)
    assert (jm.padded_nnz, jm.hbm_bytes, jm.padding_ratio) == \
        (pm.padded_nnz, pm.hbm_bytes, pm.padding_ratio)
    back = psell.unpack_sell(pm)
    _same(jsell.unpack_sell(jm), back)
    assert back.nnz == pc.nnz


@pytest.mark.parametrize("P,fmt", [(1, "F32"), (3, "BF16")])
def test_pack_bscsr_matches(P, fmt):
    jc, pc = _corpora(rows=200, deg=5)
    jparts = jbscsr.pack_bscsr(jc, P, value_format=getattr(jcfg, fmt))
    pparts = pbscsr.pack_bscsr(pc, P, value_format=getattr(pt, fmt))
    _same(jparts, pparts)
    for jp, pp in zip(jparts, pparts):
        _same(jbscsr.unpack_bscsr_partition(jp),
              pbscsr.unpack_bscsr_partition(pp))
    one = pbscsr.pack_bscsr_partition(pc.rows[:40], pc.cols[:40],
                                      pc.vals[:40], packet_size=15,
                                      prev_last_row=3)
    _same(jbscsr.pack_bscsr_partition(jc.rows[:40], jc.cols[:40],
                                      jc.vals[:40], packet_size=15,
                                      prev_last_row=3), one)


def test_golds_match():
    jc, pc = _corpora(rows=150, deg=6)
    q = _query()
    qs = np.stack([q, _query(seed=5)])
    for name, args in (("spmv_exact", (q,)), ("spmm_exact", (qs,)),
                       ("topk_exact", (q, 20)),
                       ("topk_streaming_gold", (q, 20))):
        _same(getattr(jgold, name)(jc, *args), getattr(pgold, name)(pc, *args))
    scores = pgold.spmv_exact(pc, q)
    _same(jgold.topk_of_scores(scores, 7), pgold.topk_of_scores(scores, 7))
    jparts, pparts = jbscsr.pack_bscsr(jc, 2), pbscsr.pack_bscsr(pc, 2)
    for lfr in (None, 3):
        for jp, pp in zip(jparts, pparts):
            _same(jgold.topk_bscsr_packet_gold(jp, q, 10, lfr),
                  pgold.topk_bscsr_packet_gold(pp, q, 10, lfr))
    sq = JCoo(jc.rows, jc.cols % 150, np.abs(jc.vals), 150, 150)
    psq = CooMatrix(pc.rows, pc.cols % 150, np.abs(pc.vals), 150, 150)
    _same(jgold.pagerank_gold(sq, max_iter=20),
          pgold.pagerank_gold(psq, max_iter=20))


def test_merge_candidates_host_matches():
    rng = np.random.default_rng(6)
    idx = [rng.integers(-1, 40, 30).astype(np.int32) for _ in range(4)]
    val = [rng.integers(-5, 6, 30).astype(np.float32) for _ in range(4)]
    for k in (1, 10, 200):
        _same(jmerge(idx, val, k), ptopk.merge_candidates_host(idx, val, k))


def test_metrics_match():
    rng = np.random.default_rng(7)
    gold_ = rng.permutation(60)[:50]
    test = np.concatenate([gold_[:40], rng.permutation(60)[:10] + 100])
    for name in ("precision_at_k", "ndcg", "kendall_tau", "edit_distance",
                 "count_positional_errors"):
        _same(getattr(jmetrics, name)(gold_, test),
              getattr(pmetrics, name)(gold_, test))
        _same(jmetrics.bounded(getattr(jmetrics, name), gold_, test),
              pmetrics.bounded(getattr(pmetrics, name), gold_, test))
    times = rng.random(9)
    for name in ("mean", "st_dev"):
        for skip in (0, 2, 20):
            _same(getattr(jmetrics, name)(times, skip),
                  getattr(pmetrics, name)(times, skip))


def test_accuracy_model_matches():
    for args in ((1000, 32, 100, 8), (500, 4, 10, 2), (64, 8, 16, 1)):
        _same(jacc.closed_form_single_k(*args),
              pacc.closed_form_single_k(*args))
        _same(jacc.closed_form_precision(*args),
              pacc.closed_form_precision(*args))
        _same(jacc.monte_carlo_precision(*args, num_tests=3),
              pacc.monte_carlo_precision(*args, num_tests=3))
        _same(jacc.monte_carlo_rescore_precision(*args, pool=20,
                                                 noise_sigma=0.01,
                                                 num_tests=3),
              pacc.monte_carlo_rescore_precision(*args, pool=20,
                                                 noise_sigma=0.01,
                                                 num_tests=3))
    assert peval.closed_form_precision is pacc.closed_form_precision
    assert peval.monte_carlo_precision is pacc.monte_carlo_precision


@pytest.mark.parametrize("suffix", [".mtx", ".mtx.gz"])
def test_mtx_round_trips_both_ways(tmp_path, suffix):
    """A file written by either package reads the same in both, plain and
    gzipped (the native parser takes the plain ones, NumPy the others)."""
    jc, pc = _corpora(rows=80, deg=4)
    for name, writer, coo in (("jax", jmtx.write_mtx, jc),
                              ("port", pmtx.write_mtx, pc)):
        path = str(tmp_path / (name + suffix))
        writer(path, coo)
        for read_values in (True, False):
            _same(jmtx.read_mtx(path, read_values),
                  pmtx.read_mtx(path, read_values))
    opener = gzip.open if suffix.endswith(".gz") else open
    with opener(tmp_path / ("jax" + suffix), "rb") as a, \
            opener(tmp_path / ("port" + suffix), "rb") as b:
        assert a.read() == b.read()


def test_mtx_pattern_and_symmetric(tmp_path):
    body = "%%MatrixMarket matrix coordinate {} {}\n% c\n4 4 4\n" \
           "1 1{}\n2 1{}\n3 2{}\n4 4{}\n"
    for field, sym, vals in (("pattern", "general", [""] * 4),
                             ("real", "symmetric", [" 0.5", " -1", " 2",
                                                    " 3"])):
        for opener, suffix in ((open, ".mtx"), (gzip.open, ".mtx.gz")):
            path = str(tmp_path / (field + suffix))
            with opener(path, "wt") as fh:
                fh.write(body.format(field, sym, *vals))
            _same(jmtx.read_mtx(path), pmtx.read_mtx(path))
    (tmp_path / "bad.mtx").write_text("hello\n")
    with pytest.raises(ValueError, match="not a MatrixMarket"):
        pmtx.read_mtx(str(tmp_path / "bad.mtx"))


def test_from_dense_and_to_dense_match():
    rng = np.random.default_rng(8)
    dense = np.where(rng.random((30, 20)) < 0.2,
                     rng.standard_normal((30, 20)), 0).astype(np.float32)
    jm, pm = jcoo_mod.from_dense(dense), pformats.from_dense(dense)
    _same(jm, pm)
    np.testing.assert_array_equal(pm.to_dense(), dense)
    _, pc = _corpora(rows=50, deg=5)
    jc = JCoo(pc.rows, pc.cols, pc.vals, pc.num_rows, pc.num_cols)
    np.testing.assert_array_equal(jc.to_dense(), pc.to_dense())


@pytest.mark.parametrize("P", [1, 2])
def test_sell_oracles_match(P):
    """sell_scores_np and topk_spmv_sell_xla over a SellMatrix (P
    partitions) and a BucketedSellMatrix, bit for bit."""
    jc, pc = _corpora()
    q = _query()
    kw = dict(k=10, max_cols=COLS, num_partitions=P, block_sublanes=32)
    jm = jsell.pack_sell(jc, jcfg.TopKSpMVConfig(**kw))
    pm = psell.pack_sell(pc, pt.TopKSpMVConfig(**kw))
    _same(jxla.sell_scores_np(jm, q), pxla.sell_scores_np(pm, q))
    _same(jxla.topk_spmv_sell_xla(jm, q, 25), pxla.topk_spmv_sell_xla(pm, q, 25))
    bkw = dict(k=10, max_cols=COLS, block_sublanes=32,
               fused_block_sublanes=64, width_quantum=2 * P)
    jb = jpack(jc, jcfg.TopKSpMVConfig(**bkw))
    pb = pack_sell_buckets(pc, pt.TopKSpMVConfig(**bkw))
    _same(jxla.sell_scores_np(jb, q), pxla.sell_scores_np(pb, q))
    _same(jxla.topk_spmv_sell_xla(jb, q, 25), pxla.topk_spmv_sell_xla(pb, q, 25))


def test_segment_baseline_matches():
    """topk_spmv_segment_xla: index_add_ + torch.topk against the JAX
    segment_sum + lax.top_k. Both add each row's products in nnz order in
    f32, so values agree to rtol 1e-6 (the two backends may still group
    the adds otherwise) and rows above the k-th value less that margin."""
    jc, pc = _corpora(rows=2000, cols=256, deg=10)
    q = _query(256)
    ji, jv = map(np.asarray, jxla.topk_spmv_segment_xla(
        jc.rows, jc.cols, jc.vals, q, jc.num_rows, 50))
    pi, pv = pxla.topk_spmv_segment_xla(pc.rows, pc.cols, pc.vals, q,
                                        pc.num_rows, 50)
    assert pi.dtype == torch.int32 and pv.dtype == torch.float32
    pi, pv = pi.numpy(), pv.numpy()
    np.testing.assert_allclose(pv, jv, rtol=1e-6, atol=1e-6)
    kth = jv[-1] + 1e-5
    assert set(pi[pv > kth].tolist()) == set(ji[jv > kth].tolist())
    gi, gv = pgold.topk_exact(pc, q, 50)
    np.testing.assert_allclose(pv, gv, rtol=1e-5, atol=1e-5)
    ti, tv = pxla.topk_spmv_segment_xla(
        torch.from_numpy(pc.rows), torch.from_numpy(pc.cols),
        torch.from_numpy(pc.vals), torch.from_numpy(q), pc.num_rows, 50)
    np.testing.assert_array_equal(tv.numpy(), pv)
