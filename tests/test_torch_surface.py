"""The carried host modules' surface: every public function, class and
constant a JAX host module defines exists in the port's module of the same
name, with the same parameters in the same order, and every public method
and property of its classes; the same of the tools (``bench/``, ``tune``,
``cli``, ``utils.profiling``), whose functions may take a trailing
``device``; then the names added to complete that surface
held to the JAX package's on the same seeded inputs (``pack_sell_buckets``'
``target_block_sublanes``, the matrices' size properties, the config's,
the query dequantizers, ``validate_codec``, and the native runtime's
``coo_sort_perm`` and ``cpu_topk_spmv``).
"""

import ast
import importlib
import inspect

import numpy as np
import pytest

import spmv_topk_tpu.config as jcfg
from spmv_topk_tpu.formats import create_sparse_matrix as jax_matrix
from spmv_topk_tpu.formats import sell_buckets as jsb
from spmv_topk_tpu.ops import quantized_query as jqq
from spmv_topk_tpu.utils import native as jnative

import spmv_topk_tpu_torch as pt
import spmv_topk_tpu_torch.config as pcfg
from spmv_topk_tpu_torch.formats import create_sparse_matrix
from spmv_topk_tpu_torch.formats import sell_buckets as psb
from spmv_topk_tpu_torch.ops import quantized_query as pqq
from spmv_topk_tpu_torch.utils import native as pnative

# the NumPy host modules the port carries under the same names
CARRIED = ("config", "formats.coo", "formats.synthetic", "formats.sell",
           "formats.sell_buckets", "formats.bscsr", "formats.mtx",
           "ops.fixedpoint", "ops.quantized_query", "ops.gold", "ops.xla_ref",
           "utils.native", "topk.merge", "eval.accuracy_model",
           "eval.metrics")

# the tools the port rewrites for torch under the same names; a function
# may take one more parameter, a trailing ``device`` (the torch device of
# the engines it builds)
TOOLS = ("utils.profiling", "bench.harness", "bench.sweep", "bench.service",
         "bench.cpu_baseline", "bench.capacity", "tune", "cli",
         "bench.accuracy_sweep", "bench.full_eval", "bench.plots")
# Differences of the evaluation tools by design, each with its reason:
#   bench.plots.main takes ``argv`` (the JAX main() parses sys.argv), so
#     the card's smoke run can call it in-process;
#   bench.plots.CHIP_PEAKS_GBPS holds the H100's data-sheet HBM3 rate
#     ("h100") and the CPU's where the JAX table holds TPU peaks, and
#     plot_roofline's ``chip`` defaults to "h100";
#   bench.plots.load_results returns a ``SweepResults`` (columns as numpy
#     arrays, no pandas), which the plot functions take as ``df``;
#   bench.full_eval and bench.accuracy_sweep write into ``--out-dir``
#     (default build/spmv_topk_tpu_torch/eval/), never the repository's
#     RESULTS.json, RESULTS.md or results/ (the JAX package's records).
TOOL_PARAMS_DIFFER = {("bench.plots", "main"): ["argv"]}

# Names of the JAX package the port leaves out on purpose, each with its
# reason. No carried module or tool has one; these live in api.py, which
# the port rewrites for torch:
#   api.TopKSpMV.candidates_traceable, batch_candidates_traceable: jit-
#     traceable forms for a jitted scan; torch runs eagerly, and the
#     port's tune.py times table_candidates() (a table packed beforehand)
#     back to back instead.
JAX_ONLY_API = ("candidates_traceable", "batch_candidates_traceable")
# Parameters left out of the port's signatures: ``interpret=`` picks
# Pallas's interpret mode; the port picks a kernel or its plain version
# from the device of the tensors it is given.
JAX_ONLY_PARAMS = ("interpret",)


def _public_names(mod):
    """The public names ``mod`` defines itself: functions and classes
    whose ``__module__`` is it, and its top-level assignments."""
    names = [n for n, v in vars(mod).items() if not n.startswith("_")
             and getattr(v, "__module__", None) == mod.__name__]
    for node in ast.parse(inspect.getsource(mod)).body:
        targets = (node.targets if isinstance(node, ast.Assign) else
                   [node.target] if isinstance(node, ast.AnnAssign) else [])
        names += [t.id for t in targets
                  if isinstance(t, ast.Name) and not t.id.startswith("_")]
    return sorted(set(names))


def _params(fn):
    return [p for p in inspect.signature(fn).parameters
            if p not in JAX_ONLY_PARAMS]


@pytest.mark.parametrize("module", CARRIED)
def test_carried_module_has_the_jax_surface(module):
    """Every public name of the JAX module is in the port's, functions with
    the same parameters in the same order, classes with every public
    method and property (the dataclasses' properties among them)."""
    jmod = importlib.import_module(f"spmv_topk_tpu.{module}")
    pmod = importlib.import_module(f"spmv_topk_tpu_torch.{module}")
    names = _public_names(jmod)
    assert names, module
    missing = [n for n in names if not hasattr(pmod, n)]
    assert not missing, f"{module} lacks {missing}"
    for n in names:
        j, p = getattr(jmod, n), getattr(pmod, n)
        if inspect.isfunction(j):
            assert _params(j) == _params(p), n
        elif inspect.isclass(j):
            attrs = [a for a in vars(j) if not a.startswith("_")]
            lacking = [a for a in attrs if not hasattr(p, a)]
            assert not lacking, f"{module}.{n} lacks {lacking}"
            for a in attrs:
                ja, pa = vars(j)[a], inspect.getattr_static(p, a)
                if isinstance(ja, (property, classmethod, staticmethod)):
                    assert isinstance(pa, type(ja)), f"{n}.{a}"
                elif inspect.isfunction(ja):
                    assert _params(ja) == _params(pa), f"{n}.{a}"


@pytest.mark.parametrize("module", TOOLS)
def test_tool_module_has_the_jax_surface(module):
    """Every public name of the JAX tool is in the port's, functions with
    the same parameters in the same order (the port's may end in one more,
    ``device``), classes with every public method and property."""
    jmod = importlib.import_module(f"spmv_topk_tpu.{module}")
    pmod = importlib.import_module(f"spmv_topk_tpu_torch.{module}")
    names = _public_names(jmod)
    assert names, module
    missing = [n for n in names if not hasattr(pmod, n)]
    assert not missing, f"{module} lacks {missing}"
    for n in names:
        j, p = getattr(jmod, n), getattr(pmod, n)
        if inspect.isfunction(j):
            jp, pp = _params(j), _params(p)
            if pp[-1:] == ["device"] and "device" not in jp:
                pp = pp[:-1]
            if (module, n) in TOOL_PARAMS_DIFFER:
                assert pp == jp + TOOL_PARAMS_DIFFER[module, n], n
                continue
            assert jp == pp, n
        elif inspect.isclass(j):
            attrs = [a for a in vars(j) if not a.startswith("_")]
            lacking = [a for a in attrs if not hasattr(p, a)]
            assert not lacking, f"{module}.{n} lacks {lacking}"
            for a in attrs:
                ja, pa = vars(j)[a], inspect.getattr_static(p, a)
                if inspect.isfunction(ja):
                    assert _params(ja) == _params(pa), f"{n}.{a}"


def test_plots_differ_as_written():
    """The plots' peaks are the card's (and the CPU's), not the TPU's."""
    from spmv_topk_tpu.bench import plots as jplots
    from spmv_topk_tpu_torch.bench import plots as pplots

    assert set(pplots.CHIP_PEAKS_GBPS) == {"h100", "cpu"}
    assert not set(pplots.CHIP_PEAKS_GBPS) & (set(jplots.CHIP_PEAKS_GBPS)
                                               - {"cpu"})
    assert inspect.signature(pplots.plot_roofline).parameters[
        "chip"].default == "h100"


def test_jax_only_api_names_stay_out():
    """The written JAX-only names are JAX's and not the port's."""
    from spmv_topk_tpu import api as japi
    from spmv_topk_tpu_torch import api as papi

    for n in JAX_ONLY_API:
        assert hasattr(japi.TopKSpMV, n) and not hasattr(papi.TopKSpMV, n)


def _corpora(rows, cols, deg, seed):
    return (jax_matrix(rows, cols, deg, "gamma", seed=seed),
            create_sparse_matrix(rows, cols, deg, "gamma", seed=seed))


def _same_packs(jm, pm):
    assert len(jm.buckets) == len(pm.buckets)
    for jb, pb in zip(jm.buckets, pm.buckets):
        assert (jb.width, jb.block_sublanes, jb.num_blocks, jb.slice_base,
                jb.num_slices, jb.slices_per_block) == \
            (pb.width, pb.block_sublanes, pb.num_blocks, pb.slice_base,
             pb.num_slices, pb.slices_per_block)
        np.testing.assert_array_equal(jb.words, pb.words)
    np.testing.assert_array_equal(jm.row_ids, pm.row_ids)
    assert jm.value_scale == pm.value_scale
    assert (jm.num_slices, jm.hbm_bytes, jm.padded_nnz, jm.padding_ratio) \
        == (pm.num_slices, pm.hbm_bytes, pm.padded_nnz, pm.padding_ratio)


@pytest.mark.parametrize("codec,quantum", [("f32", 8), ("h16", 2),
                                           ("i8s", 4)])
def test_pack_sell_buckets_target_block_sublanes(codec, quantum):
    """pack_sell_buckets(coo, cfg, 256): the third positional parameter
    is the block target in both packages, bucket for bucket."""
    jc, pc = _corpora(3000, 1024, 20, 5)
    # fused_block_sublanes 512: tests/conftest.py shrinks the JAX config's
    # blocks when both are at their defaults (512, 1024)
    kw = dict(k=100, max_cols=1024, query_codec=codec,
              width_quantum=quantum, block_sublanes=512,
              fused_block_sublanes=512)
    jm = jsb.pack_sell_buckets(jc, jcfg.TopKSpMVConfig(**kw), 256)
    pm = psb.pack_sell_buckets(pc, pt.TopKSpMVConfig(**kw), 256)
    _same_packs(jm, pm)
    for b in pm.buckets:
        assert b.block_sublanes == max(1, 256 // b.width) * b.width
    # None keeps config.block_sublanes, and value_scale stays a keyword
    _same_packs(jsb.pack_sell_buckets(jc, jcfg.TopKSpMVConfig(**kw), None,
                                      value_scale=0.5),
                psb.pack_sell_buckets(pc, pt.TopKSpMVConfig(**kw),
                                      value_scale=0.5))


def test_port_callers_pack_as_before():
    """The port's callers pass value_scale by keyword: the partitioned
    pack gives the JAX package's words and scale."""
    jc, pc = _corpora(2000, 512, 12, 6)
    kw = dict(k=100, max_cols=512, query_codec="h16", num_partitions=2,
              block_sublanes=64, fused_block_sublanes=128, width_quantum=2)
    jp = jsb.pack_fused_partitions(jc, jcfg.TopKSpMVConfig(**kw), 2)
    pp = psb.pack_fused_partitions(pc, pt.TopKSpMVConfig(**kw), 2)
    np.testing.assert_array_equal(jp.words, pp.words)
    np.testing.assert_array_equal(jp.nreal, pp.nreal)
    assert jp.value_scale == pp.value_scale
    assert (jp.hbm_bytes, jp.padding_ratio) == (pp.hbm_bytes,
                                                pp.padding_ratio)


def test_fused_and_config_properties():
    """FusedSellMatrix.num_slices, TopKSpMVConfig.col_groups, SUBLANES and
    ValueFormat.scale / bytes_per_value equal the JAX values."""
    jc, pc = _corpora(2500, 512, 10, 7)
    kw = dict(k=50, max_cols=512, block_sublanes=64,
              fused_block_sublanes=128)
    jm = jsb.pack_sell_buckets(jc, jcfg.TopKSpMVConfig(**kw))
    pm = psb.pack_sell_buckets(pc, pt.TopKSpMVConfig(**kw))
    for layout in ("fuse_buckets", "fuse_buckets_octet"):
        jf = getattr(jsb, layout)(jm, block_sublanes=128)
        pf = getattr(psb, layout)(pm, block_sublanes=128)
        assert (jf.num_slices, jf.hbm_bytes, jf.padding_ratio) == \
            (pf.num_slices, pf.hbm_bytes, pf.padding_ratio)
    for cols in (128, 1024, 2048):
        assert jcfg.TopKSpMVConfig(max_cols=cols).col_groups == \
            pcfg.TopKSpMVConfig(max_cols=cols).col_groups
    assert jcfg.SUBLANES == pcfg.SUBLANES
    for name in ("F32", "BF16", "FIXED32", "FIXED8"):
        jf, pf = getattr(jcfg, name), getattr(pcfg, name)
        assert (jf.scale, jf.bytes_per_value) == (pf.scale,
                                                  pf.bytes_per_value)
    odd = dict(kind="fixed", fixed_width=20, fixed_integer_part=2)
    assert pcfg.ValueFormat(**odd).bytes_per_value == \
        jcfg.ValueFormat(**odd).bytes_per_value == 3


@pytest.mark.parametrize("codec", ["int8", "i8s", "i4s"])
def test_dequantize_query_matches_jax(codec):
    """Each dequantizer inverts its packer as the JAX one does, bit for bit
    on the same seeded query (1000 columns: a partial last table row)."""
    q = np.random.default_rng(8).standard_normal(1024).astype(np.float32)
    q[1000:] = 0.0
    jpack = getattr(jqq, f"pack_query_{codec}")
    ppack = getattr(pqq, f"pack_query_{codec}")
    jt, js = jpack(q)
    pt_, ps = ppack(q)
    np.testing.assert_array_equal(jt, pt_)
    jd = getattr(jqq, f"dequantize_query_{codec}")(jt, js, 1000)
    pd = getattr(pqq, f"dequantize_query_{codec}")(pt_, ps, 1000)
    assert jd.dtype == pd.dtype
    np.testing.assert_array_equal(jd, pd)
    step = {"int8": 127, "i8s": 127, "i4s": 7}[codec]
    assert np.abs(pd - q[:1000]).max() <= ps / 2 * (1 + 1e-6)
    assert ps == np.abs(q).max() / step


@pytest.mark.parametrize("codec,cols", [
    ("f32", 65536), ("int8x4", 4096), ("i8s", 1024), ("i8s", 1152),
    ("i4s", 2048), ("i4s", 2176), ("h16", 1024), ("h16", 1152),
    ("bf16", 128)])
def test_validate_codec_matches_jax(codec, cols):
    """validate_codec accepts and refuses what the JAX one does, with the
    same message."""
    def outcome(fn):
        try:
            fn(codec, cols)
        except ValueError as e:
            return str(e)
        return None

    assert outcome(pqq.validate_codec) == outcome(jqq.validate_codec)


def test_native_sort_perm():
    """tests/test_native.py's coo_sort_perm case on the port, and the same
    permutation as the JAX binding's."""
    assert pnative.available(), pnative.load_error
    rng = np.random.default_rng(32)
    rows = rng.integers(0, 100, 1000).astype(np.int32)
    cols = rng.integers(0, 64, 1000).astype(np.int32)
    perm = pnative.coo_sort_perm(rows, cols, 64)
    keys = rows.astype(np.int64) * 64 + cols
    assert perm.dtype == np.int64
    assert np.all(np.diff(keys[perm]) >= 0)
    if jnative.available():
        np.testing.assert_array_equal(
            np.sort(perm), np.arange(1000, dtype=np.int64))
        np.testing.assert_array_equal(keys[perm], keys[
            jnative.coo_sort_perm(rows, cols, 64)])


def test_native_cpu_topk_spmv_matches_scipy():
    """tests/test_native.py's cpu_topk_spmv case on the port: the threaded
    CPU Top-K SpMV against a scipy matvec + argsort, and equal to the JAX
    binding's answer."""
    assert pnative.available(), pnative.load_error
    coo = create_sparse_matrix(5000, 512, 12, "gamma", seed=21)
    csr = coo.to_scipy()
    q = np.random.default_rng(22).standard_normal(512).astype(np.float32)
    k = 50
    args = (np.ascontiguousarray(csr.indptr, np.int64),
            np.ascontiguousarray(csr.indices, np.int32),
            np.ascontiguousarray(csr.data, np.float32), q, k)
    out = pnative.cpu_topk_spmv(*args)
    assert out is not None
    idx, val = out
    scores = csr @ q
    want = np.argsort(-scores, kind="stable")[:k]
    np.testing.assert_allclose(np.sort(val), np.sort(scores[want]),
                               rtol=1e-6)
    assert set(idx.tolist()) == set(want.tolist())
    if jnative.available():
        jidx, jval = jnative.cpu_topk_spmv(*args)
        np.testing.assert_array_equal(idx, jidx)
        np.testing.assert_array_equal(val, jval)
