"""The quantized query codecs (``int8x4``, ``i8s``, ``i4s``) on the port's
slice stream (kernels K7, K8, K9, K10a) against the JAX package on the CPU.

The port runs the plain versions of its kernels here; the JAX package
runs its Pallas kernels in interpret mode, every program once, in the
module fixture. Each product is a bf16 matrix value times an 8- or 4-bit
integer, exact in float32. Tolerances:
  - integer-valued data (matrix values small integers; the query tables
    hold integers whatever the query): every partial sum is an exact
    float32 too, so per-lane values and ``scores()`` are bit-equal, and
    (value, slice) pairs equal above each lane's smallest kept value
    (tie-safe buffers);
  - the corpus's real values: the JAX kernel sums two interleaved
    accumulators and then a chunk's rows, the port a slice's rows in row
    order, so values agree to rtol 1e-6 (``scores()`` with atol 1e-6 for
    sums that cancel to near 0) and index sets above the k-th value less
    that margin;
  - rescored query(): both packages re-rank the same pool with the same
    native csr_rescore, so indices are equal;
  - a word's product (``prod_int8x4``, ``prod_sign``): exact.
The engines are the deployments of ``spmv_topk_tpu/bench/full_eval.py``:
c3 (i8s, width quantum 4) and c8 (i4s, width quantum 4, rescore pool
400), at 3000 x 1024.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import spmv_topk_tpu as jt
import spmv_topk_tpu.config as jcfg
from spmv_topk_tpu.formats import CooMatrix as JCoo
from spmv_topk_tpu.formats import create_sparse_matrix as jax_matrix
from spmv_topk_tpu.formats.sell_buckets import (fuse_buckets as jfuse,
                                                pack_fused_partitions,
                                                pack_sell_buckets as jpack)
from spmv_topk_tpu.ops import kernel as jkernel
from spmv_topk_tpu.ops.quantized_query import (pack_query_table,
                                               pack_query_tables)

import spmv_topk_tpu_torch as pt
from spmv_topk_tpu_torch.formats import (CooMatrix, create_query_batch,
                                         create_sparse_matrix)
from spmv_topk_tpu_torch.ops import kernel as pkernel
from spmv_topk_tpu_torch.ops.fixedpoint import bf16_bits

ROWS, COLS = 3000, 1024
GEOM = dict(block_sublanes=64, fused_block_sublanes=128)
C3 = dict(k=100, query_codec="i8s", width_quantum=4, **GEOM)
C8 = dict(k=100, query_codec="i4s", width_quantum=4, rescore_pool=400,
          **GEOM)
# kernel level, tie-safe, integer-valued data: name -> (config, queries;
# 0 is the single-query sweep K7)
KERNELS = {
    "k7_i8s": (dict(C3, tie_safe_topk=True), 0),
    # fold 8: the tiled fold of 4-row periods
    "k7_i4s_fold8": (dict(C8, rescore_pool=None, tie_safe_topk=True,
                          fold_tile=8), 0),
    # 32-row blocks: wide slices
    "k7_int8x4_wide": (dict(C3, query_codec="int8x4", tie_safe_topk=True,
                            fused_block_sublanes=32), 0),
    "k8_i4s": (dict(C8, rescore_pool=None, tie_safe_topk=True,
                    batch_subgroup=2), 3),
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


def _jax_corpus(integer):
    coo = jax_matrix(ROWS, COLS, 20, "gamma", seed=5)
    return _integer_valued(coo, True) if integer else coo


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("codecs_slice")
    out = dict(dir=d, kernels={})
    jint = _jax_corpus(True)
    for name, (kw, Q) in KERNELS.items():
        cfg = jcfg.TopKSpMVConfig(**kw)
        f = jfuse(jpack(jint, cfg), block_sublanes=kw["fused_block_sublanes"])
        geo = dict(cfg=cfg, plan=f.plan, block_sublanes=f.block_sublanes,
                   num_blocks=f.num_blocks, interpret=True,
                   codec=cfg.query_codec)
        qs = create_query_batch(max(Q, 1), COLS, seed=3)
        if Q:
            tabs, _ = pack_query_tables(qs, cfg.query_codec)
            tv, tt = jkernel.topk_spmv_fused_batch_device(
                jnp.asarray(f.words), jnp.asarray(tabs),
                jnp.asarray(f.nreal), **geo)
        else:
            tabs, _ = pack_query_table(qs[0], cfg.query_codec)
            tv, tt = jkernel.topk_spmv_fused_device(
                jnp.asarray(f.words), jnp.asarray(tabs),
                jnp.asarray(f.nreal), **geo)
        out["kernels"][name] = (f, tabs, np.asarray(tv), np.asarray(tt))
    # K10a: i8s on three partitions
    cfg = jcfg.TopKSpMVConfig(**dict(C3, tie_safe_topk=True,
                                     num_partitions=3))
    f = pack_fused_partitions(jint, cfg, 3)
    table, _ = pack_query_table(create_query_batch(1, COLS, seed=4)[0],
                                "i8s")
    tv, tt = jkernel.topk_spmv_fused_part_device(
        jnp.asarray(f.words), jnp.asarray(table), jnp.asarray(f.nreal),
        cfg=cfg, plan=f.plan, block_sublanes=f.block_sublanes,
        num_blocks=f.num_blocks, num_partitions=3,
        part_slices=f.part_slices, interpret=True, codec="i8s")
    out["k10a"] = (f, table, np.asarray(tv), np.asarray(tt))
    # K9 through scores(): int8x4 on integer-valued data
    jeng = jt.TopKSpMV(jint, jt.TopKSpMVConfig(**dict(
        C3, query_codec="int8x4")))
    out["int_scores"] = np.asarray(jeng.scores(
        create_query_batch(1, COLS, seed=5)[0]))

    # engine level, real values: c3 and c8
    coo = create_sparse_matrix(ROWS, COLS, 20, "gamma", seed=5)
    jcoo = _jax_corpus(False)
    qs = {s: create_query_batch(1, COLS, seed=s)[0] for s in QUERY_SEEDS}
    batch = np.stack(list(qs.values()))[:2]
    out.update(coo=coo, qs=qs, batch=batch, eng={})
    for name, kw in (("c3", C3), ("c8", C8)):
        jeng = jt.TopKSpMV(jcoo, jt.TopKSpMVConfig(**kw))
        res = dict(q={s: tuple(map(np.asarray, jeng.query(q)))
                      for s, q in qs.items()},
                   qb=tuple(map(np.asarray, jeng.query_batch(
                       batch, group_size=2))),
                   scores=np.asarray(jeng.scores(qs[QUERY_SEEDS[0]])))
        jeng.save(str(d / f"{name}.npz"))
        out["eng"][name] = res
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


def _plan_rows(f):
    return torch.from_numpy(pkernel.slice_plan_rows(
        f.plan, f.num_blocks, f.nreal, f.block_sublanes))


@pytest.mark.parametrize("name", list(KERNELS))
def test_slice_codec_plain_matches_pallas(ref, name):
    f, tabs, jv, jt_ = ref["kernels"][name]
    kw, Q = KERNELS[name]
    cfg = pt.TopKSpMVConfig(**kw)
    rows = _plan_rows(f)
    modes = {pkernel.slice_work(r, cfg.fold_tile)[0] for r in rows.tolist()}
    if "fold8" in name:
        assert pkernel.TILED in modes
    if "wide" in name:
        assert pkernel.WIDE in modes
    args = (torch.from_numpy(f.words), torch.from_numpy(tabs),
            torch.from_numpy(f.nreal), rows)
    sweep = (pkernel.topk_spmv_fused_batch_device if Q
             else pkernel.topk_spmv_fused_device)
    pv, pt_ = sweep(*args, cfg=cfg, block_sublanes=f.block_sublanes)
    assert pv.shape == ((Q, 8, 128) if Q else (8, 128))
    assert np.isfinite(pv.numpy()).all()
    _assert_lanes_match(jv, jt_, pv.numpy(), pt_.numpy())


def test_partitioned_slice_codec_matches_pallas(ref):
    """K10a, i8s on three partitions: a pool per partition."""
    f, table, jv, jt_ = ref["k10a"]
    cfg = pt.TopKSpMVConfig(**dict(C3, tie_safe_topk=True, num_partitions=3))
    assert (f.nreal == 0).any()
    pv, pt_ = pkernel.topk_spmv_fused_device(
        torch.from_numpy(f.words), torch.from_numpy(table),
        torch.from_numpy(f.nreal), _plan_rows(f), cfg=cfg,
        block_sublanes=f.block_sublanes, num_partitions=3,
        part_slices=f.part_slices)
    assert pv.shape == (3, 8, 128)
    _assert_lanes_match(jv, jt_, pv.numpy(), pt_.numpy())


def test_int8x4_scores_bit_equal_on_integer_data(ref):
    coo = _integer_valued(create_sparse_matrix(ROWS, COLS, 20, "gamma",
                                               seed=5), False)
    peng = pt.TopKSpMV(coo, pt.TopKSpMVConfig(**dict(
        C3, query_codec="int8x4")), device="cpu")
    got = _np(peng.scores(create_query_batch(1, COLS, seed=5)[0]))
    np.testing.assert_array_equal(ref["int_scores"], got)
    assert np.abs(got).max() > 0


@pytest.mark.parametrize("seed", QUERY_SEEDS)
def test_c3_engine_matches_reference(ref, seed):
    """c3 (i8s, no rescore): production buffers on both sides."""
    peng = pt.TopKSpMV(ref["coo"], pt.TopKSpMVConfig(**C3), device="cpu")
    assert not peng.config.tie_safe_topk
    ji, jv = ref["eng"]["c3"]["q"][seed]
    pi, pv = map(_np, peng.query(ref["qs"][seed]))
    np.testing.assert_allclose(jv, pv, rtol=1e-6)
    margin = pv[-1] + 1e-6 * np.abs(pv[-1])
    assert set(ji[jv > margin].tolist()) == set(pi[pv > margin].tolist())


@pytest.mark.parametrize("seed", QUERY_SEEDS)
def test_c8_engine_matches_reference(ref, seed):
    """c8 (i4s, rescore pool 400): the same exact re-rank."""
    peng = pt.TopKSpMV(ref["coo"], pt.TopKSpMVConfig(**C8), device="cpu")
    ji, jv = ref["eng"]["c8"]["q"][seed]
    pi, pv = map(_np, peng.query(ref["qs"][seed]))
    np.testing.assert_array_equal(ji, pi)
    np.testing.assert_allclose(jv, pv, rtol=1e-6)


@pytest.mark.parametrize("name", ["c3", "c8"])
def test_codec_query_batch_and_scores_match_reference(ref, name):
    kw = C3 if name == "c3" else C8
    peng = pt.TopKSpMV(ref["coo"], pt.TopKSpMVConfig(**kw), device="cpu")
    ji, jv = ref["eng"][name]["qb"]
    pi, pv = map(_np, peng.query_batch(ref["batch"], group_size=2))
    assert pi.shape == (2, 100)
    if name == "c8":
        np.testing.assert_array_equal(ji, pi)
    else:
        np.testing.assert_allclose(jv, pv, rtol=1e-6)
        for j in range(2):
            margin = pv[j, -1] + 1e-6 * np.abs(pv[j, -1])
            assert set(ji[j][jv[j] > margin].tolist()) == \
                set(pi[j][pv[j] > margin].tolist())
    np.testing.assert_allclose(ref["eng"][name]["scores"],
                               _np(peng.scores(ref["qs"][QUERY_SEEDS[0]])),
                               rtol=1e-6, atol=1e-6)


def test_jax_i8s_snapshot_loads_in_port(ref):
    """The JAX package's save() of the c3 engine: the port's load() gives
    its plan and queries, as the port's own engine does."""
    peng = pt.TopKSpMV.load(str(ref["dir"] / "c3.npz"), device="cpu")
    built = pt.TopKSpMV(ref["coo"], pt.TopKSpMVConfig(**C3), device="cpu")
    assert peng.config == built.config
    np.testing.assert_array_equal(_np(peng.plan_rows), _np(built.plan_rows))
    np.testing.assert_array_equal(_np(peng.words), _np(built.words))
    q = ref["qs"][QUERY_SEEDS[1]]
    for a, b in zip(peng.query(q), built.query(q)):
        np.testing.assert_array_equal(_np(a), _np(b))
    ji, jv = ref["eng"]["c3"]["q"][QUERY_SEEDS[1]]
    np.testing.assert_allclose(jv, _np(peng.query(q)[1]), rtol=1e-6)


@pytest.mark.parametrize("codec,rows", [
    ("int8x4", 1), ("int8x4", 2), ("int8x4", 3), ("i8s", 1), ("i8s", 2),
    ("i4s", 1), ("i4s", 2)])
def test_quantized_prod_matches_jax(codec, rows):
    """A word's product on random words (all column bits, both signs, so
    int8x4 rows past the table too) and a random table of ``rows`` rows:
    exact, the JAX side with masked lanes (``_gather_from_bcs_int8`` or
    ``_gather_from_bcs_sign`` times the bf16 value, whose TPU bitcast only
    runs inside a kernel, as bitcast_convert_type)."""
    rng = np.random.default_rng(rows)
    high = rng.integers(0, 2**16, (8, 128)).astype(np.uint32)
    vals = bf16_bits(rng.standard_normal((8, 128)).astype(np.float32))
    w = ((high << 16) | vals.astype(np.uint32)).view(np.int32)
    tab = rng.integers(-2**31, 2**31, (rows, 128), dtype=np.int64).astype(
        np.int32)
    bcs = [jnp.broadcast_to(jnp.asarray(tab[c:c + 1]), (8, 128))
           for c in range(rows)]
    jw = jnp.asarray(w)
    val = jax.lax.bitcast_convert_type(jax.lax.shift_left(jw, 16),
                                       jnp.float32)
    want = np.asarray(val * jkernel._codec_gather(codec)(bcs, jw, 8))
    got = pkernel.codec_prod(codec)(torch.from_numpy(w),
                                    torch.from_numpy(tab))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(want, got.numpy())
