"""The query codecs ``f32``, ``int8x4``, ``i8s`` and ``i4s`` on the port's
octet stream (kernels K1, K6, K4, K10b) against the JAX package on the CPU.

The port runs the plain versions of its kernels here; the JAX package
runs its Pallas kernels in interpret mode (one fused call per sweep,
``octet_multicall=False``: the port sweeps every bucket in one launch and
both calls give the same candidates), every program once, in the module
fixture. The port adds an octet's products in the JAX kernels' own order
(K1 and K4: the even and the odd chunks of a block in two accumulators,
K6: one; a wide octet's block sums in block order). Tolerances:
  - int8x4, i8s, i4s: a product is a bf16 value times an 8- or 4-bit
    integer, exact in float32, so the sums round alike in both packages
    on any data: per-lane values and ``scores()`` bit-equal, and (value,
    slice) pairs equal above each lane's smallest kept value (tie-safe
    buffers);
  - f32: XLA on the CPU fuses some multiply-adds of the interpret-mode
    kernel into FMAs (one rounding where the port, as the TPU, rounds the
    product and the sum), and which ones depends on its fusion choices,
    so values agree to rtol 1e-6 and (value, slice) pairs above each
    lane's floor less that margin.
"""

import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import spmv_topk_tpu as jt
import spmv_topk_tpu.config as jcfg
from spmv_topk_tpu.formats import create_sparse_matrix as jax_matrix
from spmv_topk_tpu.formats.sell_buckets import (fuse_buckets_octet as jfuse,
                                                pack_fused_partitions,
                                                pack_sell_buckets as jpack)
from spmv_topk_tpu.ops import kernel as jkernel
from spmv_topk_tpu.ops.quantized_query import (pack_query_table,
                                               pack_query_tables)

import spmv_topk_tpu_torch as pt
from spmv_topk_tpu_torch.formats import (create_query_batch,
                                         create_sparse_matrix)
from spmv_topk_tpu_torch.ops import kernel as pkernel
from spmv_topk_tpu_torch.ops.quantized_query import (
    pack_query_table as port_table)

ROWS, COLS = 3000, 1024
OCTET = dict(k=100, lane_k=8, max_cols=1024, fused_layout="octet",
             width_quantum=2, fold_tile=8, tie_safe_topk=True,
             block_sublanes=64, fused_block_sublanes=128,
             octet_multicall=False)
# kernel level: name -> (config, queries; 0 is the single-query sweep)
KERNELS = {
    "k1_f32": (dict(OCTET, query_codec="f32"), 0),
    "k1_i8s": (dict(OCTET, query_codec="i8s"), 0),
    # 32-row blocks: wide octets, with the exact fold and the top 3 of 8
    "k1_i4s_fold1_wide": (dict(OCTET, query_codec="i4s", fold_tile=1,
                               fused_block_sublanes=32), 0),
    "k1_int8x4_wide": (dict(OCTET, query_codec="int8x4",
                            fused_block_sublanes=32), 0),
    "k6_i4s": (dict(OCTET, query_codec="i4s", batch_subgroup=2), 3),
    "k6_f32_wide": (dict(OCTET, query_codec="f32", batch_subgroup=2,
                         fused_block_sublanes=32), 3),
}
SCORES_CODEC = "int8x4"


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("codecs_octet")
    out = dict(dir=d, kernels={})
    jcoo = jax_matrix(ROWS, COLS, 20, "gamma", seed=5)
    for name, (kw, Q) in KERNELS.items():
        cfg = jcfg.TopKSpMVConfig(**kw)
        f = jfuse(jpack(jcoo, cfg), block_sublanes=kw["fused_block_sublanes"])
        geo = dict(cfg=cfg, plan=f.plan, block_sublanes=f.block_sublanes,
                   num_blocks=f.num_blocks, interpret=True,
                   codec=cfg.query_codec)
        qs = create_query_batch(max(Q, 1), COLS, seed=3)
        if Q:
            tabs, _ = pack_query_tables(qs, cfg.query_codec)
            tv, tt = jkernel.topk_spmv_fused_batch_octet_device(
                jnp.asarray(f.words), jnp.asarray(tabs),
                jnp.asarray(f.nreal), **geo)
        else:
            tabs, _ = pack_query_table(qs[0], cfg.query_codec)
            tv, tt = jkernel.topk_spmv_fused_octet_device(
                jnp.asarray(f.words), jnp.asarray(tabs),
                jnp.asarray(f.nreal), **geo)
        out["kernels"][name] = (f, tabs, np.asarray(tv), np.asarray(tt))
    # K10b: i4s on three partitions
    cfg = jcfg.TopKSpMVConfig(**dict(OCTET, query_codec="i4s",
                                     num_partitions=3))
    f = pack_fused_partitions(jcoo, cfg, 3, octet=True)
    table, _ = pack_query_table(create_query_batch(1, COLS, seed=4)[0],
                                "i4s")
    tv, tt = jkernel.topk_spmv_fused_octet_part_device(
        jnp.asarray(f.words), jnp.asarray(table), jnp.asarray(f.nreal),
        cfg=cfg, plan=f.plan, block_sublanes=f.block_sublanes,
        num_blocks=f.num_blocks, num_partitions=3,
        part_slices=f.part_slices, interpret=True, codec="i4s")
    out["k10b"] = (f, table, np.asarray(tv), np.asarray(tt))
    # K4 through scores(), wide octets; the octet f32 engine's snapshot
    q = create_query_batch(1, COLS, seed=5)[0]
    jeng = jt.TopKSpMV(jcoo, jt.TopKSpMVConfig(**dict(
        OCTET, query_codec=SCORES_CODEC, fused_block_sublanes=32)))
    out["scores"] = (q, np.asarray(jeng.scores(q)))
    jeng = jt.TopKSpMV(jcoo, jt.TopKSpMVConfig(**KERNELS["k1_f32"][0]))
    jeng.save(str(d / "octet_f32.npz"))
    out["coo"] = create_sparse_matrix(ROWS, COLS, 20, "gamma", seed=5)
    return out


def _assert_lanes_match(jv, jt_, pv, pt_, rtol=0.0):
    """Sorted values equal (to rtol), (value, tag) pairs above each
    lane's floor (less the rtol margin) equal, for each (lane_k, 128)
    buffer of a leading axis."""
    if jv.ndim > 2:
        assert jv.shape == pv.shape
        for a, b, c, e in zip(jv, jt_, pv, pt_):
            _assert_lanes_match(a, b, c, e, rtol)
        return
    js = -np.sort(-jv, axis=0)
    if rtol:
        np.testing.assert_allclose(js, pv, rtol=rtol)
    else:
        np.testing.assert_array_equal(js, pv)
    for lane in range(jv.shape[1]):
        floor = pv[:, lane].min()
        floor = floor + rtol * np.abs(floor) if np.isfinite(floor) else floor
        a = sorted(jt_[:, lane][jv[:, lane] > floor].tolist())
        b = sorted(pt_[:, lane][pv[:, lane] > floor].tolist())
        assert a == b, f"lane {lane}"
        if not rtol:
            a = sorted(zip(jv[:, lane][jv[:, lane] > floor].tolist(),
                           jt_[:, lane][jv[:, lane] > floor].tolist()))
            b = sorted(zip(pv[:, lane][pv[:, lane] > floor].tolist(),
                           pt_[:, lane][pv[:, lane] > floor].tolist()))
            assert a == b, f"lane {lane}"


def _plan_rows(f):
    return torch.from_numpy(pkernel.octet_plan_rows(f.plan, f.num_blocks))


@pytest.mark.parametrize("name", list(KERNELS))
def test_octet_codec_plain_matches_pallas(ref, name):
    f, tabs, jv, jt_ = ref["kernels"][name]
    kw, Q = KERNELS[name]
    cfg = pt.TopKSpMVConfig(**kw)
    if "wide" in name:
        assert any(p.blocks_per_octet > 1 for p in f.plan)
    args = (torch.from_numpy(f.words), torch.from_numpy(tabs),
            torch.from_numpy(f.nreal), _plan_rows(f))
    sweep = (pkernel.topk_spmv_fused_batch_octet_device if Q
             else pkernel.topk_spmv_fused_octet_device)
    pv, pt_ = sweep(*args, cfg=cfg, block_sublanes=f.block_sublanes)
    assert pv.shape == ((Q, 8, 128) if Q else (8, 128))
    assert np.isfinite(pv.numpy()).any()
    _assert_lanes_match(jv, jt_, pv.numpy(), pt_.numpy(),
                        rtol=1e-6 if cfg.query_codec == "f32" else 0.0)


def test_partitioned_octet_codec_matches_pallas(ref):
    """K10b, i4s on three partitions: a pool per partition, bit-equal."""
    f, table, jv, jt_ = ref["k10b"]
    cfg = pt.TopKSpMVConfig(**dict(OCTET, query_codec="i4s",
                                   num_partitions=3))
    pv, pt_ = pkernel.topk_spmv_fused_octet_device(
        torch.from_numpy(f.words), torch.from_numpy(table),
        torch.from_numpy(f.nreal), _plan_rows(f), cfg=cfg,
        block_sublanes=f.block_sublanes, num_partitions=3,
        part_slices=f.part_slices)
    assert pv.shape == (3, 8, 128)
    _assert_lanes_match(jv, jt_, pv.numpy(), pt_.numpy())


def test_octet_codec_scores_bit_equal(ref):
    """K4 with wide octets (int8x4): scores() bit-equal on real values."""
    q, want = ref["scores"]
    peng = pt.TopKSpMV(ref["coo"], pt.TopKSpMVConfig(**dict(
        OCTET, query_codec=SCORES_CODEC, fused_block_sublanes=32)),
        device="cpu")
    assert any(p.blocks_per_octet > 1 for p in peng.fused.plan)
    got = _np(peng.scores(q))
    np.testing.assert_array_equal(want, got)
    assert np.abs(got).max() > 0


def test_batch_sums_in_k6_order(ref):
    """K6 adds an octet's chunks in one accumulator, K1 in two: the f32
    batch sweep's candidates are the single sweep's to rtol 1e-6, and a
    plain K6 of one query is not the plain K1 bit for bit."""
    f, tabs, _, _ = ref["kernels"]["k6_f32_wide"]
    args = (torch.from_numpy(f.words), torch.from_numpy(tabs[0]),
            torch.from_numpy(f.nreal), _plan_rows(f))
    kw = dict(lane_k=8, fold_tile=8, tie_safe=True,
              block_sublanes=f.block_sublanes, codec="f32")
    sv, _ = pkernel.octet_topk_plain(*args, **kw)
    bv, _ = pkernel.octet_topk_batch_plain(args[0], args[1][None],
                                           *args[2:], **kw)
    np.testing.assert_allclose(sv.numpy(), bv[0].numpy(), rtol=1e-6)
    assert not torch.equal(sv, bv[0])


def test_jax_octet_f32_snapshot_loads_in_port(ref):
    """The JAX package's save() of an octet f32 engine: the port's load()
    gives the port's own pack and the JAX kernel's candidates."""
    peng = pt.TopKSpMV.load(str(ref["dir"] / "octet_f32.npz"), device="cpu")
    built = pt.TopKSpMV(ref["coo"], pt.TopKSpMVConfig(
        **KERNELS["k1_f32"][0]), device="cpu")
    assert peng.config == built.config
    assert peng.config.query_codec == "f32"
    for name in ("words", "nreal", "row_ids", "plan_rows"):
        np.testing.assert_array_equal(_np(getattr(peng, name)),
                                      _np(getattr(built, name)))
    _, _, jv, jt_ = ref["kernels"]["k1_f32"]
    pv, pt_ = peng.candidates(create_query_batch(1, COLS, seed=3)[0])
    _assert_lanes_match(jv, jt_, pv.numpy(), pt_.numpy(), rtol=1e-6)
    idx, vals = peng.query(create_query_batch(1, COLS, seed=3)[0])
    assert idx.shape == (100,) and np.isfinite(_np(vals)).all()


def test_kernel_codecs_match_the_cuda_enum():
    """KERNEL_CODECS is the kernels' codec argument: the same names in the
    order of csrc/codecs.cuh's enum Codec."""
    path = os.path.join(os.path.dirname(pkernel.__file__), os.pardir, "csrc",
                        "codecs.cuh")
    with open(path) as fh:
        enum = re.search(r"enum Codec \{([^}]*)\}", fh.read()).group(1)
    names = [n.strip() for n in enum.split(",")]
    assert names[-1] == "kNumCodecs"
    camel = ["k" + "".join(p.capitalize() for p in c.split("_"))
             for c in pkernel.KERNEL_CODECS]
    assert [n.lower() for n in names[:-1]] == [c.lower() for c in camel]


@pytest.mark.parametrize("codec,rows", [
    ("h16", 1), ("f32", 8), ("f32", 512), ("int8x4", 2), ("int8x4", 128),
    ("i8s", 2), ("i4s", 1), ("i4s", 2)])
def test_table_spec_matches_the_query_tables(codec, rows):
    """Each codec's table, as the wrappers check it, is what
    pack_query_table packs for max_cols columns."""
    max_cols = {"h16": 1024, "f32": 128 * rows, "int8x4": 512 * rows,
                "i8s": 512 * rows, "i4s": 1024 * rows}[codec]
    cfg = pt.TopKSpMVConfig(max_cols=max_cols, query_codec=codec)
    want_rows, dtype = pkernel._table_spec(cfg)
    tab, _ = port_table(np.ones(max_cols, np.float32), codec)
    assert want_rows == rows and tab.shape == (rows, 128)
    assert torch.from_numpy(np.ascontiguousarray(tab)).dtype == dtype


def test_octet_codec_wrapper_on_cpu_runs_plain(ref):
    """The wrappers take the plain versions because the tensors lie on the
    CPU; the launch counters do not move."""
    f, tabs, jv, jt_ = ref["kernels"]["k1_i8s"]
    cfg = pt.TopKSpMVConfig(**KERNELS["k1_i8s"][0])
    wrappers = (pkernel.topk_spmv_fused_octet_device,
                pkernel.topk_spmv_fused_batch_octet_device,
                pkernel.spmv_fused_scores_octet_device)
    before = [w.launches for w in wrappers]
    args = (torch.from_numpy(f.words), torch.from_numpy(tabs),
            torch.from_numpy(f.nreal), _plan_rows(f))
    pv, pt_ = wrappers[0](*args, cfg=cfg, block_sublanes=f.block_sublanes)
    _assert_lanes_match(jv, jt_, pv.numpy(), pt_.numpy())
    bargs = (args[0], args[1][None], *args[2:])
    bv, bt = wrappers[1](*bargs, cfg=cfg, block_sublanes=f.block_sublanes)
    want = pkernel.octet_topk_batch_plain(
        *bargs, lane_k=8, fold_tile=8, tie_safe=True,
        block_sublanes=f.block_sublanes, codec="i8s")
    assert torch.equal(bv, want[0]) and torch.equal(bt, want[1])
    sc = wrappers[2](*args, cfg=cfg, block_sublanes=f.block_sublanes,
                     num_slices=f.row_ids.shape[0])
    assert sc.shape == (f.row_ids.shape[0], 128) and (sc[-1] == 0).all()
    assert [w.launches for w in wrappers] == before
