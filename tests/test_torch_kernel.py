"""Plain versions of the port's kernels against the JAX package's Pallas
kernels run in interpret mode on the CPU.

  - K1 (octet Top-K sweep): ``octet_topk_plain`` against
    ``spmv_topk_tpu.ops.kernel.topk_spmv_fused_octet_device``. Both with
    tie-safe buffers: h16 scores are int32 sums converted to f32 once, so
    per-lane sorted values must be bit-equal (no tolerance), and
    (value, slice tag) pairs must be equal above each lane's smallest
    kept value (the replacement order decides which of several tied
    candidates takes that last slot).
  - K3 (stream probe): exact int32 wraparound sums.
  - finalize_topk and the h16 decode: exact.

The JAX results are computed once per module (interpret-mode compiles
dominate the suite's time).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import spmv_topk_tpu.config as jcfg
from spmv_topk_tpu.formats.sell_buckets import (fuse_buckets_octet as jfuse,
                                                pack_sell_buckets as jpack)
from spmv_topk_tpu.ops import kernel as jkernel
from spmv_topk_tpu.ops.quantized_query import pack_query_table
from spmv_topk_tpu.ops.streamprobe import stream_words_device as jstream

import spmv_topk_tpu_torch.config as pcfg
from spmv_topk_tpu_torch.formats import create_query_batch, create_sparse_matrix
from spmv_topk_tpu_torch.ops import kernel as pkernel
from spmv_topk_tpu_torch.ops import streamprobe as pstream

BASE = dict(k=100, lane_k=8, max_cols=1024, query_codec="h16",
            fused_layout="octet", width_quantum=2, rescore_pool=400,
            tie_safe_topk=True, block_sublanes=64)
# (fused_block_sublanes, fold_tile): the headline geometry at test size
# (its widest bucket already spans blocks), exact folds with wide octets,
# and the top-3-of-8 fold with wide octets
CASES = [(128, 8), (32, 1), (32, 8)]


@pytest.fixture(scope="module")
def ref():
    coo = create_sparse_matrix(3000, 1024, 20, "gamma", seed=5)
    q = create_query_batch(1, 1024, seed=3)[0]
    table, _ = pack_query_table(q, "h16")
    out = {}
    for fbs, fold in CASES:
        cfg = jcfg.TopKSpMVConfig(**BASE, fused_block_sublanes=fbs,
                                  fold_tile=fold)
        f = jfuse(jpack(coo, cfg), block_sublanes=fbs)
        tv, tt = jkernel.topk_spmv_fused_octet_device(
            jnp.asarray(f.words), jnp.asarray(table), jnp.asarray(f.nreal),
            cfg=cfg, plan=f.plan, block_sublanes=fbs,
            num_blocks=f.num_blocks, interpret=True, codec="h16")
        out[fbs, fold] = (f, np.asarray(tv), np.asarray(tt))
    f = out[CASES[0]][0]
    salt = (np.arange(128, dtype=np.int32) * 7919 - 2**30).reshape(1, 128)
    stream = np.asarray(jstream(jnp.asarray(f.words), jnp.asarray(salt),
                                block_sublanes=f.block_sublanes,
                                num_blocks=f.num_blocks, interpret=True))
    return dict(table=table, cases=out, salt=salt, stream=stream)


def _assert_lanes_match(jv, jt, pv, pt):
    np.testing.assert_array_equal(-np.sort(-jv, axis=0), pv)
    for lane in range(jv.shape[1]):
        floor = pv[:, lane].min()
        a = sorted(zip(jv[:, lane][jv[:, lane] > floor].tolist(),
                       jt[:, lane][jv[:, lane] > floor].tolist()))
        b = sorted(zip(pv[:, lane][pv[:, lane] > floor].tolist(),
                       pt[:, lane][pv[:, lane] > floor].tolist()))
        assert a == b, f"lane {lane}"


@pytest.mark.parametrize("fbs,fold", CASES)
def test_octet_plain_matches_pallas(ref, fbs, fold):
    f, jv, jt = ref["cases"][fbs, fold]
    if fbs == 32:
        assert any(p.blocks_per_octet > 1 for p in f.plan)
    rows = torch.from_numpy(pkernel.octet_plan_rows(f.plan, f.num_blocks))
    pv, pt = pkernel.octet_topk_plain(
        torch.from_numpy(f.words), torch.from_numpy(ref["table"]),
        torch.from_numpy(f.nreal), rows, lane_k=8, fold_tile=fold,
        tie_safe=True, block_sublanes=fbs)
    assert pv.dtype == torch.float32 and pt.dtype == torch.int32
    assert np.isfinite(pv.numpy()).any()
    _assert_lanes_match(jv, jt, pv.numpy(), pt.numpy())


def test_wrapper_on_cpu_runs_plain_without_launch(ref):
    """The wrapper takes the plain version because the tensors lie on the
    CPU: same result, and the launch counter does not move."""
    f, jv, jt = ref["cases"][CASES[0]]
    cfg = pcfg.TopKSpMVConfig(**BASE, fused_block_sublanes=128, fold_tile=8)
    before = pkernel.topk_spmv_fused_octet_device.launches
    pv, pt = pkernel.topk_spmv_fused_octet_device(
        torch.from_numpy(f.words), torch.from_numpy(ref["table"]),
        torch.from_numpy(f.nreal),
        torch.from_numpy(pkernel.octet_plan_rows(f.plan, f.num_blocks)),
        cfg=cfg, block_sublanes=128)
    assert pkernel.topk_spmv_fused_octet_device.launches == before
    _assert_lanes_match(jv, jt, pv.numpy(), pt.numpy())


def test_wrapper_on_other_device_raises():
    """Off the CPU the wrapper launches the kernel or raises: a tensor on
    the meta device must not fall back to the plain version."""
    cfg = pcfg.TopKSpMVConfig(**BASE, fused_block_sublanes=128, fold_tile=8)
    meta = dict(dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        pkernel.topk_spmv_fused_octet_device(
            torch.empty((128, 128), **meta), torch.empty((1, 128), **meta),
            torch.empty((1, 1), **meta), torch.empty((1, 8), **meta),
            cfg=cfg, block_sublanes=128)
    with pytest.raises(ValueError, match="CUDA"):
        pstream.stream_words_device(torch.empty((128, 128), **meta),
                                    torch.empty((1, 128), **meta))


def test_plan_rows_reject_a_plan_that_does_not_tile(ref):
    f = ref["cases"][CASES[0]][0]
    rows = pkernel.octet_plan_rows(f.plan, f.num_blocks)
    assert rows[-1, 7] + rows[-1, 3] == sum(p.stride for p in f.plan)
    with pytest.raises(ValueError):
        pkernel.octet_plan_rows(f.plan, f.num_blocks + 1)
    with pytest.raises(ValueError):
        pkernel.octet_plan_rows(f.plan[1:], f.num_blocks)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prod_h16_matches_jax(seed):
    """h16 decode on random words (all bit patterns, both signs) and
    random int4x8 tables: exact, the JAX side with masked lanes."""
    rng = np.random.default_rng(seed)
    w = rng.integers(-2**31, 2**31, (8, 128), dtype=np.int64).astype(np.int32)
    tab = rng.integers(-2**31, 2**31, (1, 128), dtype=np.int64).astype(
        np.int32)
    bc = jnp.broadcast_to(jnp.asarray(tab), (8, 128))
    want = np.asarray(jkernel._prod_h16([bc], jnp.asarray(w), mask_lanes=True))
    got = pkernel.prod_h16(torch.from_numpy(w), torch.from_numpy(tab[0]))
    np.testing.assert_array_equal(want, got.numpy())


def test_topk_init_matches_jax():
    np.testing.assert_array_equal(
        np.asarray(jkernel._topk_init(8))[:, 0], pkernel.topk_init(8))
    assert (pkernel.topk_init(8) < pkernel.TOPK_FLOOR).all()


def test_stream_plain_matches_pallas(ref):
    f = ref["cases"][CASES[0]][0]
    got = pstream.stream_words_plain(torch.from_numpy(f.words),
                                     torch.from_numpy(ref["salt"]))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(ref["stream"], got.numpy())
    via_wrapper = pstream.stream_words_device(torch.from_numpy(f.words),
                                              torch.from_numpy(ref["salt"]))
    np.testing.assert_array_equal(ref["stream"], via_wrapper.numpy())


def test_stream_plain_wraps_like_int32():
    """Sums past 2^31 wrap as int32 additions do."""
    w = np.full((16, 128), 2**31 - 1, np.int32)
    salt = np.full((1, 128), 5, np.int32)
    got = pstream.stream_words_plain(torch.from_numpy(w),
                                     torch.from_numpy(salt)).numpy()
    want = (np.int64(2**31 - 1) * 2 + 5 + 2**31) % 2**32 - 2**31
    assert (got == want).all()


@pytest.mark.parametrize("seed,k", [(0, 100), (1, 37), (2, 2000)])
def test_finalize_topk_matches_jax(seed, k):
    """Same values, and the same row sets above the k-th value (the order
    among rows tied at the k-th value is not specified)."""
    rng = np.random.default_rng(seed)
    K, slices = 8, 40
    topv = rng.integers(-50, 50, (K, 128)).astype(np.float32)
    topv[rng.random((K, 128)) < 0.1] = pkernel.topk_init(K)[0]
    topv[rng.random((K, 128)) < 0.05] = -np.inf
    topt = rng.integers(0, slices + 5, (K, 128)).astype(np.int32)
    row_ids = rng.permutation(slices * 128).reshape(slices, 128).astype(
        np.int32)
    row_ids[-3:] = -1
    ji, jv = map(np.asarray, jkernel.finalize_topk(
        jnp.asarray(topv), jnp.asarray(topt), jnp.asarray(row_ids), k=k))
    pi, pv = pkernel.finalize_topk(torch.from_numpy(topv),
                                   torch.from_numpy(topt),
                                   torch.from_numpy(row_ids), k=k)
    pi, pv = pi.numpy(), pv.numpy()
    np.testing.assert_array_equal(jv, pv)
    kth = pv[-1]
    assert set(ji[jv > kth].tolist()) == set(pi[pv > kth].tolist())
    assert (pi[np.isfinite(pv)] >= 0).all()
