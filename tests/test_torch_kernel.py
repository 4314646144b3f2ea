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
  - the plain single and batch sweeps of both layouts (K1, K6, K7, K8)
    on a stream where a few slices score NaN (and +inf, -inf), against
    the interpret-mode kernels: integer-valued f32 data, so values are
    bit-equal, pairs equal above each lane's floor (the section at the
    end).

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


def test_ptxas_report_reads_registers_and_spills(tmp_path, monkeypatch):
    """Kernel names, template arguments, registers and spill stores from
    nvcc's -Xptxas=-v output, the names through the toolkit's cu++filt
    and trimmed to kernel<args> (lines as nvcc and cu++filt 12.9 print
    them; here a stand-in for cu++filt prints them)."""
    import json
    import sys

    from spmv_topk_tpu_torch.ops import _build

    names = {
        "_ZN52_GLOBAL__N__ba66f468_19_octet_topk_batch_cu_4825f2a123octet_"
        "topk_batch_kernelILi16ELi8ELb0ELb1EEEvPKiS2_S2_S2_iiiiiPfPi":
            "void <unnamed>::octet_topk_batch_kernel<(int)16, (int)8, "
            "(bool)0, (bool)1>(const int *, const int *, const int *, "
            "const int *, int, int, int, int, int, float *, int *)",
        "_ZN48_GLOBAL__N__7ea079ae_15_octet_scores_cu_14ecab5619octet_"
        "scores_kernelEPKiS1_S1_S1_iiPf":
            "<unnamed>::octet_scores_kernel(const int *, const int *, "
            "const int *, const int *, int, int, float *)",
        "_ZN46_GLOBAL__N__f0e1d2c3_13_slice_topk_cu_1a2b3c4d17slice_topk_"
        "kernelIN5slice3H16ELi8ELb1EEEvPKiPKNT_3TabES3_S3_iiiiPfPi":
            "void <unnamed>::slice_topk_kernel<slice::H16, (int)8, (bool)1>"
            "(const int *, const T1::Tab *, const int, const int, int, int, "
            "int, int, float *, int *)",
        "_ZN52_GLOBAL__N__0a1b2c3d_19_slice_topk_batch_cu_5e6f7a8b23slice_"
        "topk_batch_kernelINS_8F32BatchELi4ELi2ELb0EEEvPKiPKvS3_S3_iiiiiiPfPi":
            "void <unnamed>::slice_topk_batch_kernel<<unnamed>::F32Batch, "
            "(int)4, (int)2, (bool)0>(const int *, const void *, "
            "const int *, const int *, int, int, int, int, int, int, "
            "float *, int *)"}
    m = list(names)
    cufilt = tmp_path / "cu++filt"
    cufilt.write_text(f"#!{sys.executable}\nimport json, sys\n"
                      f"names = json.loads({json.dumps(json.dumps(names))})\n"
                      "print('\\n'.join(names[a] for a in sys.argv[1:]))\n")
    cufilt.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(tmp_path / "nvcc"))
    lib = tmp_path / "lib.so"
    (tmp_path / "lib.so.ptxas.txt").write_text(
        "== octet_topk_batch.cu\n"
        f"ptxas info    : Compiling entry function '{m[0]}' for 'sm_90a'\n"
        "    0 bytes stack frame, 3316 bytes spill stores, 3316 bytes spill "
        "loads\n"
        "ptxas info    : Used 255 registers, 416 bytes cmem[0]\n"
        "== octet_scores.cu\n"
        f"ptxas info    : Compiling entry function '{m[1]}' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 32 registers, 400 bytes cmem[0]\n"
        "== slice_topk.cu\n"
        f"ptxas info    : Compiling entry function '{m[2]}' for 'sm_90a'\n"
        "ptxas info    : Used 40 registers, 424 bytes cmem[0]\n"
        "== slice_topk_batch.cu\n"
        f"ptxas info    : Compiling entry function '{m[3]}' for 'sm_90a'\n"
        "    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads\n"
        "ptxas info    : Used 64 registers, 432 bytes cmem[0]\n")
    monkeypatch.setattr(_build, "library_path", lambda: str(lib))
    assert _build.ptxas_report() == {
        "octet_topk_batch_kernel<16,8,0,1>": (255, 3316),
        "octet_scores_kernel": (32, 0),
        "slice_topk_kernel<H16,8,1>": (40, 0),
        "slice_topk_batch_kernel<F32Batch,4,2,0>": (64, 8)}


# ------------------------------------------------ a slice that scores NaN
# The JAX kernels never admit a NaN score (``score >= minimum`` is false),
# and a NaN member makes a harvest's ``jnp.max`` NaN, which keeps the other
# members of that octet or sub-tile out of that round. The plain sweeps of
# both layouts, single and batch, are held to the interpret-mode kernels on
# a stream where a few rows read a query entry that is NaN, or +inf and
# -inf (their slice scores NaN in that lane), or only one of the infinities
# (+inf or -inf scores). Integer-valued data: every finite sum exact, so
# values are bit-equal; (value, tag) pairs above each lane's floor equal.

NAN_COLS = (1021, 1022, 1023)        # query NaN, +inf, -inf
NAN_BASE = dict(k=100, lane_k=8, max_cols=1024, query_codec="f32",
                width_quantum=2, tie_safe_topk=True, block_sublanes=64,
                fused_block_sublanes=128, batch_subgroup=2)
NAN_CASES = {"octet_fold8": dict(NAN_BASE, fused_layout="octet", fold_tile=8),
             "octet_fold1": dict(NAN_BASE, fused_layout="octet", fold_tile=1),
             "slice_fold8": dict(NAN_BASE, fused_layout="slice", fold_tile=8)}


def nan_corpus(rows=1200, seed=5):
    """(rows, cols, vals, num_rows, num_cols) of an integer-valued gamma
    corpus whose columns NAN_COLS are read only by chosen rows: rows
    reading the NaN column, both infinities, +inf only and -inf only."""
    coo = create_sparse_matrix(rows, 1024, 20, "gamma", seed=seed)
    rng = np.random.default_rng(seed + 1)
    cols = np.where(coo.cols >= NAN_COLS[0], coo.cols - 3, coo.cols)
    vals = rng.integers(-8, 9, coo.nnz).astype(np.float32)
    picked = rng.choice(rows, 40, replace=False)
    extra = ([(r, NAN_COLS[0]) for r in picked[:12]]
             + [(r, c) for r in picked[12:24] for c in NAN_COLS[1:]]
             + [(r, NAN_COLS[1]) for r in picked[24:32]]
             + [(r, NAN_COLS[2]) for r in picked[32:]])
    er, ec = (np.array(x, np.int32) for x in zip(*extra))
    r = np.concatenate([coo.rows, er])
    c = np.concatenate([cols, ec])
    v = np.concatenate([vals, np.full(len(er), 2.0, np.float32)])
    order = np.lexsort((c, r))
    return r[order], c[order], v[order], rows, 1024


def nan_tables(num):
    """(num, 8, 128) f32 query tables of small integers with NAN_COLS set
    to NaN, +inf and -inf."""
    q = np.random.default_rng(9).integers(-4, 5, (num, 1024)).astype(
        np.float32)
    q[:, NAN_COLS[0]] = np.nan
    q[:, NAN_COLS[1]] = np.inf
    q[:, NAN_COLS[2]] = -np.inf
    return q.reshape(num, 8, 128)


@pytest.fixture(scope="module")
def nan_ref():
    from spmv_topk_tpu.formats import CooMatrix as JCoo
    from spmv_topk_tpu.formats.sell_buckets import fuse_buckets as jfuse_slice

    coo = JCoo(*nan_corpus())
    tabs = nan_tables(2)
    out = {}
    for name, kw in NAN_CASES.items():
        cfg = jcfg.TopKSpMVConfig(**kw)
        octet = kw["fused_layout"] == "octet"
        f = (jfuse if octet else jfuse_slice)(jpack(coo, cfg),
                                              block_sublanes=128)
        args = (jnp.asarray(f.words), jnp.asarray(tabs[0]),
                jnp.asarray(f.nreal))
        kw_j = dict(cfg=cfg, plan=f.plan, block_sublanes=128,
                    num_blocks=f.num_blocks, interpret=True, codec="f32")
        single = (jkernel.topk_spmv_fused_octet_device if octet
                  else jkernel.topk_spmv_fused_device)(*args, **kw_j)
        batch = (jkernel.topk_spmv_fused_batch_octet_device if octet
                 else jkernel.topk_spmv_fused_batch_device)(
            args[0], jnp.asarray(tabs), args[2], **kw_j)
        out[name] = (f, tuple(map(np.asarray, single)),
                     tuple(map(np.asarray, batch)))
    return tabs, out


@pytest.mark.parametrize("batch", [False, True], ids=["single", "batch"])
@pytest.mark.parametrize("case", list(NAN_CASES))
def test_plain_sweeps_rank_nan_as_the_kernels(nan_ref, case, batch):
    tabs, out = nan_ref
    f, single, multi = out[case]
    kw = NAN_CASES[case]
    octet = kw["fused_layout"] == "octet"
    words, nreal = torch.from_numpy(f.words), torch.from_numpy(f.nreal)
    if octet:
        rows = torch.from_numpy(pkernel.octet_plan_rows(f.plan,
                                                        f.num_blocks))
        scores = pkernel.octet_scores_plain(
            words, torch.from_numpy(tabs[0]), nreal, rows,
            num_slices=int(f.nreal.sum()) + 1, block_sublanes=128,
            codec="f32")
    else:
        rows = torch.from_numpy(pkernel.slice_plan_rows(
            f.plan, f.num_blocks, f.nreal, 128))
        scores = pkernel.slice_scores_plain(
            words, torch.from_numpy(tabs[0]), nreal, rows,
            num_slices=int(f.nreal.sum()) + 1, block_sublanes=128,
            codec="f32")
    # the stream has NaN, +inf and -inf slice scores, each in a few lanes
    assert 0 < int(torch.isnan(scores).sum()) < 40
    assert (scores == np.inf).any() and (scores == -np.inf).any()
    plain_kw = dict(lane_k=8, tie_safe=True, block_sublanes=128, codec="f32")
    if batch:
        fn = (pkernel.octet_topk_batch_plain if octet
              else pkernel.slice_topk_batch_plain)
        if octet:
            plain_kw["fold_tile"] = kw["fold_tile"]
        pv, pt_ = fn(words, torch.from_numpy(tabs), nreal, rows, **plain_kw)
        jv, jt_ = multi
    else:
        fn = pkernel.octet_topk_plain if octet else pkernel.slice_topk_plain
        pv, pt_ = fn(words, torch.from_numpy(tabs[0]), nreal, rows,
                     fold_tile=kw["fold_tile"], **plain_kw)
        pv, pt_, jv, jt_ = pv[None], pt_[None], single[0][None], \
            single[1][None]
    assert not torch.isnan(pv).any()
    assert (pv == np.inf).any()
    for q in range(pv.shape[0]):
        _assert_lanes_match(jv[q], jt_[q], pv[q].numpy(), pt_[q].numpy())
