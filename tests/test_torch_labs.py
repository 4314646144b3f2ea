"""The port's measurement labs (spmv_topk_tpu_torch/experiments: kernel_lab
L7, fused_lab L4, h16_lab L5, fold_lab L3) against the JAX labs of
experiments/ on the CPU.

The port runs the labs' plain versions here. The JAX labs' kernels run in
interpret mode with nothing in experiments/ edited: the module fixture
swaps jax.experimental.pallas.pallas_call for its interpret form, sets
the labs' module globals (W, SPB, BLOCK_SUB, NB, FOLD) to a small
geometry and runs every program once. Interpret mode and the TPU differ
where a gather index reaches past 127 (interpret mode fills, the TPU's
lane gather reads the low 7 bits) and where a shift amount reaches 32
(XLA gives 0, the TPU wraps it), so those runs take words whose gather
fields stay below 128 and whose shift amounts stay below 32 (for the raw
h16 gathers of nsh_int_raw, v2 and fold_lab that leaves words below 128,
whose products are 0: those runs check the folds' tags only). NumPy
oracles of the TPU's semantics then take the labs' own random words:
gathers of index & 127, shift amounts mod 32, float denormals flushed to
zero, h16_lab.check's integer oracle (h16_lab.py:233-273), a v2 oracle on
v2-layout words, and the folds run slice by slice as the JAX kernels run
them.

Tolerances:
  - integer-valued data (small integers: every product and partial sum
    exact) and the h16 labs' int32 sums: bit-equal values (NaN where NaN),
    (value, tag) pairs equal above each lane's smallest kept value, and
    for the fast fold (every slot the running maximum) the tags too;
  - real finite data: values to rtol 1e-6, with atol 1e-6 for sums that
    cancel to near 0 (XLA may add a slice's rows in another order than
    the halving tree the port takes: it does for the stream bodies), tags
    above the smallest kept value less that margin; h16_lab's stream (f32
    sums of words of ~2**31) the same;
  - the oracles: bit-equal (they add in the port's order; what they hold
    is each decode and each fold).
"""

import functools
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas

import experiments.fold_lab as jfold
import experiments.fused_lab as jfused
import experiments.h16_lab as jh16
import experiments.kernel_lab as jkl
import spmv_topk_tpu.config as jcfg
from spmv_topk_tpu.formats.sell_buckets import FusedBucket as JFusedBucket
from spmv_topk_tpu.ops import kernel as jkernel

from spmv_topk_tpu_torch.experiments import _common
from spmv_topk_tpu_torch.experiments import fold_lab, fused_lab, h16_lab
from spmv_topk_tpu_torch.experiments import kernel_lab

LANES = 128
FLT_MIN = np.float32(2.0 ** -126)
CSRC = os.path.join(os.path.dirname(_common.__file__), os.pardir, "csrc")

# geometries of the interpret-mode runs: kernel_lab 3 chunks a slice (the
# odd tail chunk), SPB a multiple of 4 (top1g4); fused_lab three segments
# of 2 blocks; fold_lab one chunk a slice (one accumulator)
KL = dict(W=24, SPB=4, NB=2)
FU = dict(W=16, SPB=4, NB=6)
H16 = dict(W=16, SPB=4, NB=2)
FO = dict(W=8, SPB=4, NB=3)
FO_LIMITS = (FO["NB"] * FO["SPB"] - 3, 0, FO["NB"] * FO["SPB"] + 5)
FU_NREAL = np.array([[2 * 4 - 1], [2 * 4 - 6], [2 * 4]], np.int32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bf16_bits(x):
    return np.asarray(x, np.float32).view(np.uint32) >> 16


def _restricted_words(rng, rows, real):
    """kernel_lab / fused_lab words whose gather field w >> 16 stays below
    128 (so no shift amount reaches 32): value bits a small integer's bf16
    (``real`` False) or a normal value's."""
    cols = rng.integers(0, 128, (rows, LANES)).astype(np.uint32)
    vals = (rng.standard_normal((rows, LANES)) if real else
            rng.integers(-8, 9, (rows, LANES)))
    return ((cols << 16) | _bf16_bits(vals)).view(np.int32)


def _kl_inputs(real):
    rng = np.random.default_rng(31 + real)
    words = _restricted_words(rng, KL["NB"] * KL["W"] * KL["SPB"], real)
    ftab = (rng.standard_normal((8, LANES)) if real else
            rng.integers(-4, 5, (8, LANES))).astype(np.float32)
    itab = rng.integers(-2**31, 2**31 - 1, (8, LANES),
                        dtype=np.int64).astype(np.int32)
    return words, {v: (ftab if v in kernel_lab.FLOAT_TABLES else itab)[:r]
                   for v, r in kernel_lab.VARIANTS.items()}


def _fu_inputs(real):
    rng = np.random.default_rng(41 + real)
    words = _restricted_words(rng, FU["NB"] * FU["W"] * FU["SPB"], real)
    itab = rng.integers(-2**31, 2**31 - 1, (2, LANES),
                        dtype=np.int64).astype(np.int32)
    return words, itab


def _h16_fields(w):
    """(col, val) of each half of v1 h16 words: (n, 128, 2) each."""
    w = w.view(np.uint32)
    half = np.stack([w & 0xFFFF, w >> 16], axis=-1).astype(np.int64)
    return half & 0x3FF, ((half >> 10) ^ 32) - 32


def _h16_inputs():
    """variant -> (words, table) of the interpret-mode runs: the raw
    gathers' words below 128; cur's and nsh's upper half (gathered raw)
    below 128; stream's any."""
    rng = np.random.default_rng(51)
    rows = H16["NB"] * H16["W"] * H16["SPB"]
    table, _ = _common.h16_table(rng)
    low = (_common.h16_words(rng, rows).view(np.uint32) & 0xFFFF) | (
        rng.integers(0, 128, (rows, LANES)).astype(np.uint32) << 16)
    tiny = rng.integers(0, 128, (rows, LANES)).astype(np.int32)
    full = _common.h16_words(rng, rows)
    words = {"stream": full, "nsh_int_raw": tiny, "v2": tiny}
    return {v: (words.get(v, low.view(np.int32)), table)
            for v in h16_lab.VARIANTS}


def _fo_inputs():
    rng = np.random.default_rng(61)
    rows = FO["NB"] * FO["W"] * FO["SPB"]
    return (rng.integers(0, 128, (rows, LANES)).astype(np.int32),
            _common.h16_table(rng)[0])


@pytest.fixture(scope="module")
def jax_runs():
    """Every JAX lab program of the interpret-mode tests, run once:
    key -> (topv, topt) as numpy, in the kernel's slot order."""
    out = {}
    orig = pallas.pallas_call
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pallas, "pallas_call",
                   functools.partial(orig, interpret=True))
        # kernel_lab: 12 bodies x 3 folds x (integer, real)
        mp.setattr(jkl, "W", KL["W"])
        mp.setattr(jkl, "SPB", KL["SPB"])
        mp.setattr(jkl, "BLOCK_SUB", KL["W"] * KL["SPB"])
        data = {real: _kl_inputs(real) for real in (False, True)}
        for fold in kernel_lab.FOLDS:
            mp.setattr(jkl, "FOLD", fold)
            jax.clear_caches()
            for v in kernel_lab.VARIANTS:
                for real, (words, tabs) in data.items():
                    out["kernel_lab", v, fold, real] = tuple(map(
                        np.asarray, jkl.run(words, tabs[v], variant=v,
                                            num_blocks=KL["NB"])))
        # fused_lab: 3 variants x (exact, fast) x (integer, real)
        for name in ("W", "SPB", "NB"):
            mp.setattr(jfused, name, FU[name])
        mp.setattr(jfused, "BLOCK_SUB", FU["W"] * FU["SPB"])
        for fold in fused_lab.FOLDS:
            mp.setattr(jkl, "FOLD", fold)
            jax.clear_caches()
            for v in fused_lab.MODES:
                for real in (False, True):
                    words, tab = _fu_inputs(real)
                    out["fused_lab", v, fold, real] = tuple(map(
                        np.asarray, jfused.run(words, tab, FU_NREAL,
                                               variant=v)))
        # h16_lab: 7 variants
        for name in ("W", "SPB"):
            mp.setattr(jh16, name, H16[name])
        mp.setattr(jh16, "BLOCK_SUB", H16["W"] * H16["SPB"])
        jax.clear_caches()
        for v, (words, tab) in _h16_inputs().items():
            out["h16_lab", v] = tuple(map(np.asarray, jh16.run(
                words, tab, variant=v, nb=H16["NB"])))
        # fold_lab: 4 variants x 3 limits
        for name in ("W", "SPB"):
            mp.setattr(jfold, name, FO[name])
        mp.setattr(jfold, "BLOCK_SUB", FO["W"] * FO["SPB"])
        jax.clear_caches()
        words, tab = _fo_inputs()
        for v in fold_lab.VARIANTS:
            for lim in FO_LIMITS:
                out["fold_lab", v, lim] = tuple(map(np.asarray, jfold.run(
                    words, tab, jnp.asarray([lim], jnp.int32), variant=v,
                    nb=FO["NB"])))
    jax.clear_caches()
    return out


def _sorted_desc(v, t):
    order = np.argsort(-v, axis=0, kind="stable")
    return np.take_along_axis(v, order, 0), np.take_along_axis(t, order, 0)


def _agree(jv, jt, pv, pt, *, rtol=0.0, fast=False):
    """Reference buffers (jv, jt; slot order) against the port's (pv, pt;
    sorted descending per lane): sorted values equal (to rtol, and as much
    absolutely for sums that cancel to near 0; NaN where NaN), (value,
    tag) pairs above each lane's smallest kept value (plus that margin)
    equal; with ``fast`` every tag equal."""
    pv, pt = (np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
              for x in (pv, pt))
    assert pv.shape == pt.shape == (_common.LANE_K, LANES)
    jv, jt = _sorted_desc(np.asarray(jv), np.asarray(jt))
    pv, pt = _sorted_desc(pv, pt)
    np.testing.assert_allclose(pv, jv, rtol=rtol, atol=rtol, equal_nan=True)
    if fast:
        np.testing.assert_array_equal(pt, jt)
        return
    for lane in range(LANES):
        floor = pv[:, lane].min()
        floor = floor + rtol * (abs(floor) + 1) if np.isfinite(floor) \
            else floor
        a = sorted(jt[jv[:, lane] > floor, lane].tolist())
        b = sorted(pt[pv[:, lane] > floor, lane].tolist())
        assert a == b, f"lane {lane}"


# ------------------------------------------------------------- the data

class _Stop(Exception):
    pass


def _captured(monkeypatch, module, n, argv=()):
    """The first ``n`` arrays the JAX lab's main() puts on the device."""
    got = []

    def put(x, *a, **k):
        got.append(np.asarray(x))
        if len(got) == n:
            raise _Stop
        return x

    monkeypatch.setattr(jax, "device_put", put)
    monkeypatch.setattr("sys.argv", ["lab", *argv])
    with pytest.raises(_Stop):
        module.main()
    return got


@pytest.mark.parametrize("lab", ["kernel_lab", "fused_lab", "h16_lab",
                                 "fold_lab"])
def test_data_matches_the_jax_labs(monkeypatch, lab):
    """The port's generators give the bits each JAX lab's main() makes
    (kernel_lab.py:310-326, fused_lab.py:130-137, h16_lab.py:281-284,
    fold_lab.py:193-196)."""
    nb = 3
    monkeypatch.setenv("LAB_NB", str(nb))
    if lab == "kernel_lab":
        got = _captured(monkeypatch, jkl, 3, ["stream"])
        want = _common.kernel_lab_data(nb, jkl.BLOCK_SUB)
    elif lab == "fused_lab":
        monkeypatch.setattr(jfused, "NB", nb)
        got = _captured(monkeypatch, jfused, 3)
        want = _common.fused_lab_data(nb, jfused.BLOCK_SUB, jfused.SPB,
                                      jfused.NSEG)
    else:
        module = jh16 if lab == "h16_lab" else jfold
        got = _captured(monkeypatch, module, 2)
        want = _common.h16_lab_data(nb, module.BLOCK_SUB)
        # and the helpers themselves, with the fields h16_lab's oracle
        # reads
        rng_j, rng_p = np.random.default_rng(9), np.random.default_rng(9)
        w = module._mk_words(rng_j, 5)
        if lab == "h16_lab":
            w, col, val = w
            np.testing.assert_array_equal(_h16_fields(w)[0], col)
            np.testing.assert_array_equal(_h16_fields(w)[1], val)
        np.testing.assert_array_equal(_common.h16_words(rng_p, 5), w)
        for x, y in zip(module._mk_table(rng_j), _common.h16_table(rng_p)):
            np.testing.assert_array_equal(x, y)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


# ------------------------------------------- against interpret-mode JAX

@pytest.mark.parametrize("real", [False, True], ids=["integer", "real"])
@pytest.mark.parametrize("fold", kernel_lab.FOLDS)
@pytest.mark.parametrize("variant", list(kernel_lab.VARIANTS))
def test_kernel_lab_matches_interpret(jax_runs, variant, fold, real):
    words, tabs = _kl_inputs(real)
    pv, pt = kernel_lab.kernel_lab_plain(
        _t(words), _t(tabs[variant]), variant=variant, fold=fold,
        W=KL["W"], SPB=KL["SPB"])
    jv, jt = jax_runs["kernel_lab", variant, fold, real]
    _agree(jv, jt, pv, pt, rtol=1e-6 if real else 0.0, fast=fold == "fast")


@pytest.mark.parametrize("real", [False, True], ids=["integer", "real"])
@pytest.mark.parametrize("fold", fused_lab.FOLDS)
@pytest.mark.parametrize("variant", fused_lab.MODES)
def test_fused_lab_matches_interpret(jax_runs, variant, fold, real):
    """Ragged real counts: v_smem masks slices past nreal[0], v_branch
    each segment's past its own."""
    words, tab = _fu_inputs(real)
    pv, pt = fused_lab.fused_lab_plain(
        _t(words), _t(tab), _t(FU_NREAL), variant=variant, fold=fold,
        W=FU["W"], SPB=FU["SPB"])
    jv, jt = jax_runs["fused_lab", variant, fold, real]
    _agree(jv, jt, pv, pt, rtol=1e-6 if real else 0.0, fast=fold == "fast")


@pytest.mark.parametrize("variant", list(h16_lab.VARIANTS))
def test_h16_lab_matches_interpret(jax_runs, variant):
    words, tab = _h16_inputs()[variant]
    pv, pt = h16_lab.h16_lab_plain(_t(words), _t(tab), variant=variant,
                                   W=H16["W"], SPB=H16["SPB"])
    jv, jt = jax_runs["h16_lab", variant]
    # stream's f32 sums of words of ~2**31 round in XLA's order
    _agree(jv, jt, pv, pt, rtol=1e-6 if variant == "stream" else 0.0,
           fast=True)


@pytest.mark.parametrize("limit", FO_LIMITS, ids=["ragged", "none", "past"])
@pytest.mark.parametrize("variant", fold_lab.VARIANTS)
def test_fold_lab_matches_interpret(jax_runs, variant, limit):
    words, tab = _fo_inputs()
    pv, pt = fold_lab.fold_lab_plain(_t(words), _t(tab), limit,
                                     variant=variant, W=FO["W"],
                                     SPB=FO["SPB"])
    jv, jt = jax_runs["fold_lab", variant, limit]
    if variant == "nofold":
        np.testing.assert_array_equal(pv.numpy(), jv)
        np.testing.assert_array_equal(pt.numpy(), jt)
    else:
        _agree(jv, jt, pv, pt, fast=True)


def test_v_prod_matches_jax():
    """fused_lab's v_prod: the port's K7 plain version (int8x4, fold_tile
    1, buffers not tie-safe) against the JAX production kernel in
    interpret mode on the lab's three-bucket plan (fused_lab.py:139-157),
    on finite real values (no ties)."""
    W, SPB, NB = 16, 4, 7
    rng = np.random.default_rng(71)
    cols = rng.integers(0, 1024, (NB * W * SPB, LANES)).astype(np.uint32)
    vals = _bf16_bits(rng.standard_normal(cols.shape))
    words = ((cols << 16) | vals).view(np.int32)
    tab = rng.integers(-2**31, 2**31 - 1, (2, LANES),
                       dtype=np.int64).astype(np.int32)
    per = NB // 3
    plan = tuple(JFusedBucket(
        width=W, slices_per_block=SPB, blocks_per_slice=1,
        slice_base=b * per * SPB, blk_start=b * per,
        num_blocks=(NB - 2 * per) if b == 2 else per) for b in range(3))
    cfg = jcfg.TopKSpMVConfig(k=100, lane_k=8, max_cols=1024,
                              query_codec="int8x4")
    jv, jt = map(np.asarray, jkernel.topk_spmv_fused_device(
        jnp.asarray(words), jnp.asarray(tab),
        jnp.full((3, 1), NB * SPB, jnp.int32), cfg=cfg, plan=plan,
        block_sublanes=W * SPB, num_blocks=NB, interpret=True,
        codec="int8x4"))
    pv, pt = fused_lab.fused_lab_plain(
        _t(words), _t(tab), _t(np.full((3, 1), NB * SPB, np.int32)),
        variant="v_prod", W=W, SPB=SPB)
    _agree(jv, jt, pv, pt, rtol=1e-6)


# ------------------------------------ NumPy oracles of the TPU's semantics

def _ftz(x):
    return np.where(np.abs(x) < FLT_MIN, x * np.float32(0), x)


def _o_val(w):
    return _ftz((w << np.uint32(16)).view(np.float32))


def _o_take(tab, row, idx):
    """The TPU's lane gather: entry idx & 127 of table row ``row``."""
    return tab[row][idx & np.uint32(127)]


def _o_signed(x):
    return x.astype(np.uint32).view(np.int32).astype(np.int64)


def _o_body(variant, w, tab):
    """kernel_lab.py:61-200 in NumPy: (words uint32, table uint32 bits)
    -> float32 per word, flushed; the select chains as the lab writes
    them, shift amounts mod 32."""
    lo = w >> np.uint32(16)
    neg = w.view(np.int32) < 0

    def f32(u):
        return _ftz(np.asarray(u, np.uint32).view(np.float32))

    def two():            # the sign-select row's entry
        return np.where(neg, _o_take(tab, 1, lo), _o_take(tab, 0, lo))

    if variant == "stream":
        return _ftz(_o_val(w) + f32(tab[0]))
    if variant == "f32":
        hi = w >> np.uint32(23)
        sel = _o_take(tab, 0, lo)
        for c in range(1, 8):
            sel = np.where(hi == c, _o_take(tab, c, lo), sel)
        return _ftz(_o_val(w) * f32(sel))
    if variant in ("int8", "int8_sign", "int8_fbits"):
        if variant == "int8":
            sel = np.where((w >> np.uint32(25)) == 1, _o_take(tab, 1, lo),
                           _o_take(tab, 0, lo))
            sh = (w >> np.uint32(20)) & np.uint32(24)
        else:
            sel, sh = two(), (w >> np.uint32(24)) & np.uint32(24)
        byte = (sel >> sh) & np.uint32(0xFF)
        if variant == "int8_fbits":
            vec = (byte | np.uint32(0x4B000000)).view(np.float32) - \
                np.float32(8388608.0 + 128.0)
        else:
            vec = (byte.astype(np.int64) - 128).astype(np.float32)
        return _ftz(_o_val(w) * vec)
    if variant == "int4":
        nib = (_o_take(tab, 0, lo) >> ((w >> np.uint32(21)) & np.uint32(28))) \
            & np.uint32(0xF)
        return _ftz(_o_val(w) * (nib.astype(np.int64) - 8).astype(np.float32))
    if variant == "take1":
        return _ftz(_o_val(w) * f32(_o_take(tab, 0, lo)))
    if variant == "take2sel":
        return _ftz(_o_val(w) * f32(two()))
    if variant in ("i8s", "i8s_nomask", "i8s_int"):
        a = (w >> np.uint32(24)) % np.uint32(32)   # i8s: & 31; TPU: mod 32
        q = (two() << a).view(np.int32).astype(np.int64) >> 24
        if variant != "i8s_int":
            return _ftz(_o_val(w) * q.astype(np.float32))
        prod = ((w & np.uint32(0xFFFF)).astype(np.int64) * q) & 0xFFFFFFFF
        return _ftz(prod.astype(np.uint32).view(np.float32))
    assert variant == "h16"
    g0 = _o_take(tab, 0, w & np.uint32(0x7F))
    g1 = _o_take(tab, 0, (w >> np.uint32(16)) & np.uint32(0x7F))
    n0 = ((g0 >> ((w >> np.uint32(5)) & np.uint32(28))) & 15).astype(
        np.int64) - 8
    n1 = ((g1 >> ((w >> np.uint32(21)) & np.uint32(28))) & 15).astype(
        np.int64) - 8
    v0 = _o_signed(w << np.uint32(16)) >> 26
    v1 = _o_signed(w) >> 26
    p = (v0 * n0 + v1 * n1) & 0xFFFFFFFF
    return _ftz(p.astype(np.uint32).view(np.float32))


def _o_float_scores(words, per_word, W):
    """Slice scores in the order the port takes (two accumulators by
    chunk parity, then the halving tree), every add flushed."""
    n, chunks = words.shape[0] // W, W // 8
    p = per_word(words.view(np.uint32).reshape(n, W, LANES)[
        :, :chunks * 8].reshape(n, chunks, 8, LANES))
    acc = [np.zeros((n, 8, LANES), np.float32) for _ in range(2)]
    for u in range(chunks):
        acc[u % 2] = _ftz(acc[u % 2] + p[:, u])
    x = _ftz(acc[0] + acc[1])
    while x.shape[1] > 1:
        x = _ftz(x[:, :x.shape[1] // 2] + x[:, x.shape[1] // 2:])
    return x[:, 0]


def _o_fold(scores, fold, spb, *, limit=None):
    """The JAX labs' folds run slice by slice (kernel_lab.py:45-56,
    :244-263; fold_lab.py:91-111 with ``limit``): (tv, tt) in slot
    order."""
    k = _common.LANE_K
    tv = np.full((k, LANES), -np.inf, np.float32)
    tt = np.zeros((k, LANES), np.int32)
    worst = np.full((1, LANES), -np.inf, np.float32)
    iota = np.arange(k).reshape(-1, 1)

    def update(score, t, fast):
        nonlocal tv, tt
        cur_min = tv.min(axis=0, keepdims=True)
        if fast:
            replace = (tv == cur_min) & (score >= cur_min)
        else:
            slot = np.where(tv == cur_min, iota, k).min(axis=0, keepdims=True)
            replace = (iota == slot) & (score >= cur_min)
        tv = np.where(replace, score, tv)
        tt = np.where(replace, t, tt)

    n = scores.shape[0]
    if fold == "top1g4":
        for g in range(0, n, 4):
            gmax, gidx = scores[g], np.full(LANES, g, np.int32)
            for t in range(g + 1, g + 4):
                take = scores[t] > gmax
                gmax = np.where(take, scores[t], gmax)
                gidx = np.where(take, t, gidx)
            update(gmax, gidx, False)
        return tv, tt
    for t in range(n):
        s = scores[t:t + 1]
        if fold in ("exact", "fast"):
            update(s, t, fold == "fast")
        elif fold == "base":
            update(np.where(t < limit, s, -np.inf), t, True)
        elif fold == "tguard":
            if t < limit:
                update(s, t, True)
        elif fold == "vguard":
            if t < limit and np.max(s - worst) >= 0:
                update(s, t, True)
                worst = tv.min(axis=0, keepdims=True)
        elif t < limit:                      # nofold
            tv[0:1] = s
    return tv, tt


OW, OSPB, ONB = 24, 8, 3     # the oracles' geometry (3 chunks, 24 slices)


DATA = ("lab", *_common.CHECK_KINDS)


@pytest.mark.parametrize("data", DATA)
@pytest.mark.parametrize("fold", kernel_lab.FOLDS)
@pytest.mark.parametrize("variant", list(kernel_lab.VARIANTS))
def test_kernel_lab_matches_tpu_oracle(variant, fold, data):
    """On the lab's own random words (kernel_lab.py:314-326: gather fields
    to 1023, sign bits, shift amounts past 31, NaN, inf and denormal
    values), and on them with integer, real and tiny values
    (``_common.with_values``: the lab's own values leave +inf or NaN on
    top of every lane)."""
    words, table, table_i = _common.kernel_lab_data(ONB, OW * OSPB, seed=3)
    if data != "lab":
        words, table_i, table = _common.with_values(data, words, table_i,
                                                    table, seed=4)
    tab = (table if variant in kernel_lab.FLOAT_TABLES else table_i)[
        :kernel_lab.VARIANTS[variant]]
    with np.errstate(all="ignore"):
        scores = _o_float_scores(words, lambda w: _o_body(
            variant, w, tab.view(np.uint32)), OW)
        ov, ot = _o_fold(scores, fold, OSPB)
    pv, pt = kernel_lab.kernel_lab_plain(_t(words), _t(tab), variant=variant,
                                         fold=fold, W=OW, SPB=OSPB)
    _agree(ov, ot, pv, pt, fast=fold == "fast")


@pytest.mark.parametrize("data", DATA)
@pytest.mark.parametrize("fold", fused_lab.FOLDS)
@pytest.mark.parametrize("variant", fused_lab.MODES)
def test_fused_lab_matches_tpu_oracle(variant, fold, data):
    """On the lab's own words (fused_lab.py:130-137) and on them with
    integer, real and tiny values; ragged counts: the masks of
    fused_lab.py:63-66 and the segments of :71-81."""
    nb = 7
    words, tab, _ = _common.fused_lab_data(nb, OW * OSPB, OSPB, 3, seed=4)
    if data != "lab":
        words, tab, _ = _common.with_values(data, words, tab, seed=5)
    nreal = np.array([[nb * OSPB - 9], [2 * OSPB - 3], [3 * OSPB - 1]],
                     np.int32)
    with np.errstate(all="ignore"):
        scores = _o_float_scores(words, lambda w: _o_body(
            "int8", w, tab.view(np.uint32)), OW)
        per = nb // 3
        for t in range(scores.shape[0]):
            i = t // OSPB
            if variant == "v_smem" and not t < nreal[0, 0]:
                scores[t] = -np.inf
            if variant == "v_branch":
                b = min(i // per, 2)
                if not t < b * per * OSPB + nreal[b, 0]:
                    scores[t] = -np.inf
        ov, ot = _o_fold(scores, fold, OSPB)
    pv, pt = fused_lab.fused_lab_plain(_t(words), _t(tab), _t(nreal),
                                       variant=variant, fold=fold, W=OW,
                                       SPB=OSPB)
    _agree(ov, ot, pv, pt, fast=fold == "fast")


def _o_h16_scores(col, val, q, W):
    """h16_lab.check's oracle (h16_lab.py:241-248): score[slice, lane] =
    sum over the slice's words of val * q[col >> 7, col & 127]."""
    contrib = np.zeros(col.shape[:2], np.int64)
    for h in range(2):
        contrib += val[..., h] * q[col[..., h] >> 7, col[..., h] & 127]
    return contrib.reshape(-1, W, LANES).sum(axis=1)


@pytest.mark.parametrize("variant", [v for v in h16_lab.VARIANTS
                                     if v != "stream"])
def test_h16_lab_matches_check_oracle(variant):
    """Every decode on the lab's random words (h16_lab.py:215-230): each
    lane keeps 8 copies of its best slice score, tagged with the last slice
    holding it. v2 takes v2-layout words (h16_lab.py:125-128: col0[0:10) |
    col1[10:20) | val0[20:26) | val1[26:32)) and the reversed-nibble table
    (group g at nibble 7 - g); the lab times it on v1 words."""
    W, SPB, nb = 16, 8, 3
    rng = np.random.default_rng(8)
    words = _common.h16_words(rng, nb * W * SPB)
    table, q = _common.h16_table(rng)
    col, val = _h16_fields(words)
    if variant == "v2":
        w = (col[..., 0] | (col[..., 1] << 10) | ((val[..., 0] & 63) << 20)
             | ((val[..., 1] & 63) << 26))
        words = w.astype(np.uint32).view(np.int32)
        rev = np.zeros(LANES, np.uint64)
        for g in range(8):
            rev |= (q[g] & 0xF).astype(np.uint64) << (4 * (7 - g))
        table = rev.astype(np.uint32).view(np.int32).reshape(1, LANES)
    scores = _o_h16_scores(col, val, q, W).astype(np.float32)
    ov, ot = _o_fold(scores, "fast", SPB)
    pv, pt = h16_lab.h16_lab_plain(_t(words), _t(table), variant=variant,
                                   W=W, SPB=SPB)
    _agree(ov, ot, pv, pt, fast=True)


@pytest.mark.parametrize("limit", [16 * 3 - 5, 0, 1, 16 * 3 + 2],
                         ids=["ragged", "none", "one", "past"])
@pytest.mark.parametrize("variant", fold_lab.VARIANTS)
def test_fold_lab_matches_tpu_oracle(variant, limit):
    """The production h16 chain (fold_lab.py:45-57, raw gathers reading
    the index's low 7 bits) on the lab's random words, each fold run
    slice by slice (vguard's vote over the 128 lanes; nofold's slot 0 the
    last real slice's score)."""
    W, SPB, nb = 16, 16, 3
    rng = np.random.default_rng(12)
    words = _common.h16_words(rng, nb * W * SPB)
    table, q = _common.h16_table(rng)
    scores = _o_h16_scores(*_h16_fields(words), q, W).astype(np.float32)
    with np.errstate(all="ignore"):
        ov, ot = _o_fold(scores, variant, SPB, limit=limit)
    pv, pt = fold_lab.fold_lab_plain(_t(words), _t(table), limit,
                                     variant=variant, W=W, SPB=SPB)
    if variant == "nofold":
        np.testing.assert_array_equal(pv.numpy(), ov)
        np.testing.assert_array_equal(pt.numpy(), ot)
    else:
        _agree(ov, ot, pv, pt, fast=True)


# ------------------------------------------------- the port's own pieces

@pytest.mark.parametrize("module,source,enum,names", [
    (kernel_lab, "lab_kernel.cu", "Variant", list(kernel_lab.VARIANTS)),
    (kernel_lab, "lab_kernel.cu", "Fold", kernel_lab.FOLDS),
    (fused_lab, "lab_fused.cu", "Mode", fused_lab.MODES),
    (fused_lab, "lab_fused.cu", "Fold", fused_lab.FOLDS),
    (h16_lab, "lab_h16.cu", "Variant", list(h16_lab.VARIANTS)),
    (fold_lab, "lab_fold.cu", "Variant", fold_lab.VARIANTS)],
    ids=["kernel_variant", "kernel_fold", "fused_mode", "fused_fold",
         "h16_variant", "fold_variant"])
def test_names_match_the_cuda_enums(module, source, enum, names):
    """Each wrapper's variant argument is its index in the module's names:
    the order of the kernel's enum."""
    with open(os.path.join(CSRC, source)) as fh:
        body = re.search(rf"enum {enum} \{{([^}}]*)\}}", fh.read()).group(1)
    got = [n.strip() for n in body.split(",")]
    assert got[-1].startswith("kNum")
    camel = ["k" + "".join(p.capitalize() for p in n.split("_"))
             for n in names]
    assert [n.lower() for n in got[:-1]] == [c.lower() for c in camel]


def test_wrappers_run_the_plain_versions_on_cpu():
    """On CPU tensors each device wrapper returns its plain version's
    buffers and launches nothing; bad inputs raise."""
    words, tabs = _kl_inputs(True)
    w, tab = _t(words), _t(tabs["int8"])
    before = kernel_lab.kernel_lab_device.launches
    for fold in kernel_lab.FOLDS:
        a = kernel_lab.kernel_lab_device(w, tab, variant="int8", fold=fold,
                                         W=KL["W"], SPB=KL["SPB"])
        b = kernel_lab.kernel_lab_plain(w, tab, variant="int8", fold=fold,
                                        W=KL["W"], SPB=KL["SPB"])
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert kernel_lab.kernel_lab_device.launches == before
    fw, ft = map(_t, _fu_inputs(False))
    for v in fused_lab.VARIANTS:
        a = fused_lab.fused_lab_device(fw, ft, _t(FU_NREAL), variant=v,
                                       W=FU["W"], SPB=FU["SPB"])
        b = fused_lab.fused_lab_plain(fw, ft, _t(FU_NREAL), variant=v,
                                      W=FU["W"], SPB=FU["SPB"])
        assert all(torch.equal(x, y) for x, y in zip(a, b)), v
    hw, ht = map(_t, _h16_inputs()["cur"])
    assert all(torch.equal(x, y) for x, y in zip(
        h16_lab.h16_lab_device(hw, ht, variant="int", W=16, SPB=4),
        h16_lab.h16_lab_plain(hw, ht, variant="int", W=16, SPB=4)))
    assert all(torch.equal(x, y) for x, y in zip(
        fold_lab.fold_lab_device(hw, ht, 5, variant="nofold", W=16, SPB=4),
        fold_lab.fold_lab_plain(hw, ht, 5, variant="nofold", W=16, SPB=4)))
    with pytest.raises(ValueError, match="words"):
        kernel_lab.kernel_lab_device(w[:-1], tab, variant="int8", W=KL["W"],
                                     SPB=KL["SPB"])
    with pytest.raises(ValueError, match="table"):
        kernel_lab.kernel_lab_device(w, tab[:1], variant="int8", W=KL["W"],
                                     SPB=KL["SPB"])
    with pytest.raises(ValueError, match="top1g4"):
        kernel_lab.kernel_lab_device(w, tab, variant="int8", fold="top1g4",
                                     W=KL["W"] * 2, SPB=2)
    with pytest.raises(ValueError, match="variant"):
        h16_lab.h16_lab_device(hw, ht, variant="v3", W=16, SPB=4)
    with pytest.raises(ValueError, match="v_prod"):
        fused_lab.fused_lab_device(fw, ft, _t(FU_NREAL), variant="v_prod",
                                   W=FU["W"], SPB=FU["SPB"], unmerged=True)


@pytest.mark.parametrize("lab", ["kernel_lab", "fused_lab", "h16_lab",
                                 "fold_lab"])
def test_unmerged_on_cpu_is_the_plain_buffer(lab):
    """``unmerged`` on a CPU tensor gives the plain version's buffers as
    one (1, 8, 128) buffer a lab kernel's CUDA block would write (the
    CUDA block count ``blocks`` means nothing there)."""
    if lab == "kernel_lab":
        words, tabs = _kl_inputs(True)
        args, kw = (_t(words), _t(tabs["int8"])), dict(
            variant="int8", fold="top1g4", W=KL["W"], SPB=KL["SPB"])
        device, plain = kernel_lab.kernel_lab_device, \
            kernel_lab.kernel_lab_plain
    elif lab == "fused_lab":
        fw, ft = map(_t, _fu_inputs(False))
        args, kw = (fw, ft, _t(FU_NREAL)), dict(variant="v_branch",
                                                 W=FU["W"], SPB=FU["SPB"])
        device, plain = fused_lab.fused_lab_device, fused_lab.fused_lab_plain
    elif lab == "h16_lab":
        args, kw = tuple(map(_t, _h16_inputs()["cur"])), dict(
            variant="nsh", W=16, SPB=4)
        device, plain = h16_lab.h16_lab_device, h16_lab.h16_lab_plain
    else:
        args, kw = (*map(_t, _h16_inputs()["cur"]), 5), dict(
            variant="nofold", W=16, SPB=4)
        device, plain = fold_lab.fold_lab_device, fold_lab.fold_lab_plain
    got = device(*args, blocks=3, unmerged=True, **kw)
    want = plain(*args, **kw)
    assert all(g.shape == (1, 8, LANES) and torch.equal(g[0], w)
               for g, w in zip(got, want))


@pytest.mark.parametrize("module", [kernel_lab, fused_lab, h16_lab, fold_lab],
                         ids=["kernel_lab", "fused_lab", "h16_lab",
                              "fold_lab"])
def test_main_runs_plain_on_cpu_and_needs_a_card(monkeypatch, capsys,
                                                 module):
    """``--device cpu`` prints one untimed report line per variant at the
    lab's NB and bytes; without it the lab needs a card."""
    monkeypatch.setenv("LAB_NB", "3")
    lines = module.main(["--device", "cpu"])
    names = list(module.VARIANTS)
    assert [ln["variant"] for ln in lines] == names
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == len(names)
    for ln in lines:
        assert ln["nb"] == 3 and ln["device"] == "cpu"
        assert ln["ms"] is None and ln["merged_ms"] is None
        assert ln["gb_per_s"] is None
        assert ln["words_bytes"] == 3 * 512 * LANES * 4
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        module.main([names[0]])
