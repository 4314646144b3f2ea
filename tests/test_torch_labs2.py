"""The port's labs L1 (batch_lab), L2 (dma_lab), L6 (i16_probe) and L8
(mxu_gather_lab) against the JAX labs of experiments/ on the CPU.

The port runs the labs' plain versions here. The JAX labs' kernels run in
interpret mode with nothing in experiments/ edited: the module fixture
swaps jax.experimental.pallas.pallas_call for its interpret form, sets
the labs' module globals (Q, W, SPB, BLOCK_SUB, INTERPRET, TOTAL_SUB,
SUB32, REPS) to a small geometry and runs every program once. batch_lab's
INTERPRET (its LAB_INTERPRET) masks the gather indices to their low 7
bits, as the TPU's lane gather reads them, so its runs take the lab's own
words. mxu_gather_lab's VPU arm gathers raw words; interpret mode fills an
index past 127, so it runs on words below 128 as the lab stands, and on
the lab's own words with the production decode's masked form
(``_h16_shared(w, True)``, patched in for the run). NumPy oracles of the
TPU's semantics take the labs' own words besides: batch_lab.check's
scores (batch_lab.py:257-290) with the folds run slice by slice, the
int16 probe's sums, and the VPU arm's gathers at index & 127.

Tolerances: integer results bit-equal (batch_lab's values and tags,
i16_probe's sums, mxu_gather_lab's VPU arm); dma_lab's float sum
bit-equal on integer-valued data and on the lab's words (NaN where NaN),
to rtol 1e-6 (atol 1e-6) on real data; the one-hot arm bit-equal (one
nonzero product an output: the sum of zeros adds nothing).
"""

import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas
from jax.experimental.pallas import tpu as pltpu

import experiments.batch_lab as jbatch
import experiments.dma_lab as jdma
import experiments.i16_probe as ji16
import experiments.mxu_gather_lab as jmxu
from spmv_topk_tpu.ops import kernel as jkernel

from spmv_topk_tpu_torch.experiments import _common
from spmv_topk_tpu_torch.experiments import (batch_lab, dma_lab, i16_probe,
                                             mxu_gather_lab)

LANES = 128
CSRC = os.path.join(os.path.dirname(_common.__file__), os.pardir, "csrc")

# interpret-mode geometries: batch_lab 3 queries (an uneven subgroup of 2),
# 9 slices a block (tiles of 5 and 4 slices); dma_lab the lab's cases cut
# by 16 and the lab's first case; i16_probe 3 blocks of 16 int32 rows;
# mxu_gather_lab 4 chunks, 3 queries
BA = dict(Q=3, W=16, SPB=9, NB=2)
DMA_SMALL = ((64, 1), (128, 2), (256, 4), (512, 8))
DMA_TOTAL = 2048
DMA_CASES = DMA_SMALL + ((1024, 1),)
DMA_DATA = ("lab", "integer", "real")
I16 = dict(NB=3, SUB32=16)
MX = dict(REPS=4, Q=3)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _batch_inputs():
    return _common.batch_lab_data(BA["NB"], BA["W"] * BA["SPB"], BA["Q"],
                                  seed=3)


def _dma_inputs(data):
    words, table = _common.dma_lab_data(DMA_TOTAL, seed=4)
    if data != "lab":
        words, table = dma_lab.check_data(data, words, seed=5)
    return words, table


def _i16_inputs():
    return _common.i16_probe_data(I16["NB"], I16["SUB32"], seed=6)


def _i16_args(variant):
    w32, w16, t32, t16 = _i16_inputs()
    words, table = (w32, t32) if "32" in variant else (w16, t16)
    salt = (np.arange(LANES) * 37 - 2000).astype(words.dtype).reshape(
        1, LANES)
    return words, table, salt


def _mxu_inputs(small):
    words, tab, tabq = _common.mxu_lab_data(MX["REPS"], MX["Q"], seed=7)
    if small:
        words = np.random.default_rng(8).integers(
            0, 128, words.shape).astype(np.int32)
    return words, tab, tabq


@pytest.fixture(scope="module")
def jax_runs():
    """Every JAX lab program of the interpret-mode tests, run once: key ->
    numpy output(s)."""
    out = {}
    orig = pallas.pallas_call
    made = []

    def interpret(*a, **k):
        k["interpret"] = True
        made.append(orig(*a, **k))
        return made[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pallas, "pallas_call", interpret)
        # batch_lab: 7 variants; run() passes interpret from LAB_INTERPRET
        mp.setenv("LAB_INTERPRET", "1")
        for name in ("Q", "W", "SPB"):
            mp.setattr(jbatch, name, BA[name])
        mp.setattr(jbatch, "BLOCK_SUB", BA["W"] * BA["SPB"])
        mp.setattr(jbatch, "INTERPRET", True)
        jax.clear_caches()
        words, tables = _batch_inputs()
        for v in batch_lab.VARIANTS:
            out["batch", v] = tuple(map(np.asarray, jbatch.run(
                words, tables, variant=v, nb=BA["NB"])))
        # dma_lab: 5 cases x 3 kinds of data
        mp.setattr(jdma, "TOTAL_SUB", DMA_TOTAL)
        jax.clear_caches()
        for data in DMA_DATA:
            words, table = _dma_inputs(data)
            for bs, t in DMA_CASES:
                out["dma", bs, t, data] = np.asarray(jdma.run(
                    words, table, bs=bs, t=t))
        # i16_probe: 5 variants, the call build() makes
        mp.setattr(ji16, "SUB32", I16["SUB32"])
        for v in i16_probe.VARIANTS:
            words, table, salt = _i16_args(v)
            ji16.build(v, jnp.asarray(words), jnp.asarray(table), I16["NB"])
            out["i16", v] = np.asarray(made[-1](salt, table, words))
        # mxu_gather_lab: the VPU arm as run() calls it (raw gathers on
        # small words; masked gathers on the lab's words), the one-hot arm
        mp.setattr(jmxu, "REPS", MX["REPS"])
        Q = MX["Q"]
        vk = pallas.pallas_call(
            lambda t, w, o: jmxu.vpu_kernel(t, w, o, Q=Q),
            in_specs=[pallas.BlockSpec(memory_space=pltpu.VMEM),
                      pallas.BlockSpec(memory_space=pltpu.VMEM)],
            out_specs=pallas.BlockSpec(memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct((Q, LANES), jnp.float32))
        words, tab, tabq = _mxu_inputs(small=True)
        out["mxu", "raw"] = np.asarray(vk(tab, words))
        words, tab, tabq = _mxu_inputs(small=False)
        out["mxu", "onehot"] = np.asarray(jmxu.mxu_xla_fn(Q)(words, tabq))
        shared = jkernel._h16_shared
        mp.setattr(jkernel, "_h16_shared", lambda w, mask: shared(w, True))
        jax.clear_caches()
        out["mxu", "masked"] = np.asarray(vk(tab, words))
    jax.clear_caches()
    return out


# ------------------------------------------------------------- the data

class _Stop(Exception):
    pass


def _recorded(monkeypatch, n, fn):
    """The first ``n`` arrays the generators of ``default_rng`` give while
    ``fn()`` runs (it stops there)."""
    got = []
    make = np.random.default_rng

    class Rec:
        def __init__(self, *a, **k):
            self.rng = make(*a, **k)

        def __getattr__(self, name):
            attr = getattr(self.rng, name)

            def draw(*a, **k):
                got.append(attr(*a, **k))
                if len(got) == n:
                    raise _Stop
                return got[-1]
            return draw

    monkeypatch.setattr(np.random, "default_rng", Rec)
    with pytest.raises(_Stop):
        fn()
    return got


@pytest.mark.parametrize("lab", ["batch_lab", "dma_lab", "i16_probe",
                                 "mxu_gather_lab"])
def test_data_matches_the_jax_labs(monkeypatch, lab):
    """The port's generators give the bits of batch_lab.py:298-301
    (``_mk_words``, ``_mk_tables``), dma_lab.py:88-92, i16_probe.py:
    119-125 and mxu_gather_lab.py:101-106."""
    if lab == "batch_lab":
        monkeypatch.setattr(jbatch, "Q", 5)
        rng = np.random.default_rng(0)
        want = (jbatch._mk_words(rng, 3 * 96)[0], jbatch._mk_tables(rng)[0])
        got = _common.batch_lab_data(3, 96, 5)
    elif lab == "dma_lab":
        monkeypatch.setattr(jdma, "TOTAL_SUB", 3000)
        put = []

        def device_put(x, *a, **k):
            put.append(np.asarray(x))
            if len(put) == 2:
                raise _Stop
            return x

        monkeypatch.setattr(jax, "device_put", device_put)
        with pytest.raises(_Stop):
            jdma.main()
        want, got = put, _common.dma_lab_data(3000)
    elif lab == "i16_probe":
        monkeypatch.setattr(ji16, "NB", 3)
        monkeypatch.setattr(ji16, "SUB32", 24)
        got = _common.i16_probe_data(3, 24)
        want = _recorded(monkeypatch, 4, ji16.main)
    else:
        monkeypatch.setattr(jmxu, "REPS", 6)
        got = _common.mxu_lab_data(6, 5)
        want = _recorded(monkeypatch, 3, lambda: jmxu.run(5))
        want = [want[0].astype(np.int32), want[1].astype(np.int32),
                want[2].astype(np.float32)]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_dma_words_redraw_a_rejected_draw(monkeypatch):
    """integers(0, 2**31 - 1) draws again when the Lemire remainder of a
    32-bit draw is below 2 (numpy's bounded integers): the generator
    skips those draws and keeps the order of the others."""
    excl = 2**31 - 1
    # draws whose remainder x * excl mod 2**32 is 0 or 1: x = 0 and the
    # inverse of excl mod 2**32
    inv = pow(excl, -1, 2**32)
    raw = np.array([5, 0, 7, inv, 9, 11, 2**32 - 1, 3], np.uint32)
    monkeypatch.setattr(_common, "_draws",
                        lambda bg, n: np.resize(raw, n).copy())
    words, _ = _common.dma_lab_data(1)
    keep = raw[[0, 2, 4, 5, 6, 7]].astype(np.uint64)
    want = np.resize((keep * np.uint64(excl)) >> np.uint64(32), LANES)
    np.testing.assert_array_equal(words[0], want.astype(np.int32))


# ------------------------------------------- against interpret-mode JAX

@pytest.mark.parametrize("variant", list(batch_lab.VARIANTS))
def test_batch_lab_matches_interpret(jax_runs, variant):
    """Values and tags equal slot for slot (the fast fold's slots are all
    the maximum, each tagged with the last slice holding it)."""
    words, tables = _batch_inputs()
    pv, pt_ = batch_lab.batch_lab_plain(_t(words), _t(tables),
                                        variant=variant, W=BA["W"],
                                        SPB=BA["SPB"])
    jv, jt_ = jax_runs["batch", variant]
    np.testing.assert_array_equal(pv.numpy(), jv)
    np.testing.assert_array_equal(pt_.numpy(), jt_)


@pytest.mark.parametrize("data", DMA_DATA)
@pytest.mark.parametrize("case", DMA_CASES,
                         ids=[dma_lab.name(*c) for c in DMA_CASES])
def test_dma_lab_matches_interpret(jax_runs, case, data):
    """blocks=1: the TPU's order of the adds."""
    words, table = _dma_inputs(data)
    bs, t = case
    got = dma_lab.dma_lab_plain(_t(words), _t(table), bs=bs, t=t).numpy()
    want = jax_runs["dma", bs, t, data]
    if data == "real":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)
    assert np.isfinite(got).all() == (data != "lab")


@pytest.mark.parametrize("variant", i16_probe.VARIANTS)
def test_i16_probe_matches_interpret(jax_runs, variant):
    words, table, salt = _i16_args(variant)
    got = i16_probe.i16_probe_plain(_t(words), _t(table), _t(salt),
                                    variant=variant, sub32=I16["SUB32"])
    want = jax_runs["i16", variant]
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("form", ["raw", "masked"])
def test_mxu_vpu_matches_interpret(jax_runs, form):
    """raw: words below 128 (every product 0: what interpret mode can
    check of raw gathers); masked: the lab's own words."""
    words, tab, _ = _mxu_inputs(small=form == "raw")
    got = mxu_gather_lab.mxu_vpu_plain(_t(words), _t(tab))
    np.testing.assert_array_equal(got.numpy(), jax_runs["mxu", form])
    if form == "masked":
        assert (got != 0).all()


def test_mxu_onehot_matches_xla(jax_runs):
    words, _, tabq = _mxu_inputs(small=False)
    got = mxu_gather_lab.mxu_onehot(_t(words), _t(tabq))
    assert got.shape == (MX["REPS"] * 8 * LANES, MX["Q"])
    np.testing.assert_array_equal(got.numpy(), jax_runs["mxu", "onehot"])


# ------------------------------------ NumPy oracles of the TPU's semantics

def _o_fields(words):
    w = words.view(np.uint32)
    half = np.stack([w & 0xFFFF, w >> 16], axis=-1).astype(np.int64)
    return half & 0x3FF, ((half >> 10) ^ 32) - 32


def _o_query_nibbles(tables):
    t = tables.view(np.uint32).astype(np.int64)
    return np.stack([((t >> (4 * g)) & 0xF ^ 8) - 8 for g in range(8)], 1)


def _o_batch_scores(words, tables, W):
    """batch_lab.check's scores (batch_lab.py:264-270): (Q, n, 128)."""
    col, val = _o_fields(words)
    qv = _o_query_nibbles(tables)                        # (Q, 8, 128)
    contrib = np.zeros((len(tables),) + words.shape, np.int64)
    for h in range(2):
        for q in range(len(tables)):
            contrib[q] += val[..., h] * qv[q, col[..., h] >> 7,
                                           col[..., h] & 127]
    return contrib.reshape(len(tables), -1, W, LANES).sum(axis=2)


def _o_fast(tv, tt, score, t):
    """kernel's _fold on (8, 128) buffers: every minimum slot replaced."""
    cur_min = tv.min(axis=0, keepdims=True)
    rep = (tv == cur_min) & (score >= cur_min)
    return np.where(rep, score, tv), np.where(rep, t, tt)


def _o_batch(words, tables, variant, W, SPB):
    """The lab's kernel run slice by slice in NumPy (batch_lab.py:93-196)."""
    sc = _o_batch_scores(words, tables, W).astype(np.float32)
    Q, n = sc.shape[:2]
    tv = np.full((Q, 8, LANES), -np.inf, np.float32)
    tt = np.zeros((Q, 8, LANES), np.int64)
    if variant == "nofold":
        tv[0] = sc.astype(np.int64).sum(0).max(0).astype(np.float32)
        return tv, tt
    for q in range(Q):
        if variant != "tilefold":
            for t in range(n):
                tv[q], tt[q] = _o_fast(tv[q], tt[q], sc[q, t], t)
            continue
        G = -(-SPB // 8)
        for i in range(n // SPB):
            for gi in range(G):
                js = [gi + m * G for m in range(8) if gi + m * G < SPB]
                tb = sc[q, [i * SPB + j for j in js]]
                s1 = np.argmax(tb == tb.max(0, keepdims=True), axis=0)
                m1 = tb.max(0)
                tv[q], tt[q] = _o_fast(tv[q], tt[q], m1,
                                       i * SPB + gi + s1 * G)
                if len(js) > 1:
                    tb2 = tb.copy()
                    tb2[s1, np.arange(LANES)] = -np.inf
                    s2 = np.argmax(tb2 == tb2.max(0, keepdims=True), axis=0)
                    tv[q], tt[q] = _o_fast(tv[q], tt[q], tb2.max(0),
                                           i * SPB + gi + s2 * G)
    return tv, tt


@pytest.mark.parametrize("variant", list(batch_lab.VARIANTS))
def test_batch_lab_matches_check_oracle(variant):
    """On the lab's random words at W 24 (3 chunks), 12 slices a block
    (tiles of 6), 4 queries: every value and tag."""
    W, SPB, nb, Q = 24, 12, 3, 4
    words, tables = _common.batch_lab_data(nb, W * SPB, Q, seed=9)
    ov, ot = _o_batch(words, tables, variant, W, SPB)
    pv, pt_ = batch_lab.batch_lab_plain(_t(words), _t(tables),
                                        variant=variant, W=W, SPB=SPB)
    np.testing.assert_array_equal(pv.numpy(), ov)
    np.testing.assert_array_equal(pt_.numpy(), ot)


@pytest.mark.parametrize("variant", i16_probe.VARIANTS)
def test_i16_probe_matches_oracle(variant):
    """The lab's words at 5 blocks of 40 int32 rows: salt plus every
    tile's terms, wrapped to the words' type."""
    w32, w16, t32, t16 = _common.i16_probe_data(5, 40, seed=10)
    words, table = (w32, t32) if "32" in variant else (w16, t16)
    S = 8 if "32" in variant else 16
    bits = 32 if S == 8 else 16
    u = words.astype(np.int64) & ((1 << bits) - 1)
    tiles = u.reshape(-1, S, LANES)
    if variant.startswith("g"):
        terms = np.take_along_axis(table.astype(np.int64)[None].repeat(
            len(tiles), 0), tiles & 127, axis=2)
    else:
        terms = (tiles >> 3) & 127
    salt = np.full((1, LANES), -7, words.dtype)
    want = (terms.sum(0) + salt.astype(np.int64)) % (1 << bits)
    want = np.where(want >= 1 << (bits - 1), want - (1 << bits), want)
    got = i16_probe.i16_probe_plain(_t(words), _t(table), _t(salt),
                                    variant=variant, sub32=40)
    np.testing.assert_array_equal(got.numpy(), want.astype(words.dtype))


def test_mxu_vpu_matches_oracle():
    """The lab's own words (16 chunks, 5 queries, full-range int32
    tables): raw gathers read index & 127, nibbles moved to the top by
    the complemented shift, int32 sums wrapping, converted once."""
    words, tab, _ = _common.mxu_lab_data(16, 5, seed=11)
    w = words.view(np.uint32).astype(np.int64)
    t = tab.view(np.uint32).astype(np.int64)
    acc = np.zeros((len(tab), LANES), np.int64)
    nw = ~w & 0xFFFFFFFF
    v0 = ((w << 16) & 0xFFFFFFFF).astype(np.uint32).view(np.int32).astype(
        np.int64) >> 26
    v1 = w.astype(np.uint32).view(np.int32).astype(np.int64) >> 26
    for q in range(len(tab)):
        n = []
        for idx, sh in ((w & 127, (nw >> 5) & 28),
                        ((w >> 16) & 127, (nw >> 21) & 28)):
            g = (t[q][idx] << sh) & 0xFFFFFFFF
            n.append(g.astype(np.uint32).view(np.int32).astype(np.int64)
                     >> 28)
        acc[q] = (v0 * n[0] + v1 * n[1]).sum(0)
    acc = acc % 2**32
    want = np.where(acc >= 2**31, acc - 2**32, acc).astype(np.float32)
    got = mxu_gather_lab.mxu_vpu_plain(_t(words), _t(tab))
    np.testing.assert_array_equal(got.numpy(), want)


def test_dma_plain_orders_its_blocks_as_the_kernel():
    """``blocks=n``: CUDA block b sums lab blocks b, b + n, ... (each
    sub-step (sum + acc0) + acc1 from 0), then the partials add in block
    order; on real values three blocks differ from the TPU's order (one
    block) only by rounding: another order of the 256 rounded adds that
    make each element, terms below ~4 (atol 1e-4, rtol 1e-5)."""
    words, table = _common.dma_lab_data(1024, seed=12)
    words, table = dma_lab.check_data("real", words, seed=13)
    w, tb = _t(words), _t(table)
    bs, t, n = 128, 2, 3
    steps = dma_lab.step_sums(w, tb, bs, t).numpy()      # (nb * t, 2, 8, L)
    nb = 1024 // bs
    part = np.zeros((n, 8, LANES), np.float32)
    for i in range(nb):
        for j in range(t):
            a = steps[i * t + j]
            part[i % n] = (part[i % n] + a[0]) + a[1]
    want = part[0]
    for b in range(1, n):
        want = want + part[b]
    got = dma_lab.dma_lab_plain(w, tb, bs=bs, t=t, blocks=n).numpy()
    np.testing.assert_array_equal(got, want)
    one = dma_lab.dma_lab_plain(w, tb, bs=bs, t=t).numpy()
    np.testing.assert_allclose(got, one, rtol=1e-5, atol=1e-4)
    assert not np.array_equal(got, one)


# ------------------------------------------------- the port's own pieces

@pytest.mark.parametrize("source,names", [
    ("lab_batch.cu", list(batch_lab.VARIANTS)),
    ("lab_i16.cu", list(i16_probe.VARIANTS))], ids=["batch", "i16"])
def test_names_match_the_cuda_enums(source, names):
    with open(os.path.join(CSRC, source)) as fh:
        body = re.search(r"enum Variant \{([^}]*)\}", fh.read()).group(1)
    got = [n.strip() for n in body.split(",")]
    assert got[-1].startswith("kNum")
    assert [n.lower() for n in got[:-1]] == ["k" + n for n in names]


def test_fast_merge_keeps_the_last_slice_holding_the_maximum():
    """``merge_fast`` of per-CUDA-block fast-fold buffers equals the
    sequential fold over all the slices (``fast_fold_seq``), ties and
    blocks without a slice included."""
    rng = np.random.default_rng(14)
    scores = _t(rng.integers(-3, 3, (40, LANES)).astype(np.float32))
    tags = torch.arange(40, dtype=torch.int32).view(-1, 1).expand(40, LANES)
    v, t = _common.fast_fold_seq(scores, tags)
    nblk, spb = 7, 4                    # 10 lab blocks of 4 slices
    bufs = [_common.fast_fold_seq(
        torch.cat([scores[i * spb:(i + 1) * spb]
                   for i in range(b, 10, nblk)]),
        torch.cat([tags[i * spb:(i + 1) * spb] for i in range(b, 10, nblk)]))
        for b in range(nblk)]
    mv, mt = _common.merge_fast(torch.stack([x for x, _ in bufs]),
                                torch.stack([y for _, y in bufs]))
    assert torch.equal(mv, v) and torch.equal(mt, t)
    assert (t > 0).all()


def test_wrappers_run_the_plain_versions_on_cpu():
    """On CPU tensors each device wrapper returns its plain version and
    launches nothing; bad inputs raise."""
    words, tables = map(_t, _batch_inputs())
    counters = (batch_lab.batch_lab_device, dma_lab.dma_lab_device,
                i16_probe.i16_probe_device, mxu_gather_lab.mxu_vpu_device)
    before = [c.launches for c in counters]
    kw = dict(variant="tilefold", W=BA["W"], SPB=BA["SPB"])
    assert all(torch.equal(a, b) for a, b in zip(
        batch_lab.batch_lab_device(words, tables, **kw),
        batch_lab.batch_lab_plain(words, tables, **kw)))
    dw, dt = map(_t, _dma_inputs("integer"))
    assert torch.equal(dma_lab.dma_lab_device(dw, dt, bs=256, t=4),
                       dma_lab.dma_lab_plain(dw, dt, bs=256, t=4))
    iw, itb, isalt = map(_t, _i16_args("g16"))
    assert torch.equal(
        i16_probe.i16_probe_device(iw, itb, isalt, variant="g16", sub32=16),
        i16_probe.i16_probe_plain(iw, itb, isalt, variant="g16", sub32=16))
    mw, mt, _ = map(_t, _mxu_inputs(small=False))
    assert torch.equal(mxu_gather_lab.mxu_vpu_device(mw, mt),
                       mxu_gather_lab.mxu_vpu_plain(mw, mt))
    assert [c.launches for c in counters] == before
    with pytest.raises(ValueError, match="variant"):
        batch_lab.batch_lab_device(words, tables, variant="sub3", W=16, SPB=9)
    with pytest.raises(ValueError, match="tables"):
        batch_lab.batch_lab_device(words, tables[:, :64].contiguous(),
                                   variant="cur", W=16, SPB=9)
    with pytest.raises(ValueError, match="BS"):
        dma_lab.dma_lab_device(dw, dt, bs=100, t=1)
    with pytest.raises(ValueError, match="table"):
        dma_lab.dma_lab_device(dw, dt.double(), bs=256, t=4)
    with pytest.raises(ValueError, match="words"):
        i16_probe.i16_probe_device(iw, itb, isalt, variant="s32", sub32=16)
    with pytest.raises(ValueError, match="table"):
        i16_probe.i16_probe_device(iw, itb[:8], isalt, variant="g16",
                                   sub32=16)
    with pytest.raises(ValueError, match="words"):
        mxu_gather_lab.mxu_vpu_device(mw[:-1], mt)


def _mxu_emulated(words, tables, blocks, phases=4):
    """csrc/lab_mxu.cu's order in NumPy: block b's rows (``block_rows``),
    phase p summing rows p, p + 4, ... of them, the phases added in the
    block, each block's (Q, 128) sums added into a 64-bit counter (2^48 +
    the sum's uint32 bits), whose bits 0-31 are converted to float once
    the count reaches the blocks."""
    w = words.numpy()
    acc = np.zeros((tables.shape[0], LANES), np.uint64)
    for b in range(blocks):
        rows = mxu_gather_lab.block_rows(w.shape[0], blocks, b)
        block = np.zeros(acc.shape, np.uint32)
        for p in range(phases):
            mine = list(rows)[p::phases]
            if mine:
                part = mxu_gather_lab.mxu_vpu_sums(
                    words[mine], tables).numpy().astype(np.uint64)
                block += (part & 0xFFFFFFFF).astype(np.uint32)
        acc += np.uint64(1 << 48) | block.astype(np.uint64)
    assert ((acc >> np.uint64(48)) == blocks).all()
    assert ((acc >> np.uint64(32)) & np.uint64(0xFFFF) < blocks).all()
    low = (acc & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return torch.from_numpy(low.view(np.int32).astype(np.float32))


@pytest.mark.parametrize("lab", ["batch_lab", "dma_lab", "i16_probe"])
def test_unmerged_on_cpu_is_one_block(lab):
    """``unmerged`` on a CPU tensor: the plain result as the one CUDA
    block's buffer (batch_lab: the slots' pair; the others their sums
    before the merge, i16_probe without the salt)."""
    if lab == "batch_lab":
        words, tables = map(_t, _batch_inputs())
        kw = dict(variant="sub2", W=BA["W"], SPB=BA["SPB"])
        uv, ut = batch_lab.batch_lab_device(words, tables, unmerged=True,
                                            **kw)
        pv, pt_ = batch_lab.batch_lab_plain(words, tables, **kw)
        assert uv.shape == (1, BA["Q"], 1, LANES)
        assert torch.equal(uv[0, :, 0], pv[:, 0])
        assert torch.equal(ut[0, :, 0], pt_[:, 0])
    elif lab == "dma_lab":
        w, tb = map(_t, _dma_inputs("integer"))
        part = dma_lab.dma_lab_device(w, tb, bs=128, t=2, blocks=3,
                                      unmerged=True)
        assert part.shape == (3, 8, LANES)
        assert torch.equal(dma_lab.reduce_plain(part), dma_lab.dma_lab_plain(
            w, tb, bs=128, t=2, blocks=3))
    else:
        w, tb, salt = map(_t, _i16_args("s16"))
        part = i16_probe.i16_probe_device(w, tb, salt, variant="s16",
                                          sub32=16, unmerged=True)
        assert part.shape == (1, 16, LANES) and part.dtype == torch.int16
        assert torch.equal(_common.wrap_int(part[0].long() + salt.long(),
                                            torch.int16),
                           i16_probe.i16_probe_plain(w, tb, salt,
                                                     variant="s16",
                                                     sub32=16))


@pytest.mark.parametrize("lab", ["batch_lab", "dma_lab", "i16_probe",
                                 "mxu_gather_lab"])
def test_main_runs_plain_on_cpu_and_needs_a_card(monkeypatch, capsys, lab):
    """``--device cpu`` prints one untimed report line per variant (case,
    arm); without it the lab needs a card."""
    module = {"batch_lab": batch_lab, "dma_lab": dma_lab,
              "i16_probe": i16_probe, "mxu_gather_lab": mxu_gather_lab}[lab]
    monkeypatch.setenv("LAB_NB", "2")
    monkeypatch.setenv("LAB_Q", "4")
    monkeypatch.setenv("LAB_SUB", "8192")
    monkeypatch.setenv("LAB_SUB32", "16")
    monkeypatch.setenv("LAB_REPS", "4")
    argv = ["--device", "cpu"] + (["256", "2", "8192", "8"]
                                  if lab == "dma_lab" else [])
    lines = module.main(argv)
    names = {"batch_lab": list(batch_lab.VARIANTS),
             "dma_lab": ["256x2", "8192x8"],
             "i16_probe": list(i16_probe.VARIANTS),
             "mxu_gather_lab": list(mxu_gather_lab.ARMS)}[lab]
    assert [ln["variant"] for ln in lines] == names
    assert len(capsys.readouterr().out.strip().splitlines()) == len(names)
    for ln in lines:
        assert ln["device"] == "cpu" and ln["ms"] is None
        assert ln["max_kept"] is not None or lab == "dma_lab"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        module.main([])


def test_sass_report_counts_opcodes(tmp_path, monkeypatch):
    """Opcodes (modifiers kept, predicates dropped) of each kernel of a
    unit's kept object, as ``cuobjdump -sass`` lists them, its names
    through cu++filt (stand-ins print lines as the 12.9 toolkit does)."""
    import json
    import sys

    from spmv_topk_tpu_torch.ops import _build

    names = {"_Z15lab_i16_sweepIsLb1ELb0EEvPKT_S2_iiPS0_":
             "void lab_i16_sweep<short, (bool)1, (bool)0>(const T1 *, "
             "const T1 *, int, int, T1 *)",
             "_Z15lab_i16_sweepIiLb0ELb0EEvPKT_S2_iiPS0_":
             "void lab_i16_sweep<int, (bool)0, (bool)0>(const T1 *, "
             "const T1 *, int, int, T1 *)"}
    m = list(names)
    dump = (
        "\n\tcode for sm_90a\n"
        f"\t\tFunction : {m[0]}\n"
        "\t.headerflags\t@\"EF_CUDA_TEXMODE_UNIFIED\"\n"
        "        /*0000*/                   LDC R1, c[0x0][0x28] ;"
        "                  /* 0x00000a00ff017b82 */\n"
        "                                                                "
        "           /* 0x000fe40000000800 */\n"
        "        /*0010*/                   PRMT R4, R2, 0x9910, RZ ;\n"
        "        /*0020*/              @!P0 BRA `(.L_x_1) ;\n"
        "        /*0030*/                   PRMT R5, R3, 0x9910, RZ ;\n"
        f"\t\tFunction : {m[1]}\n"
        "        /*0000*/                   IMAD.SHL.U32 R0, R0, 0x4, RZ ;\n"
        "        /*0010*/               @P1 EXIT ;\n")
    obj = str(tmp_path / "lib.so.lab_i16.cu.o")
    (tmp_path / "cuobjdump").write_text(
        f"#!{sys.executable}\nimport sys\n"
        f"assert sys.argv[1:] == ['-sass', {obj!r}]\n"
        f"print({dump!r})\n")
    (tmp_path / "cu++filt").write_text(
        f"#!{sys.executable}\nimport json, sys\n"
        f"names = json.loads({json.dumps(json.dumps(names))})\n"
        "print('\\n'.join(names[a] for a in sys.argv[1:]))\n")
    for tool in ("cuobjdump", "cu++filt"):
        (tmp_path / tool).chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(tmp_path / "nvcc"))
    monkeypatch.setattr(_build, "lib", lambda: None)
    monkeypatch.setattr(_build, "library_path",
                        lambda: str(tmp_path / "lib.so"))
    assert _build.sass_report("lab_i16.cu", "lab_i16_sweep") == {
        "lab_i16_sweep<short,1,0>": {"total": 4, "LDC": 1, "PRMT": 2,
                                     "BRA": 1},
        "lab_i16_sweep<int,0,0>": {"total": 2, "IMAD.SHL.U32": 1,
                                   "EXIT": 1}}
    assert _build.sass_report("lab_i16.cu", "lab_batch") == {}


def test_mxu_grid_is_one_wave_of_enough_rows(monkeypatch):
    """``mxu_blocks``: one wave (MXU_BLOCKS_PER_SM an SM) of at least
    MXU_MIN_ROWS rows a block, the SM count read once per device; a given
    ``blocks`` kept up to the wave."""
    from spmv_topk_tpu_torch.ops import kernel as pk

    calls = []

    def info(dev):
        calls.append(dev)
        return (132, 232448)

    monkeypatch.setattr(pk, "_device_info", info)
    dev = torch.device("cpu")
    wave = 132 * mxu_gather_lab.MXU_BLOCKS_PER_SM
    got = {n: mxu_gather_lab.mxu_blocks(dev, n) for n in (1, 32, 512, 65536)}
    assert got == {1: 8 // mxu_gather_lab.MXU_MIN_ROWS,
                   32: min(wave, 32 * 8 // mxu_gather_lab.MXU_MIN_ROWS),
                   512: wave, 65536: wave}
    assert mxu_gather_lab.mxu_blocks(dev, 512, 3) == 3
    assert mxu_gather_lab.mxu_blocks(dev, 512, 10 ** 6) == wave
    assert mxu_gather_lab.mxu_blocks(dev, 512, 0) == 1
    assert len(calls) == 7


@pytest.mark.parametrize("rows,blocks", [(256, 64), (4096, 264), (100, 7),
                                         (8, 264), (524288, 264)])
def test_mxu_block_rows_cover_once(rows, blocks):
    """Each row in exactly one block, two blocks' rows differing by one at
    most (``block_rows``, the kernel's split)."""
    spans = [mxu_gather_lab.block_rows(rows, blocks, b)
             for b in range(blocks)]
    assert [r for s in spans for r in s] == list(range(rows))
    sizes = [len(s) for s in spans]
    assert max(sizes) - min(sizes) <= 1


def test_mxu_workspace_once_per_device_stream_and_q():
    """The accumulator: (Q, 128) 64-bit zeros (the kernel's counters),
    made once per (device, stream, Q) and handed out again."""
    dev = torch.device("cpu")
    mxu_gather_lab._WORKSPACE.clear()
    a = mxu_gather_lab._workspace(dev, 0, 16)
    assert a.shape == (16, LANES) and a.dtype == torch.int64
    assert not a.any()
    assert mxu_gather_lab._workspace(dev, 0, 16) is a
    assert mxu_gather_lab._workspace(dev, 0, 4).shape == (4, LANES)
    assert mxu_gather_lab._workspace(dev, 7, 16) is not a
    mxu_gather_lab._WORKSPACE.clear()


@pytest.mark.parametrize("chunks,Q", [(32, 16), (9, 4), (64, 4),
                                     (None, None)])
def test_mxu_emulated_grid_matches_plain(chunks, Q):
    """The kernel's order (``_mxu_emulated``: its blocks' sums added in
    int32 through the accumulator) on grids that do not divide the rows,
    wrapping int32 sums included, equals ``mxu_vpu_plain``; None: the
    lab's inputs of the interpret-mode tests (``_mxu_inputs``) on 1, 3 and
    one block a row."""
    if chunks is None:
        words, tab, _ = map(_t, _mxu_inputs(small=False))
        grids = (1, 3, words.shape[0])
    else:
        words, tab, _ = map(_t, _common.mxu_lab_data(chunks, Q, seed=21))
        grids = (1, 5, chunks * 2, chunks * 8)
    want = mxu_gather_lab.mxu_vpu_plain(words, tab)
    for blocks in grids:
        assert torch.equal(_mxu_emulated(words, tab, blocks), want)
