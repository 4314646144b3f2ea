"""The port's per-bucket ops (kernels K11, K12, K13 over the buckets of
pack_sell_buckets) against the JAX package on the CPU.

The port runs the plain versions of its kernels here; the JAX package runs
its Pallas kernels (spmv_bucket_scores_device, topk_spmv_bucket_device,
topk_spmv_bucket_batch_device) in interpret mode, every program once, in
the module fixture, on two buckets of each pack: the widest (one slice
per block) and the narrowest whose last block holds padding slices.
Tolerances:
  - h16: int32 sums converted to f32 once per slice, so scores and
    per-lane values are bit-equal, and (value, slice) pairs equal above
    each lane's smallest kept value (tie-safe buffers: the replacement
    order decides which tag a tied last slot keeps);
  - every codec on integer-valued data (small integers, exact in bf16,
    every product and partial sum an exact f32): bit-equal;
  - f32 on real values: XLA on the CPU contracts some multiply-adds of the
    interpret-mode reference into FMAs (one rounding where the port
    rounds twice), so values agree to rtol 1e-6, with atol 1e-6 for sums
    that cancel to near 0, and index sets above the smallest kept value
    less that margin;
  - int8x4, i8s, i4s on real values: each product is exact in f32 and the
    port adds in the JAX kernels' order as XLA mostly runs it (two
    chunk-parity accumulators, or one for K12, then a halving tree over
    the 8 rows of a chunk), but XLA fuses some programs into another
    order (one summed a slice's 16 products in sequence), so these too
    are held to rtol 1e-6 (a few ulps of sums up to ~600).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import spmv_topk_tpu.config as jcfg
from spmv_topk_tpu.formats import CooMatrix as JCoo
from spmv_topk_tpu.formats import create_sparse_matrix as jax_matrix
from spmv_topk_tpu.formats.sell_buckets import pack_sell_buckets as jpack
from spmv_topk_tpu.ops import kernel as jkernel
from spmv_topk_tpu.ops import xla_ref as jxla

import spmv_topk_tpu_torch as pt
from spmv_topk_tpu_torch.formats import (CooMatrix, create_query_batch,
                                         create_sparse_matrix)
from spmv_topk_tpu_torch.formats.sell_buckets import pack_sell_buckets
from spmv_topk_tpu_torch.ops import gold, xla_ref
from spmv_topk_tpu_torch.ops import kernel as pkernel
from spmv_topk_tpu_torch.ops.fixedpoint import quantize_bf16
from spmv_topk_tpu_torch.ops.quantized_query import (pack_query_table,
                                                     pack_query_tables)
from spmv_topk_tpu_torch.topk import merge_candidates_host

ROWS, COLS = 1500, 256
# explicit on both packages' configs (tests/conftest.py shrinks only the
# JAX defaults)
GEOM = dict(block_sublanes=64, fused_block_sublanes=128)
# case -> (codec, integer-valued data)
CASES = {c: (c, False) for c in ("h16", "f32", "int8x4", "i8s", "i4s")}
CASES.update({f"{c}_integer": (c, True)
              for c in ("f32", "int8x4", "i8s", "i4s")})
LANE_K = 8


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _integer_valued(coo, cls):
    vals = np.random.default_rng(7).integers(-8, 9, coo.nnz).astype(
        np.float32)
    return cls(coo.rows, coo.cols, vals, coo.num_rows, coo.num_cols)


def _queries(n, integer, seed):
    if integer:
        return np.random.default_rng(seed).integers(
            -8, 9, (n, COLS)).astype(np.float32)
    return create_query_batch(n, COLS, seed=seed)


def _config(cls, codec, **kw):
    return cls.TopKSpMVConfig(**dict(dict(k=100, max_cols=COLS,
                                          query_codec=codec, **GEOM), **kw))


def _packs(codec, integer, rows=ROWS, deg=20, **kw):
    """(JAX config, JAX pack, port config, port pack) of the corpus; the
    two packs' words are bit-identical."""
    jcoo = jax_matrix(rows, COLS, deg, "gamma", seed=5)
    coo = create_sparse_matrix(rows, COLS, deg, "gamma", seed=5)
    if integer:
        jcoo, coo = _integer_valued(jcoo, JCoo), _integer_valued(coo,
                                                                  CooMatrix)
    jc, pc = _config(jcfg, codec, **kw), _config(pt, codec, **kw)
    jm, pm = jpack(jcoo, jc), pack_sell_buckets(coo, pc)
    assert len(jm.buckets) == len(pm.buckets)
    for a, b in zip(jm.buckets, pm.buckets):
        np.testing.assert_array_equal(a.words, b.words)
    return jc, jm, pc, pm


def _geometry(b):
    return dict(width=b.width, slices_per_block=b.block_sublanes // b.width,
                num_blocks=b.num_blocks)


def _selected(buckets):
    """Indices of the widest bucket and of the narrowest whose last block
    holds padding slices."""
    padded = [i for i, b in enumerate(buckets)
              if b.num_slices < b.num_blocks * (b.block_sublanes // b.width)]
    wide = max(range(len(buckets)), key=lambda i: buckets[i].width)
    return [wide, min(padded, key=lambda i: buckets[i].width)]


def _jax_k11(b, table, cfg, codec):
    return np.asarray(jkernel.spmv_bucket_scores_device(
        jnp.asarray(b.words), jnp.asarray(table), cfg=cfg, interpret=True,
        codec=codec, **_geometry(b)))


def _jax_k13(b, table, cfg, codec):
    return tuple(map(np.asarray, jkernel.topk_spmv_bucket_device(
        jnp.asarray(b.words), jnp.asarray(table),
        jnp.asarray([[b.num_slices]], jnp.int32), cfg=cfg,
        num_groups=table.shape[0], slice_base=b.slice_base, interpret=True,
        codec=codec, **_geometry(b))))


def _jax_k12(b, tables, cfg, codec):
    return tuple(map(np.asarray, jkernel.topk_spmv_bucket_batch_device(
        jnp.asarray(b.words), jnp.asarray(tables),
        jnp.asarray([[b.num_slices]], jnp.int32), cfg=cfg,
        slice_base=b.slice_base, interpret=True, codec=codec,
        **_geometry(b))))


@pytest.fixture(scope="module")
def ref():
    """Every interpret-mode program of the module, run once."""
    out = {}
    for name, (codec, integer) in CASES.items():
        jc, jm, pc, pm = _packs(codec, integer, tie_safe_topk=True,
                                batch_subgroup=2)
        qs = _queries(4, integer, 3)
        table, _ = pack_query_table(qs[0], codec)
        tables, _ = pack_query_tables(qs[1:], codec)
        sel = _selected(pm.buckets)
        out[name] = dict(
            pc=pc, pm=pm, q=qs[0], table=table, tables=tables, sel=sel,
            k11={i: _jax_k11(jm.buckets[i], table, jc, codec) for i in sel},
            k13={i: _jax_k13(jm.buckets[i], table, jc, codec) for i in sel},
            k12=(sel[1], _jax_k12(jm.buckets[sel[1]], tables, jc, codec)))
    # production buffers (not tie-safe) on tie-free data
    jc, jm, pc, pm = _packs("f32", False, tie_safe_topk=False,
                            batch_subgroup=2)
    qs = _queries(4, False, 4)
    table, _ = pack_query_table(qs[0], "f32")
    tables, _ = pack_query_tables(qs[1:], "f32")
    sel = _selected(pm.buckets)
    out["production"] = dict(
        pc=pc, pm=pm, table=table, tables=tables, sel=sel,
        k13={i: _jax_k13(jm.buckets[i], table, jc, "f32") for i in sel},
        k12=(sel[1], _jax_k12(jm.buckets[sel[1]], tables, jc, "f32")))
    # width_quantum 2: buckets of width 10, 6, 4, 2 (not multiples of 8)
    jc, jm, pc, pm = _packs("f32", False, rows=2000, deg=6, width_quantum=2)
    q = _queries(1, False, 5)[0]
    table, _ = pack_query_table(q, "f32")
    short = [i for i, b in enumerate(pm.buckets) if b.width % 8]
    out["quantum2"] = dict(
        pc=pc, pm=pm, jm=jm, q=q, table=table,
        k11={i: _jax_k11(jm.buckets[i], table, jc, "f32") for i in short})
    return out


def _exact(name):
    """Whether a case's sums are bit-equal to the JAX package's."""
    return name == "h16" or name.endswith("_integer")


def _assert_scores(js, ps, exact):
    if exact:
        np.testing.assert_array_equal(js, ps)
    else:
        np.testing.assert_allclose(ps, js, rtol=1e-6, atol=1e-6)


def _assert_lanes(jv, jt, pv, pt_, exact):
    """Per-lane buffers of the JAX kernel (buffer order) against the
    port's (sorted): sorted values equal (or close), and each lane's tags
    above its smallest kept value (less the tolerance) equal as sets, or
    as (value, tag) pairs when exact."""
    sv = -np.sort(-jv, axis=0)
    if exact:
        np.testing.assert_array_equal(sv, pv)
    else:
        np.testing.assert_allclose(pv, sv, rtol=1e-6, atol=1e-6)
    for lane in range(jv.shape[1]):
        floor = pv[:, lane].min()
        if not exact and np.isfinite(floor):
            floor += 1e-6 + 1e-6 * abs(floor)
        a = [(v, t) for v, t in zip(jv[:, lane], jt[:, lane]) if v > floor]
        b = [(v, t) for v, t in zip(pv[:, lane], pt_[:, lane]) if v > floor]
        if exact:
            assert sorted(a) == sorted(b), f"lane {lane}"
        else:
            assert sorted(t for _, t in a) == sorted(t for _, t in b), \
                f"lane {lane}"


def _plain_kw(pc, b, codec):
    return dict(_geometry(b), lane_k=pc.lane_k,
                tie_safe=bool(pc.tie_safe_topk), slice_base=b.slice_base,
                codec=codec)


def _nreal(b):
    return torch.tensor([[b.num_slices]], dtype=torch.int32)


@pytest.mark.parametrize("name", list(CASES))
def test_bucket_scores_plain_matches_pallas(ref, name):
    """K11 on the widest and on a padded narrow bucket."""
    r = ref[name]
    codec = CASES[name][0]
    for i in r["sel"]:
        b = r["pm"].buckets[i]
        ps = pkernel.bucket_scores_plain(_t(b.words), _t(r["table"]),
                                         codec=codec, **_geometry(b))
        assert ps.dtype == torch.float32 and ps.shape == r["k11"][i].shape
        _assert_scores(r["k11"][i], ps.numpy(), _exact(name))


@pytest.mark.parametrize("name", list(CASES))
def test_bucket_topk_plain_matches_pallas(ref, name):
    """K13, tie-safe, on the widest and on a padded narrow bucket."""
    r = ref[name]
    codec = CASES[name][0]
    for i in r["sel"]:
        b = r["pm"].buckets[i]
        pv, pt_ = pkernel.bucket_topk_plain(
            _t(b.words), _t(r["table"]), _nreal(b),
            **_plain_kw(r["pc"], b, codec))
        assert pv.shape == (LANE_K, 128) and pt_.dtype == torch.int32
        _assert_lanes(*r["k13"][i], pv.numpy(), pt_.numpy(), _exact(name))


@pytest.mark.parametrize("name", list(CASES))
def test_bucket_topk_batch_plain_matches_pallas(ref, name):
    """K12, tie-safe, 3 queries in subgroups of 2, on a padded bucket."""
    r = ref[name]
    codec = CASES[name][0]
    i, (jv, jt) = r["k12"]
    b = r["pm"].buckets[i]
    pv, pt_ = pkernel.bucket_topk_batch_plain(
        _t(b.words), _t(r["tables"]), _nreal(b),
        **_plain_kw(r["pc"], b, codec))
    assert pv.shape == (3, LANE_K, 128)
    for q in range(3):
        _assert_lanes(jv[q], jt[q], pv[q].numpy(), pt_[q].numpy(),
                      _exact(name))


def test_bucket_production_buffers_match_pallas(ref):
    """K13 and K12 with the production update (not tie-safe: every slot
    holding the minimum replaced, distinct sentinels) on tie-free f32
    data: the exact per-lane top of the real slices and the sentinels,
    whatever the visiting order."""
    r = ref["production"]
    for i in r["sel"]:
        b = r["pm"].buckets[i]
        pv, pt_ = pkernel.bucket_topk_plain(_t(b.words), _t(r["table"]),
                                            _nreal(b),
                                            **_plain_kw(r["pc"], b, "f32"))
        _assert_lanes(*r["k13"][i], pv.numpy(), pt_.numpy(), False)
    i, (jv, jt) = r["k12"]
    b = r["pm"].buckets[i]
    pv, pt_ = pkernel.bucket_topk_batch_plain(_t(b.words), _t(r["tables"]),
                                              _nreal(b),
                                              **_plain_kw(r["pc"], b, "f32"))
    assert (pv.numpy() <= pkernel.TOPK_FLOOR).any(), "sentinels stay"
    for q in range(3):
        _assert_lanes(jv[q], jt[q], pv[q].numpy(), pt_[q].numpy(), False)


def test_bucket_dropped_rows_at_quantum_2(ref):
    """With width_quantum 2 the ops read width // 8 chunks of a slice, as
    the JAX kernels do: buckets of width 6, 4 and 2 score 0 on every
    slice, and the width-10 bucket sums only its first 8 rows. The port's
    plain K11 gives the same (bit for bit where it is 0, to the f32
    tolerance elsewhere), and so do both packages' sell_scores_np."""
    r = ref["quantum2"]
    widths = {r["pm"].buckets[i].width for i in r["k11"]}
    assert {2, 4, 6, 10} <= widths
    prod = pkernel.codec_prod("f32")
    for i, js in r["k11"].items():
        b = r["pm"].buckets[i]
        ps = pkernel.bucket_scores_plain(_t(b.words), _t(r["table"]),
                                         codec="f32", **_geometry(b))
        _assert_scores(js, ps.numpy(), b.width < 8)
        words = _t(b.words).reshape(-1, b.width, 128)
        if b.width < 8:
            assert not js.any()
            assert prod(words, _t(r["table"])).abs().sum() > 0
        else:
            dropped = prod(words[:, 8:], _t(r["table"]))
            assert dropped.abs().sum() > 0, "the lost rows hold nnz"
            kept = prod(words[:, :8], _t(r["table"]))
            np.testing.assert_allclose(js, kept.sum(dim=1).numpy(),
                                       rtol=1e-6, atol=1e-6)
    want = jxla.sell_scores_np(r["jm"], r["q"])
    got = xla_ref.sell_scores_np(r["pm"], r["q"])
    np.testing.assert_array_equal(got, want)
    short = np.concatenate([r["pm"].row_ids[b.slice_base:b.slice_base
                                            + b.num_slices].ravel()
                            for b in r["pm"].buckets if b.width < 8])
    assert (got[short[short >= 0]] == 0).all()


def _k11_rows(pm, table, codec):
    """Plain K11 over every bucket, scattered to rows (NaN where no slice
    holds the row)."""
    out = np.full(pm.num_rows, np.nan, np.float32)
    for b in pm.buckets:
        s = pkernel.bucket_scores_plain(_t(b.words), _t(table), codec=codec,
                                        **_geometry(b)).numpy()
        ids = pm.row_ids[b.slice_base:b.slice_base + b.num_slices]
        real = ids >= 0
        out[ids[real]] = s[:b.num_slices][real]
    return out


@pytest.mark.parametrize("integer", [False, True], ids=["real", "integer"])
def test_bucket_scores_match_sell_scores_np(integer):
    """K11 over every bucket against the NumPy oracle sell_scores_np (the
    port's, itself bit-equal to the JAX package's): bit-equal on
    integer-valued data, to rtol 1e-6 on real values (the oracle adds each
    chunk's 8 rows, then the chunk sums; K11 adds two accumulators, then
    the rows)."""
    jc, jm, pc, pm = _packs("f32", integer)
    q = _queries(1, integer, 6)[0]
    want = xla_ref.sell_scores_np(pm, q)
    np.testing.assert_array_equal(want, jxla.sell_scores_np(jm, q))
    assert not np.isnan(want).any()
    table, _ = pack_query_table(q, "f32")
    _assert_scores(want, _k11_rows(pm, table, "f32"), integer)


def test_stacked_bucket_candidates_finalize():
    """K13 over every bucket, the (B, lane_k, 128) buffers stacked and
    finalized once with the matrix's row_ids (the tags are global slice
    ids), against merge_candidates_host over each bucket's own top-k and
    against gold.topk_exact of the bf16-rounded matrix (each lane holds at
    most lane_k slices of any bucket here, so the pool is exact)."""
    jc, jm, pc, pm = _packs("f32", False)
    k = 50
    q = _queries(1, False, 8)[0]
    table = _t(pack_query_table(q, "f32")[0])
    row_ids = _t(pm.row_ids)
    bufs, lists = [], []
    for b in pm.buckets:
        assert b.num_slices <= pc.lane_k
        v, t = pkernel.bucket_topk_plain(_t(b.words), table, _nreal(b),
                                         **_plain_kw(pc, b, "f32"))
        bufs.append((v, t))
        lists.append(pkernel.finalize_topk(v, t, row_ids, k))
    idx, vals = pkernel.finalize_topk(torch.stack([v for v, _ in bufs]),
                                      torch.stack([t for _, t in bufs]),
                                      row_ids, k)
    idx, vals = idx.numpy(), vals.numpy()
    mi, mv = merge_candidates_host([i.numpy() for i, _ in lists],
                                   [v.numpy() for _, v in lists], k)
    np.testing.assert_array_equal(mv, vals)
    assert set(mi.tolist()) == set(idx.tolist())
    coo = create_sparse_matrix(ROWS, COLS, 20, "gamma", seed=5)
    bf16 = CooMatrix(coo.rows, coo.cols, quantize_bf16(coo.vals),
                     coo.num_rows, coo.num_cols)
    gi, gv = gold.topk_exact(bf16, q, k)
    np.testing.assert_allclose(vals, gv, rtol=1e-5, atol=1e-5)
    kth = gv[-1] + 1e-5
    assert set(idx[vals > kth].tolist()) == set(gi[gv > kth].tolist())


def test_bucket_wrappers_on_cpu_run_plain(ref):
    """On CPU tensors each wrapper runs its plain version (no launch
    counted); K12's h16 pools equal K13's for each query (int32 sums:
    every order gives the same values)."""
    r = ref["h16"]
    pc, b = r["pc"], r["pm"].buckets[r["sel"][1]]
    words, nreal = _t(b.words), _nreal(b)
    geo = _geometry(b)
    tk = dict(geo, slice_base=b.slice_base, codec="h16")
    ops = (pkernel.spmv_bucket_scores_device, pkernel.topk_spmv_bucket_device,
           pkernel.topk_spmv_bucket_batch_device)
    before = [op.launches for op in ops]
    s = ops[0](words, _t(r["table"]), cfg=pc, codec="h16", **geo)
    v, t = ops[1](words, _t(r["table"]), nreal, cfg=pc, num_groups=1, **tk)
    tables = _t(np.concatenate([r["table"][None], r["tables"]]))
    bv, bt = ops[2](words, tables, nreal, cfg=pc, **tk)
    assert [op.launches for op in ops] == before
    assert torch.equal(s, pkernel.bucket_scores_plain(
        words, _t(r["table"]), codec="h16", **geo))
    pkw = _plain_kw(pc, b, "h16")
    for got, want in zip((v, t), pkernel.bucket_topk_plain(
            words, _t(r["table"]), nreal, **pkw)):
        assert torch.equal(got, want)
    assert bv.shape == (4, LANE_K, 128)
    np.testing.assert_array_equal(bv[0].numpy(), v.numpy())
    for q in range(1, 4):
        sv, st = pkernel.bucket_topk_plain(words, tables[q], nreal, **pkw)
        _assert_lanes(sv.numpy(), st.numpy(), bv[q].numpy(), bt[q].numpy(),
                      True)


# ------------------------------------------------- K13's lane merge on the card
# csrc/bucket_topk.cu merges its slots' buffers on the card, in a tree, by
# one total order (value descending, then tag ascending);
# ops/kernel.py::lane_merge_plain is that merge, bucket_topk_slots_plain
# the whole kernel (its slots' argmin buffers, then the merge). Both are
# held here to merge_lane_topk (torch.topk), to bucket_topk_plain and to
# the interpret-mode JAX kernel.

def _stack(kind, rows, seed):
    """(rows, 128) entries: tie-free (distinct values and tags), tied
    (values from 5 integers) or sentinel-laden (topk_init's values, -inf
    and NaN beside a few real values, tags repeating)."""
    rng = np.random.default_rng(seed)
    tags = np.stack([rng.permutation(1000)[:rows] for _ in range(128)], 1)
    if kind == "tie_free":
        vals = rng.standard_normal((rows, 128)).astype(np.float32)
    elif kind == "ties":
        vals = rng.integers(0, 5, (rows, 128)).astype(np.float32)
    else:
        init = pkernel.topk_init(16)
        vals = init[rng.integers(0, 16, (rows, 128))]
        pick = rng.random((rows, 128))
        vals = np.where(pick < 0.2, -np.inf, vals)
        vals = np.where((pick >= 0.2) & (pick < 0.25), np.nan, vals)
        vals = np.where(pick >= 0.9, rng.standard_normal((rows, 128)),
                        vals).astype(np.float32)
        tags = np.where(pick < 0.5, 0, tags)
    return _t(vals), _t(tags.astype(np.int32))


def _lanes_above_floor(v, t, rv, rt):
    """Values equal, (value, tag) pairs above each lane's smallest kept
    value equal (``rv``, ``rt``: the reference)."""
    np.testing.assert_array_equal(v.numpy(), rv.numpy())
    v, t, rv, rt = (x.numpy() for x in (v, t, rv, rt))
    for lane in range(128):
        floor = rv[:, lane].min()
        a = sorted(zip(v[v[:, lane] > floor, lane], t[v[:, lane] > floor,
                                                       lane]))
        b = sorted(zip(rv[rv[:, lane] > floor, lane],
                       rt[rv[:, lane] > floor, lane]))
        assert a == b, f"lane {lane}"


@pytest.mark.parametrize("lane_k", [4, 8, 16])
@pytest.mark.parametrize("kind", ["tie_free", "ties", "sentinels"])
def test_lane_merge_plain_matches_merge_lane_topk(kind, lane_k):
    """The card's merge (plain) against merge_lane_topk over 60 stacked
    entries a lane: the same values; on tie-free data the same tags; at
    a tie the smaller tag stays, so above each lane's floor the pairs
    agree and at the floor the kept tags are the smallest of the tied
    ones; a NaN is never kept (merge_lane_topk sees it as -inf here). The
    result is the same in any order of the entries and merged in a tree
    (groups of 7, then their merges), as the kernel merges."""
    vals, tags = _stack(kind, 60, seed=lane_k)
    v, t = pkernel.lane_merge_plain(vals, tags, lane_k)
    assert v.shape == t.shape == (lane_k, 128) and t.dtype == torch.int32
    assert not torch.isnan(v).any()
    clean = torch.where(torch.isnan(vals), float("-inf"), vals)
    rv, rt = pkernel.merge_lane_topk(clean, tags, lane_k)
    if kind == "tie_free":
        assert torch.equal(v, rv) and torch.equal(t, rt)
    _lanes_above_floor(v, t, rv, rt)
    vn, tn, cn, gn = v.numpy(), t.numpy(), clean.numpy(), tags.numpy()
    for lane in range(128):
        floor = vn[-1, lane]
        kept = np.sort(tn[vn[:, lane] == floor, lane])
        tied = np.sort(gn[cn[:, lane] == floor, lane])
        np.testing.assert_array_equal(kept, tied[:len(kept)])
    perm = torch.from_numpy(np.random.default_rng(9).permutation(60))
    pv, pt_ = pkernel.lane_merge_plain(vals[perm], tags[perm], lane_k)
    assert torch.equal(pv, v) and torch.equal(pt_, t)
    parts = [pkernel.lane_merge_plain(vals[i:i + 7], tags[i:i + 7], lane_k)
             for i in range(0, 60, 7)]
    tv, tt = pkernel.lane_merge_plain(torch.cat([p[0] for p in parts]),
                                      torch.cat([p[1] for p in parts]),
                                      lane_k)
    assert torch.equal(tv, v) and torch.equal(tt, t)


def test_lane_merge_plain_keeps_empty_places():
    """Fewer entries than lane_k (or only NaN): the rest of the lane is
    empty places, -inf with the int32 maximum as tag, as on the card."""
    vals = torch.tensor([[1.0] * 128, [float("nan")] * 128])
    tags = torch.tensor([[3] * 128, [4] * 128], dtype=torch.int32)
    v, t = pkernel.lane_merge_plain(vals, tags, 4)
    assert (v[0] == 1.0).all() and (t[0] == 3).all()
    assert (v[1:] == float("-inf")).all() and (t[1:] == 2**31 - 1).all()


@pytest.mark.parametrize("slots", [1, 3, 64, 4096])
@pytest.mark.parametrize("name", ["h16", "f32", "i8s_integer"])
def test_bucket_topk_slots_plain_matches_plain(ref, name, slots):
    """The kernel's plain version on 1, 3, 64 and more slots than slices,
    tie-safe: bucket_topk_plain's values, and its pairs above each lane's
    floor, on the widest and on a padded narrow bucket."""
    r = ref[name]
    codec = CASES[name][0]
    for i in r["sel"]:
        b = r["pm"].buckets[i]
        args = (_t(b.words), _t(r["table"]), _nreal(b))
        kw = _plain_kw(r["pc"], b, codec)
        v, t = pkernel.bucket_topk_slots_plain(*args, num_slots=slots, **kw)
        _lanes_above_floor(v, t, *pkernel.bucket_topk_plain(*args, **kw))


@pytest.mark.parametrize("name", ["h16", "f32_integer", "int8x4_integer"])
def test_bucket_topk_one_slot_is_the_jax_kernel(ref, name):
    """On one slot the kernel's plain version folds every slice in order
    into one buffer, as the JAX kernel's sequential grid does: the same
    (value, tag) pairs, tags of tied entries included, but for the -inf
    slots (the JAX kernel folds its padding slices there at -inf)."""
    r = ref[name]
    codec = CASES[name][0]
    for i in r["sel"]:
        b = r["pm"].buckets[i]
        v, t = pkernel.bucket_topk_slots_plain(
            _t(b.words), _t(r["table"]), _nreal(b), num_slots=1,
            **_plain_kw(r["pc"], b, codec))
        jv, jt = r["k13"][i]
        v, t = v.numpy(), t.numpy()
        np.testing.assert_array_equal(-np.sort(-jv, axis=0), v)
        for lane in range(128):
            a = sorted((x, y) for x, y in zip(jv[:, lane], jt[:, lane])
                       if x > -np.inf)
            b_ = sorted((x, y) for x, y in zip(v[:, lane], t[:, lane])
                        if x > -np.inf)
            assert a == b_, f"lane {lane}"


@pytest.mark.parametrize("slots", [1, 3, 4096])
def test_bucket_topk_slots_plain_production(ref, slots):
    """Not tie-safe, on tie-free f32 data: the real candidates kept (above
    TOPK_FLOOR) are bucket_topk_plain's, pair for pair; below them each
    slot's initial entries take part, so with several slots a lane of
    fewer than lane_k real candidates keeps copies of the sentinels."""
    r = ref["production"]
    for i in r["sel"]:
        b = r["pm"].buckets[i]
        args = (_t(b.words), _t(r["table"]), _nreal(b))
        kw = _plain_kw(r["pc"], b, "f32")
        v, t = pkernel.bucket_topk_slots_plain(*args, num_slots=slots, **kw)
        pv, pt_ = pkernel.bucket_topk_plain(*args, **kw)
        real, preal = v > pkernel.TOPK_FLOOR, pv > pkernel.TOPK_FLOOR
        assert torch.equal(real, preal)
        assert torch.equal(v[real], pv[preal])
        assert torch.equal(t[real], pt_[preal])
        if slots == 1:
            assert torch.equal(v, pv)


# --------------------------------------------- K12's plain version on slots
# csrc/bucket_topk_batch.cuh reads each bucket once a pass of queries,
# deals runs of 8 slices to its slots and merges them on the card;
# ops/kernel.py::bucket_topk_batch_slots_plain is what it gives on the
# kernel's slots. Here it is held to bucket_topk_batch_plain and, on one
# slot, to the interpret-mode JAX K12 of the module fixture.

SMEM = 232448   # an H100's opt-in shared memory a block


def _k12_slots(ref, name, slots, lane_k=LANE_K, tables=None, bucket=None,
               merged=True):
    """(slot plain, bucket_topk_batch_plain) of a fixture case's bucket
    (the padded narrow one by default) and tables."""
    r = ref[name]
    codec = CASES[name][0] if name in CASES else "f32"
    b = r["pm"].buckets[r["sel"][1] if bucket is None else bucket]
    tables = _t(r["tables"] if tables is None else tables)
    args = (_t(b.words), tables, _nreal(b))
    pkw = dict(_plain_kw(r["pc"], b, codec), lane_k=lane_k)
    return (pkernel.bucket_topk_batch_slots_plain(
        *args, num_slots=slots, merged=merged, **pkw),
        pkernel.bucket_topk_batch_plain(*args, **pkw))


def _each_query_above_floor(got, want):
    for q in range(got[0].shape[0]):
        _lanes_above_floor(got[0][q], got[1][q], want[0][q], want[1][q])


@pytest.mark.parametrize("slots", [1, 3, 64, 4096])
@pytest.mark.parametrize("name", list(CASES))
def test_k12_slots_plain_matches_plain(ref, name, slots):
    """K12's plain version on 1, 3, 64 and more slots than runs, tie-safe,
    every codec: bucket_topk_batch_plain's values, and its pairs above
    each lane's floor, on the padded narrow bucket and on the widest (one
    slice per block)."""
    r = ref[name]
    wide = r["pm"].buckets[r["sel"][0]]
    assert wide.block_sublanes == wide.width
    # more slots than runs: one query (each slot's buffers cost as much)
    tables = r["tables"][:1] if slots > 64 else None
    for bucket in r["sel"]:
        _each_query_above_floor(*_k12_slots(ref, name, slots, bucket=bucket,
                                            tables=tables))


@pytest.mark.parametrize("lane_k", [4, 16])
@pytest.mark.parametrize("name", ["h16", "f32", "int8x4", "i8s", "i4s"])
def test_k12_slots_plain_lane_k(ref, name, lane_k):
    """lane_k 4 and 16 on 3 slots, against bucket_topk_batch_plain."""
    _each_query_above_floor(*_k12_slots(ref, name, 3, lane_k=lane_k))


@pytest.mark.parametrize("Q", [1, 5, 33])
def test_k12_slots_plain_groups(ref, Q):
    """Groups of 1, 5 and 33 queries (a pass of 8 or 16 and their tails):
    each query's pairs are those of the query alone."""
    qs = _queries(Q, False, 12)
    tables, _ = pack_query_tables(qs, "f32")
    (v, t), want = _k12_slots(ref, "f32", 3, tables=tables)
    assert v.shape == (Q, LANE_K, 128)
    _each_query_above_floor((v, t), want)
    alone = _k12_slots(ref, "f32", 3, tables=tables[-1:])[0]
    assert torch.equal(v[-1], alone[0][0]) and torch.equal(t[-1], alone[1][0])


def test_k12_slots_plain_quantum_2(ref):
    """width_quantum 2: buckets of width 10, 6, 4 and 2 (a width below 8
    scores 0 on every slice, every value tied) against
    bucket_topk_batch_plain."""
    r = ref["quantum2"]
    tables = _t(pack_query_tables(_queries(3, False, 13), "f32")[0])
    for b in r["pm"].buckets:
        if not b.width % 8:
            continue
        args = (_t(b.words), tables, _nreal(b))
        kw = dict(_geometry(b), lane_k=LANE_K, tie_safe=True,
                  slice_base=b.slice_base, codec="f32")
        got = pkernel.bucket_topk_batch_slots_plain(*args, num_slots=3, **kw)
        want = pkernel.bucket_topk_batch_plain(*args, **kw)
        _each_query_above_floor(got, want)
        if b.width < 8:
            assert not got[0][got[0] > float("-inf")].any()


@pytest.mark.parametrize("name", ["h16", "f32_integer", "int8x4_integer",
                                  "i8s_integer", "i4s_integer"])
def test_k12_one_slot_is_the_jax_kernel(ref, name):
    """On one slot K12's plain version folds every slice in order into one
    buffer a query, as the JAX kernel's sequential grid does: the same
    (value, tag) pairs, tags of tied entries included, but for the -inf
    slots (the JAX kernel folds its padding slices there at -inf)."""
    (v, t), _ = _k12_slots(ref, name, 1)
    jv, jt = ref[name]["k12"][1]
    v, t = v.numpy(), t.numpy()
    for q in range(3):
        np.testing.assert_array_equal(-np.sort(-jv[q], axis=0), v[q])
        for lane in range(128):
            a = sorted((x, y) for x, y in zip(jv[q][:, lane], jt[q][:, lane])
                       if x > -np.inf)
            b = sorted((x, y) for x, y in zip(v[q][:, lane], t[q][:, lane])
                       if x > -np.inf)
            assert a == b, f"query {q} lane {lane}"


@pytest.mark.parametrize("slots", [1, 3, 200])
def test_k12_slots_plain_production(ref, slots):
    """Not tie-safe, on tie-free f32 data: the real candidates kept
    (above TOPK_FLOOR) are bucket_topk_batch_plain's, pair for pair; on
    one slot every entry is, sentinels included, and the JAX K12's to
    the f32 tolerance; unmerged, each slot's sorted buffer."""
    (v, t), (pv, pt_) = _k12_slots(ref, "production", slots)
    real, preal = v > pkernel.TOPK_FLOOR, pv > pkernel.TOPK_FLOOR
    assert torch.equal(real, preal)
    assert torch.equal(v[real], pv[preal]) and torch.equal(t[real], pt_[preal])
    if slots == 1:
        assert torch.equal(v, pv) and torch.equal(t, pt_)
        jv, jt = ref["production"]["k12"][1]
        for q in range(3):
            _assert_lanes(jv[q], jt[q], v[q].numpy(), t[q].numpy(), False)
    (uv, ut), _ = _k12_slots(ref, "production", slots, merged=False)
    assert uv.shape == (3, slots, LANE_K, 128)
    assert (uv[:, :, :-1] >= uv[:, :, 1:]).all()
    mv, mt = pkernel.lane_merge_plain(uv[0], ut[0], LANE_K)
    assert torch.equal(mv, v[0]) and torch.equal(mt, t[0])


@pytest.mark.parametrize("lane_k", [4, 8, 16])
@pytest.mark.parametrize("codec", ["h16", "f32", "int8x4", "i8s", "i4s"])
def test_k12_launch_shapes(codec, lane_k, monkeypatch):
    """k12_launch on a card of 132 SMs and 227 KB of shared memory a
    block: h16 in passes of 8 for up to 8 queries, else of 16, the other
    codecs in passes of 8; f32 and int8x4 tables past shared memory from
    global memory;
    every pass's shared memory within the card's; the grid one block an
    SM over the lane groups and passes, no more slots than runs of 8
    slices."""
    monkeypatch.setattr(pkernel, "_device_info", lambda dev: (132, SMEM))
    dev = torch.device("cuda", 0)
    for cols in (1024, 65536):
        if codec in ("h16", "i8s", "i4s") and cols > 1024:
            continue
        rows, _ = pkernel._table_spec(pt.TopKSpMVConfig(
            max_cols=cols, query_codec=codec))
        for Q in (1, 5, 8, 9, 16, 33):
            kc, qp, passes, slots = pkernel.k12_launch(dev, codec, Q, lane_k,
                                                       rows, 10**6)
            assert qp in pkernel.K12_PASS_QUERIES[kc]
            assert qp == (16 if codec == "h16" and Q > 8 else 8)
            assert kc == (codec if cols == 1024 else f"{codec}_global")
            assert passes == -(-Q // qp)
            smem = (pkernel.k8_smem_bytes if kc == "h16"
                    else pkernel.k6_smem_bytes)
            assert smem(kc, qp, lane_k, rows) <= SMEM
            lanes = pkernel.batch_block_lanes(qp, lane_k, kc)
            assert slots == 132 // (128 // lanes * passes)
            assert pkernel.k12_launch(dev, codec, Q, lane_k, rows,
                                      20)[3] == min(slots, 3)
