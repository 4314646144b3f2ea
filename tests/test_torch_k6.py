"""K6 as its kernels compute it (``octet_topk_batch_slots_plain``, the plain
version of csrc/octet_topk_batch.cuh and octet_topk_batch_h16.cu with
their lane merge on the card, every codec) and the pieces of its launch,
on the CPU:

  - against ``octet_topk_batch_plain`` (the plain version the other tests
    hold to the JAX package) on 1, 33, 66 and 1000 slots, every codec,
    one and two partitions, lane_k 4, 8 and 16, fold 1 and 8, wide
    octets, tie-safe buffers: per-lane sorted values bit for bit, (value,
    tag) pairs equal above each lane's smallest kept value (which tied
    candidate takes that last place depends on the slots);
  - with one slot, against the JAX package's octet batch kernels
    (``topk_spmv_fused_batch_octet_device``, ``topk_spmv_fused_batch_
    octet_part_device``) in interpret mode, tie-safe: int8x4, i8s, i4s and
    integer-valued f32 bit for bit, f32 on the corpus's real values to
    rtol 1e-6 (XLA on the CPU fuses some multiply-adds); tags above each
    lane's smallest finite kept value;
  - groups of 1, 5 and 33 queries on the slots ``k6_launch`` gives them
    (their passes change the slots): each query's values those of the
    query alone, its pairs above each lane's floor;
  - the Bf16Pass tables (int8x4, i8s, i4s): each query's fields as bf16
    values, a column's queries side by side in swizzled 16-byte words,
    decoded as the kernel decodes them, give each query's products bit
    for bit (``prod_int8x4``, ``prod_sign``) on the words the packer
    writes, whose sign-layout shifts name whole fields, and queries past
    a short pass a table of zero values; every value a field can take is
    exact in bf16 (the table's int-to-float step);
  - ``k6_launch``'s shapes with the device info monkeypatched (passes,
    slots, the f32 tables in shared or global memory, int8x4's fallback
    to FloatPass tables), ``batch_subgroup`` read by K12 only;
  - every variant of the batch sweeps' ablations (experiments/
    k6_ablation.py, k8_ablation.py, k6_h16_ablation.py) patching the
    sources it copies.
"""

import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import spmv_topk_tpu.config as jcfg
from spmv_topk_tpu.formats import CooMatrix as JCoo
from spmv_topk_tpu.formats import create_sparse_matrix as jax_matrix
from spmv_topk_tpu.formats.sell_buckets import (fuse_buckets_octet as jfuse,
                                                pack_fused_partitions,
                                                pack_sell_buckets as jpack)
from spmv_topk_tpu.ops import kernel as jkernel
from spmv_topk_tpu.ops.quantized_query import pack_query_tables

import spmv_topk_tpu_torch as pt
from spmv_topk_tpu_torch.formats import (create_query_batch,
                                         create_sparse_matrix)
from spmv_topk_tpu_torch.ops import _build
from spmv_topk_tpu_torch.ops import kernel as pkernel
from spmv_topk_tpu_torch.ops.quantized_query import (
    encode_words_sign_layout, pack_query_tables as ppack_tables)
from test_torch_k8 import _lanes_equal

ROWS, COLS = 2000, 1024
GEOM = dict(block_sublanes=64, fused_block_sublanes=128,
            fused_layout="octet", fold_tile=8)
# each codec at its width quantum (the headline's h16 and f32, c3's)
CODECS = {"h16": dict(query_codec="h16", width_quantum=2),
          "f32": dict(query_codec="f32", width_quantum=2),
          "int8x4": dict(query_codec="int8x4", width_quantum=4),
          "i8s": dict(query_codec="i8s", width_quantum=4),
          "i4s": dict(query_codec="i4s", width_quantum=4)}
# the JAX octet batch kernel's cases, tie-safe: (codec, partitions,
# integer-valued data, 32-row blocks: wide octets, fold_tile)
ONE_SLOT = {"f32": ("f32", 1, False, False, 8),
            "f32_p2_int_wide": ("f32", 2, True, True, 8),
            "int8x4_wide_fold1": ("int8x4", 1, False, True, 1),
            "i8s_p2": ("i8s", 2, False, False, 8),
            "i4s_fold1": ("i4s", 1, False, False, 1)}
JAX_ROWS, JAX_BLOCK, JAX_QUERIES = 1000, 64, 2
SMEM = 232448   # an H100's opt-in shared memory a block


def _cfg(**kw):
    return {"k": 100, **GEOM, **kw}


@pytest.fixture(scope="module")
def coo():
    return create_sparse_matrix(ROWS, COLS, 20, "gamma", seed=5)


@pytest.fixture(scope="module")
def queries():
    return create_query_batch(33, COLS, seed=3)


@pytest.fixture(scope="module")
def small_coo():
    """A corpus small enough for 33 queries' plain sweeps."""
    return create_sparse_matrix(800, COLS, 20, "gamma", seed=6)


@pytest.fixture(scope="module")
def jax_k6(queries):
    """The JAX octet batch kernel of each ONE_SLOT case on JAX_QUERIES
    queries: (words, tables, nreal, plan rows, part_slices, values,
    tags)."""
    jcoo = jax_matrix(JAX_ROWS, COLS, 20, "gamma", seed=5)
    out = {}
    for name, (codec, P, integer, wide, fold) in ONE_SLOT.items():
        cfg = jcfg.TopKSpMVConfig(**_cfg(
            **CODECS[codec], tie_safe_topk=True, num_partitions=P,
            fold_tile=fold, octet_multicall=False,
            fused_block_sublanes=32 if wide else JAX_BLOCK))
        corpus = jcoo
        if integer:
            vals = np.random.default_rng(7).integers(-8, 9, jcoo.nnz)
            corpus = JCoo(jcoo.rows, jcoo.cols, vals.astype(np.float32),
                          jcoo.num_rows, jcoo.num_cols)
        qs = (np.random.default_rng(18).integers(
            -8, 9, (JAX_QUERIES, COLS)).astype(np.float32) if integer
            else queries[:JAX_QUERIES])
        tabs, _ = pack_query_tables(qs, codec)
        geo = dict(cfg=cfg, block_sublanes=cfg.fused_block_sublanes,
                   interpret=True, codec=codec)
        if P == 1:
            f = jfuse(jpack(corpus, cfg),
                      block_sublanes=cfg.fused_block_sublanes)
            part_slices = 0
            tv, tt = jkernel.topk_spmv_fused_batch_octet_device(
                jnp.asarray(f.words), jnp.asarray(tabs), jnp.asarray(f.nreal),
                plan=f.plan, num_blocks=f.num_blocks, **geo)
        else:
            f = pack_fused_partitions(corpus, cfg, P, octet=True)
            part_slices = f.part_slices
            tv, tt = jkernel.topk_spmv_fused_batch_octet_part_device(
                jnp.asarray(f.words), jnp.asarray(tabs), jnp.asarray(f.nreal),
                plan=f.plan, num_blocks=f.num_blocks, num_partitions=P,
                part_slices=part_slices, **geo)
        rows = pkernel.octet_plan_rows(f.plan, f.num_blocks)
        out[name] = (f.words, tabs, f.nreal, rows, part_slices,
                     np.asarray(tv), np.asarray(tt))
    return out


def _engine(coo, **kw):
    cfg = pt.TopKSpMVConfig(**_cfg(**kw))
    return pt.TopKSpMV(coo, cfg, device="cpu"), cfg


def _tables(cfg, qs):
    return torch.from_numpy(ppack_tables(qs, cfg.query_codec)[0])


def _sweep_kw(cfg):
    return dict(lane_k=cfg.lane_k, fold_tile=cfg.fold_tile,
                tie_safe=bool(cfg.tie_safe_topk),
                block_sublanes=cfg.fused_block_sublanes,
                codec=cfg.query_codec)


def _slots_plain(eng, cfg, tables, num_slots, merged=True):
    return pkernel.octet_topk_batch_slots_plain(
        eng.words, tables, eng.nreal, eng.plan_rows, num_slots=num_slots,
        merged=merged, **_sweep_kw(cfg), **eng.partition_kw)


def _batch_plain(eng, cfg, tables):
    return pkernel.octet_topk_batch_plain(
        eng.words, tables, eng.nreal, eng.plan_rows, **_sweep_kw(cfg),
        **eng.partition_kw)


SLOT_CASES = [(c, n, {}) for c in CODECS for n in (1, 66)] + [
    ("f32", 1000, {}), ("i4s", 1000, dict(fold_tile=1)),
    ("f32", 33, dict(num_partitions=2, fold_tile=1)),
    ("int8x4", 66, dict(num_partitions=2, lane_k=4)),
    ("i8s", 33, dict(num_partitions=2, lane_k=16)),
    ("i4s", 66, dict(lane_k=16, fold_tile=1)),
    ("f32", 66, dict(fused_block_sublanes=32, lane_k=4)),
    ("int8x4", 33, dict(fused_block_sublanes=24, fold_tile=1)),
    ("i8s", 66, dict(fused_block_sublanes=32, num_partitions=2,
                     lane_k=16))]


@pytest.mark.parametrize(
    "codec,num_slots,kw", SLOT_CASES,
    ids=[f"{c}_{n}slots" + "".join(f"_{k}{v}" for k, v in kw.items())
         for c, n, kw in SLOT_CASES])
def test_slots_plain_matches_batch_plain(coo, queries, codec, num_slots, kw):
    """Tie-safe slots merged give each lane of each query its top lane_k
    of all the candidates: the values of ``octet_topk_batch_plain``, bit
    for bit, and its pairs above each lane's floor."""
    eng, cfg = _engine(coo, **{**CODECS[codec], **kw}, tie_safe_topk=True)
    if kw.get("fused_block_sublanes", 128) < 128:
        assert any(p.blocks_per_octet > 1 for p in eng.fused.plan)
    tables = _tables(cfg, queries[:2])
    sv, st = _slots_plain(eng, cfg, tables, num_slots)
    pv, pt_ = _batch_plain(eng, cfg, tables)
    P = cfg.num_partitions
    assert sv.shape == pv.shape == (2, *((P,) if P > 1 else ()),
                                    cfg.lane_k, 128)
    assert np.isfinite(pv.numpy()).any()
    _lanes_equal(sv, st, pv, pt_, np.min)


@pytest.mark.parametrize("tie_safe", [True, False])
@pytest.mark.parametrize("codec", ["f32", "i4s"])
def test_slots_plain_merges_its_unmerged_slots(coo, queries, codec,
                                               tie_safe):
    """The merged pairs are the lane merge of the unmerged slots' (each
    already in the merge's order), on one partition and two."""
    for P in (1, 2):
        eng, cfg = _engine(coo, **CODECS[codec], num_partitions=P,
                           tie_safe_topk=tie_safe)
        tables = _tables(cfg, queries[:2])
        sv, st = _slots_plain(eng, cfg, tables, 7)
        uv, ut = _slots_plain(eng, cfg, tables, 7, merged=False)
        assert uv.shape == (2, P, 7, 8, 128)
        sv, st = sv.reshape(2, P, 8, 128), st.reshape(2, P, 8, 128)
        for q in range(2):
            for p in range(P):
                mv, mt = pkernel.lane_merge_plain(uv[q, p], ut[q, p], 8)
                assert torch.equal(mv, sv[q, p]) and torch.equal(mt, st[q, p])


@pytest.mark.parametrize("name", list(ONE_SLOT))
def test_one_slot_matches_jax(jax_k6, name):
    """One slot carries each query's buffer over the octets in order, as
    the JAX batch kernel does: the same entries."""
    words, tabs, nreal, rows, part_slices, jv, jt = jax_k6[name]
    codec, P, integer, wide, fold = ONE_SLOT[name]
    sv, st = pkernel.octet_topk_batch_slots_plain(
        torch.from_numpy(words), torch.from_numpy(tabs),
        torch.from_numpy(nreal), torch.from_numpy(rows), num_slots=1,
        lane_k=8, fold_tile=fold, tie_safe=True,
        block_sublanes=32 if wide else JAX_BLOCK, codec=codec,
        num_partitions=P, part_slices=part_slices)
    if wide:
        assert any(r[2] > 1 for r in rows.tolist())
    if P > 1:
        assert (nreal == 0).any()
    assert sv.shape == jv.shape
    assert np.isfinite(sv.numpy()).any()

    def smallest_finite(x):
        fin = x[np.isfinite(x)]
        return fin.min() if fin.size else -np.inf

    order = np.argsort(-jv, axis=-2, kind="stable")
    _lanes_equal(np.take_along_axis(jv, order, -2),
                 np.take_along_axis(jt, order, -2), sv, st, smallest_finite,
                 rtol=1e-6 if codec == "f32" and not integer else 0.0)


@pytest.mark.parametrize("codec,kw", [
    ("f32", dict(num_partitions=2)), ("i4s", dict(lane_k=4)),
    ("int8x4", dict(fold_tile=1))], ids=["f32_p2", "i4s_k4", "int8x4_fold1"])
def test_values_do_not_depend_on_the_passes(small_coo, queries, codec, kw,
                                            monkeypatch):
    """Groups of 1, 5 and 33 queries, each on the slots its launch gives
    it (one pass, or three of 16, 16 and 1): each query's tie-safe values
    are those of the query alone, and its pairs above each lane's
    floor."""
    monkeypatch.setattr(pkernel, "_device_info", lambda dev: (132, SMEM))
    eng, cfg = _engine(small_coo, **{**CODECS[codec], **kw},
                       tie_safe_topk=True)
    P = cfg.num_partitions
    alone = _batch_plain(eng, cfg, _tables(cfg, queries))
    seen = set()
    for n in (1, 5, 33):
        _, qp, passes, slots = pkernel.k6_launch(torch.device("cuda", 0),
                                                 cfg, n, P)
        seen.add((passes, slots))
        sv, st = _slots_plain(eng, cfg, _tables(cfg, queries[:n]), slots)
        _lanes_equal(sv, st, alone[0][:n], alone[1][:n], np.min)
    assert len(seen) == 2   # 33 queries take more passes, so fewer slots


# ------------------------------------------------------------ pass tables

def _bits(a):
    return np.ascontiguousarray(a).view(np.uint32)


def _field(entry, f, codec):
    """Field f of int32 table entries as the codec's product takes it
    (``prod_int8x4``: byte f - 128; ``prod_sign``: the entry shifted left
    by 8 f (i8s) or 4 f (i4s), then arithmetically right by 24 or 28)."""
    e = np.asarray(entry).astype(np.int64) & 0xFFFFFFFF
    if codec == "int8x4":
        return ((e >> (8 * f)) & 0xFF) - 128
    width = 8 if codec == "i8s" else 4
    shifted = (e << (width * f)) & 0xFFFFFFFF
    return shifted.astype(np.uint32).view(np.int32) >> (32 - width)


def _turn(e, F):
    """Bf16Pass::turn: where entry e's fields start among its F columns."""
    return (e // (8 // F)) % F


def bf16_pass_table(tables, codec, qp):
    """(nq, rows, 128) int32 tables (nq <= qp) -> the Bf16Pass table as a
    block's shared memory holds it (csrc/codecs.cuh::Bf16Pass): column c =
    e F + (f ^ turn(e)) (entry e's field f, its place turned by the
    entry: turn(e) = (e // (8 // F)) % F), S = qp / 8 16-byte words a
    column, word r
    at 16-byte index c S + (r ^ swizzle(c)), swizzle(c) = (c // (8 // S))
    % S, its 32-bit word k holding queries 8r + 2k (low half) and 8r + 2k
    + 1 (high half) as bf16 bits; uint16 halves, 0 past nq."""
    nq, rows, _ = tables.shape
    F = pkernel.TABLE_FIELDS[codec]
    cols = rows * 128 * F
    S = qp // 8
    c = np.arange(cols)
    sw = (c // (8 // S)) % S
    tab = np.zeros(cols * qp, np.uint16)
    e = c // F
    for j in range(nq):
        vals = _field(tables[j].reshape(-1)[e], (c % F) ^ _turn(e, F),
                      codec)
        half = (_bits(vals.astype(np.float32)) >> 16).astype(np.uint16)
        tab[(c * S + ((j // 8) ^ sw)) * 8 + j % 8] = half
    return tab


def bf16_pass_products(words, tab, codec, rows, qp):
    """The kernel's products of each word for each query of the pass
    (Bf16Pass::add_word: the codec's decode once, the column's bf16 of
    each query to a float, a rounded product): (qp, words) float32."""
    u = np.asarray(words, np.uint32).astype(np.int64)
    val = ((u & 0xFFFF) << 16).astype(np.uint32).view(np.float32)
    F = pkernel.TABLE_FIELDS[codec]
    if codec == "int8x4":
        row = u >> 25
        idx = np.where(row < rows, row, 0) * 128 + ((u >> 16) & 0x7F)
        f = ((u >> 20) & 24) >> 3
    else:
        idx = ((u >> 31) & 1) * (rows > 1) * 128 + ((u >> 16) & 0x7F)
        a = (u >> 24) & 31
        f = a >> 3 if F == 4 else a >> 2
    c = idx * F + (f ^ _turn(idx, F))
    S = qp // 8
    sw = (c // (8 // S)) % S
    out = np.zeros((qp, len(u)), np.float32)
    for j in range(qp):
        half = tab[(c * S + ((j // 8) ^ sw)) * 8 + j % 8].astype(np.uint32)
        out[j] = val * (half << 16).view(np.float32)
    return out


@functools.lru_cache(maxsize=None)
def _packer_words(codec, cols):
    """4096 nonzero octet stream words of a small corpus packed for the
    codec at ``cols`` columns (the packer's words: for i8s and i4s
    written by ``encode_words_sign_layout``)."""
    coo = create_sparse_matrix(600, cols, 20, "gamma", seed=cols)
    eng, _ = _engine(coo, **CODECS[codec], max_cols=cols)
    words = eng.words.numpy().reshape(-1).view(np.uint32)
    words = words[words != 0]
    return words[np.random.default_rng(cols).permutation(len(words))[:4096]]


@pytest.mark.parametrize("nq", ["full", "short"])
@pytest.mark.parametrize("qp", [8, 16, 32])
@pytest.mark.parametrize("codec,cols", [
    ("int8x4", 1024), ("int8x4", 1536), ("i8s", 1024), ("i8s", 512),
    ("i4s", 1024), ("i4s", 2048)])
def test_bf16_pass_table_gives_each_querys_products(codec, cols, qp, nq):
    """The Bf16Pass table decoded for every query of a pass of 16 or 32
    (full, or 5 short) gives the codec's products bit for bit on the
    packer's words; queries past the pass's count decode a table of zero
    values (products of 0, whatever their codec's zero entry means)."""
    rng = np.random.default_rng(qp + cols)
    n = qp if nq == "full" else qp - 5
    qs = rng.standard_normal((n, cols)).astype(np.float32)
    tables = ppack_tables(qs, codec)[0]
    rows = tables.shape[1]
    tab = bf16_pass_table(tables, codec, qp)
    F, S = pkernel.TABLE_FIELDS[codec], qp // 8
    c = np.arange(tables[0].size * F)
    where = [(c * S + ((j // 8) ^ ((c // (8 // S)) % S))) * 8 + j % 8
             for j in range(qp)]
    assert np.unique(where).size == len(tab)   # one place each
    words = _packer_words(codec, cols)
    assert len(words) == 4096
    got = bf16_pass_products(words, tab, codec, rows, qp)
    prod = pkernel.codec_prod(codec)
    w = torch.from_numpy(words.view(np.int32))
    for j in range(n):
        want = prod(w, torch.from_numpy(tables[j])).numpy()
        np.testing.assert_array_equal(_bits(got[j]), _bits(want))
    assert not got[n:].any()


@pytest.mark.parametrize("codec", ["i8s", "i4s"])
def test_sign_layout_words_name_whole_fields(codec):
    """``encode_words_sign_layout`` writes a shift of 24 - 8 index (i8s)
    or 28 - 4 index (i4s) for every column: the whole byte or nibble that
    Bf16Pass's column of the word holds (csrc/codecs.cuh::Bf16Pass)."""
    cols = np.arange(1024 if codec == "i8s" else 2048, dtype=np.uint32)
    words = ((cols << 16) | 0x3F80).astype(np.uint32).view(np.int32)
    a = (encode_words_sign_layout(words, codec).view(np.uint32) >> 24) & 31
    width = 8 if codec == "i8s" else 4
    assert (a % width == 0).all()
    # the field a names holds the column's value: index (cols >> 7) % F
    # from the entry's top, shift 32 - width - width * index
    F = 32 // width
    assert np.array_equal(a, 32 - width - width * ((cols >> 7) % F))


@pytest.mark.parametrize("codec", ["int8x4", "i8s", "i4s"])
def test_every_field_value_is_exact_in_bf16(codec):
    """Every value a byte or nibble field can take, as a bf16 (the top
    half of its float's bits, as Bf16Pass stores it), is the float the
    codec's product takes: the table's int-to-float step is exact."""
    width = 4 if codec == "i4s" else 8
    entries = np.arange(1 << width, dtype=np.int64)   # every field's bits
    for f in range(32 // width):
        q = _field(entries << (32 - width - width * f) if codec != "int8x4"
                   else entries << (8 * f), f, codec)
        if codec == "int8x4":
            assert sorted(q.tolist()) == list(range(-128, 128))
        else:
            assert sorted(q.tolist()) == list(range(-(1 << (width - 1)),
                                                    1 << (width - 1)))
        half = _bits(q.astype(np.float32)) >> 16
        back = (half << 16).astype(np.uint32).view(np.float32)
        np.testing.assert_array_equal(back, q.astype(np.float32))


@pytest.mark.parametrize("codec", ["int8x4", "i8s", "i4s"])
def test_bf16_pass_columns_of_one_field_spread_over_the_bank_groups(codec):
    """Columns of one field index f (the warp's 32 rows at one word index
    mostly share it: a row's nnz are in column order) over random entries
    land on every 16-byte bank group equally, for every gather r: the
    field's place turns with the entry (c = e F + (f ^ turn(e)))."""
    F = pkernel.TABLE_FIELDS[codec]
    e = np.arange(2048)
    for qp in (8, 16, 32):
        S = qp // 8
        for f in range(F):
            c = e * F + (f ^ _turn(e, F))
            for r in range(S):
                group = (c * S + (r ^ ((c // (8 // S)) % S))) % 8
                assert np.bincount(group, minlength=8).tolist() == [256] * 8


def test_bf16_pass_table_spreads_each_gather_over_the_bank_groups():
    """The r-th 16-byte gather of a column lands on 16-byte bank group (c
    S + (r ^ swizzle(c))) % 8: over the columns every group takes the
    same share, for every r and pass (c S alone reaches 8 / S groups)."""
    for qp in (8, 16, 32):
        S = qp // 8
        c = np.arange(4096)
        for r in range(S):
            group = (c * S + (r ^ ((c // (8 // S)) % S))) % 8
            assert np.bincount(group, minlength=8).tolist() == [512] * 8


# ------------------------------------------------------------ the launch

def test_k6_launch_shapes(monkeypatch):
    """h16 in passes of 32 (K6 h16's grid); the other codecs in passes of
    8, or 16 past 8 queries; blocks of 64 lanes (32 past 128 buffer
    entries a lane), one an SM: slots are the SMs over the lane groups,
    partitions and passes. A table that does not fit beside the buffers
    takes the next smaller pass, 8, then f32 and int8x4 read their tables
    from global memory in passes of 8 (i8s and i4s tables are at most 2
    rows). ``batch_subgroup`` changes nothing (K12 reads it)."""
    monkeypatch.setattr(pkernel, "_device_info", lambda dev: (132, SMEM))
    dev = torch.device("cuda", 0)

    def launch(Q, P=1, **kw):
        return pkernel.k6_launch(dev, pt.TopKSpMVConfig(**dict(
            k=100, fused_layout="octet", **kw)), Q, P)

    h16 = dict(query_codec="h16", width_quantum=2)
    assert launch(32, **h16) == ("h16", 32, 1, 66)
    assert launch(33, **h16) == ("h16", 32, 2, 33)
    assert launch(32, lane_k=16, **h16) == ("h16", 32, 1, 33)
    assert launch(5) == ("f32", 8, 1, 66)
    assert launch(8, 2) == ("f32", 8, 1, 33)
    assert launch(32) == ("f32", 16, 2, 33)
    assert launch(32, lane_k=16) == ("f32", 16, 2, 16)
    assert launch(5, query_codec="i8s") == ("i8s", 8, 1, 66)
    assert launch(9, query_codec="i8s") == ("i8s", 16, 1, 66)
    assert launch(32, query_codec="i8s") == ("i8s", 16, 2, 33)
    assert launch(32, query_codec="i4s", lane_k=4) == ("i4s", 16, 2, 33)
    assert launch(33, 2, query_codec="int8x4") == ("int8x4", 16, 3, 11)
    assert launch(32, query_codec="i4s", lane_k=16) == ("i4s", 16, 2, 16)
    # forced passes: 8 at 32 queries; none of 32 (no instantiation)
    cfg = pt.TopKSpMVConfig(k=100, fused_layout="octet")
    assert pkernel.k6_launch(dev, cfg, 32, 1, 8) == ("f32", 8, 4, 16)
    assert pkernel.k6_launch(dev, dataclasses.replace(
        cfg, query_codec="i4s"), 32, 1, 8) == ("i4s", 8, 4, 16)
    with pytest.raises(ValueError, match="takes"):
        pkernel.k6_launch(dev, dataclasses.replace(cfg, query_codec="i8s"),
                          32, 1, 32)
    assert launch(8, query_codec="int8x4", batch_subgroup=2) == \
        launch(8, query_codec="int8x4") == ("int8x4", 8, 1, 66)
    # 2048 columns: 16 f32 rows, a pass of 16 no longer fits, 8 does;
    # 65,536: global memory; int8x4 Bf16Pass tables of 16 up to 3,584
    # columns (7 rows), of 8 up to 11,264 (22 rows), then global memory up
    # to its 65,536 (128 rows)
    assert launch(16, max_cols=2048) == ("f32", 8, 2, 33)
    assert launch(33, max_cols=65536) == ("f32_global", 8, 5, 13)
    assert launch(20, max_cols=3584, query_codec="int8x4") == \
        ("int8x4", 16, 2, 33)
    for cols in (4096, 11264):
        assert launch(20, max_cols=cols, query_codec="int8x4") == \
            ("int8x4", 8, 3, 22)
    for cols in (11776, 16384, 32768, 65536):
        assert launch(20, max_cols=cols, query_codec="int8x4") == \
            ("int8x4_global", 8, 3, 22)
    assert pkernel.k6_pass("int8x4", 8, 8, 1024, SMEM) == \
        ("int8x4_global", 8)
    with pytest.raises(ValueError, match="takes"):
        pkernel.k6_pass("i8s", 8, 8, 2, SMEM, pass_queries=32)
    with pytest.raises(ValueError, match="does not fit"):
        pkernel.k6_pass("f32", 32, 8, 16, SMEM, pass_queries=16)
    with pytest.raises(ValueError, match="does not fit"):
        pkernel.k6_pass("i8s", 8, 8, 1024, SMEM)
    # the old batch kernels' grid (the ablations' OLD_SOURCE) reads the
    # subgroup
    assert pkernel.batch_grid(8, 2, 132, 10**6)[:2] == (2, 4)
    assert pkernel.batch_grid(8, 0, 132, 10**6)[:2] == (4, 2)


# ------------------------------------------------------------ the ablations

def _ablation_cases():
    from spmv_topk_tpu_torch.experiments import (k6_ablation, k6_h16_ablation,
                                                 k8_ablation, k12_ablation)
    return [(m, trim, n) for m, trim in (
        (k6_ablation, k6_ablation._TRIM), (k8_ablation, k8_ablation._TRIM),
        (k6_h16_ablation, ()), (k12_ablation, k12_ablation._TRIM))
        for n in m.PARTS]


@pytest.mark.parametrize("module,trim,name", _ablation_cases(),
                         ids=lambda x: getattr(x, "__name__", None)
                         and x.__name__.rsplit(".", 1)[-1])
def test_ablation_variants_patch_their_sources(tmp_path, module, trim, name):
    """Every variant of the batch sweeps' ablations (K6, K8, K6 h16, K12)
    finds each line it replaces in exactly one of the sources it copies
    (the kernel's and batch_sweep.cuh), so that a kernel edit cannot leave
    a variant timing the unchanged kernel."""
    out = module.variant_dir(str(tmp_path), module.SOURCES,
                             (*trim, *module.PARTS[name]))
    for src in module.SOURCES:
        assert (tmp_path / src).exists()
    if module.PARTS[name]:
        changed = [src for src in module.SOURCES if (tmp_path / src)
                   .read_text() != open(os.path.join(
                       _build.CSRC_DIR, src)).read()]
        assert changed and out == str(tmp_path)


def test_ablation_routes_are_valid_configs():
    """Every route the K6, K8 and K6 h16 / K8 turn scripts time is a valid
    config whose batch sweep takes the group (on an H100's shape), and
    batch_against builds the package's own units of the entry points it
    swaps in, each with a ctypes signature."""
    from spmv_topk_tpu_torch.experiments import (batch_against, k6_ablation,
                                                 k8_ablation)
    dev = torch.device("cuda", 0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pkernel, "_device_info", lambda d: (132, SMEM))
        for module in (k6_ablation, k8_ablation, batch_against):
            for config, n in module.ROUTES.values():
                cfg = pt.TopKSpMVConfig(**config)
                launch = (pkernel.k6_launch if cfg.fused_layout == "octet"
                          else pkernel.k8_launch)
                codec, qp, passes, _ = launch(dev, cfg, n,
                                              cfg.num_partitions)
                assert passes == -(-n // qp)
        wide, n = k6_ablation.ROUTES["k6_int8x4_32k"]
        assert pkernel.k6_launch(dev, pt.TopKSpMVConfig(**wide), n, 1) == \
            ("int8x4_global", 8, 4, 16)
    for units in batch_against.ENTRIES.values():
        for u in units:
            assert os.path.exists(os.path.join(_build.CSRC_DIR, u))
    assert set(batch_against.ENTRIES) <= set(_build._SIGNATURES)
