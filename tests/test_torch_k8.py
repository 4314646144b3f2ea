"""K8 as its kernel computes it (``slice_topk_batch_slots_plain``, the
plain version of csrc/slice_topk_batch.cuh with its lane merge on the
card) and the pieces of its launch, on the CPU:

  - against ``slice_topk_batch_plain`` (the plain version the other tests
    hold to the JAX package) on 1, 66 and 1000 slots, every codec, one
    and two partitions, lane_k 4, 8 and 16, wide slices, tie-safe
    buffers: per-lane sorted values bit for bit, (value, tag) pairs equal
    above each lane's smallest kept value (which tied candidate takes
    that last place depends on the slots);
  - with one slot, against the JAX package's batch kernels
    (``topk_spmv_fused_batch_device``, ``topk_spmv_fused_batch_part_
    device``) in interpret mode, tie-safe, every codec, one and two
    partitions: h16 and integer-valued data (matrix and queries) bit for
    bit, f32 on the
    corpus's real values to rtol 1e-6 (the JAX kernel adds two
    interleaved accumulators and then a chunk's rows, the port a slice's
    rows in order); tags above each lane's smallest finite kept value
    (the JAX kernel harvests its blocks' padding slices at -inf);
  - groups of 1, 5 and 33 queries on the slots ``k8_launch`` gives them
    (their passes change the slots): each query's values those of the
    query alone, its pairs above each lane's floor;
  - the pass tables: each codec's tables repacked as the kernel's shared
    memory holds a pass (h16: K6 h16's 16-byte columns of biased nibbles,
    emulated in tests/test_torch_h16x32.py; the other codecs: the pass's
    entries side by side in 16-byte words, swizzled), decoded for every
    query of passes of 8, 16 and 32 (the others 8 and 16), full and short,
    give each query's products bit for bit (``prod_h16``, ``prod_f32``,
    ``prod_int8x4``, ``prod_sign``), queries past the pass's count a
    table of zeros;
  - K8's deal (``k7_deal`` at fold_tile 1): every item with a real member
    dealt once, contiguous runs, no slot beyond the mean and the largest
    item's work;
  - ``k8_launch``'s shapes with the device info monkeypatched (passes,
    slots, the f32 tables in shared or global memory), ``batch_subgroup``
    read nowhere, and the launch refusing blocks of partial load batches.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import spmv_topk_tpu.config as jcfg
from spmv_topk_tpu.formats import CooMatrix as JCoo
from spmv_topk_tpu.formats import create_sparse_matrix as jax_matrix
from spmv_topk_tpu.formats.sell_buckets import (fuse_buckets as jfuse,
                                                pack_fused_partitions,
                                                pack_sell_buckets as jpack)
from spmv_topk_tpu.ops import kernel as jkernel
from spmv_topk_tpu.ops.quantized_query import pack_query_tables

import spmv_topk_tpu_torch as pt
from spmv_topk_tpu_torch.formats import create_query_batch, create_sparse_matrix
from spmv_topk_tpu_torch.ops import kernel as pkernel
from spmv_topk_tpu_torch.ops.quantized_query import (
    pack_query_tables as ppack_tables)
from test_torch_h16x32 import packed_sums, plain_sums, repack

ROWS, COLS = 3000, 1024
GEOM = dict(block_sublanes=64, fused_block_sublanes=128)
# each codec at its engine's width quantum (bench.py's slice engine, the
# default, c3's)
CODECS = {"h16": dict(query_codec="h16", width_quantum=2),
          "f32": dict(),
          "int8x4": dict(query_codec="int8x4", width_quantum=4),
          "i8s": dict(query_codec="i8s", width_quantum=4),
          "i4s": dict(query_codec="i4s", width_quantum=4)}
# the JAX batch kernel's cases, tie-safe: (codec, partitions,
# integer-valued data, 32-row blocks: wide slices)
ONE_SLOT = {"h16": ("h16", 1, False, False),
            "h16_p2_wide": ("h16", 2, False, True),
            "f32": ("f32", 1, False, False),
            "f32_p2_int": ("f32", 2, True, False),
            "int8x4_wide_int": ("int8x4", 1, True, True),
            "i8s_p2_int": ("i8s", 2, True, False),
            "i4s_int": ("i4s", 1, True, False)}
# the JAX programs' corpus and queries (interpret mode takes ~10 s a
# program even at this size)
JAX_ROWS, JAX_BLOCK, JAX_QUERIES = 1000, 64, 2


def _cfg(**kw):
    return {"k": 100, **GEOM, **kw}


def _integer_valued(coo, cls):
    """The corpus with integer values in [-8, 8] (exact in bf16, every
    partial sum an exact f32)."""
    vals = np.random.default_rng(7).integers(-8, 9, coo.nnz).astype(
        np.float32)
    return cls(coo.rows, coo.cols, vals, coo.num_rows, coo.num_cols)


@pytest.fixture(scope="module")
def coo():
    return create_sparse_matrix(ROWS, COLS, 20, "gamma", seed=5)


@pytest.fixture(scope="module")
def queries():
    return create_query_batch(33, COLS, seed=3)


@pytest.fixture(scope="module")
def jax_k8(queries):
    """The JAX batch kernel of each ONE_SLOT case on JAX_QUERIES queries:
    (words, tables, nreal, plan rows, part_slices, values, tags)."""
    jcoo = jax_matrix(JAX_ROWS, COLS, 20, "gamma", seed=5)
    out = {}
    for name, (codec, P, integer, wide) in ONE_SLOT.items():
        cfg = jcfg.TopKSpMVConfig(**_cfg(
            **CODECS[codec], tie_safe_topk=True, num_partitions=P,
            fused_block_sublanes=32 if wide else JAX_BLOCK))
        corpus = _integer_valued(jcoo, JCoo) if integer else jcoo
        qs = (np.random.default_rng(18).integers(
            -8, 9, (JAX_QUERIES, COLS)).astype(np.float32) if integer
            else queries[:JAX_QUERIES])
        tabs, _ = pack_query_tables(qs, codec)
        if P == 1:
            f = jfuse(jpack(corpus, cfg),
                      block_sublanes=cfg.fused_block_sublanes)
            tv, tt = jkernel.topk_spmv_fused_batch_device(
                jnp.asarray(f.words), jnp.asarray(tabs), jnp.asarray(f.nreal),
                cfg=cfg, plan=f.plan, block_sublanes=f.block_sublanes,
                num_blocks=f.num_blocks, interpret=True, codec=codec)
            part_slices = 0
        else:
            f = pack_fused_partitions(corpus, cfg, P)
            part_slices = f.part_slices
            tv, tt = jkernel.topk_spmv_fused_batch_part_device(
                jnp.asarray(f.words), jnp.asarray(tabs), jnp.asarray(f.nreal),
                cfg=cfg, plan=f.plan, block_sublanes=f.block_sublanes,
                num_blocks=f.num_blocks, num_partitions=P,
                part_slices=part_slices, interpret=True, codec=codec)
        rows = pkernel.slice_plan_rows(f.plan, f.num_blocks, f.nreal,
                                       f.block_sublanes)
        out[name] = (f.words, tabs, f.nreal, rows, part_slices,
                     np.asarray(tv), np.asarray(tt))
    return out


def _engine(coo, **kw):
    cfg = pt.TopKSpMVConfig(**_cfg(**kw))
    return pt.TopKSpMV(coo, cfg, device="cpu"), cfg


def _tables(cfg, qs):
    return torch.from_numpy(ppack_tables(qs, cfg.query_codec)[0])


def _slots_plain(eng, cfg, tables, num_slots, merged=True):
    return pkernel.slice_topk_batch_slots_plain(
        eng.words, tables, eng.nreal, eng.plan_rows, num_slots=num_slots,
        lane_k=cfg.lane_k, tie_safe=bool(cfg.tie_safe_topk),
        block_sublanes=cfg.fused_block_sublanes, codec=cfg.query_codec,
        merged=merged, **eng.partition_kw)


def _batch_plain(eng, cfg, tables):
    return pkernel.slice_topk_batch_plain(
        eng.words, tables, eng.nreal, eng.plan_rows, lane_k=cfg.lane_k,
        tie_safe=bool(cfg.tie_safe_topk),
        block_sublanes=cfg.fused_block_sublanes, codec=cfg.query_codec,
        **eng.partition_kw)


def _lanes_equal(v, t, rv, rt, floor_of, rtol=0.0):
    """Sorted values equal (to rtol) and, above each lane's floor
    (``floor_of(lane values)``, less the rtol margin), (value, tag) pairs
    equal (tags alone with a tolerance), for each (lane_k, 128) pool."""
    v, t, rv, rt = (np.asarray(x).reshape(-1, *np.shape(x)[-2:])
                    for x in (v, t, rv, rt))
    for a, at, b, bt in zip(v, t, rv, rt):
        if rtol:
            np.testing.assert_allclose(a, b, rtol=rtol)
        else:
            np.testing.assert_array_equal(a, b)
        for lane in range(a.shape[1]):
            floor = floor_of(b[:, lane])
            if np.isfinite(floor):
                floor += rtol * abs(floor)
            ka, kb = a[:, lane] > floor, b[:, lane] > floor
            if rtol:
                assert sorted(at[ka, lane]) == sorted(bt[kb, lane]), lane
            else:
                assert sorted(zip(a[ka, lane], at[ka, lane])) == \
                    sorted(zip(b[kb, lane], bt[kb, lane])), lane


SLOT_CASES = [(c, n, {}) for c in CODECS for n in (1, 66)] + [
    ("h16", 1000, {}), ("f32", 1000, {}),
    ("h16", 66, dict(num_partitions=2)), ("f32", 3, dict(num_partitions=2)),
    ("int8x4", 66, dict(num_partitions=2, lane_k=4)),
    ("i8s", 33, dict(num_partitions=2, lane_k=16)),
    ("i4s", 66, dict(lane_k=16)), ("h16", 33, dict(lane_k=4)),
    ("h16", 66, dict(fused_block_sublanes=32, lane_k=16)),
    ("f32", 66, dict(fused_block_sublanes=32, lane_k=4)),
    ("i4s", 33, dict(fused_block_sublanes=32, num_partitions=2))]


@pytest.mark.parametrize(
    "codec,num_slots,kw", SLOT_CASES,
    ids=[f"{c}_{n}slots" + "".join(f"_{k}{v}" for k, v in kw.items())
         for c, n, kw in SLOT_CASES])
def test_slots_plain_matches_batch_plain(coo, queries, codec, num_slots, kw):
    """Tie-safe slots merged give each lane of each query its top lane_k
    of all the candidates: the values of ``slice_topk_batch_plain``, bit
    for bit, and its pairs above each lane's floor."""
    eng, cfg = _engine(coo, **{**CODECS[codec], **kw}, tie_safe_topk=True)
    if kw.get("fused_block_sublanes") == 32:
        assert any(r[2] > 1 for r in eng.plan_rows.tolist())
    tables = _tables(cfg, queries[:3])
    sv, st = _slots_plain(eng, cfg, tables, num_slots)
    pv, pt_ = _batch_plain(eng, cfg, tables)
    P = cfg.num_partitions
    assert sv.shape == pv.shape == (3, *((P,) if P > 1 else ()),
                                    cfg.lane_k, 128)
    assert np.isfinite(pv.numpy()).any()
    _lanes_equal(sv, st, pv, pt_, np.min)


@pytest.mark.parametrize("name", list(ONE_SLOT))
def test_one_slot_matches_jax(jax_k8, name):
    """One slot carries each query's buffer over the work items in order,
    every slice folded, as the JAX batch kernel does: the same entries."""
    words, tabs, nreal, rows, part_slices, jv, jt = jax_k8[name]
    codec, P, integer, wide = ONE_SLOT[name]
    sv, st = pkernel.slice_topk_batch_slots_plain(
        torch.from_numpy(words), torch.from_numpy(tabs),
        torch.from_numpy(nreal), torch.from_numpy(rows), num_slots=1,
        lane_k=8, tie_safe=True,
        block_sublanes=32 if wide else JAX_BLOCK,
        codec=codec, num_partitions=P, part_slices=part_slices)
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
    ("h16", {}), ("f32", dict(num_partitions=2)), ("i4s", dict(lane_k=4))],
    ids=["h16", "f32_p2", "i4s_k4"])
def test_values_do_not_depend_on_the_passes(coo, queries, codec, kw,
                                            monkeypatch):
    """Groups of 1, 5 and 33 queries, each on the slots its launch gives
    it (one pass of 8; two of 32 and 16, or three of 16 and 16 and 1):
    each query's tie-safe values are those of the query alone, and its
    pairs above each lane's floor."""
    monkeypatch.setattr(pkernel, "_device_info", lambda dev: (132, 232448))
    eng, cfg = _engine(coo, **{**CODECS[codec], **kw}, tie_safe_topk=True)
    P = cfg.num_partitions
    alone = _batch_plain(eng, cfg, _tables(cfg, queries))
    seen = set()
    for n in (1, 5, 33):
        _, qp, passes, slots = pkernel.k8_launch(torch.device("cuda", 0),
                                                 cfg, n, P)
        seen.add((passes, slots))
        sv, st = _slots_plain(eng, cfg, _tables(cfg, queries[:n]), slots)
        _lanes_equal(sv, st, alone[0][:n], alone[1][:n], np.min)
    assert len(seen) == 2   # 33 queries take more passes, so fewer slots


# ------------------------------------------------------------ pass tables

def _bits(a):
    return np.ascontiguousarray(a).view(np.uint32)


def float_pass_table(tables, qp):
    """(nq, rows, 128) tables (f32 or int32; nq <= qp) -> the pass table as
    a block's shared memory holds it (csrc/codecs.cuh::FloatPass): entry e
    in S = qp / 4 16-byte words, word r (queries 4r .. 4r + 3) at 16-byte
    index e S + (r ^ swizzle(e)), swizzle(e) = (e // (8 // S)) % S; uint32
    bits, 0 past nq."""
    nq, rows, _ = tables.shape
    cols = rows * 128
    S = qp // 4
    e = np.arange(cols)
    sw = (e // (8 // S)) % S
    tab = np.zeros(cols * qp, np.uint32)
    for j in range(nq):
        tab[(e * S + ((j // 4) ^ sw)) * 4 + j % 4] = _bits(
            tables[j].reshape(-1))
    return tab


def float_pass_products(words, tab, codec, rows, qp):
    """The kernel's products of each word for each query of the pass
    (FloatPass::add_word: the codec's decode once, the entry of each query
    read from the pass table): (qp, words) float32."""
    u = np.asarray(words, np.uint32).astype(np.uint64)
    val = ((u & 0xFFFF) << 16).astype(np.uint32).view(np.float32)
    if codec == "f32":
        col = u >> 16
        idx = np.where((col >> 7) < rows, col, col & 0x7F)
    elif codec == "int8x4":
        row = u >> 25
        idx = np.where(row < rows, row, 0) * 128 + ((u >> 16) & 0x7F)
        sh = (u >> 20) & 24
    else:
        row = ((u >> 31) & 1) * (rows > 1)
        idx = row * 128 + ((u >> 16) & 0x7F)
        a = (u >> 24) & 31
        shift = pkernel.SIGN_SHIFTS[codec]
    S = qp // 4
    sw = (idx // (8 // S)) % S
    out = np.zeros((qp, len(u)), np.float32)
    for j in range(qp):
        entry = tab[((idx * S + ((j // 4) ^ sw)) * 4 + j % 4).astype(np.int64)]
        if codec == "f32":
            q = entry.view(np.float32)
        elif codec == "int8x4":
            q = (((entry.astype(np.uint64) >> sh) & 0xFF).astype(np.int64)
                 - 128).astype(np.float32)
        else:
            shifted = (entry.astype(np.uint64) << a) & 0xFFFFFFFF
            q = (shifted.astype(np.uint32).view(np.int32) >> shift).astype(
                np.float32)
        out[j] = val * q
    return out


def _words(rng, codec, n, rows):
    """n random words of a one-nnz codec: a bf16 value and a column field
    reaching past the table's rows (the decode's fallback to row 0)."""
    value = _bits(rng.standard_normal(n).astype(np.float32)) >> 16
    if codec == "f32":
        field = rng.integers(0, rows * 128 + 256, n)
    elif codec == "int8x4":
        field = rng.integers(0, (rows + 1) * 512, n)
    else:   # the sign layout: a lane, a shift, a row bit
        field = (rng.integers(0, 128, n) | (rng.integers(0, 32, n) << 8)
                 | (rng.integers(0, 2, n) << 15))
    return (value | (field.astype(np.uint32) << 16)).astype(np.uint32)


@pytest.mark.parametrize("nq", ["full", "short"])
@pytest.mark.parametrize("qp", [8, 16])
@pytest.mark.parametrize("codec,cols", [
    ("f32", 1024), ("f32", 1536), ("int8x4", 1536), ("i8s", 1024),
    ("i8s", 512), ("i4s", 2048)])
def test_float_pass_table_gives_each_querys_products(codec, cols, qp, nq):
    """The pass table decoded for every query of a pass of 8 or 16 (full,
    or 3 short) gives the codec's products bit for bit; queries past the
    pass's count decode a table of zeros."""
    rng = np.random.default_rng(qp + cols)
    n = qp if nq == "full" else qp - 3
    qs = rng.standard_normal((n, cols)).astype(np.float32)
    tables = ppack_tables(qs, codec)[0]
    rows = tables.shape[1]
    tab = float_pass_table(tables, qp)
    S, e = qp // 4, np.arange(tables[0].size)
    where = [(e * S + ((j // 4) ^ ((e // (8 // S)) % S))) * 4 + j % 4
             for j in range(qp)]
    assert np.unique(where).size == len(tab)   # one place each
    words = _words(rng, codec, 4000, rows)
    got = float_pass_products(words, tab, codec, rows, qp)
    prod = pkernel.codec_prod(codec)
    w = torch.from_numpy(words.view(np.int32))
    for j in range(qp):
        want = prod(w, torch.from_numpy(
            tables[j] if j < n else np.zeros_like(tables[0]))).numpy()
        np.testing.assert_array_equal(_bits(got[j]), _bits(want))


def test_float_pass_table_spreads_each_gather_over_the_bank_groups():
    """The r-th 16-byte gather of an entry lands on 16-byte bank group
    (e S + (r ^ swizzle(e))) % 8: over the entries every group takes the
    same share, for every r and pass (e S alone reaches 8 / S groups)."""
    for qp in (8, 16):
        S = qp // 4
        e = np.arange(4096)
        for r in range(S):
            group = (e * S + (r ^ ((e // (8 // S)) % S))) % 8
            assert np.bincount(group, minlength=8).tolist() == [512] * 8


@pytest.mark.parametrize("qp", [8, 16, 32])
@pytest.mark.parametrize("short", [False, True])
def test_h16_pass_table_gives_each_querys_sums(qp, short):
    """h16 passes of 8, 16 and 32 read K6 h16's table (``repack``) with
    their queries in its first qp / 8 words and the rest 0 (a query past
    the pass's count is a table of zero nibbles): the packed sums, bias
    and nibble packing included, are each query's plain int32 sums, and 0
    past the pass's count."""
    rng = np.random.default_rng(qp)
    n = qp - 5 if short else qp
    nib = rng.integers(-8, 8, (32, 128, 8))
    nib[n:] = 0
    tables = (((nib & 0xF).astype(np.uint64)
               << (4 * np.arange(8, dtype=np.uint64))).sum(-1)
              .astype(np.uint32).view(np.int32))
    cols = rng.integers(0, 1024, (3000, 2))
    vals = rng.integers(-32, 32, (3000, 2))
    half = (cols | ((vals & 0x3F) << 10)).astype(np.uint32)
    words = half[:, 0] | (half[:, 1] << 16)
    got = packed_sums(words, repack(tables))[:qp]
    want = plain_sums(words, tables)[:qp]
    np.testing.assert_array_equal(got, want)
    assert not got[n:].any()


# ------------------------------------------------------------ deal, grid

@pytest.mark.parametrize("num_slots", [1, 33, 66, 1000])
@pytest.mark.parametrize("codec,kw", [
    ("h16", {}), ("f32", dict(fused_block_sublanes=32, num_partitions=2))],
    ids=["h16", "f32_wide_p2"])
def test_k8_deal(coo, codec, kw, num_slots):
    """K8's deal is K7's at fold_tile 1 (``k7_deal``): on each partition
    the slots take contiguous runs that cover every item with a real
    member once, and no slot does more than the mean and the largest
    item's work."""
    eng, cfg = _engine(coo, **{**CODECS[codec], **kw})
    P = cfg.num_partitions
    for nreal in eng.nreal.reshape(P, -1):
        _, work = pkernel.k7_item_work(eng.plan_rows, nreal, 1)
        slot = pkernel.k7_deal(eng.plan_rows, nreal, num_slots, 1).numpy()
        assert len(slot) == len(work) == pkernel.slice_work_items(
            eng.plan_rows, 1)
        assert (np.diff(slot) >= 0).all() and slot.min() >= 0 and \
            slot.max() < num_slots
        per_slot = np.bincount(slot, weights=work, minlength=num_slots)
        assert per_slot.sum() == work.sum()
        assert per_slot.max() <= work.sum() / num_slots + work.max()


def test_k8_launch_shapes(monkeypatch):
    """Passes of the fewest queries that hold the group (h16 8, 16, 32;
    the others 8, or 16 past 8), blocks of 64 lanes (32 for h16 at lane_k
    16 and the others past 128 entries a lane), one an SM: slots are the
    SMs over the lane groups, partitions and passes. f32 and int8x4
    tables that do not fit beside the buffers take passes of 8, then
    global memory. ``batch_subgroup`` changes nothing."""
    monkeypatch.setattr(pkernel, "_device_info", lambda dev: (132, 232448))
    dev = torch.device("cuda", 0)

    def launch(Q, P=1, **kw):
        return pkernel.k8_launch(dev, pt.TopKSpMVConfig(**dict(
            k=100, **kw)), Q, P)

    h16 = dict(query_codec="h16", width_quantum=2)
    assert launch(32, **h16) == ("h16", 32, 1, 66)
    assert launch(33, **h16) == ("h16", 32, 2, 33)
    assert launch(5, **h16) == ("h16", 8, 1, 66)
    assert launch(12, **h16) == ("h16", 16, 1, 66)
    assert launch(32, lane_k=16, **h16) == ("h16", 32, 1, 33)
    assert launch(8) == ("f32", 8, 1, 66)
    assert launch(8, 2) == ("f32", 8, 1, 33)
    assert launch(32) == ("f32", 16, 2, 33)
    assert launch(32, lane_k=16) == ("f32", 16, 2, 16)
    assert launch(32, query_codec="i4s") == ("i4s", 16, 2, 33)
    assert launch(8, query_codec="int8x4", batch_subgroup=2) == \
        launch(8, query_codec="int8x4") == ("int8x4", 8, 1, 66)
    # 2048 columns: 16 f32 rows, a pass of 16 no longer fits beside the
    # buffers, 8 does; 16,384 and 65,536 columns: global memory
    assert launch(16, max_cols=2048) == ("f32", 8, 2, 33)
    assert launch(5, max_cols=16384) == ("f32_global", 8, 1, 66)
    assert launch(33, max_cols=65536) == ("f32_global", 8, 5, 13)
    # int8x4: 16,384 columns (32 rows) in passes of 8, from 32,768 (64
    # rows) up to its 65,536 from global memory
    q8 = dict(query_codec="int8x4", width_quantum=4)
    assert launch(16, max_cols=4096, **q8) == ("int8x4", 16, 1, 66)
    assert launch(16, max_cols=16384, **q8) == ("int8x4", 8, 2, 33)
    assert launch(16, max_cols=32768, **q8) == ("int8x4_global", 8, 2, 33)
    assert launch(5, max_cols=65536, **q8) == ("int8x4_global", 8, 1, 66)
    for codec in pkernel.KERNEL_CODECS:
        for qp in pkernel.K8_PASS_QUERIES[codec]:
            for k in pkernel.KERNEL_LANE_K:
                rows = 1 if codec == "h16" else 8
                assert pkernel.k8_smem_bytes(codec, qp, k, rows) <= 232448
    with pytest.raises(ValueError, match="takes"):
        pkernel.k8_pass("f32", 8, 8, 8, 232448, pass_queries=32)


@pytest.mark.parametrize("block_sublanes", [2, 6, 1022])
def test_k8_refuses_blocks_of_partial_load_batches(coo, queries,
                                                   block_sublanes):
    """K8 reads a member's rows in batches of K8_UNROLL and closes a wide
    slice's block sums after them: its launch refuses blocks that do not
    hold whole batches before it touches a tensor."""
    eng, cfg = _engine(coo)
    with pytest.raises(ValueError, match="multiple of 4"):
        pkernel._slice_topk_batch_cuda(eng.words, _tables(cfg, queries[:2]),
                                       eng.nreal, eng.plan_rows, 1, 0, cfg,
                                       block_sublanes)
