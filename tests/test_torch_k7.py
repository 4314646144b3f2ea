"""K7 as its kernel computes it, on the kernel's slots
(``slice_topk_slots_plain``, the plain version of csrc/slice_topk.cuh with
its lane merge on the card), and K3's plain version, on the CPU:

  - against ``slice_topk_plain`` (the plain version the other tests hold
    to the JAX package) on 1, 3, 64 and 4096 slots, every codec, P = 3
    partitions, fold 1, 2 and 8, wide slices, tie-safe buffers: per-lane
    sorted values bit for bit, (value, tag) pairs equal above each lane's
    smallest kept value (which tied candidate takes that last place
    depends on the slots);
  - with one slot, against the JAX package's K7 in interpret mode (one
    buffer carried over the work items in order, the same computation),
    tie-safe: h16 and i8s on integer-valued data bit for bit, f32 on the
    corpus's real values to rtol 1e-6 (the JAX kernel adds two
    interleaved accumulators and then a chunk's rows, the port a slice's
    rows in order, ROADMAP Queue 3); tags above each lane's smallest
    finite kept value (the JAX kernel harvests its blocks' padding slices
    at -inf, which moves the tags of a tie-safe buffer's -inf entries);
  - each slot's buffer (``merged=False``) against a sequential emulation
    of the kernel's walk (slot s of S sweeps the items from the first
    whose work's midpoint reaches s C / S to the first reaching (s + 1) C
    / S, C the partition's work, an item's its real members' rows in whole
    chunks of 8 plus K7_ITEM_COST, 0 with no real member), production and
    tie-safe
    buffers, on one and three partitions;
  - ``k7_deal`` against the same walk: contiguous runs that cover every
    item with a real member once, no slot more than the largest item's
    work above the mean;
  - ``slice_topk_grid``'s shapes (K1's grid, ``octet_grid``);
  - K3's plain version (``stream_words_plain``) against the JAX
    package's interpret-mode stream probe on 1, 3 and 1057 chunks of
    words near the int32 limits (the sums wrap).

The items are enumerated here from ``slice_work`` (held to the JAX
kernel's tiling by tests/test_torch_slice.py), apart from the port's own
enumeration (``ops/kernel.py::_slice_items``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import spmv_topk_tpu.config as jcfg
from spmv_topk_tpu.formats import CooMatrix as JCoo
from spmv_topk_tpu.formats import create_sparse_matrix as jax_matrix
from spmv_topk_tpu.formats.sell_buckets import (fuse_buckets as jfuse,
                                                pack_sell_buckets as jpack)
from spmv_topk_tpu.ops import kernel as jkernel
from spmv_topk_tpu.ops.quantized_query import pack_query_table
from spmv_topk_tpu.ops.streamprobe import stream_words_device as jstream

import spmv_topk_tpu_torch as pt
from spmv_topk_tpu_torch.formats import (CooMatrix, create_query_batch,
                                         create_sparse_matrix)
from spmv_topk_tpu_torch.ops import kernel as pkernel
from spmv_topk_tpu_torch.ops import streamprobe as pstream

ROWS, COLS = 3000, 1024
GEOM = dict(block_sublanes=64, fused_block_sublanes=128)
# each codec's engine: bench.py's slice batch engine (h16, quantum 2,
# fold 8), the default (f32, quantum 8, fold 1), c3's geometry
# (quantum 4, fold 1) for the quantized codecs
CODECS = {"h16": dict(query_codec="h16", width_quantum=2, fold_tile=8),
          "f32": dict(),
          "int8x4": dict(query_codec="int8x4", width_quantum=4),
          "i8s": dict(query_codec="i8s", width_quantum=4),
          "i4s": dict(query_codec="i4s", width_quantum=4)}
# the JAX K7's cases, tie-safe: (codec config, integer-valued data);
# 32-row blocks make wide slices
ONE_SLOT = {"h16_fold8": (CODECS["h16"], False),
            "h16_fold1_wide": (dict(CODECS["h16"], fold_tile=1,
                                    fused_block_sublanes=32), False),
            "f32": (CODECS["f32"], False),
            "i8s_int": (CODECS["i8s"], True)}


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
def query():
    return create_query_batch(1, COLS, seed=3)[0]


@pytest.fixture(scope="module")
def jax_k7(query):
    """The JAX K7 of each ONE_SLOT case: (words, table, nreal, plan rows,
    values, tags)."""
    jcoo = jax_matrix(ROWS, COLS, 20, "gamma", seed=5)
    out = {}
    for name, (kw, integer) in ONE_SLOT.items():
        cfg = jcfg.TopKSpMVConfig(**_cfg(**kw, tie_safe_topk=True))
        f = jfuse(jpack(_integer_valued(jcoo, JCoo) if integer else jcoo,
                        cfg), block_sublanes=cfg.fused_block_sublanes)
        table, _ = pack_query_table(query, cfg.query_codec)
        tv, tt = jkernel.topk_spmv_fused_device(
            jnp.asarray(f.words), jnp.asarray(table), jnp.asarray(f.nreal),
            cfg=cfg, plan=f.plan, block_sublanes=f.block_sublanes,
            num_blocks=f.num_blocks, interpret=True, codec=cfg.query_codec)
        rows = pkernel.slice_plan_rows(f.plan, f.num_blocks, f.nreal,
                                       f.block_sublanes)
        out[name] = (f.words, table, f.nreal, rows, np.asarray(tv),
                     np.asarray(tt))
    return out


def _engine(coo, **kw):
    cfg = pt.TopKSpMVConfig(**_cfg(**kw))
    return pt.TopKSpMV(coo, cfg, device="cpu"), cfg


def _slots_plain(eng, cfg, table, num_slots, merged=True):
    return pkernel.slice_topk_slots_plain(
        eng.words, table, eng.nreal, eng.plan_rows, num_slots=num_slots,
        lane_k=cfg.lane_k, fold_tile=cfg.fold_tile,
        tie_safe=bool(cfg.tie_safe_topk),
        block_sublanes=cfg.fused_block_sublanes, codec=cfg.query_codec,
        merged=merged, **eng.partition_kw)


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


SLOT_CASES = [(c, n, {}) for c in CODECS for n in (1, 3, 64, 4096)] + [
    ("h16", 3, dict(num_partitions=3)), ("i4s", 64, dict(num_partitions=3)),
    ("h16", 3, dict(fold_tile=1)), ("f32", 64, dict(fold_tile=8)),
    ("i8s", 64, dict(fold_tile=2)), ("f32", 3, dict(fused_block_sublanes=32)),
    ("int8x4", 64, dict(fold_tile=4, fused_block_sublanes=32,
                        num_partitions=3))]


@pytest.mark.parametrize(
    "codec,num_slots,kw", SLOT_CASES,
    ids=[f"{c}_{n}slots" + "".join(f"_{k}{v}" for k, v in kw.items())
         for c, n, kw in SLOT_CASES])
def test_slots_plain_matches_slice_topk_plain(coo, query, codec, num_slots,
                                              kw):
    """Tie-safe slots merged give each lane its top lane_k of all the
    candidates: the values of ``slice_topk_plain``, bit for bit, and its
    pairs above each lane's floor."""
    eng, cfg = _engine(coo, **{**CODECS[codec], **kw}, tie_safe_topk=True)
    if kw.get("fused_block_sublanes") == 32:
        assert any(r[2] > 1 for r in eng.plan_rows.tolist())
    table, _ = eng._table(query)
    sv, st = _slots_plain(eng, cfg, table, num_slots)
    pv, pt_ = pkernel.slice_topk_plain(
        eng.words, table, eng.nreal, eng.plan_rows, lane_k=cfg.lane_k,
        fold_tile=cfg.fold_tile, tie_safe=True,
        block_sublanes=cfg.fused_block_sublanes, codec=cfg.query_codec,
        **eng.partition_kw)
    P = cfg.num_partitions
    assert sv.shape == pv.shape == (*((P,) if P > 1 else ()), 8, 128)
    assert np.isfinite(pv.numpy()).any()
    _lanes_equal(sv, st, pv, pt_, np.min)


@pytest.mark.parametrize("name", list(ONE_SLOT))
def test_one_slot_matches_jax(jax_k7, name):
    """One slot carries one buffer over the work items in order, as the
    JAX kernel does: the same entries."""
    words, table, nreal, rows, jv, jt = jax_k7[name]
    kw = _cfg(**ONE_SLOT[name][0])
    codec = kw.get("query_codec", "f32")
    sv, st = pkernel.slice_topk_slots_plain(
        torch.from_numpy(words), torch.from_numpy(table),
        torch.from_numpy(nreal), torch.from_numpy(rows), num_slots=1,
        lane_k=8, fold_tile=kw.get("fold_tile", 1), tie_safe=True,
        block_sublanes=kw["fused_block_sublanes"], codec=codec)
    if name.endswith("wide"):
        assert any(r[2] > 1 for r in rows.tolist())
    assert np.isfinite(sv.numpy()).any()

    def smallest_finite(x):
        fin = x[np.isfinite(x)]
        return fin.min() if fin.size else -np.inf

    _lanes_equal(-np.sort(-jv, axis=0), jt[np.argsort(-jv, axis=0,
                                                      kind="stable"),
                                            np.arange(128)],
                 sv, st, smallest_finite,
                 rtol=1e-6 if codec == "f32" else 0.0)


def _items(plan_rows, nreal, fold_tile):
    """Each item of one partition's plan in the kernels' order, from
    ``slice_work``: (bucket-relative member slices, real members, a
    sub-tile, its bucket)."""
    out = []
    for b, row in enumerate(plan_rows.tolist()):
        W, spb = row[0], row[1]
        mode, units, per, Gp, Ps, nper = pkernel.slice_work(row, fold_tile)
        for u in range(units):
            for gi in range(per):
                top2 = mode == pkernel.TILED and gi < Gp * Ps
                if mode == pkernel.WIDE:
                    members = [u]
                elif mode == pkernel.RUNS:
                    members = list(range(u * spb + gi * 8,
                                         u * spb + min(spb, gi * 8 + 8)))
                elif top2:
                    g, s = divmod(gi, Ps)
                    cnt = min(fold_tile, -(-(nper - g) // Gp))
                    members = [u * spb + Ps * (g + m * Gp) + s
                               for m in range(cnt)]
                else:
                    members = [u * spb + nper * Ps + gi - Gp * Ps]
                real = [m for m in members if m < nreal[b]]
                out.append((members, len(real), top2, b))
    return out


def _work(items, plan_rows, cost=pkernel.K7_ITEM_COST):
    """Each item's work in the kernel's deal: its real members' rows, each
    member's in whole chunks of 8, plus the item cost; 0 with none."""
    rows = plan_rows.tolist()
    return [nr * -(-rows[b][0] // 8) * 8 + cost if nr else 0
            for _, nr, _, b in items]


def _walk(slot, num_slots, work):
    """The items of slot ``slot``'s run in csrc/slice_topk.cuh
    (``slot_walk``): from the first item whose work's midpoint reaches
    slot C / num_slots to the first reaching (slot + 1) C / num_slots, C
    all the work."""
    total = sum(work)

    def first(s):
        before = 0
        for g, w in enumerate(work):
            if (2 * before + w) * num_slots >= 2 * s * total:
                return g
            before += w
        return len(work)

    return list(range(first(slot), first(slot + 1)))


def _emulate_slots(words, nreal, plan_rows, cfg, table, num_slots,
                   tag_offset):
    """Each slot's buffer of one partition's stream, sorted, by a
    sequential walk (the kernel's): (slots, lane_k, 128) values, tags."""
    K, L = cfg.lane_k, 128
    items = _items(plan_rows, nreal, cfg.fold_tile)
    rows = plan_rows.tolist()
    scores = [pkernel._bucket_scores(words, table, row, cfg.query_codec,
                                     cfg.fused_block_sublanes).numpy()
              for row in rows]
    init = (np.full(K, -np.inf, np.float32) if cfg.tie_safe_topk
            else pkernel.topk_init(K))
    out_v, out_t = [], []
    work = _work(items, plan_rows)
    for slot in range(num_slots):
        v = np.repeat(init[:, None], L, axis=1)
        t = np.zeros((K, L), np.int32)
        for g in _walk(slot, num_slots, work):
            members, nr, top2, b = items[g]
            if not nr:
                continue   # no real member: the walk skips it
            sc = scores[b][members[:nr]]   # (nr, 128)
            tags = np.asarray(members[:nr]) + rows[b][3] + tag_offset
            if top2:
                cands = []
                nan = np.isnan(sc).any(axis=0)
                for _ in range(min(nr, 2)):
                    m1 = sc.max(axis=0)
                    sl = np.argmax(sc == m1, axis=0)
                    cands.append((np.where(nan, np.nan, m1), tags[sl]))
                    sc = sc.copy()
                    sc[sl, np.arange(L)] = -np.inf
            else:
                cands = [(sc[m], tags[m]) for m in range(nr)]
            for score, tag in cands:
                cur = v.min(axis=0)
                hit = v == cur
                if cfg.tie_safe_topk:
                    hit = np.arange(K)[:, None] == np.argmax(hit, axis=0)
                rep = hit & (score >= cur)
                v = np.where(rep, score, v)
                t = np.where(rep, tag, t)
        order = np.lexsort((t, -v), axis=0)
        out_v.append(np.take_along_axis(v, order, 0))
        out_t.append(np.take_along_axis(t, order, 0))
    return np.stack(out_v), np.stack(out_t)


@pytest.mark.parametrize("tie_safe", [False, True])
@pytest.mark.parametrize("num_slots,codec,kw", [
    (3, "h16", {}), (5, "f32", {}), (4, "h16", dict(num_partitions=3)),
    (2, "i8s", dict(fused_block_sublanes=32, fold_tile=2))],
    ids=["3slots_h16", "5slots_f32", "4slots_h16_p3", "2slots_i8s_wide"])
def test_slots_plain_follows_the_kernels_walk(coo, query, num_slots, codec,
                                             kw, tie_safe):
    """Each slot's buffer before the merge, bit for bit and tags included,
    against a sequential emulation of the kernel's walk over each
    partition's items (contiguous runs of about equal work)."""
    eng, cfg = _engine(coo, **{**CODECS[codec], **kw}, tie_safe_topk=tie_safe)
    table, _ = eng._table(query)
    sv, st = _slots_plain(eng, cfg, table, num_slots, merged=False)
    P = cfg.num_partitions
    assert sv.shape == (P, num_slots, cfg.lane_k, 128)
    rows = eng.words.shape[0] // P
    for p in range(P):
        ev, et = _emulate_slots(
            eng.words[p * rows:(p + 1) * rows],
            eng.nreal.reshape(P, -1)[p].tolist(), eng.plan_rows, cfg, table,
            num_slots, p * eng.partition_kw.get("part_slices", 0))
        np.testing.assert_array_equal(sv[p].numpy(), ev)
        np.testing.assert_array_equal(st[p].numpy(), et)


@pytest.mark.parametrize("num_slots", [1, 3, 64, 512])
@pytest.mark.parametrize("codec,kw", [
    ("h16", dict(fused_block_sublanes=32, num_partitions=3)),
    ("f32", dict(fused_block_sublanes=32, num_partitions=2))],
    ids=["h16_wide_p3", "f32_wide_p2"])
def test_k7_deal_is_the_kernels_walk(coo, codec, kw, num_slots):
    """``k7_deal`` (the deal the slot plain and chip_smoke.py's balance
    read) puts each item with a real member in the slot whose sequential
    walk holds it, on each partition (wide slices and padding items
    included): the slots take contiguous runs that cover every such item
    once, and no slot does more than the mean and the largest item's
    work."""
    eng, cfg = _engine(coo, **{**CODECS[codec], **kw})
    P = cfg.num_partitions
    padding = False
    for nreal in eng.nreal.reshape(P, -1):
        items = _items(eng.plan_rows, nreal.tolist(), cfg.fold_tile)
        work = _work(items, eng.plan_rows)
        padding |= not all(work)
        slot = pkernel.k7_deal(eng.plan_rows, nreal, num_slots,
                               cfg.fold_tile).tolist()
        assert len(slot) == len(items)
        real = [g for g, w in enumerate(work) if w]
        assert all(a <= b for a, b in zip(slot, slot[1:]))   # contiguous
        walked = []
        for s in range(num_slots):
            run = [g for g in _walk(s, num_slots, work) if work[g]]
            assert run == [g for g in real if slot[g] == s]
            walked += run
            assert sum(work[g] for g in run) <= \
                sum(work) / num_slots + max(work)
        assert walked == real
    assert padding


def test_slice_topk_grid_shapes(monkeypatch):
    """K7's grid is K1's (``octet_grid``) on the occupancy API's resident
    blocks: one wave of K7_GROUPS-slot blocks shared among the partitions,
    at least one block, no more than a partition's chunks need."""
    assert pkernel.K7_GROUPS == pkernel.K1_GROUPS == 4
    seen = []

    def resident(dev, entry, *args):
        seen.append((entry, *args))
        return 2

    monkeypatch.setattr(pkernel, "_resident_blocks", resident)
    monkeypatch.setattr(pkernel, "_device_info", lambda dev: (132, 232448))
    monkeypatch.setattr(pkernel, "_KERNEL_CODEC", {})
    dev = torch.device("cuda", 0)
    cfg = pt.TopKSpMVConfig(k=100)
    assert pkernel.slice_topk_grid(dev, cfg, 10_000 * 8) == (264, 1056)
    assert pkernel.slice_topk_grid(dev, cfg, 10_000 * 8, 2) == (132, 528)
    assert pkernel.slice_topk_grid(dev, cfg, 40 * 8) == (10, 40)
    assert pkernel.slice_topk_grid(dev, cfg, 8, 3) == (1, 4)
    # (codec argument, lane_k, tie-safe, table rows): f32, 8 rows
    assert seen[0] == ("slice_topk_occupancy", 1, 8, 0, 8)


@pytest.mark.parametrize("block_sublanes", [4, 12, 1020])
def test_k7_refuses_blocks_of_partial_chunks(coo, query, block_sublanes):
    """K7 reads a member's rows in whole chunks of K7_CHUNK_ROWS and closes
    a wide slice's block sums after them: its launch refuses blocks that
    do not hold whole chunks before it touches a tensor."""
    eng, cfg = _engine(coo)
    table, _ = eng._table(query)
    with pytest.raises(ValueError, match="whole chunks"):
        pkernel._slice_topk_cuda(eng.words, table, eng.nreal, eng.plan_rows,
                                 1, 0, cfg, block_sublanes)


@pytest.mark.parametrize("chunks,block_chunks", [(1, 1), (3, 3), (1057, 7)])
def test_stream_plain_matches_jax(chunks, block_chunks):
    """K3's plain version against the JAX probe in interpret mode on
    words near the int32 limits and a salt varying by lane: the same
    wrapped int32 checksum."""
    rng = np.random.default_rng(chunks)
    words = rng.choice(np.array([2**31 - 1, -2**31, 2**31 - 2, -2**31 + 1,
                                 7, -3], np.int32), (chunks * 8, 128))
    salt = rng.integers(-2**31, 2**31, (1, 128)).astype(np.int32)
    want = np.asarray(jstream(jnp.asarray(words), jnp.asarray(salt),
                              block_sublanes=8 * block_chunks,
                              num_blocks=chunks // block_chunks,
                              interpret=True))
    got = pstream.stream_words_plain(torch.from_numpy(words),
                                     torch.from_numpy(salt))
    np.testing.assert_array_equal(got.numpy(), want)
    via_wrapper = pstream.stream_words_device(torch.from_numpy(words),
                                              torch.from_numpy(salt))
    np.testing.assert_array_equal(via_wrapper.numpy(), want)
