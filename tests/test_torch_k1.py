"""K1 as its kernel computes it, on the kernel's slots
(``octet_topk_slots_plain``, the plain version of csrc/octet_topk.cuh with
its lane merge on the card), on the CPU:

  - against ``octet_topk_plain`` (the plain version the other tests hold
    to the JAX package) on 1, 3, 64 and 4096 slots, every codec, fold 1
    and P = 3 partitions, tie-safe buffers: per-lane sorted values bit
    for bit, (value, tag) pairs equal above each lane's smallest kept
    value (which tied candidate takes that last place depends on the
    slots);
  - with one slot, against the JAX package's one-call K1 in interpret
    mode (``octet_multicall=False``: one buffer carried over the octets
    in order, the same computation), tie-safe and not: h16 and i4s bit
    for bit, f32 to rtol 1e-6 (XLA on the CPU contracts some of the
    interpret-mode kernel's multiply-adds into FMAs, ROADMAP Queue 3);
    tags above each lane's smallest finite kept value (the JAX kernel
    harvests its blocks' padding octets at -inf, which moves the tags of
    a tie-safe buffer's -inf entries);
  - each slot's buffer (``merged=False``) against a sequential emulation
    of the kernel's walk (csrc/octet_topk.cuh: slot s of S sweeps the
    octets from the first whose work's midpoint reaches s C / S to the
    first reaching (s + 1) C / S, C the partition's work, an octet's its
    width plus K1_OCTET_COST, 0 if it holds no real member), production
    and tie-safe buffers, on one and three partitions;
  - ``k1_deal`` against the same walk, at octet costs 0-2;
  - ``octet_grid``'s shapes.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import spmv_topk_tpu.config as jcfg
from spmv_topk_tpu.formats import create_sparse_matrix as jax_matrix
from spmv_topk_tpu.formats.sell_buckets import (fuse_buckets_octet as jfuse,
                                                pack_sell_buckets as jpack)
from spmv_topk_tpu.ops import kernel as jkernel
from spmv_topk_tpu.ops.quantized_query import pack_query_table

import spmv_topk_tpu_torch as pt
from spmv_topk_tpu_torch.formats import (create_query_batch,
                                         create_sparse_matrix)
from spmv_topk_tpu_torch.ops import kernel as pkernel

ROWS, COLS = 3000, 1024
OCTET = dict(k=100, lane_k=8, max_cols=COLS, query_codec="h16",
             fused_layout="octet", width_quantum=2, fold_tile=8,
             block_sublanes=64, fused_block_sublanes=128,
             octet_multicall=False)
# the JAX one-call K1's cases: 32-row blocks make wide octets
ONE_CALL = {"h16": dict(),
            "h16_fold1_wide": dict(fold_tile=1, fused_block_sublanes=32),
            "i4s": dict(query_codec="i4s"),
            "f32": dict(query_codec="f32")}
CODECS = ("h16", "f32", "int8x4", "i8s", "i4s")


def _cfg(**kw):
    return {**OCTET, **kw}


@pytest.fixture(scope="module")
def coo():
    return create_sparse_matrix(ROWS, COLS, 20, "gamma", seed=5)


@pytest.fixture(scope="module")
def query():
    return create_query_batch(1, COLS, seed=3)[0]


@pytest.fixture(scope="module")
def jax_one_call(query):
    """The JAX one-call K1 of each ONE_CALL case, tie-safe and not:
    (words, table, nreal, plan rows, values, tags)."""
    jcoo = jax_matrix(ROWS, COLS, 20, "gamma", seed=5)
    out = {}
    for name, kw in ONE_CALL.items():
        cfg = jcfg.TopKSpMVConfig(**_cfg(**kw))
        f = jfuse(jpack(jcoo, cfg), block_sublanes=cfg.fused_block_sublanes)
        table, _ = pack_query_table(query, cfg.query_codec)
        rows = pkernel.octet_plan_rows(f.plan, f.num_blocks)
        for tie_safe in (False, True):
            tcfg = jcfg.TopKSpMVConfig(**_cfg(**kw, tie_safe_topk=tie_safe))
            tv, tt = jkernel.topk_spmv_fused_octet_device(
                jnp.asarray(f.words), jnp.asarray(table),
                jnp.asarray(f.nreal), cfg=tcfg, plan=f.plan,
                block_sublanes=f.block_sublanes, num_blocks=f.num_blocks,
                interpret=True, codec=cfg.query_codec)
            out[name, tie_safe] = (f.words, table, f.nreal, rows,
                                   np.asarray(tv), np.asarray(tt))
    return out


def _engine(coo, **kw):
    cfg = pt.TopKSpMVConfig(**_cfg(rescore_pool=None, **kw))
    return pt.TopKSpMV(coo, cfg, device="cpu"), cfg


def _slots_plain(eng, cfg, table, num_slots, merged=True):
    return pkernel.octet_topk_slots_plain(
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
    ("h16", 3, dict(fold_tile=1)), ("f32", 64, dict(fold_tile=1)),
    ("int8x4", 3, dict(fold_tile=1, fused_block_sublanes=32))]


@pytest.mark.parametrize(
    "codec,num_slots,kw", SLOT_CASES,
    ids=[f"{c}_{n}slots" + "".join(f"_{k}{v}" for k, v in kw.items())
         for c, n, kw in SLOT_CASES])
def test_slots_plain_matches_octet_topk_plain(coo, query, codec, num_slots,
                                              kw):
    """Tie-safe slots merged give each lane its top lane_k of all the
    candidates: the values of ``octet_topk_plain``, bit for bit, and its
    pairs above each lane's floor."""
    eng, cfg = _engine(coo, query_codec=codec, tie_safe_topk=True, **kw)
    table, _ = eng._table(query)
    sv, st = _slots_plain(eng, cfg, table, num_slots)
    pv, pt_ = pkernel.octet_topk_plain(
        eng.words, table, eng.nreal, eng.plan_rows, lane_k=cfg.lane_k,
        fold_tile=cfg.fold_tile, tie_safe=True,
        block_sublanes=cfg.fused_block_sublanes, codec=codec,
        **eng.partition_kw)
    P = cfg.num_partitions
    assert sv.shape == pv.shape == (*((P,) if P > 1 else ()), 8, 128)
    assert np.isfinite(pv.numpy()).any()
    _lanes_equal(sv, st, pv, pt_, np.min)


@pytest.mark.parametrize("tie_safe", [False, True])
@pytest.mark.parametrize("name", list(ONE_CALL))
def test_one_slot_matches_jax_one_call(jax_one_call, name, tie_safe):
    """One slot carries one buffer over the octets in order, as the JAX
    one-call kernel does: the same entries."""
    words, table, nreal, rows, jv, jt = jax_one_call[name, tie_safe]
    kw = _cfg(**ONE_CALL[name])
    sv, st = pkernel.octet_topk_slots_plain(
        torch.from_numpy(words), torch.from_numpy(table),
        torch.from_numpy(nreal), torch.from_numpy(rows), num_slots=1,
        lane_k=kw["lane_k"], fold_tile=kw["fold_tile"], tie_safe=tie_safe,
        block_sublanes=kw["fused_block_sublanes"], codec=kw["query_codec"])
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
                 rtol=1e-6 if kw["query_codec"] == "f32" else 0.0)


def _walk(slot, num_slots, work):
    """The octets of slot ``slot``'s run in csrc/octet_topk.cuh
    (``slot_walk``): from the first octet whose work's midpoint (``work``:
    each octet's) reaches slot C / num_slots to the first reaching (slot +
    1) C / num_slots, C all the work."""
    total = sum(work)

    def first(s):
        before = 0
        for o, w in enumerate(work):
            if (2 * before + w) * num_slots >= 2 * s * total:
                return o
            before += w
        return len(work)

    return list(range(first(slot), first(slot + 1)))


def _emulate_slots(words, nreal, plan_rows, cfg, table, num_slots,
                   tag_offset):
    """Each slot's buffer of one partition's stream, sorted, by a
    sequential walk (the kernel's): (slots, lane_k, 128) values, tags."""
    K, S, L = cfg.lane_k, 8, 128
    # (sums (8, 128), real members (8,), tag of member 0, stride, width)
    octs = []
    for b, row in enumerate(plan_rows.tolist()):
        G, base, n_real = row[3], row[4] + tag_offset, int(nreal[b])
        sums = torch.cat([x for _, x in pkernel._octet_sums(
            words, table, row, cfg.fused_block_sublanes, S,
            cfg.query_codec)]).float().numpy()
        for o in range(G):
            octs.append((sums[o], o + np.arange(S) * G < n_real, base + o, G,
                         row[0]))
    init = (np.full(K, -np.inf, np.float32) if cfg.tie_safe_topk
            else pkernel.topk_init(K))
    out_v, out_t = [], []
    for slot in range(num_slots):
        v = np.repeat(init[:, None], L, axis=1)
        t = np.zeros((K, L), np.int32)
        for g in _walk(slot, num_slots,
                       [w + pkernel.K1_OCTET_COST if real[0] else 0
                        for _, real, _, _, w in octs]):
            sums, real, tag0, G, _ = octs[g]
            if not real[0]:
                continue   # skeleton padding: the walk skips it
            sc = np.where(real[:, None], sums, -np.inf)
            if cfg.fold_tile == 1:
                cands = [(sc[m], tag0 + m * G) for m in range(S)]
            else:
                cands = []
                for _ in range(3):
                    m1 = sc.max(axis=0)
                    sl = np.argmax(sc == m1, axis=0)
                    cands.append((m1, tag0 + sl * G))
                    sc[sl, np.arange(L)] = -np.inf
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
@pytest.mark.parametrize("num_slots,kw", [
    (3, {}), (5, dict(fold_tile=1)), (4, dict(num_partitions=3)),
    (2, dict(codec="i8s", fused_block_sublanes=32))],
    ids=["3slots", "5slots_fold1", "4slots_p3", "2slots_i8s_wide"])
def test_slots_plain_follows_the_kernels_walk(coo, query, num_slots, kw,
                                             tie_safe):
    """Each slot's buffer before the merge, bit for bit and tags included,
    against a sequential emulation of the kernel's walk over each
    partition's octets (contiguous runs of about equal real chunks)."""
    kw = dict(kw)
    eng, cfg = _engine(coo, query_codec=kw.pop("codec", "h16"),
                       tie_safe_topk=tie_safe, **kw)
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


@pytest.mark.parametrize("octet_cost", [0, 1, 2])
@pytest.mark.parametrize("num_slots", [1, 3, 64, 512])
def test_k1_deal_is_the_kernels_walk(coo, num_slots, octet_cost):
    """``k1_deal`` (the deal the slot plain and chip_smoke.py's balance
    read) puts each real octet in the slot whose sequential walk holds it,
    at the kernel's octet cost and at others, on each of three partitions
    (wide octets and padding octets included)."""
    eng, _ = _engine(coo, fused_block_sublanes=32, num_partitions=3)
    padding = False
    for nreal in eng.nreal.reshape(3, -1):
        chunks = pkernel.octet_real_chunks(eng.plan_rows, nreal).tolist()
        padding |= not all(chunks)
        slot = pkernel.k1_deal(eng.plan_rows, nreal, num_slots,
                               octet_cost=octet_cost).tolist()
        work = [c + octet_cost if c else 0 for c in chunks]
        for s in range(num_slots):
            assert ([g for g in _walk(s, num_slots, work) if chunks[g]]
                    == [g for g, x in enumerate(slot)
                        if x == s and chunks[g]])
    assert padding


def test_octet_grid_shapes():
    """One wave of K1_GROUPS-slot blocks shared among the partitions, at
    least one block, no more than a partition's chunks need."""
    assert pkernel.K1_GROUPS == 4
    assert pkernel.octet_grid(132) == (132, 528)
    assert pkernel.octet_grid(132, 2) == (66, 264)
    assert pkernel.octet_grid(132, 3, per_sm=2) == (88, 352)
    assert pkernel.octet_grid(132, 1, per_sm=2, chunks=10_000) == (264, 1056)
    assert pkernel.octet_grid(132, 1, chunks=10) == (3, 12)
    assert pkernel.octet_grid(132, 200) == (1, 4)
    assert pkernel.octet_grid(132, 1, chunks=1) == (1, 4)
