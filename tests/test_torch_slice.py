"""The port's slice layout (kernels K7, K8, K9 and the engines over it)
against the JAX package on the CPU.

The port runs the plain versions of its kernels here; the JAX package
runs its Pallas kernels in interpret mode, every program once, in the
module fixture. Tolerances:
  - h16: scores are int32 sums converted to f32 (once per slice, or per
    block of a wide slice and then added in f32 in block order in both
    packages), so per-lane values and ``scores()`` are bit-equal, and
    (value, slice) pairs equal above each lane's smallest kept value
    (tie-safe buffers; the replacement order decides the last slot);
  - f32 on integer-valued data (small integers, exact in bf16, every
    partial sum an exact f32): bit-equal as for h16;
  - f32 on the corpus's real values: the JAX kernel sums two interleaved
    accumulators and then the 8 rows of a chunk, the port in another
    order, so values agree to rtol 1e-6 (a few f32 roundings of sums of
    at most ~100 products; ``scores()`` adds atol 1e-6 for the sums that
    cancel to near 0), and index sets agree above the k-th value less
    that margin;
  - rescored query(): both packages re-rank the same pool with the same
    native csr_rescore, so indices are equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import spmv_topk_tpu as jt
import spmv_topk_tpu.config as jcfg
from spmv_topk_tpu.formats import CooMatrix as JCoo
from spmv_topk_tpu.formats import create_sparse_matrix as jax_matrix
from spmv_topk_tpu.formats.sell_buckets import (fuse_buckets as jfuse,
                                                pack_sell_buckets as jpack)
from spmv_topk_tpu.ops import kernel as jkernel
from spmv_topk_tpu.ops.quantized_query import (pack_query_table,
                                               pack_query_tables)

import spmv_topk_tpu_torch as pt
from spmv_topk_tpu_torch.formats import (CooMatrix, create_query_batch,
                                         create_sparse_matrix)
from spmv_topk_tpu_torch.formats.sell_buckets import (FusedBucket,
                                                      slice_plan_array)
from spmv_topk_tpu_torch.ops import kernel as pkernel
from spmv_topk_tpu_torch.ops.fixedpoint import bf16_bits

ROWS, COLS = 3000, 1024
GEOM = dict(block_sublanes=64, fused_block_sublanes=128)
# the default engine (TopKSpMVConfig(k=100): f32, quantum 8, fold 1) and
# bench.py's batch engine (h16, quantum 2, fold 8, pool 400)
DEFAULT = dict(k=100, **GEOM)
BENCH = dict(k=100, lane_k=8, max_cols=1024, query_codec="h16",
             fused_layout="slice", width_quantum=2, fold_tile=8,
             rescore_pool=400, **GEOM)
# kernel-level cases, tie-safe: (config, integer-valued data)
CASES = {
    # period widths (22, 14, 10, 6 are not multiples of 8), tiled fold
    "h16_fold8": (dict(BENCH, rescore_pool=None, tie_safe_topk=True), False),
    "h16_fold1": (dict(BENCH, rescore_pool=None, tie_safe_topk=True,
                       fold_tile=1), False),
    "f32_fold1": (dict(DEFAULT, tie_safe_topk=True), True),
    # 32-row blocks: the widest bucket spans blocks
    "h16_fold8_wide": (dict(BENCH, rescore_pool=None, tie_safe_topk=True,
                            fused_block_sublanes=32), False),
    # 2048-row blocks: the JAX kernel does not unroll the slice loops, so
    # it folds every slice despite fold 8
    "h16_fold8_unroll": (dict(BENCH, rescore_pool=None, tie_safe_topk=True,
                              fused_block_sublanes=2048), False),
}
QUERY_SEEDS = (11, 12, 13)


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _integer_valued(coo, jax_side):
    """The corpus with integer values in [-8, 8] (exact in bf16)."""
    vals = np.random.default_rng(7).integers(-8, 9, coo.nnz).astype(
        np.float32)
    cls = JCoo if jax_side else CooMatrix
    return cls(coo.rows, coo.cols, vals, coo.num_rows, coo.num_cols)


def _int_query(seed):
    return np.random.default_rng(seed).integers(-8, 9, COLS).astype(
        np.float32)


def _pack(kw, integer):
    """The JAX package's fused slice stream of the (integer-valued)
    corpus."""
    coo = jax_matrix(ROWS, COLS, 20, "gamma", seed=5)
    if integer:
        coo = _integer_valued(coo, jax_side=True)
    cfg = jcfg.TopKSpMVConfig(**kw)
    return cfg, jfuse(jpack(coo, cfg),
                      block_sublanes=kw["fused_block_sublanes"])


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("slice")
    out = dict(dir=d, cases={})
    # kernel level: K7 per case, K8 for Q=3 in subgroups of 2
    for name, (kw, integer) in CASES.items():
        cfg, f = _pack(kw, integer)
        q = _int_query(3) if integer else create_query_batch(1, COLS,
                                                             seed=3)[0]
        table, _ = pack_query_table(q, cfg.query_codec)
        tv, tt = jkernel.topk_spmv_fused_device(
            jnp.asarray(f.words), jnp.asarray(table), jnp.asarray(f.nreal),
            cfg=cfg, plan=f.plan, block_sublanes=f.block_sublanes,
            num_blocks=f.num_blocks, interpret=True, codec=cfg.query_codec)
        out["cases"][name] = (f, table, np.asarray(tv), np.asarray(tt))
    cfg, f = _pack(dict(CASES["h16_fold8"][0], batch_subgroup=2), False)
    tabs, _ = pack_query_tables(create_query_batch(3, COLS, seed=4), "h16")
    bv, bt = jkernel.topk_spmv_fused_batch_device(
        jnp.asarray(f.words), jnp.asarray(tabs), jnp.asarray(f.nreal),
        cfg=cfg, plan=f.plan, block_sublanes=f.block_sublanes,
        num_blocks=f.num_blocks, interpret=True, codec="h16")
    out["k8"] = (f, tabs, np.asarray(bv), np.asarray(bt))

    # engine level: query, query_batch, scores of both engines
    coo = create_sparse_matrix(ROWS, COLS, 20, "gamma", seed=5)
    jcoo = jax_matrix(ROWS, COLS, 20, "gamma", seed=5)
    qs = {s: create_query_batch(1, COLS, seed=s)[0] for s in QUERY_SEEDS}
    batch = np.stack(list(qs.values()))
    out.update(coo=coo, qs=qs, batch=batch, eng={})
    for name, kw in (("default", DEFAULT), ("bench", BENCH)):
        jeng = jt.TopKSpMV(jcoo, jt.TopKSpMVConfig(**kw))
        res = dict(jeng=jeng)
        res["q"] = {s: tuple(map(np.asarray, jeng.query(q)))
                    for s, q in qs.items()}
        res["qb"] = tuple(map(np.asarray, jeng.query_batch(batch,
                                                           group_size=2)))
        res["scores"] = {s: np.asarray(jeng.scores(q)) for s, q in qs.items()}
        jeng.save(str(d / f"{name}.npz"))
        out["eng"][name] = res
    # the port's snapshot of bench.py's engine, queried by the JAX package
    # (the same programs: the plan and config are equal)
    peng = pt.TopKSpMV(coo, pt.TopKSpMVConfig(**BENCH), device="cpu")
    peng.save(str(d / "port.npz"))
    jloaded = jt.TopKSpMV.load(str(d / "port.npz"), matrix=jcoo)
    out["jloaded_q"] = {s: tuple(map(np.asarray, jloaded.query(q)))
                        for s, q in qs.items()}
    # f32 scores on integer-valued data and queries
    jint = jt.TopKSpMV(_integer_valued(jcoo, True),
                       jt.TopKSpMVConfig(**DEFAULT))
    out["int_scores"] = np.asarray(jint.scores(_int_query(5)))
    return out


def _assert_lanes_match(jv, jt_, pv, pt_):
    np.testing.assert_array_equal(-np.sort(-jv, axis=0), pv)
    for lane in range(jv.shape[1]):
        floor = pv[:, lane].min()
        a = sorted(zip(jv[:, lane][jv[:, lane] > floor].tolist(),
                       jt_[:, lane][jv[:, lane] > floor].tolist()))
        b = sorted(zip(pv[:, lane][pv[:, lane] > floor].tolist(),
                       pt_[:, lane][pv[:, lane] > floor].tolist()))
        assert a == b, f"lane {lane}"


def _plan_rows(f):
    return torch.from_numpy(pkernel.slice_plan_rows(
        f.plan, f.num_blocks, f.nreal, f.block_sublanes))


@pytest.mark.parametrize("case", list(CASES))
def test_slice_plain_matches_pallas(ref, case):
    f, table, jv, jt_ = ref["cases"][case]
    kw = CASES[case][0]
    rows = _plan_rows(f)
    modes = {pkernel.slice_work(r, kw.get("fold_tile", 1))[0]
             for r in rows.tolist()}
    if case == "h16_fold8":
        assert modes == {pkernel.TILED}
        assert any(p.width % 8 for p in f.plan)
    if case == "h16_fold8_wide":
        assert pkernel.WIDE in modes and pkernel.TILED in modes
    if case == "h16_fold8_unroll":
        assert modes == {pkernel.RUNS}
    pv, pt_ = pkernel.slice_topk_plain(
        torch.from_numpy(f.words), torch.from_numpy(table),
        torch.from_numpy(f.nreal), rows, lane_k=8,
        fold_tile=kw.get("fold_tile", 1), tie_safe=True,
        block_sublanes=f.block_sublanes,
        codec=kw.get("query_codec", "f32"))
    assert pv.dtype == torch.float32 and pt_.dtype == torch.int32
    assert np.isfinite(pv.numpy()).all()
    _assert_lanes_match(jv, jt_, pv.numpy(), pt_.numpy())


def test_slice_batch_plain_matches_pallas(ref):
    """K8 folds every slice whatever fold_tile is; Q=3 in subgroups of 2."""
    f, tabs, jv, jt_ = ref["k8"]
    pv, pt_ = pkernel.slice_topk_batch_plain(
        torch.from_numpy(f.words), torch.from_numpy(tabs),
        torch.from_numpy(f.nreal), _plan_rows(f), lane_k=8, tie_safe=True,
        block_sublanes=f.block_sublanes, codec="h16")
    assert pv.shape == (3, 8, 128)
    for q in range(3):
        _assert_lanes_match(jv[q], jt_[q], pv[q].numpy(), pt_[q].numpy())


def test_wrappers_on_cpu_run_plain_without_launch(ref):
    """The wrappers take the plain versions because the tensors lie on
    the CPU; off the CPU they launch a kernel or raise."""
    f, table, jv, jt_ = ref["cases"]["h16_fold8"]
    cfg = pt.TopKSpMVConfig(**CASES["h16_fold8"][0])
    args = (torch.from_numpy(f.words), torch.from_numpy(table),
            torch.from_numpy(f.nreal), _plan_rows(f))
    counts = [w.launches for w in (pkernel.topk_spmv_fused_device,
                                   pkernel.topk_spmv_fused_batch_device,
                                   pkernel.spmv_fused_scores_device)]
    pv, pt_ = pkernel.topk_spmv_fused_device(*args, cfg=cfg,
                                             block_sublanes=128)
    _assert_lanes_match(jv, jt_, pv.numpy(), pt_.numpy())
    bv, _ = pkernel.topk_spmv_fused_batch_device(
        args[0], args[1][None], *args[2:], cfg=cfg, block_sublanes=128)
    assert bv.shape == (1, 8, 128)
    sc = pkernel.spmv_fused_scores_device(*args, cfg=cfg, block_sublanes=128,
                                          num_slices=f.row_ids.shape[0])
    assert sc.shape == (f.row_ids.shape[0], 128) and (sc[-1] == 0).all()
    assert counts == [w.launches for w in (
        pkernel.topk_spmv_fused_device, pkernel.topk_spmv_fused_batch_device,
        pkernel.spmv_fused_scores_device)]
    meta = dict(dtype=torch.int32, device="meta")
    margs = (torch.empty((128, 128), **meta), torch.empty((1, 128), **meta),
             torch.empty((1, 1), **meta), torch.empty((1, 6), **meta))
    with pytest.raises(ValueError, match="CUDA"):
        pkernel.topk_spmv_fused_device(*margs, cfg=cfg, block_sublanes=128)
    with pytest.raises(ValueError, match="CUDA"):
        pkernel.spmv_fused_scores_device(*margs, cfg=cfg, block_sublanes=128,
                                         num_slices=2)


@pytest.mark.parametrize("seed", QUERY_SEEDS)
def test_bench_engine_matches_reference(ref, seed):
    """bench.py's batch engine: rescored query() indices equal and
    scores() bit-equal (its un-rescored sweep with tie-safe buffers is
    test_slice_plain_matches_pallas[h16_fold8])."""
    peng = pt.TopKSpMV(ref["coo"], pt.TopKSpMVConfig(**BENCH), device="cpu")
    ji, jv = ref["eng"]["bench"]["q"][seed]
    pi, pv = map(_np, peng.query(ref["qs"][seed]))
    np.testing.assert_array_equal(ji, pi)
    np.testing.assert_allclose(jv, pv, rtol=1e-6)
    np.testing.assert_array_equal(ref["eng"]["bench"]["scores"][seed],
                                  _np(peng.scores(ref["qs"][seed])))


@pytest.mark.parametrize("seed", QUERY_SEEDS)
def test_default_engine_matches_reference(ref, seed):
    """TopKSpMVConfig(k=100): f32 codec, no rescore, non-tie-safe buffers
    (f32 scores of this corpus do not tie)."""
    peng = pt.TopKSpMV(ref["coo"], pt.TopKSpMVConfig(**DEFAULT),
                       device="cpu")
    assert not peng.config.tie_safe_topk and peng.config.query_codec == "f32"
    ji, jv = ref["eng"]["default"]["q"][seed]
    pi, pv = map(_np, peng.query(ref["qs"][seed]))
    np.testing.assert_allclose(jv, pv, rtol=1e-6)
    margin = pv[-1] + 1e-6 * np.abs(pv[-1])
    assert set(ji[jv > margin].tolist()) == set(pi[pv > margin].tolist())
    np.testing.assert_allclose(ref["eng"]["default"]["scores"][seed],
                               _np(peng.scores(ref["qs"][seed])), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("name", ["default", "bench"])
def test_query_batch_matches_reference(ref, name):
    kw = DEFAULT if name == "default" else BENCH
    peng = pt.TopKSpMV(ref["coo"], pt.TopKSpMVConfig(**kw), device="cpu")
    ji, jv = ref["eng"][name]["qb"]
    pi, pv = map(_np, peng.query_batch(ref["batch"], group_size=2))
    assert pi.shape == (3, 100)
    if name == "bench":                  # rescored: the same exact re-rank
        np.testing.assert_array_equal(ji, pi)
        return
    np.testing.assert_allclose(jv, pv, rtol=1e-6)
    for j in range(3):
        margin = pv[j, -1] + 1e-6 * np.abs(pv[j, -1])
        assert set(ji[j][jv[j] > margin].tolist()) == \
            set(pi[j][pv[j] > margin].tolist())


def test_f32_scores_bit_equal_on_integer_data(ref):
    coo = _integer_valued(ref["coo"], jax_side=False)
    peng = pt.TopKSpMV(coo, pt.TopKSpMVConfig(**DEFAULT), device="cpu")
    got = _np(peng.scores(_int_query(5)))
    np.testing.assert_array_equal(ref["int_scores"], got)
    assert (got == np.rint(got)).all() and np.abs(got).max() > 0


@pytest.mark.parametrize("name", ["default", "bench"])
def test_jax_snapshot_loads_in_port(ref, name):
    kw = DEFAULT if name == "default" else BENCH
    peng = pt.TopKSpMV.load(str(ref["dir"] / f"{name}.npz"), device="cpu",
                            matrix=ref["coo"])
    assert peng.config == pt.TopKSpMVConfig(**kw)
    assert all(isinstance(p, FusedBucket) for p in peng.fused.plan)
    built = pt.TopKSpMV(ref["coo"], pt.TopKSpMVConfig(**kw), device="cpu")
    np.testing.assert_array_equal(_np(peng.plan_rows), _np(built.plan_rows))
    seed = QUERY_SEEDS[0]
    for a, b in zip(peng.query(ref["qs"][seed]),
                    built.query(ref["qs"][seed])):
        np.testing.assert_array_equal(_np(a), _np(b))
    want = ref["eng"][name]["scores"][seed]
    got = _np(peng.scores(ref["qs"][seed]))
    if name == "bench":
        np.testing.assert_array_equal(want, got)
    else:
        np.testing.assert_allclose(want, got, rtol=1e-6, atol=1e-6)


def test_port_snapshot_loads_in_jax(ref):
    for seed in QUERY_SEEDS:
        np.testing.assert_array_equal(ref["jloaded_q"][seed][0],
                                      ref["eng"]["bench"]["q"][seed][0])
    with np.load(ref["dir"] / "port.npz") as z, \
            np.load(ref["dir"] / "bench.npz") as y:
        for name in ("words", "nreal", "row_ids", "plan", "meta"):
            np.testing.assert_array_equal(z[name], y[name])
        assert z["plan"].shape[1] == 6


def test_from_reference_arrays_takes_slice_plans(ref):
    jeng = ref["eng"]["bench"]["jeng"]
    f = jeng.fused
    meta = dict(config=dataclasses.asdict(jeng.config),
                block_sublanes=f.block_sublanes, num_blocks=f.num_blocks,
                num_rows=f.num_rows, num_cols=f.num_cols,
                num_nnz=f.num_nnz, value_scale=f.value_scale)
    plan = np.array([dataclasses.astuple(p) for p in f.plan], np.int64)
    assert plan.shape[1] == 6
    peng = pt.TopKSpMV.from_reference_arrays(
        f.words, f.nreal, f.row_ids, plan, meta, device="cpu",
        matrix=ref["coo"])
    np.testing.assert_array_equal(slice_plan_array(peng.fused.plan), plan)
    assert peng.hbm_bytes == jeng.hbm_bytes
    seed = QUERY_SEEDS[1]
    np.testing.assert_array_equal(ref["eng"]["bench"]["q"][seed][0],
                                  _np(peng(ref["qs"][seed])[0]))
    with pytest.raises(ValueError, match="columns"):
        pt.TopKSpMV.from_reference_arrays(
            f.words, f.nreal, f.row_ids, np.zeros((len(plan), 7), np.int64),
            meta, device="cpu")


def test_slice_plan_rows_reject_bad_plans(ref):
    f = ref["cases"]["h16_fold8"][0]
    rows = pkernel.slice_plan_rows(f.plan, f.num_blocks, f.nreal,
                                   f.block_sublanes)
    assert rows.dtype == np.int32 and rows.shape == (len(f.plan), 6)
    with pytest.raises(ValueError, match="blocks"):
        pkernel.slice_plan_rows(f.plan, f.num_blocks + 1, f.nreal,
                                f.block_sublanes)
    with pytest.raises(ValueError, match="expected"):
        pkernel.slice_plan_rows(f.plan[1:], f.num_blocks, f.nreal[1:],
                                f.block_sublanes)
    with pytest.raises(ValueError, match="need"):
        pkernel.slice_plan_rows(f.plan, f.num_blocks, f.nreal + 1000,
                                f.block_sublanes)
    with pytest.raises(ValueError, match="fit"):
        pkernel.slice_plan_rows(f.plan, f.num_blocks, f.nreal,
                                f.block_sublanes // 2)


@pytest.mark.parametrize("seed", [0, 1])
def test_prod_f32_matches_jax(seed):
    """f32 decode on random words (all 16-bit columns, so rows past the
    table too; bf16 values of normal floats, so no product is subnormal,
    where XLA's CPU flushes to zero) and a random 8-row table: exact, the
    JAX side with masked lanes (``_decode_val``, whose TPU bitcast only
    runs inside a kernel, as bitcast_convert_type, times
    ``_gather_from_bcs``)."""
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, 2**16, (8, 128)).astype(np.uint32)
    cols[0] &= 0x3FF                      # some columns inside the table
    vals = bf16_bits(rng.standard_normal((8, 128)).astype(np.float32))
    w = ((cols << 16) | vals.astype(np.uint32)).view(np.int32)
    tab = rng.standard_normal((8, 128)).astype(np.float32)
    bcs = [jnp.broadcast_to(jnp.asarray(tab[c:c + 1]), (8, 128))
           for c in range(8)]
    jw = jnp.asarray(w)
    val = jax.lax.bitcast_convert_type(jax.lax.shift_left(jw, 16),
                                       jnp.float32)
    want = np.asarray(val * jkernel._gather_from_bcs(bcs, jw, 8))
    got = pkernel.prod_f32(torch.from_numpy(w), torch.from_numpy(tab))
    np.testing.assert_array_equal(want, got.numpy())


def test_slice_work_items_cover_every_slice(ref):
    """Each real slice is a member of exactly one work item, for every
    fold_tile and geometry."""
    for name in CASES:
        f = ref["cases"][name][0]
        rows = pkernel.slice_plan_rows(f.plan, f.num_blocks, f.nreal,
                                       f.block_sublanes)
        for tile in (1, 2, 4, 8):
            for row in rows.tolist():
                mode, units, per, Gp, Ps, nper = pkernel.slice_work(row, tile)
                spb = row[1]
                if mode == pkernel.WIDE:
                    assert units * per == row[5] // row[2]
                    continue
                hit = np.zeros(spb, int)
                if mode == pkernel.RUNS:
                    for gi in range(per):
                        hit[gi * 8:min(spb, gi * 8 + 8)] += 1
                else:
                    for gi in range(Gp * Ps):
                        g, s = divmod(gi, Ps)
                        cnt = min(tile, -(-(nper - g) // Gp))
                        hit[[Ps * (g + m * Gp) + s for m in range(cnt)]] += 1
                    hit[nper * Ps:] += 1
                    assert per == Gp * Ps + spb - nper * Ps
                assert (hit == 1).all(), (name, tile, row)


@pytest.mark.parametrize("block_rows", [128, 32], ids=["narrow", "wide"])
def test_slice_f32_plain_sums_in_row_order(block_rows):
    """The plain f32 slice scores are the kernels' sums
    (csrc/slice_scores.cu: F32, slice_sums): a slice's words in row
    order from 0, each product and each add rounded to f32, and a wide
    slice's block sums added in block order. Bit-equal to a NumPy float32
    loop over the decoded words; rows of no real slice stay 0."""
    coo = create_sparse_matrix(ROWS, COLS, 20, "gamma", seed=5)
    cfg = pt.TopKSpMVConfig(**dict(DEFAULT, fused_block_sublanes=block_rows))
    eng = pt.TopKSpMV(coo, cfg, device="cpu")
    table, _ = eng._table(create_query_batch(1, COLS, seed=6)[0])
    words = eng.words.numpy().view(np.uint32)
    tab = table.numpy().reshape(-1)
    n = eng.row_ids.shape[0]
    want = np.zeros((n, 128), np.float32)
    wide = 0
    for b, (W, spb, bps, base, blk0, _) in enumerate(
            eng.plan_rows.tolist()):
        wide += bps > 1
        for t in range(int(eng.nreal.reshape(-1)[b])):
            if bps == 1:
                spans = [((blk0 + t // spb) * block_rows + t % spb * W, W)]
            else:
                spans = [((blk0 + t * bps + j) * block_rows,
                          min(block_rows, W - j * block_rows))
                         for j in range(bps)]
            carry = np.zeros(128, np.float32)
            for r0, rows in spans:
                acc = np.zeros(128, np.float32)
                for w in words[r0:r0 + rows]:
                    acc = acc + (w << 16).view(np.float32) * tab[w >> 16]
                carry = carry + acc
            want[base + t] = carry
    assert (wide > 0) == (block_rows == 32)
    got = pkernel.slice_scores_plain(eng.words, table, eng.nreal,
                                     eng.plan_rows, num_slices=n,
                                     block_sublanes=block_rows, codec="f32")
    np.testing.assert_array_equal(got.numpy(), want)


# shared memory a CUDA block can opt into on the H100: 227 KB
H100_SMEM = 232448


@pytest.mark.parametrize("max_cols,fit", [
    (1024, 8), (14464, 4), (14592, 2), (29056, 2), (29184, 1), (58112, 1),
    (58240, None), (65536, None)])
def test_f32_tables_in_smem_at_the_limit(max_cols, fit):
    """How many f32 tables (4 bytes a column) a CUDA block of the sweeps
    holds (K6 and K8 cut their subgroup to it), at each power of two's
    boundary; past one table (fit None) none: the sweeps gather from the
    tables in global memory (0, codec argument "f32_global"), up to the
    65,536 columns of the f32 column field."""
    want = 0 if fit is None else fit
    assert pkernel.tables_in_smem(4 * max_cols, H100_SMEM) == want
