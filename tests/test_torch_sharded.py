"""The port's sharded engines (``spmv_topk_tpu_torch.parallel``) against
the JAX package's on the CPU.

A port mesh is a list of devices, here ``[cpu] * D``; the JAX engines run
on D of the 8 virtual CPU devices (tests/conftest.py), their kernels in
interpret mode, each engine built and queried once in the module
fixture. The port's shards run the plain versions of its sweeps.

Tolerances (tie-safe: the two merges may keep different rows among ties
at the k-th value):
  - rows equal above the k-th value; values bit-equal where the scores
    are sums the two packages add alike (h16, the quantized codecs on
    the octet stream, the exact rescore, int8 dense products), and to
    rtol 1e-6 where they add float products in another order (f32, the
    slice stream's quantized codecs: the parity contract of ROADMAP.md;
    the dense bf16 product, torch.mm against XLA's dot);
  - the port's sharded engine against its own TopKSpMV: the same, at
    rtol 1e-6 (a shard's pool holds what the single engine's does on
    these tie-free corpora).
"""

import os
import socket

import numpy as np
import pytest
import torch

import jax

from spmv_topk_tpu.config import TopKSpMVConfig as JConfig
from spmv_topk_tpu.formats import CooMatrix as JCoo
from spmv_topk_tpu.parallel import make_mesh as jmake_mesh
from spmv_topk_tpu.parallel.sharded_buckets import (
    ShardedBucketedTopKSpMV as JSharded)
from spmv_topk_tpu.parallel.sharded_dense import (
    ShardedDenseTopKSpMV as JShardedDense)

import spmv_topk_tpu_torch as pt
from spmv_topk_tpu_torch import parallel
from spmv_topk_tpu_torch.formats import (create_query_batch,
                                         create_sample_vector,
                                         create_sparse_matrix)
from spmv_topk_tpu_torch.parallel import (ShardedBucketedTopKSpMV,
                                          ShardedDenseTopKSpMV,
                                          ShardedTopKSpMV, distributed)

from rescore_paths import load_both_natives

ROWS, COLS = 2400, 256
GEOM = dict(max_cols=COLS, block_sublanes=64, fused_block_sublanes=64)
# name -> (config, D, rtol of the values against JAX)
CASES = {
    "slice_f32_d2": (dict(k=30, **GEOM), 2, 1e-6),
    "octet_h16_d4_rescored": (dict(k=20, query_codec="h16",
                                   fused_layout="octet", width_quantum=2,
                                   rescore_pool=80, **GEOM), 4, 0.0),
    "slice_int8x4_d4_p2": (dict(k=25, query_codec="int8x4",
                                num_partitions=2, **GEOM), 4, 1e-6),
    "octet_i4s_d2_p2_rescored": (dict(k=20, query_codec="i4s",
                                      fused_layout="octet",
                                      width_quantum=4, num_partitions=2,
                                      rescore_pool=80, **GEOM), 2, 0.0),
}
DENSE = {"bf16": 1e-6, "int8": 0.0}
NQ, GROUP = 3, 2          # a batch of 3 in groups of 2: a padded tail
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _native_rescore():
    """Both packages rescore through their native runtimes, before any
    engine is built (rescore_paths.py: the JAX package's build races
    between test workers, and its NumPy path differs by an ulp)."""
    load_both_natives()


def _corpus():
    return create_sparse_matrix(ROWS, COLS, 10, "gamma", seed=301)


def _queries():
    return (create_sample_vector(COLS, seed=302),
            create_query_batch(NQ, COLS, seed=303))


def _jcoo(coo):
    return JCoo(coo.rows, coo.cols, coo.vals, coo.num_rows, coo.num_cols)


def _mesh(D):
    return parallel.make_mesh([CPU] * D)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """name -> numpy results of the JAX engines: (query idx, vals),
    (batch idx, vals), and a snapshot path for each bucketed case."""
    coo = _jcoo(_corpus())
    q, qs = _queries()
    snaps = tmp_path_factory.mktemp("jax_snapshots")
    out = {}
    for name, (cfg, D, _) in CASES.items():
        eng = JSharded(coo, JConfig(**cfg),
                       mesh=jmake_mesh(jax.devices()[:D]))
        path = str(snaps / name)
        eng.save(path)
        out[name] = (tuple(map(np.asarray, eng.query(q))),
                     tuple(map(np.asarray, eng.query_batch(
                         qs, group_size=GROUP))), path)
    for dtype in DENSE:
        eng = JShardedDense(coo, JConfig(k=20, max_cols=COLS),
                            mesh=jmake_mesh(jax.devices()[:3]),
                            block_rows=512, dtype=dtype)
        out["dense", dtype] = tuple(map(np.asarray, eng.query_batch(qs)))
    return out


@pytest.fixture(scope="module")
def engines():
    coo = _corpus()
    return {name: ShardedBucketedTopKSpMV(coo, pt.TopKSpMVConfig(**cfg),
                                          mesh=_mesh(D))
            for name, (cfg, D, _) in CASES.items()}


def _same_top(idx, vals, ref_idx, ref_vals, rtol, what):
    idx, vals = np.asarray(idx), np.asarray(vals)
    if rtol:
        np.testing.assert_allclose(vals, ref_vals, rtol=rtol, atol=1e-7,
                                   err_msg=what)
    else:
        np.testing.assert_array_equal(vals, ref_vals, err_msg=what)
    kth = ref_vals[-1] + rtol * abs(ref_vals[-1]) + (1e-7 if rtol else 0)
    assert set(idx[vals > kth].tolist()) == \
        set(ref_idx[ref_vals > kth].tolist()), what


@pytest.mark.parametrize("name", list(CASES))
def test_query_matches_jax(ref, engines, name):
    q, _ = _queries()
    idx, vals = engines[name].query(q)
    (ri, rv), _, _ = ref[name]
    assert idx.dtype == torch.int32 and idx.shape == (len(ri),)
    _same_top(idx, vals, ri, rv, CASES[name][2], name)


@pytest.mark.parametrize("name", list(CASES))
def test_query_batch_matches_jax(ref, engines, name):
    _, qs = _queries()
    bi, bv = engines[name].query_batch(qs, group_size=GROUP)
    _, (ri, rv), _ = ref[name]
    assert tuple(bi.shape) == ri.shape == (NQ, CASES[name][0]["k"])
    for j in range(NQ):
        _same_top(bi[j], bv[j], ri[j], rv[j], CASES[name][2], f"{name} {j}")


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_equals_single_engine(engines, name):
    """D shards answer as the port's one-device TopKSpMV of the same
    config (with num_partitions, a pool per partition of each shard: the
    single engine on D * P partitions)."""
    cfg, D, _ = CASES[name]
    P = cfg.get("num_partitions", 1)
    single = pt.TopKSpMV(_corpus(), pt.TopKSpMVConfig(
        **dict(cfg, num_partitions=D * P)), device=CPU)
    q, qs = _queries()
    si, sv = engines[name].query(q)
    di, dv = single.query(q)
    _same_top(si, sv, di.numpy(), dv.numpy(), 1e-6, name)
    bi, bv = engines[name].query_batch(qs, group_size=GROUP)
    for j in range(NQ):
        di, dv = single.query(qs[j])
        _same_top(bi[j], bv[j], di.numpy(), dv.numpy(), 1e-6, f"{name} {j}")


@pytest.mark.parametrize("name", ["octet_h16_d4_rescored",
                                  "slice_int8x4_d4_p2"])
def test_jax_snapshot_loads(ref, name):
    """A snapshot saved by the JAX sharded engine serves in the port (with
    matrix= the rescore too) and gives the JAX engine's answers."""
    q, _ = _queries()
    (ri, rv), _, path = ref[name]
    eng = ShardedBucketedTopKSpMV.load(path, mesh=_mesh(CASES[name][1]),
                                       matrix=_corpus())
    idx, vals = eng.query(q)
    _same_top(idx, vals, ri, rv, CASES[name][2], name)


def test_port_snapshot_round_trip(engines, tmp_path):
    name = "octet_i4s_d2_p2_rescored"
    eng = engines[name]
    q, _ = _queries()
    path = str(tmp_path / "eng")
    eng.save(path)
    files = sorted(os.listdir(tmp_path))
    assert files == ["eng.meta.npz", "eng.shard0000.npz", "eng.shard0001.npz"]
    back = ShardedBucketedTopKSpMV.load(path, mesh=_mesh(2), matrix=_corpus())
    for a, b in zip(eng.query(q), back.query(q)):
        assert torch.equal(a, b)
    with pytest.warns(UserWarning, match="rescore_pool"):
        raw = ShardedBucketedTopKSpMV.load(path, mesh=_mesh(2))
    assert raw.query(q)[0].shape == (20,)
    with pytest.raises(ValueError, match="saved for 2 devices"):
        ShardedBucketedTopKSpMV.load(path, mesh=_mesh(3))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_skeleton_exchange_single_process():
    """exchange_skeleton=True runs the processes' exchange (a gloo group
    of one process) and serves what the engine without it serves."""
    import torch.distributed as dist

    coo = _corpus()
    cfg = pt.TopKSpMVConfig(**CASES["octet_h16_d4_rescored"][0])
    q, _ = _queries()
    plain = ShardedBucketedTopKSpMV(coo, cfg, mesh=_mesh(4))
    distributed.initialize_multihost(f"127.0.0.1:{_free_port()}", 1, 0,
                                     device_type="cpu")
    try:
        assert dist.is_initialized() and dist.get_backend() == "gloo"
        eng = ShardedBucketedTopKSpMV(coo, cfg, mesh=_mesh(4),
                                      exchange_skeleton=True)
        assert eng._value_scale == plain._value_scale
        for a, b in zip(eng.query(q), plain.query(q)):
            assert torch.equal(a, b)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("dtype", list(DENSE))
def test_sharded_dense_matches_jax(ref, dtype):
    _, qs = _queries()
    eng = ShardedDenseTopKSpMV(_corpus(), pt.TopKSpMVConfig(
        k=20, max_cols=COLS), mesh=_mesh(3), block_rows=512, dtype=dtype)
    ri, rv = ref["dense", dtype]
    bi, bv = eng.query_batch(qs)
    for j in range(NQ):
        _same_top(bi[j], bv[j], ri[j], rv[j], DENSE[dtype], f"{dtype} {j}")
    # one query against the batch: bf16's float32 product of one query
    # may add in another order than one of three (gemv against gemm)
    i0, v0 = eng.query(qs[0])
    _same_top(i0, v0, bi[0].numpy(), bv[0].numpy(), DENSE[dtype],
              "query() and the batch")


def test_sharded_dense_equals_dense_engine():
    """Three int8 shards answer as the one-device dense engine (int8
    scores are exact sums, one multiply each by two scales), and as it
    does with the exact rescore."""
    coo = _corpus()
    _, qs = _queries()
    for pool in (None, 60):
        cfg = pt.TopKSpMVConfig(k=20, max_cols=COLS, rescore_pool=pool)
        sh = ShardedDenseTopKSpMV(coo, cfg, mesh=_mesh(3), block_rows=512,
                                  dtype="int8")
        one = pt.DenseTopKSpMV(coo, cfg, device=CPU, block_rows=1024,
                               dtype="int8")
        bi, bv = sh.query_batch(qs)
        oi, ov = one.query_batch(qs)
        for j in range(NQ):
            _same_top(bi[j], bv[j], oi[j].numpy(), ov[j].numpy(), 0.0,
                      f"pool {pool} {j}")


def test_errors():
    coo = _corpus()
    with pytest.raises(ValueError, match="sigma_sort"):
        ShardedBucketedTopKSpMV(coo, pt.TopKSpMVConfig(
            fused_layout="octet", query_codec="h16", sigma_sort=False,
            **GEOM), mesh=_mesh(2))
    tiny = create_sparse_matrix(6, COLS, 4, "uniform", seed=5)
    with pytest.raises(ValueError, match="empty"):
        ShardedBucketedTopKSpMV(tiny, pt.TopKSpMVConfig(k=4, **GEOM),
                                mesh=_mesh(8))
    with pytest.raises(ValueError, match="partition 3 of shard 0 is empty"):
        ShardedBucketedTopKSpMV(tiny, pt.TopKSpMVConfig(
            k=4, num_partitions=4, **GEOM), mesh=_mesh(2))
    eng = ShardedBucketedTopKSpMV(coo, pt.TopKSpMVConfig(k=10, **GEOM),
                                  mesh=_mesh(2))
    q, qs = _queries()
    with pytest.raises(ValueError, match="merge width"):
        eng.query(q, k=11)
    with pytest.raises(ValueError, match="merge width"):
        eng.query_batch(qs, k=11)
    assert eng.query(q, k=5)[0].shape == (5,)


def test_mesh_and_alias():
    assert ShardedTopKSpMV is ShardedBucketedTopKSpMV
    assert parallel.AXIS == "shards"
    mesh = parallel.make_mesh(["cpu", "cpu"])
    assert mesh == [CPU, CPU] and mesh.owners == [0, 0]
    assert distributed.local_shard_rows(10, mesh) == (0, 10)
    assert distributed.global_mesh([CPU] * 3) == [CPU] * 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            parallel.make_mesh()
    distributed.initialize_multihost()        # no address: nothing to do
    assert distributed.world_size() == 1
