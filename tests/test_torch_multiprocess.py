"""The port's sharded engine in two processes (torch.distributed, gloo on
localhost) against the same engine in one process.

Each worker (this file run as a script) holds two CPU mesh positions of
a four-position global mesh, packs only its own rows (``local_rows``,
from ``distributed.local_shard_rows``) and serves a raw slice f32 engine
and a rescored octet h16 engine through ``query`` and ``query_batch`` (a
padded tail group), then saves its shards, loads them back and queries
again. The test runs the one-process engines on ``[cpu] * 4`` and
requires every worker's answers to equal theirs bit for bit: the shards,
their candidates and the position-ordered merge are the same.

    python tests/test_torch_multiprocess.py <rank> <world> <port> <dir>
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS, COLS, K = 1024, 256, 16
RAW = dict(k=K, max_cols=COLS, block_sublanes=32, fused_block_sublanes=64)
RESCORED = dict(k=K, max_cols=COLS, query_codec="h16", fused_layout="octet",
                width_quantum=1, fused_block_sublanes=64, block_sublanes=32,
                rescore_pool=64)
NQ, GROUP = 3, 2


def _data():
    from spmv_topk_tpu_torch.formats import (create_query_batch,
                                             create_sample_vector,
                                             create_sparse_matrix)

    return (create_sparse_matrix(ROWS, COLS, 8, "uniform", seed=11),
            create_sample_vector(COLS, seed=12),
            create_query_batch(NQ, COLS, seed=13))


def _answers(eng, q, qs):
    out = {}
    for name, (i, v) in (("query", eng.query(q)),
                         ("batch", eng.query_batch(qs, group_size=GROUP))):
        out[name] = (i.cpu().numpy().tolist(), v.cpu().numpy().tolist())
    return out


def _worker(rank, world, port, snapdir):
    sys.path.insert(0, REPO)
    import torch
    import torch.distributed as dist

    from spmv_topk_tpu_torch import TopKSpMVConfig
    from spmv_topk_tpu_torch.parallel import ShardedTopKSpMV, distributed

    distributed.initialize_multihost(f"127.0.0.1:{port}", world, rank,
                                     device_type="cpu")
    assert distributed.world_size() == world
    mesh = distributed.global_mesh([torch.device("cpu")] * 2)
    assert len(mesh) == 2 * world and mesh.owners == [0, 0, 1, 1]
    coo, q, qs = _data()
    lo, hi = distributed.local_shard_rows(coo.num_rows, mesh)
    local = coo.row_slice(lo, hi)
    res = {"rows": [lo, hi]}
    for name, cfg in (("raw", RAW), ("rescored", RESCORED)):
        eng = ShardedTopKSpMV(local, TopKSpMVConfig(**cfg), mesh=mesh,
                              local_rows=(lo, coo.num_rows))
        res[name] = _answers(eng, q, qs)
        path = os.path.join(snapdir, name)
        eng.save(path)
        dist.barrier()
        back = ShardedTopKSpMV.load(path, mesh=mesh, matrix=local,
                                    local_rows=(lo, coo.num_rows))
        res[name + "_loaded"] = _answers(back, q, qs)
    print("RESULT " + json.dumps(res), flush=True)
    dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_processes_equal_one(tmp_path):
    import torch

    from spmv_topk_tpu_torch import TopKSpMVConfig
    from spmv_topk_tpu_torch.parallel import ShardedTopKSpMV, make_mesh

    port = _free_port()
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), "2", str(port),
         str(tmp_path)], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-4000:]}"
    results = [json.loads(next(ln for ln in out.splitlines()
                               if ln.startswith("RESULT "))[7:])
               for out in outs]
    assert [r["rows"] for r in results] == [[0, 512], [512, 1024]]

    coo, q, qs = _data()
    mesh = make_mesh([torch.device("cpu")] * 4)
    for name, cfg in (("raw", RAW), ("rescored", RESCORED)):
        one = _answers(ShardedTopKSpMV(coo, TopKSpMVConfig(**cfg),
                                       mesh=mesh), q, qs)
        for r in results:
            for key in (name, name + "_loaded"):
                for call in ("query", "batch"):
                    gi, gv = r[key][call]
                    oi, ov = one[call]
                    np.testing.assert_array_equal(np.asarray(gi),
                                                  np.asarray(oi))
                    np.testing.assert_array_equal(
                        np.asarray(gv, np.float32),
                        np.asarray(ov, np.float32))


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
