"""Shared helpers of the benchmark's own tests (CPU, small sizes)."""

import json
import os
import shutil
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

TINY_ROWS = 3000


def make_tiny_root(dst, rows=TINY_ROWS):
    """A checkout in ``dst``: BENCHMARK.json and a copy of benchmark/ whose
    corpora have ``rows`` rows and whose mixes sample and trace little,
    with the program linked in."""
    os.makedirs(dst, exist_ok=True)
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), dst)
    shutil.copytree(os.path.join(REPO, "benchmark"),
                    os.path.join(dst, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name in ("spmv_topk_tpu_torch", "runtime"):
        os.symlink(os.path.join(REPO, name), os.path.join(dst, name))
    for sub, edit in (("configs", _tiny_config), ("traffic", _tiny_traffic)):
        d = os.path.join(dst, "benchmark", sub)
        for f in os.listdir(d):
            with open(os.path.join(d, f)) as fh:
                spec = json.load(fh)
            edit(spec, rows)
            with open(os.path.join(d, f), "w") as fh:
                json.dump(spec, fh)
    return str(dst)


def _tiny_config(spec, rows):
    spec["corpus"]["num_rows"] = rows
    # the plain sweeps' cost grows with the block; the packer's default
    # 1024-row blocks are padding at 3000 rows
    spec["engine"]["fused_block_sublanes"] = 128


def _tiny_traffic(spec, rows):
    spec.update(pool_queries=4 * spec["queries_per_request"],
                check_queries=24, warmup_requests=1, trace_requests=2)
    if spec["queries_per_request"] > 1:
        spec["queries_per_request"] = 6
        spec["pool_queries"] = 24
        spec["entry_kwargs"] = {"group_size": 4}


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(tmp_path / "checkout")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_run(root, workload, seed=2**31 + 11, seconds=0.3, trace=False):
    from benchmark import harness

    # a tiny window holds few requests: trace from its first
    saved, harness.TRACE_FROM = harness.TRACE_FROM, 0.0
    try:
        return harness.run(root, workload, seed, seconds, trace,
                           device="cpu", require_card=False,
                           log=lambda s: None)
    finally:
        harness.TRACE_FROM = saved
