"""The harness on the CPU at a small size: the data from the seed, the
last line, files found by name, and the runs that must give no result."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import corpus, harness

from conftest import REPO, cpu_run, make_tiny_root

SPEC = dict(num_rows=2000, num_cols=512, average_degree=20,
            distribution="gamma", l2_norm=True)
KEYS = ("correct", "attempted", "failed", "metrics", "device")


def test_corpus_follows_the_seed():
    a = corpus.make_corpus(SPEC, 2**31 + 3, "cpu")
    b = corpus.make_corpus(SPEC, 2**31 + 3, "cpu")
    c = corpus.make_corpus(SPEC, 2**31 + 4, "cpu")
    for key in ("rows", "cols", "vals", "indptr"):
        assert torch.equal(a[key], b[key])
    assert not torch.equal(a["indptr"], c["indptr"])
    assert corpus.checksum(a) == corpus.checksum(b) != corpus.checksum(c)
    # rows grouped, columns sorted within a row, rows of unit norm
    deg = torch.diff(a["indptr"])
    assert int(deg.min()) >= 1 and int(deg.max()) <= SPEC["num_cols"]
    assert torch.equal(a["rows"].long(),
                       torch.repeat_interleave(torch.arange(2000), deg))
    key = a["rows"].long() * SPEC["num_cols"] + a["cols"].long()
    assert bool((torch.diff(key) >= 0).all())
    norms = torch.zeros(2000, dtype=torch.float64).index_add_(
        0, a["rows"].long(), a["vals"].double() ** 2)
    np.testing.assert_allclose(norms.numpy(), 1.0, rtol=1e-5)
    mean = float(deg.double().mean())
    assert 0.8 * SPEC["average_degree"] < mean < 1.2 * SPEC["average_degree"]


def test_corpus_refuses_another_distribution():
    with pytest.raises(ValueError, match="uniform"):
        corpus.make_corpus(dict(SPEC, distribution="uniform"), 1, "cpu")


def test_queries_follow_the_seed():
    a = corpus.make_queries(16, 512, 7, "cpu")
    assert torch.equal(a, corpus.make_queries(16, 512, 7, "cpu"))
    assert not torch.equal(a, corpus.make_queries(16, 512, 8, "cpu"))
    assert not torch.equal(a, corpus.make_queries(16, 512, 7, "cpu", "warmup"))
    np.testing.assert_allclose(torch.linalg.vector_norm(a, dim=1), 1.0,
                               rtol=1e-6)
    assert len({tuple(r) for r in a.tolist()}) == 16      # distinct


with open(os.path.join(REPO, "BENCHMARK.json")) as _fh:
    WORKLOADS = [w["name"] for w in json.load(_fh)["workloads"]]


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("trace", [False, True])
def test_last_line(tiny_root, workload, trace):
    r = cpu_run(tiny_root, workload, trace=trace)
    assert tuple(r)[:5] == KEYS and list(r)[-1] == "check"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    cell = harness.Cell(tiny_root, workload)
    want = cell.per_layer if trace else cell.end_to_end
    assert set(r["metrics"]) <= {m["name"] for m in want}
    for m in want:
        if m["name"] in r["metrics"]:
            assert r["metrics"][m["name"]]["unit"] == m["unit"]
    if trace:
        # the CPU has no device trace: only the count is read
        assert set(r["metrics"]) == {
            m["name"] for m in want
            if m["name"].split(".")[0] == "words_per_nnz"}
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert {m["name"] for m in want} == set(r["metrics"])
        assert 0.9 <= r["metrics"]["recall_at_100"]["value"] <= 1.0
    assert set(r["check"]) == {"bad_answers", "score_gap", "rank_gap"}
    for v in r["check"].values():
        assert set(v) == {"value", "limit"}
    json.dumps(r)


def test_new_files_are_found_by_name(tiny_root):
    """A configuration, a mix, a cell and a metric added as files alone,
    with their entries in BENCHMARK.json, run without an edit to any
    file that was there."""
    bench = os.path.join(tiny_root, "benchmark")
    before = {}
    for d, _, files in os.walk(bench):
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                before[os.path.join(d, f)] = fh.read()
    with open(os.path.join(bench, "configs", "c3_i8s_tiesafe_10M.json")) as fh:
        cfg = json.load(fh)
    cfg["engine"] = dict(cfg["engine"], query_codec="int8x4")
    cfg["precision"] = {"values": "bf16", "query": "int8x4"}
    cfg["name"] = "int8x4_small"
    with open(os.path.join(bench, "configs", "int8x4_small.json"), "w") as fh:
        json.dump(cfg, fh)
    with open(os.path.join(bench, "traffic", "single.json")) as fh:
        mix = json.load(fh)
    mix["entry"], mix["queries_per_request"] = "query_batch", 3
    mix["pool_queries"], mix["entry_kwargs"] = 12, {"group_size": 3}
    with open(os.path.join(bench, "traffic", "batch3.json"), "w") as fh:
        json.dump(mix, fh)
    with open(os.path.join(bench, "cells", "int8x4_small.batch3.json"),
              "w") as fh:
        json.dump({"limits": {"bad_answers": 0, "score_gap": 1e-5,
                              "rank_gap": 1e-5}}, fh)
    with open(os.path.join(bench, "metrics", "answers_per_request.py"),
              "w") as fh:
        fh.write("def read(ctx):\n    return ctx.queries / ctx.requests\n")
    path = os.path.join(tiny_root, "BENCHMARK.json")
    with open(path) as fh:
        spec = json.load(fh)
    spec["configs"].append({"name": "int8x4_small", "source": "a test",
                            "file": "benchmark/configs/int8x4_small.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "int8x4_small.batch3",
                              "config": "int8x4_small", "traffic": "batch3",
                              "chips": 1, "why": "a test"})
    spec["end_to_end"].append({"name": "answers_per_request",
                               "unit": "queries", "better": "higher",
                               "bound": 0.01, "source": "host_clock",
                               "workloads": ["int8x4_small.batch3"]})
    with open(path, "w") as fh:
        json.dump(spec, fh)
    r = cpu_run(tiny_root, "int8x4_small.batch3")
    assert r["correct"] is True
    assert r["metrics"]["answers_per_request"]["value"] == 3.0
    assert {"latency_p95_ms", "recall_at_100", "setup_s",
            "answers_per_request"} == set(r["metrics"])
    for f, data in before.items():
        with open(f, "rb") as fh:
            assert fh.read() == data, f


def _script(root, *args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, os.path.join(root, "benchmark",
                                                        "run.py"), *args],
                          cwd=root, capture_output=True, text=True,
                          timeout=300, env=env)


ARGS = ("--workload", "default_f32_tiesafe.single", "--seed", str(2**31 + 5),
        "--seconds", "1", "--trace", "0")


def test_no_card_no_result(tiny_root):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    r = _script(tiny_root, *ARGS)
    assert r.returncode != 0 and r.stdout == ""
    assert "CUDA" in r.stderr


def test_no_program_no_result(tmp_path):
    """A directory with BENCHMARK.json and benchmark/ alone gives no
    result."""
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(REPO, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _script(str(tmp_path), *ARGS)
    assert r.returncode != 0 and r.stdout == ""


def test_forbidden_modules_give_no_result(tiny_root, monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", sys.modules["json"])
    with pytest.raises(harness.Forbidden, match="jax"):
        cpu_run(tiny_root, "default_f32_tiesafe.single")


def test_idle_share_reads_the_untraced_requests(tiny_root):
    """The device's busy time a traced request against the latencies of
    the requests outside the trace, which the profiler did not slow."""
    from types import SimpleNamespace

    read = harness.Cell(tiny_root, WORKLOADS[0]).reader("device_idle_pct.batch")
    trace = SimpleNamespace(ops=[object()], requests=4, busy_s=lambda: 0.004)
    lat = np.array([2e-3, 2e-3, 9e-3, 9e-3, 9e-3, 9e-3, 4e-3, 4e-3])
    ctx = SimpleNamespace(trace=trace, latencies=lat, traced=slice(2, 6))
    # 1 ms busy a request against 2, 2, 4 and 4 ms outside the trace
    assert read(ctx) == pytest.approx(100.0 * (1 - 4e-3 / 12e-3))
    assert read(SimpleNamespace(trace=None, latencies=lat,
                                traced=slice(0, 0))) is None
