"""The port's tools (``bench/``, ``utils/profiling``, the examples and
``python -m spmv_topk_tpu_torch --help``) against the JAX package's on the
CPU.

Both packages see the same corpora and queries (numpy generators seeded
alike); the port's engines run the plain versions of its kernels, the
JAX engines their Pallas kernels in interpret mode. Every config sets
``block_sublanes`` and ``fused_block_sublanes`` in both packages
(``tests/conftest.py`` shrinks only the JAX defaults), except
``run_sweep``'s, which builds its own: there the geometries differ and
the results compared (indices, precision) do not depend on them.

Held equal, not to a tolerance: the benchmark loop's non-time CSV columns
(indices, values printed to 5 decimals, error counts, quality metrics),
the sweep's precision and nnz, the serving loop's recalls, the CPU
baseline's indices, and every numeric field of the capacity planner's
``Plan`` once the JAX module is given the port's constants. Times are not
compared: they are host clocks of two different programs.
"""

import csv
import dataclasses
import glob
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

import spmv_topk_tpu.bench.capacity as jcap
from spmv_topk_tpu.api import TopKSpMV as JTopKSpMV
from spmv_topk_tpu.bench import CSV_HEADER as J_CSV_HEADER
from spmv_topk_tpu.bench import run_benchmark as jrun_benchmark
from spmv_topk_tpu.bench.cpu_baseline import topk_cpu as jtopk_cpu
from spmv_topk_tpu.bench.service import run_service as jrun_service
from spmv_topk_tpu.bench.sweep import run_sweep as jrun_sweep
from spmv_topk_tpu.config import TopKSpMVConfig as JConfig
from spmv_topk_tpu.formats import create_sparse_matrix as jmatrix
from spmv_topk_tpu.parallel import make_mesh as jmake_mesh
from spmv_topk_tpu.parallel.sharded_buckets import (
    ShardedBucketedTopKSpMV as JSharded)

import spmv_topk_tpu_torch as pt
import spmv_topk_tpu_torch.bench.capacity as pcap
from spmv_topk_tpu_torch.bench import CSV_HEADER, run_benchmark, run_sweep
from spmv_topk_tpu_torch.bench import cpu_baseline
from spmv_topk_tpu_torch.bench.service import run_service
from spmv_topk_tpu_torch.formats import create_sparse_matrix, write_mtx
from spmv_topk_tpu_torch.parallel import ShardedBucketedTopKSpMV, make_mesh
from spmv_topk_tpu_torch.utils import profiling

from rescore_paths import load_both_natives

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
# the CSV columns that carry no time
UNTIMED = ("iteration", "error_idx", "error_val", "k", "sw_res_idx",
           "sw_res_val", "hw_res_idx", "hw_res_val", "precision", "ndcg",
           "kendall_tau")


@pytest.fixture(scope="module", autouse=True)
def _natives():
    # the serving loop's engines rescore: pin both packages to their
    # native rescore before any engine is built (tests/rescore_paths.py)
    load_both_natives()


def _untimed(text):
    return [{c: r[c] for c in UNTIMED}
            for r in csv.DictReader(io.StringIO(text))]


def test_run_benchmark_matches_jax():
    """tests/test_bench.py:11's corpus and loop in both packages: the same
    CSV header and, row for row, the same non-time columns."""
    geom = dict(k=10, num_partitions=1, max_cols=256, block_sublanes=32,
                fused_block_sublanes=128)
    jcoo = jmatrix(800, 256, 10, "uniform", seed=40)
    coo = create_sparse_matrix(800, 256, 10, "uniform", seed=40)
    jres = jrun_benchmark(JTopKSpMV(jcoo, JConfig(**geom)), jcoo,
                          num_tests=4, k=10, seed=41)
    res = run_benchmark(pt.TopKSpMV(coo, pt.TopKSpMVConfig(**geom),
                                    device="cpu"), coo,
                        num_tests=4, k=10, seed=41)
    assert CSV_HEADER == J_CSV_HEADER
    lines = res.csv.strip().split("\n")
    assert lines[0] == CSV_HEADER and len(lines) == 5
    assert _untimed(res.csv) == _untimed(jres.csv)
    assert res.mean_precision == jres.mean_precision == 1.0
    assert res.mean_exec_ms > 0 and np.isfinite(res.nnz_per_sec)
    keys = [c for c in UNTIMED if "_res_" not in c]
    for r, jr in zip(res.rows, jres.rows):
        assert {c: r[c] for c in keys} == {c: jr[c] for c in keys}


def test_run_sweep_matches_jax(tmp_path):
    """One tiny configuration of the sweep in both packages: the same
    precision, nnz and CSV rows (indices and quality columns); the port's
    file named with the reference's convention and impl cpu-f32."""
    args = ([1500], [256], ["uniform"], [8])
    jsum = jrun_sweep(*args, k=20, num_tests=3, out_dir=str(tmp_path / "j"))
    psum = run_sweep(*args, k=20, num_tests=3, out_dir=str(tmp_path / "p"),
                     device="cpu")
    assert len(psum) == len(jsum) == 1
    p, j = psum[0], jsum[0]
    assert (p["nnz"], p["precision"]) == (j["nnz"], j["precision"])
    assert p["precision"] >= 0.95
    assert p["config"] == j["config"].replace("tpu-", "cpu-", 1)
    (pcsv,) = glob.glob(str(tmp_path / "p" / "*.csv"))
    (jcsv,) = glob.glob(str(tmp_path / "j" / "*.csv"))
    assert os.path.basename(pcsv).startswith("cpu-f32_1500_256_uniform_8")
    with open(pcsv) as fp, open(jcsv) as fj:
        assert _untimed(fp.read()) == _untimed(fj.read())
    with open(tmp_path / "p" / "summary.json") as f:
        assert json.load(f) == psum


# tests/test_capacity.py:60's config, whose fused blocks stay at 1024
# sublanes there (conftest shrinks only when both are at their defaults):
# one block a bucket keeps the interpret-mode batch programs small
SERVICE = dict(k=20, max_cols=256, block_sublanes=64,
               fused_block_sublanes=1024, rescore_pool=80)


@pytest.mark.parametrize("sharded", [False, True],
                         ids=["TopKSpMV", "Sharded4"])
def test_run_service_matches_jax(sharded):
    """tests/test_capacity.py:60's serving loop in both packages, on one
    engine and on the sharded engine over four CPU shards: the same
    recalls and query count."""
    jcoo = jmatrix(3000, 256, 10, "gamma", seed=5)
    coo = create_sparse_matrix(3000, 256, 10, "gamma", seed=5)
    if sharded:
        jeng = JSharded(jcoo, JConfig(**SERVICE),
                        mesh=jmake_mesh(jax.devices()[:4]))
        eng = ShardedBucketedTopKSpMV(coo, pt.TopKSpMVConfig(**SERVICE),
                                      mesh=make_mesh([CPU] * 4))
    else:
        jeng = JTopKSpMV(jcoo, JConfig(**SERVICE))
        eng = pt.TopKSpMV(coo, pt.TopKSpMVConfig(**SERVICE), device="cpu")
    kw = dict(num_batches=2, batch_size=4, k=20, oracle_every=1, seed=9)
    jout, out = jrun_service(jeng, jcoo, **kw), run_service(eng, coo, **kw)
    keys = ("recall_at_10", "recall_at_100", "num_queries")
    assert {c: out[c] for c in keys} == {c: jout[c] for c in keys}
    assert out["recall_at_10"] >= 0.9 and out["recall_at_100"] >= 0.9
    assert out["num_queries"] == 8
    assert 0 < out["p50_ms"] <= out["p90_ms"] <= out["p99_ms"]


def test_cpu_baseline_matches_jax(capsys):
    """tests/test_bench_modules.py's CPU baseline case: the same indices as
    the JAX module's, and as scipy's; main() prints its JSON line."""
    coo = create_sparse_matrix(2000, 256, 8, "uniform", seed=40)
    jcoo = jmatrix(2000, 256, 8, "uniform", seed=40)
    q = np.random.default_rng(41).standard_normal(256).astype(np.float32)
    q /= np.linalg.norm(q)
    idx, vals = cpu_baseline.topk_cpu(coo.to_scipy(), q, 25)
    jidx, jvals = jtopk_cpu(jcoo.to_scipy(), q, 25)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(vals, jvals)
    gold = np.argsort(-(coo.to_scipy() @ q))[:25]
    assert set(idx.tolist()) == set(gold.tolist())
    # each backend of the JAX module's order gives those indices
    csr = coo.to_scipy()
    native_fn = cpu_baseline._native_fn(csr)
    assert native_fn is not None
    for fn in (dict(native_fn=native_fn), {}):
        i, _ = cpu_baseline.topk_cpu(csr, q, 25, **fn)
        assert set(i.tolist()) == set(gold.tolist())
    cpu_baseline.main(["--rows", "2000", "--cols", "256", "--deg", "8",
                       "-k", "25", "-t", "3"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["metric"] == "cpu_topk_spmv" and out["k"] == 25
    assert out["backend"] == "native_threaded"
    assert out["nnz"] == create_sparse_matrix(2000, 256, 8, "gamma",
                                              seed=1).nnz


# ---------------------------------------------------------------- capacity

PLAN_CASES = [
    dict(rows=500_000_000, mesh="h100-8", batch=1),
    dict(rows=500_000_000, mesh="h100-32", batch=1, codec="i4s"),
    dict(rows=10_000_000, mesh="h100-1", batch=1, codec="i8s"),
    dict(rows=50_000_000, mesh="h100-1", batch=1, codec="f32",
         rescore_pool=0),
    dict(rows=200_000_000, mesh="h100-16", batch=1, k=50, lane_k=4,
         words_per_nnz=0.7),
    # batches: the memory clamp kept out of reach on both sides (below)
    dict(rows=500_000_000, mesh="h100-8", batch=64),
    dict(rows=500_000_000, mesh="h100-8", batch=16),
    dict(rows=20_000_000, mesh="h100-1", batch=8, codec="i8s"),
    dict(rows=20_000_000, mesh="h100-2", batch=4, codec="f32"),
]


@pytest.mark.parametrize("case", PLAN_CASES,
                         ids=lambda c: "-".join(f"{v}" for v in c.values()))
def test_plan_matches_jax_arithmetic(monkeypatch, case):
    """The JAX planner, given the port's constants, computes every numeric
    field of the port's Plan. For batches the memory clamp is kept out of
    reach on both sides: the port divides a group's read demand by the
    queries that share it (K6 and K8 read the stream once a group), the
    JAX planner does not (test_plan_clamp_counts_one_read_a_group)."""
    chips = pcap.CHIPS
    if case["batch"] > 1:
        chips = {n: dict(c, hbm_gbps=1e9) for n, c in chips.items()}
        monkeypatch.setattr(pcap, "CHIPS", chips)
    monkeypatch.setattr(jcap, "CHIPS", chips)
    monkeypatch.setattr(jcap, "MEASURED", pcap.MEASURED)
    monkeypatch.setattr(jcap, "RESCORE_MS_PER_QUERY",
                        pcap.RESCORE_MS_PER_QUERY)
    monkeypatch.setattr(jcap, "PACK_NNZ_PER_SEC", pcap.PACK_NNZ_PER_SEC)
    p, j = pcap.plan(**case), jcap.plan(**case)
    pd, jd = dataclasses.asdict(p), dataclasses.asdict(j)
    pd.pop("assumptions"), jd.pop("assumptions")
    assert pd == jd
    assert [f.name for f in dataclasses.fields(pcap.Plan)] == \
        [f.name for f in dataclasses.fields(jcap.Plan)]


def test_h100_mesh_parsing():
    """tests/test_capacity.py's parsing invariants on h100-N meshes: N is
    the count of cards, eight a host."""
    assert pcap.parse_mesh("h100-8")[1:] == (8, 1)
    assert pcap.parse_mesh("h100-32")[1:] == (32, 4)
    assert pcap.parse_mesh("h100-1")[1:] == (1, 1)
    chip = pcap.parse_mesh("h100-16")[0]
    assert (chip["name"], chip["hbm_gb"], chip["hbm_gbps"]) == \
        ("h100", 80.0, 3350.0)
    for bad in ("v4-32", "h100-x", "h100"):
        with pytest.raises(ValueError):
            pcap.parse_mesh(bad)


def test_h100_config5_projection():
    """tests/test_capacity.py's config-5 invariants on one host of eight
    cards: it fits, serves > 100 qps, and the raw (unrescored) path scales
    at >= 80% with the merge below the sweep. Rescored, the host rescore
    (``RESCORE_MS_PER_QUERY``, measured on the card's host) exceeds the
    card's sweep: the planner says so, where the TPU's slower sweep hid
    it."""
    p = pcap.plan(rows=500_000_000, cols=1024, mesh="h100-8", batch=64)
    assert p.fits and p.hbm_utilization < 0.1
    assert p.qps > 100
    assert p.rescore_ms > p.sweep_ms > p.merge_ms
    raw = pcap.plan(rows=500_000_000, cols=1024, mesh="h100-8", batch=64,
                    rescore_pool=0)
    assert raw.scaling_efficiency >= 0.8
    assert raw.merge_ms + raw.rescore_ms < raw.sweep_ms
    assert raw.qps > p.qps


def test_plan_clamp_counts_one_read_a_group(monkeypatch):
    """The memory clamp: h16 groups of 32 on one card stay under the
    card's memory rate (one read of the stream serves the group); on a
    card of a twentieth of that rate the clamp binds, and the clamped
    demand is at most 85% of it."""
    p = pcap.plan(rows=10_000_000, mesh="h100-1", batch=32)
    assert not any("clamped" in a for a in p.assumptions)
    slow = {n: dict(c, hbm_gbps=c["hbm_gbps"] / 20)
            for n, c in pcap.CHIPS.items()}
    monkeypatch.setattr(pcap, "CHIPS", slow)
    for batch in (1, 32):
        q = pcap.plan(rows=10_000_000, mesh="h100-1", batch=batch)
        assert any("clamped" in a for a in q.assumptions)
        share = min(batch, 32)
        demand = (q.nnz / q.sweep_ms / 1e6) * \
            pcap.MEASURED["h16"]["words_per_nnz"] * 4 / 1e3 / share
        assert demand <= slow["h100"]["hbm_gbps"] * 0.85 * 1.001


def test_single_query_vs_batch_latency_model():
    """Batching amortizes the stream: per-query time strictly improves;
    one card's single-query sweep reproduces K1's measured rate (1G nnz at
    ~1,032 Gnnz/s ~= 0.97 ms)."""
    lone = pcap.plan(rows=50_000_000, mesh="h100-1", batch=1)
    grouped = pcap.plan(rows=50_000_000, mesh="h100-1", batch=32)
    assert grouped.per_query_ms < lone.per_query_ms
    assert 0.9 < lone.sweep_ms < 1.05


def test_capacity_main_json_and_text(capsys):
    """main(['--mesh', 'h100-8', '--json']) prints the Plan as one JSON
    line; the text form lists the assumptions, which name the card and
    mark the data-sheet values."""
    p = pcap.main(["--mesh", "h100-8", "--json"])
    out = json.loads(capsys.readouterr().out)
    assert out == dataclasses.asdict(p)
    assert out["mesh"] == "h100-8" and out["rows"] == 500_000_000
    pcap.main(["--baseline-config5"])
    text = capsys.readouterr().out
    assert pcap.CARD in text and "data-sheet" in text
    for codec in pcap.MEASURED:
        pcap.main(["--codec", codec, "--mesh", "h100-2", "--json"])
        assert json.loads(capsys.readouterr().out)["codec"] == codec


# ---------------------------------------------------------------- profiling

def test_profiling_helpers(tmp_path):
    sink = {}
    with profiling.phase_timer("pack", sink):
        sum(range(1000))
    assert sink["pack"] > 0
    with profiling.device_trace(str(tmp_path / "trace")) as prof:
        torch.ones(64).sum()
    (trace,) = glob.glob(str(tmp_path / "trace" / "*.json"))
    with open(trace) as f:
        assert "traceEvents" in json.load(f)
    assert prof.key_averages()
    calls = []
    per = profiling.timed_slope(lambda n: calls.append(n), 4, 104, reps=3)
    assert calls == [4, 104] + [104, 4] * 3
    assert abs(per) < 1e-3
    # a documented no-op: nothing written, whatever the path
    assert profiling.enable_compilation_cache() is None
    assert profiling.enable_compilation_cache(str(tmp_path / "c")) is None
    assert not os.path.exists(tmp_path / "c")


# ---------------------------------------------------------------- entry

def test_main_help_loads_no_jax():
    """``python -m spmv_topk_tpu_torch --help`` exits 0 and imports neither
    jax nor the JAX package (read from -X importtime)."""
    res = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "spmv_topk_tpu_torch",
         "--help"], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "--device" in res.stdout and "--autotune" in res.stdout
    mods = [line.rsplit("|", 1)[-1].strip()
            for line in res.stderr.splitlines()
            if line.startswith("import time:")]
    assert "spmv_topk_tpu_torch.cli" in mods
    bad = [m for m in mods if m in ("jax", "jaxlib", "spmv_topk_tpu")
           or m.startswith(("jax.", "jaxlib.", "spmv_topk_tpu."))]
    assert not bad, bad


# ---------------------------------------------------------------- examples

def test_example_quickstart(capsys):
    from spmv_topk_tpu_torch.examples import quickstart

    assert quickstart.main(rows=2000, device="cpu") == 0
    out = capsys.readouterr().out
    for tag in ("query 0:", "query 2:", "batch: (16, 100)", "fast top-5:",
                "reloaded top-5:", "dense batch: (16, 100)"):
        assert tag in out, out


def test_example_multihost_one_process(capsys):
    from spmv_topk_tpu_torch.examples import multihost

    assert multihost.main(rows=2000, device="cpu") == 0
    out = capsys.readouterr().out
    assert "mesh devices: 1" in out and "top-5:" in out


@pytest.mark.parametrize("how", ["mtx_autotune", "glove_defaults"])
def test_example_mtx_search(tmp_path, capsys, how):
    """mtx_search on an MTX file it parses, autotuned (measure=False on
    the CPU: ranked by the card's rates), and on the GloVe-shaped corpus
    with the default config; both serve the exact top-100 in practice."""
    from spmv_topk_tpu_torch.examples import mtx_search

    if how == "mtx_autotune":
        path = str(tmp_path / "m.mtx")
        write_mtx(path, create_sparse_matrix(2000, 256, 10, "gamma", seed=3))
        argv = [path, "50", "--device", "cpu"]
    else:
        argv = ["--synthetic-glove", "--rows", "2000", "--no-autotune",
                "--device", "cpu"]
    assert mtx_search.main(argv) == 0
    out = capsys.readouterr().out
    assert ("autotune (" in out) == (how == "mtx_autotune")
    assert "packed in" in out and "query wall:" in out
    prec = float(out.split("vs exact gold:")[1].split()[0])
    assert prec >= 0.98, out
    assert mtx_search.main([str(tmp_path / "missing.mtx"), "--device",
                            "cpu"]) == 2
