"""The port's evaluation tools (``bench/full_eval``, ``bench/accuracy_sweep``,
``bench/plots``) against the JAX package's on the CPU.

Both packages see the same corpora and queries (numpy generators seeded
alike); the port's engines run the plain versions of its kernels, the JAX
engines their Pallas kernels in interpret mode, as tests/test_bench_modules
runs them. Held equal: the accuracy sweep's production metrics (to 1e-12),
the c1 oracle check's metrics, every key the JAX full_eval writes for the
configurations run, the plots' aggregations (the JAX module's pandas over
the same CSVs), the packing ratios and the convergence model's numbers.
The accuracy sweep's raw mode (no rescore) returns the same top-100 values
as the JAX engine, bit for bit, but may rank other rows among tied scores
(the port's sweeps keep the kernels' order, ``torch.topk`` the finalize's;
tests/test_torch_ties.py): its metrics are held within the share of the
ranking that ties can move. Times are not compared: they are clocks of two
different programs.
"""

import ast
import glob
import hashlib
import inspect
import json
import os
import re

import numpy as np
import pytest
import torch

import spmv_topk_tpu.bench.full_eval as jfe
from spmv_topk_tpu import TopKSpMV as JTopKSpMV
from spmv_topk_tpu import TopKSpMVConfig as JConfig
from spmv_topk_tpu.bench import accuracy_sweep as jas
from spmv_topk_tpu.bench import plots as jplots
from spmv_topk_tpu.eval import accuracy_model as jam
from spmv_topk_tpu.formats import create_sparse_matrix as jmatrix

import spmv_topk_tpu_torch as pt
from spmv_topk_tpu_torch.bench import accuracy_sweep, full_eval, plots
from spmv_topk_tpu_torch.bench import run_sweep
from spmv_topk_tpu_torch.formats import (create_query_batch,
                                         create_sparse_matrix)

from rescore_paths import load_both_natives

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the JAX package's measurements, which no run of the port's tools touches
RECORDS = ("RESULTS.json", "RESULTS.md", "results")
EVAL_CONFIGS = "c1,c2,c4,c5,c6,c7,c11"

# Every key the JAX full_eval writes, by configuration (full_eval.py:123-
# 389 and _run_dense_c6); test_jax_keys_are_the_jax_modules holds each to
# the JAX source.
ACC = ("precision", "ndcg", "kendall_tau")
THROUGHPUT = ("per_query_ms", "gnnz_per_sec", "hbm_gbps")
JAX_KEYS = {
    "c1_small_oracle": ACC,
    **{f"c2_1M_bf16_{c}": (*THROUGHPUT, "vs_fpga_baseline", "padding", *ACC,
                           *(("precision_raw", "rescore_pool")
                             if c != "i8s" else ()))
       for c in ("i8s", "i4s", "h16")},
    "c3_10M_i8s": (*THROUGHPUT, "nnz", "pack_seconds", "gen_seconds", *ACC),
    "c4_batched_8q": ("per_group_ms", "per_query_ms",
                      "aggregate_gnnz_per_sec"),
    "c5_service": ("p50_ms", "p90_ms", "p99_ms", "qps", "recall_at_10",
                   "recall_at_100", "num_queries"),
    "c6_dense_batch64": (
        *(f"{m}_{t}" for m in ("us_per_query", "gnnz_equiv_per_sec")
          for t in ("bf16_batch64", "int8_batch64", "int8_batch256")),
        "precision_bf16", "precision_int8", "us_per_query",
        "gnnz_equiv_per_sec", "precision"),
    "c7_glove_shape_i4s": (*THROUGHPUT, "nnz", "padding", *ACC),
    "c8_50M_1Gnnz_i4s": (*THROUGHPUT, "nnz", "hbm_gb", "pack_seconds",
                         "gen_seconds", *ACC),
    "c9_100M_2Gnnz_h16": (*THROUGHPUT, "nnz", "hbm_gb", "pack_seconds",
                          "gen_seconds", *ACC,
                          *(f"batch{q}_{m}" for q in (16, 64) for m in
                            ("ms_per_query", "aggregate_gnnz_per_sec"))),
    "c11_mtx_file_50Mnnz": ("per_query_ms", "gnnz_per_sec", "nnz", "mtx_gb",
                            "mtx_write_seconds", "mtx_parse_seconds",
                            "parse_mnnz_per_sec", "native_parser", *ACC),
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread: the plain sweeps' tensors are small, and the
    suite runs six workers on the host's cores, which more threads a
    worker only oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _digest(path):
    """sha256 of a file, or of every file under a directory."""
    h = hashlib.sha256()
    paths = [path] if os.path.isfile(path) else sorted(
        p for p in glob.glob(os.path.join(path, "**"), recursive=True)
        if os.path.isfile(p))
    for p in paths:
        h.update(p.encode())
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def _records():
    return {r: _digest(os.path.join(REPO, r)) for r in RECORDS
            if os.path.exists(os.path.join(REPO, r))}


@pytest.fixture(scope="module")
def evaluation(tmp_path_factory):
    """The port's full_eval at --scale 2000 on the CPU, run once: its
    results, its output directory, and the repository's records' digests
    before and after."""
    load_both_natives()
    out = str(tmp_path_factory.mktemp("eval"))
    before = _records()
    res = full_eval.main(["--scale", "2000", "--configs", EVAL_CONFIGS,
                          "--out-dir", out, "--device", "cpu"])
    return res, out, before, _records()


def _jax_names(*mods):
    """The names the JAX modules' sources can write: dict() keywords,
    string constants, and f-strings as patterns (each field any text)."""
    words, patterns = set(), []
    for mod in mods:
        for node in ast.walk(ast.parse(inspect.getsource(mod))):
            if isinstance(node, ast.keyword) and node.arg:
                words.add(node.arg)
            elif isinstance(node, ast.Constant) and isinstance(node.value,
                                                               str):
                words.add(node.value)
            elif isinstance(node, ast.JoinedStr):
                patterns.append(re.compile("".join(
                    re.escape(v.value) if isinstance(v, ast.Constant)
                    else ".+" for v in node.values)))
    return words, patterns


def test_jax_keys_are_the_jax_modules():
    """Each configuration name and key written above is one the JAX
    full_eval (and the serving loop it calls) can write."""
    from spmv_topk_tpu.bench import service as jservice

    words, patterns = _jax_names(jfe, jservice)
    for name, keys in JAX_KEYS.items():
        for k in (name, *keys):
            assert k in words or any(p.fullmatch(k) for p in patterns), \
                (name, k)


def test_full_eval_writes_every_jax_key(evaluation):
    """Every configuration run holds every key the JAX configuration
    writes; RESULTS.json and RESULTS.md land in --out-dir, the former
    equal to what main returned, the device named "cpu"."""
    res, out, _, _ = evaluation
    want = [n for n in JAX_KEYS if n.split("_")[0] in EVAL_CONFIGS.split(",")]
    assert sorted(res["configs"]) == sorted(want)
    for name in want:
        missing = set(JAX_KEYS[name]) - set(res["configs"][name])
        assert not missing, (name, missing)
    with open(os.path.join(out, "RESULTS.json")) as f:
        assert json.load(f) == json.loads(json.dumps(res))
    with open(os.path.join(out, "RESULTS.md")) as f:
        md = f.read()
    assert md.startswith("# RESULTS — measured on cpu")
    assert "spmv_topk_tpu_torch.bench.full_eval" in md
    assert res["device"] == "cpu"
    c = res["configs"]
    assert c["c1_small_oracle"]["precision"] == 1.0
    assert c["c6_dense_batch64"]["precision_bf16"] == 1.0
    assert c["c11_mtx_file_50Mnnz"]["native_parser"] is True
    for name in ("c2_1M_bf16_i4s", "c2_1M_bf16_h16"):
        assert c[name]["precision"] == 1.0 and c[name]["rescore_pool"] == 400


def test_full_eval_leaves_the_jax_records(evaluation):
    """RESULTS.json, RESULTS.md and results/ are byte for byte as before
    the run, and the merge keeps an earlier file's other configurations."""
    _, out, before, after = evaluation
    assert before and after == before
    path = os.path.join(out, "RESULTS.json")
    with open(path) as f:
        data = json.load(f)
    data["configs"]["c9_100M_2Gnnz_h16"] = {"kept": True}
    with open(path, "w") as f:
        json.dump(data, f)
    merged = full_eval.main(["--scale", "2000", "--configs", "c1",
                             "--out-dir", out, "--device", "cpu"])
    assert merged["configs"]["c9_100M_2Gnnz_h16"] == {"kept": True}
    # "c1" runs c1 alone: c11's entry is the one written before
    assert merged["configs"]["c11_mtx_file_50Mnnz"] == \
        data["configs"]["c11_mtx_file_50Mnnz"]
    assert merged["configs"]["c4_batched_8q"] == \
        data["configs"]["c4_batched_8q"]
    assert _records() == before


def test_c1_accuracy_matches_jax(evaluation):
    """full_eval._accuracy on c1's engine (10k rows, TopKSpMVConfig(k=100))
    gives the JAX function's precision, NDCG and Kendall tau."""
    res, _, _, _ = evaluation
    coo = jmatrix(10_000, 1024, 20, "gamma", seed=1)
    want = jfe._accuracy(JTopKSpMV(coo, JConfig(k=100)), coo)
    got = res["configs"]["c1_small_oracle"]
    assert set(got) == set(want)
    for m in want:
        assert abs(got[m] - want[m]) <= 1e-12, (m, got[m], want[m])


ACC_ARGS = dict(rows=4000, cols=256, deg=10, trials=2)


def test_accuracy_sweep_matches_jax():
    """run(rows=4000, cols=256, deg=10, trials=2) in both packages: the
    same structure, the production metrics equal at every K to 1e-12, and
    the raw mode's within what its tied scores can move (precision@K by at
    most one row of each trial's K), the production precision@K >= 0.95
    (tests/test_bench_modules.py's bar)."""
    got = accuracy_sweep.run(**ACC_ARGS, device="cpu")
    want = jas.run(**ACC_ARGS)
    assert {k: v for k, v in got.items() if k != "configs"} == \
        {k: v for k, v in want.items() if k != "configs"}
    assert [(c["dist"], c["mode"]) for c in got["configs"]] == \
        [(c["dist"], c["mode"]) for c in want["configs"]]
    for g, w in zip(got["configs"], want["configs"]):
        for K in got["ks"]:
            for m in ("precision", "kendall_tau", "ndcg"):
                d = abs(g["metrics"][K][m] - w["metrics"][K][m])
                if g["mode"] == "production":
                    assert d <= 1e-12, (g["dist"], K, m)
                elif m == "precision":
                    assert d <= 1.0 / K + 1e-12, (g["dist"], K, d)
            if g["mode"] == "production":
                assert g["metrics"][K]["precision"] >= 0.95


def test_raw_mode_returns_the_jax_values():
    """The accuracy sweep's raw mode (rescore_pool=0) on its gamma corpus:
    the top-100 values equal the JAX engine's bit for bit (only rows of
    tied scores may differ)."""
    rows, cols, deg = ACC_ARGS["rows"], ACC_ARGS["cols"], ACC_ARGS["deg"]
    cfg = dict(k=100, lane_k=8, max_cols=cols, query_codec="h16",
               width_quantum=2, fused_block_sublanes=1024, fold_tile=8,
               rescore_pool=400)
    q = create_query_batch(ACC_ARGS["trials"], cols, seed=8)[1]
    eng = pt.TopKSpMV(create_sparse_matrix(rows, cols, deg, "gamma", seed=7),
                      pt.TopKSpMVConfig(**cfg), device="cpu")
    jeng = JTopKSpMV(jmatrix(rows, cols, deg, "gamma", seed=7),
                     JConfig(**cfg))
    _, v = eng.query(q, k=100, rescore_pool=0)
    _, jv = jeng.query(q, k=100, rescore_pool=0)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


def test_accuracy_sweep_main_writes_out_dir(tmp_path, capsys):
    """main() writes its JSON and figure into --out-dir and prints each
    (dist, mode)'s metrics at K=100."""
    res = accuracy_sweep.main(["--rows", "600", "--cols", "128",
                               "--trials", "1", "--out-dir", str(tmp_path),
                               "--device", "cpu"])
    path = tmp_path / "accuracy_sweep.json"
    with open(path) as f:
        assert json.load(f) == json.loads(json.dumps(res))
    assert (tmp_path / "accuracy_sweep.png").exists()
    out = capsys.readouterr().out
    assert out.count("precision@100=") == 4 and f"wrote {path}" in out
    assert accuracy_sweep.DEFAULT_OUT_DIR == os.path.join(
        "build", "spmv_topk_tpu_torch", "eval")


@pytest.fixture(scope="module")
def sweep_dir(tmp_path_factory):
    """Two configurations of the port's sweep on the CPU (5 iterations
    each): the CSVs the figures read."""
    out = str(tmp_path_factory.mktemp("sweep"))
    run_sweep([800, 1200], [256], ["uniform"], [8], k=20, num_tests=5,
              out_dir=out, device="cpu")
    return out


def test_plot_aggregations_match_pandas(sweep_dir):
    """load_results and the figures' numbers over the port's CSVs equal
    the JAX module's pandas over the same files: the configurations in
    groupby order, exec-time mean and std after the warm-up, the error
    metrics' means, GNNZ/s."""
    df = jplots.load_results(sweep_dir)
    res = plots.load_results(sweep_dir)
    assert len(res) == len(df) == 10
    assert res.configs() == sorted(df["config"].unique())
    for col in ("iteration", "hw_exec_time_ms", "precision", "rows", "deg"):
        np.testing.assert_array_equal(res[col], df[col].to_numpy(float))
    g = (df[df.iteration >= 2].groupby("config")["hw_exec_time_ms"]
         .agg(["mean", "std"]))
    stats = plots.exec_time_stats(res)
    assert list(stats) == list(g.index)
    for c, (mean, std) in stats.items():
        assert mean == pytest.approx(g.loc[c, "mean"], rel=1e-12)
        assert std == pytest.approx(g.loc[c, "std"], rel=1e-12)
    errs = plots.error_means(res)
    for m in ("precision", "ndcg", "kendall_tau"):
        want = df.groupby("config")[m].mean()
        for c in res.configs():
            assert errs[m][c] == pytest.approx(want[c], rel=1e-12)
    nnz = df.groupby("config").apply(
        lambda x: x["rows"].iloc[0] * x["deg"].iloc[0], include_groups=False)
    t = df[df.iteration >= 2].groupby("config")["hw_exec_time_ms"].mean()
    want = (nnz / (t / 1e3)) / 1e9
    for c, v in plots.roofline_gnnz(res).items():
        assert v == pytest.approx(want[c], rel=1e-12)
    assert plots._parse_name(glob.glob(os.path.join(sweep_dir, "*.csv"))[0]
                             )["impl"] == "cpu-f32"


def test_figures_written(sweep_dir, tmp_path):
    """With matplotlib present each figure is written; main() prints the
    summary of every configuration."""
    res = plots.load_results(sweep_dir)
    plots.plot_exec_time(res, str(tmp_path))
    plots.plot_errors(res, str(tmp_path))
    plots.plot_roofline(res, str(tmp_path))
    for name in ("exec_time", "errors", "roofline"):
        assert (tmp_path / f"{name}.png").exists(), name
    out = tmp_path / "main"
    plots.main([sweep_dir, "--out", str(out)])
    assert sorted(os.listdir(out)) == ["errors.png", "exec_time.png",
                                       "roofline.png"]


def test_main_without_matplotlib(sweep_dir, tmp_path, monkeypatch, capsys):
    """Where matplotlib cannot be imported (the card's host) main() says
    the figures are skipped and prints the numbers they would draw."""
    def no_pyplot():
        raise ImportError("No module named 'matplotlib'")

    monkeypatch.setattr(plots, "_pyplot", no_pyplot)
    plots.main([sweep_dir, "--out", str(tmp_path)])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("figures skipped: ImportError")
    summary = json.loads(lines[1])["summary"]
    assert summary["chip"] == "h100" and summary["peak_gbps"] == 3350.0
    res = plots.load_results(sweep_dir)
    assert sorted(summary["configs"]) == res.configs()
    assert os.listdir(tmp_path) == []


def test_chip_peaks_are_the_cards():
    """The roofline's peaks are the H100's data-sheet HBM3 rate and the
    CPU's; the reference points are the paper's, as in the JAX module."""
    assert plots.CHIP_PEAKS_GBPS == {"h100": 3350.0, "cpu": 100.0}
    assert plots.REFERENCE_POINTS == jplots.REFERENCE_POINTS


def test_sparsity_ratios_match_jax(tmp_path, monkeypatch):
    """plot_sparsity's packing ratios equal the JAX module's (the same
    packer, at the configs' default blocks, which tests/conftest.py
    shrinks for the JAX package: undone here) and its figure is
    written."""
    import conftest
    import spmv_topk_tpu.config as jcfg

    monkeypatch.setattr(jcfg.TopKSpMVConfig, "__post_init__",
                        conftest._orig_post_init)
    coo = create_sparse_matrix(20_000, 512, 15, "gamma", seed=90)
    got = plots.plot_sparsity(coo, str(tmp_path), name="t")
    os.makedirs(tmp_path / "j")
    want = jplots.plot_sparsity(jmatrix(20_000, 512, 15, "gamma", seed=90),
                                str(tmp_path / "j"), name="t")
    assert got == want
    assert (tmp_path / "sparsity.png").exists()


def test_convergence_curves_match_the_model(tmp_path):
    """convergence_curves gives the JAX accuracy model's numbers, and
    plot_convergence writes its figure."""
    n, k, tests = 20_000, 100, 2
    cur = plots.convergence_curves(n, k, tests)
    for p in cur["partitions"]:
        assert p["closed_form"] == [
            jam.closed_form_precision(n, p["partitions"], k, pk)
            for pk in cur["lane_ks"]]
        assert p["monte_carlo"] == [
            jam.monte_carlo_precision(n, p["partitions"], k, pk,
                                      num_tests=tests, seed=1)
            for pk in (2, 4, 8)]
    for r in cur["rescore"]:
        assert r["precision"] == [
            jam.monte_carlo_rescore_precision(
                n, 128, k, 8, pool, noise_sigma=r["sigma"],
                num_tests=tests, seed=2) for pool in r["pools"]]
    path = plots.plot_convergence(str(tmp_path), n=n, k=k, num_tests=tests)
    assert os.path.exists(path)
