"""The port's command line (``spmv_topk_tpu_torch.cli.main``) against the
JAX package's on the CPU.

The argv of tests/test_bench.py:24 goes to both packages' ``main``, the
port's with ``--device cpu`` (its plain kernels; the JAX engine runs its
Pallas kernels in interpret mode). Held equal: the printed precision and,
row for row, the CSV's indices, values (5 decimals), error counts and
quality columns. Times are not compared.
"""

import csv
import io

import pytest

import spmv_topk_tpu.tune as jtune
from spmv_topk_tpu.cli import main as jmain

from spmv_topk_tpu_torch import tune as ptune
from spmv_topk_tpu_torch.cli import main

from rescore_paths import load_both_natives

ARGV = ["--synthetic", "1500", "256", "8", "gamma", "-k", "20", "-t", "2",
        "--codec", "h16", "--rescore-pool", "80"]
UNTIMED = ("iteration", "error_idx", "error_val", "k", "sw_res_idx",
           "sw_res_val", "hw_res_idx", "hw_res_val", "precision", "ndcg",
           "kendall_tau")


@pytest.fixture(scope="module", autouse=True)
def _natives():
    # the rescored runs: both packages on their native rescore
    load_both_natives()


def _run(fn, argv, tmp_path, capsys, name):
    path = tmp_path / f"{name}.csv"
    assert fn(argv + ["--csv", str(path)]) == 0
    out = capsys.readouterr().out
    rows = [{c: r[c] for c in UNTIMED}
            for r in csv.DictReader(io.StringIO(path.read_text()))]
    return out, rows


def _precision(out):
    return float(out.split("precision")[-1].split(";")[0])


@pytest.mark.parametrize("extra", [[], ["--autotune"],
                                   ["--engine", "dense"]],
                         ids=["h16", "autotune", "dense"])
def test_cli_matches_jax(tmp_path, capsys, monkeypatch, extra):
    """The same printed precision and CSV rows; with --autotune the same
    chosen config (measure=False in both on the CPU; each tuner's first
    two candidates, the octet and slice h16 ones, to keep the JAX
    interpret-mode engines few: tests/test_torch_tune.py compares whole
    searches), with --engine dense the dense engines' answers."""
    for mod in (jtune, ptune):
        first = mod._candidates
        monkeypatch.setattr(mod, "_candidates",
                            lambda *a, first=first, **kw: first(*a, **kw)[:2])
    jout, jrows = _run(jmain, ARGV + extra, tmp_path, capsys, "jax")
    out, rows = _run(main, ARGV + extra + ["--device", "cpu"], tmp_path,
                     capsys, "port")
    assert _precision(out) == _precision(jout) >= 0.95
    assert rows == jrows and len(rows) == 2
    assert out.rstrip().endswith(jout.rstrip().split(" over ")[-1])
    if extra == ["--autotune"]:
        tuned = [line for line in out.splitlines()
                 if line.startswith("autotune:")]
        assert tuned == [line for line in jout.splitlines()
                         if line.startswith("autotune:")]
        assert tuned == ["autotune: codec=h16 layout=octet quantum=2 "
                         "fold_tile=8 rescore_pool=100"]


def test_cli_mesh_and_debug(tmp_path, capsys):
    """--mesh on the CPU shards onto one CPU device and serves the rows of
    the unsharded engine; -d prints each iteration; no matrix is an
    error."""
    out, rows = _run(main, ARGV + ["--device", "cpu", "-d"], tmp_path,
                     capsys, "one")
    assert "iter 0: exec" in out and "iter 1: exec" in out
    mout, mrows = _run(main, ARGV + ["--device", "cpu", "--mesh"], tmp_path,
                       capsys, "mesh")
    assert [r["hw_res_idx"] for r in mrows] == \
        [r["hw_res_idx"] for r in rows]
    assert _precision(mout) == _precision(out)
    with pytest.raises(SystemExit):
        main(["-k", "5", "--device", "cpu"])
