"""The port's experiment drivers (``spmv_topk_tpu_torch/experiments``:
padding_lab, cfg_sweep, q1_ab, octet_lab, octet_batch_lab,
octet_block_lab, octet_multicall_lab) against the JAX drivers of
experiments/ on the CPU.

padding_lab's ``decompose`` is host arithmetic and equals the JAX one
number for number. The others time sweeps: here each ``main`` runs at
2,000 rows on the CPU (the kernels' plain versions; the times mean
nothing) with its run lengths and repetitions set small through the
module globals, as tests/test_torch_labs.py sets the labs'; its printed
JSON lines are its results, and its checks hold: q1_ab's precision@100
spot checks equal the JAX engine's on the same corpus and query, and
octet_multicall_lab's one-launch-a-bucket arm agrees with the one-launch
sweep. The JAX drivers run at import or read bench.py's cache, so their
surface is read from their source (``ast``), not imported.
"""

import ast
import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

import experiments.padding_lab as jpad
from spmv_topk_tpu import TopKSpMV as JTopKSpMV
from spmv_topk_tpu import TopKSpMVConfig as JConfig
from spmv_topk_tpu.formats import create_query_batch as jqueries
from spmv_topk_tpu.formats import create_sparse_matrix as jmatrix
from spmv_topk_tpu.ops.gold import topk_exact as jtopk_exact

from spmv_topk_tpu_torch.experiments import (cfg_sweep, octet_batch_lab,
                                             octet_block_lab, octet_lab,
                                             octet_multicall_lab,
                                             padding_lab, q1_ab)
from spmv_topk_tpu_torch.experiments import _drivers

from rescore_paths import load_both_natives

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = 2000
CPU = ["--rows", str(ROWS), "--device", "cpu"]
DRIVERS = dict(padding_lab=padding_lab, cfg_sweep=cfg_sweep, q1_ab=q1_ab,
               octet_lab=octet_lab, octet_batch_lab=octet_batch_lab,
               octet_block_lab=octet_block_lab,
               octet_multicall_lab=octet_multicall_lab)
# JAX drivers' public functions the port has no function for, by design:
# each builds a jitted scan of sweeps (the port's runs go through
# _drivers.single_runner / batch_runner on the engine's entry points)
JAX_ONLY = {("q1_ab", "single_fn"), ("q1_ab", "batch_fn")}
# parameters that differ by design: octet_multicall_lab's runner takes the
# arm's sweep, where the JAX one takes a config whose octet_multicall
# picks the arm (no config knob picks it in the port)
PARAMS_DIFFER = {("octet_multicall_lab", "runner")}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread: the plain sweeps' tensors are small, and the
    suite runs six workers on the host's cores, which more threads a
    worker only oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _small(monkeypatch):
    """Run lengths and repetitions of one or two sweeps."""
    for mod, vals in ((cfg_sweep, dict(SHORT=1, LONG=2, REPS=1)),
                      (q1_ab, dict(SINGLE=(1, 2, 1), BATCH=(1, 2, 1), QB=2)),
                      (octet_lab, dict(SINGLE=(1, 2), BATCH_GROUPS=(1, 2),
                                       BATCH_QS=(2,))),
                      (octet_batch_lab, dict(REPS=1, SUBGROUP=1)),
                      (octet_block_lab, dict(SHORT=1, LONG=2, REPS=1)),
                      (octet_multicall_lab, dict(SHORT=1, LONG=2))):
        for name, v in vals.items():
            assert hasattr(mod, name), (mod.__name__, name)
            monkeypatch.setattr(mod, name, v)


def _run(mod, argv):
    """mod.main(argv): its results, held equal to the JSON lines it
    printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = mod.main(argv)
    lines = [json.loads(line) for line in buf.getvalue().splitlines()
             if line.startswith("{")]
    assert lines == json.loads(json.dumps(res))
    return res


@pytest.mark.parametrize("rows,quantum,frac,tgt", [
    (20_000, 2, 0.01, 1024), (20_000, 1, 0.01, 1024),
    (20_000, 1, 0.005, 1024), (7_777, 4, 0.02, 512), (300, 2, 0.01, 64)])
def test_padding_decompose_matches_jax(rows, quantum, frac, tgt):
    got = padding_lab.decompose(rows, quantum=quantum, budget_frac=frac,
                                tgt=tgt)
    want = jpad.decompose(rows, quantum=quantum, budget_frac=frac, tgt=tgt)
    assert list(got) == list(want)
    for k in want:
        assert got[k] == want[k], k


def test_padding_main():
    """main() prints the JAX script's three decompositions as JSON."""
    res = _run(padding_lab, ["--rows", "20000"])
    assert [(r["quantum"], r["budget_frac"]) for r in res] == \
        list(padding_lab.CASES)
    for r in res:
        want = jpad.decompose(20_000, quantum=r["quantum"],
                              budget_frac=r["budget_frac"])
        assert {k: r[k] for k in want} == want


def test_cfg_sweep_main():
    """Two geometries of the sweep, each beside the stream floor."""
    res = _run(cfg_sweep, [*CPU, "2,1024", "4,512,8"])
    assert [(r["quantum"], r["tgt"], r["tile"]) for r in res] == \
        [(2, 1024, 1), (4, 512, 8)]
    for r in res:
        assert r["rows"] == ROWS and r["device"] == "cpu"
        assert all(np.isfinite(r[k]) for k in ("per_query_ms", "floor_ms",
                                                "ratio", "padding"))
    assert cfg_sweep.CASES == ((2, 1024, 1), (2, 1024, 8))  # the JAX's


def test_q1_ab_precision_matches_jax():
    """Both quanta run single and batch; each precision@100 spot check
    (query seed 3, pool 400) equals the JAX engine's."""
    load_both_natives()
    res = _run(q1_ab, CPU)
    assert [r["quantum"] for r in res] == [2, 1]
    jcoo = jmatrix(ROWS, 1024, 20, "gamma", seed=1)
    q = jqueries(1, 1024, seed=3)[0]
    gi, _ = jtopk_exact(jcoo, q, 100)
    for r in res:
        assert np.isfinite(r["single_ms"] + r["batch_ms_per_query"])
        jeng = JTopKSpMV(jcoo, JConfig(
            k=100, max_cols=1024, query_codec="h16",
            width_quantum=r["quantum"], fused_block_sublanes=1024,
            fold_tile=8, rescore_pool=400))
        ki = np.asarray(jeng.query(q)[0])
        want = len(set(gi.tolist()) & set(ki.tolist())) / 100
        assert r["precision_at_100"] == want == 1.0


@pytest.mark.parametrize("batch", [False, True], ids=["single", "batch"])
def test_octet_lab_main(batch):
    res = _run(octet_lab, [*CPU, "--reps", "1", *(["--batch"] if batch
                                                  else [])])
    timed = [r for r in res if "ms_per_query" in r]
    if batch:
        assert [r["variant"] for r in timed] == ["batch-slice-q2",
                                                 "batch-octet-q2"]
        assert "octet_vs_slice" in res[-1]
    else:
        assert [r["variant"] for r in timed] == ["slice-q2", "octet-q2",
                                                 "octet-q1"]
        assert [r["variant"] for r in res if "vs_slice_q2" in r] == \
            ["octet-q2", "octet-q1"]


def test_octet_batch_lab_main():
    """slice-q2 against octet-q1 at Q = 2; the batch_subgroup arm is
    octet-q1's measurement, marked as such."""
    res = _run(octet_batch_lab, [*CPU, "2"])
    timed = {r["variant"]: r for r in res if "ms_per_query" in r}
    assert sorted(timed) == ["octet-q1", "octet-q1-sub1", "slice-q2"]
    sub = dict(timed["octet-q1-sub1"])
    assert sub.pop("note") == octet_batch_lab.SUBGROUP_NOTE
    assert sub.pop("variant") == "octet-q1-sub1"
    assert {k: v for k, v in timed["octet-q1"].items() if k != "variant"} \
        == sub
    assert "octet_over_slice_batch32" not in res[-1]


def test_octet_block_lab_main():
    res = _run(octet_block_lab, [*CPU, "octet-q1-b2048", "octet-q8-b1024"])
    geo = [r for r in res if "buckets" in r]
    assert [r["variant"] for r in geo] == ["octet-q1-b2048", "octet-q8-b1024"]
    assert geo[0]["buckets"] > geo[1]["buckets"]
    timed = [r["variant"] for r in res if "ms_per_query" in r]
    assert timed == ["octet-q1-b2048", "octet-q8-b1024"]
    with pytest.raises(SystemExit, match="unknown variant"):
        octet_block_lab.main([*CPU, "octet-q3"])


def test_octet_multicall_lab_main():
    """The multicall arm (K1 once a bucket, merged per lane) holds the
    one-launch sweep's top distinct scores on every lane, and both arms
    are timed."""
    res = _run(octet_multicall_lab, [*CPU, "1"])
    (check,) = [r for r in res if "correctness" in r]
    assert check["launches_per_query"]["multicall"] == res[0]["buckets"] > 1
    assert [r["arm"] for r in res if "ms_per_query" in r] == \
        ["onecall", "multicall"]


def test_multicall_merge_equals_the_one_launch_sweep():
    """With tie-safe buffers the merged per-bucket buffers equal the
    one-launch sweep's values lane for lane."""
    coo = _drivers.corpus(ROWS)
    cfg = _drivers.h16_config(fused_layout="octet", width_quantum=2,
                              fused_block_sublanes=1024, fold_tile=8,
                              tie_safe_topk=True)
    eng, _ = _drivers.build(coo, cfg, "cpu")
    for table in _drivers.query_tables(eng, 2, seed=5):
        v, _ = eng.table_candidates(table)
        mv, _ = octet_multicall_lab.multicall_candidates(eng, table)
        torch.testing.assert_close(mv, v, rtol=0, atol=0)


def _functions(path):
    tree = ast.parse(open(path).read())
    return {n.name: [a.arg for a in n.args.args] for n in tree.body
            if isinstance(n, ast.FunctionDef) and not n.name.startswith("_")}


@pytest.mark.parametrize("name", sorted(DRIVERS))
def test_driver_surface(name):
    """Every public function of the JAX driver is in the port's driver
    (but the written jit-scan builders), its parameters first in the same
    order; main takes argv, and importing the module runs nothing."""
    jfuncs = _functions(os.path.join(REPO, "experiments", f"{name}.py"))
    mod = DRIVERS[name]
    pfuncs = _functions(mod.__file__)
    for fn, params in jfuncs.items():
        if (name, fn) in JAX_ONLY:
            assert fn not in pfuncs
            continue
        assert fn in pfuncs, fn
        if fn != "main" and (name, fn) not in PARAMS_DIFFER:
            # the same parameters first, or after a leading one the JAX
            # function reads from a module global (the corpus)
            got = pfuncs[fn]
            assert got[:len(params)] == params or \
                got[1:len(params) + 1] == params, (fn, got)
    assert pfuncs["main"] == ["argv"]
