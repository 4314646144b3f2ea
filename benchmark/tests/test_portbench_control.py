"""The check fails what it must: the control (the configuration's lower
precision) and a timed path broken underneath, and passes the program.

At a size a test run holds: on the CPU the program runs its kernels'
plain versions; the ``cuda`` test runs the same on the card.
"""

import json
import os

import pytest
import torch

from benchmark import harness, readings

from conftest import REPO, cpu_run, make_tiny_root

with open(os.path.join(REPO, "BENCHMARK.json")) as _fh:
    WORKLOADS = [w["name"] for w in json.load(_fh)["workloads"]]
BATCH = [w for w in WORKLOADS if w.endswith(".batch64")]


def _readings(root, workload, device, seeds=(2**31 + 21, 2**31 + 22)):
    cell = harness.Cell(root, workload)
    out = []
    for seed in seeds:
        coo, pool, fp = harness.inputs(cell, seed, device)
        for variant in ("program", "control"):
            out.append(readings.reading(cell, seed, device, variant, 0.3, coo,
                                        pool, fp, lambda s: None))
    return out


def _assert_separates(rs):
    for r in rs:
        assert r["correct"] is (r["variant"] == "program"), r
        if r["variant"] == "control":
            # the control fails by a number, not by a malformed answer
            assert r["numbers"]["bad_answers"] == 0 and r["malformed"] == 0


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails_and_the_program_passes(tiny_root, workload):
    _assert_separates(_readings(tiny_root, workload, torch.device("cpu")))


def _half_batch(monkeypatch):
    """query_batch answers the first half of its queries and repeats
    those answers for the rest."""
    from spmv_topk_tpu_torch import api

    real = api.TopKSpMV.query_batch

    def half(self, queries, *a, **kw):
        h = max(len(queries) // 2, 1)
        idx, vals = real(self, queries[:h], *a, **kw)
        rep = -(-len(queries) // h)
        return (idx.repeat(rep, 1)[:len(queries)],
                vals.repeat(rep, 1)[:len(queries)])

    monkeypatch.setattr(api.TopKSpMV, "query_batch", half)


def _altered(monkeypatch):
    """finalize gives each answer's first row id one higher."""
    from spmv_topk_tpu_torch import api

    real = api.finalize_topk_batch

    def altered(*a, **kw):
        rows, vals = real(*a, **kw)
        rows = rows.clone()
        rows[:, 0] += 1
        return rows, vals

    monkeypatch.setattr(api, "finalize_topk_batch", altered)
    monkeypatch.setattr(api, "finalize_topk",
                        lambda *a, **kw: tuple(t[0] for t in altered(
                            *(x[None] if i < 2 else x for i, x in enumerate(a)),
                            **kw)))


FAULTS = [("half_batch", w) for w in BATCH] + \
    [("answer_altered", w) for w in WORKLOADS]


@pytest.mark.parametrize("fault,workload", FAULTS)
def test_a_broken_timed_path_is_not_correct(tiny_root, monkeypatch, fault,
                                            workload):
    assert cpu_run(tiny_root, workload)["correct"] is True
    {"half_batch": _half_batch, "answer_altered": _altered}[fault](monkeypatch)
    r = cpu_run(tiny_root, workload)
    assert r["correct"] is False
    assert r["check"]["score_gap"]["value"] > r["check"]["score_gap"]["limit"] \
        or r["check"]["rank_gap"]["value"] > r["check"]["rank_gap"]["limit"] \
        or r["check"]["bad_answers"]["value"] > 0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the control on the card runs on the chip")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails_on_the_card(card, tmp_path, workload):
    root = make_tiny_root(tmp_path / "checkout", rows=200_000)
    _assert_separates(_readings(root, workload, card))
