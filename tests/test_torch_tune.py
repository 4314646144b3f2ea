"""The port's autotuner (``spmv_topk_tpu_torch.autotune``) against the JAX
package's on the CPU: the five cases of tests/test_tune.py in both
packages, ``measure=False`` (ranked by each package's measured rates:
the TPU's there, the card's here), the sample engines' precision checked
by running them (the port's plain kernels; the JAX kernels in interpret
mode).

Where the rules agree the two return the same config and report the same
precision for each candidate. Where the card's numbers change a rule, the
port's choice is pinned with the figures behind it (PERF.md section 6,
one NVIDIA H100 80GB HBM3 at 700 W):
  - h16 keeps the octet layout for batch workloads: a group of 32 took
    0.725 ms on the octet stream (K6 h16) against 1.250 on the slice
    stream (K8 h16); the JAX package flips to the slice layout;
  - the dense engine is recommended from batches of 256 (bf16 0.197-0.199
    ms a query at 256, 0.354-0.369 at 64, against the sparse batch's
    0.315-0.761 rescored: dense the faster at 256 in every run, at 64 in
    some); the JAX package recommends it from 16.
"""

import dataclasses

import numpy as np
import pytest

from spmv_topk_tpu import autotune as jautotune
from spmv_topk_tpu.config import TopKSpMVConfig as JConfig
from spmv_topk_tpu.formats import create_sparse_matrix as jmatrix
from spmv_topk_tpu.tune import _candidates as j_candidates

import spmv_topk_tpu_torch as pt
from spmv_topk_tpu_torch import tune
from spmv_topk_tpu_torch.bench.capacity import MEASURED
from spmv_topk_tpu_torch.formats import (create_sample_vector,
                                         create_sparse_matrix)
from spmv_topk_tpu_torch.ops.gold import topk_exact

from rescore_paths import load_both_natives

GEOM = dict(block_sublanes=64, fused_block_sublanes=64)   # test_tune's SMALL


@pytest.fixture(scope="module", autouse=True)
def _natives():
    # the h16 candidates rescore: both packages on their native rescore
    load_both_natives()


def _both(rows, cols, deg, dist, seed, **kw):
    """autotune on the same corpus in both packages: (port cfg, port
    report, JAX cfg, JAX report)."""
    jcfg, jrep = jautotune(jmatrix(rows, cols, deg, dist, seed=seed),
                           measure=False, base=JConfig(**GEOM), **kw)
    coo = create_sparse_matrix(rows, cols, deg, dist, seed=seed)
    cfg, rep = tune.autotune(coo, measure=False,
                             base=pt.TopKSpMVConfig(**GEOM), device="cpu",
                             **kw)
    return coo, cfg, rep, jcfg, jrep


def _same_config(cfg, jcfg):
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)


def _candidate_precisions(report):
    return [(r["codec"], r["fold_tile"], r["fused_layout"],
             r.get("precision")) for r in report if "codec" in r
            and "note" not in r]


def test_autotune_picks_h16_with_rescore():
    coo, cfg, rep, jcfg, jrep = _both(
        3000, 512, 10, "gamma", 30, k=50, target_precision=0.98,
        num_queries=2, codecs=("h16", "i8s"))
    _same_config(cfg, jcfg)
    assert _candidate_precisions(rep) == _candidate_precisions(jrep)
    assert cfg.query_codec == "h16" and cfg.fused_layout == "octet"
    assert cfg.rescore_pool and cfg.rescore_pool >= 4 * 50
    assert cfg.max_cols == 512
    assert all(r["ranked_by"].startswith("the card's") for r in rep)
    # the returned config really delivers the target end to end
    eng = pt.TopKSpMV(coo, cfg, device="cpu")
    q = create_sample_vector(512, seed=33)
    gi, _ = topk_exact(coo, q, 50)
    idx, _ = eng.query(q)
    assert len(set(idx.numpy().tolist()) & set(gi.tolist())) / 50 >= 0.98


def test_autotune_headlines_octet():
    _, cfg, rep, jcfg, jrep = _both(
        3000, 512, 10, "gamma", 35, k=50, target_precision=0.98,
        num_queries=2, codecs=("h16",))
    _same_config(cfg, jcfg)
    assert _candidate_precisions(rep) == _candidate_precisions(jrep)
    assert (cfg.fused_layout, cfg.width_quantum, cfg.fold_tile) == \
        ("octet", 2, 8)


def test_candidates_keep_octet_for_batches():
    """The card's layout rule (module docstring): octet first whatever the
    batch, where the JAX package's batch list leads with slice."""
    cands = tune._candidates(50, 512, 200)
    assert cands[0]["fused_layout"] == "octet"
    assert cands[0]["width_quantum"] == 2
    assert j_candidates(50, 512, 200, expected_batch=1) == cands
    assert j_candidates(50, 512, 200, expected_batch=32)[0][
        "fused_layout"] == "slice"
    # the codec gates by width are the JAX package's
    for cols in (1024, 1152, 2048, 4096):
        assert [c["query_codec"] for c in tune._candidates(50, cols, 200)] \
            == [c["query_codec"] for c in j_candidates(50, cols, 200)]


def test_autotune_unreachable_target_falls_back_exact():
    _, cfg, rep, jcfg, jrep = _both(
        1500, 256, 8, "uniform", 31, k=20, target_precision=1.01,
        num_queries=1, codecs=("h16",))
    # the fallback takes the default geometry, which tests/conftest.py
    # shrinks in the JAX package only
    assert dataclasses.asdict(cfg) == dict(
        dataclasses.asdict(jcfg), block_sublanes=512,
        fused_block_sublanes=1024)
    assert cfg.query_codec == "f32"
    assert any("fallback" in r.get("note", "") for r in rep)


def test_autotune_dense_recommendation_batch():
    """JAX recommends the dense engine at batch 32; the port from 256, and
    keeps the octet h16 config for the sparse engine (module docstring).
    Single-query workloads get no dense entry in either."""
    coo, cfg, rep, jcfg, jrep = _both(
        1500, 256, 8, "uniform", 32, k=20, num_queries=1, expected_batch=32,
        codecs=("h16",))
    assert jrep[0].get("engine") == "DenseTopKSpMV"
    assert not any(r.get("engine") for r in rep)
    assert (jcfg.fused_layout, cfg.fused_layout) == ("slice", "octet")
    assert dataclasses.asdict(cfg) == dict(
        dataclasses.asdict(jcfg), fused_layout="octet")
    _, rep256 = tune.autotune(coo, k=20, measure=False, num_queries=1,
                              expected_batch=tune.DENSE_MIN_BATCH,
                              base=pt.TopKSpMVConfig(**GEOM),
                              codecs=("h16",), device="cpu")
    assert rep256[0].get("engine") == "DenseTopKSpMV"
    assert rep256[0]["dense_bf16_gb"] == round(2 * 1500 * 256 / 1e9, 2)
    # a budget the bf16 form does not fit takes the dense entry away
    _, small = tune.autotune(coo, k=20, measure=False, num_queries=1,
                             expected_batch=256, dense_hbm_budget_gb=1e-4,
                             base=pt.TopKSpMVConfig(**GEOM),
                             codecs=("h16",), device="cpu")
    assert not any(r.get("engine") for r in small)
    _, one = tune.autotune(coo, k=20, measure=False, num_queries=1,
                           expected_batch=1, base=pt.TopKSpMVConfig(**GEOM),
                           codecs=("h16",), device="cpu")
    assert not any(r.get("engine") for r in one)


def test_autotune_samples_large_corpus():
    _, cfg, rep, jcfg, jrep = _both(
        5000, 256, 8, "gamma", 34, k=20, num_queries=1, sample_rows=1500,
        codecs=("i8s",))
    _same_config(cfg, jcfg)
    assert _candidate_precisions(rep) == _candidate_precisions(jrep)
    assert cfg.k == 20
    assert all("error" not in r for r in rep if "codec" in r), rep


def test_autotune_measure_times_the_sweep():
    """measure=True times each candidate's sweep on tables packed
    beforehand (here on the CPU, so ``timed_on`` says cpu) and ranks by
    it; measure=None resolves to False on the CPU."""
    coo = create_sparse_matrix(1500, 256, 8, "gamma", seed=36)
    kw = dict(k=20, num_queries=2, base=pt.TopKSpMVConfig(**GEOM),
              codecs=("h16", "i8s"), device="cpu")
    cfg, rep = tune.autotune(coo, measure=True, timing_reps=1, **kw)
    assert [r["timed_on"] for r in rep] == ["cpu"] * 4
    assert all(r["per_query_ms"] > 0 and r["rank_key"] == r["per_query_ms"]
               for r in rep)
    best = min((r for r in rep if r["meets_target"]),
               key=lambda r: r["rank_key"])
    assert (cfg.query_codec, cfg.fused_layout, cfg.fold_tile) == \
        (best["codec"], best["fused_layout"], best["fold_tile"])
    _, auto = tune.autotune(coo, **kw)
    assert all("per_query_ms" not in r for r in auto)
    assert np.isclose(auto[0]["rank_key"],
                      1e3 / MEASURED["h16"]["gnnz_core"], atol=1e-4)
