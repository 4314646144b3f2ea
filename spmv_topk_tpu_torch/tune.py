"""Autotuner: pick an engine configuration for a corpus + recall target.

The counterpart of ``spmv_topk_tpu.tune``. The reference ships four
pre-built FPGA variants (cores x MHz x bits, test_spmv_topk.py:42-47) and
the user picks one per workload; here the codec/fold/rescore space is a
config, so the library can pick for you. ``autotune`` builds candidate
engines on a row sample of the corpus, measures per-query sweep time and
precision against the exact gold, and returns the fastest config meeting
the precision target.

On the card (``device="cuda"``, the default) each candidate's sweep is
timed. ``measure=False`` ranks the candidates by the card's measured rates
instead (``bench.capacity.MEASURED``) and still verifies precision by
running the sample engines, on the CPU through the kernels' plain
versions — deterministic and hardware-free.

The layout order and the dense recommendation follow the port's
measurements on one NVIDIA H100 80GB HBM3 at 700 W (PERF.md section 6),
not the TPU's: see ``_candidates`` and ``DENSE_MIN_BATCH``.

Usage:
    cfg, report = autotune(coo, k=100, target_precision=0.98)
    eng = TopKSpMV(coo, cfg, device="cuda")
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .api import TopKSpMV
from .config import LANES, TopKSpMVConfig
from .formats.coo import CooMatrix
from .formats.synthetic import create_sample_vector
from .ops.gold import topk_exact

# The least expected batch for which autotune recommends the dense engine
# (bf16). On one NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py's dense
# and batch phases; PERF.md section 6) it took 0.197-0.199 ms a query in
# batches of 256 and 0.354-0.369 in batches of 64, against the sparse h16
# batch's 0.315 to 0.761 rescored, groups of 32, over the runs: dense was
# the faster at 256 in every run, at 64 in some; int8 took 0.358-0.360 /
# 0.479-0.487.
DENSE_MIN_BATCH = 256


def _candidates(k: int, max_cols: int, pool: int):
    """Candidate configs, fastest-first by the card's measured ladder
    (``bench.capacity.MEASURED``: h16 1,032 Gnnz/s (K1) > i8s 464, i4s 462,
    f32 443 (K7) on the 10M x 1024 corpus; one NVIDIA H100 80GB HBM3 at
    700 W, PERF.md section 6).

    h16 takes the octet stream at quantum 2 for single queries and for
    batches alike: K1 0.189 ms against the slice stream's K7 h16 0.340,
    and a group of 32 K6 h16 0.725 ms against K8 h16's 1.250 (PERF.md
    section 6). The JAX package flips batch workloads to the slice
    stream, whose batch kernel was the faster there."""
    octet = dict(fused_layout="octet", width_quantum=2)
    slice_ = dict(fused_layout="slice", width_quantum=2)
    cands = []
    if max_cols <= 1024:
        cands.append(dict(query_codec="h16", fold_tile=8, rescore_pool=pool,
                          **octet))
        cands.append(dict(query_codec="h16", fold_tile=8, rescore_pool=pool,
                          **slice_))
        cands.append(dict(query_codec="h16", fold_tile=1, rescore_pool=pool,
                          **octet))
    if max_cols <= 2048:
        cands.append(dict(query_codec="i4s", fold_tile=1, rescore_pool=pool,
                          **slice_))
    cands.append(dict(query_codec="i8s", fold_tile=1, rescore_pool=None,
                      **slice_))
    cands.append(dict(query_codec="f32", fold_tile=1, rescore_pool=None,
                      **slice_))
    return cands


def _sample(coo: CooMatrix, sample_rows: int) -> CooMatrix:
    if coo.num_rows <= sample_rows:
        return coo
    # contiguous prefix slice: cheap, and degree statistics are i.i.d.
    # across rows for embedding corpora (synthetic.py's generators are)
    return coo.row_slice(0, sample_rows)


def autotune(
    coo: CooMatrix,
    k: int = 100,
    *,
    target_precision: float = 0.98,
    sample_rows: int = 500_000,
    num_queries: int = 4,
    timing_reps: int = 5,
    measure: Optional[bool] = None,
    base: Optional[TopKSpMVConfig] = None,
    codecs: Optional[tuple] = None,
    expected_batch: int = 1,
    dense_hbm_budget_gb: float = 48.0,
    seed: int = 0,
    verbose: bool = False,
    device="cuda",
):
    """Pick the fastest TopKSpMVConfig meeting `target_precision` at `k`.

    Returns (config, report): report is one dict per candidate with its
    measured precision and (when measure) per-query milliseconds of its
    sweep on the sample (``timed_on`` names the device). measure=None
    resolves to True on a CUDA device. The sample engines are built on
    ``device``.

    If the dense bf16 form of the FULL corpus fits `dense_hbm_budget_gb`
    (default: 0.6 of the card's 80 GB, the dense engine's own budget on a
    card) and `expected_batch` >= ``DENSE_MIN_BATCH``, the report's first
    entry recommends ``DenseTopKSpMV`` instead — the sparse config is
    still returned for corpora that outgrow dense capacity.
    """
    device = torch.device(device)
    if measure is None:
        measure = device.type == "cuda"
    max_cols = -(-coo.num_cols // LANES) * LANES
    pool = max(4 * k, 100)
    sample = _sample(coo, sample_rows)
    queries = [create_sample_vector(coo.num_cols, seed=seed + i)
               for i in range(num_queries)]
    golds = [topk_exact(sample, q, k) for q in queries]

    report = []
    dense_gb = 2 * coo.num_rows * max_cols / 1e9
    if expected_batch >= DENSE_MIN_BATCH and dense_gb <= dense_hbm_budget_gb:
        report.append(dict(
            engine="DenseTopKSpMV", dense_bf16_gb=round(dense_gb, 2),
            note=f"dense bf16 fits ({dense_gb:.1f} GB) and batch >= "
                 f"{DENSE_MIN_BATCH}: on the card it took 0.197-0.199 ms a "
                 "query in batches of 256 against the sparse batch's "
                 "0.315-0.761 rescored (PERF.md) — prefer "
                 "ops.dense.DenseTopKSpMV"))

    # the card's measured ladder for the measure=False ranking
    from .bench.capacity import MEASURED

    cands = _candidates(k, max_cols, pool)
    if codecs is not None:  # restrict the search
        cands = [c for c in cands if c["query_codec"] in codecs]

    best = None
    for cand in cands:
        overrides = dict(cand, k=k, max_cols=max_cols)
        cfg = (dataclasses.replace(base, **overrides) if base
               else TopKSpMVConfig(**overrides))
        entry = dict(codec=cfg.query_codec, fold_tile=cfg.fold_tile,
                     rescore_pool=cfg.rescore_pool,
                     fused_layout=cfg.fused_layout,
                     width_quantum=cfg.width_quantum)
        try:
            eng = TopKSpMV(sample, cfg, device=device)
        except ValueError as e:  # e.g. codec/geometry constraint
            entry["error"] = str(e)
            report.append(entry)
            continue

        precs = []
        for q, (gi, _) in zip(queries, golds):
            idx, _ = eng.query(q, k)
            precs.append(len(set(idx.cpu().numpy().tolist())
                              & set(gi.tolist())) / k)
        entry["precision"] = float(np.mean(precs))

        if measure:
            # back-to-back sweeps of tables packed beforehand, slope-timed:
            # one sweep is sub-ms, and the fixed cost of a run (the card's
            # hold, the synchronize) would mis-rank codecs
            from .utils.profiling import held_runner, timed_slope

            tabs8 = [eng._table(queries[i % num_queries])[0]
                     for i in range(8)]
            run_n = held_runner(
                device, lambda i: eng.table_candidates(tabs8[i % 8]))
            sweep_s = timed_slope(run_n, 4, 104, reps=timing_reps)
            entry["per_query_ms"] = round(sweep_s * 1e3, 4)
            entry["rank_key"] = entry["per_query_ms"]
            entry["timed_on"] = (torch.cuda.get_device_name(device)
                                 if device.type == "cuda" else "cpu")
        else:
            # rank by the measured ladder. fold_tile 1 has no rate of its
            # own on the card: it takes its codec's, and a tie keeps the
            # candidates' order (fold 8 first)
            rate = MEASURED[cfg.query_codec]["gnnz_core"]
            entry["rank_key"] = round(1e3 / rate, 4)
            entry["ranked_by"] = ("the card's measured rates, "
                                  "bench/capacity.py MEASURED (measure=False)")

        entry["meets_target"] = entry["precision"] >= target_precision
        report.append(entry)
        if entry["meets_target"] and (
                best is None or entry["rank_key"] < best[0]["rank_key"]):
            best = (entry, cfg)
        if verbose:
            print(entry)

    if best is None:
        # nothing met the bar: fall back to exact f32 (always 1.0 up to
        # bf16 storage noise) and say so in the report
        cfg = TopKSpMVConfig(k=k, max_cols=max_cols, width_quantum=2)
        report.append(dict(codec="f32", note="fallback: no candidate met "
                           f"target_precision={target_precision}"))
        return cfg, report
    return best[1], report
