"""Full BASELINE.json evaluation: runs the named configurations and writes
RESULTS.json + RESULTS.md into an output directory.

The counterpart of ``spmv_topk_tpu.bench.full_eval``, with its
configurations, names, keys and rounding:
  1. matrix_10000_1024_20_gamma-style exact CPU oracle check
  2. 1M x 1024 gamma, the production codecs (i8s, i4s, h16), one device
  3. 10M x 1024, reduced precision, K=100, single host
  4. batched queries (the multi-query sweep, groups of 8)
  5. serving loop: latency percentiles + recall@10/@100
  6. dense batch engine (when the dense form fits the budget)
  7. GloVe-shaped workload (2.2M x 300, the reference's real dataset
     geometry) with the i4s + rescore production mode
  8. billion-nnz single-device capacity demo (50M x 1024, i4s)
  9. BASELINE config-4 geometry on one device: 100M x 1024, ~2G nnz, h16,
     with multi-query groups up to 64
 11. a real MTX file at scale through the native parser

A sweep's time is the slope of back-to-back sweeps of query tables
packed beforehand (``utils.profiling.timed_slope`` of a
``held_runner``: each timed run starts behind a hold of the stream and
ends in a synchronize), so it is the card's time a sweep, as the JAX package's
jitted scan of sweeps is, and not the host's launch rate.

The results go to ``--out-dir`` (default
``build/spmv_topk_tpu_torch/eval/``), never to the repository's own
RESULTS.json / RESULTS.md, which hold the JAX package's measurements.

Usage: python -m spmv_topk_tpu_torch.bench.full_eval [--small]
           [--configs c2,c7] [--out-dir DIR] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import subprocess
import time

import numpy as np
import torch

from ..api import TopKSpMV
from ..config import TopKSpMVConfig
from ..eval import metrics
from ..formats.synthetic import create_sparse_matrix, create_query_batch
from ..ops.gold import topk_exact
from ..ops.quantized_query import pack_query_tables
from ..utils.profiling import held_runner, timed_slope
from .accuracy_sweep import DEFAULT_OUT_DIR
from .service import run_service

BASELINE_GNNZ = 76.9


def _throughput(eng, coo, nq=104):
    """Median-slope per-query seconds over back-to-back sweeps
    (``table_candidates``) of nq query tables packed beforehand."""
    tabs = [eng._table(q)[0]
            for q in create_query_batch(nq, coo.num_cols, seed=2)]
    step = lambda i: eng.table_candidates(tabs[i])  # noqa: E731
    return timed_slope(held_runner(eng.device, step), 4, nq)


def _group_tables(eng, num_queries, seed):
    """One group's (Q, rows, 128) query tables on the engine's device."""
    qs = create_query_batch(num_queries, eng.num_cols, seed=seed)
    padded = np.zeros((num_queries, eng.config.max_cols), np.float32)
    padded[:, :eng.num_cols] = qs
    tabs, _ = pack_query_tables(padded, eng.config.query_codec)
    return torch.from_numpy(tabs).to(eng.device)


def _batch_slope(eng, groups, short):
    """Median-slope seconds a group over back-to-back batch sweeps
    (``batch_candidates``) of the groups' tables."""
    return timed_slope(
        held_runner(eng.device, lambda i: eng.batch_candidates(groups[i])),
        short, len(groups))


def _accuracy(eng, coo, k=100, trials=3):
    precs, ndcgs, taus = [], [], []
    for t in range(trials):
        q = create_query_batch(1, coo.num_cols, seed=50 + t)[0]
        ki = eng.query(q, k)[0].cpu().numpy()
        gi, _ = topk_exact(coo, q, k)
        precs.append(metrics.precision_at_k(gi, ki))
        ndcgs.append(metrics.ndcg(gi, ki))
        taus.append(metrics.kendall_tau(gi, ki))
    return dict(precision=float(np.mean(precs)), ndcg=float(np.mean(ndcgs)),
                kendall_tau=float(np.mean(taus)))


def _host_peak_gb():
    """The process's peak resident memory so far, GB (Linux: ru_maxrss
    is in KiB)."""
    return round(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
                 * 1024 / 1e9, 2)


def describe_device(device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` prints them (the torch name
    where nvidia-smi cannot be run), or ``cpu``."""
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", str(index)],
            capture_output=True, text=True, timeout=60)
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return torch.cuda.get_device_name(device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true",
                    help="shrink matrices ~10x for a quick pass")
    ap.add_argument("--scale", type=int, default=None,
                    help="explicit shrink divisor (overrides --small; "
                         "e.g. --scale 2000 for a CPU smoke run)")
    ap.add_argument("--configs", default=None,
                    help="comma-separated config prefixes to run "
                         "(e.g. c2,c7; c1 is not c11); default all. Existing "
                         "RESULTS.json entries in --out-dir for skipped "
                         "configs are kept.")
    ap.add_argument("--out-dir", default=DEFAULT_OUT_DIR,
                    help="directory of RESULTS.json and RESULTS.md "
                         "(default %(default)s)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engines (cpu: the kernels' "
                         "plain versions)")
    args = ap.parse_args(argv)
    scale = args.scale or (10 if args.small else 1)
    device = torch.device(args.device)
    out_dir = args.out_dir
    os.makedirs(out_dir, exist_ok=True)
    json_path = os.path.join(out_dir, "RESULTS.json")
    results = {"device": describe_device(device), "configs": {}}
    try:  # merge over previous results when running a subset
        with open(json_path) as f:
            results["configs"].update(json.load(f).get("configs", {}))
    except (OSError, ValueError):
        pass
    want = args.configs.split(",") if args.configs else None

    def skip(name):
        # a prefix selects the configs it begins, but never cuts a number:
        # "c1" is c1, not c11 (the JAX module's "c1" runs both)
        return want is not None and not any(
            name.startswith(w) and not (w[-1:].isdigit() and
                                        name[len(w):len(w) + 1].isdigit())
            for w in want)

    _corpus = {}

    def corpus_1m():
        # shared by c2 and c4-c6; generated at most once per process
        if "m" not in _corpus:
            _corpus["m"] = create_sparse_matrix(
                1_000_000 // scale, 1024, 20, "gamma", seed=1)
        return _corpus["m"]

    def record(name, value):
        # write-through after every config: a crash in a later one must
        # not lose earlier measurements
        results["configs"][name] = value
        with open(json_path, "w") as f:
            json.dump(results, f, indent=2)
        _write_md(results, out_dir)

    if not skip("c1"):
        # config 1: small-matrix exact oracle agreement (CPU gold protocol)
        coo = create_sparse_matrix(10_000, 1024, 20, "gamma", seed=1)
        eng = TopKSpMV(coo, TopKSpMVConfig(k=100), device=device)
        record("c1_small_oracle", _accuracy(eng, coo))

    # config 2: 1M x 1024 gamma, the production codecs (exact-codec
    # accuracy is config 1's)
    for codec in () if skip("c2") else ("i8s", "i4s", "h16"):
        coo = corpus_1m()
        # i4s/h16 are the production fast modes (h16: 2 nnz/word, half
        # the bytes); the exact host rescore of the top-400 pool
        # restores precision 1.0
        pool = 400 if codec in ("i4s", "h16") else None
        # h16 runs the production geometry: quantum-2 widths
        quantum = 2 if codec == "h16" else 4
        eng = TopKSpMV(coo, TopKSpMVConfig(
            k=100, query_codec=codec, width_quantum=quantum,
            fold_tile=8 if codec == "h16" else 1,
            rescore_pool=pool), device=device)
        per = _throughput(eng, coo)
        acc = _accuracy(eng, coo)
        entry = dict(
            per_query_ms=round(per * 1e3, 3),
            gnnz_per_sec=round(coo.nnz / per / 1e9, 2),
            hbm_gbps=round(eng.hbm_bytes / per / 1e9, 1),
            vs_fpga_baseline=round(coo.nnz / per / 1e9 / BASELINE_GNNZ, 3),
            padding=round(eng.fused.padding_ratio, 3), **acc)
        if pool:
            q = create_query_batch(1, coo.num_cols, seed=50)[0]
            raw_i = eng.query(q, rescore_pool=0)[0].cpu().numpy()
            gi, _ = topk_exact(coo, q, 100)
            entry["precision_raw"] = metrics.precision_at_k(gi, raw_i)
            entry["rescore_pool"] = pool
        record(f"c2_1M_bf16_{codec}", entry)
        del eng

    if not skip("c3"):
        # config 3: 10M x 1024 reduced precision K=100 single host
        t0 = time.time()
        coo = create_sparse_matrix(10_000_000 // scale, 1024, 20, "gamma",
                                   seed=1)
        gen_s = time.time() - t0
        t0 = time.time()
        eng = TopKSpMV(coo, TopKSpMVConfig(k=100, query_codec="i8s",
                                           width_quantum=4), device=device)
        pack_s = time.time() - t0
        per = _throughput(eng, coo, nq=24)
        acc = _accuracy(eng, coo, trials=1)
        record("c3_10M_i8s", dict(
            per_query_ms=round(per * 1e3, 3),
            gnnz_per_sec=round(coo.nnz / per / 1e9, 2),
            hbm_gbps=round(eng.hbm_bytes / per / 1e9, 1),
            nnz=coo.nnz, pack_seconds=round(pack_s, 1),
            gen_seconds=round(gen_s, 1), host_peak_gb=_host_peak_gb(),
            **acc))
        del eng, coo

    # configs 4-6 share the 1M corpus
    G = 8
    if not (skip("c4") and skip("c5") and skip("c6")):
        coo = corpus_1m()
        if not (skip("c4") and skip("c5")):  # c6 only needs the matrix
            eng = TopKSpMV(coo, TopKSpMVConfig(k=100, query_codec="i8s",
                                               width_quantum=4),
                           device=device)

    if not skip("c4"):
        # config 4: batched queries (the multi-query sweep)
        groups = [_group_tables(eng, G, 100 + s) for s in range(10)]
        perg = _batch_slope(eng, groups, 2)
        record("c4_batched_8q", dict(
            per_group_ms=round(perg * 1e3, 3),
            per_query_ms=round(perg / G * 1e3, 3),
            aggregate_gnnz_per_sec=round(coo.nnz * G / perg / 1e9, 2)))

    if not skip("c5"):
        # config 5: serving loop
        stats = run_service(eng, coo, num_batches=10, batch_size=G, k=100,
                            oracle_every=5)
        record("c5_service", stats)

    if not (skip("c4") and skip("c5")):
        del eng

    if not skip("c6"):
        try:
            record("c6_dense_batch64", _run_dense_c6(coo, device))
        except ValueError as e:
            record("c6_dense_batch64", dict(skipped=str(e)))

    if not skip("c7"):
        # config 7: GloVe-shaped workload (the reference's non-synthetic
        # benchmark: glove 2.2M x 300, 54.9M nnz, ~25 nnz/row,
        # test_spmv_topk.py:29-32), a synthetic stand-in with the same
        # geometry; i4s + rescore production mode.
        coo = create_sparse_matrix(2_200_000 // scale, 300, 25, "uniform",
                                   seed=7)
        eng = TopKSpMV(coo, TopKSpMVConfig(
            k=100, query_codec="i4s", width_quantum=4, max_cols=384,
            rescore_pool=400), device=device)
        per = _throughput(eng, coo, nq=54)
        acc = _accuracy(eng, coo)
        record("c7_glove_shape_i4s", dict(
            per_query_ms=round(per * 1e3, 3),
            gnnz_per_sec=round(coo.nnz / per / 1e9, 2),
            hbm_gbps=round(eng.hbm_bytes / per / 1e9, 1),
            nnz=coo.nnz, padding=round(eng.fused.padding_ratio, 3),
            **acc))
        del eng

    if not skip("c8"):
        # config 8: billion-nnz single-device capacity demo: 50M x 1024,
        # ~975M nnz, a ~4.3 GB packed stream resident on one card (the
        # reference's largest run is 250M nnz on the full U280).
        t0 = time.time()
        coo = create_sparse_matrix(50_000_000 // scale, 1024, 20, "gamma",
                                   seed=1)
        gen_s = time.time() - t0
        t0 = time.time()
        eng = TopKSpMV(coo, TopKSpMVConfig(k=100, query_codec="i4s",
                                           width_quantum=4,
                                           rescore_pool=400), device=device)
        pack_s = time.time() - t0
        per = _throughput(eng, coo, nq=12)
        acc = _accuracy(eng, coo, trials=1)
        record("c8_50M_1Gnnz_i4s", dict(
            per_query_ms=round(per * 1e3, 3),
            gnnz_per_sec=round(coo.nnz / per / 1e9, 2),
            hbm_gbps=round(eng.hbm_bytes / per / 1e9, 1),
            nnz=coo.nnz, hbm_gb=round(eng.hbm_bytes / 1e9, 2),
            pack_seconds=round(pack_s, 1), gen_seconds=round(gen_s, 1),
            host_peak_gb=_host_peak_gb(), **acc))
        del eng, coo

    if not skip("c9"):
        # config 9: BASELINE config-4 geometry on ONE device: 100M rows x
        # 1024 cols, ~2G nnz, h16 codec (a ~4.3 GB packed stream) with
        # multi-query groups up to 64 (the SpMM analog of multi_spmv_gold,
        # gold_algorithms.hpp:21-35).
        t0 = time.time()
        coo = create_sparse_matrix(100_000_000 // scale, 1024, 20,
                                   "gamma", seed=1)
        gen_s = time.time() - t0
        t0 = time.time()
        eng = TopKSpMV(coo, TopKSpMVConfig(k=100, query_codec="h16",
                                           width_quantum=2, fold_tile=8,
                                           rescore_pool=400), device=device)
        pack_s = time.time() - t0
        per = _throughput(eng, coo, nq=12)
        acc = _accuracy(eng, coo, trials=1)
        entry = dict(
            per_query_ms=round(per * 1e3, 3),
            gnnz_per_sec=round(coo.nnz / per / 1e9, 2),
            hbm_gbps=round(eng.hbm_bytes / per / 1e9, 1),
            nnz=coo.nnz, hbm_gb=round(eng.hbm_bytes / 1e9, 2),
            pack_seconds=round(pack_s, 1), gen_seconds=round(gen_s, 1),
            **acc)
        for Q in (16, 64):
            ng = 6 if Q == 16 else 4
            groups = [_group_tables(eng, Q, 300 + s) for s in range(ng)]
            perg = _batch_slope(eng, groups, 2)
            entry[f"batch{Q}_ms_per_query"] = round(perg / Q * 1e3, 3)
            entry[f"batch{Q}_aggregate_gnnz_per_sec"] = round(
                coo.nnz * Q / perg / 1e9, 2)
            del groups
        entry["host_peak_gb"] = _host_peak_gb()
        record("c9_100M_2Gnnz_h16", entry)
        del eng, coo

    if not skip("c11"):
        # config 11: a REAL MTX FILE at scale through the native parser:
        # the reference's file-based operation (readMtx, utils.hpp:475-520;
        # GloVe/synthetic grids test_spmv_topk.py:15-32): write_mtx a
        # ~50M-nnz corpus, parse it back with the native two-phase parser,
        # build the production engine from the parsed matrix, measure.
        import tempfile

        from ..formats.mtx import read_mtx, write_mtx
        from ..utils import native

        coo_src = create_sparse_matrix(2_500_000 // scale, 1024, 20,
                                       "gamma", seed=11)  # ~49M nnz
        path = os.path.join(tempfile.gettempdir(), "spmv_c11.mtx")
        try:
            t0 = time.time()
            write_mtx(path, coo_src)
            write_s = time.time() - t0
            size_gb = os.path.getsize(path) / 1e9
            t0 = time.time()
            coo = read_mtx(path)
            parse_s = time.time() - t0
            assert coo.nnz == coo_src.nnz and coo.num_rows == coo_src.num_rows
            eng = TopKSpMV(coo, TopKSpMVConfig(
                k=100, query_codec="h16", width_quantum=2, fold_tile=8,
                rescore_pool=400), device=device)
            per = _throughput(eng, coo, nq=24)
            acc = _accuracy(eng, coo, trials=1)
            record("c11_mtx_file_50Mnnz", dict(
                per_query_ms=round(per * 1e3, 3),
                gnnz_per_sec=round(coo.nnz / per / 1e9, 2),
                nnz=coo.nnz, mtx_gb=round(size_gb, 2),
                mtx_write_seconds=round(write_s, 1),
                mtx_parse_seconds=round(parse_s, 1),
                parse_mnnz_per_sec=round(coo.nnz / parse_s / 1e6, 1),
                native_parser=native._load() is not None,
                **acc))
            del eng, coo
        finally:
            if os.path.exists(path):
                os.remove(path)

    with open(json_path, "w") as f:
        json.dump(results, f, indent=2)
    _write_md(results, out_dir)
    print(json.dumps(results["configs"], indent=1))
    return results


def _run_dense_c6(coo, device="cuda"):
    """config 6: the dense batch engine (when the dense form fits the
    budget).

    Measures bf16 batch-64, then the int8 per-row-scale engine at batch
    64 and 256 (int8 halves the bytes of the dense form)."""
    from ..ops.dense import (DenseTopKSpMV, dense_topk_batch,
                             quantize_queries_int8)

    device = torch.device(device)
    out = {}
    gold_q = np.asarray(create_query_batch(1, 1024, seed=51)[0])
    gi, _ = topk_exact(coo, gold_q, 100)

    for dt in ("bf16", "int8"):
        deng = DenseTopKSpMV(coo, TopKSpMVConfig(k=100), device=device,
                             hbm_budget_bytes=8 << 30, dtype=dt)
        for QD in (64, 256) if dt == "int8" else (64,):
            n_groups = 7 if QD == 64 else 5
            qf = [np.asarray(create_query_batch(QD, 1024, seed=200 + i),
                             np.float32) for i in range(n_groups)]
            if dt == "int8":
                pairs = [quantize_queries_int8(q, device) for q in qf]
            else:
                pairs = [(torch.from_numpy(q).to(device), None) for q in qf]

            def step(i):
                qs, sc = pairs[i]
                if dt == "int8":
                    dense_topk_batch(
                        deng._A, qs, None, deng._scales, sc, k=100,
                        block_rows=deng.block_rows,
                        recall_target=deng.recall_target)
                else:
                    dense_topk_batch(
                        deng._A, qs, k=100, block_rows=deng.block_rows,
                        recall_target=deng.recall_target)

            perd = timed_slope(held_runner(device, step), 2, n_groups) / QD
            tag = f"{dt}_batch{QD}"
            out[f"us_per_query_{tag}"] = round(perd * 1e6, 1)
            out[f"gnnz_equiv_per_sec_{tag}"] = round(
                coo.nnz / perd / 1e9, 2)
        di = deng.query_batch(gold_q[None])[0].cpu().numpy()
        out[f"precision_{dt}"] = metrics.precision_at_k(gi, di[0])
        del deng
    # round-1 compatible aliases (bf16 batch-64 was the original c6)
    out["us_per_query"] = out["us_per_query_bf16_batch64"]
    out["gnnz_equiv_per_sec"] = out["gnnz_equiv_per_sec_bf16_batch64"]
    out["precision"] = out["precision_bf16"]
    return out


def _write_md(results, out_dir=DEFAULT_OUT_DIR):
    lines = ["# RESULTS — measured on " + results["device"], "",
             "Produced by `python -m spmv_topk_tpu_torch.bench.full_eval`. "
             "FPGA baseline: 76.9 Gnnz/s (BASELINE.md).", ""]
    for name, cfg in results["configs"].items():
        lines.append(f"## {name}")
        for k, v in cfg.items():
            lines.append(f"- {k}: {v}")
        lines.append("")
    with open(os.path.join(out_dir, "RESULTS.md"), "w") as f:
        f.write("\n".join(lines))


if __name__ == "__main__":
    main()
