#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (spmv_topk_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``spmv_topk_tpu_torch/csrc`` and the native
host runtime from ``runtime/``, then prints one JSON object per phase:

  1. environment: card, power limit, torch / CUDA / nvcc versions, whether
     the native runtime loaded, kernel build seconds;
  2. kernels vs their plain PyTorch versions on a 50k-row h16 octet
     corpus (tie-safe buffers, so per-lane values must agree bit for bit),
     once more with blocks small enough to force wide octets;
  3. the main path at full size: the 10M x 1024 gamma corpus (seed 1) in
     the headline config, 32 queries through ``TopKSpMV.query()`` held
     against the exact scipy top-100, sweep and end-to-end times, and the
     stream floor of the same words;
  4. both kernels timed against their plain versions at the main-path
     shapes, and checked against them there;
  5. the launch counts of the main-path run.

Then the kernel summary, the ``nvidia-smi`` name and power limit, and
last ``{"ok": true, "device": {...}}``. Any failed check raises, so the
run exits non-zero with no ``ok`` line; so does a host without CUDA.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HEADLINE = dict(k=100, lane_k=8, num_partitions=1, max_cols=1024,
                query_codec="h16", fused_layout="octet", width_quantum=2,
                fused_block_sublanes=1024, fold_tile=8, rescore_pool=400)
FULL_ROWS, NUM_COLS, AVG_DEG, CORPUS_SEED = 10_000_000, 1024, 20, 1
NUM_QUERIES, QUERY_SEED = 32, 3
MIN_PRECISION = 0.98


def require(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def emit(obj):
    print(json.dumps(obj), flush=True)


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps, warmup=1):
    """Milliseconds per fn() over a run of `reps` back-to-back calls
    between two CUDA events (the host enqueues ahead of the card, so
    launch overhead hides unless it exceeds the device time)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def compare_lanes(kv, kt, pv, pt):
    """Max |kernel - plain| over the per-lane sorted values, after
    requiring bit-equal values and equal (value, tag) pairs above each
    lane's smallest kept value (the tie that decides that last slot may
    keep a different tag)."""
    kv, kt, pv, pt = (x.cpu().numpy() for x in (kv, kt, pv, pt))
    require(np.array_equal(kv, pv),
            "kernel per-lane sorted values equal the plain version's")
    for lane in range(kv.shape[1]):
        floor = pv[:, lane].min()
        a = sorted(zip(kv[:, lane][kv[:, lane] > floor].tolist(),
                       kt[:, lane][kv[:, lane] > floor].tolist()))
        b = sorted(zip(pv[:, lane][pv[:, lane] > floor].tolist(),
                       pt[:, lane][pv[:, lane] > floor].tolist()))
        require(a == b, f"lane {lane} (value, tag) pairs above its floor")
    fin = np.isfinite(pv)
    return float(np.abs(kv[fin] - pv[fin]).max()) if fin.any() else 0.0


def phase_environment():
    import torch

    from spmv_topk_tpu_torch.ops import _build
    from spmv_topk_tpu_torch.utils import native

    _build.lib()
    env = dict(phase="environment", nvidia_smi=smi_line(),
               torch=torch.__version__, cuda=torch.version.cuda,
               nvcc=_build.nvcc_version(),
               device=torch.cuda.get_device_name(0),
               native_runtime=native.available(),
               native_error=native.load_error,
               kernel_build_seconds=_build.build_seconds)
    emit(env)
    return env


def _plain_and_kernel(eng, table, cfg):
    from spmv_topk_tpu_torch.ops.kernel import (octet_topk_plain,
                                                topk_spmv_fused_octet_device)

    args = (eng.words, table, eng.nreal, eng.plan_rows)
    kern = topk_spmv_fused_octet_device(
        *args, cfg=cfg, block_sublanes=eng.fused.block_sublanes)
    plain = octet_topk_plain(
        *args, lane_k=cfg.lane_k, fold_tile=cfg.fold_tile,
        tie_safe=bool(cfg.tie_safe_topk),
        block_sublanes=eng.fused.block_sublanes)
    return kern, plain


def phase_small(dev):
    """Kernels vs plain versions on a 50k-row corpus."""
    import torch

    from spmv_topk_tpu_torch import TopKSpMV, TopKSpMVConfig
    from spmv_topk_tpu_torch.formats import (create_query_batch,
                                             create_sparse_matrix)
    from spmv_topk_tpu_torch.ops.streamprobe import (stream_words_device,
                                                     stream_words_plain)

    coo = create_sparse_matrix(50_000, NUM_COLS, AVG_DEG, "gamma", seed=7)
    q = create_query_batch(1, NUM_COLS, seed=8)[0]
    cases = []
    for fbs, fold in ((1024, 8), (1024, 1), (64, 8)):
        cfg = TopKSpMVConfig(**dict(HEADLINE, fused_block_sublanes=fbs,
                                    fold_tile=fold, tie_safe_topk=True,
                                    rescore_pool=None))
        eng = TopKSpMV(coo, cfg, device=dev)
        wide = sum(p.blocks_per_octet > 1 for p in eng.fused.plan)
        if fbs == 64:
            require(wide > 0, "small blocks force wide octets")
        table, _ = eng._table(q)
        (kv, kt), (pv, pt) = _plain_and_kernel(eng, table, cfg)
        torch.cuda.synchronize()
        err = compare_lanes(kv, kt, pv, pt)
        cases.append(dict(fused_block_sublanes=fbs, fold_tile=fold,
                          buckets=len(eng.fused.plan), wide_buckets=wide,
                          k1_max_abs_err=err))
    salt = torch.arange(128, dtype=torch.int32, device=dev).reshape(1, 128) * 7919
    ks = stream_words_device(eng.words, salt)
    ps = stream_words_plain(eng.words, salt)
    torch.cuda.synchronize()
    require(torch.equal(ks, ps), "stream probe checksum equals plain")
    out = dict(phase="kernels_vs_plain_small", rows=coo.num_rows,
               nnz=coo.nnz, cases=cases, k3_equal=True)
    emit(out)
    return out


def phase_main(dev):
    """The main path at full size; returns (engine, queries, results)."""
    import torch

    from spmv_topk_tpu_torch import TopKSpMV, TopKSpMVConfig
    from spmv_topk_tpu_torch.formats import (create_query_batch,
                                             create_sparse_matrix)
    from spmv_topk_tpu_torch.ops.kernel import topk_spmv_fused_octet_device
    from spmv_topk_tpu_torch.ops.streamprobe import stream_words_device
    from spmv_topk_tpu_torch.utils import native

    require(native.available(),
            f"native runtime loaded for the full-size pack ({native.load_error})")
    t0 = time.perf_counter()
    coo = create_sparse_matrix(FULL_ROWS, NUM_COLS, AVG_DEG, "gamma",
                               seed=CORPUS_SEED)
    gen_s = time.perf_counter() - t0
    cfg = TopKSpMVConfig(**HEADLINE)
    t0 = time.perf_counter()
    eng = TopKSpMV(coo, cfg, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    torch.from_numpy(eng.fused.words).to(dev)    # upload alone, for its time
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0

    qs = create_query_batch(NUM_QUERIES, NUM_COLS, seed=QUERY_SEED)
    t0 = time.perf_counter()
    gold_scores = np.asarray(eng._scipy_csr @ qs.T)       # (rows, Q)
    gold = []
    for j in range(NUM_QUERIES):
        g = gold_scores[:, j]
        part = np.argpartition(-g, cfg.k - 1)[:cfg.k]
        gold.append(set(part.tolist()))
    del gold_scores
    gold_s = time.perf_counter() - t0

    eng.query(qs[0])                                      # warm
    torch.cuda.synchronize()
    topk_spmv_fused_octet_device.launches = 0
    stream_words_device.launches = 0
    prec, prec_raw, e2e_ms, sweep_ms = [], [], [], []
    for j in range(NUM_QUERIES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        idx, vals = eng.query(qs[j])
        torch.cuda.synchronize()
        e2e_ms.append((time.perf_counter() - t0) * 1e3)
        idx = idx.cpu().numpy()
        require(idx.shape == (cfg.k,) and (idx >= 0).all()
                and np.isfinite(vals.cpu().numpy()).all(),
                "query returns k valid rows with finite scores")
        prec.append(len(gold[j] & set(idx.tolist())) / cfg.k)
        raw_idx, _ = eng.query(qs[j], rescore_pool=0)
        prec_raw.append(len(gold[j] & set(raw_idx.cpu().numpy().tolist()))
                        / cfg.k)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        eng.candidates(qs[j])
        end.record()
        end.synchronize()
        sweep_ms.append(start.elapsed_time(end))
    salts = [torch.full((1, 128), i, dtype=torch.int32, device=dev)
             for i in range(11)]
    floor_ms = cuda_ms(lambda it=iter(salts): stream_words_device(
        eng.words, next(it)), reps=10)
    torch.cuda.synchronize()
    launches = dict(octet_topk_h16=topk_spmv_fused_octet_device.launches,
                    stream_words=stream_words_device.launches)

    sweep = statistics.median(sweep_ms)
    res = dict(
        phase="main_path", rows=coo.num_rows, cols=coo.num_cols,
        nnz=coo.nnz, config=HEADLINE, buckets=len(eng.fused.plan),
        generate_s=gen_s, pack_and_upload_s=build_s, upload_s=upload_s,
        gold_s=gold_s, words_bytes_on_device=eng.words.numel() * 4,
        padding_words_per_nnz=eng.fused.padding_ratio,
        queries=NUM_QUERIES, precision_at_100_mean=float(np.mean(prec)),
        precision_at_100_min=float(np.min(prec)),
        precision_raw_mean=float(np.mean(prec_raw)),
        sweep_ms_median=sweep, e2e_ms_median=statistics.median(e2e_ms),
        gnnz_per_s=coo.nnz / (sweep * 1e-3) / 1e9,
        words_gb_per_s=eng.hbm_bytes / (sweep * 1e-3) / 1e9,
        stream_floor_ms=floor_ms,
        stream_floor_gb_per_s=eng.hbm_bytes / (floor_ms * 1e-3) / 1e9,
        launches=launches,
        nvidia_smi=smi_line())
    emit(res)
    require(res["precision_at_100_mean"] >= MIN_PRECISION,
            f"mean precision@100 >= {MIN_PRECISION}")
    return eng, qs, res


def phase_kernels_full(eng, qs, dev):
    """Kernel vs plain at the main-path shapes: times and agreement."""
    import dataclasses

    import torch

    from spmv_topk_tpu_torch.ops.kernel import (octet_topk_plain,
                                                topk_spmv_fused_octet_device)
    from spmv_topk_tpu_torch.ops.streamprobe import (stream_words_device,
                                                     stream_words_plain)

    cfg = eng.config
    table, _ = eng._table(qs[0])
    bs = eng.fused.block_sublanes
    args = (eng.words, table, eng.nreal, eng.plan_rows)
    # agreement needs tie-safe buffers: h16 scores tie often at this size
    safe = dataclasses.replace(cfg, tie_safe_topk=True)
    (kv, kt), (pv, pt) = _plain_and_kernel(eng, table, safe)
    torch.cuda.synchronize()
    k1_err = compare_lanes(kv, kt, pv, pt)

    plain_kw = dict(lane_k=cfg.lane_k, fold_tile=cfg.fold_tile,
                    tie_safe=bool(cfg.tie_safe_topk), block_sublanes=bs)
    k1_ms = cuda_ms(lambda: topk_spmv_fused_octet_device(
        *args, cfg=cfg, block_sublanes=bs), reps=20, warmup=2)
    k1_plain_ms = cuda_ms(lambda: octet_topk_plain(*args, **plain_kw),
                          reps=3)
    salt = torch.arange(128, dtype=torch.int32, device=dev).reshape(1, 128)
    ks = stream_words_device(eng.words, salt)
    ps = stream_words_plain(eng.words, salt)
    torch.cuda.synchronize()
    require(torch.equal(ks, ps), "full-size stream checksum equals plain")
    k3_ms = cuda_ms(lambda: stream_words_device(eng.words, salt), reps=20,
                    warmup=2)
    k3_plain_ms = cuda_ms(lambda: stream_words_plain(eng.words, salt),
                          reps=3)
    res = dict(phase="kernels_vs_plain_full", words_bytes=eng.hbm_bytes,
               k1_ms=k1_ms, k1_plain_ms=k1_plain_ms, k1_max_abs_err=k1_err,
               k1_words_gb_per_s=eng.hbm_bytes / (k1_ms * 1e-3) / 1e9,
               k3_ms=k3_ms, k3_plain_ms=k3_plain_ms, k3_max_abs_err=0,
               k3_gb_per_s=eng.hbm_bytes / (k3_ms * 1e-3) / 1e9,
               nvidia_smi=smi_line())
    emit(res)
    return res


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False

    phase_environment()
    torch.cuda.synchronize()
    phase_small(dev)
    torch.cuda.synchronize()
    eng, qs, main_res = phase_main(dev)
    torch.cuda.synchronize()
    full = phase_kernels_full(eng, qs, dev)
    torch.cuda.synchronize()
    launches = main_res["launches"]
    emit(dict(phase="launch_counts", **launches))
    for name, n in launches.items():
        require(n > 0, f"main path launched {name}")

    emit({"kernels": [
        dict(name="octet_topk_h16", route="cuda",
             source="spmv_topk_tpu_torch/csrc/octet_topk.cu",
             replaces="spmv_topk_tpu/ops/kernel.py:1057",
             launches=launches["octet_topk_h16"],
             max_abs_err=full["k1_max_abs_err"], ms=full["k1_ms"],
             plain_ms=full["k1_plain_ms"]),
        dict(name="stream_words", route="cuda",
             source="spmv_topk_tpu_torch/csrc/stream_probe.cu",
             replaces="spmv_topk_tpu/ops/streamprobe.py:54",
             launches=launches["stream_words"],
             max_abs_err=full["k3_max_abs_err"], ms=full["k3_ms"],
             plain_ms=full["k3_plain_ms"]),
    ]})
    print(smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
