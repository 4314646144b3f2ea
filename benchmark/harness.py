"""One run of one cell: set-up, the measured window, the metrics and the
check of what the window served.

Everything that belongs to one configuration, traffic mix, cell or
metric is a file found by its name in ``BENCHMARK.json``:

- ``benchmark/configs/<config>.json``: the corpus (``corpus``: rows,
  columns, average degree, degree distribution), the engine's
  ``TopKSpMVConfig`` keywords (``engine``), the precision they state
  (``precision``: ``values``, ``query``; what the reference computes in)
  and the control (``control``, ``benchmark/readings.py``);
- ``benchmark/traffic/<traffic>.json``: the entry a request calls
  (``entry``: ``query`` or ``query_batch``; ``entry_kwargs``), the
  queries a request carries, the pool of distinct queries the window
  cycles through, the warm-up, the number of answers checked and the
  requests traced (one client drives every mix in a closed loop);
- ``benchmark/cells/<workload>.json``: the limits of the check's
  numbers (``limits``) and the readings they were set from;
- ``benchmark/metrics/<metric>.py`` (or ``<metric up to its first
  dot>.py``): ``read(ctx)``, the metric's value or None.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import os
import resource
import subprocess
import sys
import time

import numpy as np
import torch

from benchmark import check, corpus, roofline
from benchmark import trace as tracing
from benchmark.reference import exact_topk

FORBIDDEN = ("jax", "jaxlib", "flax", "spmv_topk_tpu")
# the traced stretch: from this share of the window to that one (or to
# the mix's ``trace_requests``), clear of the window's first requests
TRACE_FROM, TRACE_UNTIL = 0.25, 0.9


class NoCard(RuntimeError):
    pass


class Forbidden(RuntimeError):
    pass


def _json(path):
    with open(path) as fh:
        return json.load(fh)


def applies(metric: dict, workload: str) -> bool:
    """Whether ``metric`` is reported in ``workload``: in the cells it
    lists, or in every cell."""
    return workload in metric.get("workloads", [workload])


class Cell:
    """A workload of BENCHMARK.json with its files."""

    def __init__(self, root: str, workload: str):
        self.root = root
        spec = _json(os.path.join(root, "BENCHMARK.json"))
        by_name = {w["name"]: w for w in spec["workloads"]}
        if workload not in by_name:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.workload = by_name[workload]
        self.name = workload
        cfg = {c["name"]: c for c in spec["configs"]}[self.workload["config"]]
        self.config = _json(os.path.join(root, cfg["file"]))
        bench = os.path.join(root, "benchmark")
        self.traffic = _json(os.path.join(
            bench, "traffic", self.workload["traffic"] + ".json"))
        if self.traffic["entry"] not in ENTRIES:
            raise ValueError(f"no entry {self.traffic['entry']!r}")
        self.limits = _json(os.path.join(bench, "cells",
                                         workload + ".json"))["limits"]
        self.end_to_end = [m for m in spec["end_to_end"]
                           if applies(m, workload)]
        self.per_layer = [m for m in spec["per_layer"]
                          if applies(m, workload)]
        self.chips = int(self.workload.get("chips", 1))

    def reader(self, metric: str):
        d = os.path.join(self.root, "benchmark", "metrics")
        for stem in (metric, metric.split(".")[0]):
            path = os.path.join(d, stem + ".py")
            if os.path.exists(path):
                spec = importlib.util.spec_from_file_location(
                    "benchmark_metric_" + stem.replace(".", "_"), path)
                mod = importlib.util.module_from_spec(spec)
                spec.loader.exec_module(mod)
                return mod.read
        raise FileNotFoundError(f"no reader for metric {metric!r} in {d}")


class Ctx:
    """What the metric readers read."""

    roofline = roofline

    def __init__(self, cell, **kw):
        self.cell = cell
        self.config = cell.config
        self.traffic = cell.traffic
        self.__dict__.update(kw)

    def request_work(self):
        """(bytes, operations) of one request, from the problem."""
        return roofline.work(self.nnz, self.num_cols,
                             self.traffic["queries_per_request"], self.k,
                             self.codec)


ENTRIES = {
    "query": lambda eng, qs, kw: tuple(t[None] for t in eng.query(qs[0], **kw)),
    "query_batch": lambda eng, qs, kw: eng.query_batch(qs, **kw),
}


def _request(eng, entry, qs, kw, span=None):
    """One request: the entry, then its answers to the host."""
    idx, vals = entry(eng, qs, kw)
    if span is None:
        return idx.cpu().numpy(), vals.cpu().numpy()
    with tracing.record_function(span):
        return idx.cpu().numpy(), vals.cpu().numpy()


def drive(eng, pool, traffic, seconds, device, trace=False):
    """The closed loop of one client for ``seconds``. Returns the
    latencies, the answers, the window's length, the failures and, when
    traced, the trace of a steady stretch of it."""
    entry = ENTRIES[traffic["entry"]]
    kw = dict(traffic.get("entry_kwargs", {}))
    n = traffic["queries_per_request"]
    per_pool = len(pool) // n
    lat, answers, failed = [], [], 0
    prof = win = None
    traced = traced_from = 0
    trace_from, trace_until = seconds * TRACE_FROM, seconds * TRACE_UNTIL
    t_open = time.perf_counter()
    t_close = t_open + seconds
    i = 0
    while True:
        qs = pool[(i % per_pool) * n:(i % per_pool + 1) * n]
        if (trace and prof is None and traced == 0
                and time.perf_counter() - t_open >= trace_from):
            # the spans and the profiler only round the traced requests:
            # the others run as in an untraced run
            spanned = tracing.spans(eng)
            spanned.__enter__()
            prof = tracing.profiler(device.type)
            prof.start()
            traced_from = i
            win = tracing.record_function("bench.window")
            win.__enter__()
        t0 = time.perf_counter()
        try:
            if prof is not None:
                with tracing.record_function("bench.request"):
                    ans = _request(eng, entry, qs, kw, "bench.readback")
            else:
                ans = _request(eng, entry, qs, kw)
        except Exception as exc:       # a request that raised has failed
            ans = None
            failed += n
            print(f"request {i} raised {exc!r}", file=sys.stderr)
        t1 = time.perf_counter()
        lat.append(t1 - t0)
        answers.append(ans)
        i += 1
        if prof is not None:
            traced += 1
            if (traced >= traffic["trace_requests"]
                    or t1 - t_open >= trace_until or t1 >= t_close):
                win.__exit__(None, None, None)
                result = prof.stop()
                spanned.__exit__(None, None, None)
                prof = None
        if t1 >= t_close:
            break
    out = dict(latencies=np.asarray(lat), answers=answers, window_s=t1 - t_open,
               requests=i, queries=i * n, failed=failed,
               traced=slice(traced_from, traced_from + traced))
    if trace:
        out["trace"] = (tracing.Trace(tracing.events_of(result), traced,
                                      traced * n)
                        if traced else None)
    return out


@contextlib.contextmanager
def host_watch():
    """What the host did to the block's process, in the dict it yields:
    the collector's runs and their seconds, and involuntary context
    switches."""
    runs, began = [], []

    def note(phase, info):
        if phase == "start":
            began.append(time.perf_counter())
        elif began:
            runs.append(time.perf_counter() - began.pop())

    facts = {}
    switches = resource.getrusage(resource.RUSAGE_SELF).ru_nivcsw
    gc.callbacks.append(note)
    try:
        yield facts
    finally:
        gc.callbacks.remove(note)
        facts["collections"] = len(runs)
        facts["collector_s"] = sum(runs)
        facts["involuntary_switches"] = (
            resource.getrusage(resource.RUSAGE_SELF).ru_nivcsw - switches)


def card_facts(device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0}
    facts = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
             "count": 1}
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader", f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=30)
        facts["nvidia_smi"] = r.stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        facts["nvidia_smi"] = f"unavailable: {exc!r}"
    return facts


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def build_engine(cfg_file: dict, coo, device, overrides=None):
    from spmv_topk_tpu_torch import TopKSpMV, TopKSpMVConfig

    kw = dict(cfg_file["engine"])
    kw.update(overrides or {})
    return TopKSpMV(coo, TopKSpMVConfig(**kw), device=device)


def host_coo(c: dict):
    """The corpus, handed to the program as its host COO matrix."""
    from spmv_topk_tpu_torch.formats.coo import CooMatrix

    m = CooMatrix(c["rows"].cpu().numpy(), c["cols"].cpu().numpy(),
                  c["vals"].cpu().numpy(), c["num_rows"], c["num_cols"])
    m._sorted = True       # made row-major sorted
    return m


def inputs(cell, seed, device):
    """The corpus (the program's host COO matrix) and the query pool from
    the seed, and the corpus's fingerprint."""
    spec = cell.config["corpus"]
    c = corpus.make_corpus(spec, seed, device)
    fingerprint = corpus.checksum(c)
    coo = host_coo(c)
    del c
    pool = corpus.make_queries(cell.traffic["pool_queries"],
                               spec["num_cols"], seed, device).cpu().numpy()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    return coo, pool, fingerprint


def setup(cell, seed, device, log, overrides=None):
    """inputs(), then the engine on the device: (engine, pool, corpus
    fingerprint)."""
    coo, pool, fingerprint = inputs(cell, seed, device)
    t = time.perf_counter()
    eng = build_engine(cell.config, coo, device, overrides)
    log(f"engine built in {time.perf_counter() - t:.3f} s: {eng.num_nnz} nnz, "
        f"{eng.hbm_bytes} bytes of words")
    del coo
    return eng, pool, fingerprint


def warm_up(eng, cell, seed, device):
    """Every shape the window uses, with queries of their own."""
    t = cell.traffic
    n = t["queries_per_request"]
    qs = corpus.make_queries(n, cell.config["corpus"]["num_cols"], seed,
                             device, "warmup").cpu().numpy()
    entry, kw = ENTRIES[t["entry"]], dict(t.get("entry_kwargs", {}))
    for _ in range(t["warmup_requests"]):
        _request(eng, entry, qs, kw)


def reference_inputs(cell, seed, device, queries, served_idx, k):
    """The reference's view of the sampled queries: regenerate the corpus
    from the seed, then the exact f32 top-k rows, and the in-precision
    score of each served row, k-th best and best."""
    spec = cell.config["corpus"]
    c = corpus.make_corpus(spec, seed, device)
    fingerprint = corpus.checksum(c)
    prec = cell.config["precision"]
    q = torch.from_numpy(queries).to(device)
    exact = exact_topk.csr(c["indptr"], c["cols"], c["vals"], c["num_rows"],
                           c["num_cols"], "f32")
    exact_rows, _ = exact_topk.topk(exact, exact_topk.effective_query(q, "f32"), k)
    del exact
    m = exact_topk.csr(c["indptr"], c["cols"], c["vals"], c["num_rows"],
                       c["num_cols"], prec["values"])
    del c
    of_served, kth, best = exact_topk.judge_inputs(
        m, exact_topk.effective_query(q, prec["query"]),
        torch.from_numpy(np.asarray(served_idx, np.int64)), k)
    return dict(exact_rows=exact_rows.cpu().numpy(),
                of_served=of_served.cpu().numpy(), kth=kth.cpu().numpy(),
                best=best.cpu().numpy(), fingerprint=fingerprint)


def judge(cell, seed, device, pool, out, k, num_rows, fingerprint, log):
    """Sample the window's answers, compare them with the reference, and
    return (correct, check lines, check numbers, served and exact rows of
    the sample)."""
    n = cell.traffic["queries_per_request"]
    per_pool = len(pool) // n
    answered = [(r, j) for r, a in enumerate(out["answers"]) if a is not None
                for j in range(n)]
    pos = check.sample_positions(len(answered),
                                 cell.traffic["check_queries"],
                                 corpus.stream_seed(seed, "sample"))
    pick = [answered[p] for p in pos]
    qs = np.stack([pool[(r % per_pool) * n + j] for r, j in pick]) if pick \
        else np.zeros((0, pool.shape[1]), np.float32)
    idx = np.stack([out["answers"][r][0][j] for r, j in pick]) if pick \
        else np.zeros((0, k), np.int64)
    vals = np.stack([out["answers"][r][1][j] for r, j in pick]) if pick \
        else np.zeros((0, k), np.float32)
    nums = {"bad_answers": 0, "score_gap": float("nan"),
            "rank_gap": float("nan")}
    exact_rows = np.zeros((0, k), np.int64)
    if pick:
        t = time.perf_counter()
        ref = reference_inputs(cell, seed, device, qs, idx, k)
        exact_rows = ref["exact_rows"]
        log(f"reference over {len(pick)} sampled queries in "
            f"{time.perf_counter() - t:.3f} s")
        if ref["fingerprint"] != fingerprint:
            log("the reference regenerated another corpus: "
                f"{ref['fingerprint']} against {fingerprint}")
            nums["bad_answers"] = len(pick)
        else:
            nums = check.numbers(idx, vals, ref["of_served"], ref["kth"],
                                 ref["best"], k, num_rows)
    ok, lines = check.verdict(nums, cell.limits)
    # every answer of the window, not only the sample, must be well formed
    bad, shown = 0, 0
    for r, a in enumerate(out["answers"]):
        if a is None:
            continue
        m = check.malformed(a[0], a[1], k, num_rows)
        bad += int(m.sum())
        for j in np.flatnonzero(m)[:max(0, 3 - shown)]:
            shown += 1
            log(f"malformed: request {r} query {j}: "
                f"{check.why_malformed(a[0][j], a[1][j], k, num_rows)}")
    lines.append(f"malformed {bad} of {out['queries'] - out['failed']} "
                 f"answers; failed {out['failed']} of {out['queries']}; "
                 f"sampled {len(pick)}")
    ok = ok and bad == 0 and out["failed"] == 0 and len(pick) > 0
    return ok, lines, nums, bad, (idx, exact_rows)


def run(root, workload, seed, seconds, trace, *, device="cuda",
        require_card=True, t_start=None, log=None):
    """One run. Returns the result object of the last line."""
    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    cell = Cell(root, workload)
    device = torch.device(device)
    if require_card:
        if not torch.cuda.is_available():
            raise NoCard("torch sees no CUDA device")
        if torch.cuda.device_count() < cell.chips:
            raise NoCard(f"{workload} needs {cell.chips} CUDA devices, "
                         f"torch sees {torch.cuda.device_count()}")
    if device.type == "cuda":
        device = torch.device("cuda", device.index or 0)
        torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    eng, pool, fingerprint = setup(cell, seed, device, log)
    k = eng.config.k
    warm_up(eng, cell, seed, device)
    if trace:      # the profiler's and the spans' first use, outside the window
        with tracing.spans(eng), tracing.profiler(device.type):
            warm_up(eng, cell, seed, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    # one client thread: no torch worker threads beside it
    torch.set_num_threads(1)
    gc.collect()
    with host_watch() as host:
        out = drive(eng, pool, cell.traffic, seconds, device, trace)
    found = forbidden_modules()
    if found:
        raise Forbidden(f"loaded in this process: {', '.join(found)}")
    dev = card_facts(device)
    if device.type == "cuda":
        dev["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(device))
    facts = dict(nnz=int(eng.num_nnz), num_rows=int(eng.num_rows),
                 num_cols=int(eng.num_cols), hbm_bytes=int(eng.hbm_bytes),
                 k=k, codec=eng.config.query_codec)
    del eng
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    log(f"window {out['window_s']:.3f} s: {out['requests']} requests, "
        f"{out['queries']} queries; set-up {setup_s:.3f} s")
    log("window's host: " + ", ".join(f"{key} {v:.6g}" for key, v in
                                      host.items()))
    if trace and out["traced"].stop > out["traced"].start:
        lat = out["latencies"]
        rest = np.delete(lat, np.arange(len(lat))[out["traced"]])
        log(f"median request: traced {np.median(lat[out['traced']]) * 1e3:.4f}"
            f" ms ({out['traced'].stop - out['traced'].start}), untraced "
            f"{np.median(rest) * 1e3 if len(rest) else float('nan'):.4f} ms "
            f"({len(rest)})")
    ok, lines, nums, bad, (served, exact) = judge(
        cell, seed, device, pool, out, k, facts["num_rows"], fingerprint, log)
    ctx = Ctx(cell, setup_s=setup_s, seconds=seconds, seed=seed,
              trace=out.get("trace"), served=served, exact=exact,
              **{key: out[key] for key in ("latencies", "traced", "window_s",
                                           "requests", "queries")},
              **facts)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = cell.reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    result = {"correct": bool(ok), "attempted": int(out["queries"]),
              "failed": int(out["failed"] + bad), "metrics": metrics,
              "device": {k_: dev[k_] for k_ in ("platform", "kind", "count",
                                                "memory_peak_bytes")
                         if k_ in dev}}
    if trace and ctx.trace is not None:
        result["device"]["busy_s"] = ctx.trace.busy_s()
        result["device"]["window_s"] = ctx.trace.window_s
        result["breakdown"] = {"device_ops": ctx.trace.device_ops_top(),
                               "idle_gaps": ctx.trace.idle_gaps_top()}
    result["card"] = {"nvidia_smi": dev.get("nvidia_smi", ""),
                      "torch": torch.__version__,
                      "cuda": torch.version.cuda}
    result["check"] = {name: {"value": nums[name],
                              "limit": cell.limits[name]}
                       for name in check.NUMBERS}
    found = forbidden_modules()
    if found:
        raise Forbidden(f"loaded in this process: {', '.join(found)}")
    for line in lines:
        log(line)
    return result


def main(argv, t_start=None) -> int:
    import argparse

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = argparse.ArgumentParser(description="One run of one benchmark cell.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    try:
        result = run(root, a.workload, a.seed, a.seconds, bool(a.trace),
                     t_start=t_start)
    except NoCard as exc:
        print(f"no result: {exc}", file=sys.stderr)
        return 3
    except Forbidden as exc:
        print(f"no result: {exc}", file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    return 0
