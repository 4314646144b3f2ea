"""Spans around the program's layers, the profiler, and the reduction of
its trace to what the per-layer metrics read.

The spans are the benchmark's own: ``spans`` wraps the calls into each
layer of one engine in ``torch.profiler.record_function`` (the table
pack, the sweep, finalize), and the harness opens ``bench.window``,
``bench.request`` and ``bench.readback`` itself. The program is not
edited; the wrappers are put in place only for a traced run and taken
away after it. The profiler records the device's activity, the runtime
calls that launch it and these spans, and no torch operator.
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import re
from typing import NamedTuple

import torch
from torch._C._autograd import _disable_profiler, _enable_profiler
from torch._C._profiler import RecordScope
from torch.autograd.profiler import record_function

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_ACTIVITIES = ("cuda_runtime", "cuda_driver")


def _wrap(fn, name):
    @functools.wraps(fn)
    def spanned(*args, **kwargs):
        with record_function(name):
            return fn(*args, **kwargs)
    return spanned


@contextlib.contextmanager
def spans(engine):
    """Record a span around each layer's calls of ``engine`` (and of the
    program's module functions it calls) while the block runs."""
    from spmv_topk_tpu_torch import api

    module_fns = {"pack_query_table": "bench.table_pack",
                  "pack_query_tables": "bench.table_pack",
                  "finalize_topk": "bench.finalize",
                  "finalize_topk_batch": "bench.finalize"}
    saved = {n: getattr(api, n) for n in module_fns}
    for n, span in module_fns.items():
        setattr(api, n, _wrap(saved[n], span))
    for m in ("table_candidates", "batch_candidates"):
        setattr(engine, m, _wrap(getattr(engine, m), "bench.sweep"))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(api, n, fn)
        for m in ("table_candidates", "batch_candidates"):
            delattr(engine, m)


class profiler:
    """torch's Kineto profiler with the device's activity (kernels,
    copies, fills and the runtime calls that launch them) and, on the
    host, the spans (``record_function``) alone. Each torch operator that
    a profiler records costs the host microseconds that the traced
    request pays: recording every operator made a traced single f32 query
    1.15 ms against 0.67 ms untraced, on an H100."""

    def __init__(self, device_type: str):
        self._prof = torch.autograd.profiler.profile(
            use_kineto=True,
            use_device="cuda" if device_type == "cuda" else None)
        self._cuda = device_type == "cuda"

    def start(self):
        self._prof._prepare_trace()
        _enable_profiler(self._prof.config(), self._prof.kineto_activities,
                         {RecordScope.USER_SCOPE})

    def stop(self):
        """The profiler's result (``events()``)."""
        if self._cuda:
            torch.cuda.synchronize()
        return _disable_profiler()

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False


class Event(NamedTuple):
    name: str
    device: bool
    activity: str
    start: int       # ns
    end: int         # ns
    corr: int
    linked: int


_RUNTIME = re.compile(r"^(cuda|cu)[A-Z]")


def _activity(e, device: bool) -> str:
    """Kineto's activity type; torch releases without
    ``activity_type()`` are told apart by name."""
    if hasattr(e, "activity_type"):
        return str(e.activity_type())
    name = e.name()
    annotation = getattr(e, "is_user_annotation", lambda: False)()
    if device:
        if annotation or name.startswith("bench."):
            return "gpu_user_annotation"
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "kernel"
    if annotation or name.startswith("bench."):
        return "user_annotation"
    return "cuda_runtime" if _RUNTIME.match(name) else "cpu_op"


def events_of(result) -> list[Event]:
    """The profiler's raw events as plain tuples."""
    out = []
    for e in result.events():
        start = int(e.start_ns())
        device = str(e.device_type()).endswith("CUDA")
        out.append(Event(e.name(), device, _activity(e, device), start,
                         start + int(e.duration_ns()),
                         int(e.correlation_id()),
                         int(e.linked_correlation_id())))
    return out


def short_name(name: str, width: int = 80) -> str:
    if name.startswith("void "):
        name = name[5:]
    return name.split("(")[0][:width] or name[:width]


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


class Trace:
    """The traced window: the device's operations in it, the spans, and
    where each device operation was launched from."""

    def __init__(self, events: list[Event], requests: int, queries: int):
        win = [e for e in events if e.name == "bench.window" and not e.device]
        if not win:
            raise ValueError("the trace holds no bench.window span")
        self.t0, self.t1 = win[0].start, win[0].end
        self.requests, self.queries = requests, queries
        self.ops = [e for e in events if e.device
                    and e.activity in DEVICE_ACTIVITIES
                    and e.end > self.t0 and e.start < self.t1]
        launches = {e.corr: e.start for e in events
                    if not e.device and e.activity in LAUNCH_ACTIVITIES}
        spans_by_corr = {e.corr: e.start for e in events if not e.device
                         and e.activity not in LAUNCH_ACTIVITIES}
        # when the host launched each device operation: its runtime call,
        # else the span it is linked to
        self.launched_at = [launches.get(e.corr, spans_by_corr.get(e.linked))
                            for e in self.ops]
        # the spans, and the runtime calls that name what the host did
        # inside them
        host = [e for e in events if not e.device
                and e.end > self.t0 and e.start < self.t1
                and e.name != "bench.window"]
        self.spans = sorted((e for e in host if e.name.startswith("bench.")),
                            key=lambda e: e.start)
        self.host_ops = sorted((e for e in host
                                if not e.name.startswith("bench.")),
                               key=lambda e: e.start)
        self._span_starts = [e.start for e in self.spans]
        self._op_starts = [e.start for e in self.host_ops]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def _clip(self, e):
        return max(e.start, self.t0), min(e.end, self.t1)

    def busy_s(self) -> float:
        return sum(e - s for s, e in _union(self._clip(o) for o in self.ops)) / 1e9

    def seconds(self, ops) -> float:
        return sum(b - a for a, b in (self._clip(o) for o in ops)) / 1e9

    def kernels(self, match) -> list[Event]:
        return [o for o in self.ops if o.activity == "kernel" and match(o.name)]

    @staticmethod
    def _innermost(items, starts, t, look=256):
        i = bisect.bisect_right(starts, t) - 1
        for j in range(i, max(i - look, -1), -1):
            if items[j].end >= t:
                return items[j]
        return None

    def span_at(self, t):
        return self._innermost(self.spans, self._span_starts, t)

    def ops_under(self, span_name: str) -> list[Event]:
        """Device operations launched while a span of that name was open."""
        out = []
        for o, t in zip(self.ops, self.launched_at):
            if t is None:
                continue
            i = bisect.bisect_right(self._span_starts, t) - 1
            for j in range(i, max(i - 64, -1), -1):
                s = self.spans[j]
                if s.name == span_name and s.end >= t:
                    out.append(o)
                    break
        return out

    def device_ops_top(self, n=10):
        tot = {}
        for o in self.ops:
            key = short_name(o.name)
            tot[key] = tot.get(key, 0.0) + (o.end - o.start) / 1e9
        return sorted(([k, v] for k, v in tot.items()),
                      key=lambda kv: -kv[1])[:n]

    def idle_gaps_top(self, n=10):
        """Idle time of the device in the window, summed by what the host
        was doing at the middle of each gap (the innermost benchmark span,
        then the innermost operation inside it)."""
        busy = _union(self._clip(o) for o in self.ops)
        edges = [self.t0] + [x for iv in busy for x in iv] + [self.t1]
        tot = {}
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) // 2
            span = self.span_at(mid)
            op = self._innermost(self.host_ops, self._op_starts, mid)
            label = (span.name if span else "host") + (
                "/" + op.name if op is not None and (
                    span is None or op.start >= span.start) else "")
            tot[label] = tot.get(label, 0.0) + (b - a) / 1e9
        return sorted(([k, v] for k, v in tot.items()),
                      key=lambda kv: -kv[1])[:n]
