"""Profiling / tracing helpers: the counterpart of
``spmv_topk_tpu.utils.profiling``.

  - ``phase_timer``: wall-clock phase timing (host-side phases: pack,
    upload).
  - ``device_trace``: a ``torch.profiler`` trace of the CPU and, where a
    card is visible, its CUDA kernels, written as a Chrome trace (open it
    in chrome://tracing or Perfetto).
  - ``timed_slope``: per-iteration time from the slope between a short and
    a long run of iterations, which cancels the fixed cost of a run (the
    first launch, the final synchronize).
  - ``held_runner``: a ``run_n`` for ``timed_slope`` whose launches the
    card runs back to back (behind a hold of the stream), then waits for.
"""

from __future__ import annotations

import contextlib
import os
import time


@contextlib.contextmanager
def phase_timer(name: str, sink: dict | None = None, verbose: bool = False):
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    if sink is not None:
        sink[name] = dt
    if verbose:
        print(f"[{name}] {dt * 1e3:.2f} ms")


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Profile the enclosed code with ``torch.profiler`` (CPU activity, and
    CUDA activity where ``torch.cuda.is_available()``) and write its Chrome
    trace to ``log_dir/trace-<pid>-<ns>.json``. Yields the profiler, whose
    ``key_averages()`` sums the events by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


def timed_slope(run_n, short: int, long_: int, reps: int = 5) -> float:
    """Per-iteration device time from the slope of two chained run lengths.

    run_n(n) must enqueue n iterations and wait for them to finish: end it
    in ``torch.cuda.synchronize()`` (or a ``.cpu()`` readback of the last
    result), since a CUDA launch returns before the card has run it.
    Returns seconds per iteration.

    Each slope pairs ADJACENT short/long runs (a shared card's clocks and
    neighbours drift over minutes) and the median of reps rejects
    outliers; a (long_ - short) under ~50 iterations of a sub-ms kernel is
    below the launch-noise floor — prefer 4/104.
    """
    run_n(short)
    run_n(long_)

    def once(n):
        t0 = time.perf_counter()
        run_n(n)
        return time.perf_counter() - t0

    slopes = sorted(
        (once(long_) - once(short)) / (long_ - short) for _ in range(reps))
    return slopes[len(slopes) // 2]


# cycles the card sleeps at the head of each timed run while the host
# enqueues its sweeps (``torch.cuda._sleep``; ~10 ms at the H100's clocks),
# so that the sweeps then run back to back and the slope is the card's
# time a sweep, as the JAX package's jitted scan of sweeps is, and not the
# host's time a launch: a 500k-row sample's sweep takes the card less time
# than the host takes to launch it
HOLD_CYCLES = 20_000_000


def held_runner(device, step):
    """``run_n(n)`` for ``timed_slope``: on a CUDA device the card first
    sleeps (HOLD_CYCLES) while the host enqueues ``step(0) .. step(n -
    1)``, so the launches then run back to back and the slope is the
    card's time a step, not the host's time a launch; then a synchronize.
    On the CPU, the steps and nothing else."""
    import torch

    device = torch.device(device)

    def run_n(n):
        if device.type == "cuda":
            with torch.cuda.device(device):
                torch.cuda._sleep(HOLD_CYCLES)
        for i in range(n):
            step(i)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    return run_n


def enable_compilation_cache(path: "str | None" = None) -> None:
    """Does nothing; kept for the JAX package's callers.

    The JAX package persists its jit executables here. The port has no
    jit: its kernels are built once by nvcc into
    ``build/spmv_topk_tpu_torch/`` beside the package, under a name that
    carries a hash of the sources (``ops/_build.py``), and every later
    process loads that library. ``path`` is accepted and ignored."""
    return None
