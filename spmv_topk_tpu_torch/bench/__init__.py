"""The benchmark tools of the port: the reference's CSV benchmark loop
(``harness``), its sweep (``sweep``), the serving loop
(``service``), the CPU baseline (``cpu_baseline``) and the capacity
planner (``capacity``)."""

from .harness import run_benchmark, BenchResult, CSV_HEADER
from .sweep import run_sweep
