"""The benchmark tools of the port: the reference's CSV benchmark loop
(``harness``), its sweep (``sweep``), the serving loop
(``service``), the CPU baseline (``cpu_baseline``), the capacity
planner (``capacity``), the BASELINE.json evaluation (``full_eval``), the
accuracy-vs-K sweep (``accuracy_sweep``) and the figures (``plots``)."""

from .harness import run_benchmark, BenchResult, CSV_HEADER
from .sweep import run_sweep
