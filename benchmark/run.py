#!/usr/bin/env python3
"""One run of one benchmark cell on the card.

    python3 benchmark/run.py --workload c3_i8s_tiesafe.batch64 --seed 7 \
        --seconds 10 --trace 0

Makes the corpus and the queries from the seed, builds the engine of the
cell's configuration on the card, warms up the cell's shapes, drives the
cell's traffic for ``--seconds``, checks a sample of the answers against
the plain reference, and prints one JSON object as its last line:
``--trace 0`` the cell's end-to-end metrics, ``--trace 1`` its per-layer
metrics from a profiled stretch of the window. Exits 3 without a result
where torch sees no CUDA device (it never falls back to the CPU), and 4
where JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import os   # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# build and kernel caches at fixed paths inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[var] = os.path.join(ROOT, "build", "benchmark_cache", sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path[:] = [ROOT] + [p for p in sys.path
                        if os.path.abspath(p or ".") != os.path.dirname(
                            os.path.abspath(__file__))]

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], t_start=T_START))
