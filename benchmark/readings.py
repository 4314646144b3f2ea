#!/usr/bin/env python3
"""The readings that a cell's check limits are set from, in one process.

    python3 benchmark/readings.py --workload c3_i8s_tiesafe.batch64 \
        --seeds 11,12,13 --control-seeds 11,12,13 --seconds 3

For each seed: the corpus and queries, the program's engine, a short
window of the cell's traffic, and the check's numbers of what it served
(a sound run's reading). For each control seed, on the same corpus: the
configuration's control (``control`` in its file) judged by the same
check: either the program with its own lower-precision path switched on
(``"kind": "program"``, its ``engine`` keywords), or the reference put
in the program's place and computed in the lower precision
(``"kind": "reference"``, its ``precision``). One JSON line a reading;
the limits go in ``benchmark/cells/<workload>.json``.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:] = [ROOT] + [p for p in sys.path
                        if os.path.abspath(p or ".") != os.path.dirname(
                            os.path.abspath(__file__))]

import argparse  # noqa: E402
import gc        # noqa: E402
import json      # noqa: E402
import time      # noqa: E402

import numpy as np  # noqa: E402
import torch        # noqa: E402

from benchmark import corpus, harness  # noqa: E402
from benchmark.reference import exact_topk  # noqa: E402


def control_answers(cell, seed, device, pool, precision, k):
    """The reference in the program's place, in ``precision``: the top-k
    rows and values of as many queries as the check samples, as a
    window's answers."""
    n = cell.traffic["queries_per_request"]
    m = min(-(-cell.traffic["check_queries"] // n), len(pool) // n) * n
    c = corpus.make_corpus(cell.config["corpus"], seed, device)
    mat = exact_topk.csr(c["indptr"], c["cols"], c["vals"], c["num_rows"],
                         c["num_cols"], precision["values"])
    del c
    q = torch.from_numpy(pool[:m]).to(device)
    rows, vals = exact_topk.topk(
        mat, exact_topk.effective_query(q, precision["query"]), k)
    rows = rows.cpu().numpy().astype(np.int32)
    vals = vals.float().cpu().numpy()
    return dict(answers=[(rows[i:i + n], vals[i:i + n])
                         for i in range(0, m, n)],
                queries=m, failed=0, requests=m // n)


def reading(cell, seed, device, variant, seconds, coo, pool, fingerprint,
            log):
    ctl = cell.config["control"]
    k = cell.config["engine"].get("k", 100)
    if variant == "control" and ctl["kind"] == "reference":
        out = control_answers(cell, seed, device, pool, ctl["precision"], k)
        num_rows = cell.config["corpus"]["num_rows"]
    else:
        over = ctl["engine"] if variant == "control" else None
        eng = harness.build_engine(cell.config, coo, device, over)
        harness.warm_up(eng, cell, seed, device)
        out = harness.drive(eng, pool, cell.traffic, seconds, device)
        num_rows = eng.num_rows
        del eng
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    ok, lines, nums, bad, _ = harness.judge(cell, seed, device, pool, out, k,
                                            num_rows, fingerprint, log)
    return dict(workload=cell.name, seed=seed, variant=variant, correct=ok,
                numbers=nums, malformed=bad, queries=out["queries"])


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    device = torch.device(a.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    cell = harness.Cell(ROOT, a.workload)
    seeds = [int(s) for s in a.seeds.split(",") if s]
    ctl = [int(s) for s in a.control_seeds.split(",") if s]
    log = (lambda s: print(s, file=sys.stderr, flush=True))
    for seed in dict.fromkeys(seeds + ctl):
        t = time.perf_counter()
        coo, pool, fingerprint = harness.inputs(cell, seed, device)
        for variant in ("program", "control"):
            if seed in (seeds if variant == "program" else ctl):
                r = reading(cell, seed, device, variant, a.seconds, coo,
                            pool, fingerprint, log)
                r["seconds"] = round(time.perf_counter() - t, 3)
                print(json.dumps(r), flush=True)
        del coo, pool
        gc.collect()
    return 0


if __name__ == "__main__":
    sys.exit(main())
