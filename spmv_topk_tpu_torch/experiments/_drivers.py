"""What the experiment drivers (``octet_lab``, ``octet_batch_lab``,
``octet_block_lab``, ``octet_multicall_lab``, ``cfg_sweep``, ``q1_ab``)
share: their corpus, their command line, and the slopes they time.

The JAX drivers time ``jax.lax.scan``s of the fused sweeps over query
tables packed beforehand, as the slope between a short and a long scan.
Here a timed run enqueues the same sweeps through the engine's own entry
points (``TopKSpMV.table_candidates`` for one query, ``batch_candidates``
for a group) behind a hold of the stream and ends in a synchronize
(``utils.profiling.held_runner``), so the slope is the card's time a
sweep. Each driver prints one JSON object a line, its results, and
returns them. On the CPU the sweeps are the kernels' plain versions and
the times mean nothing; the precision spot checks hold all the same.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..api import TopKSpMV
from ..config import TopKSpMVConfig
from ..formats import create_query_batch, create_sparse_matrix
from ..ops.gold import topk_exact
from ..ops.quantized_query import pack_query_tables
from ..utils.profiling import held_runner

COLS = 1024
DEG = 20


def parse_args(argv, description: str, rows: int, extra=None):
    """The drivers' command line: ``--rows`` (default ``rows``) and
    ``--device`` (default cuda), and what ``extra(ap)`` adds."""
    ap = argparse.ArgumentParser(description=description.split("\n")[0])
    ap.add_argument("--rows", type=int, default=rows,
                    help="corpus rows (x 1024 columns, degree 20, gamma, "
                         "seed 1; default %(default)s)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engines (cpu: the kernels' "
                         "plain versions)")
    if extra is not None:
        extra(ap)
    args = ap.parse_args(argv)
    args.device = torch.device(args.device)
    return args


def corpus(rows: int):
    """The drivers' corpus: ``rows`` x 1024, degree 20, gamma, seed 1 (the
    JAX drivers' and bench.py's)."""
    return create_sparse_matrix(rows, COLS, DEG, "gamma", seed=1)


def h16_config(**kw) -> TopKSpMVConfig:
    """The drivers' h16 engine (k 100, lane_k 8, 1024 columns) with ``kw``
    (layout, quantum, blocks, fold, pool, ...)."""
    return TopKSpMVConfig(**dict(dict(k=100, lane_k=8, max_cols=COLS,
                                      query_codec="h16"), **kw))


def build(coo, cfg, device):
    """(engine, seconds to pack and upload)."""
    t0 = time.perf_counter()
    eng = TopKSpMV(coo, cfg, device=device)
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    return eng, time.perf_counter() - t0


def geometry(eng) -> dict:
    return dict(buckets=len(eng.fused.plan), blocks=eng.fused.num_blocks,
                padding=eng.fused.padding_ratio,
                words_per_nnz=eng.bytes_per_nnz / 4)


def query_tables(eng, n: int, seed: int):
    """n single-query tables on the engine's device."""
    return [eng._table(q)[0]
            for q in create_query_batch(n, eng.num_cols, seed=seed)]


def group_tables(eng, Q: int, n_groups: int, seed: int):
    """n_groups groups of Q queries' tables (``pack_query_tables``, as
    ``query_batch`` packs them), from one batch of Q * n_groups queries."""
    qs = create_query_batch(Q * n_groups, eng.num_cols, seed=seed)
    padded = np.zeros((len(qs), eng.config.max_cols), np.float32)
    padded[:, :eng.num_cols] = qs
    out = []
    for i in range(n_groups):
        tabs, _ = pack_query_tables(padded[i * Q:(i + 1) * Q],
                                    eng.config.query_codec)
        out.append(torch.from_numpy(tabs).to(eng.device))
    return out


def single_runner(eng, tables, sweep=None):
    """run_n(n): n back-to-back sweeps of ``tables`` (cycled) through
    ``sweep(table)`` (default ``eng.table_candidates``)."""
    sweep = sweep or eng.table_candidates
    return held_runner(eng.device, lambda i: sweep(tables[i % len(tables)]))


def batch_runner(eng, groups):
    """run_n(n): n back-to-back batch sweeps of ``groups`` (cycled)."""
    return held_runner(eng.device,
                       lambda i: eng.batch_candidates(groups[i % len(groups)]))


def timed(run_n, n: int) -> float:
    """Host seconds of ``run_n(n)`` (which ends in a synchronize)."""
    t0 = time.perf_counter()
    run_n(n)
    return time.perf_counter() - t0


def slopes(pairs: dict, short: int, long_: int, reps: int) -> dict:
    """{name: [seconds an iteration]}: ``reps`` rounds, each timing every
    name's long and short run in turn (``pairs``: name -> run_n), so that
    the card's drift over the rounds falls on every name alike."""
    out = {n: [] for n in pairs}
    for _ in range(reps):
        for n, run_n in pairs.items():
            out[n].append((timed(run_n, long_) - timed(run_n, short))
                          / (long_ - short))
    return out


def warm(run_n, short: int, long_: int) -> float:
    """Seconds of a first short and long run (the kernels' first launch
    loads or builds their library)."""
    t0 = time.perf_counter()
    run_n(short)
    run_n(long_)
    return time.perf_counter() - t0


def precision_at_100(eng, coo, seed: int) -> float:
    """precision@100 of ``eng.query`` on query ``seed`` against the exact
    top-100."""
    q = create_query_batch(1, coo.num_cols, seed=seed)[0]
    ki = eng.query(q)[0].cpu().numpy()
    gi, _ = topk_exact(coo, q, 100)
    return len(set(gi.tolist()) & set(ki.tolist())) / 100


def emit(obj: dict) -> dict:
    print(json.dumps(obj), flush=True)
    return obj


def device_name(device) -> str:
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" \
        else device.type
