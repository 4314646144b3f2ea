"""K6 h16 and K8 beside the same kernels built from another checkout's
sources, in turns on one card.

    python -m spmv_topk_tpu_torch.experiments.batch_against OTHER_CSRC

OTHER_CSRC is the ``spmv_topk_tpu_torch/csrc`` directory of another
checkout (for example the parent commit's, unpacked with ``git archive``
into a directory that git ignores), whose C entry points
``octet_topk_batch_h16`` and ``slice_topk_batch`` take the arguments this
package's wrappers pass. Each side's units of the two kernels
(``ENTRIES``) are built with nvcc into a library of their own
(``build/spmv_topk_tpu_torch/batch_against/``), and each route is timed
through the package's wrapper with one library and then the other in the
package library's place (``_build._LIB``), in turns (other, this, this,
other; each 10 launches between CUDA events after 2 more), after
requiring the two sides' pairs equal, tie-safe and with production
buffers. The routes: K6 h16 on the headline octet engine, a group of 32
(``chip_smoke.py``'s main path), and K8's and K10c's routes of
``k8_ablation.ROUTES``, on the 10M x 1024 corpus. Each line: the route,
both sides' ms a group and their ratio; first the card's name and power
limit.

Env: ``ABL_ROWS`` (default 10,000,000 rows).
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import json
import os
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from ..ops import _build
from ..ops import kernel as K
from ._common import cuda_ms, smi_line
from .k8_ablation import ROUTES as K8_ROUTES

# the C entry points compared and the units that build them
ENTRIES = {"octet_topk_batch_h16": ("octet_topk_batch_h16.cu",),
           "slice_topk_batch": ("slice_topk_batch.cu",
                                "slice_topk_batch_f32.cu",
                                "slice_topk_batch_q.cu")}
OUT_DIR = os.path.join(_build.BUILD_DIR, "batch_against")
ROWS = int(os.environ.get("ABL_ROWS", 10_000_000))
HEADLINE = dict(k=100, lane_k=8, max_cols=1024, query_codec="h16",
                fused_layout="octet", width_quantum=2,
                fused_block_sublanes=1024, fold_tile=8, rescore_pool=400)
ROUTES = {"k6_h16": (HEADLINE, 32), **K8_ROUTES}


def _compile(args):
    csrc, src, obj = args
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", csrc,
                          "-c", "-o", obj, os.path.join(csrc, src)],
                         capture_output=True, text=True, timeout=900)
    if res.returncode:
        raise RuntimeError(f"nvcc {csrc}/{src} failed:\n{res.stderr[-4000:]}")
    return obj


def build(sides: dict) -> dict:
    """{side: loaded library} of ENTRIES' units from each side's csrc
    directory, every unit compiled at once."""
    jobs = {}
    for side, csrc in sides.items():
        d = os.path.join(OUT_DIR, side)
        os.makedirs(d, exist_ok=True)
        for units in ENTRIES.values():
            for u in units:
                jobs[(side, u)] = (csrc, u, os.path.join(d, u + ".o"))
    with ThreadPoolExecutor(len(jobs)) as ex:
        objs = dict(zip(jobs, ex.map(_compile, jobs.values())))
    libs = {}
    for side in sides:
        so = os.path.join(OUT_DIR, side, "lib.so")
        subprocess.run([_build._nvcc(), "-shared", "-o", so,
                        *(o for (s, _), o in objs.items() if s == side)],
                       check=True, capture_output=True, timeout=300)
        lib = ctypes.CDLL(so)
        for name in ENTRIES:
            fn = getattr(lib, name)
            fn.argtypes = _build._SIGNATURES[name]
            fn.restype = ctypes.c_int
        libs[side] = lib
    return libs


@contextlib.contextmanager
def _using(lib):
    """The package's wrappers launch ``lib``'s entry points."""
    saved = _build._LIB
    _build._LIB = lib
    try:
        yield
    finally:
        _build._LIB = saved


def _routes(libs, coo, qs, dev):
    import spmv_topk_tpu_torch as pt

    lines = []
    for route, (config, n) in ROUTES.items():
        cfg = pt.TopKSpMVConfig(**config)
        eng = pt.TopKSpMV(coo, cfg, device=dev)
        tables = torch.stack([eng._table(q)[0] for q in qs[:n]])

        def launch(c, lib):
            with _using(lib):
                return eng._layout.batch_sweep(
                    eng.words, tables, eng.nreal, eng.plan_rows, cfg=c,
                    block_sublanes=eng.fused.block_sublanes,
                    **eng.partition_kw)

        for tie_safe in (True, False):
            c = dataclasses.replace(cfg, tie_safe_topk=tie_safe)
            this, other = (launch(c, libs[s]) for s in ("this", "other"))
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(this, other)):
                raise RuntimeError(f"{route} tie_safe={tie_safe}: the two "
                                   "sides' pairs differ")
        turns = {"other": [], "this": []}
        for side in ("other", "this", "this", "other"):
            turns[side].append(cuda_ms(lambda s=side: launch(cfg, libs[s]),
                                       10, warmup=2))
        ms = {s: statistics.median(v) for s, v in turns.items()}
        line = dict(lab="batch_against", route=route, queries=n,
                    partitions=cfg.num_partitions, codec=cfg.query_codec,
                    this_ms=ms["this"], other_ms=ms["other"],
                    ratio=ms["this"] / ms["other"], turns=turns,
                    device=torch.cuda.get_device_name(dev))
        print(json.dumps(line), flush=True)
        lines.append(line)
        del eng
        torch.cuda.empty_cache()
    return lines


def main(argv=None) -> list:
    from spmv_topk_tpu_torch.formats import (create_query_batch,
                                             create_sparse_matrix)

    args = list(argv if argv is not None else sys.argv[1:])
    if len(args) != 1 or not os.path.isdir(args[0]):
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("batch_against times kernels: it needs a card")
    _build.lib()   # the package's other kernels, as an engine may use them
    libs = build({"this": _build.CSRC_DIR,
                  "other": os.path.abspath(args[0])})
    dev = torch.device("cuda")
    print(smi_line(), flush=True)
    coo = create_sparse_matrix(ROWS, 1024, 20, "gamma", seed=1)
    qs = create_query_batch(32, 1024, seed=3)
    return _routes(libs, coo, qs, dev)


if __name__ == "__main__":
    main()
