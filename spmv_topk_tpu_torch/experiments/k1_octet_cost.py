"""How K1's deal of octets to slots weighs an octet: the kernel
(``csrc/octet_topk.cuh``, whose ``kOctetCost`` is an octet's work in the
deal beside its chunks) against copies of it built with other costs,
timed on the headline corpus for one query.

Each variant is K1's h16 source with ``kOctetCost`` replaced (``cost0``:
slots balanced by chunks alone; ``cost1``: the kernel as it is;
``cost2``), built with nvcc beside the package's library (``build/
spmv_topk_tpu_torch/k1_octet_cost/``, the h16 instantiations only) and
launched through the same entry point, its lane merge included. Every
variant computes a right answer: its values with tie-safe buffers are
required equal to ``octet_topk_plain``'s (the values do not depend on the
deal; the tags at ties and, without tie-safe buffers, the copies kept
do), and only ``cost1`` is the deal that ``octet_topk_slots_plain``
follows. Each line: the variant, its ms (median of 5 runs of 10 launches
between CUDA events), its share of ``cost1``'s, and its deal's largest
slot over the mean in chunks and in work (``ops/kernel.py::k1_deal``);
first the card's name and power limit.

    python -m spmv_topk_tpu_torch.experiments.k1_octet_cost [variant ...]

Env: ``COST_ROWS`` (default 10,000,000 rows, the headline corpus).
"""

from __future__ import annotations

import array
import ctypes
import dataclasses
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from ..config import LANES
from ..ops import _build
from ..ops import kernel as K
from ._common import smi_line
from .k6_h16_ablation import HEADLINE, time_ms

OUT_DIR = os.path.join(_build.BUILD_DIR, "k1_octet_cost")
COSTS = {"cost0": 0, "cost1": 1, "cost2": 2}
# (file, old, new): the cost, and the entry point kept to h16 (the other
# codecs' instantiations live in translation units of their own)
_CONSTANT = "constexpr int kOctetCost = 1;"
_DISPATCH = ("  if (c.codec == kF32 || c.codec == kF32Global) return "
             "k1::run_f32(c);\n  return k1::run_quantized(c);",
             "  return cudaErrorInvalidValue;")
ROWS = int(os.environ.get("COST_ROWS", 10_000_000))


def _edit(name: str, old: str, new: str) -> str:
    src = open(os.path.join(_build.CSRC_DIR, name)).read()
    if old not in src:
        raise RuntimeError(f"{name} no longer holds {old!r}")
    return src.replace(old, new)


def build(name: str) -> str:
    """nvcc the variant into a shared library; its path. Its header copy
    sits beside its source, so ``#include "octet_topk.cuh"`` finds it
    first and the shared headers come from ``csrc/``."""
    out = os.path.join(OUT_DIR, name)
    os.makedirs(out, exist_ok=True)
    files = {"octet_topk.cuh": _edit("octet_topk.cuh", _CONSTANT,
                                     f"constexpr int kOctetCost = "
                                     f"{COSTS[name]};"),
             "octet_topk.cu": _edit("octet_topk.cu", *_DISPATCH)}
    for fname, src in files.items():
        with open(os.path.join(out, fname), "w") as fh:
            fh.write(src)
    so = os.path.join(out, "k1.so")
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                          "-I", _build.CSRC_DIR, "-o", so,
                          os.path.join(out, "octet_topk.cu")],
                         capture_output=True, text=True, timeout=900)
    if res.returncode:
        raise RuntimeError(f"nvcc {name} failed:\n{res.stderr[-4000:]}")
    return so


def launcher(so: str, eng, table, cfg):
    """A call of the variant's K1 (merged) on the current stream, packed
    as ``ops/kernel.py::_octet_topk_cuda`` packs it; its (values, tags)
    outputs."""
    lib = ctypes.CDLL(so)
    fn = lib.octet_topk
    fn.argtypes = _build._SIGNATURES["octet_topk"]
    fn.restype = ctypes.c_int
    occ = lib.octet_topk_occupancy
    occ.argtypes = _build._SIGNATURES["octet_topk_occupancy"]
    occ.restype = ctypes.c_int
    dev = eng.words.device
    rows = table.shape[0]
    arg, _ = K._kernel_codec(dev, "h16", rows)
    lk = cfg.lane_k
    per_sm = occ(arg, lk, int(cfg.fold_tile == 1),
                 int(bool(cfg.tie_safe_topk)), rows)
    if per_sm < 1:
        raise RuntimeError(f"octet_topk_occupancy: {per_sm}")
    blocks, _ = K.octet_grid(
        torch.cuda.get_device_properties(dev).multi_processor_count, 1,
        per_sm, eng.words.shape[0] // cfg.chunk_sublanes)
    sets = K._merge_sets(blocks)
    lists = blocks + sets
    ws = torch.empty(lists * 2 * lk * LANES, dtype=torch.int32, device=dev)
    tickets = torch.zeros(1 + sets, dtype=torch.int32, device=dev)
    out_v = torch.empty((1, lk, LANES), dtype=torch.float32, device=dev)
    out_t = torch.empty((1, lk, LANES), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = array.array("q", (
        eng.words.data_ptr(), table.data_ptr(), eng.nreal.data_ptr(),
        eng.plan_rows.data_ptr(), eng.plan_rows.shape[0],
        eng.fused.block_sublanes, rows, arg, lk, int(cfg.fold_tile == 1),
        int(bool(cfg.tie_safe_topk)), blocks, 1, eng.words.shape[0], 0, 1,
        ws.data_ptr(), lists, tickets.data_ptr(), tickets.numel(),
        out_v.data_ptr(), out_t.data_ptr(), stream))

    def call():
        _build.check(fn(args.buffer_info()[0]), "octet_topk")
        return out_v[0], out_t[0]
    return call, blocks * K.K1_GROUPS


def balance(eng, slots: int, cost: int) -> dict:
    """The deal's largest slot over the mean, in chunks and in work."""
    chunks = K.octet_real_chunks(eng.plan_rows, eng.nreal)
    work = (chunks + cost) * (chunks > 0)
    slot = K.k1_deal(eng.plan_rows, eng.nreal, slots, octet_cost=cost)
    out = {}
    for what, x in (("chunks", chunks), ("work", work)):
        per = torch.bincount(slot, weights=x.double(), minlength=slots)
        out[f"slot_{what}_max_over_mean"] = float(per.max() / per.mean())
    return out


def main(argv=None) -> list:
    import spmv_topk_tpu_torch as pt
    from spmv_topk_tpu_torch.formats import (create_query_batch,
                                             create_sparse_matrix)

    names = list(argv if argv is not None else sys.argv[1:]) or list(COSTS)
    unknown = [n for n in names if n not in COSTS]
    if unknown:
        raise SystemExit(f"unknown variant(s) {unknown}: {list(COSTS)}")
    if not torch.cuda.is_available():
        raise SystemExit("k1_octet_cost times kernels: it needs a card")
    if "cost1" not in names:
        names.insert(0, "cost1")
    with ThreadPoolExecutor(len(names)) as ex:
        libs = dict(zip(names, ex.map(build, names)))
    dev = torch.device("cuda")
    print(smi_line(), flush=True)
    coo = create_sparse_matrix(ROWS, 1024, 20, "gamma", seed=1)
    cfg = pt.TopKSpMVConfig(**dict(HEADLINE, rescore_pool=None))
    eng = pt.TopKSpMV(coo, cfg, device=dev)
    table, _ = eng._table(create_query_batch(1, 1024, seed=3)[0])
    safe = dataclasses.replace(cfg, tie_safe_topk=True)
    pv, _ = K.octet_topk_plain(
        eng.words, table, eng.nreal, eng.plan_rows,
        **K._sweep_kw(safe, eng.fused.block_sublanes))
    ms, slots = {}, {}
    for n in names:
        check, _ = launcher(libs[n], eng, table, safe)
        kv, _ = check()
        torch.cuda.synchronize()
        if not torch.equal(kv, pv):
            raise RuntimeError(f"{n}: tie-safe values differ from "
                               "octet_topk_plain's")
        call, slots[n] = launcher(libs[n], eng, table, cfg)
        ms[n] = time_ms(call)
    lines = [dict(lab="k1_octet_cost", variant=n, octet_cost=COSTS[n],
                  ms=ms[n], share_of_cost1=ms[n] / ms["cost1"],
                  slots=slots[n], **balance(eng, slots[n], COSTS[n]),
                  rows=ROWS, words_bytes=eng.hbm_bytes,
                  device=torch.cuda.get_device_name(dev)) for n in names]
    for line in lines:
        print(json.dumps(line), flush=True)
    return lines


if __name__ == "__main__":
    main()
