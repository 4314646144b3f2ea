"""Where K7's time goes on the card: the kernel (``csrc/slice_topk.cuh``)
against copies of it with a part changed or taken out, timed on the 10M x
1024 corpus in bench.py's slice h16 engine and in the default f32 engine,
one query, the lane merge included (the launch as the wrapper makes it).

Each variant is the kernel's header with a few lines replaced
(``PARTS``), built with nvcc beside the package's library (``build/
spmv_topk_tpu_torch/k7_ablation/``, h16 and f32 instantiations only) and
launched through the same entry point:

  kernel       the kernel as it is;
  cost<N>      the slots dealt with an item's cost N rows (the kernel:
               ``kItemCost``): how much locating, harvesting and
               stepping through an item costs beside its rows;
  chunk4       chunks of 4 rows of a member (8 in the kernel);
  no_harvest   no score enters the buffers (each compared with a value
               none takes; the sums, a sub-tile's top 2 and the walk as
               they are);
  no_decode    each word added as it is instead of decoded against the
               query's table;
  no_loads     each word made from its address instead of read from
               device memory (the same work, no stream bytes).

The ``kernel`` and ``cost<N>`` and ``chunk4`` variants compute K7's
values: with tie-safe buffers they must equal ``slice_topk_plain``'s (the
run raises otherwise); the others are timing probes. Each line: the
engine, the variant, its ms (median of 5 runs of 10 launches between CUDA
events), its share of the kernel's, and K3's ms on the same words; first
the card's name and power limit.

    python -m spmv_topk_tpu_torch.experiments.k7_ablation [variant ...]

Env: ``ABL_ROWS`` (default 10,000,000 rows).
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
from ._common import smi_line, stream_ms, sweep_ms

HEADER = os.path.join(_build.CSRC_DIR, "slice_topk.cuh")
UNIT = os.path.join(_build.CSRC_DIR, "slice_topk.cu")
OUT_DIR = os.path.join(_build.BUILD_DIR, "k7_ablation")
ROWS = int(os.environ.get("ABL_ROWS", 10_000_000))
# the h16 unit, with the f32 codec (its table in shared memory) and no
# other codec
_F32_ONLY = """
namespace k7 {
cudaError_t run_f32(const Call& c) {
  using namespace codec;
  return run_codecs<codec_set<kF32>()>(c);
}
cudaError_t run_quantized(const Call&) { return cudaErrorInvalidValue; }
}  // namespace k7
"""
_COST = "constexpr int kItemCost = 16;"
PARTS = {
    "kernel": (),
    "cost0": ((_COST, "constexpr int kItemCost = 0;"),),
    "cost8": ((_COST, "constexpr int kItemCost = 8;"),),
    "cost32": ((_COST, "constexpr int kItemCost = 32;"),),
    "chunk4": (("constexpr int kChunkRows = 8;",
                "constexpr int kChunkRows = 4;"),),
    "no_harvest": (("if (sc >= tmin) replace<K, TIE_SAFE>(",
                    "if (sc == 1.5e30f) replace<K, TIE_SAFE>("),
                   ("if (!top.nan && top.m1 >= tmin) {",
                    "if (top.m1 == 1.5e30f) {")),
    "no_decode": (("acc = C::add(acc, cur[d], tab);", "acc += cur[d];"),),
    "no_loads": (("static_cast<uint32_t>(__ldg(row + d * kLanes))",
                  "static_cast<uint32_t>(reinterpret_cast<uintptr_t>("
                  "row + d * kLanes) >> 2)"),),
}
# the variants that compute K7's values
EXACT = ("kernel", "cost0", "cost8", "cost32", "chunk4")
SLICE_H16 = dict(k=100, lane_k=8, max_cols=1024, query_codec="h16",
                 fused_layout="slice", width_quantum=2,
                 fused_block_sublanes=1024, fold_tile=8, rescore_pool=400)
DEFAULT = dict(k=100, max_cols=1024)


def variant_header(name: str) -> str:
    src = open(HEADER).read()
    for old, new in PARTS[name]:
        if old not in src:
            raise RuntimeError(f"{name}: the kernel's source no longer "
                               f"holds {old!r}")
        src = src.replace(old, new)
    return src


def build(name: str) -> str:
    """nvcc the variant (its header beside a copy of slice_topk.cu) into a
    shared library; its path."""
    d = os.path.join(OUT_DIR, name)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "slice_topk.cuh"), "w") as fh:
        fh.write(variant_header(name))
    cu = os.path.join(d, "unit.cu")
    with open(cu, "w") as fh:
        fh.write(open(UNIT).read() + _F32_ONLY)
    so = os.path.join(d, "k7.so")
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                          "-I", d, "-I", _build.CSRC_DIR, "-o", so, cu],
                         capture_output=True, text=True, timeout=900)
    if res.returncode:
        raise RuntimeError(f"nvcc {name} failed:\n{res.stderr[-4000:]}")
    return so


def launcher(so: str, eng, table, cfg):
    """A launch of the variant on the engine's stream, as
    ``ops/kernel.py::_slice_topk_cuda`` makes it: (call, the pair it
    returns)."""
    fn = ctypes.CDLL(so).slice_topk
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dev = eng.words.device
    P, lk = cfg.num_partitions, cfg.lane_k
    rows, _ = K._table_spec(cfg)
    arg, _ = K._kernel_codec(dev, cfg.query_codec, rows)
    part_rows = eng.words.shape[0] // P
    blocks, _ = K.slice_topk_grid(dev, cfg, part_rows, P)
    sets = K._merge_sets(blocks)
    ws = torch.empty(P * (blocks + sets) * 2 * lk * LANES, dtype=torch.int32,
                     device=dev)
    tickets = torch.zeros(P * (1 + sets), dtype=torch.int32, device=dev)
    out_v = torch.empty((P, lk, LANES), dtype=torch.float32, device=dev)
    out_t = torch.empty((P, lk, LANES), dtype=torch.int32, device=dev)
    args = array.array("q", (
        eng.words.data_ptr(), table.data_ptr(), eng.nreal.data_ptr(),
        eng.plan_rows.data_ptr(), eng.plan_rows.shape[0],
        eng.fused.block_sublanes, rows, arg, lk, cfg.fold_tile,
        int(bool(cfg.tie_safe_topk)), blocks, P, part_rows,
        eng.partition_kw.get("part_slices", 0), 1, ws.data_ptr(),
        ws.numel() // (2 * lk * LANES), tickets.data_ptr(), tickets.numel(),
        out_v.data_ptr(), out_t.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream))

    def call():
        _build.check(fn(args.buffer_info()[0]), "slice_topk (variant)")
    return call, (out_v[0], out_t[0])


def main(argv=None) -> list:
    import spmv_topk_tpu_torch as pt
    from spmv_topk_tpu_torch.formats import (create_query_batch,
                                             create_sparse_matrix)

    names = list(argv if argv is not None else sys.argv[1:]) or list(PARTS)
    unknown = [n for n in names if n not in PARTS]
    if unknown:
        raise SystemExit(f"unknown variant(s) {unknown}: {list(PARTS)}")
    if not torch.cuda.is_available():
        raise SystemExit("k7_ablation times kernels: it needs a card")
    if "kernel" not in names:
        names.insert(0, "kernel")
    with ThreadPoolExecutor(len(names)) as ex:
        libs = dict(zip(names, ex.map(build, names)))
    dev = torch.device("cuda")
    print(smi_line(), flush=True)
    coo = create_sparse_matrix(ROWS, 1024, 20, "gamma", seed=1)
    q = create_query_batch(1, 1024, seed=3)[0]
    lines = []
    for engine, config in (("slice_h16", SLICE_H16), ("default_f32",
                                                      DEFAULT)):
        cfg = pt.TopKSpMVConfig(**config)
        eng = pt.TopKSpMV(coo, cfg, device=dev)
        table, _ = eng._table(q)
        safe = dataclasses.replace(cfg, tie_safe_topk=True)
        want, _ = K.slice_topk_plain(
            eng.words, table, eng.nreal, eng.plan_rows, lane_k=cfg.lane_k,
            fold_tile=cfg.fold_tile, tie_safe=True,
            block_sublanes=eng.fused.block_sublanes, codec=cfg.query_codec)
        for name in EXACT:
            if name in names:
                call, (got, _) = launcher(libs[name], eng, table, safe)
                call()
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise RuntimeError(f"{engine} {name}: values differ "
                                       "from slice_topk_plain's")
        k3 = stream_ms(eng.words)
        ms = {n: sweep_ms(launcher(libs[n], eng, table, cfg)[0])
              for n in names}
        for n in names:
            line = dict(lab="k7_ablation", engine=engine, variant=n,
                        ms=ms[n], share_of_kernel=ms[n] / ms["kernel"],
                        k3_ms=k3, words_bytes=eng.hbm_bytes,
                        device=torch.cuda.get_device_name(dev))
            print(json.dumps(line), flush=True)
            lines.append(line)
        del eng
        torch.cuda.empty_cache()
    return lines


if __name__ == "__main__":
    main()
