"""Where K6 h16's time goes on the card: the kernel
(``csrc/octet_topk_batch_h16.cu``) against copies of it with one part
taken out, timed on the headline corpus for one group of 32 queries.

Each variant is the kernel's source (and batch_sweep.cuh, its harvest)
with a few lines replaced (``PARTS``), built with nvcc beside the
package's library (``build/spmv_topk_tpu_torch/ablation/<variant>/``)
and launched through the same entry point, the lane merge left out (the sweep alone, as
``ops/kernel.py::octet_topk_batch_cuda(..., unmerged=True)``):

  kernel       the kernel as it is;
  no_loads     each word made from its address instead of read from
               device memory (the same decode work, no stream bytes);
  no_harvest   no (lane, query) pair ever queued: the octet's largest
               member is still found and compared, nothing is replaced;
  no_flush     each query's packed sum stored as it is (no bias taken
               out, no shift) before the harvest;
  no_decode    each word added to one accumulator instead of decoded
               against the 32 queries;
  no_decode_no_harvest  both: the loads, the member sums' stores, the
               barriers and the per-octet bookkeeping.

Only ``kernel`` computes the right answer; the others are timing probes.
Each line: the variant, its ms (median of 5 runs of 10 launches between
CUDA events) and its share of the kernel's; first the card's name and
power limit.

    python -m spmv_topk_tpu_torch.experiments.k6_h16_ablation [variant ...]

Env: ``ABL_ROWS`` (default 10,000,000 rows, the headline corpus).
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from ..config import LANES
from ..ops import _build
from ..ops import kernel as K
from ._common import smi_line, variant_dir

# the kernel's source and the harvest it shares with K6's other codecs
# and K8, the files a variant patches
SOURCES = ("octet_topk_batch_h16.cu", "batch_sweep.cuh")
OUT_DIR = os.path.join(_build.BUILD_DIR, "ablation")
# variant -> (old, new) replacements of the kernel's source
_DECODE = ("H16x32::add<NR>(acc, vs, w0[i], tab);", "acc[i] += w0[i];")
_HARVEST = ("enqueue(static_cast<float>(top) >= buf_min[q * L + lane],",
            "enqueue(false,")
PARTS = {
    "kernel": (),
    "no_loads": ((
        "w[i] = j + i < o.width ? static_cast<uint32_t>(__ldg(o.src + "
        "member * kLanes +\n                                                  "
        "          (j + i) * kStep))",
        "w[i] = j + i < o.width ? static_cast<uint32_t>(reinterpret_cast<"
        "uintptr_t>(o.src) >> 2) * 2654435761u + (j + i) * 40503u + "
        "member * 977u"),),
    "no_harvest": (_HARVEST,),
    "no_flush": ((
        "static_cast<uint32_t>(H16x32::finish(acc[q], vs, q % 8));",
        "static_cast<uint32_t>(acc[q]);"),),
    "no_decode": (_DECODE,),
    "no_decode_no_harvest": (_DECODE, _HARVEST),
}
ROWS = int(os.environ.get("ABL_ROWS", 10_000_000))
HEADLINE = dict(k=100, lane_k=8, max_cols=1024, query_codec="h16",
                fused_layout="octet", width_quantum=2, fold_tile=8,
                fused_block_sublanes=1024, rescore_pool=400)


def build(name: str) -> str:
    """nvcc the variant (its copies of the kernel's source and of
    batch_sweep.cuh, the harvest it shares) into a shared library; its
    path."""
    d = variant_dir(os.path.join(OUT_DIR, name), SOURCES, PARTS[name])
    so = os.path.join(d, f"{name}.so")
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                          "-I", d, "-I", _build.CSRC_DIR, "-o", so,
                          os.path.join(d, SOURCES[0])],
                         capture_output=True, text=True, timeout=900)
    if res.returncode:
        raise RuntimeError(f"nvcc {name} failed:\n{res.stderr[-4000:]}")
    return so


def launcher(so: str, eng, tables, cfg):
    """A call of the variant's sweep (no merge) on the engine's stream."""
    fn = ctypes.CDLL(so).octet_topk_batch_h16
    fn.argtypes = _build._SIGNATURES["octet_topk_batch_h16"]
    fn.restype = ctypes.c_int
    dev = eng.words.device
    Q, P, lk = tables.shape[0], cfg.num_partitions, cfg.lane_k
    passes, slots = K.octet_h16_grid(
        Q, torch.cuda.get_device_properties(dev).multi_processor_count, P,
        lk)
    lists = Q * P * (slots + K._merge_sets(slots))
    ws = torch.empty(lists * 2 * lk * LANES, dtype=torch.int32, device=dev)
    tickets = torch.zeros(passes * P * 4 * (1 + K._merge_sets(slots)),
                          dtype=torch.int32, device=dev)
    out = torch.empty((2, Q, P, lk, LANES), dtype=torch.int32, device=dev)
    args = (eng.words.data_ptr(), tables.data_ptr(), eng.nreal.data_ptr(),
            eng.plan_rows.data_ptr(), eng.plan_rows.shape[0],
            eng.fused.block_sublanes, lk, int(cfg.fold_tile == 1),
            int(bool(cfg.tie_safe_topk)), Q, slots, P,
            eng.words.shape[0] // P, 0, 0, ws.data_ptr(), lists,
            tickets.data_ptr(), tickets.numel(), out[0].data_ptr(),
            out[1].data_ptr())

    def call():
        _build.check(fn(*args, torch.cuda.current_stream(dev).cuda_stream),
                     "octet_topk_batch_h16")
    return call


def time_ms(call, reps: int = 5, launches: int = 10) -> float:
    call()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(launches):
            call()
        e1.record()
        e1.synchronize()
        ts.append(e0.elapsed_time(e1) / launches)
    return statistics.median(ts)


def main(argv=None) -> list:
    import spmv_topk_tpu_torch as pt
    from spmv_topk_tpu_torch.formats import (create_query_batch,
                                             create_sparse_matrix)
    from spmv_topk_tpu_torch.ops.quantized_query import pack_query_tables

    names = list(argv if argv is not None else sys.argv[1:]) or list(PARTS)
    unknown = [n for n in names if n not in PARTS]
    if unknown:
        raise SystemExit(f"unknown variant(s) {unknown}: {list(PARTS)}")
    if not torch.cuda.is_available():
        raise SystemExit("k6_h16_ablation times kernels: it needs a card")
    if "kernel" not in names:
        names.insert(0, "kernel")
    with ThreadPoolExecutor(len(names)) as ex:
        libs = dict(zip(names, ex.map(build, names)))
    dev = torch.device("cuda")
    print(smi_line(), flush=True)
    coo = create_sparse_matrix(ROWS, 1024, 20, "gamma", seed=1)
    cfg = pt.TopKSpMVConfig(**HEADLINE)
    eng = pt.TopKSpMV(coo, cfg, device=dev)
    tables = torch.from_numpy(pack_query_tables(
        create_query_batch(32, 1024, seed=3), "h16")[0]).to(dev)
    ms = {n: time_ms(launcher(libs[n], eng, tables, cfg)) for n in names}
    lines = [dict(lab="k6_h16_ablation", variant=n, ms=ms[n],
                  share_of_kernel=ms[n] / ms["kernel"], rows=ROWS,
                  queries=32, words_bytes=eng.hbm_bytes,
                  device=torch.cuda.get_device_name(dev)) for n in names]
    for line in lines:
        print(json.dumps(line), flush=True)
    return lines


if __name__ == "__main__":
    main()
