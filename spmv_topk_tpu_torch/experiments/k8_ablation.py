"""Where K8's time goes on the card, and K8 beside the kernel before it.

The kernel (``csrc/slice_topk_batch.cuh``) against copies of it with a
part changed or taken out, and against the kernel it replaced, timed on
the 10M x 1024 corpus in bench.py's slice h16 engine and in the default
f32 engine, a group of 32 queries, the lane merge included (the launch as
the wrapper makes it):

  kernel       the kernel as it is, in its passes (h16 one of 32, f32 two
               of 16);
  pass<N>      the kernel in passes of N queries (h16 8, 16, 32; f32 8,
               16): the stream read 32 / N times;
  unmerged     the kernel without its lane merge (each slot's buffers
               sorted into the workspace);
  no_loads     each word made from its address instead of read from
               device memory (the same work, no stream bytes);
  no_harvest   no (lane, query) pair queued (the sums, the item maxima
               and the walk as they are);
  no_decode    no_harvest with each word's bits added into one sum
               instead of decoded against the pass's tables (no gathers,
               no products);
  lanes32      the float passes in blocks of 32 lanes, two an SM (the
               same slots; f32 only, in passes of 8, beside pass8);
  old          the kernel before (``OLD_SOURCE``: a CUDA block of 128
               lanes a subgroup of 4 queries, their buffers and sums in
               registers, one gather a query a word, items round-robin
               over the slots, the stream read once a subgroup), its
               slots merged by one per-lane ``torch.topk``, as its wrapper
               did;
  old_sweep    the kernel before without that merge.

Each variant is built with nvcc beside the package's library
(``build/spmv_topk_tpu_torch/k8_ablation/``, lane_k 8 only, h16 and f32
instantiations; the old kernel every codec) and launched as the wrapper
launches it. ``kernel``, ``pass<N>``, ``lanes32`` and ``old`` compute
K8's values: with tie-safe buffers they must equal
``slice_topk_batch_plain``'s (the run raises otherwise); the others are
timing probes. Each line: the
engine, the variant, its ms a group (median of 5 runs of 10 launches
between CUDA events), its share of the kernel's, and K3's ms on the same
words; first the card's name and power limit.

``routes`` times instead every route the engines of ``chip_smoke.py``
launch K8 and K10c on (h16 a group of 32; f32, int8x4, i8s groups of 8;
i4s 32; f32, i8s and int8x4 on 2 partitions, groups of 8) through the
package's wrapper beside the kernel before it (``old``), in turns (old,
kernel, kernel, old), after requiring the two's tie-safe values equal.

    python -m spmv_topk_tpu_torch.experiments.k8_ablation [variant ...]
    python -m spmv_topk_tpu_torch.experiments.k8_ablation routes

Env: ``ABL_ROWS`` (default 10,000,000 rows).
"""

from __future__ import annotations

import array
import ctypes
import dataclasses
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
from ._common import cuda_ms, smi_line, stream_ms, sweep_ms, variant_dir

# the sources a variant patches: the kernel and the batch sweeps' shared
# pieces
SOURCES = ("slice_topk_batch.cuh", "batch_sweep.cuh")
UNITS = [os.path.join(_build.CSRC_DIR, u)
         for u in ("slice_topk_batch.cu", "slice_topk_batch_f32.cu")]
OUT_DIR = os.path.join(_build.BUILD_DIR, "k8_ablation")
ROWS = int(os.environ.get("ABL_ROWS", 10_000_000))
GROUP = 32
_NO_QUANTIZED = """
namespace k8 {
cudaError_t run_quantized(const Call&) { return cudaErrorInvalidValue; }
}  // namespace k8
"""
_NO_HARVEST = ("const bool enter = top >= buf_min[q * L + lane];",
               "const bool enter = top == 1.5e30f;")
# every variant: lane_k 8 only
_TRIM = (("    case 4: return c.tie_safe ? run<PC, 4, true>(c) : run<PC, 4, false>(c);\n", ""),
         ("    case 16: return c.tie_safe ? run<PC, 16, true>(c) : run<PC, 16, false>(c);\n",
          ""))
PARTS = {
    "kernel": (),
    "no_loads": (("static_cast<uint32_t>(__ldg(src + (int64_t)(j + i) * kLanes))",
                  "static_cast<uint32_t>(reinterpret_cast<uintptr_t>("
                  "src + (int64_t)(j + i) * kLanes) >> 2)"),),
    "no_harvest": (_NO_HARVEST,),
    # the float passes in blocks of 32 lanes, two an SM
    "lanes32": (("constexpr int kBlockLanes = (H16 ? K <= 8 : QP * K <= 128) ? 64 : 32;",
                 "constexpr int kBlockLanes = (H16 ? K <= 8 : false) ? 64 : 32;"),
                ("__launch_bounds__(kMembers * kBlockLanes<PC::kQueries, K, PC::kExact>, 1)",
                 "__launch_bounds__(kMembers * kBlockLanes<PC::kQueries, K, PC::kExact>,"
                 " PC::kExact ? 1 : 2)")),
    # its sums garbage, so that no harvest fills its queue: beside
    # no_harvest
    "no_decode": (("PC::add(acc, w[0], width - j, view);",
                   "reinterpret_cast<uint32_t&>(acc) += "
                   "w[0][0] + w[0][1] + w[0][2] + w[0][3];"), _NO_HARVEST),
}
PASSES = {"slice_h16": (8, 16, 32), "default_f32": (8, 16)}
SLICE_H16 = dict(k=100, lane_k=8, max_cols=1024, query_codec="h16",
                 fused_layout="slice", width_quantum=2,
                 fused_block_sublanes=1024, fold_tile=8, rescore_pool=400)
DEFAULT = dict(k=100, max_cols=1024)
C3 = dict(k=100, max_cols=1024, query_codec="i8s", width_quantum=4)
C8 = dict(C3, query_codec="i4s", rescore_pool=400)
# chip_smoke.py's routes of K8 (K10c with 2 partitions): (config, queries)
ROUTES = {"k8_h16": (SLICE_H16, 32), "k8_f32": (DEFAULT, 8),
          "k8_int8x4": (dict(C3, query_codec="int8x4"), 8),
          "k8_i8s": (C3, 8), "k8_i4s": (C8, 32),
          "k10c_f32": (dict(DEFAULT, num_partitions=2), 8),
          "k10c_i8s": (dict(C3, num_partitions=2), 8),
          "k10c_int8x4": (dict(DEFAULT, num_partitions=2,
                               query_codec="int8x4"), 8)}

# The kernel before this one (the parent's csrc/slice_topk_batch.cuh and
# its entry point, lane_k 8 and subgroups of 4 only): a CUDA block of 128
# threads, one a lane, a subgroup's sums and buffers in registers; items
# g, g + slots, ... to slot g; each block's buffers to out[q][slot].
OLD_SOURCE = r"""
#include "slice_common.cuh"

namespace k8old {

using namespace slice;

template <class C, int QG>
__device__ __forceinline__ void rows_sums(const int32_t* src, int rows,
                                          const Table<unsigned char>& tab, int nq,
                                          typename C::Acc (&acc)[QG]) {
#pragma unroll
  for (int dq = 0; dq < QG; ++dq) acc[dq] = 0;
#pragma unroll 2
  for (int r = 0; r < rows; ++r)
    C::template add<QG>(acc, static_cast<uint32_t>(__ldg(src + (int64_t)r * kLanes)), tab, nq);
}

template <class C, int QG>
__device__ __forceinline__ void member_scores(const Walker& w, const Item& it, int m,
                                              const Table<unsigned char>& tab, int nq,
                                              float (&sc)[QG]) {
  const int32_t* src = w.rows_of(it, m);
  typename C::Acc acc[QG];
  if (w.k.mode != kWide) {
    rows_sums<C, QG>(src, w.k.width, tab, nq, acc);
#pragma unroll
    for (int dq = 0; dq < QG; ++dq) sc[dq] = C::finish(acc[dq]);
    return;
  }
#pragma unroll
  for (int dq = 0; dq < QG; ++dq) sc[dq] = 0.0f;
  for (int blk = 0; blk < w.k.bps; ++blk) {
    const int rows = min(w.block_sublanes, w.k.width - blk * w.block_sublanes);
    rows_sums<C, QG>(src + (int64_t)blk * w.block_sublanes * kLanes, rows, tab, nq, acc);
#pragma unroll
    for (int dq = 0; dq < QG; ++dq) sc[dq] = __fadd_rn(sc[dq], C::finish(acc[dq]));
  }
}

template <class C, int K, int QG, bool TIE_SAFE>
__global__ void __launch_bounds__(kLanes)
old_kernel(const int32_t* __restrict__ words, const void* __restrict__ tables,
           const int32_t* __restrict__ nreal, const int32_t* __restrict__ plan, int num_buckets,
           int block_sublanes, int table_rows, int shift, int num_queries, int subgroup,
           int num_subgroups, int part_rows, int part_slices, float* __restrict__ out_v,
           int32_t* __restrict__ out_t) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x;
  const int sg = blockIdx.x % num_subgroups;
  const int slot = blockIdx.x / num_subgroups;
  const int num_slots = gridDim.x / num_subgroups;
  const int q0 = sg * subgroup;
  const int nq = min(subgroup, num_queries - q0);
  const auto tab = C::template load<QG>(smem, tables, q0, nq, table_rows, shift, lane);
  __syncthreads();
  float tv[QG][K];
  int32_t tt[QG][K];
#pragma unroll
  for (int dq = 0; dq < QG; ++dq) octet::topk_init<K, TIE_SAFE>(tv[dq], tt[dq]);
  const Partition part = partition(words, nreal, num_buckets, part_rows, part_slices);
  Walker w(part.words, plan, part.nreal, num_buckets, block_sublanes, 1, lane);
  Item it;
  for (int g = slot; w.locate(g, it); g += num_slots) {
    for (int m = 0; m < it.count; ++m) {
      if (!w.real(it, m)) continue;
      float sc[QG];
      member_scores<C, QG>(w, it, m, tab, nq, sc);
      const int tag = part.tag_offset + w.tag(it, m);
#pragma unroll
      for (int dq = 0; dq < QG; ++dq) {
        if (dq >= nq) break;
        octet::topk_update<K, TIE_SAFE>(tv[dq], tt[dq], sc[dq], tag);
      }
    }
  }
#pragma unroll
  for (int dq = 0; dq < QG; ++dq) {
    if (dq >= nq) break;
    const int64_t out0 =
        (((int64_t)(q0 + dq) * gridDim.y + blockIdx.y) * num_slots + slot) * K * kLanes + lane;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      out_v[out0 + s * kLanes] = tv[dq][s];
      out_t[out0 + s * kLanes] = tt[dq][s];
    }
  }
}

}  // namespace k8old

extern "C" int slice_topk_batch_old(const int32_t* words, const void* tables,
                                    const int32_t* nreal, const int32_t* plan, int num_buckets,
                                    int block_sublanes, int table_rows, int codec, int tie_safe,
                                    int num_queries, int num_cuda_blocks, int num_partitions,
                                    int part_rows, int part_slices, float* out_v, int32_t* out_t,
                                    void* stream) {
  const int subgroup = 4;
  const int num_subgroups = (num_queries + subgroup - 1) / subgroup;
  if (num_cuda_blocks % num_subgroups) return cudaErrorInvalidValue;
  const cudaError_t err = codec::dispatch(codec, [&](auto tag) {
    using B = typename codec::BatchOf<typename decltype(tag)::type>::type;
    auto kernel = tie_safe ? k8old::old_kernel<B, 8, 4, true> : k8old::old_kernel<B, 8, 4, false>;
    const size_t smem = B::smem_bytes(4, table_rows);
    const cudaError_t e = codec::allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<dim3(num_cuda_blocks, num_partitions), slice::kLanes, smem,
             static_cast<cudaStream_t>(stream)>>>(
        words, tables, nreal, plan, num_buckets, block_sublanes, table_rows,
        codec::sign_shift(codec), num_queries, subgroup, num_subgroups, part_rows, part_slices,
        out_v, out_t);
    return cudaSuccess;
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
"""


def _nvcc(d: str, cu: str, so: str, what: str) -> str:
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                          "-I", d, "-I", _build.CSRC_DIR, "-o", so, cu],
                         capture_output=True, text=True, timeout=900)
    if res.returncode:
        raise RuntimeError(f"nvcc {what} failed:\n{res.stderr[-4000:]}")
    return so


def build(name: str) -> str:
    """nvcc a variant (its copies of the kernel's header and of
    batch_sweep.cuh beside the h16 and f32 units) or the old kernel into
    a shared library; its path."""
    d = os.path.join(OUT_DIR, name)
    os.makedirs(d, exist_ok=True)
    cu = os.path.join(d, "unit.cu")
    if name == "old":
        with open(cu, "w") as fh:
            fh.write(OLD_SOURCE)
        return _nvcc(d, cu, os.path.join(d, "k8old.so"), name)
    variant_dir(d, SOURCES, (*_TRIM, *PARTS[name]))
    with open(cu, "w") as fh:
        fh.write("".join(open(u).read() for u in UNITS) + _NO_QUANTIZED)
    return _nvcc(d, cu, os.path.join(d, "k8.so"), name)


def launcher(so: str, eng, tables, cfg, pass_queries=None, merged=True):
    """A launch of a variant on the engine's stream, as ``ops/kernel.py::
    _slice_topk_batch_cuda`` makes it: (call, the pairs it returns)."""
    fn = ctypes.CDLL(so).slice_topk_batch
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dev = eng.words.device
    P, lk, Q = cfg.num_partitions, cfg.lane_k, tables.shape[0]
    rows, _ = K._table_spec(cfg)
    codec, qp, passes, slots = K.k8_launch(dev, cfg, Q, P, pass_queries)
    sets = K._merge_sets(slots)
    lists = Q * P * (slots + sets)
    ws = torch.empty(lists * 2 * lk * LANES, dtype=torch.int32, device=dev)
    tickets = torch.zeros(passes * P * 4 * (1 + sets), dtype=torch.int32,
                          device=dev)
    out_v = torch.empty((Q, P, lk, LANES), dtype=torch.float32, device=dev)
    out_t = torch.empty((Q, P, lk, LANES), dtype=torch.int32, device=dev)
    args = array.array("q", (
        eng.words.data_ptr(), tables.data_ptr(), eng.nreal.data_ptr(),
        eng.plan_rows.data_ptr(), eng.plan_rows.shape[0],
        eng.fused.block_sublanes, rows, K.KERNEL_CODECS.index(codec), lk,
        int(bool(cfg.tie_safe_topk)), Q, qp, slots, P,
        eng.words.shape[0] // P, eng.partition_kw.get("part_slices", 0),
        int(merged), ws.data_ptr(), lists, tickets.data_ptr(),
        tickets.numel(), out_v.data_ptr(), out_t.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream))

    def call():
        _build.check(fn(args.buffer_info()[0]), "slice_topk_batch (variant)")
    return call, (out_v, out_t)


def old_launcher(so: str, eng, tables, cfg, merged=True):
    """A launch of the kernel before, as its wrapper made it (subgroups of
    4 queries; slots from ``batch_grid``; each slot's buffers merged by
    one per-lane ``torch.topk`` unless not ``merged``): (call, a function
    returning the pairs, (Q, P, lane_k, 128) values)."""
    fn = ctypes.CDLL(so).slice_topk_batch_old
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + \
        [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    dev = eng.words.device
    P, lk, Q = cfg.num_partitions, cfg.lane_k, tables.shape[0]
    rows, _ = K._table_spec(cfg)
    codec, fit = K._kernel_codec(dev, cfg.query_codec, rows)
    sms = K._device_info(dev)[0]
    part_rows = eng.words.shape[0] // P
    sub, n_sub, slots = K.batch_grid(Q, min(K.BATCH_SUBGROUP, fit), sms,
                                     part_rows // 8, P)
    if sub != 4:
        raise RuntimeError(f"the old kernel is built for subgroups of 4, "
                           f"not {sub}")
    out_v = torch.empty((Q, P, slots, lk, LANES), dtype=torch.float32,
                        device=dev)
    out_t = torch.empty((Q, P, slots, lk, LANES), dtype=torch.int32,
                        device=dev)
    res = {}

    def call():
        _build.check(fn(
            eng.words.data_ptr(), tables.data_ptr(), eng.nreal.data_ptr(),
            eng.plan_rows.data_ptr(), eng.plan_rows.shape[0],
            eng.fused.block_sublanes, rows, codec,
            int(bool(cfg.tie_safe_topk)), Q, slots * n_sub, P, part_rows,
            eng.partition_kw.get("part_slices", 0), out_v.data_ptr(),
            out_t.data_ptr(), torch.cuda.current_stream(dev).cuda_stream),
            "slice_topk_batch_old")
        if merged:
            res["pair"] = K.merge_lane_topk(out_v, out_t, lk, lead=2)
    return call, lambda: res["pair"]


def _tables(eng, qs):
    return torch.stack([eng._table(q)[0] for q in qs])


def _line(**kw):
    line = dict(lab="k8_ablation", **kw)
    print(json.dumps(line), flush=True)
    return line


def _ablation(names, coo, qs, dev):
    """The variants on the slice h16 and default f32 engines."""
    import spmv_topk_tpu_torch as pt

    builds = [n for n in names if n in PARTS or n == "old"]
    if "kernel" not in builds:
        builds.insert(0, "kernel")
    if "old_sweep" in names and "old" not in builds:
        builds.append("old")
    with ThreadPoolExecutor(len(builds)) as ex:
        libs = dict(zip(builds, ex.map(build, builds)))
    lines = []
    for engine, config in (("slice_h16", SLICE_H16), ("default_f32",
                                                      DEFAULT)):
        cfg = pt.TopKSpMVConfig(**config)
        eng = pt.TopKSpMV(coo, cfg, device=dev)
        tables = _tables(eng, qs)
        safe = dataclasses.replace(cfg, tie_safe_topk=True)
        want, _ = K.slice_topk_batch_plain(
            eng.words, tables, eng.nreal, eng.plan_rows, lane_k=cfg.lane_k,
            tie_safe=True, block_sublanes=eng.fused.block_sublanes,
            codec=cfg.query_codec)
        calls = {}
        for n in names:
            if n == "lanes32":
                if engine == "default_f32":
                    calls[n] = launcher(libs[n], eng, tables, cfg,
                                        pass_queries=8)[0]
            elif n in PARTS:
                calls[n] = launcher(libs[n], eng, tables, cfg)[0]
            elif n.startswith("pass"):
                if int(n[4:]) in PASSES[engine]:   # pass32: h16's only
                    calls[n] = launcher(libs["kernel"], eng, tables, cfg,
                                        pass_queries=int(n[4:]))[0]
            elif n == "unmerged":
                calls[n] = launcher(libs["kernel"], eng, tables, cfg,
                                    merged=False)[0]
            elif n in ("old", "old_sweep"):
                calls[n] = old_launcher(libs["old"], eng, tables, cfg,
                                        merged=n == "old")[0]
        # the variants that compute K8's values, tie-safe
        checks = {"kernel": lambda: launcher(libs["kernel"], eng, tables,
                                             safe)}
        checks.update({n: (lambda n=n: launcher(
            libs["kernel"], eng, tables, safe, pass_queries=int(n[4:])))
            for n in calls if n.startswith("pass")})
        if "lanes32" in calls:
            checks["lanes32"] = lambda: launcher(libs["lanes32"], eng, tables,
                                                 safe, pass_queries=8)
        if "old" in calls:
            checks["old"] = lambda: old_launcher(libs["old"], eng, tables,
                                                 safe)
        for n, make in checks.items():
            call, pair = make()
            call()
            torch.cuda.synchronize()
            got = (pair() if callable(pair) else pair)[0]
            if not torch.equal(got.reshape(want.shape), want):
                raise RuntimeError(f"{engine} {n}: values differ from "
                                   "slice_topk_batch_plain's")
        k3 = stream_ms(eng.words)
        ms = {n: sweep_ms(c) for n, c in calls.items()}
        for n in calls:
            lines.append(_line(engine=engine, variant=n, queries=len(qs),
                               ms=ms[n], share_of_kernel=ms[n] / ms["kernel"],
                               k3_ms=k3, words_bytes=eng.hbm_bytes,
                               device=torch.cuda.get_device_name(dev)))
        del eng
        torch.cuda.empty_cache()
    return lines


def _routes(coo, qs, dev):
    """K8 and K10c through the package's wrapper beside the kernel before
    it, on every route of chip_smoke.py's engines."""
    import spmv_topk_tpu_torch as pt

    old = build("old")
    lines = []
    for route, (config, n) in ROUTES.items():
        cfg = pt.TopKSpMVConfig(**config)
        eng = pt.TopKSpMV(coo, cfg, device=dev)
        tables = _tables(eng, qs[:n])
        bs = eng.fused.block_sublanes
        parts = eng.partition_kw
        safe = dataclasses.replace(cfg, tie_safe_topk=True)
        call, pair = old_launcher(old, eng, tables, safe)
        call()
        got, _ = K.topk_spmv_fused_batch_device(
            eng.words, tables, eng.nreal, eng.plan_rows, cfg=safe,
            block_sublanes=bs, **parts)
        torch.cuda.synchronize()
        if not torch.equal(got.reshape(pair()[0].shape), pair()[0]):
            raise RuntimeError(f"{route}: the kernel's values differ from "
                               "the kernel before's")
        new = lambda: K.topk_spmv_fused_batch_device(  # noqa: E731
            eng.words, tables, eng.nreal, eng.plan_rows, cfg=cfg,
            block_sublanes=bs, **parts)
        before = old_launcher(old, eng, tables, cfg)[0]
        turns = {"old": [], "kernel": []}
        for name in ("old", "kernel", "kernel", "old"):
            turns[name].append(cuda_ms(before if name == "old" else new,
                                       10, warmup=2))
        ms = {k: statistics.median(v) for k, v in turns.items()}
        lines.append(_line(route=route, queries=n,
                           partitions=cfg.num_partitions,
                           codec=cfg.query_codec, kernel_ms=ms["kernel"],
                           old_ms=ms["old"], turns=turns,
                           speedup=ms["old"] / ms["kernel"],
                           words_bytes=eng.hbm_bytes,
                           device=torch.cuda.get_device_name(dev)))
        del eng
        torch.cuda.empty_cache()
    return lines


def main(argv=None) -> list:
    from spmv_topk_tpu_torch.formats import (create_query_batch,
                                             create_sparse_matrix)

    known = (*PARTS, "unmerged", "old", "old_sweep", "pass8", "pass16",
             "pass32")
    names = list(argv if argv is not None else sys.argv[1:])
    routes = names == ["routes"]
    if not routes:
        names = names or list(known)
        unknown = [n for n in names if n not in known]
        if unknown:
            raise SystemExit(f"unknown variant(s) {unknown}: {list(known)} "
                             "or routes")
        if "kernel" not in names:
            names.insert(0, "kernel")
    if not torch.cuda.is_available():
        raise SystemExit("k8_ablation times kernels: it needs a card")
    dev = torch.device("cuda")
    print(smi_line(), flush=True)
    coo = create_sparse_matrix(ROWS, 1024, 20, "gamma", seed=1)
    qs = create_query_batch(GROUP, 1024, seed=3)
    if routes:
        return _routes(coo, qs, dev)
    return _ablation(names, coo, qs, dev)


if __name__ == "__main__":
    main()
