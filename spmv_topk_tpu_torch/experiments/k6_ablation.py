"""Where K6's time goes on the card, and K6 beside the kernel before it.

The kernel for the codecs but h16 (``csrc/octet_topk_batch.cuh``) against
copies of it with a part changed or taken out, and against the kernel it
replaced, timed on the 10M x 1024 corpus in the octet engines of
``chip_smoke.py`` (the headline config with the f32, int8x4, i8s and i4s
codecs), a group of 32 queries (``ABL_GROUP``), the lane merge included
(the launch as the wrapper makes it):

  kernel       the kernel as it is, in its passes (two of 16; one of 8
               for a group of 8);
  pass<N>      the kernel in passes of N queries (f32 8, 16; the others
               8, 16, 32): the stream read 32 / N times (the package
               builds no Bf16Pass of 32: ``pass32`` is a build of its
               own, its units given the instantiations, in blocks of 32
               lanes at lane_k 8 for the buffers' room);
  unmerged     the kernel without its lane merge (each slot's buffers
               sorted into the workspace);
  no_loads     each word made from its address instead of read from
               device memory (the same work, no stream bytes);
  no_harvest   no (lane, query) pair queued (the sums, the octet maxima
               and the walk as they are);
  no_decode    no_harvest with each batch's words added into one sum
               instead of decoded against the pass's tables (no gathers,
               no products);
  old          the kernel before (``OLD_SOURCE``: a CUDA block of 128
               lanes a subgroup of 4 queries, their sums and buffers in
               registers, one 4-byte gather a query a word, the stream
               read once a subgroup), its slots merged by one per-lane
               ``torch.topk``, as its wrapper did;
  old_sweep    the kernel before without that merge.

Each variant is built with nvcc beside the package's library
(``build/spmv_topk_tpu_torch/k6_ablation/``, lane_k 8 and fold 8 only)
and launched as the wrapper launches it. ``kernel``, ``pass<N>`` and
``old`` compute K6's values: with tie-safe buffers they must equal
``octet_topk_batch_plain``'s (the run raises otherwise); the others are
timing probes. Each line: the engine, the variant, its ms a group
(median of 5 runs of 10 launches between CUDA events), its share of the
kernel's, and K3's ms on the same words; first the card's name and power
limit.

``routes`` times instead every route ``chip_smoke.py``'s engines launch
K6 and K10d on for these codecs (each codec a group of 32; f32 and i4s on
2 partitions, K10d), each codec in a group of 8 (``query_batch``'s
default), and int8x4 at 32,768 columns (its tables read from global
memory, ``int8x4_global``; a group of 32 and of 8) through the package's
wrapper beside the kernel before it (``old``), in turns (old, kernel,
kernel, old), after requiring the two's tie-safe values equal.

    python -m spmv_topk_tpu_torch.experiments.k6_ablation [variant ...]
    python -m spmv_topk_tpu_torch.experiments.k6_ablation routes

Env: ``ABL_ROWS`` (default 10,000,000 rows), ``ABL_GROUP`` (the
variants' queries, default 32).
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

# the sources a variant patches: the kernel, the batch sweeps' shared
# pieces and the kernel's units (built as one)
UNITS = tuple(f"octet_topk_batch{u}.cu"
              for u in ("", "_f32", "_f32g", "_int8x4", "_i8s", "_i4s"))
SOURCES = ("octet_topk_batch.cuh", "batch_sweep.cuh", *UNITS)
OUT_DIR = os.path.join(_build.BUILD_DIR, "k6_ablation")
ROWS = int(os.environ.get("ABL_ROWS", 10_000_000))
GROUP = int(os.environ.get("ABL_GROUP", 32))
_NO_HARVEST = ("enqueue(static_cast<float>(top) >= buf_min[q * L + lane],",
               "enqueue(false,")
# every variant: lane_k 8 and fold 8 (not EXACT) only
_TRIM = (("    case 4: return run_flags<PC, 4>(c);\n", ""),
         ("    case 16: return run_flags<PC, 16>(c);\n", ""),
         ("  if (c.tie_safe && c.exact) return run<PC, K, true, true>(c);\n",
          "  if (c.exact) return cudaErrorInvalidValue;\n"),
         ("  if (c.exact) return run<PC, K, false, true>(c);\n", ""))
PARTS = {
    "kernel": (),
    "no_loads": (("static_cast<uint32_t>(__ldg(lsrc + (lpos + i) * kStep))",
                  "static_cast<uint32_t>(reinterpret_cast<uintptr_t>("
                  "lsrc + (lpos + i) * kStep) >> 2)"),),
    "no_harvest": (_NO_HARVEST,),
    # its sums garbage, so that no harvest fills its queue: beside
    # no_harvest
    "no_decode": (("PC::add(acc, w[0], end - pos, view);",
                   "reinterpret_cast<uint32_t&>(acc) += "
                   "w[0][0] + w[0][1] + w[0][2] + w[0][3];"), _NO_HARVEST),
    # the quantized codecs' passes of 32, one stream read a group of 32
    "pass32": tuple(
        (f"    case 16: return run_k<Bf16Pass<{c}, 16, {f}>>(c);\n",
         f"    case 16: return run_k<Bf16Pass<{c}, 16, {f}>>(c);\n"
         f"    case 32: return run_k<Bf16Pass<{c}, 32, {f}>>(c);\n")
        for c, f in (("Int8x4", 4), ("Sign", 4), ("Sign", 8))),
}
HEADLINE = dict(k=100, lane_k=8, max_cols=1024, query_codec="h16",
                fused_layout="octet", width_quantum=2,
                fused_block_sublanes=1024, fold_tile=8, rescore_pool=400)
CODECS = ("f32", "int8x4", "i8s", "i4s")
# chip_smoke.py's routes of K6 and K10d for these codecs: (config, queries)
ROUTES = {**{f"k6_{c}": (dict(HEADLINE, query_codec=c), 32)
             for c in CODECS},
          "k10d_f32": (dict(HEADLINE, query_codec="f32", num_partitions=2),
                       32),
          "k10d_i4s": (dict(HEADLINE, query_codec="i4s", num_partitions=2),
                       32),
          **{f"k6_{c}_g8": (dict(HEADLINE, query_codec=c), 8)
             for c in CODECS},
          "k6_int8x4_32k": (dict(HEADLINE, query_codec="int8x4",
                                 max_cols=32768), 32),
          "k6_int8x4_32k_g8": (dict(HEADLINE, query_codec="int8x4",
                                    max_cols=32768), 8)}

# The kernel before this one (the parent's csrc/octet_topk_batch.cuh and
# its entry point, lane_k 8, fold 8 and subgroups of 4 only): a CUDA block
# of 128 threads, one a lane, a subgroup's sums and buffers in registers;
# octets g, g + slots, ... to slot g; each block's buffers to
# out[q][slot].
OLD_SOURCE = r"""
#include "octet_common.cuh"

namespace octet {

// The same for each query of a batch subgroup (batch codec B, K6's order,
// _fused_kernel_batch_octet): h16 in int32 as above; the float codecs add
// each block span's chunks into one accumulator per query from 0, in chunk
// order, and a wide octet its span sums in block order.
template <class B, int QG>
__device__ __forceinline__ void octet_sums_batch(const Octet& oc,
                                                 const codec::Table<unsigned char>& t, int nq,
                                                 int chunks_per_block,
                                                 float (&sc)[kMembers][QG]) {
  if constexpr (B::kExact) {
    // one loop over the W chunks, as K1's h16 sums (with the block spans'
    // loop nest around it, nvcc scheduled QG = 2 with half the loads in
    // flight, and the sweep took twice as long)
    typename B::Acc acc[kMembers][QG];
#pragma unroll
    for (int m = 0; m < kMembers; ++m)
#pragma unroll
      for (int dq = 0; dq < QG; ++dq) acc[m][dq] = 0;
#pragma unroll 2
    for (int j = 0; j < oc.width; ++j) {
      const int32_t* row = oc.src + (int64_t)j * kMembers * kLanes;
#pragma unroll
      for (int m = 0; m < kMembers; ++m)
        B::template add<QG>(acc[m], static_cast<uint32_t>(__ldg(row + m * kLanes)), t, nq);
    }
#pragma unroll
    for (int m = 0; m < kMembers; ++m)
#pragma unroll
      for (int dq = 0; dq < QG; ++dq) sc[m][dq] = B::finish(acc[m][dq]);
  } else {
    const bool wide = oc.width > chunks_per_block;
#pragma unroll
    for (int m = 0; m < kMembers; ++m)
#pragma unroll
      for (int dq = 0; dq < QG; ++dq) sc[m][dq] = 0.0f;
    for (int j0 = 0; j0 < oc.width; j0 += chunks_per_block) {
      const int j1 = min(oc.width, j0 + chunks_per_block);
      float acc[kMembers][QG];
#pragma unroll
      for (int m = 0; m < kMembers; ++m)
#pragma unroll
        for (int dq = 0; dq < QG; ++dq) acc[m][dq] = 0.0f;
#pragma unroll 2
      for (int j = j0; j < j1; ++j) {
        const int32_t* row = oc.src + (int64_t)j * kMembers * kLanes;
#pragma unroll
        for (int m = 0; m < kMembers; ++m)
          B::template add<QG>(acc[m], static_cast<uint32_t>(__ldg(row + m * kLanes)), t, nq);
      }
#pragma unroll
      for (int m = 0; m < kMembers; ++m)
#pragma unroll
        for (int dq = 0; dq < QG; ++dq)
          sc[m][dq] = wide ? __fadd_rn(sc[m][dq], acc[m][dq]) : acc[m][dq];
    }
  }
}

}  // namespace octet

namespace k6old {

using namespace octet;

template <class B, int K, int QG, bool TIE_SAFE>
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
  const auto tab = B::template load<QG>(smem, tables, q0, nq, table_rows, shift, lane);
  __syncthreads();
  float tv[QG][K];
  int32_t tt[QG][K];
#pragma unroll
  for (int dq = 0; dq < QG; ++dq) topk_init<K, TIE_SAFE>(tv[dq], tt[dq]);
  const Partition part = partition(words, nreal, num_buckets, part_rows, part_slices);
  const int total = total_octets(plan, num_buckets);
  int b = 0;
  for (int g = slot; g < total; g += num_slots) {
    const Octet oc = locate(part.words, plan, part.nreal, num_buckets, block_sublanes, g, b, lane);
    if (oc.index >= oc.n_real) continue;
    float scores[kMembers][QG];
    octet_sums_batch<B, QG>(oc, tab, nq, block_sublanes / kMembers, scores);
#pragma unroll
    for (int dq = 0; dq < QG; ++dq) {
      if (dq >= nq) break;
      float sc[kMembers];
#pragma unroll
      for (int m = 0; m < kMembers; ++m)
        sc[m] = (oc.index + m * oc.stride < oc.n_real) ? scores[m][dq] : -INFINITY;
      harvest<K, TIE_SAFE, false>(tv[dq], tt[dq], sc, part.tag_offset + oc.slice0, oc.stride);
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

}  // namespace k6old

extern "C" int octet_topk_batch_old(const int32_t* words, const void* tables,
                                    const int32_t* nreal, const int32_t* plan, int num_buckets,
                                    int block_sublanes, int table_rows, int codec, int tie_safe,
                                    int num_queries, int num_cuda_blocks, int num_partitions,
                                    int part_rows, int part_slices, float* out_v, int32_t* out_t,
                                    void* stream) {
  const int subgroup = 4;
  const int num_subgroups = (num_queries + subgroup - 1) / subgroup;
  if (codec == codec::kH16 || num_cuda_blocks % num_subgroups) return cudaErrorInvalidValue;
  const cudaError_t err = codec::dispatch(codec, [&](auto tag) {
    using B = typename codec::BatchOf<typename decltype(tag)::type>::type;
    auto kernel = tie_safe ? k6old::old_kernel<B, 8, 4, true> : k6old::old_kernel<B, 8, 4, false>;
    const size_t smem = B::smem_bytes(4, table_rows);
    const cudaError_t e = codec::allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<dim3(num_cuda_blocks, num_partitions), octet::kLanes, smem,
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
    batch_sweep.cuh beside the kernel's units) or the old kernel into a
    shared library; its path."""
    d = os.path.join(OUT_DIR, name)
    os.makedirs(d, exist_ok=True)
    cu = os.path.join(d, "unit.cu")
    if name == "old":
        with open(cu, "w") as fh:
            fh.write(OLD_SOURCE)
        return _nvcc(d, cu, os.path.join(d, "k6old.so"), name)
    variant_dir(d, SOURCES, (*_TRIM, *PARTS[name]))
    with open(cu, "w") as fh:
        fh.write("".join(open(os.path.join(d, u)).read() for u in UNITS))
    return _nvcc(d, cu, os.path.join(d, "k6.so"), name)


def launcher(so: str, eng, tables, cfg, pass_queries=None, merged=True):
    """A launch of a variant on the engine's stream, as ``ops/kernel.py::
    octet_topk_batch_cuda`` makes it (a pass the package does not take,
    ``pass32``'s, on ``pass_grid``'s slots): (call, the pairs it
    returns)."""
    fn = ctypes.CDLL(so).octet_topk_batch
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dev = eng.words.device
    P, lk, Q = cfg.num_partitions, cfg.lane_k, tables.shape[0]
    rows, _ = K._table_spec(cfg)
    if pass_queries in K.K6_PASS_QUERIES[cfg.query_codec] + (None,):
        codec, qp, passes, slots = K.k6_launch(dev, cfg, Q, P, pass_queries)
    else:
        codec, qp = cfg.query_codec, pass_queries
        passes, slots = K.pass_grid(Q, K._device_info(dev)[0], qp, lk,
                                    codec, P)
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
        int(cfg.fold_tile == 1), int(bool(cfg.tie_safe_topk)), Q, qp, slots,
        P, eng.words.shape[0] // P, eng.partition_kw.get("part_slices", 0),
        int(merged), ws.data_ptr(), lists, tickets.data_ptr(),
        tickets.numel(), out_v.data_ptr(), out_t.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream))

    def call():
        _build.check(fn(args.buffer_info()[0]), "octet_topk_batch (variant)")
    return call, (out_v, out_t)


def old_launcher(so: str, eng, tables, cfg, merged=True):
    """A launch of the kernel before, as its wrapper made it (subgroups of
    4 queries; slots from ``batch_grid``; each slot's buffers merged by
    one per-lane ``torch.topk`` unless not ``merged``): (call, a function
    returning the pairs, (Q, P, lane_k, 128) values)."""
    fn = ctypes.CDLL(so).octet_topk_batch_old
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
            "octet_topk_batch_old")
        if merged:
            res["pair"] = K.merge_lane_topk(out_v, out_t, lk, lead=2)
    return call, lambda: res["pair"]


def _tables(eng, qs):
    return torch.stack([eng._table(q)[0] for q in qs])


def _line(**kw):
    line = dict(lab="k6_ablation", **kw)
    print(json.dumps(line), flush=True)
    return line


def _passes(codec):
    """The passes a codec's ``pass<N>`` variants take: f32 8 and 16, the
    others 8, 16 and (``pass32``'s build) 32."""
    return (8, 16) if codec == "f32" else (8, 16, 32)


def _ablation(names, coo, qs, dev):
    """The variants on the octet engines of each codec but h16."""
    import spmv_topk_tpu_torch as pt

    builds = [n for n in names if n in PARTS or n == "old"]
    if "kernel" not in builds:
        builds.insert(0, "kernel")
    if "old_sweep" in names and "old" not in builds:
        builds.append("old")
    with ThreadPoolExecutor(len(builds)) as ex:
        libs = dict(zip(builds, ex.map(build, builds)))
    lines = []
    for codec in CODECS:
        cfg = pt.TopKSpMVConfig(**dict(HEADLINE, query_codec=codec))
        eng = pt.TopKSpMV(coo, cfg, device=dev)
        tables = _tables(eng, qs)
        safe = dataclasses.replace(cfg, tie_safe_topk=True)
        want, _ = K.octet_topk_batch_plain(
            eng.words, tables, eng.nreal, eng.plan_rows, lane_k=cfg.lane_k,
            fold_tile=cfg.fold_tile, tie_safe=True,
            block_sublanes=eng.fused.block_sublanes, codec=codec)
        calls = {}
        for n in names:
            if n.startswith("pass"):
                if int(n[4:]) in _passes(codec):
                    calls[n] = launcher(libs.get(n, libs["kernel"]), eng,
                                        tables, cfg,
                                        pass_queries=int(n[4:]))[0]
            elif n in PARTS:
                calls[n] = launcher(libs[n], eng, tables, cfg)[0]
            elif n == "unmerged":
                calls[n] = launcher(libs["kernel"], eng, tables, cfg,
                                    merged=False)[0]
            elif n in ("old", "old_sweep"):
                calls[n] = old_launcher(libs["old"], eng, tables, cfg,
                                        merged=n == "old")[0]
        # the variants that compute K6's values, tie-safe
        checks = {"kernel": lambda: launcher(libs["kernel"], eng, tables,
                                             safe)}
        checks.update({n: (lambda n=n: launcher(
            libs.get(n, libs["kernel"]), eng, tables, safe,
            pass_queries=int(n[4:]))) for n in calls if n.startswith("pass")})
        if "old" in calls:
            checks["old"] = lambda: old_launcher(libs["old"], eng, tables,
                                                 safe)
        for n, make in checks.items():
            call, pair = make()
            call()
            torch.cuda.synchronize()
            got = (pair() if callable(pair) else pair)[0]
            if not torch.equal(got.reshape(want.shape), want):
                raise RuntimeError(f"{codec} {n}: values differ from "
                                   "octet_topk_batch_plain's")
        k3 = stream_ms(eng.words)
        ms = {n: sweep_ms(c) for n, c in calls.items()}
        for n in calls:
            lines.append(_line(engine=f"octet_{codec}", variant=n,
                               queries=len(qs), ms=ms[n],
                               share_of_kernel=ms[n] / ms["kernel"],
                               k3_ms=k3, words_bytes=eng.hbm_bytes,
                               device=torch.cuda.get_device_name(dev)))
        del eng
        torch.cuda.empty_cache()
    return lines


def _routes(coo, qs, dev):
    """K6 and K10d through the package's wrapper beside the kernel before
    it, on every route of chip_smoke.py's engines for these codecs."""
    import spmv_topk_tpu_torch as pt

    from spmv_topk_tpu_torch.formats import (create_query_batch,
                                             create_sparse_matrix)

    old = build("old")
    lines = []
    corpora = {1024: (coo, qs)}
    for route, (config, n) in ROUTES.items():
        cfg = pt.TopKSpMVConfig(**config)
        cols = cfg.max_cols
        if cols not in corpora:
            corpora[cols] = (create_sparse_matrix(ROWS, cols, 20, "gamma",
                                                  seed=1),
                             create_query_batch(32, cols, seed=3))
        eng = pt.TopKSpMV(corpora[cols][0], cfg, device=dev)
        tables = _tables(eng, corpora[cols][1][:n])
        bs = eng.fused.block_sublanes
        parts = eng.partition_kw
        safe = dataclasses.replace(cfg, tie_safe_topk=True)
        call, pair = old_launcher(old, eng, tables, safe)
        call()
        got, _ = K.topk_spmv_fused_batch_octet_device(
            eng.words, tables, eng.nreal, eng.plan_rows, cfg=safe,
            block_sublanes=bs, **parts)
        torch.cuda.synchronize()
        if not torch.equal(got.reshape(pair()[0].shape), pair()[0]):
            raise RuntimeError(f"{route}: the kernel's values differ from "
                               "the kernel before's")
        new = lambda: K.topk_spmv_fused_batch_octet_device(  # noqa: E731
            eng.words, tables, eng.nreal, eng.plan_rows, cfg=cfg,
            block_sublanes=bs, **parts)
        before = old_launcher(old, eng, tables, cfg)[0]
        turns = {"old": [], "kernel": []}
        for name in ("old", "kernel", "kernel", "old"):
            turns[name].append(cuda_ms(before if name == "old" else new,
                                       10, warmup=2))
        ms = {k: statistics.median(v) for k, v in turns.items()}
        lines.append(_line(route=route, queries=n, columns=cols,
                           partitions=cfg.num_partitions,
                           codec=cfg.query_codec, kernel_ms=ms["kernel"],
                           launch=K.k6_launch(dev, cfg, n,
                                              cfg.num_partitions),
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

    known = (*PARTS, "unmerged", "old", "old_sweep", "pass8", "pass16")
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
        raise SystemExit("k6_ablation times kernels: it needs a card")
    dev = torch.device("cuda")
    print(smi_line(), flush=True)
    coo = create_sparse_matrix(ROWS, 1024, 20, "gamma", seed=1)
    qs = create_query_batch(max(GROUP, 32), 1024, seed=3)
    if routes:
        return _routes(coo, qs, dev)
    return _ablation(names, coo, qs[:GROUP], dev)


if __name__ == "__main__":
    main()
