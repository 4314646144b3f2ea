"""Where K12's time goes on the card, and K12 and K11 beside the kernels
before them.

K12 (``csrc/bucket_topk_batch.cuh``) against copies of it with a part
taken out, and against the kernel it replaced, timed over every bucket of
``pack_sell_buckets`` of the 10M x 1024 corpus on the two bucket paths of
``chip_smoke.py`` (``bucket``: the default config, f32 at quantum 8;
``bucket_h16``: h16 at quantum 8 with the headline's other settings), a
group of 8 queries, one launch a bucket as the wrapper makes it:

  kernel       the kernel as it is (a group of 8: one pass of 8, each
               bucket read once), its lane merge on the card;
  unmerged     the kernel without its lane merge (each slot's buffers
               sorted into the workspace);
  no_loads     each word made from its address instead of read from
               device memory (the same work, no bucket bytes);
  no_harvest   no (lane, query) pair queued (the sums, the run maxima and
               the walk as they are);
  ahead2, ahead4  the loads 2 or 4 batches of 4 rows ahead instead of 3;
  old          the kernel before (``OLD_SOURCE``: a CUDA block of 128
               lanes a subgroup of 4 queries, their sums and buffers in
               registers, slices round-robin over the slots, the bucket
               read once a subgroup), its slots merged by one per-lane
               ``torch.topk`` a bucket, as its wrapper did;
  old_sweep    the kernel before without that merge;
  topk_merge   the kernel's unmerged launch, then the old ``torch.topk``
               merge of its slots (``merge_lane_topk``).

Each variant is built with nvcc beside the package's library
(``build/spmv_topk_tpu_torch/k12_ablation/``, lane_k 8, h16 and f32 only)
and launched as the wrapper launches it. ``kernel`` and ``old`` compute
K12's values: with tie-safe buffers they must equal
``bucket_topk_batch_plain``'s (the run raises otherwise); the others are
timing probes. Each line: the path, the variant, its ms a group over the
buckets (median of 5 runs of 10 groups between CUDA events), its share of
the kernel's, and K3's ms on the same words; first the card's name and
power limit.

``routes`` times instead K12 (a group of 8) and K11 (one query) on both
paths through the package's wrappers beside the kernels before them
(``old`` with its ``torch.topk`` merge, and K11's, ``old_k11``), in turns
(old, kernel, kernel, old), after requiring the two's values equal
(K12 tie-safe; K11 bit for bit).

    python -m spmv_topk_tpu_torch.experiments.k12_ablation [variant ...]
    python -m spmv_topk_tpu_torch.experiments.k12_ablation routes

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

import numpy as np
import torch

from ..config import LANES
from ..ops import _build
from ..ops import kernel as K
from ._common import cuda_ms, smi_line, stream_ms, sweep_ms, variant_dir

# the sources a variant patches: the kernel and the batch sweeps' shared
# pieces
SOURCES = ("bucket_topk_batch.cuh", "batch_sweep.cuh")
UNITS = [os.path.join(_build.CSRC_DIR, u)
         for u in ("bucket_topk_batch.cu", "bucket_topk_batch_f32.cu")]
OUT_DIR = os.path.join(_build.BUILD_DIR, "k12_ablation")
ROWS = int(os.environ.get("ABL_ROWS", 10_000_000))
GROUP = 8
_NO_OTHER_CODECS = """
namespace k12 {
cudaError_t run_int8x4(const Call&) { return cudaErrorInvalidValue; }
cudaError_t run_i8s(const Call&) { return cudaErrorInvalidValue; }
cudaError_t run_i4s(const Call&) { return cudaErrorInvalidValue; }
}  // namespace k12
"""
# every variant: lane_k 8 only
_TRIM = (("    case 4: return c.tie_safe ? run<PC, 4, true>(c) : run<PC, 4, false>(c);\n", ""),
         ("    case 16: return c.tie_safe ? run<PC, 16, true>(c) : run<PC, 16, false>(c);\n",
          ""))
PARTS = {
    "kernel": (),
    "no_loads": (("static_cast<uint32_t>(__ldg(lsrc + (int64_t)row * kLanes))",
                  "static_cast<uint32_t>(reinterpret_cast<uintptr_t>("
                  "lsrc + (int64_t)row * kLanes) >> 2)"),),
    "no_harvest": (("const bool enter = top >= buf_min[q * L + lane];",
                    "const bool enter = top == 1.5e30f;"),),
    # load batches in flight: 2 or 4 instead of 3
    "ahead2": (("  constexpr int A = kBatches<PC>;", "  constexpr int A = 2;"),),
    "ahead4": (("  constexpr int A = kBatches<PC>;", "  constexpr int A = 4;"),),
}
DEFAULT = dict(k=100, max_cols=1024)
BUCKET_H16 = dict(k=100, lane_k=8, max_cols=1024, query_codec="h16",
                  fused_layout="octet", width_quantum=8, fold_tile=8,
                  rescore_pool=400, fused_block_sublanes=1024)
PATHS = {"bucket": DEFAULT, "bucket_h16": BUCKET_H16}

# The kernels before these (the parent's csrc/bucket_topk_batch.cuh with
# its entry point, lane_k 8, subgroups of 4, h16 and f32; and the parent's
# csrc/bucket_scores.cu with the slice sum it had, h16 and f32): K12 a
# CUDA block of 128 threads, one a lane, a subgroup's sums and buffers in
# registers, slices s, s + slots, ... to slot s, each block's buffers to
# out[q][slot]; K11 blocks of 128 threads, eight an SM, slices in turn,
# each row's chunks summed in turn (two loads in flight).
OLD_SOURCE = r"""
#include "bucket_common.cuh"

namespace k12old {

using namespace bucket;

template <class B, int QG>
__device__ __forceinline__ void row_sums(const int32_t* src, int chunks, int r,
                                         const Table<unsigned char>& tab, int nq,
                                         float (&p)[QG]) {
  typename B::Acc acc[QG];
#pragma unroll
  for (int dq = 0; dq < QG; ++dq) acc[dq] = 0;
#pragma unroll 2
  for (int u = 0; u < chunks; ++u) B::template add<QG>(acc, word(src, u * kChunk + r), tab, nq);
#pragma unroll
  for (int dq = 0; dq < QG; ++dq) p[dq] = acc[dq];
}

template <class B, int QG>
__device__ __forceinline__ void slice_scores(const int32_t* src, int chunks,
                                             const Table<unsigned char>& tab, int nq,
                                             float (&sc)[QG]) {
  if constexpr (B::kExact) {
    typename B::Acc acc[QG];
#pragma unroll
    for (int dq = 0; dq < QG; ++dq) acc[dq] = 0;
#pragma unroll 2
    for (int r = 0; r < chunks * kChunk; ++r) B::template add<QG>(acc, word(src, r), tab, nq);
#pragma unroll
    for (int dq = 0; dq < QG; ++dq) sc[dq] = B::finish(acc[dq]);
  } else {
    float c[2][QG];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float a[QG], b[QG], x[QG];
      row_sums<B, QG>(src, chunks, h, tab, nq, a);
      row_sums<B, QG>(src, chunks, h + 4, tab, nq, b);
#pragma unroll
      for (int dq = 0; dq < QG; ++dq) x[dq] = __fadd_rn(a[dq], b[dq]);
      row_sums<B, QG>(src, chunks, h + 2, tab, nq, a);
      row_sums<B, QG>(src, chunks, h + 6, tab, nq, b);
#pragma unroll
      for (int dq = 0; dq < QG; ++dq) c[h][dq] = __fadd_rn(x[dq], __fadd_rn(a[dq], b[dq]));
    }
#pragma unroll
    for (int dq = 0; dq < QG; ++dq) sc[dq] = __fadd_rn(c[0][dq], c[1][dq]);
  }
}

template <class B, int K, int QG>
__global__ void __launch_bounds__(kLanes)
old_kernel(const int32_t* __restrict__ words, const void* __restrict__ tables,
           const int32_t* __restrict__ num_real, int num_slices, int width, int table_rows,
           int shift, bool tie_safe, int slice_base, int num_queries, int subgroup,
           int num_subgroups, float* __restrict__ out_v, int32_t* __restrict__ out_t) {
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
  for (int dq = 0; dq < QG; ++dq) topk_init<K>(tv[dq], tt[dq], tie_safe);
  const int chunks = width / kChunk;
  const int n = real_slices(num_real, num_slices);
  for (int s = slot; s < n; s += num_slots) {
    float sc[QG];
    slice_scores<B, QG>(words + (int64_t)s * width * kLanes + lane, chunks, tab, nq, sc);
#pragma unroll
    for (int dq = 0; dq < QG; ++dq) {
      if (dq >= nq) break;
      topk_update<K>(tv[dq], tt[dq], sc[dq], slice_base + s, tie_safe);
    }
  }
#pragma unroll
  for (int dq = 0; dq < QG; ++dq) {
    if (dq >= nq) break;
    const int64_t out0 = ((int64_t)(q0 + dq) * num_slots + slot) * K * kLanes + lane;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      out_v[out0 + k * kLanes] = tv[dq][k];
      out_t[out0 + k * kLanes] = tt[dq][k];
    }
  }
}

template <class C>
__device__ __forceinline__ float old_slice_score(const int32_t* src, int chunks,
                                                 const Table<typename C::Tab>& tab) {
  if constexpr (C::kExact) {
    typename C::Acc acc = 0;
#pragma unroll 4
    for (int r = 0; r < chunks * kChunk; ++r) acc = C::add(acc, word(src, r), tab);
    return C::finish(acc);
  } else {
    return halving_sum([&](int r) {
      float even = 0.0f, odd = 0.0f;
      int u = 0;
#pragma unroll 2
      for (; u + 1 < chunks; u += 2) {
        even = C::add(even, word(src, u * kChunk + r), tab);
        odd = C::add(odd, word(src, (u + 1) * kChunk + r), tab);
      }
      if (u < chunks) even = C::add(even, word(src, u * kChunk + r), tab);
      return __fadd_rn(even, odd);
    });
  }
}

template <class C>
__global__ void __launch_bounds__(kLanes)
old_scores_kernel(const int32_t* __restrict__ words, const typename C::Tab* __restrict__ table,
                  int num_slices, int width, int table_rows, int shift,
                  float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x;
  const auto tab = codec::stage_table<C, false>(smem, table, table_rows, shift, lane);
  const int chunks = width / kChunk;
  for (int s = blockIdx.x; s < num_slices; s += gridDim.x)
    out[(int64_t)s * kLanes + lane] =
        old_slice_score<C>(words + (int64_t)s * width * kLanes + lane, chunks, tab);
}

}  // namespace k12old

extern "C" int bucket_topk_batch_old(const int32_t* words, const void* tables,
                                     const int32_t* num_real, int num_slices, int width,
                                     int table_rows, int codec, int tie_safe, int slice_base,
                                     int num_queries, int num_cuda_blocks, float* out_v,
                                     int32_t* out_t, void* stream) {
  const int subgroup = 4;
  const int num_subgroups = (num_queries + subgroup - 1) / subgroup;
  if (num_cuda_blocks % num_subgroups) return cudaErrorInvalidValue;
  using namespace codec;
  const cudaError_t err = dispatch<codec_set<kH16, kF32>()>(codec, [&](auto tag) {
    using B = typename BatchOf<typename decltype(tag)::type>::type;
    auto kernel = k12old::old_kernel<B, 8, 4>;
    const size_t smem = B::smem_bytes(4, table_rows);
    const cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<num_cuda_blocks, bucket::kLanes, smem, static_cast<cudaStream_t>(stream)>>>(
        words, tables, num_real, num_slices, width, table_rows, sign_shift(codec),
        tie_safe != 0, slice_base, num_queries, subgroup, num_subgroups, out_v, out_t);
    return cudaSuccess;
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bucket_scores_old(const int32_t* words, const void* table, int num_slices,
                                 int width, int table_rows, int codec, int num_cuda_blocks,
                                 float* out, void* stream) {
  using namespace codec;
  const cudaError_t err = dispatch<codec_set<kH16, kF32>()>(codec, [&](auto tag) {
    using C = typename decltype(tag)::type;
    auto kernel = k12old::old_scores_kernel<C>;
    const size_t smem = table_smem_bytes<C, false>(table_rows);
    const cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<num_cuda_blocks, bucket::kLanes, smem, static_cast<cudaStream_t>(stream)>>>(
        words, static_cast<const typename C::Tab*>(table), num_slices, width, table_rows,
        sign_shift(codec), out);
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
    batch_sweep.cuh beside the h16 and f32 units) or the old kernels into
    a shared library; its path."""
    d = os.path.join(OUT_DIR, name)
    os.makedirs(d, exist_ok=True)
    cu = os.path.join(d, "unit.cu")
    if name == "old":
        with open(cu, "w") as fh:
            fh.write(OLD_SOURCE)
        return _nvcc(d, cu, os.path.join(d, "k12old.so"), name)
    variant_dir(d, SOURCES, (*_TRIM, *PARTS[name]))
    with open(cu, "w") as fh:
        fh.write("".join(open(u).read() for u in UNITS) + _NO_OTHER_CODECS)
    return _nvcc(d, cu, os.path.join(d, "k12.so"), name)


def _fn(so: str, name: str, argtypes):
    fn = getattr(ctypes.CDLL(so), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def launcher(so: str, bks, tables, cfg, codec, merged=True):
    """The launches of a variant over the buckets ``bks`` on the current
    stream, as ``ops/kernel.py::_bucket_topk_batch_cuda`` makes them:
    (call, the last call's pairs, one (Q, lane_k, 128) pair a bucket)."""
    fn = _fn(so, "bucket_topk_batch", [ctypes.c_void_p])
    dev = tables.device
    lk, Q, rows = cfg.lane_k, tables.shape[0], tables.shape[1]
    stream = torch.cuda.current_stream(dev).cuda_stream
    argv, outs = [], []
    for w, nr, geo in bks:
        n = geo["num_blocks"] * geo["slices_per_block"]
        kc, qp, passes, slots = K.k12_launch(dev, codec, Q, lk, rows, n)
        sets = K._merge_sets(slots)
        lists = Q * (slots + sets)
        ws = torch.empty(lists * 2 * lk * LANES, dtype=torch.int32,
                         device=dev)
        tickets = torch.zeros(passes * 4 * (1 + sets), dtype=torch.int32,
                              device=dev)
        out = (torch.empty((Q, lk, LANES), dtype=torch.float32, device=dev),
               torch.empty((Q, lk, LANES), dtype=torch.int32, device=dev))
        argv.append((array.array("q", (
            w.data_ptr(), tables.data_ptr(), nr.data_ptr(), n, geo["width"],
            rows, K.KERNEL_CODECS.index(kc), lk, int(bool(cfg.tie_safe_topk)),
            geo["slice_base"], Q, qp, slots, int(merged), ws.data_ptr(),
            lists, tickets.data_ptr(), tickets.numel(), out[0].data_ptr(),
            out[1].data_ptr(), stream)), ws, tickets))
        outs.append(out)

    def call():
        for args, _, _ in argv:
            _build.check(fn(args.buffer_info()[0]), "bucket_topk_batch (variant)")
    return call, outs


def old_launcher(so: str, bks, tables, cfg, codec, merged=True):
    """The launches of the kernel before over the buckets, as its wrapper
    made them (subgroups of 4 queries; slots from ``batch_grid``; each
    bucket's slots merged by one per-lane ``torch.topk`` unless not
    ``merged``): (call, a function returning one (Q, lane_k, 128) pair a
    bucket)."""
    fn = _fn(so, "bucket_topk_batch_old", [ctypes.c_void_p] * 3 +
             [ctypes.c_int] * 8 + [ctypes.c_void_p] * 3)
    dev = tables.device
    lk, Q, rows = cfg.lane_k, tables.shape[0], tables.shape[1]
    arg, fit = K._kernel_codec(dev, codec, rows)
    sms = K._device_info(dev)[0]
    launches = []
    for w, nr, geo in bks:
        n = geo["num_blocks"] * geo["slices_per_block"]
        sub, n_sub, slots = K.batch_grid(Q, min(K.BATCH_SUBGROUP, fit), sms, n)
        if sub != 4:
            raise RuntimeError(f"the old kernel is built for subgroups of 4, "
                               f"not {sub}")
        out = (torch.empty((Q, slots, lk, LANES), dtype=torch.float32,
                           device=dev),
               torch.empty((Q, slots, lk, LANES), dtype=torch.int32,
                           device=dev))
        launches.append((w, nr, geo, n, slots * n_sub, out))
    res = {}

    def call():
        stream = torch.cuda.current_stream(dev).cuda_stream
        pairs = []
        for w, nr, geo, n, blocks, out in launches:
            _build.check(fn(
                w.data_ptr(), tables.data_ptr(), nr.data_ptr(), n,
                geo["width"], rows, arg, int(bool(cfg.tie_safe_topk)),
                geo["slice_base"], Q, blocks, out[0].data_ptr(),
                out[1].data_ptr(), stream), "bucket_topk_batch_old")
            if merged:
                pairs.append(K.merge_lane_topk(*out, lk, lead=1))
        res["pairs"] = pairs
    return call, lambda: res["pairs"]


def old_k11(so: str, bks, table, codec):
    """The old K11's launches over the buckets (blocks of 128 threads,
    eight an SM): (call, a function returning the last call's scores)."""
    fn = _fn(so, "bucket_scores_old", [ctypes.c_void_p] * 2 +
             [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2)
    dev = table.device
    rows = table.shape[0]
    arg, _ = K._kernel_codec(dev, codec, rows)
    sms = K._device_info(dev)[0]
    res = {}

    def call():
        stream = torch.cuda.current_stream(dev).cuda_stream
        outs = []
        for w, _, geo in bks:
            n = geo["num_blocks"] * geo["slices_per_block"]
            out = torch.empty((n, LANES), dtype=torch.float32, device=dev)
            _build.check(fn(w.data_ptr(), table.data_ptr(), n, geo["width"],
                            rows, arg, max(1, min(sms * 8, n)),
                            out.data_ptr(), stream), "bucket_scores_old")
            outs.append(out)
        res["scores"] = outs
    return call, lambda: res["scores"]


def buckets(coo, config, dev):
    """(config, [(the bucket's words, num_real (1, 1), geometry keywords
    with slice_base)], all the words) of ``pack_sell_buckets`` on the
    card."""
    import spmv_topk_tpu_torch as pt
    from spmv_topk_tpu_torch.formats.sell_buckets import pack_sell_buckets

    cfg = pt.TopKSpMVConfig(**config)
    m = pack_sell_buckets(coo, cfg)
    words = torch.from_numpy(np.concatenate([b.words for b in m.buckets])).to(
        dev)
    bks, r0 = [], 0
    for b in m.buckets:
        n = b.words.shape[0]
        bks.append((words[r0:r0 + n],
                    torch.tensor([[b.num_slices]], dtype=torch.int32,
                                 device=dev),
                    dict(width=b.width,
                         slices_per_block=b.block_sublanes // b.width,
                         num_blocks=b.num_blocks, slice_base=b.slice_base)))
        r0 += n
    return cfg, bks, words


def _tables(qs, codec, dev):
    from spmv_topk_tpu_torch.ops.quantized_query import pack_query_tables

    return torch.from_numpy(pack_query_tables(qs, codec)[0]).to(dev)


def _plain_values(bks, tables, cfg, codec):
    """``bucket_topk_batch_plain``'s tie-safe values, one a bucket."""
    return [K.bucket_topk_batch_plain(
        w, tables, nr, lane_k=cfg.lane_k, tie_safe=True, codec=codec,
        **geo)[0] for w, nr, geo in bks]


def _require_values(what, got, want):
    for g, w in zip(got, want):
        if not torch.equal(g, w):
            raise RuntimeError(f"{what}: values differ from "
                               "bucket_topk_batch_plain's")


def _line(**kw):
    line = dict(lab="k12_ablation", **kw)
    print(json.dumps(line), flush=True)
    return line


def _ablation(names, coo, qs, dev):
    """The variants on both bucket paths."""
    builds = [n for n in names if n in PARTS]
    if "kernel" not in builds:
        builds.insert(0, "kernel")
    if {"old", "old_sweep"} & set(names):
        builds.append("old")
    with ThreadPoolExecutor(len(builds)) as ex:
        libs = dict(zip(builds, ex.map(build, builds)))
    lines = []
    for path, config in PATHS.items():
        cfg, bks, words = buckets(coo, config, dev)
        codec = cfg.query_codec
        tables = _tables(qs, codec, dev)
        safe = dataclasses.replace(cfg, tie_safe_topk=True)
        want = _plain_values(bks, tables, cfg, codec)
        call, outs = launcher(libs["kernel"], bks, tables, safe, codec)
        call()
        torch.cuda.synchronize()
        _require_values(f"{path} kernel", [v for v, _ in outs], want)
        if "old" in libs:
            call, pairs = old_launcher(libs["old"], bks, tables, safe, codec)
            call()
            torch.cuda.synchronize()
            _require_values(f"{path} old", [v for v, _ in pairs()], want)
        calls = {}
        for n in names:
            if n in PARTS:
                calls[n] = launcher(libs[n], bks, tables, cfg, codec)[0]
            elif n == "unmerged":
                calls[n] = launcher(libs["kernel"], bks, tables, cfg, codec,
                                    merged=False)[0]
            elif n == "topk_merge":
                calls[n] = _topk_merged(bks, tables, cfg, codec)
            elif n in ("old", "old_sweep"):
                calls[n] = old_launcher(libs["old"], bks, tables, cfg, codec,
                                        merged=n == "old")[0]
        k3 = stream_ms(words)
        ms = {n: sweep_ms(c) for n, c in calls.items()}
        for n in calls:
            lines.append(_line(path=path, variant=n, queries=len(qs),
                               buckets=len(bks), ms=ms[n],
                               share_of_kernel=ms[n] / ms["kernel"],
                               k3_ms=k3, words_bytes=words.numel() * 4,
                               device=torch.cuda.get_device_name(dev)))
        del words, bks
        torch.cuda.empty_cache()
    return lines


def _topk_merged(bks, tables, cfg, codec):
    """The package's unmerged launches, each bucket's slots then merged by
    one per-lane ``torch.topk`` (the merge the kernel before ran)."""
    kw = dict(lane_k=cfg.lane_k, tie_safe=bool(cfg.tie_safe_topk),
              codec=codec, unmerged=True)

    def call():
        for w, nr, geo in bks:
            v, t = K._bucket_topk_batch_cuda(w, tables, nr, **kw, **geo)
            K.merge_lane_topk(v, t, cfg.lane_k, lead=1)
    return call


def _routes(coo, qs, dev):
    """K12 and K11 through the package's wrappers beside the kernels
    before them, on both bucket paths, in turns."""
    old = build("old")
    lines = []
    for path, config in PATHS.items():
        cfg, bks, words = buckets(coo, config, dev)
        codec = cfg.query_codec
        tables = _tables(qs, codec, dev)
        table = tables[0]
        safe = dataclasses.replace(cfg, tie_safe_topk=True)

        def k12(c=cfg):
            return [K.topk_spmv_bucket_batch_device(
                w, tables, nr, cfg=c, codec=codec, **geo)
                for w, nr, geo in bks]

        def k11():
            return [K.spmv_bucket_scores_device(
                w, table, cfg=cfg, codec=codec,
                **{k: v for k, v in geo.items() if k != "slice_base"})
                for w, _, geo in bks]

        call, pairs = old_launcher(old, bks, tables, safe, codec)
        call()
        got = k12(safe)
        torch.cuda.synchronize()
        _require_values(f"{path} K12 against the kernel before",
                        [v for v, _ in got], [v for v, _ in pairs()])
        old11, scores = old_k11(old, bks, table, codec)
        old11()
        new = k11()
        torch.cuda.synchronize()
        for a, b in zip(new, scores()):
            if not torch.equal(a, b):
                raise RuntimeError(f"{path}: K11 differs from the kernel "
                                   "before")
        before = {"k12": old_launcher(old, bks, tables, cfg, codec)[0],
                  "k11": old11}
        after = {"k12": k12, "k11": k11}
        for kern in ("k12", "k11"):
            turns = {"old": [], "kernel": []}
            for name in ("old", "kernel", "kernel", "old"):
                fn = before[kern] if name == "old" else after[kern]
                turns[name].append(cuda_ms(fn, 10, warmup=2))
            ms = {k: statistics.median(v) for k, v in turns.items()}
            lines.append(_line(route=f"{path}_{kern}", codec=codec,
                               queries=len(qs) if kern == "k12" else 1,
                               buckets=len(bks), kernel_ms=ms["kernel"],
                               old_ms=ms["old"], turns=turns,
                               speedup=ms["old"] / ms["kernel"],
                               words_bytes=words.numel() * 4,
                               device=torch.cuda.get_device_name(dev)))
        del words, bks
        torch.cuda.empty_cache()
    return lines


def main(argv=None) -> list:
    from spmv_topk_tpu_torch.formats import (create_query_batch,
                                             create_sparse_matrix)

    known = (*PARTS, "unmerged", "topk_merge", "old", "old_sweep")
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
        raise SystemExit("k12_ablation times kernels: it needs a card")
    dev = torch.device("cuda")
    print(smi_line(), flush=True)
    coo = create_sparse_matrix(ROWS, 1024, 20, "gamma", seed=1)
    qs = create_query_batch(GROUP, 1024, seed=3)
    if routes:
        return _routes(coo, qs, dev)
    return _ablation(names, coo, qs, dev)


if __name__ == "__main__":
    main()
