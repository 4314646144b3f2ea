"""Where K9's time goes on the card, K4 beside it, and where ``scores()``
spends its time.

K9 (``csrc/slice_scores.cu``) against copies of it with a part changed
or taken out, and against the kernel it replaced, timed on the 10M x 1024
corpus in bench.py's slice h16 engine and in the default f32 engine, one
query, the launch as the wrapper makes it (slice order into a (slices,
128) output unless named):

  kernel         the kernel as it is;
  rows           the kernel storing to row order (the launch scores()
                 makes, into a zero fill made once);
  no_loads       each 16-byte word made from its address instead of read
                 from device memory (the same work, no stream bytes);
  no_decode      each word added as it is instead of decoded against the
                 query's table;
  no_stores      no score stored (each compared with a value none takes);
  no_load_hint   the words (and row ids) loaded through the read-only
                 path instead of cache-streaming (L2 evict-first);
  rows_no_load_hint, rows_no_store_hint, rows_no_hints
                 row order without the loads' evict-first hint, without
                 the row stores' evict-last one (evict-first instead), or
                 without either;
  rows_plain_store  row order, the row stores without a hint;
  rows1, rows4   load groups of 1 or 4 rows instead of 2;
  warps8         blocks of 8 warps instead of 16;
  old            the kernel before (``OLD_SOURCE``: one CUDA block a
                 slice of 128 lanes, eight blocks an SM, grid-stride over
                 runs of 8 slices, a lane's words of one slice summed in
                 turn, four loads in flight);
  old_no_loads   the same with each word made from its address instead of
                 read from device memory (the same work, no stream bytes);
  old_no_decode  the same with each word added as it is instead of
                 decoded against the query's table;
  old_no_stores  the same with no score stored (each compared with a
                 value none takes);
  k4             K4 (``csrc/octet_scores.cu``, the kernel before in
                 ``OLD_SOURCE``) on the headline octet h16 engine's words
                 (the same corpus), beside K9.

``old`` and the variants of ``EXACT`` compute K9's scores: they must
equal ``slice_scores_plain``'s bit for bit (the run raises otherwise);
the others are timing probes.
Each line: the engine, the variant, its ms (median of 5 runs of 10
launches between CUDA events), its share of the kernel's (or of
``old``'s), and K3's ms on the same words; first the card's name and
power limit.

``routes`` times, in turns with the kernels before (three rounds of old,
kernel, kernel, old), K9 through its wrapper on the slice h16, default f32 and c3 (i8s)
engines and K4 on the headline octet engine with h16 and f32, each in
slice order
(against the kernel before) and in row order (a zero fill and the
launch, against the kernel before and the epilogue the port ran after
it), and ``scores()`` whole against that path with the query table's
pack in front, after requiring each pair bit-equal.

``profile`` splits one ``scores()`` of the headline octet h16, the slice
h16 and the default f32 engines: the whole call on the host clock and
between CUDA events (median of 20), ``torch.profiler``'s device time by
kernel over 5 calls, and the epilogue the port ran after the kernel
before the row-order store (an int64 copy of ``row_ids``, ``torch.where``,
the multiply by the scale, a zero fill, ``scatter_``), each op on its own
between CUDA events (median of 5 runs of 20).

    python -m spmv_topk_tpu_torch.experiments.k9_ablation [variant ...]
    python -m spmv_topk_tpu_torch.experiments.k9_ablation profile
    python -m spmv_topk_tpu_torch.experiments.k9_ablation routes

Env: ``ABL_ROWS`` (default 10,000,000 rows).
"""

from __future__ import annotations

import array
import ctypes
import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from ..ops import _build
from ..ops import kernel as K
from ._common import cuda_ms, smi_line, stream_ms, sweep_ms, variant_dir

OUT_DIR = os.path.join(_build.BUILD_DIR, "k9_ablation")
ROWS = int(os.environ.get("ABL_ROWS", 10_000_000))
SLICE_H16 = dict(k=100, lane_k=8, max_cols=1024, query_codec="h16",
                 fused_layout="slice", width_quantum=2,
                 fused_block_sublanes=1024, fold_tile=8, rescore_pool=400)
DEFAULT = dict(k=100, max_cols=1024)
HEADLINE = dict(k=100, lane_k=8, max_cols=1024, query_codec="h16",
                fused_layout="octet", width_quantum=2,
                fused_block_sublanes=1024, fold_tile=8, rescore_pool=400)
C3 = dict(k=100, max_cols=1024, query_codec="i8s", width_quantum=4)
ENGINES = {"slice_h16": SLICE_H16, "default_f32": DEFAULT}
PROFILED = {"octet_h16": HEADLINE, **ENGINES}
ROUTES = {"slice_h16": SLICE_H16, "default_f32": DEFAULT, "c3_i8s": C3,
          "octet_h16": HEADLINE, "octet_f32": dict(HEADLINE, query_codec="f32")}

_LOAD = "__ldcs(src + (int64_t)(r0 + i) * kRowVecs)"
_ROW_IDS = "__ldcs(reinterpret_cast<const int4*>(a.row_ids) + at)"
_ADDS = """      acc[0] = C::add(acc[0], static_cast<uint32_t>(v[i].x), tab);
      acc[1] = C::add(acc[1], static_cast<uint32_t>(v[i].y), tab);
      acc[2] = C::add(acc[2], static_cast<uint32_t>(v[i].z), tab);
      acc[3] = C::add(acc[3], static_cast<uint32_t>(v[i].w), tab);"""
_STORE = "reinterpret_cast<float4*>(a.out)[at] = make_float4(sc[0], sc[1], sc[2], sc[3]);"
_NO_LOAD_HINT = ((_LOAD, "__ldg(src + (int64_t)(r0 + i) * kRowVecs)"),
                 (_ROW_IDS, "__ldg(reinterpret_cast<const int4*>(a.row_ids) + at)"))
_NO_STORE_HINT = (("const uint64_t keep = octet::evict_last_policy();",
                   "const uint64_t keep = [] { uint64_t p; asm(\"createpolicy.fractional"
                   ".L2::evict_first.b64 %0, 1.0;\" : \"=l\"(p)); return p; }();"),)
_ROW_STORES = "".join(
    f"      if (r.{c} >= 0) octet::store_kept(a.out + r.{c}, __fmul_rn(sc[{k}], a.factor), "
    "keep);\n" for k, c in enumerate("xyzw"))
PARTS = {
    "kernel": (),
    "rows": (),
    "no_loads": ((_LOAD, "[&] { const int32_t w_ = static_cast<int32_t>(reinterpret_cast<"
                  "uintptr_t>(src + (int64_t)(r0 + i) * kRowVecs) >> 4); "
                  "return make_int4(w_, w_ + 1, w_ + 2, w_ + 3); }()"),),
    "no_decode": ((_ADDS, "      acc[0] += v[i].x; acc[1] += v[i].y; acc[2] += v[i].z; "
                   "acc[3] += v[i].w;"),),
    "no_stores": ((_STORE, "if (sc[0] == 1.5e30f) " + _STORE),),
    "no_load_hint": _NO_LOAD_HINT,
    "rows_no_load_hint": _NO_LOAD_HINT,
    "rows_no_store_hint": _NO_STORE_HINT,
    "rows_no_hints": (*_NO_LOAD_HINT, *_NO_STORE_HINT),
    "rows_plain_store": ((_ROW_STORES, "".join(
        f"      if (r.{c} >= 0) a.out[r.{c}] = __fmul_rn(sc[{k}], a.factor);\n"
        for k, c in enumerate("xyzw"))),),
    "rows1": (("constexpr int kRows = 2;", "constexpr int kRows = 1;"),),
    "rows4": (("constexpr int kRows = 2;", "constexpr int kRows = 4;"),),
    "warps8": (("constexpr int kWarps = 16;", "constexpr int kWarps = 8;"),),
}
# the variants that compute K9's scores, and those launched in row order
EXACT = ("kernel", "rows", "no_load_hint", "rows_no_load_hint",
         "rows_no_store_hint", "rows_no_hints", "rows_plain_store", "rows1",
         "rows4", "warps8")
ROW_ORDER = ("rows", "rows_no_load_hint", "rows_no_store_hint",
             "rows_no_hints", "rows_plain_store")

# The kernels before (the parent's csrc/slice_scores.cu, its sums from
# slice_common.cuh, and csrc/octet_scores.cu, whose sweep K4 keeps), every
# codec, entry points slice_scores_old and octet_scores_old with the
# parent's arguments: K9 one CUDA block of 128 threads, one a lane, eight
# blocks an SM, grid-stride over runs of 8 slices and wide slices
# (slice_common.cuh::Walker), each member's words summed in turn by its
# lane (four loads in flight), its 128 scores stored in slice order; K4 one
# octet a block at a time, its 8 member scores stored in slice order.
OLD_SOURCE = r"""
#include "slice_common.cuh"

namespace k9old {

using namespace slice;

template <class C>
__device__ __forceinline__ typename C::Acc old_rows_sum(const int32_t* src, int rows,
                                                        const Table<typename C::Tab>& tab) {
  typename C::Acc acc = 0;
#pragma unroll 4
  for (int r = 0; r < rows; ++r)
    acc = C::add(acc, static_cast<uint32_t>(__ldg(src + (int64_t)r * kLanes)), tab);
  return acc;
}

template <class C>
__device__ __forceinline__ float old_member_score(const Walker& w, const Item& it, int m,
                                                  const Table<typename C::Tab>& tab) {
  const int32_t* src = w.rows_of(it, m);
  if (w.k.mode != kWide) return C::finish(old_rows_sum<C>(src, w.k.width, tab));
  float carry = 0.0f;
  for (int blk = 0; blk < w.k.bps; ++blk) {
    const int rows = min(w.block_sublanes, w.k.width - blk * w.block_sublanes);
    carry = __fadd_rn(carry, C::finish(old_rows_sum<C>(
        src + (int64_t)blk * w.block_sublanes * kLanes, rows, tab)));
  }
  return carry;
}

template <class C>
__global__ void __launch_bounds__(kLanes)
slice_scores_old_kernel(const int32_t* __restrict__ words,
                        const typename C::Tab* __restrict__ table,
                        const int32_t* __restrict__ nreal,
                        const int32_t* __restrict__ plan, int num_buckets,
                        int block_sublanes, int table_rows, int shift, int part_rows,
                        int part_slices, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x;
  const auto tab = codec::stage_table<C, false>(smem, table, table_rows, shift, lane);
  const Partition part = partition(words, nreal, num_buckets, part_rows, part_slices);
  Walker w(part.words, plan, part.nreal, num_buckets, block_sublanes, 1, lane);
  Item it;
  for (int g = blockIdx.x; w.locate(g, it); g += gridDim.x) {
    for (int m = 0; m < it.count; ++m) {
      if (!w.real(it, m)) continue;
      const float sc = old_member_score<C>(w, it, m, tab);
      out[((int64_t)part.tag_offset + w.tag(it, m)) * kLanes + lane] = sc;
    }
  }
}

}  // namespace k9old

namespace k4old {

using namespace octet;

template <class C>
__global__ void __launch_bounds__(kLanes)
octet_scores_old_kernel(const int32_t* __restrict__ words,
                        const typename C::Tab* __restrict__ table,
                        const int32_t* __restrict__ nreal,
                        const int32_t* __restrict__ plan, int num_buckets,
                        int block_sublanes, int table_rows, int shift, int part_rows,
                        int part_slices, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x;
  const auto tab = codec::stage_table<C, true>(smem, table, table_rows, shift, lane);
  const Partition part = partition(words, nreal, num_buckets, part_rows, part_slices);
  const int total = total_octets(plan, num_buckets);
  int b = 0;
  for (int g = blockIdx.x; g < total; g += gridDim.x) {
    const Octet oc = locate(part.words, plan, part.nreal, num_buckets, block_sublanes, g, b, lane);
    if (oc.index >= oc.n_real) continue;
    float sc[kMembers];
    octet_sums<C>(oc, tab, block_sublanes / kMembers, sc);
    const int64_t row0 = part.tag_offset + oc.slice0;
#pragma unroll
    for (int m = 0; m < kMembers; ++m)
      if (oc.index + m * oc.stride < oc.n_real)
        out[(row0 + m * oc.stride) * kLanes + lane] = sc[m];
  }
}

}  // namespace k4old

namespace {

template <template <class> class KERNEL, bool STATIC_H16>
struct Old {
  template <class C>
  static cudaError_t launch(const int32_t* words, const void* table, const int32_t* nreal,
                            const int32_t* plan, int num_buckets, int block_sublanes,
                            int table_rows, int shift, int blocks, int num_partitions,
                            int part_rows, int part_slices, float* out, cudaStream_t stream) {
    auto kernel = KERNEL<C>::fn;
    const size_t smem = codec::table_smem_bytes<C, STATIC_H16>(table_rows);
    const cudaError_t err = codec::allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<dim3(blocks, num_partitions), 128, smem, stream>>>(
        words, static_cast<const typename C::Tab*>(table), nreal, plan, num_buckets,
        block_sublanes, table_rows, shift, part_rows, part_slices, out);
    return cudaSuccess;
  }
};

template <class C>
struct K9Old {
  static constexpr auto fn = k9old::slice_scores_old_kernel<C>;
};
template <class C>
struct K4Old {
  static constexpr auto fn = k4old::octet_scores_old_kernel<C>;
};

template <template <class> class KERNEL, bool STATIC_H16>
int run(const int32_t* words, const void* table, const int32_t* nreal, const int32_t* plan,
        int num_buckets, int block_sublanes, int table_rows, int codec, int blocks,
        int num_partitions, int part_rows, int part_slices, float* out, void* stream) {
  if (num_buckets < 1 || blocks < 1 || num_partitions < 1 ||
      !codec::table_rows_ok(codec, table_rows))
    return cudaErrorInvalidValue;
  const cudaError_t err = codec::dispatch(codec, [&](auto tag) {
    return Old<KERNEL, STATIC_H16>::template launch<typename decltype(tag)::type>(
        words, table, nreal, plan, num_buckets, block_sublanes, table_rows,
        codec::sign_shift(codec), blocks, num_partitions, part_rows, part_slices, out,
        static_cast<cudaStream_t>(stream));
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int slice_scores_old(const int32_t* words, const void* table, const int32_t* nreal,
                     const int32_t* plan, int num_buckets, int block_sublanes, int table_rows,
                     int codec, int blocks, int num_partitions, int part_rows, int part_slices,
                     float* out, void* stream) {
  return run<K9Old, false>(words, table, nreal, plan, num_buckets, block_sublanes, table_rows,
                           codec, blocks, num_partitions, part_rows, part_slices, out, stream);
}

int octet_scores_old(const int32_t* words, const void* table, const int32_t* nreal,
                     const int32_t* plan, int num_buckets, int block_sublanes, int table_rows,
                     int codec, int blocks, int num_partitions, int part_rows, int part_slices,
                     float* out, void* stream) {
  return run<K4Old, true>(words, table, nreal, plan, num_buckets, block_sublanes, table_rows,
                          codec, blocks, num_partitions, part_rows, part_slices, out, stream);
}

}  // extern "C"
"""
_OLD_LOAD = "static_cast<uint32_t>(__ldg(src + (int64_t)r * kLanes))"
_OLD_STORE = "out[((int64_t)part.tag_offset + w.tag(it, m)) * kLanes + lane] = sc;"
OLD_PARTS = {
    "old": (),
    "old_no_loads": ((_OLD_LOAD, "static_cast<uint32_t>(reinterpret_cast<uintptr_t>("
                      "src + (int64_t)r * kLanes) >> 2)"),),
    "old_no_decode": (("acc = C::add(acc, " + _OLD_LOAD + ", tab);",
                       "acc += " + _OLD_LOAD + ";"),),
    "old_no_stores": ((_OLD_STORE, "if (sc == 1.5e30f) " + _OLD_STORE),),
}
_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 2


def _nvcc(d: str, cu: str, so: str, what: str) -> str:
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                          "-I", d, "-I", _build.CSRC_DIR, "-o", so, cu],
                         capture_output=True, text=True, timeout=900)
    if res.returncode:
        raise RuntimeError(f"nvcc {what} failed:\n{res.stderr[-4000:]}")
    return so


def build_old(name: str) -> str:
    """nvcc an ``OLD_PARTS`` variant of the kernels before into a shared
    library; its path."""
    d = os.path.join(OUT_DIR, name)
    os.makedirs(d, exist_ok=True)
    src = OLD_SOURCE
    for old, new in OLD_PARTS[name]:
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: OLD_SOURCE holds {old!r} "
                               f"{src.count(old)} times")
        src = src.replace(old, new)
    cu = os.path.join(d, "unit.cu")
    with open(cu, "w") as fh:
        fh.write(src)
    return _nvcc(d, cu, os.path.join(d, "old.so"), name)


def build(name: str) -> str:
    """nvcc a ``PARTS`` variant of K9 (its copy of slice_scores.cu) into a
    shared library; its path."""
    d = variant_dir(os.path.join(OUT_DIR, name), ("slice_scores.cu",),
                    PARTS[name])
    return _nvcc(d, os.path.join(d, "slice_scores.cu"),
                 os.path.join(d, "k9.so"), name)


def launcher(so: str, eng, table, scale: float = 1.0, rows: bool = False,
             warps: int = K.K9_WARPS):
    """A launch of a K9 variant on the engine's words and the current
    stream, as ``ops/kernel.py::spmv_fused_scores_device`` makes it (its
    grid from the variant's own occupancy entry): (call, its output:
    (slices, 128) slice order, or a zero-filled vector of the engine's
    rows with ``rows``)."""
    lib = ctypes.CDLL(so)
    fn, occ = lib.slice_scores, lib.slice_scores_occupancy
    fn.argtypes = [ctypes.c_void_p]
    occ.argtypes = [ctypes.c_int] * 3
    fn.restype = occ.restype = ctypes.c_int
    dev = eng.words.device
    cfg = eng.config
    P = cfg.num_partitions
    trows, _ = K._table_spec(cfg)
    arg, _ = K._kernel_codec(dev, cfg.query_codec, trows)
    n = eng.row_ids.shape[0]
    with torch.cuda.device(dev):
        per_sm = occ(arg, trows, int(rows))
    if per_sm < 1:
        raise RuntimeError(f"slice_scores_occupancy: {per_sm}")
    blocks = max(1, min(K._device_info(dev)[0] * per_sm // P,
                        -(-(n // P) // warps)))
    if rows:
        out = torch.zeros(eng.num_rows, dtype=torch.float32, device=dev)
        ids = eng.row_ids.data_ptr()
    else:
        out = torch.zeros((n, 128), dtype=torch.float32, device=dev)
        ids = 0
    args = array.array("q", (
        eng.words.data_ptr(), table.data_ptr(), eng.nreal.data_ptr(),
        eng.plan_rows.data_ptr(), eng.plan_rows.shape[0],
        eng.fused.block_sublanes, trows, arg, blocks, P,
        eng.words.shape[0] // P, n // P, out.data_ptr(), ids,
        int(K.np.float32(K.score_factor(scale)).view(K.np.uint32)),
        torch.cuda.current_stream(dev).cuda_stream))

    def call():
        _build.check(fn(args.buffer_info()[0]), "slice_scores (variant)")
    return call, out


def old_launcher(so: str, eng, table, entry: str = "slice_scores_old"):
    """A launch of a kernel before on the engine's words and the current
    stream, as the parent's wrapper made it (``_sweep_blocks``' grid):
    (call, its (slices, 128) slice-order output); the call takes another
    table of the same shape as an argument."""
    fn = getattr(ctypes.CDLL(so), entry)
    fn.argtypes = _ARGS
    fn.restype = ctypes.c_int
    dev = eng.words.device
    cfg = eng.config
    P = cfg.num_partitions
    rows, _ = K._table_spec(cfg)
    arg, _ = K._kernel_codec(dev, cfg.query_codec, rows)
    part_rows = eng.words.shape[0] // P
    nblk = K._sweep_blocks(K._device_info(dev)[0], part_rows, P)
    n = eng.row_ids.shape[0]
    out = torch.zeros((n, 128), dtype=torch.float32, device=dev)

    def call(table=table):
        _build.check(fn(eng.words.data_ptr(), table.data_ptr(),
                        eng.nreal.data_ptr(), eng.plan_rows.data_ptr(),
                        eng.plan_rows.shape[0], eng.fused.block_sublanes,
                        rows, arg, nblk, P, part_rows, n // P,
                        out.data_ptr(),
                        torch.cuda.current_stream(dev).cuda_stream), entry)
    return call, out


def _line(**kw):
    line = dict(lab="k9_ablation", **kw)
    print(json.dumps(line), flush=True)
    return line


def _plain(eng, table):
    cfg = eng.config
    return K.slice_scores_plain(
        eng.words, table, eng.nreal, eng.plan_rows,
        num_slices=eng.row_ids.shape[0],
        block_sublanes=eng.fused.block_sublanes, codec=cfg.query_codec,
        num_partitions=cfg.num_partitions)


def _rows_plain(eng, table, scale):
    cfg = eng.config
    return K.slice_scores_plain(
        eng.words, table, eng.nreal, eng.plan_rows,
        num_slices=eng.row_ids.shape[0],
        block_sublanes=eng.fused.block_sublanes, codec=cfg.query_codec,
        num_partitions=cfg.num_partitions, row_ids=eng.row_ids, scale=scale,
        out=torch.zeros(eng.num_rows, dtype=torch.float32, device=eng.device))


def _ablation(names, coo, q, dev):
    """The variants on both slice engines, K4 beside them."""
    import spmv_topk_tpu_torch as pt

    olds = sorted({n for n in names if n in OLD_PARTS} | {"old"})
    news = [n for n in names if n in PARTS]
    with ThreadPoolExecutor(len(olds) + len(news)) as ex:
        libs = dict(zip(olds + news, ex.map(
            lambda n: build_old(n) if n in OLD_PARTS else build(n),
            olds + news)))
    base = "kernel" if news else "old"
    lines = []
    for engine, config in ENGINES.items():
        eng = pt.TopKSpMV(coo, pt.TopKSpMVConfig(**config), device=dev)
        table, scale = eng._table(q)
        factor = scale * eng._value_scale
        calls = {}
        for n in names:
            if n in OLD_PARTS:
                calls[n] = old_launcher(libs[n], eng, table)
            elif n in PARTS:
                calls[n] = launcher(libs[n], eng, table, factor,
                                    n in ROW_ORDER,
                                    8 if n == "warps8" else K.K9_WARPS)
        want = _plain(eng, table)
        want_rows = _rows_plain(eng, table, factor)
        for n, (call, out) in calls.items():
            if n in EXACT or n == "old":
                call()
                torch.cuda.synchronize()
                ref = want_rows if out.dim() == 1 else want
                if not torch.equal(out.view(torch.int32),
                                   ref.view(torch.int32)):
                    raise RuntimeError(f"{engine} {n}: scores differ from "
                                       "slice_scores_plain's")
        k3 = stream_ms(eng.words)
        ms = {n: sweep_ms(c) for n, (c, _) in calls.items()}
        for n in calls:
            lines.append(_line(engine=engine, variant=n, ms=ms[n],
                               share_of_base=ms[n] / ms[base], base=base,
                               k3_ms=k3, words_bytes=eng.hbm_bytes,
                               device=torch.cuda.get_device_name(dev)))
        del eng
        torch.cuda.empty_cache()
    if "k4" in names:
        eng = pt.TopKSpMV(coo, pt.TopKSpMVConfig(**HEADLINE), device=dev)
        table, _ = eng._table(q)
        call, out = old_launcher(libs["old"], eng, table, "octet_scores_old")
        call()
        want = K.octet_scores_plain(
            eng.words, table, eng.nreal, eng.plan_rows,
            num_slices=eng.row_ids.shape[0],
            block_sublanes=eng.fused.block_sublanes)
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            raise RuntimeError("octet_h16 k4: scores differ from "
                               "octet_scores_plain's")
        lines.append(_line(engine="octet_h16", variant="k4",
                           ms=sweep_ms(call), k3_ms=stream_ms(eng.words),
                           words_bytes=eng.hbm_bytes,
                           device=torch.cuda.get_device_name(dev)))
        del eng
        torch.cuda.empty_cache()
    return lines


def epilogue(eng, sc, factor):
    """The epilogue the port ran after the kernel before the row-order
    store: an int64 copy of row_ids, torch.where sending padding lanes to
    one extra slot, the multiply and scatter_ into a zero fill."""
    rows = eng.row_ids.reshape(-1).long()
    res = torch.zeros(eng.num_rows + 1, dtype=torch.float32,
                      device=eng.device)
    res.scatter_(0, torch.where(rows >= 0, rows, eng.num_rows),
                 sc.reshape(-1) * factor)
    return res[:eng.num_rows]


def _turns(before, after, reps=10, rounds=3):
    """ms of ``before`` and ``after`` between CUDA events in turns, rounds
    of (before, after, after, before): (medians, every turn)."""
    turns = {"old": [], "kernel": []}
    for name in ("old", "kernel", "kernel", "old") * rounds:
        fn = before if name == "old" else after
        turns[name].append(cuda_ms(fn, reps, warmup=2))
    return {k: statistics.median(v) for k, v in turns.items()}, turns


def _routes(coo, q, dev):
    """K9 and K4 through the wrappers beside the kernels before, in turns,
    in both store forms, and scores() whole."""
    import spmv_topk_tpu_torch as pt

    old = build_old("old")
    lines = []
    for engine, config in ROUTES.items():
        eng = pt.TopKSpMV(coo, pt.TopKSpMVConfig(**config), device=dev)
        cfg = eng.config
        octet = cfg.fused_layout == "octet"
        wrapper = (K.spmv_fused_scores_octet_device if octet
                   else K.spmv_fused_scores_device)
        table, scale = eng._table(q)
        factor = scale * eng._value_scale
        args = (eng.words, table, eng.nreal, eng.plan_rows)
        kw = dict(cfg=cfg, block_sublanes=eng.fused.block_sublanes,
                  num_slices=eng.row_ids.shape[0],
                  num_partitions=cfg.num_partitions)
        out = torch.zeros(eng.num_rows, dtype=torch.float32, device=dev)
        call_old, old_out = old_launcher(
            old, eng, table, "octet_scores_old" if octet else
            "slice_scores_old")

        def slice_order():
            return wrapper(*args, **kw)

        def row_order():
            out.zero_()
            return wrapper(*args, **kw, row_ids=eng.row_ids, scale=factor,
                           out=out)

        # the kernel before as its wrapper ran it: a zero fill of the
        # slice-order output, then the launch
        def old_slice(tab=table):
            old_out.zero_()
            call_old(tab)
            return old_out

        def old_rows():
            return epilogue(eng, old_slice(), factor)

        def old_scores():
            tab, sc = eng._table(q)
            return epilogue(eng, old_slice(tab), sc * eng._value_scale)

        new_sc = slice_order()
        old_slice()
        got_rows = row_order().clone()
        torch.cuda.synchronize()
        if not torch.equal(new_sc.view(torch.int32),
                           old_out.view(torch.int32)):
            raise RuntimeError(f"{engine}: slice order differs from the "
                               "kernel before")
        if not torch.equal(got_rows.view(torch.int32),
                           old_rows().view(torch.int32)) or not torch.equal(
                eng.scores(q).view(torch.int32),
                old_scores().view(torch.int32)):
            raise RuntimeError(f"{engine}: row order differs from the "
                               "kernel before and its epilogue")
        kern = "k4" if octet else "k9"
        for route, before, after in (
                (f"{kern}_slice_order", old_slice, slice_order),
                (f"{kern}_row_order", old_rows, row_order),
                ("scores", old_scores, lambda: eng.scores(q))):
            ms, turns = _turns(before, after)
            lines.append(_line(engine=engine, route=route,
                               codec=cfg.query_codec, kernel_ms=ms["kernel"],
                               old_ms=ms["old"], turns=turns,
                               speedup=ms["old"] / ms["kernel"],
                               words_bytes=eng.hbm_bytes,
                               device=torch.cuda.get_device_name(dev)))
        del eng, out
        torch.cuda.empty_cache()
    return lines


def _device_time(avg) -> float:
    """A profiler average's device time, µs (the attribute's name moved
    between torch versions)."""
    for name in ("device_time_total", "cuda_time_total"):
        v = getattr(avg, name, None)
        if v is not None:
            return float(v)
    return 0.0


def _whole_call(eng, q, reps=20):
    """Medians of ``reps`` scores() calls: (host-clock ms to the
    synchronize, ms between CUDA events around the call)."""
    host, device = [], []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        eng.scores(q)
        end.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        device.append(start.elapsed_time(end))
    return statistics.median(host), statistics.median(device)


def _epilogue_ms(eng, q):
    """The scores path as the port ran it before the row-order store, op
    by op between CUDA events: the query table (host clock, to the
    synchronize), the kernel's slice-order launch, then each op of the
    epilogue over every slice row."""
    cfg = eng.config
    t0 = time.perf_counter()
    table, scale = eng._table(q)
    torch.cuda.synchronize()
    table_ms = (time.perf_counter() - t0) * 1e3
    kw = dict(cfg=cfg, block_sublanes=eng.fused.block_sublanes,
              num_slices=eng.row_ids.shape[0],
              num_partitions=cfg.num_partitions)
    args = (eng.words, table, eng.nreal, eng.plan_rows)
    sc = eng._layout.scores(*args, **kw)
    rows = eng.row_ids.reshape(-1).long()
    n = eng.num_rows
    idx = torch.where(rows >= 0, rows, n)
    vals = sc.reshape(-1) * (scale * eng._value_scale)
    res = torch.zeros(n + 1, dtype=torch.float32, device=eng.device)
    ops = {
        "kernel": lambda: eng._layout.scores(*args, **kw),
        "row_ids_int64": lambda: eng.row_ids.reshape(-1).long(),
        "where": lambda: torch.where(rows >= 0, rows, n),
        "scale_multiply": lambda: sc.reshape(-1) * (scale * eng._value_scale),
        "zero_fill": lambda: torch.zeros(n + 1, dtype=torch.float32,
                                         device=eng.device),
        "scatter": lambda: res.scatter_(0, idx, vals),
    }
    out = {f"{k}_ms": sweep_ms(fn, reps=20) for k, fn in ops.items()}
    out["table_host_ms"] = table_ms
    return out


def _profile(coo, q, dev):
    """One scores() of each profiled engine, split."""
    import spmv_topk_tpu_torch as pt
    from torch.profiler import ProfilerActivity, profile

    lines = []
    for engine, config in PROFILED.items():
        eng = pt.TopKSpMV(coo, pt.TopKSpMVConfig(**config), device=dev)
        eng.scores(q)
        torch.cuda.synchronize()
        host, device = _whole_call(eng, q)
        try:   # the CUDA-event split below does not need the profiler
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    eng.scores(q)
                torch.cuda.synchronize()
            by_op = {a.key: _device_time(a) / 5 / 1e3
                     for a in prof.key_averages() if _device_time(a) > 0}
        except Exception as exc:   # noqa: BLE001 - reported, not hidden
            by_op = {"profiler_failed": repr(exc)}
        lines.append(_line(
            engine=engine, variant="profile", rows=eng.num_rows,
            slice_rows=eng.row_ids.numel(), words_bytes=eng.hbm_bytes,
            scores_host_ms_median=host, scores_device_ms_median=device,
            profiler_device_ms_per_call=by_op,
            profiler_device_ms_total=sum(by_op.values()),
            split_before_row_store=_epilogue_ms(eng, q),
            device=torch.cuda.get_device_name(dev)))
        del eng
        torch.cuda.empty_cache()
    return lines


def main(argv=None) -> list:
    from spmv_topk_tpu_torch.formats import (create_query_batch,
                                             create_sparse_matrix)

    known = (*PARTS, *OLD_PARTS, "k4", "profile", "routes")
    names = list(argv if argv is not None else sys.argv[1:]) or [
        n for n in known if n != "routes"]
    unknown = [n for n in names if n not in known]
    if unknown:
        raise SystemExit(f"unknown variant(s) {unknown}: {list(known)}")
    if not torch.cuda.is_available():
        raise SystemExit("k9_ablation times kernels: it needs a card")
    dev = torch.device("cuda")
    print(smi_line(), flush=True)
    coo = create_sparse_matrix(ROWS, 1024, 20, "gamma", seed=1)
    q = create_query_batch(1, 1024, seed=3)[0]
    lines = []
    if any(n in OLD_PARTS or n in PARTS or n == "k4" for n in names):
        lines += _ablation(names, coo, q, dev)
    if "routes" in names:
        lines += _routes(coo, q, dev)
    if "profile" in names:
        lines += _profile(coo, q, dev)
    return lines


if __name__ == "__main__":
    main()
