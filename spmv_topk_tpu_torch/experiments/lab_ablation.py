"""L9 (``csrc/lab_pack16.cu``) and L8 (``csrc/lab_mxu.cu``) beside the
kernels before them and beside copies with one part changed, on the card.

  routes    L9's six cases through ``pack16_lab.pack16_device`` against
            the kernel before (``OLD_PACK16``: a CUDA block of 128 threads
            a copy of the tile, one thread a lane running its lane's
            chains, 512 rounds unrolled), each timed by the lab's slope
            (12 against 2 chained calls behind a hold of the stream,
            ``pack16_lab.slope_ms``) and by its held device time a call
            (``_common.sweep_ms``, 20 calls), in turns (old, new, new,
            old; three rounds), after requiring both bit-equal to
            ``pack16_plain`` on x and x + 3; L8 at 32, 512 and 65536
            chunks of 16 queries: the held device time of
            ``mxu_vpu_device`` (one launch, its merge on the card), of
            the kernel before (``OLD_MXU``: 8 blocks of 128
            threads an SM, grid-stride over the chunks, per-block sums)
            alone and with the torch merge it needed (an int64 sum, the
            wrap, the float conversion), and of an empty kernel launch
            (``EMPTY``, one block: the card's floor for one launch), in
            turns, after requiring the kernels bit-equal to
            ``mxu_vpu_plain``.
  forms     L9's bf16 cases with the pair's multiply and add written as
            PTX ``mul.rn`` / ``add.rn`` instead of the kernel's
            ``fma.rn.bf16x2`` (a * b + -0.0, a * 1.0 + b) (``FORMS``: both,
            or one of them): bit-equal to ``pack16_plain`` on x and x + 3,
            each form's round loop's chain opcodes (``_build.sass_loops``)
            and its slope and held time in turns with the kernel.
  variants  copies of the kernels with one part changed (``VARIANTS``),
            each held bit-equal to its plain version where it computes
            the same function, timed (held) in turns with the kernel: L9
            with every copy writing the one tile, 4 chains a thread for
            f32 and the integers, 8 bf16 pairs, blocks of 8 or 4 warps (2
            or 4 blocks an SM); L8 with two blocks an SM (64 registers a
            thread), batches of 4 rows, no merge (each block stores its
            sums: a timing probe) and no decode (each word added as it is:
            a timing probe), at 32, 512 and 65536 chunks.

Each prints one JSON line per case (and the card's name and power limit
first); the kernels before, the empty kernel and the variants build with
nvcc into ``build/spmv_topk_tpu_torch/lab_ablation/`` (the old L9 unit
takes 23-75 s, its rounds unrolled), each library named by a hash of its
sources and flags and reused by a later run while they stay the same.

    python -m spmv_topk_tpu_torch.experiments.lab_ablation [routes]
        [forms] [variants]
"""

from __future__ import annotations

import ctypes
import glob
import json
import os
import statistics
import subprocess
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import torch

from ..ops import _build
from . import mxu_gather_lab, pack16_lab
from ._common import (CHUNK, cuda_blocks, mxu_lab_data, smi_line,
                      sweep_ms, variant_dir, wrap_int)

OUT_DIR = os.path.join(_build.BUILD_DIR, "lab_ablation")
MODES = ("routes", "forms", "variants")
MXU_CHUNKS = (32, 512, 65536)
MXU_QUERIES = 16

OLD_PACK16 = r"""

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kReps = 512;   // pack16_lab.py REPS

enum Dtype { kF32, kBF16, kI16, kI32, kNumDtypes };   // pack16_lab.py DTYPES

__device__ __forceinline__ uint32_t bf16x2_mul(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t bf16x2_add(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

template <int SUB>
__global__ void __launch_bounds__(kLanes) lab_pack16_f32(const float* __restrict__ x,
                                                         float* __restrict__ out) {
  const int lane = threadIdx.x;
  float xv[SUB], acc[SUB];
#pragma unroll
  for (int r = 0; r < SUB; ++r) acc[r] = xv[r] = x[r * kLanes + lane];
#pragma unroll
  for (int i = 0; i < kReps; ++i) {
#pragma unroll
    for (int r = 0; r < SUB; ++r) acc[r] = __fadd_rn(__fmul_rn(acc[r], xv[r]), xv[r]);
  }
#pragma unroll
  for (int r = 0; r < SUB; ++r) out[r * kLanes + lane] = acc[r];
}

template <int SUB>
__global__ void __launch_bounds__(kLanes) lab_pack16_bf16(const uint16_t* __restrict__ x,
                                                          uint16_t* __restrict__ out) {
  constexpr int P = SUB / 2;
  const int lane = threadIdx.x;
  uint32_t xv[P], acc[P];
#pragma unroll
  for (int p = 0; p < P; ++p)
    acc[p] = xv[p] = static_cast<uint32_t>(x[(2 * p) * kLanes + lane]) |
                     (static_cast<uint32_t>(x[(2 * p + 1) * kLanes + lane]) << 16);
#pragma unroll
  for (int i = 0; i < kReps; ++i) {
#pragma unroll
    for (int p = 0; p < P; ++p) acc[p] = bf16x2_add(bf16x2_mul(acc[p], xv[p]), xv[p]);
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    out[(2 * p) * kLanes + lane] = static_cast<uint16_t>(acc[p]);
    out[(2 * p + 1) * kLanes + lane] = static_cast<uint16_t>(acc[p] >> 16);
  }
}

template <class T, int SUB>
__global__ void __launch_bounds__(kLanes) lab_pack16_int(const T* __restrict__ x,
                                                         T* __restrict__ out) {
  const int lane = threadIdx.x;
  uint32_t xv[SUB], acc[SUB];
#pragma unroll
  for (int r = 0; r < SUB; ++r)
    acc[r] = xv[r] = static_cast<uint32_t>(static_cast<int32_t>(x[r * kLanes + lane]));
#pragma unroll
  for (int i = 0; i < kReps; ++i) {
#pragma unroll
    for (int r = 0; r < SUB; ++r) acc[r] = acc[r] * xv[r] + xv[r];
  }
#pragma unroll
  for (int r = 0; r < SUB; ++r) out[r * kLanes + lane] = static_cast<T>(acc[r]);
}

}  // namespace

extern "C" {

// x: (sub, 128) tile of `dtype` (the enum above; bf16 as its 16-bit
// pattern); out: (sub, 128) of the same type, written by each of `grid`
// CUDA blocks. The lab's cases: f32 sub 8 and 16, bf16 16 and 32, int16
// 16, int32 8. Returns cudaGetLastError() (or cudaErrorInvalidValue for a
// case the kernels are not built for).
int lab_pack16_old(const void* x, int dtype, int sub, int grid, void* out, void* stream) {
  if (grid < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 g(grid), b(kLanes);
  if (dtype == kF32 && sub == 8) {
    lab_pack16_f32<8><<<g, b, 0, s>>>(static_cast<const float*>(x), static_cast<float*>(out));
  } else if (dtype == kF32 && sub == 16) {
    lab_pack16_f32<16><<<g, b, 0, s>>>(static_cast<const float*>(x), static_cast<float*>(out));
  } else if (dtype == kBF16 && sub == 16) {
    lab_pack16_bf16<16><<<g, b, 0, s>>>(static_cast<const uint16_t*>(x),
                                        static_cast<uint16_t*>(out));
  } else if (dtype == kBF16 && sub == 32) {
    lab_pack16_bf16<32><<<g, b, 0, s>>>(static_cast<const uint16_t*>(x),
                                        static_cast<uint16_t*>(out));
  } else if (dtype == kI16 && sub == 16) {
    lab_pack16_int<int16_t, 16><<<g, b, 0, s>>>(static_cast<const int16_t*>(x),
                                                static_cast<int16_t*>(out));
  } else if (dtype == kI32 && sub == 8) {
    lab_pack16_int<int32_t, 8><<<g, b, 0, s>>>(static_cast<const int32_t*>(x),
                                               static_cast<int32_t*>(out));
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
"""

# The kernel before L8's redesign (the parent's csrc/lab_mxu.cu, entry
# lab_mxu_old): CUDA blocks of 128 threads (8 an SM) grid-striding over
# the chunks, each writing its (Q, 128) int32 sums; the wrapper merged
# them with torch.
OLD_MXU = r"""

#include "lab_common.cuh"

namespace {

using namespace lab;

template <int Q>
__global__ void __launch_bounds__(kLanes, kBlocksPerSm)
lab_mxu_sweep(const int32_t* __restrict__ words, const uint32_t* __restrict__ tables,
              int chunks, int32_t* __restrict__ partials) {
  __shared__ uint32_t tab[Q * kLanes];
  const int lane = threadIdx.x;
#pragma unroll
  for (int q = 0; q < Q; ++q) tab[q * kLanes + lane] = __ldg(tables + q * kLanes + lane);
  __syncthreads();
  int32_t acc[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) acc[q] = 0;
  for (int c = blockIdx.x; c < chunks; c += gridDim.x) {
    uint32_t w[kChunk];
#pragma unroll
    for (int r = 0; r < kChunk; ++r) w[r] = word(words + (int64_t)(c * kChunk + r) * kLanes + lane);
#pragma unroll
    for (int r = 0; r < kChunk; ++r) {
      const H16Split s = h16_shared(w[r]);
#pragma unroll
      for (int q = 0; q < Q; ++q) acc[q] += h16_apply(tab + q * kLanes, s);
    }
  }
  int32_t* out = partials + (int64_t)blockIdx.x * Q * kLanes + lane;
#pragma unroll
  for (int q = 0; q < Q; ++q) out[q * kLanes] = acc[q];
}

template <int Q>
cudaError_t launch(int nblk, cudaStream_t stream, const int32_t* words, const uint32_t* tables,
                   int chunks, int32_t* partials) {
  lab_mxu_sweep<Q><<<nblk, kLanes, 0, stream>>>(words, tables, chunks, partials);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// words: (chunks * 8, 128) int32; tables: (queries, 128) int32 int4x8
// rows, queries 4 or 16; partials: (nblk, queries, 128) int32, each CUDA
// block's sums. Returns cudaGetLastError() (or cudaErrorInvalidValue for
// arguments the kernel does not take).
int lab_mxu_old(const int32_t* words, const uint32_t* tables, int chunks, int queries, int nblk,
            int32_t* partials, void* stream) {
  if (chunks < 1 || nblk < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (queries) {
    case 4: err = launch<4>(nblk, s, words, tables, chunks, partials); break;
    case 16: err = launch<16>(nblk, s, words, tables, chunks, partials); break;
    default: err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
"""

# An empty kernel: the card's floor for one launch.
EMPTY = r"""
#include <cuda_runtime.h>

namespace {
__global__ void lab_empty_kernel() {}
}  // namespace

extern "C" int lab_empty(int blocks, int threads, void* stream) {
  lab_empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
"""

UNITS = {"pack16_old": OLD_PACK16, "mxu_old": OLD_MXU, "empty": EMPTY}

_FMA_MUL = ('asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(p) : "r"(a), '
            '"r"(x), "r"(kNegZero2));')
_FMA_ADD = ('asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(s) : "r"(p), '
            '"r"(kOne2), "r"(x));')
_MUL = 'asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(p) : "r"(a), "r"(x));'
_ADD = 'asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(s) : "r"(p), "r"(x));'
# the bf16 pair's forms beside the kernel's fma.rn + fma.rn
FORMS = {"mul_add": ((_FMA_MUL, _MUL), (_FMA_ADD, _ADD)),
         "mul_fma": ((_FMA_MUL, _MUL),),
         "fma_add": ((_FMA_ADD, _ADD),)}
_M1 = ("constexpr int kMxuBlocksPerSm = 1;",
       "constexpr int kMxuBlocksPerSm = 2;")
_MERGE = "    const unsigned long long old = atomicAdd(c, add);"
# name -> (source, parts, exact: computes the kernel's function)
VARIANTS = {
    "one_tile": ("lab_pack16.cu", (("typename C::In* o = out + copy * sub * kLanes;",
                                    "typename C::In* o = out;"),), True),
    "chains4": ("lab_pack16.cu", (("static constexpr int kChains = 8;",
                                   "static constexpr int kChains = 4;"),), True),
    "bf16_chains8": ("lab_pack16.cu", (("static constexpr int kChains = 4;",
                                        "static constexpr int kChains = 8;"),),
                     True),
    "warps8": ("lab_pack16.cu", (("constexpr int kWarps = 16;",
                                  "constexpr int kWarps = 8;"),), True),
    "warps4": ("lab_pack16.cu", (("constexpr int kWarps = 16;",
                                  "constexpr int kWarps = 4;"),), True),
    "blocks2": ("lab_mxu.cu", (_M1,), True),
    "batch4": ("lab_mxu.cu", (("constexpr int kBatch = 2;",
                               "constexpr int kBatch = 4;"),), True),
    "no_merge": ("lab_mxu.cu", (
        (_MERGE, "    out[q * kLanes + lane] = static_cast<float>(\n"
                 "        static_cast<int32_t>(t));\n"
                 "    const unsigned long long old = 0;"),), False),
    "no_decode": ("lab_mxu.cu", (
        ("for (int b = 0; b < kBatch; ++b) decode<Q>(tab, cur[b], s);",
         "for (int b = 0; b < kBatch; ++b) s[b] += cur[b];"),), False),
}
# L9's blocks an SM by variant (the wrapper's one block of 16 warps)
_PER_SM = {"warps8": 2, "warps4": 4}
_LIBS = {}
_LOCK = threading.Lock()
build_seconds = {}


def _nvcc(d: str, cu: str, so: str) -> None:
    tmp = f"{so}.{os.getpid()}.tmp"
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                          "-I", d, "-I", _build.CSRC_DIR, "-o", tmp, cu],
                         capture_output=True, text=True, timeout=900)
    if res.returncode:
        raise RuntimeError(f"nvcc {os.path.basename(so)} failed:\n"
                           f"{res.stderr[-4000:]}")
    os.replace(tmp, so)   # atomic: concurrent builds agree


def _unit(name: str) -> str:
    """nvcc one unit: a kernel before (UNITS), a bf16 form (FORMS) or a
    variant (VARIANTS); the path of its shared library. The library's
    name carries a hash of the flags, the unit's sources and the package's
    headers, and a library already built for them is reused."""
    import hashlib

    d = os.path.join(OUT_DIR, name)
    if name in UNITS:
        os.makedirs(d, exist_ok=True)
        cu = os.path.join(d, "unit.cu")
        with open(cu, "w") as fh:
            fh.write(UNITS[name])
    else:
        source, parts = (("lab_pack16.cu", FORMS[name]) if name in FORMS
                         else VARIANTS[name][:2])
        variant_dir(d, (source,), parts)
        cu = os.path.join(d, source)
    h = hashlib.sha256(" ".join(_build.NVCC_FLAGS).encode())
    for src in (sorted(glob.glob(os.path.join(d, "*.cu*"))) +
                sorted(glob.glob(os.path.join(_build.CSRC_DIR, "*.cuh")))):
        with open(src, "rb") as fh:
            h.update(os.path.basename(src).encode() + fh.read())
    so = os.path.join(d, f"{name}-{h.hexdigest()[:16]}.so")
    if not os.path.exists(so):
        _nvcc(d, cu, so)
    return so


def build(names=tuple(UNITS)) -> dict:
    """The units ``names`` (of UNITS, FORMS, VARIANTS) built (each nvcc at
    once; a library built before for the same sources reused) and loaded:
    name -> ctypes library. Each loaded once per process; safe to call
    from a thread started early (chip_smoke.py does)."""
    import time

    with _LOCK:
        todo = [n for n in names if n not in _LIBS]

        def one(name):
            t0 = time.perf_counter()
            so = _unit(name)
            build_seconds[name] = time.perf_counter() - t0
            return name, so
        if todo:
            with ThreadPoolExecutor(max_workers=len(todo)) as ex:
                for name, so in ex.map(one, todo):
                    lib = ctypes.CDLL(so)
                    entry = {"pack16_old": "lab_pack16_old",
                             "mxu_old": "lab_mxu_old",
                             "empty": "lab_empty"}.get(name)
                    if entry is None:
                        entry = VARIANTS[name][0][:-3] if name in VARIANTS \
                            else "lab_pack16"
                    fn = getattr(lib, entry)
                    fn.argtypes = _ARGTYPES.get(entry) or \
                        _build._SIGNATURES[entry]
                    fn.restype = ctypes.c_int
                    _LIBS[name] = (lib, fn, so)
    return {n: _LIBS[n] for n in names}


_vp, _i32 = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {"lab_pack16_old": [_vp] + [_i32] * 3 + [_vp] * 2,
             "lab_mxu_old": [_vp] * 2 + [_i32] * 3 + [_vp] * 2,
             "lab_empty": [_i32, _i32, _vp]}


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _fn(name):
    return build((name,))[name][1]


def pack16_old(x: torch.Tensor, grid: int = pack16_lab.GRID):
    """The kernel before L9's redesign on a CUDA tile: (sub, 128)."""
    out = torch.empty_like(x)
    _build.check(_fn("pack16_old")(
        x.data_ptr(), pack16_lab.DTYPES.index(x.dtype), x.shape[0], grid,
        out.data_ptr(), _stream(x.device)), "lab_pack16_old")
    return out


def pack16_unit(name: str):
    """A launcher of L9 built as form or variant ``name``, taking the tile
    as ``pack16_device`` does."""
    fn = _fn(name)

    def call(x, grid=pack16_lab.GRID):
        blocks = pack16_lab.pack16_blocks(x.device) * _PER_SM.get(name, 1)
        out = torch.empty((grid, *x.shape), dtype=x.dtype, device=x.device)
        _build.check(fn(x.data_ptr(), pack16_lab.DTYPES.index(x.dtype),
                        x.shape[0], grid, blocks, out.data_ptr(), 0,
                        _stream(x.device)), name)
        return out[0]
    return call


def mxu_old(words: torch.Tensor, tables: torch.Tensor, merged: bool = True):
    """The kernel before L8's redesign: its per-block sums (blocks, Q, 128)
    int32, or with ``merged`` the (Q, 128) float32 its wrapper made of them
    with torch."""
    dev = words.device
    chunks = words.shape[0] // CHUNK
    Q = tables.shape[0]
    nblk = cuda_blocks(dev, chunks)
    part = torch.empty((nblk, Q, 128), dtype=torch.int32, device=dev)
    _build.check(_fn("mxu_old")(
        words.data_ptr(), tables.data_ptr(), chunks, Q, nblk,
        part.data_ptr(), _stream(dev)), "lab_mxu_old")
    if not merged:
        return part
    return wrap_int(part.long().sum(0), torch.int32).float()


def mxu_unit(name: str):
    """A launcher of L8 built as variant ``name``, taking the words and
    tables as ``mxu_vpu_device`` does (its own accumulator; blocks2 on a
    wave of two blocks an SM)."""
    from ..ops.kernel import _device_info

    fn = _fn(name)
    ws = {}

    def call(words, tables):
        dev, Q = words.device, tables.shape[0]
        chunks = words.shape[0] // CHUNK
        per_sm = 2 if name == "blocks2" else mxu_gather_lab.MXU_BLOCKS_PER_SM
        blocks = min(_device_info(dev)[0] * per_sm,
                     -(-chunks * CHUNK // mxu_gather_lab.MXU_MIN_ROWS))
        acc = ws.get(Q)
        if acc is None:
            acc = ws[Q] = torch.zeros((Q, 128), dtype=torch.int64,
                                      device=dev)
        out = torch.empty((Q, 128), dtype=torch.float32, device=dev)
        _build.check(fn(words.data_ptr(), tables.data_ptr(), chunks, Q,
                        blocks, acc.data_ptr(), out.data_ptr(),
                        _stream(dev)), name)
        return out
    return call


def empty_launch(dev) -> None:
    """One launch of an empty kernel (one block of 128 threads)."""
    _build.check(_fn("empty")(1, 128, _stream(dev)), "lab_empty")


def in_turns(fns: dict, timer, rounds: int = 3) -> dict:
    """name -> the times ``timer(fn)`` of each of ``fns`` taken in turns:
    each round the names in order, then in reverse (old, new, new, old)."""
    names = list(fns)
    got = {n: [] for n in names}
    for _ in range(rounds):
        for n in names + names[::-1]:
            got[n].append(timer(fns[n]))
    return got


def _bits(t):
    return t.view(torch.int16) if t.element_size() == 2 else \
        t.view(torch.int32)


def _same(a, b) -> bool:
    return a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))


def _emit(line: dict) -> dict:
    print(json.dumps(line), flush=True)
    return line


def _timed(line: dict, x, fns: dict, rounds: int) -> dict:
    """The slope and held times of launchers ``fns`` (name -> fn(tile)) on
    tile ``x`` in turns, into ``line``: each name's list and median, and
    each name's median over the first name's."""
    timers = {"slope_ms": lambda f: pack16_lab.slope_ms(x, launch=f),
              "held_ms": lambda f: sweep_ms(lambda: f(x), reps=20)}
    first = next(iter(fns))
    for key, timer in timers.items():
        for n, v in in_turns(fns, timer, rounds).items():
            line[f"{n}_{key}"] = v
            line[f"{n}_{key}_median"] = statistics.median(v)
        for n in fns:
            line[f"{n}_{key}_over_{first}"] = (line[f"{n}_{key}_median"] /
                                               line[f"{first}_{key}_median"])
    return line


def _check_pack16(name: str, x, fns: dict) -> None:
    """Raise unless each of ``fns`` equals ``pack16_plain`` bit for bit on
    x and on x + 3 (chains that run to inf and NaN, or wrap)."""
    for shift in (0, 3):
        xi = x + shift
        want = pack16_lab.pack16_plain(xi)
        for n, fn in fns.items():
            if not _same(fn(xi), want):
                raise RuntimeError(f"L9 {name} {n}: differs from "
                                   f"pack16_plain on x + {shift}")


def pack16_routes(dev, names=pack16_lab.NAMES, rounds: int = 3) -> dict:
    """L9's cases against the kernel before, in turns (module docstring):
    name -> line."""
    data = pack16_lab.pack16_data()
    fns = {"old": pack16_old, "new": pack16_lab.pack16_device}
    out = {}
    for name in names:
        x = data[name].to(dev)
        _check_pack16(name, x, fns)
        line = dict(lab="lab_ablation", mode="routes", kernel="lab_pack16",
                    case=name, bound_ms=pack16_lab.bound_ms(
                        *pack16_lab.case(name)))
        out[name] = _emit(_timed(line, x, fns, rounds))
    return out


def bf16_forms(dev, rounds: int = 3) -> dict:
    """L9's bf16 cases in each of FORMS beside the kernel (module
    docstring): case -> line, each form's round-loop chain opcodes in it."""
    build(tuple(FORMS))
    sass = {}
    for form in ("fma_fma", *FORMS):
        obj = None if form == "fma_fma" else build((form,))[form][2]
        loops = _build.sass_loops("lab_pack16.cu", "lab_pack16_chains", obj)
        loop = pack16_lab.round_loop(
            loops[pack16_lab.sass_kernel(loops, torch.bfloat16)],
            torch.bfloat16)
        sass[form] = pack16_lab.chain_opcodes(loop["opcodes"],
                                              torch.bfloat16)
    fns = {"fma_fma": pack16_lab.pack16_device,
           **{f: pack16_unit(f) for f in FORMS}}
    data = pack16_lab.pack16_data()
    out = {}
    for name in ("bf16_16", "bf16_32"):
        x = data[name].to(dev)
        _check_pack16(name, x, fns)
        line = dict(lab="lab_ablation", mode="forms", kernel="lab_pack16",
                    case=name, chain_opcodes=sass,
                    bound_ms=pack16_lab.bound_ms(*pack16_lab.case(name)))
        out[name] = _emit(_timed(line, x, fns, rounds))
    return out


def variants(dev, rounds: int = 2) -> dict:
    """The kernels beside their VARIANTS (module docstring): L9 case ->
    line, L8 chunks -> line; held times in turns, the exact variants held
    to the plain versions first."""
    names = tuple(VARIANTS)
    build(names)
    data = pack16_lab.pack16_data()
    p16 = {n: pack16_unit(n) for n in names if VARIANTS[n][0] ==
           "lab_pack16.cu"}
    out = {}
    for name in pack16_lab.NAMES:
        x = data[name].to(dev)
        fns = {"kernel": pack16_lab.pack16_device, **p16}
        _check_pack16(name, x, fns)
        line = dict(lab="lab_ablation", mode="variants",
                    kernel="lab_pack16", case=name,
                    bound_ms=pack16_lab.bound_ms(*pack16_lab.case(name)))
        for n, v in in_turns(fns, lambda f: sweep_ms(lambda: f(x),
                                                       reps=20),
                             rounds).items():
            line[f"{n}_held_ms"] = v
            line[f"{n}_held_ms_median"] = statistics.median(v)
        out[name] = _emit(line)
    mxu = {n: mxu_unit(n) for n in names if VARIANTS[n][0] == "lab_mxu.cu"}
    for n in MXU_CHUNKS:
        words, tables, _ = (torch.from_numpy(a).to(dev)
                            for a in mxu_lab_data(n, MXU_QUERIES))
        want = mxu_gather_lab.mxu_vpu_plain(words, tables)
        fns = {"kernel": lambda: mxu_gather_lab.mxu_vpu_device(words, tables),
               **{v: (lambda f=f: f(words, tables)) for v, f in mxu.items()}}
        for v, f in fns.items():
            if (v == "kernel" or VARIANTS[v][2]) and \
                    not torch.equal(f(), want):
                raise RuntimeError(f"L8 {n} chunks {v}: differs from "
                                   f"mxu_vpu_plain")
        line = dict(lab="lab_ablation", mode="variants", kernel="lab_mxu",
                    chunks=n, queries=MXU_QUERIES)
        for v, t in in_turns(fns, lambda f: sweep_ms(f, reps=20),
                             rounds).items():
            line[f"{v}_held_ms"] = t
            line[f"{v}_held_ms_median"] = statistics.median(t)
        out[n] = _emit(line)
        del words, tables
    return out


def mxu_routes(dev, chunks=MXU_CHUNKS, Q: int = MXU_QUERIES,
               rounds: int = 3) -> dict:
    """L8 against the kernel before and an empty launch, in turns (module
    docstring): chunks -> line."""
    out = {}
    for n in chunks:
        words, tables, _ = (torch.from_numpy(a).to(dev)
                            for a in mxu_lab_data(n, Q))
        want = mxu_gather_lab.mxu_vpu_plain(words, tables)
        for what, got in (("new", mxu_gather_lab.mxu_vpu_device(words,
                                                                 tables)),
                          ("old", mxu_old(words, tables))):
            if not torch.equal(got, want):
                raise RuntimeError(f"L8 {n} chunks {what}: differs from "
                                   f"mxu_vpu_plain")
        fns = {"old": lambda: mxu_old(words, tables),
               "new": lambda: mxu_gather_lab.mxu_vpu_device(words, tables),
               "old_unmerged": lambda: mxu_old(words, tables, merged=False),
               "empty": lambda: empty_launch(dev)}
        line = dict(lab="lab_ablation", mode="routes", kernel="lab_mxu",
                    chunks=n, queries=Q, blocks=mxu_gather_lab.mxu_blocks(
                        dev, n), old_blocks=cuda_blocks(dev, n))
        for name, v in in_turns(fns, lambda f: sweep_ms(f, reps=20),
                                rounds).items():
            line[f"{name}_held_ms"] = v
            line[f"{name}_held_ms_median"] = statistics.median(v)
        line["new_over_old"] = (line["new_held_ms_median"] /
                                line["old_held_ms_median"])
        line["new_over_empty"] = (line["new_held_ms_median"] /
                                  line["empty_held_ms_median"])
        out[n] = _emit(line)
        del words, tables
    return out


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    bad = [a for a in argv if a not in MODES]
    if bad:
        raise SystemExit(f"unknown modes {bad}: choose from {MODES}")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device (torch.cuda.is_available() is "
                         "False): the ablation times kernels on the card")
    dev = torch.device("cuda", 0)
    print(smi_line(), flush=True)
    out = {}
    for mode in argv or MODES:
        if mode == "routes":
            out["pack16"] = pack16_routes(dev)
            out["mxu"] = mxu_routes(dev)
        elif mode == "forms":
            out["forms"] = bf16_forms(dev)
        else:
            out["variants"] = variants(dev)
    return out


if __name__ == "__main__":
    main()
