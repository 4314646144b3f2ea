"""Where K3's time went: the stream probe (``csrc/stream_probe.cu``)
beside the kernel it replaced and beside itself with its final add taken
out, all on the same words, with the library call that computes the same
checksum.

  k3                 the kernel through its wrapper
                     (``ops/streamprobe.py::stream_words_device``): one
                     launch;
  k3_partials        the kernel's source with the final add taken out:
                     each block stores its 1024 partial sums in a row of
                     its own (no atomic add, no ticket, no salt, no
                     output);
  old                the kernel before (``OLD_SOURCE``: 8 blocks an SM of
                     256 threads striding over the chunks, four 16-byte
                     loads in flight a thread, then a one-load remainder
                     loop, 1024 atomic adds a block onto the output) with
                     its wrapper's copy of the salt into the output, a
                     launch of its own, before each launch;
  old_no_salt_copy   the same kernel alone, its output seeded once;
  library            ``words.view(-1, 8, 128).sum(0, dtype=torch.int32)``
                     plus the salt.

Only ``k3``, ``old`` and ``library`` compute the checksum; the others are
timing probes. Each line: the variant, its ms (median of 5 runs of 10
launches between CUDA events), GB/s of words and its share of ``k3``'s
time; first the card's name and power limit.

    python -m spmv_topk_tpu_torch.experiments.k3_ablation

Env: ``ABL_ROWS`` (default 10,000,000 rows: the headline corpus's h16
words, 449,314,816 bytes).
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
from concurrent.futures import ThreadPoolExecutor

import torch

from ..config import LANES
from ..ops import _build
from ..ops.streamprobe import stream_words_device
from ._common import smi_line, sweep_ms

SOURCE = os.path.join(_build.CSRC_DIR, "stream_probe.cu")
OUT_DIR = os.path.join(_build.BUILD_DIR, "k3_ablation")
ROWS = int(os.environ.get("ABL_ROWS", 10_000_000))
_CHUNK = 8 * LANES

# the kernel's final add, and what k3_partials has in its place
_FINAL_ADD = (
    ("atomicAdd(acc + w, sum[w]);", "acc[blockIdx.x * kChunk + w] = sum[w];"),
    ("if (!lane_merge::arrive(ticket, gridDim.x)) return;", "return;"))

OLD_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 8 * 128;
constexpr int kThreads = kChunk / 4;
constexpr int kUnroll = 4;

__global__ void __launch_bounds__(kThreads)
old_kernel(const int4* __restrict__ words, int64_t num_chunks, unsigned int* __restrict__ out) {
  const int t = threadIdx.x;
  uint32_t a0 = 0, a1 = 0, a2 = 0, a3 = 0;
  int64_t c = blockIdx.x;
  const int64_t step = gridDim.x;
  for (; c + (kUnroll - 1) * step < num_chunks; c += kUnroll * step) {
    int4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = __ldg(words + (c + u * step) * kThreads + t);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      a0 += static_cast<uint32_t>(v[u].x);
      a1 += static_cast<uint32_t>(v[u].y);
      a2 += static_cast<uint32_t>(v[u].z);
      a3 += static_cast<uint32_t>(v[u].w);
    }
  }
  for (; c < num_chunks; c += step) {
    const int4 v = __ldg(words + c * kThreads + t);
    a0 += static_cast<uint32_t>(v.x);
    a1 += static_cast<uint32_t>(v.y);
    a2 += static_cast<uint32_t>(v.z);
    a3 += static_cast<uint32_t>(v.w);
  }
  atomicAdd(out + 4 * t + 0, a0);
  atomicAdd(out + 4 * t + 1, a1);
  atomicAdd(out + 4 * t + 2, a2);
  atomicAdd(out + 4 * t + 3, a3);
}

}  // namespace

extern "C" int stream_words_old(const void* words, int64_t num_chunks, void* out, int blocks,
                                void* stream) {
  old_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(words), num_chunks, static_cast<unsigned int*>(out));
  return static_cast<int>(cudaGetLastError());
}
"""
# the old wrapper's CUDA blocks an SM
_OLD_BLOCKS_PER_SM = 8


def partials_source() -> str:
    src = open(SOURCE).read()
    for old, new in _FINAL_ADD:
        if old not in src:
            raise RuntimeError(f"the kernel's source no longer holds {old!r}")
        src = src.replace(old, new)
    return src


def build(name: str, source: str) -> ctypes.CDLL:
    """nvcc ``source`` into a shared library of its own; loaded."""
    os.makedirs(OUT_DIR, exist_ok=True)
    cu = os.path.join(OUT_DIR, f"{name}.cu")
    so = os.path.join(OUT_DIR, f"{name}.so")
    with open(cu, "w") as fh:
        fh.write(source)
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                          "-I", _build.CSRC_DIR, "-o", so, cu],
                         capture_output=True, text=True, timeout=900)
    if res.returncode:
        raise RuntimeError(f"nvcc {name} failed:\n{res.stderr[-4000:]}")
    return ctypes.CDLL(so)


def run(words: torch.Tensor) -> list:
    """Every variant on ``words`` ((n * 8, 128) int32 on the card): one
    line each (``k3`` first), after requiring the old kernel's, K3's and
    the library's checksums equal."""
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    with ThreadPoolExecutor(2) as ex:
        old_lib, part_lib = ex.map(build, ("old", "k3_partials"),
                                   (OLD_SOURCE, partials_source()))
    old_fn = old_lib.stream_words_old
    old_fn.argtypes = [vp, i64, vp, i32, vp]
    part_fn = part_lib.stream_words
    part_fn.argtypes = [vp, i64, vp, vp, vp, i32, vp]
    for fn in (old_fn, part_fn):
        fn.restype = ctypes.c_int
    dev = words.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n = words.shape[0] // 8
    salt = torch.arange(LANES, dtype=torch.int32, device=dev).reshape(
        1, LANES) * 7919
    stream = torch.cuda.current_stream(dev).cuda_stream
    old_blocks = max(1, min(sms * _OLD_BLOCKS_PER_SM, n))
    seeded = salt.expand(8, LANES).contiguous()
    # a row of partial sums for each of the kernel's blocks
    per_sm = int(re.search(r"kBlocksPerSm = (\d+);", open(SOURCE).read())[1])
    ws = torch.zeros((per_sm * sms + 1) * _CHUNK + 1, dtype=torch.int32,
                     device=dev)
    scratch = torch.empty((8, LANES), dtype=torch.int32, device=dev)

    def old():
        out = salt.expand(8, LANES).contiguous()
        _build.check(old_fn(words.data_ptr(), n, out.data_ptr(), old_blocks,
                            stream), "stream_words_old")
        return out

    def old_no_salt_copy():
        _build.check(old_fn(words.data_ptr(), n, seeded.data_ptr(),
                            old_blocks, stream), "stream_words_old")

    def k3_partials():
        _build.check(part_fn(words.data_ptr(), n, salt.data_ptr(),
                             ws.data_ptr(), scratch.data_ptr(), sms, stream),
                     "stream_words (partials)")

    def library():
        return words.view(-1, 8, LANES).sum(0, dtype=torch.int32) + salt

    k3 = stream_words_device(words, salt)
    if not (torch.equal(old(), k3) and torch.equal(library(), k3)):
        raise RuntimeError("the old kernel's, K3's and the library's "
                           "checksums differ")
    variants = dict(k3=lambda: stream_words_device(words, salt),
                    k3_partials=k3_partials, old=old,
                    old_no_salt_copy=old_no_salt_copy, library=library)
    ms = {name: sweep_ms(fn) for name, fn in variants.items()}
    nbytes = words.numel() * 4
    return [dict(lab="k3_ablation", variant=name, ms=t,
                 gb_per_s=nbytes / t / 1e6, share_of_k3=t / ms["k3"],
                 words_bytes=nbytes, device=torch.cuda.get_device_name(dev))
            for name, t in ms.items()]


def main() -> list:
    import spmv_topk_tpu_torch as pt
    from spmv_topk_tpu_torch.formats import create_sparse_matrix

    if not torch.cuda.is_available():
        raise SystemExit("k3_ablation times kernels: it needs a card")
    print(smi_line(), flush=True)
    cfg = pt.TopKSpMVConfig(k=100, lane_k=8, max_cols=1024,
                            query_codec="h16", fused_layout="octet",
                            width_quantum=2, fold_tile=8,
                            fused_block_sublanes=1024, rescore_pool=400)
    eng = pt.TopKSpMV(create_sparse_matrix(ROWS, 1024, 20, "gamma", seed=1),
                      cfg, device=torch.device("cuda"))
    lines = run(eng.words)
    for line in lines:
        print(json.dumps(line), flush=True)
    return lines


if __name__ == "__main__":
    main()
