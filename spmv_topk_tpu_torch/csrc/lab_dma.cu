// DMA lab (L2) for Hopper (sm_90a): a float sum over every word of a
// stream, in steps of the lab's block size, to see whether the block size
// moves a plain sweep's rate.
//
// Replaces experiments/dma_lab.py::make_kernel (:41), the pallas_call of
// dma_lab.py::run (:71).
//
// What it computes. The words are nb lab blocks of bs rows x 128 lanes,
// each walked in t sub-steps of bs / t rows. In a sub-step, row r of
// chunk u (8 rows) adds bf16(low half of the word) + table[lane] into
// accumulator u % 2 of sublane r (both from 0.0); the sub-step then adds
// them into the running (8, 128) sum as (sum + acc0) + acc1 (dma_lab.py:
// 53-57; the TPU walks the sub-steps of block 0, then block 1, ...). f32
// throughout, denormals flushed (-ftz=true, as the TPU flushes), each add
// rounded apart (-fmad=false).
//
// Mapping. A TPU block of 1024-8192 sublanes (512 KiB - 4 MiB) is staged
// whole in VMEM; an SM's 227 KB of shared memory cannot hold one, and a
// sum needs no staging, so nothing is staged here: lab block i belongs to
// CUDA block i % nblk (grid-stride, in increasing order), which walks its
// t sub-steps with plain 4-byte loads, one thread per lane (a warp reads
// 128 contiguous bytes a row), chunks in pairs so that 16 loads are in
// flight per thread. What (bs, t) changes here is the work of one
// grid-stride step and the number of lab blocks: 1 GiB holds 2048 blocks
// of 1024 rows but 256 of 8192, fewer than the 1056 CUDA blocks the card
// keeps resident (8 an SM), so large blocks leave SMs idle. The mapping
// does not measure DMA sizes or VMEM staging, which the card does not
// have; no load width the lab lacks is added.
//
// Order. Each CUDA block writes its partial sum (its lab blocks' sub-steps
// in the TPU's order from 0.0); lab_dma_reduce adds the partials in
// block order, starting from block 0's, with no atomics, so the result is
// one fixed order that the plain version repeats bit for bit on any data
// (with one CUDA block it is the TPU's order).
//
// Bound. Every word read once: 1 GiB at 3.35 TB/s is 0.32 ms; two float
// adds a word are far below the card's float rate, so bytes bound it.

#include "lab_common.cuh"

namespace {

using namespace lab;

__global__ void __launch_bounds__(kLanes, kBlocksPerSm)
lab_dma_sweep(const int32_t* __restrict__ words, const float* __restrict__ table, int nb,
              int bs, int t, float* __restrict__ partials) {
  const int lane = threadIdx.x;
  const float tab = __ldg(table + lane);
  const int half = bs / t;
  const int chunks = half / kChunk;
  float part[kChunk];
#pragma unroll
  for (int r = 0; r < kChunk; ++r) part[r] = 0.0f;
  for (int i = blockIdx.x; i < nb; i += gridDim.x) {
    for (int j = 0; j < t; ++j) {
      const int32_t* src = words + ((int64_t)i * bs + (int64_t)j * half) * kLanes + lane;
      float a0[kChunk], a1[kChunk];
#pragma unroll
      for (int r = 0; r < kChunk; ++r) a0[r] = a1[r] = 0.0f;
      int u = 0;
      for (; u + 1 < chunks; u += 2) {
        uint32_t e[kChunk], o[kChunk];
#pragma unroll
        for (int r = 0; r < kChunk; ++r) {
          e[r] = word(src + (int64_t)(u * kChunk + r) * kLanes);
          o[r] = word(src + (int64_t)((u + 1) * kChunk + r) * kLanes);
        }
#pragma unroll
        for (int r = 0; r < kChunk; ++r) {
          a0[r] = a0[r] + (bf16(e[r]) + tab);
          a1[r] = a1[r] + (bf16(o[r]) + tab);
        }
      }
      if (u < chunks) {
#pragma unroll
        for (int r = 0; r < kChunk; ++r)
          a0[r] = a0[r] + (bf16(word(src + (int64_t)(u * kChunk + r) * kLanes)) + tab);
      }
#pragma unroll
      for (int r = 0; r < kChunk; ++r) part[r] = (part[r] + a0[r]) + a1[r];
    }
  }
  float* out = partials + (int64_t)blockIdx.x * kChunk * kLanes + lane;
#pragma unroll
  for (int r = 0; r < kChunk; ++r) out[r * kLanes] = part[r];
}

// out[k] = ((p[0][k] + p[1][k]) + p[2][k]) + ...: one thread per element
// of the (8, 128) sum.
__global__ void lab_dma_reduce_kernel(const float* __restrict__ partials, int nblk,
                                      float* __restrict__ out) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= kChunk * kLanes) return;
  float s = partials[k];
  for (int b = 1; b < nblk; ++b) s = s + partials[(int64_t)b * kChunk * kLanes + k];
  out[k] = s;
}

}  // namespace

extern "C" {

// words: (nb * bs, 128) int32; table: (1, 128) f32; bs a multiple of
// 8 * t; partials: (nblk, 8, 128) f32, each CUDA block's sum. Returns
// cudaGetLastError() (or cudaErrorInvalidValue for arguments the kernel
// does not take).
int lab_dma(const int32_t* words, const float* table, int nb, int bs, int t, int nblk,
            float* partials, void* stream) {
  if (nb < 1 || t < 1 || bs < kChunk * t || bs % (kChunk * t) || nblk < 1)
    return cudaErrorInvalidValue;
  lab_dma_sweep<<<nblk, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(words, table, nb, bs,
                                                                          t, partials);
  return static_cast<int>(cudaGetLastError());
}

// partials: (nblk, 8, 128) f32 -> out (8, 128) f32, added in block order.
int lab_dma_reduce(const float* partials, int nblk, float* out, void* stream) {
  if (nblk < 1) return cudaErrorInvalidValue;
  lab_dma_reduce_kernel<<<kChunk, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(partials,
                                                                                   nblk, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
