// Stream probe (kernel K3) for Hopper (sm_90a): read the packed word
// stream once and reduce it to an (8, 128) int32 checksum,
//   out[s, l] = salt[l] + sum_c words[8c + s, l]   (int32 wraparound).
//
// Replaces spmv_topk_tpu/ops/streamprobe.py::_stream_kernel /
// stream_words_device, the benchmark's stream floor: the rate at which
// this card delivers the same bytes the Top-K sweep reads, with almost no
// arithmetic.
//
// Bound: device memory bytes only (one add per word). Design: each thread
// owns 4 consecutive words of the 1024-word chunk and reads them with one
// 16-byte load; blocks grid-stride over chunks with four loads in flight
// per thread. The TPU kernel carries its sum across sequential grid steps;
// CUDA blocks run in no order, so each block adds its partial sums into
// the output with a uint32 atomic add, whose wraparound is the int32 sum's
// (integer addition is associative, so the result is exact in any order).
// The wrapper seeds the output with the salt.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 8 * 128;          // int32 words per (8, 128) chunk
constexpr int kThreads = kChunk / 4;     // one int4 per thread per chunk
constexpr int kUnroll = 4;

__global__ void __launch_bounds__(kThreads)
stream_words_kernel(const int4* __restrict__ words, int64_t num_chunks,
                    unsigned int* __restrict__ out) {
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

extern "C" {

// words: (num_chunks * 8, 128) int32, 16-byte aligned; out: (8, 128) int32
// holding the salt on entry. Returns cudaGetLastError().
int stream_words(const void* words, int64_t num_chunks, void* out,
                 int num_cuda_blocks, void* stream) {
  if (num_cuda_blocks < 1) return cudaErrorInvalidValue;
  stream_words_kernel<<<num_cuda_blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(words), num_chunks, static_cast<unsigned int*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
