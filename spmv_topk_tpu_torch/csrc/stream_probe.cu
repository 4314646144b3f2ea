// Stream probe (kernel K3) for Hopper (sm_90a): read the packed word
// stream once and reduce it to an (8, 128) int32 checksum,
//   out[s, l] = salt[l] + sum_c words[8c + s, l]   (int32 wraparound).
//
// Replaces spmv_topk_tpu/ops/streamprobe.py::_stream_kernel /
// stream_words_device (its pallas_call at :54), the benchmark's stream
// floor: the rate at which this card delivers the same bytes the Top-K
// sweeps read, with almost no arithmetic.
//
// Bound: device memory bytes only, the words read once (449 MB of the
// headline corpus's h16 words: 0.134 ms at 3.35 TB/s), one add a word.
//
// Design, against what a stream read can lose:
//  1. a second launch: the kernel seeds the salt itself, so the wrapper
//     runs no torch op before or after its one launch;
//  2. atomics piled on one output: block b sums its part in registers,
//     then its threads' sums through shared memory into the chunk's 1024
//     words, and adds each once into a 4 KB accumulator with a uint32
//     atomic (a warp's 32 adds on one 128-byte line; 2 blocks an SM, so
//     264 adds a line on the H100); a ticket (lane_merge.cuh::arrive)
//     elects the last block, which takes each word with an atomic
//     exchange (leaving it 0 for the next launch), adds the salt and
//     writes out, and resets the ticket. uint32 wraparound is the int32
//     sum's, and integer addition is associative, so the result is exact
//     in any order of the blocks;
//  3. a ragged last round: one wave of blocks of kThreads threads
//     (kBlocksPerSm an SM), block b on the contiguous span of chunks [b n
//     / B, (b + 1) n / B), so the spans differ by at most one chunk; the
//     last round's loads are predicated and issued together;
//  4. scattered loads: a block walks its span as one flat run of 16-byte
//     loads, thread t reading int4 t, t + kThreads, ... of it (a chunk is
//     256 int4s, so a thread's int4 sits at the same place of every chunk
//     it reads), kUnroll loads issued before their adds (128 bytes a
//     thread in flight).
// experiments/k3_ablation.py times the kernel before this one (1056
// blocks each striding over the chunks, four loads in flight, 1024
// atomic adds a block, the salt copied by the wrapper) beside this one
// and beside its per-block partials without the final add.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lane_merge.cuh"

namespace {

constexpr int kChunk = 8 * 128;            // int32 words per (8, 128) chunk
constexpr int kChunkInt4 = kChunk / 4;     // 256 int4s a chunk
constexpr int kThreads = 512;              // an int4 each of two chunks a step
constexpr int kBlocksPerSm = 2;
constexpr int kUnroll = 8;                 // 16-byte loads in flight a thread

static_assert(kThreads % kChunkInt4 == 0, "a thread keeps one place of the chunk");

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
stream_words_kernel(const int4* __restrict__ words, int64_t num_chunks,
                    const int32_t* __restrict__ salt, unsigned* __restrict__ acc,
                    unsigned* __restrict__ ticket, int32_t* __restrict__ out) {
  __shared__ uint4 part[kThreads];
  const int t = threadIdx.x;
  const int64_t B = gridDim.x;
  const int64_t b = blockIdx.x;
  const int64_t begin = b * num_chunks / B * kChunkInt4;
  const int64_t end = (b + 1) * num_chunks / B * kChunkInt4;
  uint32_t a0 = 0, a1 = 0, a2 = 0, a3 = 0;
  int64_t i = begin + t;
  for (; i + (kUnroll - 1) * kThreads < end; i += kUnroll * kThreads) {
    int4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = __ldg(words + i + u * kThreads);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      a0 += static_cast<uint32_t>(v[u].x);
      a1 += static_cast<uint32_t>(v[u].y);
      a2 += static_cast<uint32_t>(v[u].z);
      a3 += static_cast<uint32_t>(v[u].w);
    }
  }
  {   // the last round: its loads issued together, predicated
    int4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      v[u] = i + u * kThreads < end ? __ldg(words + i + u * kThreads) : make_int4(0, 0, 0, 0);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      a0 += static_cast<uint32_t>(v[u].x);
      a1 += static_cast<uint32_t>(v[u].y);
      a2 += static_cast<uint32_t>(v[u].z);
      a3 += static_cast<uint32_t>(v[u].w);
    }
  }
  // the block's sum of each of the chunk's 1024 words: threads t and
  // t + 256 hold the same four words
  part[t] = make_uint4(a0, a1, a2, a3);
  __syncthreads();
  if (t < kChunkInt4) {
    const uint4 o = part[t + kChunkInt4];
    part[t] = make_uint4(a0 + o.x, a1 + o.y, a2 + o.z, a3 + o.w);
  }
  __syncthreads();
  const unsigned* sum = reinterpret_cast<const unsigned*>(part);
  for (int w = t; w < kChunk; w += kThreads) atomicAdd(acc + w, sum[w]);
  // the last block to finish: the salt, the output, the accumulator and
  // the ticket left 0
  if (!lane_merge::arrive(ticket, gridDim.x)) return;
  for (int w = t; w < kChunk; w += kThreads)
    out[w] = static_cast<int32_t>(atomicExch(acc + w, 0u) +
                                  static_cast<uint32_t>(__ldg(salt + w % 128)));
}

}  // namespace

extern "C" {

// words: (num_chunks * 8, 128) int32, 16-byte aligned; salt: (1, 128)
// int32; workspace: 1025 unsigned zeros (the accumulator, then the
// ticket; the kernel leaves them 0); out: (8, 128) int32; sms: the
// card's SMs (one wave of kBlocksPerSm blocks an SM, no more blocks than
// chunks). Returns cudaGetLastError().
int stream_words(const void* words, int64_t num_chunks, const void* salt, void* workspace,
                 void* out, int sms, void* stream) {
  if (sms < 1 || num_chunks < 1) return cudaErrorInvalidValue;
  const int blocks = static_cast<int>(
      num_chunks < (int64_t)sms * kBlocksPerSm ? num_chunks : (int64_t)sms * kBlocksPerSm);
  unsigned* acc = static_cast<unsigned*>(workspace);
  stream_words_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(words), num_chunks, static_cast<const int32_t*>(salt), acc,
      acc + kChunk, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
