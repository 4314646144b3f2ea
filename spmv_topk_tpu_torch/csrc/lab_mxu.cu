// MXU-gather lab (L8) for Hopper (sm_90a): its VPU arm, the Q-query h16
// gather-sum over a few chunks of words.
//
// Replaces experiments/mxu_gather_lab.py::vpu_kernel (:65), the
// pallas_call of mxu_gather_lab.py::run (:108). The lab's other arm, the
// one-hot matrix product (:79-97), is plain XLA there and plain torch in
// spmv_topk_tpu_torch/experiments/mxu_gather_lab.py.
//
// What it computes. out[q][lane] = float(int32 sum over every row of the
// words (chunks x 8 rows) of h16_apply(query row q, h16_shared(w))), the
// production batch decode (spmv_topk_tpu/ops/kernel.py::_h16_shared /
// _h16_apply, lab_common.cuh::H16Split). The TPU runs it as one program
// of REPS chunks with Q live accumulators. The TPU's gather reads an
// index's low 7 bits (the lab gathers raw words); the query rows sit in
// shared memory, read at index & 127.
//
// Design: one launch a call, its merge on the card.
//  - A block is kPhases x 128 threads, thread (phase, lane) holding Q int32
//    sums of its lane; block b takes the rows [b R / B, (b + 1) R / B) of
//    the R = chunks * 8 rows, so two blocks' rows differ by one at most,
//    and phase p sums rows p, p + kPhases, ... of them, kBatch rows loaded
//    before it decodes them (the first batch issued before the block waits
//    for its query table, which it loads once).
//  - The gathers: 32 lanes gathering 4-byte entries at random indices meet
//    in shared memory's banks about 3.5 deep. The table holds entry i of 4
//    queries side by side (16 bytes), group g of index i at 16-byte slot i
//    G + (g ^ ((i >> 1) & (G - 1))) for G = Q / 4 groups, so one 16-byte
//    load gathers 4 queries and the 8 lanes of each quarter-warp phase
//    fall on 8 distinct bank quads for 8 distinct values of i & 7 (about
//    2.4 deep at random).
//  - The grid (the wrapper's ``mxu_blocks``) is at most one wave of
//    kMxuBlocksPerSm blocks an SM and at least kPhases rows a block, so
//    small calls spread over the SMs instead of 512 blocks of one chunk.
//    One block an SM leaves a thread 128 registers: at 64 (two blocks an
//    SM) the 16-query sweep spilled and took 10% longer at 65536 chunks,
//    and a block's own sums are the merge's atomics.
//  - The merge, with no ticket: the block adds its phases' sums through
//    shared memory, then each (query, lane) sum once into a 64-bit counter
//    of the (Q, 128) accumulator with an atomic add of 2^48 + the sum's
//    uint32 bits: bits 0-31 hold the int32 sum (wrapping), bits 32-47
//    take the carries out of bit 31 (one an add at most, so at most one a
//    block), bits 48-63 count the blocks. The add that returns the count
//    B - 1 completes the sum: its thread converts bits 0-31 to float once,
//    writes out and leaves the counter 0 for the next call. int32 addition
//    wraps and is associative, so the result is bit-equal to the plain
//    version in any order of the blocks. The wrapper allocates the
//    accumulator once per device, stream and query count.
//
// Bound. On a large stream each word costs every query two gathers and
// about 10 integer instructions (see lab_batch.cu): integer operations
// bound it (at 512 chunks 0.005 ms on the H100), its bytes far less. At
// the lab's shape (32 chunks, 128 KiB of words) the launch bounds it, as
// the lab says of the TPU.

#include "lab_common.cuh"

namespace {

using namespace lab;

constexpr int kPhases = 4;                    // row phases of a block
constexpr int kThreads = kPhases * kLanes;    // 512
constexpr int kMxuBlocksPerSm = 1;            // mxu_gather_lab.py MXU_BLOCKS_PER_SM
constexpr int kBatch = 2;                     // rows a thread loads ahead
constexpr unsigned long long kCount = 1ull << 48;   // one block in a counter

// the 16-byte slot of group g (queries 4g .. 4g + 3) of index i
template <int G>
__device__ __forceinline__ int slot(uint32_t i, int g) {
  return static_cast<int>(i) * G + (g ^ static_cast<int>((i >> 1) & (G - 1)));
}

template <int Q>
__device__ __forceinline__ void decode(const uint4* tab, uint32_t w, int32_t (&s)[Q]) {
  constexpr int G = Q / 4;
  const H16Split sp = h16_shared(w);
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const uint4 a = tab[slot<G>(sp.i0, g)];
    const uint4 b = tab[slot<G>(sp.i1, g)];
    const uint32_t ea[4] = {a.x, a.y, a.z, a.w}, eb[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int k = 0; k < 4; ++k)
      s[4 * g + k] += sp.v0 * (static_cast<int32_t>(ea[k] << sp.sh0) >> 28) +
                      sp.v1 * (static_cast<int32_t>(eb[k] << sp.sh1) >> 28);
  }
}

template <int Q>
__global__ void __launch_bounds__(kThreads, kMxuBlocksPerSm)
lab_mxu_sweep(const int32_t* __restrict__ words, const uint32_t* __restrict__ tables, int rows,
              unsigned long long* __restrict__ acc, float* __restrict__ out) {
  static_assert(Q % kPhases == 0 && Q % 4 == 0, "4 queries a slot, Q / kPhases a phase");
  constexpr int G = Q / 4;
  __shared__ uint4 tab[G * kLanes];
  __shared__ int32_t part[kPhases * Q * kLanes];
  const int lane = threadIdx.x % kLanes;
  const int phase = threadIdx.x / kLanes;
  const int r1 = static_cast<int>(static_cast<int64_t>(rows) * (blockIdx.x + 1) / gridDim.x);
  int r = static_cast<int>(static_cast<int64_t>(rows) * blockIdx.x / gridDim.x) + phase;
  const int32_t* src = words + lane;
  uint32_t w[kBatch];
#pragma unroll
  for (int b = 0; b < kBatch; ++b) {
    const int rb = r + b * kPhases;
    w[b] = rb < r1 ? word(src + static_cast<int64_t>(rb) * kLanes) : 0u;
  }
  uint32_t* t32 = reinterpret_cast<uint32_t*>(tab);
  for (int e = threadIdx.x; e < Q * kLanes; e += kThreads) {
    const int q = e / kLanes, i = e % kLanes;
    t32[slot<G>(i, q / 4) * 4 + q % 4] = __ldg(tables + e);
  }
  __syncthreads();
  int32_t s[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) s[q] = 0;
  // whole batches, the next batch's loads issued before this one decodes
  while (r + (kBatch - 1) * kPhases < r1) {
    uint32_t cur[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) cur[b] = w[b];
    r += kBatch * kPhases;
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int rb = r + b * kPhases;
      w[b] = rb < r1 ? word(src + static_cast<int64_t>(rb) * kLanes) : 0u;
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) decode<Q>(tab, cur[b], s);
  }
  // the ragged last batch: its rows were loaded, the others are past r1
#pragma unroll
  for (int b = 0; b < kBatch - 1; ++b)
    if (r + b * kPhases < r1) decode<Q>(tab, w[b], s);
  // the block's phases added; each (query, lane) once into its counter
#pragma unroll
  for (int q = 0; q < Q; ++q) part[(phase * Q + q) * kLanes + lane] = s[q];
  __syncthreads();
#pragma unroll
  for (int j = 0; j < Q / kPhases; ++j) {
    const int q = phase + kPhases * j;
    uint32_t t = 0;
#pragma unroll
    for (int p = 0; p < kPhases; ++p) t += static_cast<uint32_t>(part[(p * Q + q) * kLanes + lane]);
    const unsigned long long add = kCount | t;
    unsigned long long* c = acc + q * kLanes + lane;
    const unsigned long long old = atomicAdd(c, add);
    if (old >> 48 == gridDim.x - 1) {   // the last block's add: the sum is whole
      out[q * kLanes + lane] = static_cast<float>(static_cast<int32_t>(old + add));
      *c = 0ull;
    }
  }
}

template <int Q>
void launch(int nblk, cudaStream_t stream, const int32_t* words, const uint32_t* tables,
            int rows, unsigned long long* acc, float* out) {
  lab_mxu_sweep<Q><<<nblk, kThreads, 0, stream>>>(words, tables, rows, acc, out);
}

}  // namespace

extern "C" {

// words: (chunks * 8, 128) int32; tables: (queries, 128) int32 int4x8
// rows, queries 4 or 16; nblk: the CUDA grid (at most kMxuBlocksPerSm an
// SM, below 2^16: the counters' fields); acc: (queries, 128) uint64 zeros
// (the kernel leaves them 0); out: (queries, 128) float32. Returns
// cudaGetLastError() (or cudaErrorInvalidValue for arguments the kernel
// does not take).
int lab_mxu(const int32_t* words, const uint32_t* tables, int chunks, int queries, int nblk,
            unsigned long long* acc, float* out, void* stream) {
  if (chunks < 1 || nblk < 1 || nblk >= (1 << 16)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = chunks * kChunk;
  switch (queries) {
    case 4: launch<4>(nblk, s, words, tables, rows, acc, out); break;
    case 16: launch<16>(nblk, s, words, tables, rows, acc, out); break;
    default: return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
