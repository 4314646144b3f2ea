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
// of REPS chunks with Q live accumulators. Here CUDA blocks grid-stride
// over the chunks, one thread per lane holding Q int32 accumulators, and
// write their sums per query; the wrapper adds them in int32 and converts
// once, so the result is bit-equal in any order. The TPU's gather reads an
// index's low 7 bits (the lab gathers raw words); the query rows sit in
// shared memory, read at index & 127.
//
// Bound. At the lab's shape (32 chunks, 128 KiB of words) a launch does a
// few microseconds of work at most, so the launch bounds it, as the lab
// says of the TPU. On a larger stream each word costs every query two
// gathers and about 10 integer operations (see lab_batch.cu): integer
// operations bound it, not its bytes.

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
int lab_mxu(const int32_t* words, const uint32_t* tables, int chunks, int queries, int nblk,
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
