// Octet Top-K sweep of the h16 stream (kernel K1) for Hopper (sm_90a).
//
// Replaces spmv_topk_tpu/ops/kernel.py::_fused_kernel_octet together with
// its _octet_multicall dispatch: one launch sweeps every bucket.
//
// What it computes. The stream (formats/sell_buckets.py::
// fuse_buckets_octet) is a sequence of octets; chunk j (8 sublanes x 128
// lanes of int32) of octet o holds word j of the eight member slices
// slice_base + o + m*stride, m = 0..7, one per sublane. Each lane is one
// row of its slice. A lane adds up the decoded products of the octet's W
// chunks into 8 int32 member scores, converts them to float once, sets
// members past the bucket's real slices to -inf, and harvests them into
// its own lane_k-entry (value, slice tag) buffer: the top 3 of the 8 in
// three max / lowest-index passes, or each member in turn when
// fold_tile == 1 (EXACT). The buffer update is argmin replacement
// (_topk_update): replace the first minimum (TIE_SAFE) or every slot that
// holds the minimum, when score >= minimum.
//
// Design. One CUDA block of 128 threads is the 128 lanes of one octet at
// a time, so a warp reads 128 contiguous bytes of every sublane row and
// a block 4 KB per chunk. The h16 query table (128 int32) sits in shared
// memory; the lane buffers and the 8 accumulators sit in registers
// (lane_k is a template parameter, so every index is static). Blocks
// grid-stride over the octets of all buckets (octet_common.cuh::locate);
// there is no carry between blocks, so the TPU's block-padding octets do
// not exist here. Each block writes its buffers to out[blockIdx]; one
// per-lane torch.topk over the blocks follows (ops/kernel.py::
// merge_lane_topk).
//
// Bound. A query reads every packed word once (about 450 MB at the 10M x
// 1024 headline corpus) and spends about 10 integer operations and two
// shared-memory gathers per word, so the sweep should be bound by device
// memory bytes. Eight independent loads per lane per chunk keep bytes in
// flight; wider loads, cp.async/TMA rings and more lanes per thread are
// later work.

#include "octet_common.cuh"

namespace {

using namespace octet;

template <int K, bool TIE_SAFE, bool EXACT>
__global__ void __launch_bounds__(kLanes)
octet_topk_kernel(const int32_t* __restrict__ words,
                  const int32_t* __restrict__ table,
                  const int32_t* __restrict__ nreal,
                  const int32_t* __restrict__ plan, int num_buckets,
                  int block_sublanes, float* __restrict__ out_v,
                  int32_t* __restrict__ out_t) {
  __shared__ int32_t tab[kLanes];
  const int lane = threadIdx.x;
  tab[lane] = table[lane];
  __syncthreads();

  float tv[K];
  int32_t tt[K];
  topk_init<K, TIE_SAFE>(tv, tt);

  const int total = total_octets(plan, num_buckets);
  int b = 0;
  for (int g = blockIdx.x; g < total; g += gridDim.x) {
    const Octet oc = locate(words, plan, nreal, num_buckets, block_sublanes, g, b, lane);
    int32_t acc[kMembers];
    octet_sums(oc, tab, acc);
    float sc[kMembers];
#pragma unroll
    for (int m = 0; m < kMembers; ++m)
      sc[m] = (oc.index + m * oc.stride < oc.n_real) ? static_cast<float>(acc[m]) : -INFINITY;
    harvest<K, TIE_SAFE, EXACT>(tv, tt, sc, oc.slice0, oc.stride);
  }

  const int64_t out0 = (int64_t)blockIdx.x * K * kLanes + lane;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    out_v[out0 + s * kLanes] = tv[s];
    out_t[out0 + s * kLanes] = tt[s];
  }
}

template <int K, bool TIE_SAFE, bool EXACT>
void launch(const int32_t* words, const int32_t* table, const int32_t* nreal,
            const int32_t* plan, int num_buckets, int block_sublanes,
            int num_cuda_blocks, float* out_v, int32_t* out_t,
            cudaStream_t stream) {
  octet_topk_kernel<K, TIE_SAFE, EXACT><<<num_cuda_blocks, kLanes, 0, stream>>>(
      words, table, nreal, plan, num_buckets, block_sublanes, out_v, out_t);
}

template <int K>
void launch_k(bool tie_safe, bool exact, const int32_t* words,
              const int32_t* table, const int32_t* nreal, const int32_t* plan,
              int num_buckets, int block_sublanes, int num_cuda_blocks,
              float* out_v, int32_t* out_t, cudaStream_t stream) {
  if (tie_safe && exact)
    launch<K, true, true>(words, table, nreal, plan, num_buckets, block_sublanes, num_cuda_blocks, out_v, out_t, stream);
  else if (tie_safe)
    launch<K, true, false>(words, table, nreal, plan, num_buckets, block_sublanes, num_cuda_blocks, out_v, out_t, stream);
  else if (exact)
    launch<K, false, true>(words, table, nreal, plan, num_buckets, block_sublanes, num_cuda_blocks, out_v, out_t, stream);
  else
    launch<K, false, false>(words, table, nreal, plan, num_buckets, block_sublanes, num_cuda_blocks, out_v, out_t, stream);
}

}  // namespace

extern "C" {

// words: (num_blocks * block_sublanes, 128) int32; table: (1, 128) int32;
// nreal: (num_buckets,) int32; plan: (num_buckets, 8) int32;
// out_v/out_t: (num_cuda_blocks, lane_k, 128). Returns cudaGetLastError().
int octet_topk_h16(const int32_t* words, const int32_t* table,
                   const int32_t* nreal, const int32_t* plan, int num_buckets,
                   int block_sublanes, int lane_k, int exact, int tie_safe,
                   int num_cuda_blocks, float* out_v, int32_t* out_t,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_buckets < 1 || num_cuda_blocks < 1) return cudaErrorInvalidValue;
  switch (lane_k) {
    case 4:
      launch_k<4>(tie_safe, exact, words, table, nreal, plan, num_buckets, block_sublanes, num_cuda_blocks, out_v, out_t, s);
      break;
    case 8:
      launch_k<8>(tie_safe, exact, words, table, nreal, plan, num_buckets, block_sublanes, num_cuda_blocks, out_v, out_t, s);
      break;
    case 16:
      launch_k<16>(tie_safe, exact, words, table, nreal, plan, num_buckets, block_sublanes, num_cuda_blocks, out_v, out_t, s);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
