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
// grid-stride over the octets of all buckets, reading the bucket plan
// (int32 rows: width, octets/block, blocks/octet, stride, slice base,
// first block, blocks, first octet) from device memory; there is no
// carry between blocks, so the TPU's block-padding octets do not exist
// here. Each block writes its buffers to out[blockIdx]; one per-lane
// torch.topk over the blocks follows (ops/kernel.py::merge_lane_topk).
//
// Bound. A query reads every packed word once (about 450 MB at the 10M x
// 1024 headline corpus) and spends about 10 integer operations and two
// shared-memory gathers per word, so the sweep should be bound by device
// memory bytes. Eight independent loads per lane per chunk keep bytes in
// flight; wider loads, cp.async/TMA rings and more lanes per thread are
// later work.
//
// h16 word: two halves, each col[0:10) | val6[10:16) (two's complement).
// The table index is masked to 7 bits (the TPU gather wraps, CUDA would
// read out of bounds); shifts that must not sign-extend run on uint32_t.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kMembers = 8;    // chunk sublanes = octet members
constexpr int kPlanCols = 8;
constexpr int kHarvest = 3;    // top 3 of 8 per octet
enum PlanCol { kWidth, kOpb, kBpo, kStride, kSliceBase, kBlkStart,
               kNumBlocks, kOctStart };

__device__ __forceinline__ int32_t prod_h16(int32_t w, const int32_t* tab) {
  const uint32_t u = static_cast<uint32_t>(w);
  const int32_t g0 = tab[u & 0x7Fu];
  const int32_t g1 = tab[(u >> 16) & 0x7Fu];
  const uint32_t sh0 = (~u >> 5) & 28u;    // 28 - 4 * (col0 >> 7)
  const uint32_t sh1 = (~u >> 21) & 28u;
  const int32_t n0 = static_cast<int32_t>(static_cast<uint32_t>(g0) << sh0) >> 28;
  const int32_t n1 = static_cast<int32_t>(static_cast<uint32_t>(g1) << sh1) >> 28;
  const int32_t v0 = static_cast<int32_t>(u << 16) >> 26;
  const int32_t v1 = w >> 26;
  return v0 * n0 + v1 * n1;
}

template <int K, bool TIE_SAFE>
__device__ __forceinline__ void topk_update(float (&tv)[K], int32_t (&tt)[K],
                                            float score, int32_t tag) {
  float cur_min = tv[0];
#pragma unroll
  for (int s = 1; s < K; ++s) cur_min = fminf(cur_min, tv[s]);
  if (!(score >= cur_min)) return;
  bool done = false;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    if (tv[s] == cur_min && !done) {
      tv[s] = score;
      tt[s] = tag;
      if (TIE_SAFE) done = true;
    }
  }
}

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
#pragma unroll
  for (int s = 0; s < K; ++s) {
    // _topk_init's distinct sentinels, rounded as f32 mul then f32 sub
    tv[s] = TIE_SAFE ? -INFINITY
                     : __fsub_rn(-2.8e38f, __fmul_rn(static_cast<float>(s), 1e32f));
    tt[s] = 0;
  }

  const int32_t* last = plan + (num_buckets - 1) * kPlanCols;
  const int total_octets = __ldg(last + kOctStart) + __ldg(last + kStride);
  int b = 0;
  for (int g = blockIdx.x; g < total_octets; g += gridDim.x) {
    // g only grows, so the bucket index only moves forward
    while (b + 1 < num_buckets && g >= __ldg(plan + (b + 1) * kPlanCols + kOctStart)) ++b;
    const int32_t* p = plan + b * kPlanCols;
    const int W = __ldg(p + kWidth);
    const int opb = __ldg(p + kOpb);
    const int bpo = __ldg(p + kBpo);
    const int G = __ldg(p + kStride);
    const int blk_start = __ldg(p + kBlkStart);
    const int o = g - __ldg(p + kOctStart);
    const int64_t base =
        bpo == 1 ? (int64_t)(blk_start + o / opb) * block_sublanes +
                       (int64_t)(o % opb) * kMembers * W
                 : ((int64_t)blk_start + (int64_t)o * bpo) * block_sublanes;
    const int32_t* src = words + base * kLanes + lane;

    int32_t acc[kMembers];
#pragma unroll
    for (int m = 0; m < kMembers; ++m) acc[m] = 0;
#pragma unroll 2
    for (int j = 0; j < W; ++j) {
      const int32_t* row = src + (int64_t)j * kMembers * kLanes;
#pragma unroll
      for (int m = 0; m < kMembers; ++m) acc[m] += prod_h16(__ldg(row + m * kLanes), tab);
    }

    const int n_real = __ldg(nreal + b);
    const int32_t tag0 = __ldg(p + kSliceBase) + o;
    float sc[kMembers];
#pragma unroll
    for (int m = 0; m < kMembers; ++m)
      sc[m] = (o + m * G < n_real) ? static_cast<float>(acc[m]) : -INFINITY;

    if (EXACT) {
#pragma unroll
      for (int m = 0; m < kMembers; ++m) topk_update<K, TIE_SAFE>(tv, tt, sc[m], tag0 + m * G);
    } else {
#pragma unroll
      for (int r = 0; r < kHarvest; ++r) {
        float m1 = sc[0];
#pragma unroll
        for (int m = 1; m < kMembers; ++m) m1 = fmaxf(m1, sc[m]);
        int sl = 0;
#pragma unroll
        for (int m = kMembers - 1; m >= 0; --m)
          if (sc[m] == m1) sl = m;            // lowest member among ties
        topk_update<K, TIE_SAFE>(tv, tt, m1, tag0 + sl * G);
#pragma unroll
        for (int m = 0; m < kMembers; ++m)
          if (m == sl) sc[m] = -INFINITY;
      }
    }
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
