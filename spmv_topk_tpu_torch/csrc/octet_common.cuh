// Pieces shared by the octet-stream kernels: K1 (octet_topk.cuh), K6
// (octet_topk_batch.cuh) and K4 (octet_scores.cu); the Top-K buffers and
// partitions serve the slice kernels too.
//
// The stream (formats/sell_buckets.py::fuse_buckets_octet) is a sequence
// of octets; chunk j (8 sublanes x 128 lanes of int32) of octet o holds
// word j of the eight member slices slice_base + o + m*stride, m = 0..7,
// one per sublane. The bucket plan is an int32 (B, 8) table (ops/kernel.py
// ::octet_plan_rows). A CUDA block grid-strides over the octets of all
// buckets; locate() turns a global octet index into its bucket and the
// address of its first word, for the block's lane. A partitioned stream
// is P such streams on one plan; the grid's y index is the partition
// (partition()).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "codecs.cuh"

namespace octet {

constexpr int kLanes = 128;
constexpr int kMembers = 8;    // chunk sublanes = octet members
constexpr int kPlanCols = 8;
constexpr int kHarvest = 3;    // top 3 of 8 per octet
enum PlanCol { kWidth, kOpb, kBpo, kStride, kSliceBase, kBlkStart,
               kNumBlocks, kOctStart };

// _topk_init's distinct sentinels (rounded as f32 mul then f32 sub), or
// -inf for tie-safe buffers.
template <int K, bool TIE_SAFE>
__device__ __forceinline__ void topk_init(float (&tv)[K], int32_t (&tt)[K]) {
#pragma unroll
  for (int s = 0; s < K; ++s) {
    tv[s] = TIE_SAFE ? -INFINITY
                     : __fsub_rn(-2.8e38f, __fmul_rn(static_cast<float>(s), 1e32f));
    tt[s] = 0;
  }
}

// Argmin replacement (_topk_update): when score >= the buffer minimum,
// replace the first minimum (TIE_SAFE) or every slot holding it.
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

// Harvest one octet's 8 member scores into a lane buffer: each member in
// turn (EXACT, fold_tile 1) or the top 3 of the 8 in three max /
// lowest-index passes. sc is consumed. The max propagates NaN as the JAX
// kernels' jnp.max does: a NaN member makes every pass's maximum NaN,
// which no member equals and the buffer never admits, so nothing of that
// octet enters the lane's buffer.
template <int K, bool TIE_SAFE, bool EXACT>
__device__ __forceinline__ void harvest(float (&tv)[K], int32_t (&tt)[K],
                                        float (&sc)[kMembers], int32_t tag0,
                                        int G) {
  if (EXACT) {
#pragma unroll
    for (int m = 0; m < kMembers; ++m) topk_update<K, TIE_SAFE>(tv, tt, sc[m], tag0 + m * G);
    return;
  }
#pragma unroll
  for (int r = 0; r < kHarvest; ++r) {
    float m1 = sc[0];
#pragma unroll
    for (int m = 1; m < kMembers; ++m) m1 = (sc[m] > m1 || sc[m] != sc[m]) ? sc[m] : m1;
    int sl = kMembers;                       // none holds a NaN maximum
#pragma unroll
    for (int m = kMembers - 1; m >= 0; --m)
      if (sc[m] == m1) sl = m;              // lowest member among ties
    topk_update<K, TIE_SAFE>(tv, tt, m1, tag0 + sl * G);
#pragma unroll
    for (int m = 0; m < kMembers; ++m)
      if (m == sl) sc[m] = -INFINITY;
  }
}

// The smallest value of a lane buffer.
template <int K>
__device__ __forceinline__ float buffer_min(const float (&tv)[K]) {
  float m = tv[0];
#pragma unroll
  for (int s = 1; s < K; ++s) m = fminf(m, tv[s]);
  return m;
}

// harvest of the octet's member scores sc (consumed) into a lane buffer
// whose minimum tmin is kept beside it (K6, K1): the same
// replacements, but a round of the top-3 fold whose candidate is below
// the minimum ends the harvest (the later rounds' candidates are no
// larger, and the minimum only rises), and the minimum is found once per
// replacement, not per round.
template <int K, bool TIE_SAFE, bool EXACT>
__device__ __forceinline__ void harvest_above(float (&tv)[K], int32_t (&tt)[K], float& tmin,
                                              float (&sc)[kMembers], int32_t tag0, int G) {
  if (EXACT) {
    harvest<K, TIE_SAFE, true>(tv, tt, sc, tag0, G);
    tmin = buffer_min(tv);
    return;
  }
#pragma unroll
  for (int r = 0; r < kHarvest; ++r) {
    float m1 = sc[0];
#pragma unroll
    for (int m = 1; m < kMembers; ++m) m1 = (sc[m] > m1 || sc[m] != sc[m]) ? sc[m] : m1;
    if (!(m1 >= tmin)) return;   // a NaN maximum too: harvest's NaN rule
    int sl = kMembers;
#pragma unroll
    for (int m = kMembers - 1; m >= 0; --m)
      if (sc[m] == m1) sl = m;   // lowest member among ties
    bool done = false;
#pragma unroll
    for (int s = 0; s < K; ++s) {   // topk_update's replacement
      if (tv[s] == tmin && !done) {
        tv[s] = m1;
        tt[s] = tag0 + sl * G;
        if (TIE_SAFE) done = true;
      }
    }
    tmin = buffer_min(tv);
#pragma unroll
    for (int m = 0; m < kMembers; ++m)
      if (m == sl) sc[m] = -INFINITY;
  }
}

// The row-order store of the SpMV kernels (K4, octet_scores.cu; K9,
// slice_scores.cu): the stream and the row ids are loaded cache-streaming
// (__ldcs: L2 evict-first), the scattered 4-byte row stores made with an
// L2 evict-last policy (createpolicy, sm_80 and later), so that the L2
// holds the 40 MB of rows while the stream passes through it, and each
// 32-byte sector of rows until its rows are written.
__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t p;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
  return p;
}

__device__ __forceinline__ void store_kept(float* p, float v, uint64_t policy) {
  asm volatile("st.global.L2::cache_hint.f32 [%0], %1, %2;" ::"l"(p), "f"(v), "l"(policy)
               : "memory");
}

// Partition blockIdx.y of a partition-major stream (formats/
// sell_buckets.py::PartitionedFusedMatrix; an unpartitioned stream is
// partition 0 of 1): its blocks start part_rows rows into the words, its
// real-slice counts num_buckets into nreal ((P, B) int32), and its slice
// tags part_slices into the stacked row_ids (the JAX kernels' toff). Each
// CUDA block works inside one partition, so its lane buffers hold that
// partition's candidates only.
struct Partition {
  const int32_t* words;
  const int32_t* nreal;
  int tag_offset;
};

__device__ __forceinline__ Partition partition(const int32_t* words, const int32_t* nreal,
                                               int num_buckets, int part_rows,
                                               int part_slices) {
  const int p = blockIdx.y;
  return {words + (int64_t)p * part_rows * kLanes, nreal + (int64_t)p * num_buckets,
          p * part_slices};
}

__device__ __forceinline__ int total_octets(const int32_t* plan, int num_buckets) {
  const int32_t* last = plan + (num_buckets - 1) * kPlanCols;
  return __ldg(last + kOctStart) + __ldg(last + kStride);
}

// One octet of the stream, as a lane sees it.
struct Octet {
  const int32_t* src;   // the lane's word of chunk 0, member 0
  int width;            // chunks (W)
  int stride;           // member stride (G)
  int index;            // octet index o within its bucket
  int slice0;           // slice id of member 0: slice_base + o
  int n_real;           // real slices of the bucket
};

// Global octet g; b is the bucket of the previous call (start at 0), and
// only moves forward, so g must not decrease between calls.
__device__ __forceinline__ Octet locate(const int32_t* words,
                                        const int32_t* plan,
                                        const int32_t* nreal, int num_buckets,
                                        int block_sublanes, int g, int& b,
                                        int lane) {
  while (b + 1 < num_buckets && g >= __ldg(plan + (b + 1) * kPlanCols + kOctStart)) ++b;
  const int32_t* p = plan + b * kPlanCols;
  Octet oc;
  oc.width = __ldg(p + kWidth);
  oc.stride = __ldg(p + kStride);
  oc.index = g - __ldg(p + kOctStart);
  oc.slice0 = __ldg(p + kSliceBase) + oc.index;
  oc.n_real = __ldg(nreal + b);
  const int opb = __ldg(p + kOpb);
  const int bpo = __ldg(p + kBpo);
  const int blk_start = __ldg(p + kBlkStart);
  // a wide octet (bpo > 1) starts a span of bpo blocks; its chunks are
  // contiguous, so one base address serves both cases
  const int64_t base =
      bpo == 1 ? (int64_t)(blk_start + oc.index / opb) * block_sublanes +
                     (int64_t)(oc.index % opb) * kMembers * oc.width
               : ((int64_t)blk_start + (int64_t)oc.index * bpo) * block_sublanes;
  oc.src = words + base * kLanes + lane;
  return oc;
}

// The octet's 8 member scores for a single-query codec C, in the JAX
// kernels' order (_fused_kernel_octet, _fused_scores_kernel_octet): h16
// sums its W chunks in int32 (exact in any order) and converts once. The
// float codecs add the even and the odd chunks of each block span (the
// octet's chunks in one block; a wide octet spans several) into two
// accumulators from 0 and then the two together; a wide octet adds its
// span sums in block order from 0 (the TPU kernel's carry). STREAM:
// each word loaded cache-streaming (K4's row-order store: the stream
// leaves L2 first), else through the read-only path.
template <class C, bool STREAM = false>
__device__ __forceinline__ void octet_sums(const Octet& oc, const codec::Table<typename C::Tab>& t,
                                           int chunks_per_block, float (&sc)[kMembers]) {
  const auto word = [](const int32_t* p) -> uint32_t {
    if constexpr (STREAM) return static_cast<uint32_t>(__ldcs(p));
    return static_cast<uint32_t>(__ldg(p));
  };
  if constexpr (C::kExact) {
    typename C::Acc acc[kMembers];
#pragma unroll
    for (int m = 0; m < kMembers; ++m) acc[m] = 0;
#pragma unroll 2
    for (int j = 0; j < oc.width; ++j) {
      const int32_t* row = oc.src + (int64_t)j * kMembers * kLanes;
#pragma unroll
      for (int m = 0; m < kMembers; ++m)
        acc[m] = C::add(acc[m], word(row + m * kLanes), t);
    }
#pragma unroll
    for (int m = 0; m < kMembers; ++m) sc[m] = C::finish(acc[m]);
  } else {
    const bool wide = oc.width > chunks_per_block;
#pragma unroll
    for (int m = 0; m < kMembers; ++m) sc[m] = 0.0f;
    for (int j0 = 0; j0 < oc.width; j0 += chunks_per_block) {
      const int j1 = min(oc.width, j0 + chunks_per_block);
      float even[kMembers], odd[kMembers];
#pragma unroll
      for (int m = 0; m < kMembers; ++m) even[m] = odd[m] = 0.0f;
      int j = j0;
      for (; j + 1 < j1; j += 2) {
        const int32_t* row = oc.src + (int64_t)j * kMembers * kLanes;
#pragma unroll
        for (int m = 0; m < kMembers; ++m) {
          even[m] = C::add(even[m], word(row + m * kLanes), t);
          odd[m] = C::add(odd[m], word(row + (kMembers + m) * kLanes), t);
        }
      }
      if (j < j1) {
        const int32_t* row = oc.src + (int64_t)j * kMembers * kLanes;
#pragma unroll
        for (int m = 0; m < kMembers; ++m)
          even[m] = C::add(even[m], word(row + m * kLanes), t);
      }
#pragma unroll
      for (int m = 0; m < kMembers; ++m) {
        const float part = __fadd_rn(even[m], odd[m]);
        sc[m] = wide ? __fadd_rn(sc[m], part) : part;
      }
    }
  }
}

}  // namespace octet
