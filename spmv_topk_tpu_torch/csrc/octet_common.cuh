// Pieces shared by the octet-stream kernels: K1 (octet_topk.cu), K6
// (octet_topk_batch.cu) and K4 (octet_scores.cu).
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

namespace octet {

constexpr int kLanes = 128;
constexpr int kMembers = 8;    // chunk sublanes = octet members
constexpr int kPlanCols = 8;
constexpr int kHarvest = 3;    // top 3 of 8 per octet
enum PlanCol { kWidth, kOpb, kBpo, kStride, kSliceBase, kBlkStart,
               kNumBlocks, kOctStart };

// h16 word: two halves, each col[0:10) | val6[10:16) (two's complement).
// The table index is masked to 7 bits (the TPU gather wraps, CUDA would
// read out of bounds); shifts that must not sign-extend run on uint32_t.
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

// Multi-query h16 (K6, K8). A subgroup's QG int4x8 tables (int32 (Q, 128),
// queries q0 .. q0 + nq - 1) repacked into tab[1024]: entry c (a 10-bit
// column) holds that column's signed nibble for every query, query dq at
// bits [4dq, 4dq+4), so one shared-memory gather per nnz serves the whole
// subgroup. Column c = n*128 + lane is nibble n of word `lane` of each
// table; a block's 128 threads (one per lane) fill it together.
constexpr int kH16Cols = 1024;   // h16 columns: 10-bit field

template <int QG>
__device__ __forceinline__ void repack_h16_tables(uint32_t* tab, const int32_t* tables, int q0,
                                                  int nq, int lane) {
  uint32_t qt[QG];
#pragma unroll
  for (int dq = 0; dq < QG; ++dq)
    qt[dq] = dq < nq ? static_cast<uint32_t>(__ldg(tables + (q0 + dq) * kLanes + lane)) : 0u;
#pragma unroll
  for (int n = 0; n < kH16Cols / kLanes; ++n) {
    uint32_t e = 0;
#pragma unroll
    for (int dq = 0; dq < QG; ++dq) e |= ((qt[dq] >> (4 * n)) & 0xFu) << (4 * dq);
    tab[n * kLanes + lane] = e;
  }
}

// Word u's product for each query of a repacked table: the decode of its
// two nnz (columns, 6-bit values) once, then per query its nibble to the
// top and sign-extended down (_h16_shared, _h16_apply).
template <int QG>
__device__ __forceinline__ void prod_h16_batch(uint32_t u, const uint32_t* tab, int32_t (&p)[QG]) {
  const uint32_t g0 = tab[u & 0x3FFu];
  const uint32_t g1 = tab[(u >> 16) & 0x3FFu];
  const int32_t v0 = static_cast<int32_t>(u << 16) >> 26;
  const int32_t v1 = static_cast<int32_t>(u) >> 26;
#pragma unroll
  for (int dq = 0; dq < QG; ++dq) {
    const int32_t n0 = static_cast<int32_t>(g0 << (28 - 4 * dq)) >> 28;
    const int32_t n1 = static_cast<int32_t>(g1 << (28 - 4 * dq)) >> 28;
    p[dq] = v0 * n0 + v1 * n1;
  }
}

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
// lowest-index passes. sc is consumed.
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
    for (int m = 1; m < kMembers; ++m) m1 = fmaxf(m1, sc[m]);
    int sl = 0;
#pragma unroll
    for (int m = kMembers - 1; m >= 0; --m)
      if (sc[m] == m1) sl = m;              // lowest member among ties
    topk_update<K, TIE_SAFE>(tv, tt, m1, tag0 + sl * G);
#pragma unroll
    for (int m = 0; m < kMembers; ++m)
      if (m == sl) sc[m] = -INFINITY;
  }
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

// The octet's 8 member sums of h16 products over its W chunks (int32,
// exact in any order).
__device__ __forceinline__ void octet_sums(const Octet& oc, const int32_t* tab,
                                           int32_t (&acc)[kMembers]) {
#pragma unroll
  for (int m = 0; m < kMembers; ++m) acc[m] = 0;
#pragma unroll 2
  for (int j = 0; j < oc.width; ++j) {
    const int32_t* row = oc.src + (int64_t)j * kMembers * kLanes;
#pragma unroll
    for (int m = 0; m < kMembers; ++m) acc[m] += prod_h16(__ldg(row + m * kLanes), tab);
  }
}

}  // namespace octet
