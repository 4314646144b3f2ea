// Pieces shared by the per-bucket kernels: K11 (bucket_scores.cu), K13
// (bucket_topk.cu) and K12 (bucket_topk_batch.cuh).
//
// One bucket of formats/sell_buckets.py::pack_sell_buckets is
// num_slices = num_blocks * slices_per_block slices of W rows x 128 lanes
// of int32 words, slice s on rows s*W .. (s+1)*W - 1; lane l of a slice is
// one matrix row. The JAX kernels (spmv_topk_tpu/ops/kernel.py::
// _bucket_scores_kernel, _bucket_kernel, _bucket_kernel_batch) read a
// slice as W // 8 chunks of (8, 128) words and keep (8, 128) accumulators,
// so a lane's score is built from 8 partial sums, one per row of a chunk,
// reduced at the end; a width that is not a multiple of 8 loses its last
// W % 8 rows, and a width below 8 scores 0. The kernels here read the
// same W // 8 chunks and add in the same order (ops/kernel.py::
// _bucket_sums): for the float codecs each add is rounded apart (no FMA),
// so a kernel and its plain version agree bit for bit; h16 sums are int32,
// exact in any order.

#pragma once

#include "octet_common.cuh"

namespace bucket {

constexpr int kLanes = 128;
constexpr int kChunk = 8;   // rows per chunk of the JAX kernels

using codec::Table;

__device__ __forceinline__ uint32_t word(const int32_t* src, int row) {
  return static_cast<uint32_t>(__ldg(src + (int64_t)row * kLanes));
}

// The 8 partial sums p(0) .. p(7) of a lane reduced as XLA's CPU backend
// reduces the JAX kernels' accumulator over its rows (jnp.sum(acc,
// axis=0)) in most interpret-mode programs: a halving tree,
// ((p0 + p4) + (p2 + p6)) + ((p1 + p5) + (p3 + p7)).
template <class P>
__device__ __forceinline__ float halving_sum(P p) {
  const float c0 = __fadd_rn(__fadd_rn(p(0), p(4)), __fadd_rn(p(2), p(6)));
  const float c1 = __fadd_rn(__fadd_rn(p(1), p(5)), __fadd_rn(p(3), p(7)));
  return __fadd_rn(c0, c1);
}

// Chunks a load step of slice_score reads (an even and an odd one).
constexpr int kStep = 2;

// One slice's score for a single-query codec C, in the order of
// _bucket_kernel and _bucket_scores_kernel (K13, K11): h16 sums every
// word of the W // 8 chunks in int32; the float codecs sum row r of each
// chunk over the chunks in two accumulators by chunk parity (the JAX
// kernels' two alternating (8, 128) accumulators, one when W // 8 < 2),
// add the two, and reduce the 8 rows by halving_sum. The chunks are the
// outer loop: each step loads kStep chunks (16 words, W x 512 contiguous
// bytes a slice) before any of their adds, so a thread keeps 16 loads in
// flight, and the 8 rows' accumulators stay in registers (a step of 4
// measured no faster: PERF.md); chunk c of a float codec goes to the even
// or the odd accumulators of its 8 rows by its parity, an odd last chunk
// alone. h16's int32 sum is exact in any order (one accumulator). src:
// the lane's word of row 0.
template <class C>
__device__ __forceinline__ float slice_score(const int32_t* src, int chunks,
                                             const Table<typename C::Tab>& tab) {
  static_assert(kStep == 2, "a step holds one (even, odd) chunk pair");
  constexpr int N = kStep * kChunk;
  if constexpr (C::kExact) {
    typename C::Acc acc = 0;
    int u = 0;
    for (; u + kStep <= chunks; u += kStep) {
      uint32_t w[N];
#pragma unroll
      for (int i = 0; i < N; ++i) w[i] = word(src, u * kChunk + i);
#pragma unroll
      for (int i = 0; i < N; ++i) acc = C::add(acc, w[i], tab);
    }
    if (u < chunks) {
      uint32_t w[kChunk];
#pragma unroll
      for (int r = 0; r < kChunk; ++r) w[r] = word(src, u * kChunk + r);
#pragma unroll
      for (int r = 0; r < kChunk; ++r) acc = C::add(acc, w[r], tab);
    }
    return C::finish(acc);
  } else {
    float even[kChunk], odd[kChunk];
#pragma unroll
    for (int r = 0; r < kChunk; ++r) even[r] = odd[r] = 0.0f;
    int u = 0;
    for (; u + kStep <= chunks; u += kStep) {
      uint32_t w[N];
#pragma unroll
      for (int i = 0; i < N; ++i) w[i] = word(src, u * kChunk + i);
#pragma unroll
      for (int r = 0; r < kChunk; ++r) {
        even[r] = C::add(even[r], w[r], tab);
        odd[r] = C::add(odd[r], w[kChunk + r], tab);
      }
    }
    if (u < chunks) {
      uint32_t w[kChunk];
#pragma unroll
      for (int r = 0; r < kChunk; ++r) w[r] = word(src, u * kChunk + r);
#pragma unroll
      for (int r = 0; r < kChunk; ++r) even[r] = C::add(even[r], w[r], tab);
    }
    return halving_sum([&](int r) { return __fadd_rn(even[r], odd[r]); });
  }
}

// The lane buffers' argmin replacement and initial entries, tie-safe or
// not at run time (octet_common.cuh): one branch per slice, uniform across
// the block, in place of a template argument per mode.
template <int K>
__device__ __forceinline__ void topk_init(float (&tv)[K], int32_t (&tt)[K], bool tie_safe) {
  if (tie_safe)
    octet::topk_init<K, true>(tv, tt);
  else
    octet::topk_init<K, false>(tv, tt);
}

template <int K>
__device__ __forceinline__ void topk_update(float (&tv)[K], int32_t (&tt)[K], float score,
                                            int32_t tag, bool tie_safe) {
  if (tie_safe)
    octet::topk_update<K, true>(tv, tt, score, tag);
  else
    octet::topk_update<K, false>(tv, tt, score, tag);
}

// The slices a Top-K kernel folds: those before the bucket's real count
// (the JAX kernels add -inf to the others, which changes no value).
__device__ __forceinline__ int real_slices(const int32_t* num_real, int num_slices) {
  return min(num_slices, max(__ldg(num_real), 0));
}

}  // namespace bucket
