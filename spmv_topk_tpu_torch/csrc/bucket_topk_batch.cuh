// Per-bucket Top-K of Q queries (kernel K12) for Hopper (sm_90a), every
// query codec (codecs.cuh). bucket_topk_batch.cu holds the h16 and f32
// instantiations and the C entry point, bucket_topk_batch_q.cu the
// int8x4 / i8s / i4s ones (a translation unit of their own, built in
// parallel).
//
// Replaces spmv_topk_tpu/ops/kernel.py::_bucket_kernel_batch (the
// pallas_call of topk_spmv_bucket_batch_device).
//
// What it computes. For each of Q queries, every real slice's 128 row
// scores, each folded into that query's per-lane (value, tag) buffers of
// lane_k entries by argmin replacement, the tag the global slice id
// slice_base + s. The JAX kernel keeps one (8, 128) accumulator per query
// (not K13's two), so a query's sums run over the chunks in order in one
// accumulator per row of a chunk, then the 8 rows by halving_sum; h16 in
// int32. As in the JAX kernel the query-independent part of a word's
// decode (_codec_split's shared part) is done once per subgroup and
// applied per query (codecs.cuh::Batch, H16Batch).
//
// Design. K8's: up to 8 queries (the subgroup, cfg.batch_subgroup) live in
// one CUDA block of 128 threads, one per lane; their sums and buffers in
// registers, sized for QG, the subgroup rounded up to a power of two; the
// subgroup's tables in shared memory (h16 repacked so that one gather
// serves the subgroup; the float codecs side by side, cut to what fits,
// ops/kernel.py::tables_in_smem; f32 tables past one block's shared
// memory read from global memory, Batch<F32Global>). The grid is (slots) x
// (subgroups), subgroup fastest; each block takes slices in turn and
// writes its buffers to out[q][slot], merged by one per-lane torch.topk
// per query. Tie-safe or not is a run-time branch.
//
// Bound. Per word: one coalesced load, the shared decode, and per live
// query a gather and 2-4 arithmetic operations; the bucket is read once
// per subgroup. At 8 queries the per-query work outweighs the bytes, as
// for K8, so it should be bound by the SMs' instruction throughput.

#pragma once

#include "bucket_common.cuh"

namespace k12 {

using namespace bucket;

// Row r's sum over the chunks for every live query, in chunk order from 0.
template <class B, int QG>
__device__ __forceinline__ void row_sums(const int32_t* src, int chunks, int r,
                                         const Table<unsigned char>& tab, int nq,
                                         float (&p)[QG]) {
  typename B::Acc acc[QG];
#pragma unroll
  for (int dq = 0; dq < QG; ++dq) acc[dq] = 0;
#pragma unroll 2
  for (int u = 0; u < chunks; ++u) B::template add<QG>(acc, word(src, u * kChunk + r), tab, nq);
#pragma unroll
  for (int dq = 0; dq < QG; ++dq) p[dq] = acc[dq];
}

// One slice's score for every live query (halving_sum of row_sums per
// query for the float codecs; h16 every word in int32).
template <class B, int QG>
__device__ __forceinline__ void slice_scores(const int32_t* src, int chunks,
                                             const Table<unsigned char>& tab, int nq,
                                             float (&sc)[QG]) {
  if constexpr (B::kExact) {
    typename B::Acc acc[QG];
#pragma unroll
    for (int dq = 0; dq < QG; ++dq) acc[dq] = 0;
#pragma unroll 2
    for (int r = 0; r < chunks * kChunk; ++r) B::template add<QG>(acc, word(src, r), tab, nq);
#pragma unroll
    for (int dq = 0; dq < QG; ++dq) sc[dq] = B::finish(acc[dq]);
  } else {
    // c[h] = (p_h + p_{h+4}) + (p_{h+2} + p_{h+6}); score = c[0] + c[1]
    float c[2][QG];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float a[QG], b[QG], x[QG];
      row_sums<B, QG>(src, chunks, h, tab, nq, a);
      row_sums<B, QG>(src, chunks, h + 4, tab, nq, b);
#pragma unroll
      for (int dq = 0; dq < QG; ++dq) x[dq] = __fadd_rn(a[dq], b[dq]);
      row_sums<B, QG>(src, chunks, h + 2, tab, nq, a);
      row_sums<B, QG>(src, chunks, h + 6, tab, nq, b);
#pragma unroll
      for (int dq = 0; dq < QG; ++dq) c[h][dq] = __fadd_rn(x[dq], __fadd_rn(a[dq], b[dq]));
    }
#pragma unroll
    for (int dq = 0; dq < QG; ++dq) sc[dq] = __fadd_rn(c[0][dq], c[1][dq]);
  }
}

template <class B, int K, int QG>
__global__ void __launch_bounds__(kLanes)
bucket_topk_batch_kernel(const int32_t* __restrict__ words, const void* __restrict__ tables,
                         const int32_t* __restrict__ num_real, int num_slices, int width,
                         int table_rows, int shift, bool tie_safe, int slice_base,
                         int num_queries, int subgroup, int num_subgroups,
                         float* __restrict__ out_v, int32_t* __restrict__ out_t) {
  static_assert(QG >= 1 && QG <= 8, "an h16 table entry holds 8 nibbles");
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x;
  const int sg = blockIdx.x % num_subgroups;
  const int slot = blockIdx.x / num_subgroups;
  const int num_slots = gridDim.x / num_subgroups;
  const int q0 = sg * subgroup;
  const int nq = min(subgroup, num_queries - q0);   // <= QG
  const auto tab = B::template load<QG>(smem, tables, q0, nq, table_rows, shift, lane);
  __syncthreads();

  float tv[QG][K];
  int32_t tt[QG][K];
#pragma unroll
  for (int dq = 0; dq < QG; ++dq) topk_init<K>(tv[dq], tt[dq], tie_safe);

  const int chunks = width / kChunk;
  const int n = real_slices(num_real, num_slices);
  for (int s = slot; s < n; s += num_slots) {
    float sc[QG];
    slice_scores<B, QG>(words + (int64_t)s * width * kLanes + lane, chunks, tab, nq, sc);
#pragma unroll
    for (int dq = 0; dq < QG; ++dq) {
      if (dq >= nq) break;
      topk_update<K>(tv[dq], tt[dq], sc[dq], slice_base + s, tie_safe);
    }
  }

#pragma unroll
  for (int dq = 0; dq < QG; ++dq) {
    if (dq >= nq) break;
    const int64_t out0 = ((int64_t)(q0 + dq) * num_slots + slot) * K * kLanes + lane;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      out_v[out0 + k * kLanes] = tv[dq][k];
      out_t[out0 + k * kLanes] = tt[dq][k];
    }
  }
}

struct Args {
  const int32_t* words;
  const void* tables;
  const int32_t* num_real;
  int codec, num_slices, width, table_rows, shift, lane_k, slice_base, num_queries, subgroup,
      num_subgroups, num_cuda_blocks;
  bool tie_safe;
  float* out_v;
  int32_t* out_t;
  cudaStream_t stream;
};

template <class B, int K, int QG>
cudaError_t launch(const Args& a) {
  auto kernel = bucket_topk_batch_kernel<B, K, QG>;
  const size_t smem = B::smem_bytes(QG, a.table_rows);
  const cudaError_t err = codec::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<a.num_cuda_blocks, kLanes, smem, a.stream>>>(
      a.words, a.tables, a.num_real, a.num_slices, a.width, a.table_rows, a.shift, a.tie_safe,
      a.slice_base, a.num_queries, a.subgroup, a.num_subgroups, a.out_v, a.out_t);
  return cudaSuccess;
}

template <class B, int K>
cudaError_t launch_k(const Args& a) {
  if (a.subgroup == 1) return launch<B, K, 1>(a);
  if (a.subgroup == 2) return launch<B, K, 2>(a);
  if (a.subgroup <= 4) return launch<B, K, 4>(a);
  return launch<B, K, 8>(a);
}

// Launches the sweep for the codecs of `only` (codec::dispatch).
template <unsigned only>
cudaError_t launch_codecs(const Args& a) {
  return codec::dispatch<only>(a.codec, [&](auto tag) {
    using B = typename codec::BatchOf<typename decltype(tag)::type>::type;
    switch (a.lane_k) {
      case 4: return launch_k<B, 4>(a);
      case 8: return launch_k<B, 8>(a);
      case 16: return launch_k<B, 16>(a);
      default: return cudaErrorInvalidValue;
    }
  });
}

// int8x4, i8s and i4s (bucket_topk_batch_q.cu).
cudaError_t launch_quantized(const Args& a);

}  // namespace k12
