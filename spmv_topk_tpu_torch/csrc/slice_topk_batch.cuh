// Multi-query slice-stream Top-K sweep (kernel K8; K10c with partitions)
// for Hopper (sm_90a), every query codec (codecs.cuh). slice_topk_batch.cu
// holds the h16 and f32 instantiations and the C entry point,
// slice_topk_batch_q.cu the int8x4 / i8s / i4s ones (a translation unit of
// their own, built in parallel).
//
// Replaces spmv_topk_tpu/ops/kernel.py::_fused_kernel_batch (the
// pallas_calls of topk_spmv_fused_batch_device and, with P row
// partitions, topk_spmv_fused_batch_part_device: the partition is the
// grid's y index, as in K7, and each query keeps a pool per partition,
// (Q, P, lane_k, 128) after the merge).
//
// What it computes. For each of Q queries, every real slice's 128 row
// scores (as K7 and K9 compute them), each folded into that query's
// per-lane (value, slice tag) buffers of lane_k entries by argmin
// replacement. The JAX batch kernel has no tiled fold: it folds every
// slice whatever fold_tile is, and so does this one (work items are runs
// of slices and wide slices). As in the JAX kernel the query-independent
// part of a word's decode (_codec_split: columns, values) is done once
// and applied per query.
//
// Design. Up to 8 queries (cfg.batch_subgroup) are live in one CUDA block
// of 128 threads, one per lane; their sums and buffer pairs sit in
// registers, sized for QG, the subgroup rounded up to a power of two.
// h16: the subgroup's int4x8 tables are repacked in shared memory as in
// K6 (codecs.cuh::H16Batch), entry c (a 10-bit column) holding that
// column's nibble for every query of the subgroup, so one gather per nnz
// serves all of them. The other codecs: the subgroup's tables side by
// side (codecs.cuh::Batch), QG x table_rows x 512 bytes (32 KB for 8 f32
// queries at 1024 columns, 8 KB for int8x4 or i8s, 4 KB for i4s), one
// gather per query per nnz; the wrapper cuts the subgroup to the tables
// that fit a block's shared memory (ops/kernel.py::tables_in_smem: 227 KB
// on the H100, so one f32 table up to 58,112 columns), and past one f32
// table the subgroup's tables are gathered from global memory through
// the read-only path (Batch<F32Global>: 256 KB a query at 65,536 columns,
// which L2 holds). The grid is (slots) x (subgroups), subgroup
// fastest, so the blocks that read the same work items for different
// subgroups are launch neighbours and can meet in L2; each block writes
// its buffers to out[q][slot] and one per-lane torch.topk per query merges
// the slots.
//
// Bound. Per word: one coalesced load, the shared decode, and per live
// query a gather and 2-4 arithmetic operations. With 32 queries the
// per-query work outweighs the bytes (the stream is read once per
// subgroup), so the sweep should be bound by the SMs' instruction
// throughput rather than by device memory.

#pragma once

#include "slice_common.cuh"

namespace k8 {

using namespace slice;

template <class C, int QG>
__device__ __forceinline__ void rows_sums(const int32_t* src, int rows,
                                          const Table<unsigned char>& tab, int nq,
                                          typename C::Acc (&acc)[QG]) {
#pragma unroll
  for (int dq = 0; dq < QG; ++dq) acc[dq] = 0;
#pragma unroll 2
  for (int r = 0; r < rows; ++r)
    C::template add<QG>(acc, static_cast<uint32_t>(__ldg(src + (int64_t)r * kLanes)), tab, nq);
}

// Member m's score for every live query (see member_score).
template <class C, int QG>
__device__ __forceinline__ void member_scores(const Walker& w, const Item& it, int m,
                                              const Table<unsigned char>& tab, int nq,
                                              float (&sc)[QG]) {
  const int32_t* src = w.rows_of(it, m);
  typename C::Acc acc[QG];
  if (w.k.mode != kWide) {
    rows_sums<C, QG>(src, w.k.width, tab, nq, acc);
#pragma unroll
    for (int dq = 0; dq < QG; ++dq) sc[dq] = C::finish(acc[dq]);
    return;
  }
#pragma unroll
  for (int dq = 0; dq < QG; ++dq) sc[dq] = 0.0f;
  for (int blk = 0; blk < w.k.bps; ++blk) {
    const int rows = min(w.block_sublanes, w.k.width - blk * w.block_sublanes);
    rows_sums<C, QG>(src + (int64_t)blk * w.block_sublanes * kLanes, rows, tab, nq, acc);
#pragma unroll
    for (int dq = 0; dq < QG; ++dq) sc[dq] = __fadd_rn(sc[dq], C::finish(acc[dq]));
  }
}

template <class C, int K, int QG, bool TIE_SAFE>
__global__ void __launch_bounds__(kLanes)
slice_topk_batch_kernel(const int32_t* __restrict__ words, const void* __restrict__ tables,
                        const int32_t* __restrict__ nreal,
                        const int32_t* __restrict__ plan, int num_buckets,
                        int block_sublanes, int table_rows, int shift, int num_queries,
                        int subgroup, int num_subgroups, int part_rows, int part_slices,
                        float* __restrict__ out_v, int32_t* __restrict__ out_t) {
  static_assert(QG >= 1 && QG <= 8, "an h16 table entry holds 8 nibbles");
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x;
  const int sg = blockIdx.x % num_subgroups;
  const int slot = blockIdx.x / num_subgroups;
  const int num_slots = gridDim.x / num_subgroups;
  const int q0 = sg * subgroup;
  const int nq = min(subgroup, num_queries - q0);   // <= QG
  const auto tab = C::template load<QG>(smem, tables, q0, nq, table_rows, shift, lane);
  __syncthreads();

  float tv[QG][K];
  int32_t tt[QG][K];
#pragma unroll
  for (int dq = 0; dq < QG; ++dq) octet::topk_init<K, TIE_SAFE>(tv[dq], tt[dq]);

  // fold_tile 1: runs of slices and wide slices, every slice folded
  const Partition part = partition(words, nreal, num_buckets, part_rows, part_slices);
  Walker w(part.words, plan, part.nreal, num_buckets, block_sublanes, 1, lane);
  Item it;
  for (int g = slot; w.locate(g, it); g += num_slots) {
    for (int m = 0; m < it.count; ++m) {
      if (!w.real(it, m)) continue;
      float sc[QG];
      member_scores<C, QG>(w, it, m, tab, nq, sc);
      const int tag = part.tag_offset + w.tag(it, m);
#pragma unroll
      for (int dq = 0; dq < QG; ++dq) {
        if (dq >= nq) break;
        octet::topk_update<K, TIE_SAFE>(tv[dq], tt[dq], sc[dq], tag);
      }
    }
  }

#pragma unroll
  for (int dq = 0; dq < QG; ++dq) {
    if (dq >= nq) break;
    const int64_t out0 =
        (((int64_t)(q0 + dq) * gridDim.y + blockIdx.y) * num_slots + slot) * K * kLanes + lane;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      out_v[out0 + s * kLanes] = tv[dq][s];
      out_t[out0 + s * kLanes] = tt[dq][s];
    }
  }
}

struct Args {
  const int32_t* words;
  const void* tables;
  const int32_t* nreal;
  const int32_t* plan;
  int codec, num_buckets, block_sublanes, table_rows, shift, lane_k, num_queries, subgroup,
      num_subgroups, num_cuda_blocks, num_partitions, part_rows, part_slices;
  bool tie_safe;
  float* out_v;
  int32_t* out_t;
  cudaStream_t stream;
};

template <class C, int K, int QG, bool TIE_SAFE>
cudaError_t launch(const Args& a) {
  auto kernel = slice_topk_batch_kernel<C, K, QG, TIE_SAFE>;
  const size_t smem = C::smem_bytes(QG, a.table_rows);
  const cudaError_t err = codec::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.num_cuda_blocks, a.num_partitions);
  kernel<<<grid, kLanes, smem, a.stream>>>(
      a.words, a.tables, a.nreal, a.plan, a.num_buckets, a.block_sublanes, a.table_rows, a.shift,
      a.num_queries, a.subgroup, a.num_subgroups, a.part_rows, a.part_slices, a.out_v, a.out_t);
  return cudaSuccess;
}

template <class C, int K, int QG>
cudaError_t launch_q(const Args& a) {
  return a.tie_safe ? launch<C, K, QG, true>(a) : launch<C, K, QG, false>(a);
}

template <class C, int K>
cudaError_t launch_k(const Args& a) {
  if (a.subgroup == 1) return launch_q<C, K, 1>(a);
  if (a.subgroup == 2) return launch_q<C, K, 2>(a);
  if (a.subgroup <= 4) return launch_q<C, K, 4>(a);
  return launch_q<C, K, 8>(a);
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

// int8x4, i8s and i4s (slice_topk_batch_q.cu).
cudaError_t launch_quantized(const Args& a);

}  // namespace k8
