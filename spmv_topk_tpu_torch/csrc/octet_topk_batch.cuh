// Multi-query octet Top-K sweep (kernel K6; K10d with partitions) for
// Hopper (sm_90a), every query codec of codecs.cuh but h16, whose sweep
// reads the stream once for 32 queries (octet_topk_batch_h16.cu).
// octet_topk_batch.cu holds the C entry point; each codec's instantiations
// are a translation unit of their own (octet_topk_batch_<codec>.cu),
// built in parallel.
//
// Replaces spmv_topk_tpu/ops/kernel.py::_fused_kernel_batch_octet (the
// pallas_calls of topk_spmv_fused_batch_octet_device and, with P row
// partitions, topk_spmv_fused_batch_octet_part_device: the partition is
// the grid's y index, as in K1, and each query keeps a pool per
// partition, (Q, P, lane_k, 128) after the merge).
//
// What it computes. For each of Q queries, what K1 (octet_topk.cuh)
// computes for one: every octet's 8 member scores, harvested (top 3 of 8,
// or every member with fold_tile 1) into per-lane (value, slice tag)
// buffers of lane_k entries. The float codecs add in the JAX batch
// kernel's order, one accumulator per query in chunk order and block sums
// carried in f32 (octet_common.cuh::octet_sums_batch), which is not K1's:
// their scores can differ from K1's in the last bits. As in the JAX
// kernel, the query-independent part of a word's decode (_codec_split's
// shared) is done once and applied per query, and each query has its own
// argmin-replacement buffers.
//
// Design. A query subgroup of at most 8 queries is live in one CUDA block
// (cfg.batch_subgroup): their 8 accumulators and buffer pair each sit in
// registers, sized for QG, the subgroup rounded up to a power of two.
// The grid is (octet slots) x (subgroups), flattened with the subgroup
// fastest, so the blocks that read the same octets for the
// different subgroups are neighbours in launch order: the stream is read
// once per subgroup, and the neighbours' reads meet in L2 where they run
// together. The subgroup's tables sit side by side in shared memory
// (codecs.cuh::Batch; the wrapper cuts the
// subgroup to the tables that fit shared memory, and f32 tables past one
// are read from global memory), one gather per query per nnz. Blocks
// grid-stride over all octets as in K1 (no carry between blocks, no
// block-padding octets) and write their buffers to out[q][slot]; one
// per-lane torch.topk per query merges the slots.
//
// Bound. Per word: one coalesced load, the shared decode, and per live
// query one gather and a rounded multiply and add: at 8 queries a
// subgroup and the headline corpus, about the bytes of the 4-byte words
// read once per subgroup.

#pragma once

#include "octet_common.cuh"

namespace k6 {

using namespace octet;

template <class B, int K, int QG, bool TIE_SAFE, bool EXACT>
__global__ void __launch_bounds__(kLanes)
octet_topk_batch_kernel(const int32_t* __restrict__ words, const void* __restrict__ tables,
                        const int32_t* __restrict__ nreal,
                        const int32_t* __restrict__ plan, int num_buckets,
                        int block_sublanes, int table_rows, int shift, int num_queries,
                        int subgroup, int num_subgroups, int part_rows, int part_slices,
                        float* __restrict__ out_v, int32_t* __restrict__ out_t) {
  static_assert(QG >= 1 && QG <= 8, "at most 8 live queries");
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
  for (int dq = 0; dq < QG; ++dq) topk_init<K, TIE_SAFE>(tv[dq], tt[dq]);

  const Partition part = partition(words, nreal, num_buckets, part_rows, part_slices);
  const int total = total_octets(plan, num_buckets);
  int b = 0;
  for (int g = slot; g < total; g += num_slots) {
    const Octet oc = locate(part.words, plan, part.nreal, num_buckets, block_sublanes, g, b, lane);
    if (oc.index >= oc.n_real) continue;   // skeleton padding: no real member
    float scores[kMembers][QG];
    octet_sums_batch<B, QG>(oc, tab, nq, block_sublanes / kMembers, scores);
#pragma unroll
    for (int dq = 0; dq < QG; ++dq) {
      if (dq >= nq) break;
      float sc[kMembers];
#pragma unroll
      for (int m = 0; m < kMembers; ++m)
        sc[m] = (oc.index + m * oc.stride < oc.n_real) ? scores[m][dq] : -INFINITY;
      harvest<K, TIE_SAFE, EXACT>(tv[dq], tt[dq], sc, part.tag_offset + oc.slice0, oc.stride);
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
  bool exact, tie_safe;
  float* out_v;
  int32_t* out_t;
  cudaStream_t stream;
};

template <class B, int K, int QG, bool TIE_SAFE, bool EXACT>
cudaError_t launch(const Args& a) {
  auto kernel = octet_topk_batch_kernel<B, K, QG, TIE_SAFE, EXACT>;
  const size_t smem = B::smem_bytes(QG, a.table_rows);
  const cudaError_t err = codec::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.num_cuda_blocks, a.num_partitions);
  kernel<<<grid, kLanes, smem, a.stream>>>(
      a.words, a.tables, a.nreal, a.plan, a.num_buckets, a.block_sublanes, a.table_rows, a.shift,
      a.num_queries, a.subgroup, a.num_subgroups, a.part_rows, a.part_slices, a.out_v, a.out_t);
  return cudaSuccess;
}

template <class B, int K, int QG>
cudaError_t launch_kq(const Args& a) {
  if (a.tie_safe && a.exact) return launch<B, K, QG, true, true>(a);
  if (a.tie_safe) return launch<B, K, QG, true, false>(a);
  if (a.exact) return launch<B, K, QG, false, true>(a);
  return launch<B, K, QG, false, false>(a);
}

template <class B, int K>
cudaError_t launch_k(const Args& a) {
  if (a.subgroup == 1) return launch_kq<B, K, 1>(a);
  if (a.subgroup == 2) return launch_kq<B, K, 2>(a);
  if (a.subgroup <= 4) return launch_kq<B, K, 4>(a);
  return launch_kq<B, K, 8>(a);
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

// Each codec but h16 in a translation unit of its own
// (octet_topk_batch_<name>.cu).
cudaError_t launch_f32(const Args& a);
cudaError_t launch_f32g(const Args& a);
cudaError_t launch_int8x4(const Args& a);
cudaError_t launch_sign(const Args& a);

}  // namespace k6
