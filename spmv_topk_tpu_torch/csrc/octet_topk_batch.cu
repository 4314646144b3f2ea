// Multi-query octet Top-K sweep of the h16 stream (kernel K6; K10d with
// partitions) for Hopper (sm_90a).
//
// Replaces spmv_topk_tpu/ops/kernel.py::_fused_kernel_batch_octet (the
// pallas_calls of topk_spmv_fused_batch_octet_device and, with P row
// partitions, topk_spmv_fused_batch_octet_part_device: the partition is
// the grid's y index, as in K1, and each query keeps a pool per
// partition, (Q, P, lane_k, 128) after the merge).
//
// What it computes. For each of Q queries, exactly what K1
// (octet_topk.cu) computes for one: every octet's 8 member sums of h16
// products, harvested (top 3 of 8, or every member with fold_tile 1)
// into per-lane (value, slice tag) buffers of lane_k entries. As in the
// JAX kernel, the query-independent part of a word's decode (_h16_shared:
// columns, values) is done once and applied per query (_h16_apply), and
// each query has its own argmin-replacement buffers.
//
// Design. A query subgroup of at most 8 queries is live in one CUDA block
// (cfg.batch_subgroup): their 8 accumulators and buffer pair each sit in
// registers, sized for QG, the subgroup rounded up to a power of two.
// The grid is (octet slots) x (subgroups), flattened with the subgroup
// fastest, so the blocks that read the same octets for the
// different subgroups are neighbours in launch order: the stream is read
// once per subgroup, and the neighbours' reads meet in L2 where they run
// together. The QG query tables are repacked in shared memory so that
// entry c (a 10-bit column) holds that column's signed nibble for every
// query of the subgroup, query dq at bits [4dq, 4dq+4): one gather per
// nnz serves the whole subgroup, and each query's nibble comes out with
// a constant shift (octet_common.cuh: repack_h16_tables, prod_h16_batch,
// shared with K8). Blocks grid-stride over all octets as in K1 (no
// carry between blocks, no block-padding octets) and write their buffers
// to out[q][slot]; one per-lane torch.topk per query merges the slots.
//
// Bound. Per word: one coalesced load, two shared-memory gathers and ~6
// integer operations per live query. At the headline corpus and 32
// queries the integer work (~2e10 operations a group) outweighs the
// bytes, so the sweep should be bound by the SMs' integer throughput, not
// by device memory.

#include "octet_common.cuh"

namespace {

using namespace octet;

template <int K, int QG, bool TIE_SAFE, bool EXACT>
__global__ void __launch_bounds__(kLanes)
octet_topk_batch_kernel(const int32_t* __restrict__ words,
                        const int32_t* __restrict__ tables,
                        const int32_t* __restrict__ nreal,
                        const int32_t* __restrict__ plan, int num_buckets,
                        int block_sublanes, int num_queries, int subgroup,
                        int num_subgroups, int part_rows, int part_slices,
                        float* __restrict__ out_v, int32_t* __restrict__ out_t) {
  static_assert(QG >= 1 && QG <= 8, "a table entry holds 8 nibbles");
  __shared__ uint32_t tab[kH16Cols];
  const int lane = threadIdx.x;
  const int sg = blockIdx.x % num_subgroups;
  const int slot = blockIdx.x / num_subgroups;
  const int num_slots = gridDim.x / num_subgroups;
  const int q0 = sg * subgroup;
  const int nq = min(subgroup, num_queries - q0);   // <= QG
  repack_h16_tables<QG>(tab, tables, q0, nq, lane);
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
    int32_t acc[QG][kMembers];
#pragma unroll
    for (int dq = 0; dq < QG; ++dq)
#pragma unroll
      for (int m = 0; m < kMembers; ++m) acc[dq][m] = 0;
#pragma unroll 2
    for (int j = 0; j < oc.width; ++j) {
      const int32_t* row = oc.src + (int64_t)j * kMembers * kLanes;
#pragma unroll
      for (int m = 0; m < kMembers; ++m) {
        int32_t p[QG];
        prod_h16_batch<QG>(static_cast<uint32_t>(__ldg(row + m * kLanes)), tab, p);
#pragma unroll
        for (int dq = 0; dq < QG; ++dq) acc[dq][m] += p[dq];
      }
    }
#pragma unroll
    for (int dq = 0; dq < QG; ++dq) {
      if (dq >= nq) break;
      float sc[kMembers];
#pragma unroll
      for (int m = 0; m < kMembers; ++m)
        sc[m] = (oc.index + m * oc.stride < oc.n_real) ? static_cast<float>(acc[dq][m]) : -INFINITY;
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
  const int32_t* tables;
  const int32_t* nreal;
  const int32_t* plan;
  int num_buckets, block_sublanes, num_queries, subgroup, num_subgroups,
      num_cuda_blocks, num_partitions, part_rows, part_slices;
  float* out_v;
  int32_t* out_t;
  cudaStream_t stream;
};

template <int K, int QG, bool TIE_SAFE, bool EXACT>
void launch(const Args& a) {
  const dim3 grid(a.num_cuda_blocks, a.num_partitions);
  octet_topk_batch_kernel<K, QG, TIE_SAFE, EXACT><<<grid, kLanes, 0, a.stream>>>(
      a.words, a.tables, a.nreal, a.plan, a.num_buckets, a.block_sublanes,
      a.num_queries, a.subgroup, a.num_subgroups, a.part_rows, a.part_slices, a.out_v,
      a.out_t);
}

template <int K, int QG>
void launch_kq(bool tie_safe, bool exact, const Args& a) {
  if (tie_safe && exact) launch<K, QG, true, true>(a);
  else if (tie_safe) launch<K, QG, true, false>(a);
  else if (exact) launch<K, QG, false, true>(a);
  else launch<K, QG, false, false>(a);
}

template <int K>
void launch_k(bool tie_safe, bool exact, const Args& a) {
  if (a.subgroup == 1) launch_kq<K, 1>(tie_safe, exact, a);
  else if (a.subgroup == 2) launch_kq<K, 2>(tie_safe, exact, a);
  else if (a.subgroup <= 4) launch_kq<K, 4>(tie_safe, exact, a);
  else launch_kq<K, 8>(tie_safe, exact, a);
}

}  // namespace

extern "C" {

// words: (num_partitions * part_rows, 128) int32, part_rows a whole
// number of blocks; tables: (Q, 128) int32; nreal: (num_partitions,
// num_buckets) int32; plan: (num_buckets, 8) int32; subgroup: live
// queries per CUDA block, 1..8; num_cuda_blocks (per partition): a
// multiple of num_subgroups = ceil(Q / subgroup); part_slices: slice tags
// per partition; out_v/out_t: (Q, num_partitions, num_cuda_blocks /
// num_subgroups, lane_k, 128). Returns cudaGetLastError().
int octet_topk_batch_h16(const int32_t* words, const int32_t* tables,
                         const int32_t* nreal, const int32_t* plan,
                         int num_buckets, int block_sublanes, int lane_k,
                         int exact, int tie_safe, int num_queries,
                         int subgroup, int num_cuda_blocks, int num_partitions,
                         int part_rows, int part_slices, float* out_v,
                         int32_t* out_t, void* stream) {
  if (num_buckets < 1 || num_queries < 1 || subgroup < 1 || subgroup > 8 ||
      num_partitions < 1 || num_partitions > 65535)
    return cudaErrorInvalidValue;
  const int num_subgroups = (num_queries + subgroup - 1) / subgroup;
  if (num_cuda_blocks < num_subgroups || num_cuda_blocks % num_subgroups)
    return cudaErrorInvalidValue;
  const Args a{words, tables, nreal, plan, num_buckets, block_sublanes,
               num_queries, subgroup, num_subgroups, num_cuda_blocks,
               num_partitions, part_rows, part_slices, out_v, out_t,
               static_cast<cudaStream_t>(stream)};
  switch (lane_k) {
    case 4: launch_k<4>(tie_safe, exact, a); break;
    case 8: launch_k<8>(tie_safe, exact, a); break;
    case 16: launch_k<16>(tie_safe, exact, a); break;
    default: return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
