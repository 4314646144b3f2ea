// Plain SpMV over the octet stream of the h16 codec (kernel K4) for Hopper
// (sm_90a).
//
// Replaces spmv_topk_tpu/ops/kernel.py::_fused_scores_kernel_octet (the
// pallas_call of spmv_fused_scores_octet_device, with its (P, num_blocks)
// partition grid too: the partition is the grid's y index, and partition
// p's slices land part_slices * p rows down, against the stacked row_ids).
//
// What it computes. Every octet's 8 member sums of h16 products (the same
// sums K1 harvests, octet_common.cuh::octet_sums), converted to float
// once and written straight to slice order: member m of octet o of a
// bucket is slice slice_base + o + m*stride, row `slice` of a
// (num_slices, 128) f32 output. Members past the bucket's real slices
// are not written (their ids belong to the next bucket). The TPU kernel
// wrote (num_blocks, 8 * octets_per_block, 128) tiles that the host then
// transposed into slice order; here the kernel's store does it. int32
// sums are exact in any order, so the JAX kernel's two alternating
// accumulators have no counterpart.
//
// Design and bound: K1's sweep (one CUDA block = the 128 lanes of one
// octet at a time, grid-stride over all octets, the query table in
// shared memory) with K1's harvest replaced by 8 coalesced 512-byte row
// stores per octet. It reads the stream once and writes 4 bytes per
// slice row (~40 MB at the 10M-row headline corpus against ~450 MB of
// words), so it should be bound by device memory bytes like K1.

#include "octet_common.cuh"

namespace {

using namespace octet;

__global__ void __launch_bounds__(kLanes)
octet_scores_kernel(const int32_t* __restrict__ words,
                    const int32_t* __restrict__ table,
                    const int32_t* __restrict__ nreal,
                    const int32_t* __restrict__ plan, int num_buckets,
                    int block_sublanes, int part_rows, int part_slices,
                    float* __restrict__ out) {
  __shared__ int32_t tab[kLanes];
  const int lane = threadIdx.x;
  tab[lane] = table[lane];
  __syncthreads();

  const Partition part = partition(words, nreal, num_buckets, part_rows, part_slices);
  const int total = total_octets(plan, num_buckets);
  int b = 0;
  for (int g = blockIdx.x; g < total; g += gridDim.x) {
    const Octet oc = locate(part.words, plan, part.nreal, num_buckets, block_sublanes, g, b, lane);
    if (oc.index >= oc.n_real) continue;   // skeleton padding: no real member
    int32_t acc[kMembers];
    octet_sums(oc, tab, acc);
    const int64_t row0 = part.tag_offset + oc.slice0;
#pragma unroll
    for (int m = 0; m < kMembers; ++m)
      if (oc.index + m * oc.stride < oc.n_real)
        out[(row0 + m * oc.stride) * kLanes + lane] = static_cast<float>(acc[m]);
  }
}

}  // namespace

extern "C" {

// words: (num_partitions * part_rows, 128) int32, part_rows a whole
// number of blocks; table: (1, 128) int32; nreal: (num_partitions,
// num_buckets) int32; plan: (num_buckets, 8) int32; out: (num_partitions
// * part_slices, 128) f32, rows of real slices written, others left.
// Returns cudaGetLastError().
int octet_scores_h16(const int32_t* words, const int32_t* table,
                     const int32_t* nreal, const int32_t* plan,
                     int num_buckets, int block_sublanes, int num_cuda_blocks,
                     int num_partitions, int part_rows, int part_slices,
                     float* out, void* stream) {
  if (num_buckets < 1 || num_cuda_blocks < 1 || num_partitions < 1 || num_partitions > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid(num_cuda_blocks, num_partitions);
  octet_scores_kernel<<<grid, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      words, table, nreal, plan, num_buckets, block_sublanes, part_rows, part_slices, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
