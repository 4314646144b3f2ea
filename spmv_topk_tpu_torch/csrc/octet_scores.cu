// Plain SpMV over the octet stream (kernel K4) for Hopper (sm_90a), every
// query codec (codecs.cuh).
//
// Replaces spmv_topk_tpu/ops/kernel.py::_fused_scores_kernel_octet (the
// pallas_call of spmv_fused_scores_octet_device, with its (P, num_blocks)
// partition grid too: the partition is the grid's y index, and partition
// p's slices land part_slices * p rows down, against the stacked row_ids).
//
// What it computes. Every octet's 8 member scores (the same sums K1
// harvests, octet_common.cuh::octet_sums: h16 in int32 converted once,
// the float codecs in the JAX kernel's order of two alternating
// accumulators and block sums carried in f32), written straight to slice
// order: member m of octet o of a bucket is slice slice_base + o +
// m*stride, row `slice` of a (num_slices, 128) f32 output; or straight
// to row order, as K9 writes it (slice_scores.cu): out[row] = score *
// factor (one rounded multiply) for row = row_ids[slice, lane] >= 0.
// Members past the bucket's real slices are not written (their ids belong
// to the next bucket). The TPU kernel wrote (num_blocks, 8 *
// octets_per_block, 128) tiles that the host then transposed into slice
// order and gathered into row order (spmv_topk_tpu/api.py:535-560); here
// the kernel's store does it.
//
// Design and bound: K1's sweep (one CUDA block = the 128 lanes of one
// octet at a time, grid-stride over all octets, the query table in
// shared memory or, for f32 past it, global memory) with K1's harvest
// replaced by 8 coalesced 512-byte row stores per octet (row order: 8
// 512-byte loads of row ids and 8 scattered 4-byte stores a lane; the
// row-order form loads the words and the row ids cache-streaming and
// stores the rows L2 evict-last, as K9 does, octet_common.cuh::store_kept,
// so that the 40 MB of rows stay in the 50 MB L2 while the stream
// passes; its sums are the slice-order form's). It reads the stream once and
// writes 4 bytes per slice row (~40 MB at the 10M-row headline corpus
// against ~450 MB of h16 words; row order reads ~41 MB of row ids
// besides), so it should be bound by device memory bytes like K1.

#include "octet_common.cuh"

namespace {

using namespace octet;

template <class C, bool ROWS>
__global__ void __launch_bounds__(kLanes)
octet_scores_kernel(const int32_t* __restrict__ words,
                    const typename C::Tab* __restrict__ table,
                    const int32_t* __restrict__ nreal,
                    const int32_t* __restrict__ plan, int num_buckets,
                    int block_sublanes, int table_rows, int shift, int part_rows,
                    int part_slices, float* __restrict__ out,
                    const int32_t* __restrict__ row_ids, float factor) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x;
  const auto tab = codec::stage_table<C, true>(smem, table, table_rows, shift, lane);

  const Partition part = partition(words, nreal, num_buckets, part_rows, part_slices);
  const int total = total_octets(plan, num_buckets);
  // row order: the words and the row ids leave L2 first, the rows stay
  // (octet_common.cuh::store_kept)
  const uint64_t keep = ROWS ? evict_last_policy() : 0;
  int b = 0;
  for (int g = blockIdx.x; g < total; g += gridDim.x) {
    const Octet oc = locate(part.words, plan, part.nreal, num_buckets, block_sublanes, g, b, lane);
    if (oc.index >= oc.n_real) continue;   // skeleton padding: no real member
    float sc[kMembers];
    octet_sums<C, ROWS>(oc, tab, block_sublanes / kMembers, sc);
    const int64_t row0 = part.tag_offset + oc.slice0;
#pragma unroll
    for (int m = 0; m < kMembers; ++m)
      if (oc.index + m * oc.stride < oc.n_real) {
        const int64_t at = (row0 + m * oc.stride) * kLanes + lane;
        if constexpr (ROWS) {
          const int32_t row = __ldcs(row_ids + at);
          if (row >= 0) store_kept(out + row, __fmul_rn(sc[m], factor), keep);
        } else {
          out[at] = sc[m];
        }
      }
  }
}

struct Args {
  const int32_t* words;
  const void* table;
  const int32_t* nreal;
  const int32_t* plan;
  int num_buckets, block_sublanes, table_rows, shift, num_cuda_blocks, num_partitions, part_rows,
      part_slices;
  float* out;
  const int32_t* row_ids;
  float factor;
  cudaStream_t stream;
};

template <class C, bool ROWS>
cudaError_t launch(const Args& a) {
  auto kernel = octet_scores_kernel<C, ROWS>;
  const size_t smem = codec::table_smem_bytes<C, true>(a.table_rows);
  const cudaError_t err = codec::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.num_cuda_blocks, a.num_partitions);
  kernel<<<grid, kLanes, smem, a.stream>>>(
      a.words, static_cast<const typename C::Tab*>(a.table), a.nreal, a.plan, a.num_buckets,
      a.block_sublanes, a.table_rows, a.shift, a.part_rows, a.part_slices, a.out, a.row_ids,
      a.factor);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// words: (num_partitions * part_rows, 128) int32, part_rows a whole
// number of blocks; table: (table_rows, 128), int32 (f32 for the f32
// codecs), codec one of codecs.cuh::Codec; nreal: (num_partitions,
// num_buckets) int32; plan: (num_buckets, 8) int32; out: (num_partitions
// * part_slices, 128) f32, rows of real slices written, others left; or,
// with row_ids ((num_partitions * part_slices, 128) int32, -1 for no row),
// f32 rows, out[row] = score * factor for each slice lane's row.
// Returns cudaGetLastError() (or the error of a refused launch).
int octet_scores(const int32_t* words, const void* table, const int32_t* nreal,
                 const int32_t* plan, int num_buckets, int block_sublanes, int table_rows,
                 int codec, int num_cuda_blocks, int num_partitions, int part_rows,
                 int part_slices, float* out, const int32_t* row_ids, float factor,
                 void* stream) {
  if (num_buckets < 1 || num_cuda_blocks < 1 || num_partitions < 1 || num_partitions > 65535 ||
      !codec::table_rows_ok(codec, table_rows))
    return cudaErrorInvalidValue;
  const Args a{words, table, nreal, plan, num_buckets, block_sublanes, table_rows,
               codec::sign_shift(codec), num_cuda_blocks, num_partitions, part_rows,
               part_slices, out, row_ids, factor, static_cast<cudaStream_t>(stream)};
  const cudaError_t err = codec::dispatch(codec, [&](auto tag) {
    using C = typename decltype(tag)::type;
    return row_ids ? launch<C, true>(a) : launch<C, false>(a);
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
