// Plain SpMV over the slice stream (kernel K9) for Hopper (sm_90a),
// every query codec (codecs.cuh).
//
// Replaces spmv_topk_tpu/ops/kernel.py::_fused_scores_kernel (the
// pallas_call of spmv_fused_scores_device, with its (P, num_blocks)
// partition grid too: the partition is the grid's y index, and partition
// p's slices land part_slices * p rows down, against the stacked row_ids).
//
// What it computes. Every real slice's 128 row scores, as K7 computes
// them (slice_common.cuh::member_score: h16 sums converted once per slice
// or per block of a wide slice, block sums carried in float), written
// straight to slice order: row slice_base + t of a (num_slices, 128) f32
// output. The TPU kernel wrote (num_blocks, max_spb, 128) tiles that the
// host then gathered into slice order; here the kernel's store does it.
// Padding slices of a bucket's last block are not written (their ids
// belong to the next bucket).
//
// Design and bound: K7's sweep (one CUDA block = 128 lanes, the query
// table in shared memory, grid-stride over runs of 8 slices and wide
// slices) with the harvest replaced by one coalesced 512-byte row store
// per slice. It reads the stream once and writes 4 bytes per slice row
// (about 40 MB at the 10M-row corpus), so it should be bound by device
// memory bytes like K7.

#include "slice_common.cuh"

namespace {

using namespace slice;

template <class C>
__global__ void __launch_bounds__(kLanes)
slice_scores_kernel(const int32_t* __restrict__ words,
                    const typename C::Tab* __restrict__ table,
                    const int32_t* __restrict__ nreal,
                    const int32_t* __restrict__ plan, int num_buckets,
                    int block_sublanes, int table_rows, int shift, int part_rows,
                    int part_slices, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x;
  const auto tab = codec::stage_table<C, false>(smem, table, table_rows, shift, lane);

  // fold_tile 1: runs of slices and wide slices, every slice on its own
  const Partition part = partition(words, nreal, num_buckets, part_rows, part_slices);
  Walker w(part.words, plan, part.nreal, num_buckets, block_sublanes, 1, lane);
  Item it;
  for (int g = blockIdx.x; w.locate(g, it); g += gridDim.x) {
    for (int m = 0; m < it.count; ++m) {
      if (!w.real(it, m)) continue;
      out[((int64_t)part.tag_offset + w.tag(it, m)) * kLanes + lane] =
          member_score<C>(w, it, m, tab);
    }
  }
}

struct Args {
  const int32_t* words;
  const void* table;
  const int32_t* nreal;
  const int32_t* plan;
  int num_buckets, block_sublanes, table_rows, shift, num_cuda_blocks, num_partitions,
      part_rows, part_slices;
  float* out;
  cudaStream_t stream;
};

template <class C>
cudaError_t launch(const Args& a) {
  auto kernel = slice_scores_kernel<C>;
  const size_t smem = codec::table_smem_bytes<C, false>(a.table_rows);
  const cudaError_t err = codec::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.num_cuda_blocks, a.num_partitions);
  kernel<<<grid, kLanes, smem, a.stream>>>(
      a.words, static_cast<const typename C::Tab*>(a.table), a.nreal, a.plan, a.num_buckets,
      a.block_sublanes, a.table_rows, a.shift, a.part_rows, a.part_slices, a.out);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// words: (num_partitions * part_rows, 128) int32, part_rows a whole
// number of blocks; table: (table_rows, 128), int32 (f32 for the f32
// codecs), codec one of codecs.cuh::Codec; nreal: (num_partitions,
// num_buckets) int32; plan:
// (num_buckets, 6) int32; out: (num_partitions * part_slices, 128) f32,
// rows of real slices written, others left. Returns cudaGetLastError()
// (or the error of a refused launch).
int slice_scores(const int32_t* words, const void* table, const int32_t* nreal,
                 const int32_t* plan, int num_buckets, int block_sublanes,
                 int table_rows, int codec, int num_cuda_blocks, int num_partitions,
                 int part_rows, int part_slices, float* out, void* stream) {
  if (num_buckets < 1 || num_cuda_blocks < 1 || table_rows < 1 || num_partitions < 1 ||
      num_partitions > 65535 || !codec::table_rows_ok(codec, table_rows))
    return cudaErrorInvalidValue;
  const Args a{words, table, nreal, plan, num_buckets, block_sublanes, table_rows,
               codec::sign_shift(codec), num_cuda_blocks, num_partitions, part_rows,
               part_slices, out, static_cast<cudaStream_t>(stream)};
  const cudaError_t err =
      codec::dispatch(codec, [&](auto tag) { return launch<typename decltype(tag)::type>(a); });
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
