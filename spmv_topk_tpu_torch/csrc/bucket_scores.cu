// Plain SpMV over one bucket (kernel K11) for Hopper (sm_90a), every query
// codec (codecs.cuh).
//
// Replaces spmv_topk_tpu/ops/kernel.py::_bucket_scores_kernel (the
// pallas_call of spmv_bucket_scores_device).
//
// What it computes. For each of the bucket's num_slices slices (padding
// slices included: their zero words score 0), its 128 row scores, summed
// as the JAX kernel sums them (bucket_common.cuh::slice_score), written
// to row s of a (num_slices, 128) f32 output in slice order.
//
// Design. One CUDA block of 128 threads, one per lane; the query table in
// shared memory (an f32 table past a block's shared memory, above 58,112
// columns on the H100, is read from global memory through the read-only
// path, F32Global); blocks take slices in turn (grid stride), each thread
// adding its lane's W // 8 chunks and storing one float, a coalesced
// 512-byte row per slice.
//
// Bound. It reads every word of the bucket once and writes 4 bytes per
// slice row, with a gather and a few operations per word, so it should be
// bound by device memory bytes. One launch per bucket: a corpus of many
// small buckets pays a launch each.

#include "bucket_common.cuh"

namespace {

using namespace bucket;

template <class C>
__global__ void __launch_bounds__(kLanes)
bucket_scores_kernel(const int32_t* __restrict__ words, const typename C::Tab* __restrict__ table,
                     int num_slices, int width, int table_rows, int shift,
                     float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x;
  const auto tab = codec::stage_table<C, false>(smem, table, table_rows, shift, lane);
  const int chunks = width / kChunk;
  for (int s = blockIdx.x; s < num_slices; s += gridDim.x)
    out[(int64_t)s * kLanes + lane] =
        slice_score<C>(words + (int64_t)s * width * kLanes + lane, chunks, tab);
}

}  // namespace

extern "C" {

// words: (num_slices * width, 128) int32; table: (table_rows, 128), int32
// (f32 for the f32 codecs), codec one of codecs.cuh::Codec; out:
// (num_slices, 128) f32. Returns cudaGetLastError() (or the error of a
// refused launch).
int bucket_scores(const int32_t* words, const void* table, int num_slices, int width,
                  int table_rows, int codec, int num_cuda_blocks, float* out, void* stream) {
  if (num_slices < 1 || width < 1 || num_cuda_blocks < 1 ||
      !codec::table_rows_ok(codec, table_rows))
    return cudaErrorInvalidValue;
  const cudaError_t err = codec::dispatch(codec, [&](auto tag) {
    using C = typename decltype(tag)::type;
    auto kernel = bucket_scores_kernel<C>;
    const size_t smem = codec::table_smem_bytes<C, false>(table_rows);
    const cudaError_t e = codec::allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<num_cuda_blocks, kLanes, smem, static_cast<cudaStream_t>(stream)>>>(
        words, static_cast<const typename C::Tab*>(table), num_slices, width, table_rows,
        codec::sign_shift(codec), out);
    return cudaSuccess;
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
