// Per-bucket Top-K of one query (kernel K13) for Hopper (sm_90a), every
// query codec (codecs.cuh).
//
// Replaces spmv_topk_tpu/ops/kernel.py::_bucket_kernel (the pallas_call of
// topk_spmv_bucket_device).
//
// What it computes. Every real slice s (s < num_real) of one bucket:
// its 128 row scores as K11 computes them (bucket_common.cuh::
// slice_score), folded into per-lane (value, tag) buffers of lane_k
// entries by argmin replacement (_topk_update: the first minimum when
// tie-safe, else every slot holding it, when score >= minimum), the tag
// the global slice id slice_base + s. The JAX kernel folds the padding
// slices too, at -inf (a penalty added to their score): that moves no
// value, so they are skipped here.
//
// Design. K11's sweep (one CUDA block = 128 lanes, the table in shared
// memory or F32Global, blocks taking slices in turn) with the lane buffers
// in registers (lane_k a template parameter; tie-safe or not a run-time
// branch). The TPU kernel carried one buffer over its sequential grid;
// here each block writes its buffers to out[blockIdx], and one per-lane
// torch.topk (ops/kernel.py::merge_lane_topk) merges them, so the
// candidates equal the JAX kernel's on tie-free data.
//
// Bound. As K11: the bucket's words read once, bound by device memory
// bytes; the buffers' writes (nblk x lane_k x 1 KiB) are small. One launch
// and one merge per bucket.

#include "bucket_common.cuh"

namespace {

using namespace bucket;

template <class C, int K>
__global__ void __launch_bounds__(kLanes)
bucket_topk_kernel(const int32_t* __restrict__ words, const typename C::Tab* __restrict__ table,
                   const int32_t* __restrict__ num_real, int num_slices, int width,
                   int table_rows, int shift, bool tie_safe, int slice_base,
                   float* __restrict__ out_v, int32_t* __restrict__ out_t) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x;
  const auto tab = codec::stage_table<C, false>(smem, table, table_rows, shift, lane);

  float tv[K];
  int32_t tt[K];
  topk_init<K>(tv, tt, tie_safe);

  const int chunks = width / kChunk;
  const int n = real_slices(num_real, num_slices);
  for (int s = blockIdx.x; s < n; s += gridDim.x)
    topk_update<K>(tv, tt,
                   slice_score<C>(words + (int64_t)s * width * kLanes + lane, chunks, tab),
                   slice_base + s, tie_safe);

  const int64_t out0 = (int64_t)blockIdx.x * K * kLanes + lane;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    out_v[out0 + k * kLanes] = tv[k];
    out_t[out0 + k * kLanes] = tt[k];
  }
}

struct Args {
  const int32_t* words;
  const void* table;
  const int32_t* num_real;
  int num_slices, width, table_rows, shift, slice_base, num_cuda_blocks;
  bool tie_safe;
  float* out_v;
  int32_t* out_t;
  cudaStream_t stream;
};

template <class C, int K>
cudaError_t launch(const Args& a) {
  auto kernel = bucket_topk_kernel<C, K>;
  const size_t smem = codec::table_smem_bytes<C, false>(a.table_rows);
  const cudaError_t err = codec::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<a.num_cuda_blocks, kLanes, smem, a.stream>>>(
      a.words, static_cast<const typename C::Tab*>(a.table), a.num_real, a.num_slices, a.width,
      a.table_rows, a.shift, a.tie_safe, a.slice_base, a.out_v, a.out_t);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// words: (num_slices * width, 128) int32; table: (table_rows, 128), int32
// (f32 for the f32 codecs), codec one of codecs.cuh::Codec; num_real: one
// int32 on the device; out_v/out_t: (num_cuda_blocks, lane_k, 128).
// Returns cudaGetLastError() (or the error of a refused launch).
int bucket_topk(const int32_t* words, const void* table, const int32_t* num_real, int num_slices,
                int width, int table_rows, int codec, int lane_k, int tie_safe, int slice_base,
                int num_cuda_blocks, float* out_v, int32_t* out_t, void* stream) {
  if (num_slices < 1 || width < 1 || num_cuda_blocks < 1 ||
      !codec::table_rows_ok(codec, table_rows))
    return cudaErrorInvalidValue;
  const Args a{words, table, num_real, num_slices, width, table_rows, codec::sign_shift(codec),
               slice_base, num_cuda_blocks, tie_safe != 0, out_v, out_t,
               static_cast<cudaStream_t>(stream)};
  const cudaError_t err = codec::dispatch(codec, [&](auto tag) {
    using C = typename decltype(tag)::type;
    switch (lane_k) {
      case 4: return launch<C, 4>(a);
      case 8: return launch<C, 8>(a);
      case 16: return launch<C, 16>(a);
      default: return cudaErrorInvalidValue;
    }
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
