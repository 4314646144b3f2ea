// Plain SpMV over the slice stream (kernel K9) for Hopper (sm_90a),
// codecs h16 and f32.
//
// Replaces spmv_topk_tpu/ops/kernel.py::_fused_scores_kernel (the
// pallas_call of spmv_fused_scores_device).
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
                    int block_sublanes, int table_rows,
                    float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  typename C::Tab* tab = reinterpret_cast<typename C::Tab*>(smem);
  const int lane = threadIdx.x;
  for (int i = lane; i < table_rows * kLanes; i += kLanes) tab[i] = table[i];
  __syncthreads();

  // fold_tile 1: runs of slices and wide slices, every slice on its own
  Walker w(words, plan, nreal, num_buckets, block_sublanes, 1, lane);
  Item it;
  for (int g = blockIdx.x; w.locate(g, it); g += gridDim.x) {
    for (int m = 0; m < it.count; ++m) {
      if (!w.real(it, m)) continue;
      out[(int64_t)w.tag(it, m) * kLanes + lane] = member_score<C>(w, it, m, tab, table_rows);
    }
  }
}

template <class C>
cudaError_t launch(const int32_t* words, const void* table, const int32_t* nreal,
                   const int32_t* plan, int num_buckets, int block_sublanes,
                   int table_rows, int num_cuda_blocks, float* out, cudaStream_t stream) {
  auto kernel = slice_scores_kernel<C>;
  const size_t smem = sizeof(typename C::Tab) * table_rows * kLanes;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<num_cuda_blocks, kLanes, smem, stream>>>(
      words, static_cast<const typename C::Tab*>(table), nreal, plan, num_buckets,
      block_sublanes, table_rows, out);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// words: (num_blocks * block_sublanes, 128) int32; table: (1, 128) int32
// (codec 0, h16) or (table_rows, 128) f32 (codec 1, f32); nreal:
// (num_buckets,) int32; plan: (num_buckets, 6) int32; out: (num_slices,
// 128) f32, rows of real slices written, others left. Returns
// cudaGetLastError() (or the error of a refused launch).
int slice_scores(const int32_t* words, const void* table, const int32_t* nreal,
                 const int32_t* plan, int num_buckets, int block_sublanes,
                 int table_rows, int codec, int num_cuda_blocks, float* out,
                 void* stream) {
  if (num_buckets < 1 || num_cuda_blocks < 1 || table_rows < 1 ||
      (codec == 0 && table_rows != 1))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (codec == 0)
    err = launch<H16>(words, table, nreal, plan, num_buckets, block_sublanes, table_rows,
                      num_cuda_blocks, out, s);
  else if (codec == 1)
    err = launch<F32>(words, table, nreal, plan, num_buckets, block_sublanes, table_rows,
                      num_cuda_blocks, out, s);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
