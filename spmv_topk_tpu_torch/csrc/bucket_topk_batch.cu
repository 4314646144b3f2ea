// Kernel K12 (bucket_topk_batch.cuh): the h16 and f32 instantiations and
// the C entry point, which hands the other codecs to
// bucket_topk_batch_q.cu.

#include "bucket_topk_batch.cuh"

extern "C" {

// words: (num_slices * width, 128) int32; tables: (Q, table_rows, 128),
// int32 (f32 for the f32 codecs), codec one of codecs.cuh::Codec;
// num_real: one int32 on the device; subgroup: live queries per CUDA
// block, 1..8; num_cuda_blocks: a multiple of num_subgroups =
// ceil(Q / subgroup); out_v/out_t: (Q, num_cuda_blocks / num_subgroups,
// lane_k, 128). Returns cudaGetLastError() (or the error of a refused
// launch).
int bucket_topk_batch(const int32_t* words, const void* tables, const int32_t* num_real,
                      int num_slices, int width, int table_rows, int codec, int lane_k,
                      int tie_safe, int slice_base, int num_queries, int subgroup,
                      int num_cuda_blocks, float* out_v, int32_t* out_t, void* stream) {
  if (num_slices < 1 || width < 1 || num_queries < 1 || subgroup < 1 || subgroup > 8 ||
      !codec::table_rows_ok(codec, table_rows))
    return cudaErrorInvalidValue;
  const int num_subgroups = (num_queries + subgroup - 1) / subgroup;
  if (num_cuda_blocks < num_subgroups || num_cuda_blocks % num_subgroups)
    return cudaErrorInvalidValue;
  const k12::Args a{words, tables, num_real, codec, num_slices, width, table_rows,
                    codec::sign_shift(codec), lane_k, slice_base, num_queries, subgroup,
                    num_subgroups, num_cuda_blocks, tie_safe != 0, out_v, out_t,
                    static_cast<cudaStream_t>(stream)};
  using namespace codec;
  const cudaError_t err = codec == kH16 || codec == kF32 || codec == kF32Global
                              ? k12::launch_codecs<codec_set<kH16, kF32, kF32Global>()>(a)
                              : k12::launch_quantized(a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
