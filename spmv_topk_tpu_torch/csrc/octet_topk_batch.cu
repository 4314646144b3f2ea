// Kernel K6 (octet_topk_batch.cuh) for every codec but h16: the C entry
// point, which hands each codec to its octet_topk_batch_<codec>.cu (h16
// has a kernel and an entry point of its own, octet_topk_batch_h16.cu).

#include "octet_topk_batch.cuh"

extern "C" {

// words: (num_partitions * part_rows, 128) int32, part_rows a whole
// number of blocks; tables: (Q, table_rows, 128), int32 (f32 for the f32
// codecs), codec one of codecs.cuh::Codec but kH16; nreal: (num_partitions,
// num_buckets) int32; plan: (num_buckets, 8) int32; subgroup: live
// queries per CUDA block, 1..8; num_cuda_blocks (per partition): a
// multiple of num_subgroups = ceil(Q / subgroup); part_slices: slice tags
// per partition; out_v/out_t: (Q, num_partitions, num_cuda_blocks /
// num_subgroups, lane_k, 128). Returns cudaGetLastError() (or the error
// of a refused launch).
int octet_topk_batch(const int32_t* words, const void* tables, const int32_t* nreal,
                     const int32_t* plan, int num_buckets, int block_sublanes, int table_rows,
                     int codec, int lane_k, int exact, int tie_safe, int num_queries,
                     int subgroup, int num_cuda_blocks, int num_partitions, int part_rows,
                     int part_slices, float* out_v, int32_t* out_t, void* stream) {
  if (num_buckets < 1 || num_queries < 1 || subgroup < 1 || subgroup > 8 ||
      num_partitions < 1 || num_partitions > 65535 || !codec::table_rows_ok(codec, table_rows))
    return cudaErrorInvalidValue;
  const int num_subgroups = (num_queries + subgroup - 1) / subgroup;
  if (num_cuda_blocks < num_subgroups || num_cuda_blocks % num_subgroups)
    return cudaErrorInvalidValue;
  const k6::Args a{words, tables, nreal, plan, codec, num_buckets, block_sublanes, table_rows,
                   codec::sign_shift(codec), lane_k, num_queries, subgroup, num_subgroups,
                   num_cuda_blocks, num_partitions, part_rows, part_slices, exact != 0,
                   tie_safe != 0, out_v, out_t, static_cast<cudaStream_t>(stream)};
  using namespace codec;
  cudaError_t err;
  switch (codec) {
    case kH16: return cudaErrorInvalidValue;   // octet_topk_batch_h16
    case kF32: err = k6::launch_f32(a); break;
    case kF32Global: err = k6::launch_f32g(a); break;
    case kInt8x4: err = k6::launch_int8x4(a); break;
    default: err = k6::launch_sign(a);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
