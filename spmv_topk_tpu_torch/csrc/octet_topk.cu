// Kernel K1 (octet_topk.cuh): the h16 instantiations and the C entry
// point, which hands the other codecs to octet_topk_q.cu.

#include "octet_topk.cuh"

extern "C" {

// words: (num_partitions * part_rows, 128) int32, part_rows a whole
// number of blocks; table: (table_rows, 128), int32 (f32 for the f32
// codecs), codec one of codecs.cuh::Codec; nreal: (num_partitions,
// num_buckets) int32; plan: (num_buckets, 8) int32; part_slices: slice
// tags per partition; out_v/out_t: (num_partitions, num_cuda_blocks,
// lane_k, 128). Returns cudaGetLastError() (or the error of a refused
// launch).
int octet_topk(const int32_t* words, const void* table, const int32_t* nreal,
               const int32_t* plan, int num_buckets, int block_sublanes, int table_rows,
               int codec, int lane_k, int exact, int tie_safe, int num_cuda_blocks,
               int num_partitions, int part_rows, int part_slices, float* out_v,
               int32_t* out_t, void* stream) {
  if (num_buckets < 1 || num_cuda_blocks < 1 || num_partitions < 1 || num_partitions > 65535 ||
      !codec::table_rows_ok(codec, table_rows))
    return cudaErrorInvalidValue;
  const k1::Args a{words, table, nreal, plan, codec, num_buckets, block_sublanes, table_rows,
                   codec::sign_shift(codec), lane_k, num_cuda_blocks, num_partitions, part_rows,
                   part_slices, exact != 0, tie_safe != 0, out_v, out_t,
                   static_cast<cudaStream_t>(stream)};
  const cudaError_t err = codec == codec::kH16
                              ? k1::launch_codecs<codec::codec_set<codec::kH16>()>(a)
                              : k1::launch_quantized(a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
