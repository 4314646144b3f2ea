// Kernel K8 (slice_topk_batch.cuh): the h16 instantiations and the C entry
// point, which hands the other codecs to slice_topk_batch_f32.cu and
// slice_topk_batch_q.cu.

#include "slice_topk_batch.cuh"

extern "C" {

// One launch of K8 from its arguments packed as int64 values (one ctypes
// argument, as K7's), in this order:
//   0 words: (num_partitions * part_rows, 128) int32, part_rows a whole
//     number of blocks; 1 tables: (Q, table_rows, 128), int32 (f32 for
//     the f32 codecs); 2 nreal: (num_partitions, num_buckets) int32;
//     3 plan: (num_buckets, 6) int32 (ops/kernel.py::slice_plan_rows);
//   4 num_buckets, 5 block_sublanes (a multiple of 4; h16 at most
//     codecs.cuh::kH16x32MaxWidth), 6 table_rows, 7 codec
//     (codecs.cuh::Codec), 8 lane_k, 9 tie_safe;
//   10 num_queries Q; 11 pass_queries: queries a pass reads the stream
//     for (h16 8, 16 or 32; the others 8 or 16, tables in global memory
//     8), ceil(Q / pass_queries)
//     passes; 12 slots: a partition's and a pass's, 128 / block lanes
//     CUDA blocks each (ops/kernel.py::pass_grid); 13 num_partitions;
//     14 part_rows; 15 part_slices: slice tags a partition;
//   16 merged: 0 leaves each slot's sorted buffers in the workspace,
//      (Q, num_partitions, slots, lane_k, 128) values then tags, and runs
//      no merge (out_v, out_t unused);
//   17 workspace: int32 storage of 18 workspace_lists x 2 x lane_k x 128
//      entries (values, then tags): at least Q x num_partitions x (slots
//      + sets) lists, sets = ceil(slots / ceil(sqrt(slots))), or Q x
//      num_partitions x slots when not merged;
//   19 tickets: 20 num_tickets unsigned zeros, at least passes x
//      num_partitions x 4 x (1 + sets) (the kernel leaves them 0);
//   21 out_v, 22 out_t: (Q, num_partitions, lane_k, 128), each lane's
//      top lane_k, values descending (then tags ascending); 23 stream.
// Returns cudaGetLastError() (or the error of a refused launch).
int slice_topk_batch(const int64_t* p) {
  auto ptr = [&](int i) { return reinterpret_cast<void*>(static_cast<intptr_t>(p[i])); };
  auto arg = [&](int i) { return static_cast<int>(p[i]); };
  const int num_buckets = arg(4), block_sublanes = arg(5), table_rows = arg(6), codec = arg(7);
  const int lane_k = arg(8), num_queries = arg(10), pass_queries = arg(11), slots = arg(12);
  const int num_partitions = arg(13);
  const bool merged = p[16] != 0;
  const int64_t lists = p[18];
  if (num_buckets < 1 || num_queries < 1 || pass_queries < 1 || slots < 1 ||
      slots > (1 << 24) || num_partitions < 1 || num_partitions > 65535 ||
      block_sublanes < 1 || block_sublanes % k8::kUnroll ||
      (codec == codec::kH16 && block_sublanes > codec::kH16x32MaxWidth) ||
      !codec::table_rows_ok(codec, table_rows))
    return cudaErrorInvalidValue;
  const int passes = (num_queries + pass_queries - 1) / pass_queries;
  const int set_size = lane_merge::set_size_of(slots);
  const int sets = (slots + set_size - 1) / set_size;
  const int64_t qp = (int64_t)num_queries * num_partitions;
  if (passes > 65535 || (merged ? lists < qp * (slots + sets) : lists < qp * slots) ||
      (merged && p[20] < (int64_t)passes * num_partitions * 4 * (1 + sets)))
    return cudaErrorInvalidValue;
  float* ws_v = static_cast<float*>(ptr(17));
  int32_t* ws_t = reinterpret_cast<int32_t*>(ws_v + lists * lane_k * octet::kLanes);
  k8::Call c{};
  c.p = k8::Params{static_cast<const int32_t*>(ptr(0)), ptr(1),
                   static_cast<const int32_t*>(ptr(2)), static_cast<const int32_t*>(ptr(3)),
                   num_buckets, block_sublanes, table_rows, codec::sign_shift(codec),
                   num_queries, arg(14), arg(15), merged, set_size, ws_v, ws_t,
                   static_cast<unsigned*>(ptr(19)), static_cast<float*>(ptr(21)),
                   static_cast<int32_t*>(ptr(22))};
  c.codec = codec;
  c.lane_k = lane_k;
  c.pass_queries = pass_queries;
  c.slots = slots;
  c.num_partitions = num_partitions;
  c.passes = passes;
  c.tie_safe = p[9] != 0;
  c.stream = static_cast<cudaStream_t>(ptr(23));
  using namespace codec;
  const cudaError_t err = codec == kH16 ? k8::run_codecs<codec_set<kH16>()>(c)
                          : codec == kF32 || codec == kF32Global ? k8::run_f32(c)
                                                                 : k8::run_quantized(c);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
