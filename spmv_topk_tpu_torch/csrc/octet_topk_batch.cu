// Kernel K6 (octet_topk_batch.cuh) for every codec but h16: the C entry
// point, which hands each codec to its octet_topk_batch_<codec>.cu (h16
// has a kernel and an entry point of its own, octet_topk_batch_h16.cu).

#include "octet_topk_batch.cuh"

extern "C" {

// One launch of K6 from its arguments packed as int64 values (one ctypes
// argument, as K8's), in this order:
//   0 words: (num_partitions * part_rows, 128) int32 octet stream,
//     part_rows a whole number of blocks; 1 tables: (Q, table_rows, 128),
//     int32 (f32 for the f32 codecs); 2 nreal: (num_partitions,
//     num_buckets) int32; 3 plan: (num_buckets, 8) int32
//     (ops/kernel.py::octet_plan_rows);
//   4 num_buckets, 5 block_sublanes (a multiple of 8), 6 table_rows,
//     7 codec (codecs.cuh::Codec, not kH16), 8 lane_k, 9 exact (fold_tile
//     1: every member harvested), 10 tie_safe;
//   11 num_queries Q; 12 pass_queries: queries a pass reads the stream
//     for (f32, int8x4, i8s and i4s 8 or 16, f32_global and
//     int8x4_global 8), ceil(Q / pass_queries) passes; 13 slots: a partition's and
//     a pass's, 128 / block lanes CUDA blocks each (ops/kernel.py::
//     pass_grid); 14 num_partitions; 15 part_rows; 16 part_slices: slice
//     tags a partition;
//   17 merged: 0 leaves each slot's sorted buffers in the workspace, (Q,
//     num_partitions, slots, lane_k, 128) values then tags, and runs no
//     merge (out_v, out_t unused);
//   18 workspace: int32 storage of 19 workspace_lists x 2 x lane_k x 128
//     entries (values, then tags): at least Q x num_partitions x (slots +
//     sets) lists, sets = ceil(slots / ceil(sqrt(slots))), or Q x
//     num_partitions x slots when not merged;
//   20 tickets: 21 num_tickets unsigned zeros, at least passes x
//     num_partitions x 4 x (1 + sets) (the kernel leaves them 0);
//   22 out_v, 23 out_t: (Q, num_partitions, lane_k, 128), each lane's
//     top lane_k, values descending (then tags ascending); 24 stream.
// Returns cudaGetLastError() (or the error of a refused launch).
int octet_topk_batch(const int64_t* p) {
  auto ptr = [&](int i) { return reinterpret_cast<void*>(static_cast<intptr_t>(p[i])); };
  auto arg = [&](int i) { return static_cast<int>(p[i]); };
  const int num_buckets = arg(4), block_sublanes = arg(5), table_rows = arg(6), codec = arg(7);
  const int lane_k = arg(8), num_queries = arg(11), pass_queries = arg(12), slots = arg(13);
  const int num_partitions = arg(14);
  const bool merged = p[17] != 0;
  const int64_t lists = p[19];
  if (codec == codec::kH16 || num_buckets < 1 || num_queries < 1 || pass_queries < 1 ||
      slots < 1 || slots > (1 << 24) || num_partitions < 1 || num_partitions > 65535 ||
      block_sublanes < octet::kMembers || block_sublanes % octet::kMembers ||
      !codec::table_rows_ok(codec, table_rows))
    return cudaErrorInvalidValue;
  const int passes = (num_queries + pass_queries - 1) / pass_queries;
  const int set_size = lane_merge::set_size_of(slots);
  const int sets = (slots + set_size - 1) / set_size;
  const int64_t qp = (int64_t)num_queries * num_partitions;
  if (passes > 65535 || (merged ? lists < qp * (slots + sets) : lists < qp * slots) ||
      (merged && p[21] < (int64_t)passes * num_partitions * 4 * (1 + sets)))
    return cudaErrorInvalidValue;
  float* ws_v = static_cast<float*>(ptr(18));
  int32_t* ws_t = reinterpret_cast<int32_t*>(ws_v + lists * lane_k * octet::kLanes);
  k6::Call c{};
  c.p = batch::Params{static_cast<const int32_t*>(ptr(0)), ptr(1),
                      static_cast<const int32_t*>(ptr(2)), static_cast<const int32_t*>(ptr(3)),
                      num_buckets, block_sublanes, table_rows, codec::sign_shift(codec),
                      num_queries, arg(15), arg(16), merged, set_size, ws_v, ws_t,
                      static_cast<unsigned*>(ptr(20)), static_cast<float*>(ptr(22)),
                      static_cast<int32_t*>(ptr(23))};
  c.codec = codec;
  c.lane_k = lane_k;
  c.pass_queries = pass_queries;
  c.slots = slots;
  c.num_partitions = num_partitions;
  c.passes = passes;
  c.exact = p[9] != 0;
  c.tie_safe = p[10] != 0;
  c.stream = static_cast<cudaStream_t>(ptr(24));
  using namespace codec;
  cudaError_t err;
  switch (codec) {
    case kF32: err = k6::run_f32(c); break;
    case kF32Global: err = k6::run_f32g(c); break;
    case kInt8x4: err = k6::run_int8x4(c); break;
    case kInt8x4Global: err = k6::run_int8x4g(c); break;
    case kI8s: err = k6::run_i8s(c); break;
    default: err = k6::run_i4s(c);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
