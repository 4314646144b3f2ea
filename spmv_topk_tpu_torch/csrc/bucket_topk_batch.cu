// Kernel K12 (bucket_topk_batch.cuh): the h16 instantiations and the C
// entry point, which hands each other codec to its
// bucket_topk_batch_<codec>.cu.

#include "bucket_topk_batch.cuh"

namespace k12 {

cudaError_t run_h16(const Call& c) {
  switch (c.pass_queries) {
    case 8: return run_k<codec::H16Pass<8>>(c);
    case 16: return run_k<codec::H16Pass<16>>(c);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace k12

extern "C" {

// One launch of K12 from its arguments packed as int64 values (one ctypes
// argument, as K13's), in this order:
//   0 words: (num_slices * width, 128) int32, one bucket of
//     pack_sell_buckets; 1 tables: (Q, table_rows, 128), int32 (f32 for
//     the f32 codecs); 2 num_real: one int32 on the device;
//   3 num_slices, 4 width (h16 at most codecs.cuh::kH16x32MaxWidth),
//     5 table_rows, 6 codec (codecs.cuh::Codec), 7 lane_k, 8 tie_safe,
//     9 slice_base;
//   10 num_queries Q; 11 pass_queries: queries a pass reads the bucket for
//     (h16 8 or 16, the other codecs 8), ceil(Q / pass_queries) passes;
//     12 slots: a pass's,
//     128 / block lanes CUDA blocks each (ops/kernel.py::k12_launch);
//   13 merged: 0 leaves each slot's sorted buffers in the workspace, (Q,
//     slots, lane_k, 128) values then tags, and runs no merge (out_v,
//     out_t unused);
//   14 workspace: int32 storage of 15 workspace_lists x 2 x lane_k x 128
//     entries (values, then tags): at least Q x (slots + sets) lists,
//     sets = ceil(slots / ceil(sqrt(slots))), or Q x slots when not
//     merged;
//   16 tickets: 17 num_tickets unsigned zeros, at least passes x 4 x (1 +
//     sets) (the kernel leaves them 0);
//   18 out_v, 19 out_t: (Q, lane_k, 128), each lane's top lane_k, values
//     descending (then tags ascending); 20 stream.
// The launch is a programmatic dependent one: its sweep may overlap the
// tail of the stream's previous kernel (bucket_topk_batch.cuh).
// Returns cudaGetLastError() (or the error of a refused launch).
int bucket_topk_batch(const int64_t* p) {
  auto ptr = [&](int i) { return reinterpret_cast<void*>(static_cast<intptr_t>(p[i])); };
  auto arg = [&](int i) { return static_cast<int>(p[i]); };
  const int num_slices = arg(3), width = arg(4), table_rows = arg(5), codec = arg(6);
  const int lane_k = arg(7), num_queries = arg(10), pass_queries = arg(11), slots = arg(12);
  const bool merged = p[13] != 0;
  const int64_t lists = p[15];
  if (num_slices < 1 || width < 1 || num_queries < 1 || pass_queries < 1 || slots < 1 ||
      slots > (1 << 24) || (codec == codec::kH16 && width > codec::kH16x32MaxWidth) ||
      !codec::table_rows_ok(codec, table_rows))
    return cudaErrorInvalidValue;
  const int passes = (num_queries + pass_queries - 1) / pass_queries;
  const int set_size = lane_merge::set_size_of(slots);
  const int sets = (slots + set_size - 1) / set_size;
  if (passes > 65535 ||
      (merged ? lists < (int64_t)num_queries * (slots + sets)
              : lists < (int64_t)num_queries * slots) ||
      (merged && p[17] < (int64_t)passes * 4 * (1 + sets)))
    return cudaErrorInvalidValue;
  float* ws_v = static_cast<float*>(ptr(14));
  int32_t* ws_t = reinterpret_cast<int32_t*>(ws_v + lists * lane_k * octet::kLanes);
  k12::Call c{};
  c.p = k12::Params{static_cast<const int32_t*>(ptr(0)), ptr(1),
                    static_cast<const int32_t*>(ptr(2)), num_slices, width, table_rows,
                    codec::sign_shift(codec), arg(9), num_queries, merged, set_size, ws_v, ws_t,
                    static_cast<unsigned*>(ptr(16)), static_cast<float*>(ptr(18)),
                    static_cast<int32_t*>(ptr(19))};
  c.codec = codec;
  c.lane_k = lane_k;
  c.pass_queries = pass_queries;
  c.slots = slots;
  c.passes = passes;
  c.tie_safe = p[8] != 0;
  c.stream = static_cast<cudaStream_t>(ptr(20));
  using namespace codec;
  cudaError_t err;
  switch (codec) {
    case kH16: err = k12::run_h16(c); break;
    case kF32:
    case kF32Global: err = k12::run_f32(c); break;
    case kInt8x4:
    case kInt8x4Global: err = k12::run_int8x4(c); break;
    case kI8s: err = k12::run_i8s(c); break;
    default: err = k12::run_i4s(c);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
