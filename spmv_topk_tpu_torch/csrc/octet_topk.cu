// Kernel K1 (octet_topk.cuh): the h16 instantiations and the C entry
// points, which hand the other codecs to octet_topk_f32.cu and
// octet_topk_q.cu.

#include "octet_topk.cuh"

namespace {

cudaError_t run_any(const k1::Call& c) {
  using namespace codec;
  if (c.codec == kH16) return k1::run_codecs<codec_set<kH16>()>(c);
  if (c.codec == kF32 || c.codec == kF32Global) return k1::run_f32(c);
  return k1::run_quantized(c);
}

}  // namespace

extern "C" {

// Resident blocks an SM of the K1 kernel of (codec, lane_k, exact,
// tie_safe) with a table of table_rows rows (on the current device), or a
// negative cudaError_t.
int octet_topk_occupancy(int codec, int lane_k, int exact, int tie_safe, int table_rows) {
  if (!codec::table_rows_ok(codec, table_rows)) return -static_cast<int>(cudaErrorInvalidValue);
  int blocks = 0;
  k1::Call c{};
  c.p.table_rows = table_rows;
  c.codec = codec;
  c.lane_k = lane_k;
  c.exact = exact != 0;
  c.tie_safe = tie_safe != 0;
  c.blocks_per_sm = &blocks;
  const cudaError_t err = run_any(c);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// One launch of K1 from its arguments packed as int64 values (one ctypes
// argument, as K13's), in this order:
//   0 words: (num_partitions * part_rows, 128) int32, part_rows a whole
//     number of blocks; 1 table: (table_rows, 128), int32 (f32 for the
//     f32 codecs); 2 nreal: (num_partitions, num_buckets) int32; 3 plan:
//     (num_buckets, 8) int32 (ops/kernel.py::octet_plan_rows);
//   4 num_buckets, 5 block_sublanes, 6 table_rows, 7 codec
//     (codecs.cuh::Codec), 8 lane_k, 9 exact (fold_tile 1), 10 tie_safe;
//   11 blocks: CUDA blocks a partition, 4 slots each
//     (ops/kernel.py::octet_grid); 12 num_partitions; 13 part_rows;
//   14 part_slices: slice tags a partition;
//   15 merged: 0 leaves each slot's sorted buffer in the workspace,
//      (num_partitions, slots, lane_k, 128) values then tags, and runs no
//      merge (out_v, out_t unused);
//   16 workspace: int32 storage of 17 workspace_lists x 2 x lane_k x 128
//      entries (values, then tags): at least num_partitions x (blocks +
//      sets) lists, sets = ceil(blocks / ceil(sqrt(blocks))), or
//      num_partitions x slots when not merged;
//   18 tickets: 19 num_tickets unsigned zeros, at least num_partitions x
//      (1 + sets) (the kernel leaves them 0);
//   20 out_v, 21 out_t: (num_partitions, lane_k, 128), each lane's top
//      lane_k, values descending (then tags ascending); 22 stream.
// Returns cudaGetLastError() (or the error of a refused launch).
int octet_topk(const int64_t* p) {
  auto ptr = [&](int i) { return reinterpret_cast<void*>(static_cast<intptr_t>(p[i])); };
  auto arg = [&](int i) { return static_cast<int>(p[i]); };
  const int num_buckets = arg(4), table_rows = arg(6), codec = arg(7), lane_k = arg(8);
  const int blocks = arg(11), num_partitions = arg(12);
  const bool merged = p[15] != 0;
  const int64_t lists = p[17];
  if (num_buckets < 1 || blocks < 1 || blocks > (1 << 24) || num_partitions < 1 ||
      num_partitions > 65535 || !codec::table_rows_ok(codec, table_rows))
    return cudaErrorInvalidValue;
  const int set_size = lane_merge::set_size_of(blocks);
  const int sets = (blocks + set_size - 1) / set_size;
  if (merged ? lists < (int64_t)num_partitions * (blocks + sets) ||
                   p[19] < (int64_t)num_partitions * (1 + sets)
             : lists < (int64_t)num_partitions * blocks * k1::kGroups)
    return cudaErrorInvalidValue;
  float* ws_v = static_cast<float*>(ptr(16));
  int32_t* ws_t = reinterpret_cast<int32_t*>(ws_v + lists * lane_k * octet::kLanes);
  k1::Call c{};
  c.p = k1::Params{static_cast<const int32_t*>(ptr(0)), ptr(1),
                   static_cast<const int32_t*>(ptr(2)), static_cast<const int32_t*>(ptr(3)),
                   num_buckets, arg(5), table_rows, codec::sign_shift(codec), arg(13), arg(14),
                   set_size, merged, ws_v, ws_t, static_cast<unsigned*>(ptr(18)),
                   static_cast<float*>(ptr(20)), static_cast<int32_t*>(ptr(21))};
  c.codec = codec;
  c.lane_k = lane_k;
  c.blocks = blocks;
  c.num_partitions = num_partitions;
  c.exact = p[9] != 0;
  c.tie_safe = p[10] != 0;
  c.stream = static_cast<cudaStream_t>(ptr(22));
  const cudaError_t err = run_any(c);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
