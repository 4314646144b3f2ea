// Per-bucket Top-K of one query (kernel K13) for Hopper (sm_90a), every
// query codec (codecs.cuh), the lane merge included.
//
// Replaces spmv_topk_tpu/ops/kernel.py::_bucket_kernel (the pallas_call of
// topk_spmv_bucket_device).
//
// What it computes. Every real slice s (s < num_real) of one bucket:
// its 128 row scores as K11 computes them (the order of bucket_common.cuh::
// slice_score), folded into per-lane (value, tag) buffers of lane_k
// entries by argmin replacement (_topk_update: the first minimum when
// tie-safe, else every slot holding it, when score >= minimum), the tag
// the global slice id slice_base + s; then the buffers merged per lane
// into the final (lane_k, 128) pair, values descending. The JAX kernel
// folds the padding slices too, at -inf (a penalty added to their score):
// that moves no value, so they are skipped here.
//
// Slots. num_slots buffers (slots) take the slices in turn, slot j slices
// j, j + num_slots, ..., each starting from topk_init's entries; the merge
// takes each lane's top lane_k over every slot's entries, the initial
// ones included. The wrapper sets num_slots to one resident wave of
// groups, no more than the bucket's slices (ops/kernel.py::
// _bucket_topk_slots): the SM count x the occupancy API's resident blocks
// an SM (1: the launch bounds give a thread up to 128 registers) x 4
// slots. The non-tie-safe buffers depend on it at ties (a tied minimum is
// replaced in every slot that holds it).
//
// Merge order. Every merge keeps the first lane_k entries in the order
// value descending, then tag ascending (lane_merge.cuh, shared with K6
// h16); no NaN reaches a merge (the argmin replacement never admits one),
// and the merge's tree below gives what one merge of all slots gives
// (ops/kernel.py::lane_merge_plain, bucket_topk_slots_plain).
//
// Design. A CUDA block is kGroups groups of 128 threads, one group per
// slot and one thread per lane; the query table is staged in shared memory
// once for the block (an f32 table past shared memory is read from global
// memory, F32Global). A thread sums its lane of a slice with
// bucket_common.cuh::slice_score: the chunks in the outer loop, 16 loads
// in flight, the 8 rows' accumulators in registers. Up to 128 registers a
// thread (one block of 512 threads an SM) hold those loads, the 16
// accumulators and the lane buffer without a spill. The merge runs in the same launch,
// in three levels:
//   1. each block merges its groups' buffers in shared memory and writes
//      one sorted buffer to the workspace;
//   2. a ticket (__threadfence, then atomicAdd) elects the last block to
//      finish in each set of set_size consecutive blocks (set_size about
//      the square root of the grid); it merges the set's buffers, its
//      threads sharing the lanes (kGroups threads a lane, each keeping a
//      sorted register top-k of its buffers, then merged in shared
//      memory), and writes one buffer for the set;
//   3. a second ticket elects the last set, which merges the set buffers
//      the same way and writes the sorted outputs.
// Each elected block resets its ticket, so the next launch on the stream
// starts from 0. A launch with one set skips level 3. Levels 2 and 3 each
// run on one SM and read ~12 buffers there; with nothing to sweep a
// launch takes ~15 µs. So each bucket is launched as a programmatic
// dependent launch: its sweep runs while the previous launch merges, and
// it waits for that launch to complete (griddepcontrol.wait) before it
// touches the workspace, the tickets or its outputs.
//
// Bound. The bucket's words read once, bound by device memory bytes; the
// merge moves (blocks + sets) x lane_k x 1 KiB through L2 and writes
// lane_k x 1 KiB. One launch per bucket, nothing between it and the
// wrapper's return. On one H100 80GB HBM3 at 700 W the 9 f32 buckets of
// the 10M x 1024 corpus take 0.393 ms a query against a 0.277 ms bound
// (chip_smoke.py, bucket_path).

#include "bucket_common.cuh"
#include "lane_merge.cuh"

namespace {

using namespace bucket;
using namespace lane_merge;

constexpr int kGroups = 4;                  // slots (128-thread groups) a block
constexpr int kThreads = kGroups * kLanes;  // 512
constexpr int kMinBlocks = 1;               // resident blocks an SM the launch bounds ask

// The query table, copied into shared memory by all the block's threads
// (C::kShared), else the global table.
template <class C>
__device__ __forceinline__ Table<typename C::Tab> stage(unsigned char* smem,
                                                       const typename C::Tab* table, int rows,
                                                       int shift) {
  if constexpr (!C::kShared) {
    return {table, rows, shift};
  } else {
    typename C::Tab* tab = reinterpret_cast<typename C::Tab*>(smem);
    for (int i = threadIdx.x; i < rows * kLanes; i += kThreads) tab[i] = table[i];
    __syncthreads();
    return {tab, rows, shift};
  }
}

template <class C, int K>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
bucket_topk_kernel(const int32_t* __restrict__ words, const typename C::Tab* __restrict__ table,
                   const int32_t* __restrict__ num_real, int num_slices, int width,
                   int table_rows, int shift, bool tie_safe, int slice_base, int num_slots,
                   int set_size, float* ws_v, int32_t* ws_t, unsigned* tickets,
                   float* __restrict__ out_v, int32_t* __restrict__ out_t) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x % kLanes;
  const int group = threadIdx.x / kLanes;
  const int block = blockIdx.x;
  const int slot = block * kGroups + group;
  const auto tab = stage<C>(smem, table, table_rows, shift);

  float v[K];
  int32_t t[K];
  topk_init<K>(v, t, tie_safe);
  const int chunks = width / kChunk;
  const int n = real_slices(num_real, num_slices);
  if (slot < num_slots)
    for (int s = slot; s < n; s += num_slots)
      topk_update<K>(v, t,
                     slice_score<C>(words + (int64_t)s * width * kLanes + lane, chunks, tab),
                     slice_base + s, tie_safe);
  // The next launch on the stream (launched to overlap this one's tail)
  // may start its sweep now; this one touches the workspace, the tickets
  // and its outputs only once the launch before it has completed.
  asm volatile("griddepcontrol.launch_dependents;");
  asm volatile("griddepcontrol.wait;" ::: "memory");

  // 1. the block's slots -> its buffer in the workspace
  float* sv = reinterpret_cast<float*>(smem);
  int32_t* st = reinterpret_cast<int32_t*>(sv + kGroups * K * kLanes);
  sort<K>(v, t);
  __syncthreads();  // no thread reads the table any more
  combine<K>(v, t, sv, st, group, lane, min(kGroups, num_slots - block * kGroups));
  if (group == 0) store<K>(v, t, ws_v, ws_t, block, lane);

  // 2. the last block of each set -> the set's buffer (the outputs when
  // there is one set)
  const int blocks = gridDim.x;
  const int sets = (blocks + set_size - 1) / set_size;
  const int set = block / set_size;
  const int first = set * set_size;
  const int in_set = min(set_size, blocks - first);
  if (!arrive(tickets + 1 + set, in_set)) return;
  gather<K, kGroups>(v, t, ws_v, ws_t, first, in_set, group, lane);
  combine<K>(v, t, sv, st, group, lane, min(kGroups, in_set));
  if (sets == 1) {
    if (group == 0) store<K>(v, t, out_v, out_t, 0, lane);
    return;
  }
  if (group == 0) store<K>(v, t, ws_v, ws_t, blocks + set, lane);

  // 3. the last set -> the outputs
  if (!arrive(tickets, sets)) return;
  gather<K, kGroups>(v, t, ws_v, ws_t, blocks, sets, group, lane);
  combine<K>(v, t, sv, st, group, lane, min(kGroups, sets));
  if (group == 0) store<K>(v, t, out_v, out_t, 0, lane);
}

// Dynamic shared memory: the table (C::kShared), then the merge's lists in
// the same bytes.
template <class C, int K>
size_t smem_bytes(int table_rows) {
  const size_t tab = codec::table_smem_bytes<C, false>(table_rows);
  const size_t merge = (size_t)kGroups * K * kLanes * (sizeof(float) + sizeof(int32_t));
  return tab > merge ? tab : merge;
}

struct Args {
  const int32_t* words;
  const void* table;
  const int32_t* num_real;
  int num_slices, width, table_rows, shift, slice_base, num_slots;
  bool tie_safe;
  float* ws_v;
  int32_t* ws_t;
  unsigned* tickets;
  float* out_v;
  int32_t* out_t;
  cudaStream_t stream;
};

template <class C, int K>
cudaError_t launch(const Args& a) {
  auto kernel = bucket_topk_kernel<C, K>;
  const size_t smem = smem_bytes<C, K>(a.table_rows);
  const cudaError_t err = codec::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (a.num_slots + kGroups - 1) / kGroups;
  // a programmatic dependent launch, which may start once every block of
  // the stream's previous kernel has passed its sweep (a kernel that does
  // not say so counts as passing it when it completes)
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = a.stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, a.words, static_cast<const typename C::Tab*>(a.table),
                            a.num_real, a.num_slices, a.width, a.table_rows, a.shift, a.tie_safe,
                            a.slice_base, a.num_slots, set_size_of(blocks), a.ws_v, a.ws_t,
                            a.tickets, a.out_v, a.out_t);
}

template <class C, int K>
cudaError_t occupancy(int table_rows, int* blocks) {
  auto kernel = bucket_topk_kernel<C, K>;
  const size_t smem = smem_bytes<C, K>(table_rows);
  const cudaError_t err = codec::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, kThreads, smem);
}

// f(Tag<C>, integral_constant K) for a lane_k of 4, 8 or 16.
template <class F>
cudaError_t dispatch(int codec_arg, int lane_k, F&& f) {
  return codec::dispatch(codec_arg, [&](auto tag) {
    switch (lane_k) {
      case 4: return f(tag, std::integral_constant<int, 4>{});
      case 8: return f(tag, std::integral_constant<int, 8>{});
      case 16: return f(tag, std::integral_constant<int, 16>{});
      default: return cudaErrorInvalidValue;
    }
  });
}

}  // namespace

extern "C" {

// Resident blocks an SM of the K13 kernel of (codec, lane_k) with a table
// of table_rows rows (on the current device), or a negative cudaError_t.
int bucket_topk_occupancy(int codec, int lane_k, int table_rows) {
  if (!codec::table_rows_ok(codec, table_rows)) return -static_cast<int>(cudaErrorInvalidValue);
  int blocks = 0;
  const cudaError_t err = dispatch(codec, lane_k, [&](auto tag, auto k) {
    using C = typename decltype(tag)::type;
    return occupancy<C, decltype(k)::value>(table_rows, &blocks);
  });
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// One launch of K13 from its arguments packed as int64 values (one
// argument crosses from Python, not 18: ops/kernel.py::
// topk_spmv_bucket_device), in this order:
//   0 words: (num_slices * width, 128) int32;
//   1 table: (table_rows, 128), int32 (f32 for the f32 codecs);
//   2 num_real: one int32 on the device;
//   3 num_slices, 4 width, 5 table_rows, 6 codec (codecs.cuh::Codec),
//   7 lane_k, 8 tie_safe, 9 slice_base;
//   10 num_slots: the slots (ceil(num_slots / 4) CUDA blocks of 512
//      threads);
//   11 workspace: int32 storage of 12 workspace_buffers x 2 x lane_k x
//      128 entries, at least twice the blocks' count;
//   13 tickets: 14 num_tickets unsigned zeros, more than the blocks' count
//      (the kernel leaves them 0);
//   15 out_v, 16 out_t: (lane_k, 128); 17 stream.
// The launch is a programmatic dependent one: its sweep may overlap the
// tail of the stream's previous kernel (see launch).
// Returns cudaGetLastError() (or the error of a refused launch).
int bucket_topk(const int64_t* p) {
  auto ptr = [&](int i) { return reinterpret_cast<void*>(static_cast<intptr_t>(p[i])); };
  const int num_slices = static_cast<int>(p[3]), width = static_cast<int>(p[4]);
  const int table_rows = static_cast<int>(p[5]), codec = static_cast<int>(p[6]);
  const int lane_k = static_cast<int>(p[7]), num_slots = static_cast<int>(p[10]);
  const int workspace_buffers = static_cast<int>(p[12]), num_tickets = static_cast<int>(p[14]);
  const int blocks = (num_slots + kGroups - 1) / kGroups;
  if (num_slices < 1 || width < 1 || num_slots < 1 || workspace_buffers < 2 * blocks ||
      num_tickets <= blocks || !codec::table_rows_ok(codec, table_rows))
    return cudaErrorInvalidValue;
  float* ws_v = static_cast<float*>(ptr(11));
  int32_t* ws_t = reinterpret_cast<int32_t*>(ws_v + (int64_t)workspace_buffers * lane_k * kLanes);
  const Args a{static_cast<const int32_t*>(ptr(0)), ptr(1), static_cast<const int32_t*>(ptr(2)),
               num_slices, width, table_rows, codec::sign_shift(codec),
               static_cast<int>(p[9]), num_slots, p[8] != 0, ws_v, ws_t,
               static_cast<unsigned*>(ptr(13)), static_cast<float*>(ptr(15)),
               static_cast<int32_t*>(ptr(16)), static_cast<cudaStream_t>(ptr(17))};
  const cudaError_t err = dispatch(codec, lane_k, [&](auto tag, auto k) {
    using C = typename decltype(tag)::type;
    return launch<C, decltype(k)::value>(a);
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
