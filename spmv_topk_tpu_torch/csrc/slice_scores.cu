// Plain SpMV over the slice stream (kernel K9) for Hopper (sm_90a), every
// query codec (codecs.cuh), stored in slice order or straight to row
// order.
//
// Replaces spmv_topk_tpu/ops/kernel.py::_fused_scores_kernel (the
// pallas_call of spmv_fused_scores_device, :1909, with its (P,
// num_blocks) partition grid too: the partition is the grid's y index,
// and partition p's slice tags are offset by p * part_slices, against the
// stacked row_ids) and the host gather of its tiles into row order that
// followed it (spmv_topk_tpu/api.py:535-560).
//
// What it computes. Every real slice's 128 row scores: a lane adds up its
// W decoded words in row order from 0 (h16 in int32, converted to float
// once; the float codecs one rounded multiply and one rounded add at a
// time, no FMA); a wide slice sums each block of its span so and adds the
// block sums in float in block order from 0 (the JAX kernel's carry).
// These are ops/kernel.py::slice_scores_plain's scores bit for bit. They
// go to slice order, row tag of a (num_slices, 128) f32 output, or
// straight to row order: out[row] = score * factor (one rounded multiply)
// for row = row_ids[tag, lane] >= 0, every other row left as it is (the
// caller's zero fill). Each matrix row sits on one slice lane, so no two
// lanes write one row. Padding slices past a bucket's real count are not
// read.
//
// Bound. A query reads every word once and writes 4 bytes a slice row:
// 430 MB of h16 words for bench.py's slice engine and 41 MB of
// slice-order scores, 0.140 ms at 3.35 TB/s; in row order the 41 MB of
// row_ids are read and 40 MB of rows written, 0.153 ms. A few operations
// and one or two shared-memory gathers a word: bound by device memory
// bytes.
//
// Design. A warp sums one slice at a time: thread t owns lanes 4t ..
// 4t + 3 and reads them with one 16-byte load a row, so each load of the
// warp takes a whole 512-byte row and a thread keeps four independent
// sums. Two groups of kRows rows are in flight: a group's loads are
// issued before the group before it is decoded (two groups of 4 rows held
// 8 more registers than ptxas gave the kernel, 64, and spilled). The
// warps of the grid (one resident wave, ops/kernel.py::slice_scores_grid)
// take the partition's real slices in turn in the plan's order
// (fuse_buckets lays the widest bucket first), so every round hands the
// warps slices of nearly one width and the last rounds are the
// narrowest. The query table is staged as codecs.cuh stages it (h16's
// 128-entry row in a static array; spreading it over the 32 banks, an
// entry a lane's bank, took 8% longer on the H100). The store is one
// 16-byte store of four scores (slice order), or one 16-byte load of four
// row ids and four scattered 4-byte stores (row order). The words and the
// row ids are loaded cache-streaming (L2 evict-first) and the rows stored
// L2 evict-last (octet_common.cuh::store_kept), so that the 40 MB of rows
// stay in the 50 MB L2 while the stream passes through it. Measured on
// the H100 (experiments/k9_ablation.py, slice h16, the loads' hint then a
// createpolicy evict-first one): the kernel alone 0.18 ms in slice order,
// 0.26 in row order, 0.59 in row order without the loads' hint, 0.30
// without the stores'.

#include <cstring>

#include "slice_common.cuh"

namespace {

using namespace slice;

constexpr int kWarps = 16;               // warps a block (ops/kernel.py::K9_WARPS)
constexpr int kThreads = kWarps * 32;
constexpr int kVec = 4;                  // lanes a thread: a 16-byte load a row
constexpr int kRowVecs = kLanes / kVec;  // 16-byte words a row
constexpr int kRows = 2;                 // rows of a load group

// The kernel's arguments.
struct Params {
  const int32_t* words;
  const void* table;
  const int32_t* nreal;
  const int32_t* plan;
  int num_buckets, block_sublanes, table_rows, shift, part_rows, part_slices;
  float* out;
  const int32_t* row_ids;   // row order; slice order without
  float factor;
};

// Bucket b of the plan as K9 walks it: n real slices.
struct Bkt {
  int width, spb, bps, slice_base, blk_start, n;
};

__device__ __forceinline__ Bkt load_bkt(const int32_t* plan, const int32_t* nreal, int b) {
  const int32_t* p = plan + b * kPlanCols;
  return {__ldg(p + kWidth), __ldg(p + kSpb), __ldg(p + kBps), __ldg(p + kSliceBase),
          __ldg(p + kBlkStart), max(__ldg(nreal + b), 0)};
}

// The loads of rows r0 .. r0 + kRows - 1 of a span, those below `rows`
// (cache-streaming: L2 evict-first).
__device__ __forceinline__ void load_group(int4 (&v)[kRows], const int4* src, int r0, int rows) {
#pragma unroll
  for (int i = 0; i < kRows; ++i)
    if (r0 + i < rows) v[i] = __ldcs(src + (int64_t)(r0 + i) * kRowVecs);
}

// Those rows added to the thread's four sums, in row order.
template <class C>
__device__ __forceinline__ void add_group(typename C::Acc (&acc)[kVec], const int4 (&v)[kRows],
                                          int r0, int rows, const Table<typename C::Tab>& tab) {
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    if (r0 + i < rows) {
      acc[0] = C::add(acc[0], static_cast<uint32_t>(v[i].x), tab);
      acc[1] = C::add(acc[1], static_cast<uint32_t>(v[i].y), tab);
      acc[2] = C::add(acc[2], static_cast<uint32_t>(v[i].z), tab);
      acc[3] = C::add(acc[3], static_cast<uint32_t>(v[i].w), tab);
    }
  }
}

// The thread's four lanes of a span of `rows` rows from src (its 16 bytes
// of the span's first row), each summed in row order from 0; the next
// group's loads in flight while a group is added.
template <class C>
__device__ __forceinline__ void span_sums(const int4* src, int rows,
                                          const Table<typename C::Tab>& tab,
                                          typename C::Acc (&acc)[kVec]) {
#pragma unroll
  for (int k = 0; k < kVec; ++k) acc[k] = 0;
  int4 a[kRows], b[kRows];
  load_group(a, src, 0, rows);
  for (int r = 0; r < rows; r += 2 * kRows) {
    load_group(b, src, r + kRows, rows);
    add_group<C>(acc, a, r, rows, tab);
    load_group(a, src, r + 2 * kRows, rows);
    add_group<C>(acc, b, r + kRows, rows, tab);
  }
}

// The thread's four scores of a slice of `width` rows from src: one span,
// or (a wide slice, bps > 1) a span a block, the block sums added in float
// in block order from 0.
template <class C>
__device__ __forceinline__ void slice_sums(const int4* src, int width, int bps,
                                           int block_sublanes,
                                           const Table<typename C::Tab>& tab,
                                           float (&sc)[kVec]) {
  typename C::Acc acc[kVec];
  if (bps == 1) {
    span_sums<C>(src, width, tab, acc);
#pragma unroll
    for (int k = 0; k < kVec; ++k) sc[k] = C::finish(acc[k]);
    return;
  }
#pragma unroll
  for (int k = 0; k < kVec; ++k) sc[k] = 0.0f;
  for (int r0 = 0; r0 < width; r0 += block_sublanes) {
    span_sums<C>(src + (int64_t)r0 * kRowVecs, min(block_sublanes, width - r0), tab, acc);
#pragma unroll
    for (int k = 0; k < kVec; ++k) sc[k] = __fadd_rn(sc[k], C::finish(acc[k]));
  }
}

template <class C, bool ROWS>
__global__ void __launch_bounds__(kThreads) slice_scores_kernel(const Params a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const auto tab = codec::stage_block<C, kThreads>(
      smem, static_cast<const typename C::Tab*>(a.table), a.table_rows, a.shift);
  const uint64_t keep = octet::evict_last_policy();   // the row stores
  const Partition part = partition(a.words, a.nreal, a.num_buckets, a.part_rows, a.part_slices);
  const int t = threadIdx.x % 32;
  const int warps = gridDim.x * kWarps;
  // the bucket cursor: bucket b holds the partition's real slices first ..
  // end - 1, in the plan's order
  int b = -1, first = 0, end = 0;
  Bkt k{};
  for (int g = blockIdx.x * kWarps + threadIdx.x / 32;; g += warps) {
    while (g >= end) {
      if (++b >= a.num_buckets) return;
      k = load_bkt(a.plan, part.nreal, b);
      first = end;
      end += k.n;
    }
    const int s = g - first;   // the slice within its bucket
    int64_t row0;
    if (k.bps == 1) {
      const int u = s / k.spb;
      row0 = (int64_t)(k.blk_start + u) * a.block_sublanes + (int64_t)(s - u * k.spb) * k.width;
    } else {
      row0 = ((int64_t)k.blk_start + (int64_t)s * k.bps) * a.block_sublanes;
    }
    float sc[kVec];
    slice_sums<C>(reinterpret_cast<const int4*>(part.words + row0 * kLanes) + t, k.width,
                  k.bps, a.block_sublanes, tab, sc);
    const int64_t at = ((int64_t)part.tag_offset + k.slice_base + s) * kRowVecs + t;
    if constexpr (ROWS) {
      const int4 r = __ldcs(reinterpret_cast<const int4*>(a.row_ids) + at);
      if (r.x >= 0) octet::store_kept(a.out + r.x, __fmul_rn(sc[0], a.factor), keep);
      if (r.y >= 0) octet::store_kept(a.out + r.y, __fmul_rn(sc[1], a.factor), keep);
      if (r.z >= 0) octet::store_kept(a.out + r.z, __fmul_rn(sc[2], a.factor), keep);
      if (r.w >= 0) octet::store_kept(a.out + r.w, __fmul_rn(sc[3], a.factor), keep);
    } else {
      reinterpret_cast<float4*>(a.out)[at] = make_float4(sc[0], sc[1], sc[2], sc[3]);
    }
  }
}

// One launch, or (blocks_per_sm set) the occupancy API's resident blocks
// an SM of the launch's kernel.
struct Call {
  Params p;
  int codec, blocks, num_partitions;
  bool rows;   // the row-order store
  cudaStream_t stream;
  int* blocks_per_sm;
};

template <class C, bool ROWS>
cudaError_t run(const Call& c) {
  auto kernel = slice_scores_kernel<C, ROWS>;
  const size_t smem = codec::table_smem_bytes<C, true>(c.p.table_rows);
  const cudaError_t err = codec::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  if (c.blocks_per_sm)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(c.blocks_per_sm, kernel, kThreads, smem);
  kernel<<<dim3(c.blocks, c.num_partitions), kThreads, smem, c.stream>>>(c.p);
  return cudaSuccess;
}

cudaError_t run_any(const Call& c) {
  if (!codec::table_rows_ok(c.codec, c.p.table_rows)) return cudaErrorInvalidValue;
  return codec::dispatch(c.codec, [&](auto tag) {
    using C = typename decltype(tag)::type;
    return c.rows ? run<C, true>(c) : run<C, false>(c);
  });
}

}  // namespace

extern "C" {

// Resident blocks an SM of the K9 kernel of (codec, store form: row_order
// 1 for the row-order store) with a table of table_rows rows (on the
// current device), or a negative cudaError_t.
int slice_scores_occupancy(int codec, int table_rows, int row_order) {
  int blocks = 0;
  Call c{};
  c.p.table_rows = table_rows;
  c.rows = row_order != 0;
  c.codec = codec;
  c.blocks_per_sm = &blocks;
  const cudaError_t err = run_any(c);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// One launch of K9 from its arguments packed as int64 values (one ctypes
// argument), in this order:
//   0 words: (num_partitions * part_rows, 128) int32, part_rows a whole
//     number of blocks; 1 table: (table_rows, 128), int32 (f32 for the
//     f32 codecs); 2 nreal: (num_partitions, num_buckets) int32; 3 plan:
//     (num_buckets, 6) int32 (ops/kernel.py::slice_plan_rows);
//   4 num_buckets, 5 block_sublanes, 6 table_rows, 7 codec
//     (codecs.cuh::Codec);
//   8 blocks: CUDA blocks a partition (ops/kernel.py::slice_scores_grid);
//   9 num_partitions; 10 part_rows; 11 part_slices: slice tags a
//     partition;
//   12 out: slice order (num_partitions * part_slices, 128) f32, rows of
//     real slices written; or row order, f32 rows, those of row_ids
//     written;
//   13 row_ids: 0 for slice order, else (num_partitions * part_slices,
//     128) int32 (-1 for no row); 14 factor: the row-order scale, f32 bits;
//   15 stream.
// Returns cudaGetLastError() (or the error of a refused launch).
int slice_scores(const int64_t* args) {
  Call c{};
  Params& p = c.p;
  p.words = reinterpret_cast<const int32_t*>(args[0]);
  p.table = reinterpret_cast<const void*>(args[1]);
  p.nreal = reinterpret_cast<const int32_t*>(args[2]);
  p.plan = reinterpret_cast<const int32_t*>(args[3]);
  p.num_buckets = static_cast<int>(args[4]);
  p.block_sublanes = static_cast<int>(args[5]);
  p.table_rows = static_cast<int>(args[6]);
  c.codec = static_cast<int>(args[7]);
  p.shift = codec::sign_shift(c.codec);
  c.blocks = static_cast<int>(args[8]);
  c.num_partitions = static_cast<int>(args[9]);
  p.part_rows = static_cast<int>(args[10]);
  p.part_slices = static_cast<int>(args[11]);
  p.out = reinterpret_cast<float*>(args[12]);
  p.row_ids = reinterpret_cast<const int32_t*>(args[13]);
  const uint32_t bits = static_cast<uint32_t>(args[14]);
  memcpy(&p.factor, &bits, sizeof(float));
  c.rows = p.row_ids != nullptr;
  c.stream = reinterpret_cast<cudaStream_t>(args[15]);
  if (p.num_buckets < 1 || c.blocks < 1 || c.num_partitions < 1 ||
      c.num_partitions > 65535)
    return cudaErrorInvalidValue;
  const cudaError_t err = run_any(c);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
