// Pieces shared by the slice-stream kernels: K7 (slice_topk.cu), K8
// (slice_topk_batch.cu) and K9 (slice_scores.cu).
//
// The stream (formats/sell_buckets.py::fuse_buckets) is a sequence of
// uniform blocks of block_sublanes rows x 128 lanes of int32 words. A
// narrow bucket holds spb slices per block, slice j on rows j*W ..
// (j+1)*W - 1; a wide bucket holds one slice per bps blocks, on the first
// W rows of the span. Lane l of a slice's rows is one matrix row, so a
// slice's 128 row scores are 128 independent sums of W decoded words.
// The bucket plan is an int32 (B, 6) table (ops/kernel.py::
// slice_plan_rows).
//
// On the TPU a slice is a run of W sublanes, and because the VPU works on
// (8, 128) tiles the JAX kernel splits the chunks that straddle two
// slices when 8 does not divide W (the period machinery of
// _fused_kernel). A GPU thread just adds up its lane's W words, so none of
// that is carried over. What is carried over exactly is which slice
// scores reach the Top-K buffers (the harvest), because that decides the
// candidates: Walker cuts the stream into the work items of
// ops/kernel.py::slice_work, the same rules written twice. A partitioned
// stream is P such streams on one plan, the grid's y index the partition
// (octet_common.cuh::partition); a partition's buckets may hold more
// blocks than its slices need (the shared skeleton), and the Walker skips
// slices at or past the bucket's real count.

#pragma once

#include "octet_common.cuh"

namespace slice {

constexpr int kLanes = 128;
constexpr int kPlanCols = 6;
constexpr int kChunk = 8;           // rows per chunk of the JAX kernels
constexpr int kRun = 8;             // ops/kernel.py::_RUN
constexpr int kUnrollChunks = 128;  // ops/kernel.py::_UNROLL_CHUNKS
enum PlanCol { kWidth, kSpb, kBps, kSliceBase, kBlkStart, kNumBlocks };
enum Mode { kWide, kRuns, kTiled };  // ops/kernel.py: WIDE, RUNS, TILED

// Single-query codecs: the per-word product added to a lane's sum.
// kShared says whether the sweeps copy the query table into shared
// memory first (else each gather reads it from global memory).
// h16: two nnz per word against the int4x8 table (128 int32), summed in
// int32 (exact in any order) and converted to float once per slice, or
// once per block of a wide slice, as the JAX kernel does.
struct H16 {
  using Tab = int32_t;
  using Acc = int32_t;
  static constexpr bool kShared = true;
  __device__ static __forceinline__ Acc add(Acc a, uint32_t u, const Tab* tab, int) {
    return a + octet::prod_h16(static_cast<int32_t>(u), tab);
  }
  __device__ static __forceinline__ float finish(Acc a) { return static_cast<float>(a); }
};

// f32: one nnz per word, col[16:32) | bf16 value[0:16), against the
// (table_rows x 128) f32 table; lane col & 127 of row col >> 7, or of
// row 0 past the table (_gather_from_bcs). Multiply, then add, each
// rounded: no FMA contraction, as on the TPU. The sum runs in row order
// from 0, so it agrees with the TPU's two interleaved accumulators to
// rounding, and with the plain version (ops/kernel.py::_row_sum) bit for
// bit. SHARED: the table sits in shared memory; otherwise (a table larger
// than a block's shared memory, ops/kernel.py::f32_tables_in_smem) each
// gather reads global memory through the read-only path: 256 KB at the
// widest table (65,536 columns), which stays in L2 and L1. The arithmetic
// is the same either way.
template <bool SHARED>
struct F32T {
  using Tab = float;
  using Acc = float;
  static constexpr bool kShared = SHARED;
  __device__ static __forceinline__ Acc add(Acc a, uint32_t u, const Tab* tab, int table_rows) {
    const uint32_t col = u >> 16;
    const uint32_t idx = (col >> 7) < static_cast<uint32_t>(table_rows) ? col : (col & 0x7Fu);
    const float q = SHARED ? tab[idx] : __ldg(tab + idx);
    return __fadd_rn(a, __fmul_rn(__uint_as_float(u << 16), q));
  }
  __device__ static __forceinline__ float finish(Acc a) { return a; }
};
using F32 = F32T<true>;
using F32Global = F32T<false>;

// The query table a sweep gathers from: copied into shared memory by
// the block's threads (C::kShared), else the global table itself.
template <class C>
__device__ __forceinline__ const typename C::Tab* stage_table(unsigned char* smem,
                                                            const typename C::Tab* table,
                                                            int table_rows, int lane) {
  if (!C::kShared) return table;
  typename C::Tab* tab = reinterpret_cast<typename C::Tab*>(smem);
  for (int i = lane; i < table_rows * kLanes; i += kLanes) tab[i] = table[i];
  __syncthreads();
  return tab;
}

template <class C>
inline size_t table_smem_bytes(int table_rows) {
  return C::kShared ? sizeof(typename C::Tab) * table_rows * kLanes : 0;
}

using octet::Partition;
using octet::partition;

// One bucket of the plan and how it is cut into work items
// (ops/kernel.py::slice_work). A unit is a block of a narrow bucket or a
// slice of a wide one; per_unit work items per unit.
struct Bucket {
  int width, spb, bps, slice_base, blk_start, n_real;
  int mode, units, per_unit;
  int Gp, Ps, nper;   // kTiled: sub-tiles of Ps periods, nper periods a block
};

__device__ __forceinline__ Bucket load_bucket(const int32_t* plan, const int32_t* nreal,
                                              int b, int fold_tile) {
  const int32_t* p = plan + b * kPlanCols;
  Bucket k;
  k.width = __ldg(p + kWidth);
  k.spb = __ldg(p + kSpb);
  k.bps = __ldg(p + kBps);
  k.slice_base = __ldg(p + kSliceBase);
  k.blk_start = __ldg(p + kBlkStart);
  k.n_real = __ldg(nreal + b);
  const int nb = __ldg(p + kNumBlocks);
  k.Gp = k.Ps = k.nper = 0;
  if (k.bps > 1) {
    k.mode = kWide;
    k.units = nb / k.bps;
    k.per_unit = 1;
    return k;
  }
  k.units = nb;
  int g = kChunk;                    // gcd(W, 8): 8 is a power of two
  while (k.width % g) g >>= 1;
  const int Ps = kChunk / g;         // slices per period of whole chunks
  const int nper = k.spb / Ps;
  if (fold_tile > 1 && nper * (Ps * k.width / kChunk) <= kUnrollChunks) {
    k.mode = kTiled;
    k.Ps = Ps;
    k.nper = nper;
    k.Gp = (nper + fold_tile - 1) / fold_tile;
    k.per_unit = k.Gp * Ps + k.spb - nper * Ps;
  } else {
    k.mode = kRuns;
    k.per_unit = (k.spb + kRun - 1) / kRun;
  }
  return k;
}

// One work item: count member slices j0, j0 + dj, ... of one unit.
struct Item {
  const int32_t* src;   // the lane's word of the unit's first row
  int u;                // unit
  int j0, dj, count;    // members (slice index within the block)
  bool top2;            // harvest the top 2 of the members, else each one
};

// Walks the work items of every bucket in increasing order: the bucket
// cursor only moves forward, so item indices must not decrease.
struct Walker {
  const int32_t* words;
  const int32_t* plan;
  const int32_t* nreal;
  int num_buckets, block_sublanes, fold_tile, lane;
  int b, first;         // current bucket and its first item
  Bucket k;

  __device__ __forceinline__ Walker(const int32_t* w, const int32_t* p, const int32_t* n, int nb,
                                    int bs, int ft, int ln)
      : words(w), plan(p), nreal(n), num_buckets(nb), block_sublanes(bs), fold_tile(ft),
        lane(ln), b(0), first(0) {
    k = load_bucket(plan, nreal, 0, fold_tile);
  }

  // Work item g; false past the last one.
  __device__ __forceinline__ bool locate(int g, Item& it) {
    while (g >= first + k.units * k.per_unit) {
      first += k.units * k.per_unit;
      if (++b >= num_buckets) return false;
      k = load_bucket(plan, nreal, b, fold_tile);
    }
    const int r = g - first;
    it.u = r / k.per_unit;
    const int gi = r % k.per_unit;
    const int64_t blk = k.mode == kWide ? (int64_t)k.blk_start + (int64_t)it.u * k.bps
                                        : (int64_t)k.blk_start + it.u;
    it.src = words + blk * block_sublanes * kLanes + lane;
    it.j0 = 0;
    it.dj = 1;
    it.count = 1;
    it.top2 = false;
    if (k.mode == kRuns) {
      it.j0 = gi * kRun;
      it.count = min(kRun, k.spb - it.j0);
    } else if (k.mode == kTiled) {
      const int nt = k.Gp * k.Ps;
      if (gi < nt) {                // sub-tile (g, s): slice s of periods g, g + Gp, ...
        const int gp = gi / k.Ps;
        it.j0 = k.Ps * gp + gi % k.Ps;
        it.dj = k.Ps * k.Gp;
        it.count = min(fold_tile, (k.nper - gp + k.Gp - 1) / k.Gp);
        it.top2 = true;
      } else {                      // a block's last slices, one at a time
        it.j0 = k.nper * k.Ps + gi - nt;
      }
    }
    return true;
  }

  // Bucket-relative slice index of member m (the unit's for a wide slice)
  __device__ __forceinline__ int slice_of(const Item& it, int m) const {
    return k.mode == kWide ? it.u : it.u * k.spb + it.j0 + m * it.dj;
  }
  __device__ __forceinline__ bool real(const Item& it, int m) const {
    return slice_of(it, m) < k.n_real;
  }
  __device__ __forceinline__ int tag(const Item& it, int m) const {
    return k.slice_base + slice_of(it, m);
  }
  // Rows of member m: narrow, W rows from src; wide, the span's blocks.
  __device__ __forceinline__ const int32_t* rows_of(const Item& it, int m) const {
    return k.mode == kWide ? it.src : it.src + (int64_t)(it.j0 + m * it.dj) * k.width * kLanes;
  }
};

template <class C>
__device__ __forceinline__ typename C::Acc rows_sum(const int32_t* src, int rows,
                                                    const typename C::Tab* tab, int table_rows) {
  typename C::Acc acc = 0;
#pragma unroll 4
  for (int r = 0; r < rows; ++r)
    acc = C::add(acc, static_cast<uint32_t>(__ldg(src + (int64_t)r * kLanes)), tab, table_rows);
  return acc;
}

// Member m's score: its W words summed; a wide slice sums each block,
// converts, and adds the block sums up in float in block order (the JAX
// kernel's carry).
template <class C>
__device__ __forceinline__ float member_score(const Walker& w, const Item& it, int m,
                                              const typename C::Tab* tab, int table_rows) {
  const int32_t* src = w.rows_of(it, m);
  if (w.k.mode != kWide) return C::finish(rows_sum<C>(src, w.k.width, tab, table_rows));
  float carry = 0.0f;
  for (int blk = 0; blk < w.k.bps; ++blk) {
    const int rows = min(w.block_sublanes, w.k.width - blk * w.block_sublanes);
    carry = __fadd_rn(carry, C::finish(rows_sum<C>(
        src + (int64_t)blk * w.block_sublanes * kLanes, rows, tab, table_rows)));
  }
  return carry;
}

// Shared memory beyond the 48 KB default needs opting in per kernel.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace slice
