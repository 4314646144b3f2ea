// Pieces shared by the slice-stream kernels: K7 (slice_topk.cuh), K8
// (slice_topk_batch.cu) and K9 (slice_scores.cu). The work items and
// their members are Bucket's and members_of's for all three; K7 walks
// them with a cursor of its own (slice_topk.cuh::Walk), K8 and K9 with
// the Walker below.
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

using codec::Table;

using octet::Partition;
using octet::partition;

// One bucket of the plan and how it is cut into work items
// (ops/kernel.py::slice_work). A unit is a block of a narrow bucket or a
// slice of a wide one; per_unit work items per unit.
struct Bucket {
  int width, spb, bps, slice_base, blk_start, n_real;
  int mode, units, per_unit;
  int Gp, Ps, nper;   // kTiled: sub-tiles of Ps periods, nper periods a block
  int ps_log, q, rem; // kTiled: Ps = 1 << ps_log, nper = q Gp + rem
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
  k.Gp = k.Ps = k.nper = k.ps_log = k.q = k.rem = 0;
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
    k.ps_log = __ffs(Ps) - 1;
    if (k.Gp) {
      k.q = nper / k.Gp;
      k.rem = nper % k.Gp;
    }
  } else {
    k.mode = kRuns;
    k.per_unit = (k.spb + kRun - 1) / kRun;
  }
  return k;
}

// The members of a work item: count slices j0, j0 + dj, ... of its unit
// (slice index within the block; a wide slice's one item is its span's
// slice 0), harvested as the top 2 of the members (top2) or each one.
struct Members {
  int j0, dj, count;
  bool top2;
};

// Item gi of one of bucket k's units (ops/kernel.py::slice_work).
__device__ __forceinline__ Members members_of(const Bucket& k, int gi, int fold_tile) {
  Members m{0, 1, 1, false};
  if (k.mode == kRuns) {
    m.j0 = gi * kRun;
    m.count = min(kRun, k.spb - m.j0);
  } else if (k.mode == kTiled) {
    if (gi < k.Gp * k.Ps) {   // sub-tile (g, s): slice s of periods g, g + Gp, ...
      const int g = gi >> k.ps_log;
      m.j0 = k.Ps * g + (gi & (k.Ps - 1));
      m.dj = k.Ps * k.Gp;
      m.count = min(fold_tile, k.q + (g < k.rem ? 1 : 0));
      m.top2 = true;
    } else {                  // a block's last slices, one at a time
      m.j0 = k.nper * k.Ps + gi - k.Gp * k.Ps;
    }
  }
  return m;
}

// One work item: its members (members_of) of unit u.
struct Item : Members {
  const int32_t* src;   // the lane's word of the unit's first row
  int u;                // unit
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
    static_cast<Members&>(it) = members_of(k, gi, fold_tile);
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

// A slice's rows summed in row order from 0 (h16 in int32; the float
// codecs one rounded add at a time, ops/kernel.py::_row_sum).
template <class C>
__device__ __forceinline__ typename C::Acc rows_sum(const int32_t* src, int rows,
                                                    const Table<typename C::Tab>& tab) {
  typename C::Acc acc = 0;
#pragma unroll 4
  for (int r = 0; r < rows; ++r)
    acc = C::add(acc, static_cast<uint32_t>(__ldg(src + (int64_t)r * kLanes)), tab);
  return acc;
}

// Member m's score: its W words summed; a wide slice sums each block,
// converts, and adds the block sums up in float in block order (the JAX
// kernel's carry).
template <class C>
__device__ __forceinline__ float member_score(const Walker& w, const Item& it, int m,
                                              const Table<typename C::Tab>& tab) {
  const int32_t* src = w.rows_of(it, m);
  if (w.k.mode != kWide) return C::finish(rows_sum<C>(src, w.k.width, tab));
  float carry = 0.0f;
  for (int blk = 0; blk < w.k.bps; ++blk) {
    const int rows = min(w.block_sublanes, w.k.width - blk * w.block_sublanes);
    carry = __fadd_rn(carry, C::finish(rows_sum<C>(
        src + (int64_t)blk * w.block_sublanes * kLanes, rows, tab)));
  }
  return carry;
}

}  // namespace slice
