// Slice-stream Top-K sweep of one query (kernel K7; K10a with
// partitions) for Hopper (sm_90a), every query codec (codecs.cuh), the
// lane merge included. slice_topk.cu holds the h16 instantiations and the
// C entry points, slice_topk_f32.cu the f32 ones (the table in shared or
// global memory) and slice_topk_q.cu int8x4's, i8s's and i4s's
// (translation units of their own, so that nvcc builds them in parallel).
//
// Replaces spmv_topk_tpu/ops/kernel.py::_fused_kernel (:442): the
// pallas_call of topk_spmv_fused_device (:864) and, with P row
// partitions, of topk_spmv_fused_part_device (:927): partition p is the
// grid's y index, its tags offset by p * part_slices as the JAX kernel's
// toff, with a pool of its own, (P, lane_k, 128).
//
// What it computes. Every real slice's 128 row scores (slice_common.cuh:
// a lane adds up its W decoded words in row order from 0, h16 in int32;
// a wide slice adds its block sums in float in block order from 0),
// harvested into per-lane (value, slice tag) buffers of lane_k entries by
// argmin replacement (_topk_update): when score >= the buffer's minimum,
// replace the first slot holding it (TIE_SAFE) or every one. Which
// scores are harvested is the JAX kernel's rule (ops/kernel.py::
// slice_work, the work items of slice_common.cuh): each strided sub-tile
// of up to fold_tile slices of a tiled bucket gives its top 2 (lowest
// member among ties; a NaN member blocks the sub-tile, as tflush's NaN
// maximum does), every other slice is folded alone. Slices past a
// bucket's real count are skipped. A harvest first compares with the
// buffer's minimum (kept beside the buffer), which gives the same
// replacements. Then each lane's top lane_k of every slot's entries (the
// initial ones included) in the order value descending, then tag
// ascending: out[p] = (lane_k, 128).
//
// Slots. A slot is 128 threads, one lane each, one buffer a lane. The
// work items go to the slots by a static deal, the same on every launch
// (which items share a buffer decides the tags kept at ties):
// ops/kernel.py::k7_deal is its written twin and slice_topk_slots_plain
// computes what the kernel gives, bit for bit. An item's work is its
// real members' rows in whole chunks plus kItemCost (locating and
// harvesting it), 0 when it has no real member; item g goes to the slot
// holding its work's midpoint, floor((2 c(g) + w(g)) * slots / (2 C)),
// c(g) the work before it and C the partition's. So each slot takes a
// contiguous run of items and no slot does more than the mean and half
// the largest item's work beyond it. Each slot finds its run alone
// (slot_walk): a warp sums each bucket's work in closed form (its whole
// units, the one unit that holds its last real slices), then counts the
// items below the run's two midpoints.
//
// Bound. A query reads every packed word once: 430 MB of h16 words for
// bench.py's slice engine, 937 MB of f32 words for the default engine at
// the 10M x 1024 corpus (0.128 / 0.280 ms at 3.35 TB/s), the merge's
// lists a few hundred KB of L2 besides; a few operations and one
// shared-memory gather a word: bound by device memory bytes.
//
// Design. A CUDA block is kGroups slots (512 threads), one wave of them
// (the occupancy API's resident blocks an SM; ops/kernel.py::octet_grid,
// K1's grid). The query table sits in shared memory (h16's row in a
// static array, up to 227 KB for f32; an f32 table past that is read from
// global memory, F32Global), the buffer and the sums in registers. A
// slot reads its run in memory order, a member's W rows after another's
// (a slice's rows are contiguous, and a run's slices too), in chunks of
// up to kChunkRows rows of one member (a warp reads 128 contiguous bytes
// of a row, a slot 4 KB of a full chunk); each thread keeps the loads of
// the next two chunks of its slot's walk in flight and issues the next
// chunk's before it adds the current one's, across members, slices and
// items: the next item's first rows are in flight while an item is
// located and harvested. Three chunk buffers rotate (Sweep::run), so no
// register moves between them; a full chunk takes no predicates, a tail
// of at most half a chunk half the decodes. (Summing an item's members
// side by side, a row of each at a time, made each slot eight streams
// 512 bytes apart and took longer.) The merge runs in
// the same launch (lane_merge.cuh::merge_slots, as K1's): the slots'
// sorted buffers merge in shared memory, then in sets elected by tickets,
// into the outputs; its lists reuse the table's shared memory once the
// sweep is done. There is no torch op after the launch.
//
// Measured (experiments/k7_ablation.py; one H100 80GB HBM3 at 700 W, the
// 10M x 1024 corpus): the sweep is bound by its instructions more than by
// the stream. With its words made from their addresses instead of read,
// it takes 0.83 of its time on h16 words and 0.53 on f32 words; without
// the decode, 0.60 and 0.77; without buffer updates, 0.98-1.0. The deal
// counts whole chunks because a partial chunk costs a whole one's walk.

#pragma once

#include "lane_merge.cuh"
#include "slice_common.cuh"

namespace k7 {

using namespace slice;
using namespace lane_merge;
using octet::buffer_min;
using octet::topk_init;

constexpr int kGroups = 4;                  // slots (128-thread groups) a block
constexpr int kThreads = kGroups * kLanes;  // 512
constexpr int kMaxMembers = kRun;           // a run's slices; a sub-tile's fold_tile <= 8
constexpr int kChunkRows = 8;               // rows of one member a load step reads
// An item's work in the slots' deal beside its real members' chunks, in
// rows (ops/kernel.py::K7_ITEM_COST, which the plain version deals by)
constexpr int kItemCost = 16;

// A member's rows as the sweep reads them: whole chunks.
__device__ __forceinline__ int chunk_rows(int width) {
  return (width + kChunkRows - 1) / kChunkRows * kChunkRows;
}

// The kernel's arguments.
struct Params {
  const int32_t* words;
  const void* table;
  const int32_t* nreal;
  const int32_t* plan;
  int num_buckets, block_sublanes, table_rows, shift, fold_tile, part_rows, part_slices;
  SlotMerge merge;
};

// Bucket b of the partition as K7 deals and walks it: its work items
// (slice_common.cuh::Bucket) and how many of its units hold only real
// slices (full).
struct Seg {
  Bucket k;
  int full;
};

__device__ __forceinline__ Seg load_seg(const Params& a, const int32_t* nreal, int b) {
  Seg s;
  s.k = load_bucket(a.plan, nreal, b, a.fold_tile);
  const int n = max(s.k.n_real, 0);
  s.full = min(s.k.mode == kWide ? n : n / s.k.spb, s.k.units);
  return s;
}

// One work item as K7 reads it: member m's row j at words + off + (m
// mstride + j 128) + lane, its slice tag tag0 + m dj; nr real members
// (a prefix of its members: their slices increase with m).
struct Item {
  int64_t off;
  int mstride, nr, tag0, dj;
  bool top2;
};

// Item (u, gi) of bucket s: its members (slice_common.cuh::members_of),
// the real ones counted.
__device__ __forceinline__ Item item_of(const Seg& s, int u, int gi, int block_sublanes,
                                        int fold_tile) {
  const Bucket& k = s.k;
  const Members mb = members_of(k, gi, fold_tile);
  Item it;
  it.dj = mb.dj;
  it.top2 = mb.top2;
  if (k.mode == kWide) {
    it.off = ((int64_t)k.blk_start + (int64_t)u * k.bps) * block_sublanes * kLanes;
    it.mstride = 0;
    it.nr = u < k.n_real ? 1 : 0;
    it.tag0 = k.slice_base + u;
    return it;
  }
  const int j0 = mb.j0, count = mb.count;
  it.off = ((int64_t)k.blk_start + u) * block_sublanes * kLanes + (int64_t)j0 * k.width * kLanes;
  it.mstride = it.dj * k.width * kLanes;
  it.tag0 = k.slice_base + u * k.spb + j0;
  if (u < s.full) {
    it.nr = count;
  } else {
    const int rr = k.n_real - u * k.spb - j0;
    it.nr = rr <= 0 ? 0 : min(count, (rr + it.dj - 1) / it.dj);
  }
  return it;
}

// An item's work: its real members' rows in whole chunks, plus
// kItemCost; 0 with no real member.
__device__ __forceinline__ int64_t work_of(const Item& it, int width) {
  return it.nr > 0 ? (int64_t)it.nr * chunk_rows(width) + kItemCost : 0;
}

// The work of one of the bucket's whole units (every item real).
__device__ __forceinline__ int64_t unit_work(const Seg& s) {
  const int rows = chunk_rows(s.k.width);
  return s.k.mode == kWide ? rows + kItemCost
                           : (int64_t)s.k.spb * rows + (int64_t)s.k.per_unit * kItemCost;
}

// The bucket's work: its whole units', and unit `full`'s real items'.
__device__ __forceinline__ int64_t seg_work(const Seg& s, const Params& a) {
  int64_t w = s.full * unit_work(s);
  if (s.k.mode != kWide && s.full < s.k.units)
    for (int gi = 0; gi < s.k.per_unit; ++gi)
      w += work_of(item_of(s, s.full, gi, a.block_sublanes, a.fold_tile), s.k.width);
  return w;
}

// How many of the bucket's items have 2 c + w < X (c the work of the
// bucket's items before it, w its own): 2 c + w does not decrease along
// the items. Units below u0 lie wholly under X; from u0 on at most a unit
// and a half is walked (past the units with a real slice, every item has
// 2 c + w = 2 c, the bucket's whole work).
__device__ __forceinline__ int count_below(const Seg& s, const Params& a, int64_t X) {
  if (X <= 0) return 0;
  const int64_t U = unit_work(s);
  const int64_t below = X / (2 * U);
  const int u0 = below < s.full ? static_cast<int>(below) : s.full;
  int64_t c = u0 * U;
  int count = u0 * s.k.per_unit;
  for (int u = u0; u < s.k.units; ++u) {
    if (u > s.full) return count + (2 * c < X ? (s.k.units - u) * s.k.per_unit : 0);
    for (int gi = 0; gi < s.k.per_unit; ++gi) {
      const int64_t w = work_of(item_of(s, u, gi, a.block_sublanes, a.fold_tile), s.k.width);
      if (2 * c + w >= X) return count;
      c += w;
      ++count;
    }
  }
  return count;
}

// x summed over the warp's lanes up to this one, and over all 32.
__device__ __forceinline__ int64_t warp_prefix(int64_t x) {
  const int l = threadIdx.x % 32;
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const int64_t y = __shfl_up_sync(0xFFFFFFFFu, x, d);
    if (l >= d) x += y;
  }
  return x;
}
__device__ __forceinline__ int64_t warp_sum(int64_t x) {
  return __shfl_sync(0xFFFFFFFFu, warp_prefix(x), 31);
}

// A slot's walk over its run of items: the cursor (item gi of unit u of
// bucket b, the partition's item g), the run's end, the current item, its
// member m and that member's next row j.
struct Walk {
  Seg s;
  int b, u, gi, g, end, m, j;
  Item it;
};

// The cursor one item on (g + 1).
__device__ __forceinline__ void next_item(Walk& w, const Params& a, const int32_t* nreal) {
  ++w.g;
  if (++w.gi < w.s.k.per_unit) return;
  w.gi = 0;
  if (++w.u < w.s.k.units) return;
  w.u = 0;
  if (++w.b < a.num_buckets) w.s = load_seg(a, nreal, w.b);
}

// From the cursor on, the first item with a real member, or g >= end.
// A unit with no real slice sends the cursor to the next bucket.
__device__ __forceinline__ void settle(Walk& w, const Params& a, const int32_t* nreal) {
  while (w.g < w.end) {
    const bool none = w.s.k.mode == kWide ? w.u >= w.s.k.n_real
                                         : w.u * w.s.k.spb >= w.s.k.n_real;
    if (none) {   // nor in the bucket's later units
      w.g += (w.s.k.units - w.u) * w.s.k.per_unit - w.gi;
      w.u = w.gi = 0;
      if (++w.b < a.num_buckets) w.s = load_seg(a, nreal, w.b);
      continue;
    }
    w.it = item_of(w.s, w.u, w.gi, a.block_sublanes, a.fold_tile);
    if (w.it.nr > 0) break;
    next_item(w, a, nreal);
  }
  w.m = w.j = 0;
}

__device__ __forceinline__ void advance(Walk& w, const Params& a, const int32_t* nreal) {
  next_item(w, a, nreal);
  settle(w, a, nreal);
}

// Slot `slot`'s walk (settled) over its run [begin, end) of the
// partition's items: item g when floor((2 c(g) + w(g)) slots / (2 C)) ==
// slot. Each warp finds it alone, 32 buckets at a time: the partition's
// work C, then the items below each end's midpoint, then the bucket of
// the first.
__device__ __forceinline__ Walk slot_walk(const Params& a, const int32_t* nreal, int slot,
                                          int num_slots) {
  const int l = threadIdx.x % 32;
  int64_t C = 0;
  for (int b0 = 0; b0 < a.num_buckets; b0 += 32) {
    const int b = b0 + l;
    C += warp_sum(b < a.num_buckets ? seg_work(load_seg(a, nreal, b), a) : 0);
  }
  const int64_t T0 = (2 * slot * C + num_slots - 1) / num_slots;
  const int64_t T1 = (2 * (slot + 1) * C + num_slots - 1) / num_slots;
  int64_t before = 0, begin = 0, end = 0;
  for (int b0 = 0; b0 < a.num_buckets; b0 += 32) {
    const int b = b0 + l;
    const bool in = b < a.num_buckets;
    const Seg s = load_seg(a, nreal, min(b, a.num_buckets - 1));
    const int64_t w = in ? seg_work(s, a) : 0;
    const int64_t cb = before + warp_prefix(w) - w;   // the work before the bucket
    const int64_t items = (int64_t)s.k.units * s.k.per_unit;
    int64_t n0 = 0, n1 = 0;
    if (in) {
      n0 = 2 * cb >= T0 ? 0 : 2 * (cb + w) < T0 ? items : count_below(s, a, T0 - 2 * cb);
      n1 = 2 * cb >= T1 ? 0 : 2 * (cb + w) < T1 ? items : count_below(s, a, T1 - 2 * cb);
    }
    before += warp_sum(w);
    begin += warp_sum(n0);
    end += warp_sum(n1);
  }
  // the bucket of item `begin`: the first whose items reach past it
  Walk wk{};
  wk.g = static_cast<int>(begin);
  wk.end = static_cast<int>(end);
  int64_t first = 0;   // items before bucket b0
  wk.b = a.num_buckets;
  for (int b0 = 0; b0 < a.num_buckets; b0 += 32) {
    const int b = b0 + l;
    const Seg s = load_seg(a, nreal, min(b, a.num_buckets - 1));
    const int64_t items = b < a.num_buckets ? (int64_t)s.k.units * s.k.per_unit : 0;
    const int64_t upto = first + warp_prefix(items);
    const unsigned hit = __ballot_sync(0xFFFFFFFFu, b < a.num_buckets && begin < upto);
    if (hit) {
      const int src = __ffs(hit) - 1;
      const int r = static_cast<int>(begin - __shfl_sync(0xFFFFFFFFu, upto - items, src));
      wk.b = b0 + src;
      wk.s = load_seg(a, nreal, wk.b);
      wk.u = r / wk.s.k.per_unit;
      wk.gi = r % wk.s.k.per_unit;
      break;
    }
    first = __shfl_sync(0xFFFFFFFFu, upto, 31);
  }
  if (wk.b >= a.num_buckets) wk.g = wk.end;   // past the last item: an empty run
  settle(wk, a, nreal);
  return wk;
}

// The lane's words of the walk's next chunk: rows j .. j + kChunkRows - 1
// of member m (0 past its W rows).
__device__ __forceinline__ void load_chunk(uint32_t (&w)[kChunkRows], const Walk& wk,
                                           const int32_t* words, int lane) {
  const int32_t* row = words + wk.it.off + (int64_t)wk.m * wk.it.mstride +
                       (int64_t)wk.j * kLanes + lane;
  const int left = wk.s.k.width - wk.j;
  if (left >= kChunkRows) {
#pragma unroll
    for (int d = 0; d < kChunkRows; ++d) w[d] = static_cast<uint32_t>(__ldg(row + d * kLanes));
  } else {
#pragma unroll
    for (int d = 0; d < kChunkRows; ++d)
      w[d] = d < left ? static_cast<uint32_t>(__ldg(row + d * kLanes)) : 0u;
  }
}

// The walk a chunk on: the member's next rows, the item's next member, or
// the next item with a real member.
__device__ __forceinline__ void step(Walk& w, const Params& a, const int32_t* nreal) {
  w.j += kChunkRows;
  if (w.j < w.s.k.width) return;
  w.j = 0;
  if (++w.m < w.it.nr) return;
  advance(w, a, nreal);
}

// _topk_update's replacement of a score at or above the buffer's minimum
// tmin (kept beside the buffer): the first slot holding it (TIE_SAFE) or
// every one.
template <int K, bool TIE_SAFE>
__device__ __forceinline__ void replace(float (&tv)[K], int32_t (&tt)[K], float& tmin,
                                        float score, int32_t tag) {
  bool done = false;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    if (tv[s] == tmin && !done) {
      tv[s] = score;
      tt[s] = tag;
      if (TIE_SAFE) done = true;
    }
  }
  tmin = buffer_min(tv);
}

// A sub-tile's top 2 of its members' scores so far, in member order
// (lowest member among ties), and whether one was NaN.
struct Top2 {
  float m1, m2;
  int i1, i2;
  bool nan;
  __device__ __forceinline__ void clear() {
    m1 = m2 = -INFINITY;
    i1 = i2 = -1;
    nan = false;
  }
  __device__ __forceinline__ void add(float s, int m) {
    nan |= s != s;
    if (i1 < 0 || s > m1) {
      m2 = m1;
      i2 = i1;
      m1 = s;
      i1 = m;
    } else if (i2 < 0 || s > m2) {
      m2 = s;
      i2 = m;
    }
  }
};

// A slot's sweep: its two walks (`ld` issues the loads of the chunks
// ahead of `cs`, whose chunks the sums take), the lane's buffer and the
// sums of cs's member.
template <class C, int K, bool TIE_SAFE>
struct Sweep {
  Walk ld, cs;
  float tv[K];
  int32_t tt[K];
  float tmin;
  typename C::Acc acc;   // the member's sum of the block span
  float carry;           // a wide slice's block sums
  Top2 top;              // a sub-tile's
  int span1;             // where cs's block span ends

  // The loads of ld's next chunk into `next` (ld a chunk on), then cs's
  // chunk `cur` added up and, at a member's end, harvested; false once
  // cs's run is done. The caller rotates three chunk buffers, so that no
  // register moves between them and two chunks stay in flight.
  __device__ __forceinline__ bool run(const uint32_t (&cur)[kChunkRows],
                                      uint32_t (&next)[kChunkRows], const Params& a,
                                      const Partition& part,
                                      const codec::Table<typename C::Tab>& tab, int lane) {
    if (cs.g >= cs.end) return false;
    if (ld.g < ld.end) {
      load_chunk(next, ld, part.words, lane);
      step(ld, a, part.nreal);
    }
    const int width = cs.s.k.width;
    const int left = width - cs.j;
    if (left >= kChunkRows) {
#pragma unroll
      for (int d = 0; d < kChunkRows; ++d) acc = C::add(acc, cur[d], tab);
    } else if (left > kChunkRows / 2) {
#pragma unroll
      for (int d = 0; d < kChunkRows; ++d)
        if (d < left) acc = C::add(acc, cur[d], tab);
    } else {   // a tail of at most half a chunk: half the decodes
#pragma unroll
      for (int d = 0; d < kChunkRows / 2; ++d)
        if (d < left) acc = C::add(acc, cur[d], tab);
    }
    // block spans end at multiples of kChunkRows (ops/kernel.py::_slice_topk_cuda
    // refuses other block_sublanes), or at W
    cs.j += kChunkRows;
    const bool wide = cs.s.k.mode == kWide;
    if (wide && cs.j >= span1) {   // its block sum, in block order
      carry = __fadd_rn(carry, C::finish(acc));
      acc = 0;
      span1 = min(width, span1 + a.block_sublanes);
    }
    if (cs.j < width) return true;
    // the member's score, harvested: a sub-tile's when its last member is in
    const float sc = wide ? carry : C::finish(acc);
    acc = 0;
    carry = 0.0f;
    cs.j = 0;
    const int32_t tag0 = part.tag_offset + cs.it.tag0;
    if (!cs.it.top2) {
      if (sc >= tmin) replace<K, TIE_SAFE>(tv, tt, tmin, sc, tag0 + cs.m * cs.it.dj);
    } else {
      top.add(sc, cs.m);
      if (cs.m + 1 == cs.it.nr) {
        if (!top.nan && top.m1 >= tmin) {   // m2 <= m1: else neither enters
          replace<K, TIE_SAFE>(tv, tt, tmin, top.m1, tag0 + top.i1 * cs.it.dj);
          if (top.i2 >= 0 && top.m2 >= tmin)
            replace<K, TIE_SAFE>(tv, tt, tmin, top.m2, tag0 + top.i2 * cs.it.dj);
        }
        top.clear();
      }
    }
    if (++cs.m < cs.it.nr) return true;
    advance(cs, a, part.nreal);   // the next item, the next loads in flight
    span1 = min(cs.s.k.width, a.block_sublanes);
    return true;
  }
};

template <class C, int K, bool TIE_SAFE>
__global__ void __launch_bounds__(kThreads, 1) slice_topk_kernel(const Params a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x % kLanes;
  const int group = threadIdx.x / kLanes;
  const int num_slots = gridDim.x * kGroups;
  const int slot = blockIdx.x * kGroups + group;
  const auto tab = codec::stage_block<C, kThreads>(
      smem, static_cast<const typename C::Tab*>(a.table), a.table_rows, a.shift);
  const Partition part = partition(a.words, a.nreal, a.num_buckets, a.part_rows, a.part_slices);

  Sweep<C, K, TIE_SAFE> sw;
  topk_init<K, TIE_SAFE>(sw.tv, sw.tt);
  sw.tmin = buffer_min(sw.tv);
  sw.acc = 0;
  sw.carry = 0.0f;
  sw.top.clear();
  sw.ld = slot_walk(a, part.nreal, slot, num_slots);
  sw.cs = sw.ld;
  sw.span1 = min(sw.cs.s.k.width, a.block_sublanes);
  uint32_t r0[kChunkRows], r1[kChunkRows], r2[kChunkRows];
  if (sw.ld.g < sw.ld.end) {
    load_chunk(r0, sw.ld, part.words, lane);
    step(sw.ld, a, part.nreal);
  }
  if (sw.ld.g < sw.ld.end) {
    load_chunk(r1, sw.ld, part.words, lane);
    step(sw.ld, a, part.nreal);
  }
  while (sw.run(r0, r2, a, part, tab, lane) && sw.run(r1, r0, a, part, tab, lane) &&
         sw.run(r2, r1, a, part, tab, lane)) {
  }
  // The lane merge (lane_merge.cuh). Unmerged: each slot's sorted buffer,
  // list p * num_slots + slot of the workspace.
  merge_slots<K, kGroups>(sw.tv, sw.tt, smem, a.merge);
}

// Dynamic shared memory: the table (C::kShared, but h16's static row),
// then the merge's lists in the same bytes.
template <class C, int K>
size_t smem_bytes(int table_rows) {
  const size_t tab = codec::table_smem_bytes<C, true>(table_rows);
  const size_t merge = (size_t)kGroups * K * kLanes * (sizeof(float) + sizeof(int32_t));
  return tab > merge ? tab : merge;
}

// One launch, or (blocks_per_sm set) the occupancy API's resident blocks
// an SM of the launch's kernel.
struct Call {
  Params p;
  int codec, lane_k, blocks, num_partitions;
  bool tie_safe;
  cudaStream_t stream;
  int* blocks_per_sm;
};

template <class C, int K, bool TIE_SAFE>
cudaError_t run(const Call& c) {
  auto kernel = slice_topk_kernel<C, K, TIE_SAFE>;
  const size_t smem = smem_bytes<C, K>(c.p.table_rows);
  const cudaError_t err = codec::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  if (c.blocks_per_sm)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(c.blocks_per_sm, kernel, kThreads, smem);
  kernel<<<dim3(c.blocks, c.num_partitions), kThreads, smem, c.stream>>>(c.p);
  return cudaSuccess;
}

// The call for the codecs of `only` (codec::dispatch).
template <unsigned only>
cudaError_t run_codecs(const Call& c) {
  return codec::dispatch<only>(c.codec, [&](auto tag) {
    using C = typename decltype(tag)::type;
    switch (c.lane_k) {
      case 4: return c.tie_safe ? run<C, 4, true>(c) : run<C, 4, false>(c);
      case 8: return c.tie_safe ? run<C, 8, true>(c) : run<C, 8, false>(c);
      case 16: return c.tie_safe ? run<C, 16, true>(c) : run<C, 16, false>(c);
      default: return cudaErrorInvalidValue;
    }
  });
}

cudaError_t run_f32(const Call& c);         // f32, f32_global (slice_topk_f32.cu)
cudaError_t run_quantized(const Call& c);   // int8x4, i8s, i4s (slice_topk_q.cu)

}  // namespace k7
