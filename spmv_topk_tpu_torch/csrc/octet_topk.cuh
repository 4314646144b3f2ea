// Octet Top-K sweep of one query (kernel K1; K10b with partitions) for
// Hopper (sm_90a), every query codec (codecs.cuh), the lane merge
// included. octet_topk.cu holds the h16 instantiations and the C entry
// points, octet_topk_f32.cu the f32 ones (the table in shared or global
// memory) and octet_topk_q.cu int8x4's, i8s's and i4s's (translation
// units of their own, so that nvcc builds them in parallel).
//
// Replaces spmv_topk_tpu/ops/kernel.py::_fused_kernel_octet with its two
// dispatches: the one-call pallas_call of topk_spmv_fused_octet_device
// (cfg.octet_multicall False) and _octet_multicall's per-bucket calls with
// their per-lane lax.top_k merge; with P row partitions (grid y > 1), the
// pallas_call of topk_spmv_fused_octet_part_device (K10b).
//
// What it computes. The stream (formats/sell_buckets.py::
// fuse_buckets_octet) is a sequence of octets; chunk j (8 sublanes x 128
// lanes of int32) of octet o holds word j of the eight member slices
// slice_base + o + m*stride, m = 0..7, one per sublane. Each lane is one
// row of its slice. A lane adds up the decoded products of the octet's W
// chunks into 8 member scores (h16 in int32, converted once; the float
// codecs in the JAX kernel's order: the even and the odd chunks of each
// block span in two accumulators from 0, added together, a wide octet's
// span sums added in block order), sets members past the bucket's real
// slices to -inf, and harvests them into a lane_k-entry (value, slice tag)
// buffer: the top 3 of the 8 in three max / lowest-index passes, or each
// member in turn when fold_tile == 1 (EXACT); a NaN member blocks its
// octet's harvest (octet_common.cuh::harvest; the kernel runs its
// harvest_above, which stops at the first round below the buffer's
// minimum, with the same replacements). The buffer update is argmin
// replacement (_topk_update): replace the first minimum (TIE_SAFE) or
// every slot that holds the minimum, when score >= minimum. With P
// partitions, partition p (grid y) sweeps its own run of the words with
// its own real-slice counts, tags p * part_slices up (the JAX kernel's
// toff), and has its own pool; octets with no real member (the shared
// skeleton's padding) are skipped.
//
// Slots. A slot is 128 threads, one lane each, with one buffer a lane.
// The octets go to the slots by a static schedule, the same on every
// launch: which octets share a buffer decides the tags kept at ties (and,
// without TIE_SAFE, how many copies), so ops/kernel.py::
// octet_topk_slots_plain reproduces it bit for bit. Each slot takes a
// contiguous run of the partition's octets holding about C / num_slots of
// its work C, an octet's work w its chunks plus kOctetCost (what locating,
// masking and harvesting it costs, in chunks; ops/kernel.py::
// K1_OCTET_COST): octet o goes to the slot holding its work's midpoint,
// floor((2 c(o) + w(o)) * num_slots / (2 C)), c(o) the work before o (an
// octet with no real member counts 0 and is skipped), so no slot does
// more than the mean and half the widest octet's work beyond it.
// (Dealing the width-sorted octets one a slot in turn leaves the largest
// slot 1.29x the mean chunks on the headline corpus: chip_smoke.py's
// k1_slot_chunks_max_over_mean_*.) Then each
// lane's top lane_k of every slot's entries (the initial ones included)
// in the order value descending, then tag ascending: out[p] = (lane_k,
// 128).
//
// Bound. A query reads every packed word once: 449 MB of h16 words at the
// 10M x 1024 headline corpus, 0.134 ms at 3.35 TB/s, the merge and its
// lists a few hundred KB of L2 besides. About 10 operations and one or two
// shared-memory gathers a word: bound by device memory bytes.
//
// Design. A CUDA block is kGroups slots (512 threads), one wave of them
// (the occupancy API's resident blocks an SM; ops/kernel.py::octet_grid).
// The query table sits in shared memory (a static 512-byte row for h16,
// up to 227 KB for f32; an f32 table past that is read from global memory,
// F32Global), the lane buffer and the accumulators in registers. Against
// an idle stream: each thread keeps the loads of the next kAhead chunks of
// its slot's walk in flight (8 coalesced 4-byte loads a chunk, one lane of
// each member row: a warp reads 128 contiguous bytes of a row) and issues
// the next chunk's before the sums of the current one, across octets too,
// so the next octet's first chunks are in flight while an octet is
// located, masked and harvested. A thread holds one lane, so a load is 4
// bytes (a 16-byte load would need four lanes' buffers in its registers).
// The merge runs in the same launch, on the card, in three levels
// (lane_merge.cuh, as K13 does): each slot sorts its buffer and a block
// merges its slots' in shared memory into one list of the workspace; a
// ticket (__threadfence, then atomicAdd) elects the last block to finish
// in each set of about sqrt(blocks) blocks, which merges the set's lists;
// a second ticket elects the last set, which merges the sets' into the
// outputs. Each elected block resets its ticket. The merge's lists reuse
// the table's shared memory once the sweep is done, so the table keeps
// the block's whole opt-in budget. There is no torch op after the launch.
//
// Measured (experiments/k1_octet_cost.py; one H100 80GB HBM3 at 700 W,
// the headline corpus): an octet costs about a chunk's time beside its
// chunks (the locates, the mask, the harvest); slots balanced by chunks
// alone (kOctetCost 0) take about a quarter longer than with kOctetCost 1,
// with which the sweep reads the words about as fast as K3 does (PERF.md,
// sections 5 and 6).

#pragma once

#include "lane_merge.cuh"
#include "octet_common.cuh"

namespace k1 {

using namespace octet;
using namespace lane_merge;

constexpr int kGroups = 4;                  // slots (128-thread groups) a block
constexpr int kThreads = kGroups * kLanes;  // 512
// An octet's work in the slots' deal beside its chunks, in chunks
// (ops/kernel.py::K1_OCTET_COST, which the plain version deals by)
constexpr int kOctetCost = 1;
// Chunks a thread's loads run ahead of its sums: 3, but 2 for the float
// codecs at lane_k 16, whose 24 accumulators and 32 buffer registers leave
// no room in 128 for a third (f32 from global memory spilled 12 bytes)
template <class C, int K>
constexpr int kAhead = C::kExact || K < 16 ? 3 : 2;

// The kernel's arguments.
struct Params {
  const int32_t* words;
  const void* table;
  const int32_t* nreal;
  const int32_t* plan;
  int num_buckets, block_sublanes, table_rows, shift, part_rows, part_slices;
  SlotMerge merge;
};

// A slot's walk over its run of octets: the current one (global index g,
// its bucket b for locate), its next chunk j, and the run's end.
struct Walk {
  Octet oc;
  int g, end, b, j;
};

// The walk's next octet with a real member (skeleton padding has none),
// or g at the run's end.
__device__ __forceinline__ void advance(Walk& w, const Partition& part, const Params& a,
                                        int lane) {
  for (++w.g; w.g < w.end; ++w.g) {
    w.oc = locate(part.words, a.plan, part.nreal, a.num_buckets, a.block_sublanes, w.g, w.b,
                  lane);
    if (w.oc.index < w.oc.n_real) break;
  }
  w.j = 0;
}

// x summed over the warp's lanes up to this one (all 32 lanes call it).
__device__ __forceinline__ int64_t warp_prefix(int64_t x) {
  const int l = threadIdx.x % 32;
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const int64_t y = __shfl_up_sync(0xFFFFFFFFu, x, d);
    if (l >= d) x += y;
  }
  return x;
}

// Bucket b of the partition in the deal's units: its octets (G), those
// with a real member (its first r = min(nreal, G)) and one's work w (its
// width plus kOctetCost; the others' is 0); all 0 past the plan.
struct BucketWork {
  int64_t G, r, w;
};

__device__ __forceinline__ BucketWork bucket_work(const Params& a, const int32_t* nreal, int b) {
  if (b >= a.num_buckets) return {0, 0, 0};
  const int32_t* p = a.plan + b * kPlanCols;
  const int G = __ldg(p + kStride);
  return {G, min(max(__ldg(nreal + b), 0), G), __ldg(p + kWidth) + kOctetCost};
}

// The first octet o of the partition with 2 c(o) + w(o) >= T2 (twice its
// work's midpoint; c(o) the work before o, T2 <= twice the partition's
// work), or total; each warp finds it alone, 32 buckets at a time.
__device__ __forceinline__ int first_octet(const Params& a, const int32_t* nreal, int64_t T2,
                                           int total) {
  const int l = threadIdx.x % 32;
  int64_t before = 0;   // work of the buckets below b0
  for (int b0 = 0; b0 < a.num_buckets; b0 += 32) {
    const int b = b0 + l;
    const BucketWork k = bucket_work(a, nreal, b);
    const int64_t upto = before + warp_prefix(k.r * k.w);   // through bucket b
    // the bucket's largest 2 c + w: its last real octet's, or its
    // padding's (work 0) after them
    const int64_t top = 2 * upto - (k.r == k.G && k.r > 0 ? k.w : 0);
    const unsigned hit = __ballot_sync(0xFFFFFFFFu, b < a.num_buckets && k.G > 0 && T2 <= top);
    if (hit) {
      const int src = __ffs(hit) - 1;
      const int64_t cum = __shfl_sync(0xFFFFFFFFu, upto - k.r * k.w, src);   // before it
      const int64_t w = __shfl_sync(0xFFFFFFFFu, k.w, src);
      const int64_t r = __shfl_sync(0xFFFFFFFFu, k.r, src);
      // the first real octet j with 2 (cum + j w) + w >= T2, or the first
      // padding octet after them
      const int64_t num = T2 - 2 * cum - w;
      const int64_t j = min(num <= 0 ? 0 : (num + 2 * w - 1) / (2 * w), r);
      return __ldg(a.plan + (b0 + src) * kPlanCols + kOctStart) + static_cast<int>(j);
    }
    before = __shfl_sync(0xFFFFFFFFu, upto, 31);
  }
  return total;
}

// Slot `slot`'s run [begin, end) of the partition's octets: octet o when
// floor((2 c(o) + w(o)) * num_slots / (2 C)) == slot, C the partition's
// work (an octet goes to the slot holding the midpoint of its work).
__device__ __forceinline__ Walk slot_walk(const Params& a, const int32_t* nreal, int slot,
                                          int num_slots, int total) {
  int64_t C = 0;
  for (int b0 = 0; b0 < a.num_buckets; b0 += 32) {
    const BucketWork k = bucket_work(a, nreal, b0 + threadIdx.x % 32);
    C += __shfl_sync(0xFFFFFFFFu, warp_prefix(k.r * k.w), 31);
  }
  Walk w{};
  w.g = first_octet(a, nreal, (2 * slot * C + num_slots - 1) / num_slots, total) - 1;
  w.end = first_octet(a, nreal, (2 * (slot + 1) * C + num_slots - 1) / num_slots, total);
  return w;
}

// The lane's words of chunk j of octet oc, one a member.
__device__ __forceinline__ void load_chunk(uint32_t (&w)[kMembers], const Octet& oc, int j) {
  const int32_t* row = oc.src + (int64_t)j * kMembers * kLanes;
#pragma unroll
  for (int m = 0; m < kMembers; ++m) w[m] = static_cast<uint32_t>(__ldg(row + m * kLanes));
}

template <class C, int K, bool TIE_SAFE, bool EXACT>
__global__ void __launch_bounds__(kThreads, 1) octet_topk_kernel(const Params a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x % kLanes;
  const int group = threadIdx.x / kLanes;
  const int block = blockIdx.x, blocks = gridDim.x;
  const int num_slots = blocks * kGroups;
  const int slot = block * kGroups + group;
  const auto tab = codec::stage_block<C, kThreads>(
      smem, static_cast<const typename C::Tab*>(a.table), a.table_rows, a.shift);

  float tv[K];
  int32_t tt[K];
  topk_init<K, TIE_SAFE>(tv, tt);
  float tmin = buffer_min(tv);
  const Partition part = partition(a.words, a.nreal, a.num_buckets, a.part_rows, a.part_slices);
  const int total = total_octets(a.plan, a.num_buckets);
  const int span = a.block_sublanes / kMembers;   // chunks a block holds
  constexpr int ahead = kAhead<C, K>;

  // Two walks over the slot's octets: `ld` issues the loads of the chunks
  // `ahead` ahead of `cs`, whose chunks the sums take from the ring r.
  Walk ld = slot_walk(a, part.nreal, slot, num_slots, total);
  advance(ld, part, a, lane);
  Walk cs = ld;
  uint32_t r[ahead][kMembers];
#pragma unroll
  for (int d = 0; d < ahead; ++d) {
    if (ld.g < ld.end) {
      load_chunk(r[d], ld.oc, ld.j);
      if (++ld.j == ld.oc.width) advance(ld, part, a, lane);
    }
  }
  typename C::Acc acc[kMembers];   // h16: the octet's sums
  float even[kMembers], odd[kMembers], sc[kMembers];   // the float codecs'
#pragma unroll
  for (int m = 0; m < kMembers; ++m) {
    acc[m] = 0;
    even[m] = odd[m] = sc[m] = 0.0f;
  }
  int span0 = 0;                              // the float codecs' block span
  int span1 = min(cs.oc.width, span);
  while (cs.g < cs.end) {
    uint32_t next[kMembers];
    const bool more = ld.g < ld.end;
    if (more) load_chunk(next, ld.oc, ld.j);
    if constexpr (C::kExact) {
#pragma unroll
      for (int m = 0; m < kMembers; ++m) acc[m] = C::add(acc[m], r[0][m], tab);
    } else {
      if ((cs.j - span0) & 1) {
#pragma unroll
        for (int m = 0; m < kMembers; ++m) odd[m] = C::add(odd[m], r[0][m], tab);
      } else {
#pragma unroll
        for (int m = 0; m < kMembers; ++m) even[m] = C::add(even[m], r[0][m], tab);
      }
      if (cs.j + 1 == span1) {   // the span's sum; a wide octet's added in block order
#pragma unroll
        for (int m = 0; m < kMembers; ++m) {
          const float s = __fadd_rn(even[m], odd[m]);
          sc[m] = span0 == 0 ? s : __fadd_rn(sc[m], s);
          even[m] = odd[m] = 0.0f;
        }
        span0 = span1;
        span1 = min(cs.oc.width, span0 + span);
      }
    }
#pragma unroll
    for (int d = 0; d + 1 < ahead; ++d)
#pragma unroll
      for (int m = 0; m < kMembers; ++m) r[d][m] = r[d + 1][m];
    if (more) {
#pragma unroll
      for (int m = 0; m < kMembers; ++m) r[ahead - 1][m] = next[m];
      if (++ld.j == ld.oc.width) advance(ld, part, a, lane);
    }
    if (++cs.j == cs.oc.width) {   // the octet's harvest, the next loads in flight
      float s[kMembers];
#pragma unroll
      for (int m = 0; m < kMembers; ++m) {
        if constexpr (C::kExact) {
          s[m] = C::finish(acc[m]);
          acc[m] = 0;
        } else {
          s[m] = sc[m];
        }
        if (cs.oc.index + m * cs.oc.stride >= cs.oc.n_real) s[m] = -INFINITY;
      }
      harvest_above<K, TIE_SAFE, EXACT>(tv, tt, tmin, s, part.tag_offset + cs.oc.slice0,
                                        cs.oc.stride);
      advance(cs, part, a, lane);
      span0 = 0;
      span1 = min(cs.oc.width, span);
    }
  }

  // The lane merge (lane_merge.cuh). Unmerged: each slot's sorted buffer,
  // list p * num_slots + slot of the workspace.
  merge_slots<K, kGroups>(tv, tt, smem, a.merge);
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
  bool exact, tie_safe;
  cudaStream_t stream;
  int* blocks_per_sm;
};

template <class C, int K, bool TIE_SAFE, bool EXACT>
cudaError_t run(const Call& c) {
  auto kernel = octet_topk_kernel<C, K, TIE_SAFE, EXACT>;
  const size_t smem = smem_bytes<C, K>(c.p.table_rows);
  const cudaError_t err = codec::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  if (c.blocks_per_sm)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(c.blocks_per_sm, kernel, kThreads, smem);
  kernel<<<dim3(c.blocks, c.num_partitions), kThreads, smem, c.stream>>>(c.p);
  return cudaSuccess;
}

template <class C, int K>
cudaError_t run_k(const Call& c) {
  if (c.tie_safe && c.exact) return run<C, K, true, true>(c);
  if (c.tie_safe) return run<C, K, true, false>(c);
  if (c.exact) return run<C, K, false, true>(c);
  return run<C, K, false, false>(c);
}

// The call for the codecs of `only` (codec::dispatch).
template <unsigned only>
cudaError_t run_codecs(const Call& c) {
  return codec::dispatch<only>(c.codec, [&](auto tag) {
    using C = typename decltype(tag)::type;
    switch (c.lane_k) {
      case 4: return run_k<C, 4>(c);
      case 8: return run_k<C, 8>(c);
      case 16: return run_k<C, 16>(c);
      default: return cudaErrorInvalidValue;
    }
  });
}

cudaError_t run_f32(const Call& c);         // f32, f32_global (octet_topk_f32.cu)
cudaError_t run_quantized(const Call& c);   // int8x4, i8s, i4s (octet_topk_q.cu)

}  // namespace k1
