// Multi-query slice-stream Top-K sweep (kernel K8; K10c with partitions)
// for Hopper (sm_90a), every query codec, the lane merge included.
// slice_topk_batch.cu holds the h16 instantiations and the C entry point,
// slice_topk_batch_f32.cu the f32 ones (tables in shared or global memory)
// and slice_topk_batch_q.cu int8x4's (likewise), i8s's and i4s's
// (translation units of their own, so that nvcc builds them in parallel).
//
// Replaces spmv_topk_tpu/ops/kernel.py::_fused_kernel_batch (:1150): the
// pallas_calls of topk_spmv_fused_batch_device (:1381) and, with P row
// partitions, topk_spmv_fused_batch_part_device (:1440): partition p is
// the grid's y index, its tags offset by p * part_slices, with a pool of
// its own, (Q, P, lane_k, 128).
//
// What it computes. For each of Q queries, every real slice's 128 row
// scores (a lane adds up its W decoded words in row order from 0, h16 in
// exact integers, the float codecs each product and add rounded; a wide
// slice adds its block sums in float in block order from 0), each folded
// into that query's per-lane (value, slice tag) buffers of lane_k entries
// by argmin replacement, whatever fold_tile is (the JAX batch kernel has
// no tiled fold); then each lane's top lane_k of every slot's entries (the
// initial ones included) in the order value descending, then tag
// ascending: out[q][p] = (lane_k, 128). ops/kernel.py::
// slice_topk_batch_slots_plain computes what it gives, bit for bit.
//
// Slots. As K7's at fold_tile 1: the work items (runs of up to 8 slices
// of a block, a wide slice alone) go to the slots by K7's static deal
// (ops/kernel.py::k7_deal; slice_topk.cuh::slot_walk finds a slot's
// contiguous run of items of about equal work), and each slot harvests its
// items in order, an item's real members in turn.
//
// Design. One read of the stream a pass of QP queries: h16 passes of 8,
// 16 or 32 (codecs.cuh::H16Pass, K6 h16's table: 16 bytes a column and
// dp2a products), the float codecs' of 8 or 16 (FloatPass: the pass's
// tables side by side, one decode and QP / 4 16-byte gathers a word; f32
// tables past shared memory in passes of 8, read from global memory). A
// CUDA block is 8 member warps per 32 lanes of the stream (L = 64 lanes,
// 16 warps; 32 lanes where the buffers need it, kBlockLanes; 128 / L
// blocks share a slot): the warps of member m add up member m of each
// item, each thread one lane, for every query of the pass, its loads two
// or three batches ahead (kAhead), into the next item. The sums go
// through shared memory to the harvest; the (lane, query) buffers live in
// shared memory with
// their minima: thread (lane, m) compares the item's largest real member
// of queries m, m + 8, ... with the minimum, and only the pairs that can
// enter go on a queue that every thread then takes from (K6 h16's
// harvest). Passes, partitions and slots are the grid's axes, one block an
// SM (ops/kernel.py::pass_grid). The merge: each block sorts its buffers
// into the workspace, a ticket elects the last block of each set of about
// sqrt(slots) slots to merge the set's, a second ticket the last set
// (K6 h16's); no torch op runs after the launch.
//
// Bound. A pass reads every packed word once: 430 MB of h16 words for
// bench.py's slice engine (a group of 32 in one pass), 937 MB of f32 words
// for the default engine (a group of 8), at 3.35 TB/s 0.128 / 0.280 ms;
// per word and pass about 66 instructions and two 16-byte gathers for 32
// h16 queries, a decode, QP / 4 gathers and 2 QP float operations for the
// float codecs: bound by the SMs' issue and shared-memory gathers on h16,
// near the bytes on the float codecs.

#pragma once

#include "batch_sweep.cuh"
#include "slice_topk.cuh"

namespace k8 {

using namespace slice;
using namespace lane_merge;
using codec::PassView;
using octet::kMembers;

constexpr int kUnroll = 4;   // words of a member a load batch reads

using batch::kAhead;
using batch::kBlockLanes;
using batch::Params;
using batch::Smem;

template <class PC, int K, bool TIE_SAFE>
__global__ void __launch_bounds__(kMembers * kBlockLanes<PC::kQueries, K, PC::kExact>, 1)
slice_topk_batch_kernel(const Params a) {
  constexpr int QP = PC::kQueries;   // queries a pass computes
  constexpr int L = kBlockLanes<QP, K, PC::kExact>;
  constexpr int T = kMembers * L;
  constexpr int kGroups = kLanes / L;   // blocks (lane groups) a slot
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int queued;
  const Smem<PC, K> S(a.table_rows);
  float* sums = reinterpret_cast<float*>(smem + S.sums);
  float* buf_v = reinterpret_cast<float*>(smem + S.buf_v);
  int32_t* buf_t = reinterpret_cast<int32_t*>(smem + S.buf_t);
  float* buf_min = reinterpret_cast<float*>(smem + S.min);
  uint16_t* queue = reinterpret_cast<uint16_t*>(smem + S.queue);
  const int warp = threadIdx.x / 32;
  const int member = warp % kMembers;
  const int lane = (warp / kMembers) * 32 + threadIdx.x % 32;   // of the block's L
  const int slot = blockIdx.x / kGroups;
  const int num_slots = gridDim.x / kGroups;
  const int stream_lane = (blockIdx.x % kGroups) * L + lane;
  const int q0 = blockIdx.z * QP;
  const int nq = min(QP, a.num_queries - q0);
  PC::load(smem, a.tables, q0, nq, a.table_rows, threadIdx.x, T);
  batch::init_buffers<K, TIE_SAFE, QP, L, T>(buf_v, buf_t, buf_min);
  if (threadIdx.x == 0) queued = 0;
  __syncthreads();
  const int64_t cols = (int64_t)a.table_rows * kLanes;
  const PassView view{smem, static_cast<const unsigned char*>(a.tables) +
                                (int64_t)q0 * cols * 4,
                      a.table_rows, a.shift, nq};

  const Partition part = partition(a.words, a.nreal, a.num_buckets, a.part_rows, a.part_slices);
  // K7's walk at fold_tile 1 (every slice its own harvest step)
  k7::Params deal{};
  deal.plan = a.plan;
  deal.num_buckets = a.num_buckets;
  deal.block_sublanes = a.block_sublanes;
  deal.fold_tile = 1;
  k7::Walk wk = k7::slot_walk(deal, part.nreal, slot, num_slots);
  // this warp's member's words j .. j + kUnroll - 1 of the walk's item (0
  // past its rows, or for a member past the item's real ones); kAhead
  // batches in flight
  auto load = [&](uint32_t(&w)[kUnroll], int j) {
    const bool mine = member < wk.it.nr;
    const int width = wk.s.k.width;
    const int32_t* src =
        part.words + wk.it.off + (int64_t)member * wk.it.mstride + stream_lane;
#pragma unroll
    for (int i = 0; i < kUnroll; ++i)
      w[i] = mine && j + i < width ? static_cast<uint32_t>(__ldg(src + (int64_t)(j + i) * kLanes))
                                   : 0u;
  };
  constexpr int A = kAhead<PC>;
  uint32_t w[A][kUnroll];
  if (wk.g < wk.end) {
#pragma unroll
    for (int b = 0; b < A; ++b) load(w[b], b * kUnroll);
  }
  while (wk.g < wk.end) {
    const k7::Item it = wk.it;
    if (member < it.nr) {
      // member `member`'s sums for the pass's queries, into sums[q][member]:
      // a narrow slice's W rows; a wide slice's block sums added in float
      // in block order (block_sublanes a multiple of kUnroll)
      const int width = wk.s.k.width;
      const bool wide = wk.s.k.mode == kWide;
      float* out = sums + member * L + lane;
      typename PC::Sums acc;
      PC::clear(acc);
      bool first = true;
      auto flush = [&]() {
#pragma unroll
        for (int q = 0; q < QP; ++q) {
          const float s = PC::finish(acc, q);
          float& o = out[q * kMembers * L];
          o = wide ? __fadd_rn(first ? 0.0f : o, s) : s;
        }
        PC::clear(acc);
        first = false;
      };
      for (int j = 0; j < width; j += kUnroll) {
        if (wide && j > 0 && j % a.block_sublanes == 0) flush();
        uint32_t next[kUnroll];
        load(next, j + A * kUnroll);
        PC::add(acc, w[0], width - j, view);
#pragma unroll
        for (int i = 0; i < kUnroll; ++i) {
#pragma unroll
          for (int b = 0; b + 1 < A; ++b) w[b][i] = w[b + 1][i];
          w[A - 1][i] = next[i];
        }
      }
      flush();
    }
    // the next item with a real member, its first loads in flight during
    // the harvest
    k7::advance(wk, deal, part.nreal);
    if (wk.g < wk.end) {
#pragma unroll
      for (int b = 0; b < A; ++b) load(w[b], b * kUnroll);
    }
    __syncthreads();
    // The harvest (batch_sweep.cuh): the item's real members in turn
    // (K7's replacement)
    batch::member_harvest<K, TIE_SAFE, QP, L>(sums, buf_v, buf_t, buf_min, queue, queued, it.nr,
                                             part.tag_offset + it.tag0, it.dj, member, lane,
                                             nq);
  }

  // The lane merge (lane_merge.cuh), K6 h16's
  batch::merge_pass<K, QP, L>(buf_v, buf_t, member, lane, q0, nq, a.num_queries, a.merged,
                              a.set_size, a.ws_v, a.ws_t, a.tickets, a.out_v, a.out_t);
}

// One launch: the grid is (slots x lane groups, partitions, passes).
struct Call {
  Params p;
  int codec, lane_k, pass_queries, slots, num_partitions, passes;
  bool tie_safe;
  cudaStream_t stream;
};

template <class PC, int K, bool TIE_SAFE>
cudaError_t run(const Call& c) {
  auto kernel = slice_topk_batch_kernel<PC, K, TIE_SAFE>;
  const size_t smem = Smem<PC, K>(c.p.table_rows).bytes;
  const cudaError_t err = codec::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  constexpr int L = kBlockLanes<PC::kQueries, K, PC::kExact>;
  const dim3 grid(c.slots * (kLanes / L), c.num_partitions, c.passes);
  kernel<<<grid, kMembers * L, smem, c.stream>>>(c.p);
  return cudaSuccess;
}

template <class PC>
cudaError_t run_k(const Call& c) {
  switch (c.lane_k) {
    case 4: return c.tie_safe ? run<PC, 4, true>(c) : run<PC, 4, false>(c);
    case 8: return c.tie_safe ? run<PC, 8, true>(c) : run<PC, 8, false>(c);
    case 16: return c.tie_safe ? run<PC, 16, true>(c) : run<PC, 16, false>(c);
    default: return cudaErrorInvalidValue;
  }
}

// The call for the codecs of `only` (codec::dispatch): h16 in passes of 8,
// 16 or 32 queries, the float codecs of 8 or 16, f32 and int8x4 tables
// in global memory of 8 (16 spilled at lane_k 4: each query's gather its
// own address).
template <unsigned only>
cudaError_t run_codecs(const Call& c) {
  return codec::dispatch<only>(c.codec, [&](auto tag) {
    using C = typename decltype(tag)::type;
    switch (c.pass_queries) {
      case 8: return run_k<typename codec::PassOf<C, 8>::type>(c);
      case 16:
        if constexpr (C::kShared)
          return run_k<typename codec::PassOf<C, 16>::type>(c);
        return cudaErrorInvalidValue;
      case 32:
        if constexpr (std::is_same_v<C, codec::H16>) return run_k<codec::H16Pass<32>>(c);
        return cudaErrorInvalidValue;
      default: return cudaErrorInvalidValue;
    }
  });
}

cudaError_t run_f32(const Call& c);         // f32, f32_global (slice_topk_batch_f32.cu)
cudaError_t run_quantized(const Call& c);   // int8x4 (and global), i8s, i4s (slice_topk_batch_q.cu)

}  // namespace k8
