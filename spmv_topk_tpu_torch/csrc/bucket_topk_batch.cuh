// Per-bucket Top-K of Q queries (kernel K12) for Hopper (sm_90a), every
// query codec, the lane merge included. bucket_topk_batch.cu holds the
// h16 instantiations and the C entry point, and each other codec's
// instantiations are a translation unit of their own
// (bucket_topk_batch_<codec>.cu: f32, int8x4, i8s, i4s), built in
// parallel.
//
// Replaces spmv_topk_tpu/ops/kernel.py::_bucket_kernel_batch (the
// pallas_call of topk_spmv_bucket_batch_device).
//
// What it computes. For each of Q queries, every real slice's 128 row
// scores (s < num_real), summed in the JAX kernel's order: that kernel
// keeps one (8, 128) accumulator a query (not K13's two), so row r of a
// chunk is summed over the chunks in chunk order from 0 in one
// accumulator, each product and add rounded, and the 8 row sums are then
// reduced by bucket_common.cuh::halving_sum; h16 in exact integers. A
// width that is not a multiple of 8 loses its last width % 8 rows, and a
// width below 8 scores 0. Each score is folded into that query's per-lane
// (value, tag) buffers of lane_k entries by argmin replacement (when
// score >= the buffer's minimum: the first slot holding it when
// tie-safe, else every one), the tag the global slice id slice_base + s;
// then each lane's top lane_k of every slot's entries (the initial ones
// included) in the order value descending, then tag ascending: out[q] =
// (lane_k, 128). ops/kernel.py::bucket_topk_batch_slots_plain computes
// what it gives, bit for bit, tags and ties included.
//
// Slots. The bucket's real slices form runs of 8 consecutive slices (the
// last run may be shorter); slot j of S takes runs j R / S .. (j + 1) R / S
// - 1 of the R runs (a contiguous deal: every run but the last has the same
// work), and folds its runs in order, a run's slices in turn. The non-tie-
// safe buffers depend on the slot count at ties, as K13's and K8's do.
//
// Design. One read of the bucket a pass of QP queries (ops/kernel.py::
// k12_pass): h16 in passes of 8 or 16 (codecs.cuh::H16Pass, K8's table);
// f32 in passes of 8 (FloatPass), past shared memory f32_global; int8x4,
// i8s and i4s in passes of 8 (Bf16Pass, K6's), int8x4 past that
// int8x4_global (FloatPass on the tables in global memory). A CUDA block
// is K6's and K8's: 8 member warps per 32 lanes of the bucket (64 lanes,
// or 32 at h16's lane_k 16, batch_sweep.cuh::kBlockLanes; 128 / lanes
// blocks share a slot), one block an SM. Member warp m takes slice m of
// each run (every slice of a bucket has one width) and sums its lane for
// every query of the pass in memory order, in K12's order: h16 in one
// exact sum a query; the float codecs in one sum a query and row of a
// chunk (8 QP floats in registers, which is why their passes stop at 8
// queries: 16 would need every register of a thread), each added over
// the chunks in order, then halving_sum. Its loads stay two or three
// batches of 4 rows ahead (kBatches) into the next run's slice, so that
// they are in flight during the harvest. The member sums go through shared
// memory to K8's harvest (batch_sweep.cuh::member_harvest: the (lane,
// query) buffers in shared memory with their minima, a queue of the pairs
// a run can enter). Slots and passes are the grid's axes. The merge is
// K6's and K8's (batch_sweep.cuh::merge_pass): no torch op runs after the
// launch. Each bucket is a programmatic dependent launch, as K13's: its
// sweep runs while the previous launch merges, and it touches the
// workspace, the tickets and its outputs only after that launch has
// completed (griddepcontrol.wait).
//
// Bound. A pass reads the bucket's words once: the 9 f32 buckets of the
// 10M x 1024 corpus, 937 MB, take 0.280 ms at 3.35 TB/s. Per word and pass
// a decode, two 16-byte gathers (FloatPass), one (Bf16Pass) or two
// (H16Pass), and a rounded multiply and add a query: bound by the SMs'
// instruction rate and shared-memory gathers, as K8 is on the same words.

#pragma once

#include "batch_sweep.cuh"
#include "bucket_common.cuh"

namespace k12 {

using namespace bucket;
using batch::kAhead;
using batch::kBlockLanes;
using batch::Smem;
using codec::PassView;
using octet::kMembers;

constexpr int kUnroll = 4;   // rows a load batch reads

// Load batches in flight: K6's and K8's (batch_sweep.cuh::kAhead), but 2
// for FloatPass on tables in global memory (f32_global, int8x4_global),
// whose gathers hold a register each besides (a third spilled at lane_k
// 16).
template <class PC>
constexpr int kBatches = kAhead<PC>;
template <class C, int QP>
constexpr int kBatches<codec::FloatPass<C, QP>> = C::kShared ? 3 : 2;

// A launch's arguments.
struct Params {
  const int32_t* words;
  const void* tables;
  const int32_t* num_real;
  int num_slices, width, table_rows, shift, slice_base, num_queries;
  bool merged;
  int set_size;   // lane_merge::set_size_of(slots)
  float* ws_v;
  int32_t* ws_t;
  unsigned* tickets;
  float* out_v;
  int32_t* out_t;
};

template <class PC, int K, bool TIE_SAFE>
__global__ void __launch_bounds__(kMembers * kBlockLanes<PC::kQueries, K, PC::kExact>, 1)
bucket_topk_batch_kernel(const Params a) {
  constexpr int QP = PC::kQueries;   // queries a pass computes
  constexpr int L = kBlockLanes<QP, K, PC::kExact>;
  constexpr int T = kMembers * L;
  constexpr int kGroups = kLanes / L;   // blocks (lane groups) a slot
  constexpr int A = kBatches<PC>;
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

  // the slot's runs of 8 real slices, a contiguous deal
  const int n = real_slices(a.num_real, a.num_slices);
  const int runs = (n + kMembers - 1) / kMembers;
  int run = (int)((int64_t)slot * runs / num_slots);
  const int end = (int)((int64_t)(slot + 1) * runs / num_slots);
  const int total = a.width / kChunk * kChunk;   // the rows a slice sums

  // The load cursor: this warp's member slice of run lrun (at lsrc), its
  // rows from lpos on in memory order, then the next run's (a batch never
  // crosses a slice: the rows a slice sums are whole chunks); 0 past the
  // slot's runs or for a slice past the real ones.
  int lrun = run, lpos = 0;
  const int32_t* lsrc = nullptr;
  auto seek = [&]() {
    const int s = lrun * kMembers + member;
    lsrc = lrun < end && s < n ? a.words + (int64_t)s * a.width * kLanes + stream_lane : nullptr;
  };
  auto load = [&](uint32_t(&w)[kUnroll]) {
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      const int row = lpos + i;
      w[i] = lsrc != nullptr && row < total
                 ? static_cast<uint32_t>(__ldg(lsrc + (int64_t)row * kLanes))
                 : 0u;
    }
    lpos += kUnroll;
    if (lpos >= total) {
      lpos = 0;
      ++lrun;
      seek();
    }
  };
  uint32_t w[A][kUnroll];
  seek();
#pragma unroll
  for (int b = 0; b < A; ++b) load(w[b]);
  while (run < end) {
    const int nr = min(kMembers, n - run * kMembers);   // the run's real slices
    if (member < nr) {
      // member `member`'s scores for the pass's queries, into
      // sums[q][member]: h16 one exact sum; the float codecs one sum a row
      // of a chunk, each added over the chunks in order, then halving_sum
      constexpr int kSums = PC::kExact ? 1 : kChunk;
      typename PC::Sums acc[kSums];
#pragma unroll
      for (int r = 0; r < kSums; ++r) PC::clear(acc[r]);
      for (int j = 0; j < total; j += kChunk) {   // a chunk: rows 0-3, 4-7
#pragma unroll
        for (int h = 0; h < kChunk / kUnroll; ++h) {
          uint32_t next[kUnroll];
          load(next);
          if constexpr (PC::kExact) {
            PC::add(acc[0], w[0], kUnroll, view);
          } else {
#pragma unroll
            for (int i = 0; i < kUnroll; ++i)
              PC::add_word(acc[h * kUnroll + i], w[0][i], view);
          }
#pragma unroll
          for (int i = 0; i < kUnroll; ++i) {
#pragma unroll
            for (int b = 0; b + 1 < A; ++b) w[b][i] = w[b + 1][i];
            w[A - 1][i] = next[i];
          }
        }
      }
      float* out = sums + member * L + lane;
#pragma unroll
      for (int q = 0; q < QP; ++q) {
        if constexpr (PC::kExact)
          out[q * kMembers * L] = PC::finish(acc[0], q);
        else
          out[q * kMembers * L] = halving_sum([&](int r) { return PC::finish(acc[r], q); });
      }
    }
    const int32_t tag0 = a.slice_base + run * kMembers;
    ++run;
    __syncthreads();   // the next run's first loads are in flight
    batch::member_harvest<K, TIE_SAFE, QP, L>(sums, buf_v, buf_t, buf_min, queue, queued, nr,
                                             tag0, 1, member, lane, nq);
  }
  // The next launch on the stream (launched to overlap this one's tail)
  // may start its sweep now; this one touches the workspace, the tickets
  // and its outputs only once the launch before it has completed.
  asm volatile("griddepcontrol.launch_dependents;");
  asm volatile("griddepcontrol.wait;" ::: "memory");
  batch::merge_pass<K, QP, L>(buf_v, buf_t, member, lane, q0, nq, a.num_queries, a.merged,
                              a.set_size, a.ws_v, a.ws_t, a.tickets, a.out_v, a.out_t);
}

// One launch: the grid is (slots x lane groups, 1, passes).
struct Call {
  Params p;
  int codec, lane_k, pass_queries, slots, passes;
  bool tie_safe;
  cudaStream_t stream;
};

template <class PC, int K, bool TIE_SAFE>
cudaError_t run(const Call& c) {
  auto kernel = bucket_topk_batch_kernel<PC, K, TIE_SAFE>;
  const size_t smem = Smem<PC, K>(c.p.table_rows).bytes;
  const cudaError_t err = codec::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  constexpr int L = kBlockLanes<PC::kQueries, K, PC::kExact>;
  // a programmatic dependent launch (K13's): it may start once every
  // block of the stream's previous kernel has passed its sweep
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c.slots * (kLanes / L), 1, c.passes);
  cfg.blockDim = dim3(kMembers * L);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = c.stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, c.p);
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

// A pass codec of 8 queries.
template <class PC>
cudaError_t run_8(const Call& c) {
  return c.pass_queries == 8 ? run_k<PC>(c) : cudaErrorInvalidValue;
}

// Each codec's passes, in a translation unit of its own
// (bucket_topk_batch_<name>.cu; h16's in bucket_topk_batch.cu): h16 8 or
// 16 (H16Pass); f32 8 (FloatPass) and f32_global 8; int8x4 8 (Bf16Pass)
// and int8x4_global 8 (FloatPass); i8s and i4s 8 (Bf16Pass).
cudaError_t run_h16(const Call& c);
cudaError_t run_f32(const Call& c);
cudaError_t run_int8x4(const Call& c);
cudaError_t run_i8s(const Call& c);
cudaError_t run_i4s(const Call& c);

}  // namespace k12
