// Multi-query octet Top-K sweep (kernel K6; K10d with partitions) for
// Hopper (sm_90a), every query codec of codecs.cuh but h16 (whose sweep is
// octet_topk_batch_h16.cu, the design this one follows), the lane merge
// included. octet_topk_batch.cu holds the C entry point, and each codec's
// instantiations are a translation unit of their own
// (octet_topk_batch_<codec>.cu), built in parallel.
//
// Replaces spmv_topk_tpu/ops/kernel.py::_fused_kernel_batch_octet (:1474):
// the pallas_calls of topk_spmv_fused_batch_octet_device (:1626) and, with
// P row partitions, topk_spmv_fused_batch_octet_part_device (:1676): the
// partition is the grid's y index, its tags offset by p * part_slices,
// and each query keeps a pool per partition, (Q, P, lane_k, 128).
//
// What it computes. For each of Q queries, every octet's 8 member scores
// in the JAX batch kernel's order (CHAIN): one accumulator per query and
// member from 0, the products added in chunk order, each product and add
// rounded, a block span's chunks at a time, and a wide octet's span sums
// added in float in block order from 0; members past the bucket's real
// slices -inf; harvested (top 3 of 8, or every member with fold_tile 1:
// EXACT) into per-lane (value, slice tag) buffers of lane_k entries by
// argmin replacement, a set per slot (slot j takes octets j, j + slots,
// ...); then each lane's top lane_k of every slot's entries (the initial
// ones included) in the order value descending, then tag ascending:
// out[q][p] = (lane_k, 128). ops/kernel.py::octet_topk_batch_slots_plain
// computes what it gives, bit for bit, on the packer's words (Bf16Pass).
//
// Design. One read of the stream a pass of QP queries (ops/kernel.py::
// k6_pass): f32 in passes of 8 or 16 (codecs.cuh::FloatPass: the pass's
// tables side by side in swizzled 16-byte words, one decode and QP / 4
// gathers a word; past shared memory f32_global in passes of 8); int8x4,
// i8s and i4s in passes of 8 or 16 (Bf16Pass: the pass's queries' fields
// side by side as bf16 values, QP / 8 gathers a word and no int-to-float
// conversion; int8x4 tables past that int8x4_global, FloatPass of the
// tables in global memory in passes of 8, as f32_global; passes of 32,
// in blocks of 32 lanes for their buffers' room, were slower on the H100:
// experiments/k6_ablation.py pass32 builds them). A CUDA block is 8
// member warps per 32 lanes of the stream (64 lanes, or 32 past 128
// buffer entries a lane; 128 / lanes blocks share a slot): the warps of
// member m add up member m of each octet, each thread one lane, for every
// query of the pass, its loads three batches of 4 words ahead, into the
// next octet. A batch holds words of one block span only, so
// that a wide octet's span sums close after whole batches whatever the
// block's chunks. The member sums go through shared memory to K6 h16's
// harvest (batch_sweep.cuh): the (lane, query) buffers in shared memory
// with their minima, and a queue of the pairs an octet can enter. Slots,
// partitions and passes are the grid's axes, one block an SM
// (ops/kernel.py::pass_grid). The merge is K6 h16's (batch_sweep.cuh::
// merge_pass): no torch op runs after the launch.
//
// Bound. A pass reads every packed word once: 923 MB of 4-byte words at
// the 10M x 1024 corpus, 0.276 ms at 3.35 TB/s. Per word and pass: a
// decode, QP / 4 (f32) or QP / 8 (Bf16Pass) 16-byte gathers, and a
// rounded multiply and add a query (Bf16Pass one shift or mask besides):
// bound by the SMs' issue and shared-memory gathers, not by device memory.

#pragma once

#include "batch_sweep.cuh"

namespace k6 {

using namespace octet;
using batch::kAhead;
using batch::kBlockLanes;
using batch::Params;
using batch::Smem;
using codec::PassView;

constexpr int kUnroll = 4;                            // words a load batch
constexpr int64_t kStep = (int64_t)kMembers * kLanes;  // a chunk's words

template <class PC, int K, bool TIE_SAFE, bool EXACT>
__global__ void __launch_bounds__(kMembers * kBlockLanes<PC::kQueries, K, false>, 1)
octet_topk_batch_kernel(const Params a) {
  static_assert(!PC::kExact, "h16 has octet_topk_batch_h16.cu");
  constexpr int QP = PC::kQueries;   // queries a pass computes
  constexpr int L = kBlockLanes<QP, K, false>;
  constexpr int T = kMembers * L;
  constexpr int kGroups = kLanes / L;   // blocks (lane groups) a slot
  constexpr int A = kAhead<PC>;
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
  const int total = total_octets(a.plan, a.num_buckets);
  const int span = a.block_sublanes / kMembers;   // chunks of a block span
  int b = 0;
  // The load cursor: the next batch of this warp's member (at lsrc) of the
  // octet next() found, from chunk lpos, the words below lend (the end of
  // its span) read, the rest 0; after a span's last batch it moves to the
  // next span (past the octet's last, every batch reads 0).
  const int32_t* lsrc = nullptr;
  int lpos = 0, lend = 0, lwidth = 0;
  auto load = [&](uint32_t(&w)[kUnroll]) {
#pragma unroll
    for (int i = 0; i < kUnroll; ++i)
      w[i] = lpos + i < lend ? static_cast<uint32_t>(__ldg(lsrc + (lpos + i) * kStep)) : 0u;
    lpos += kUnroll;
    if (lpos >= lend) {
      lpos = lend;
      lend = min(lend + span, lwidth);
    }
  };
  uint32_t w[A][kUnroll];
  // the block's next octet with a real member from g on (skeleton padding
  // holds none; the whole block skips it), its first A batches in flight
  auto next = [&](int& g) {   // g moves to that octet, or past total
    Octet o{};
    for (; g < total; g += num_slots) {
      o = locate(part.words, a.plan, part.nreal, a.num_buckets, a.block_sublanes, g, b,
                 stream_lane);
      if (o.index < o.n_real) break;
    }
    if (g < total) {
      lsrc = o.src + member * kLanes;
      lpos = 0;
      lwidth = o.width;
      lend = min(span, o.width);
#pragma unroll
      for (int i = 0; i < A; ++i) load(w[i]);
    }
    return o;
  };
  int g = slot;
  Octet oc = next(g);
  while (g < total) {
    {
      // member `member`'s sums for the pass's queries, into sums[q][member]:
      // each span's chunks from 0, a wide octet's span sums added in float
      // in block order from 0
      float* out = sums + member * L + lane;
      const bool wide = oc.width > span;
      typename PC::Sums acc;
      PC::clear(acc);
      bool first = true;
      int pos = 0, end = min(span, oc.width);
      do {
        uint32_t nxt[kUnroll];
        load(nxt);
        PC::add(acc, w[0], end - pos, view);
#pragma unroll
        for (int i = 0; i < kUnroll; ++i) {
#pragma unroll
          for (int j = 0; j + 1 < A; ++j) w[j][i] = w[j + 1][i];
          w[A - 1][i] = nxt[i];
        }
        pos += kUnroll;
        if (pos >= end) {   // the span's last batch
#pragma unroll
          for (int q = 0; q < QP; ++q) {
            const float s = PC::finish(acc, q);
            float& o = out[q * kMembers * L];
            o = wide ? __fadd_rn(first ? 0.0f : o, s) : s;
          }
          PC::clear(acc);
          first = false;
          pos = end;
          end = min(end + span, oc.width);
        }
      } while (pos < oc.width);
    }
    const Octet cur = oc;
    g += num_slots;
    oc = next(g);
    __syncthreads();
    batch::octet_harvest<K, TIE_SAFE, EXACT, QP, L>(sums, buf_v, buf_t, buf_min, queue, queued,
                                                   cur, part.tag_offset + cur.slice0, member,
                                                   lane, nq);
  }
  batch::merge_pass<K, QP, L>(buf_v, buf_t, member, lane, q0, nq, a.num_queries, a.merged,
                              a.set_size, a.ws_v, a.ws_t, a.tickets, a.out_v, a.out_t);
}

// One launch: the grid is (slots x lane groups, partitions, passes).
struct Call {
  Params p;
  int codec, lane_k, pass_queries, slots, num_partitions, passes;
  bool tie_safe, exact;
  cudaStream_t stream;
};

template <class PC, int K, bool TIE_SAFE, bool EXACT>
cudaError_t run(const Call& c) {
  auto kernel = octet_topk_batch_kernel<PC, K, TIE_SAFE, EXACT>;
  const size_t smem = Smem<PC, K>(c.p.table_rows).bytes;
  const cudaError_t err = codec::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  constexpr int L = kBlockLanes<PC::kQueries, K, false>;
  const dim3 grid(c.slots * (kLanes / L), c.num_partitions, c.passes);
  kernel<<<grid, kMembers * L, smem, c.stream>>>(c.p);
  return cudaSuccess;
}

template <class PC, int K>
cudaError_t run_flags(const Call& c) {
  if (c.tie_safe && c.exact) return run<PC, K, true, true>(c);
  if (c.tie_safe) return run<PC, K, true, false>(c);
  if (c.exact) return run<PC, K, false, true>(c);
  return run<PC, K, false, false>(c);
}

template <class PC>
cudaError_t run_k(const Call& c) {
  switch (c.lane_k) {
    case 4: return run_flags<PC, 4>(c);
    case 8: return run_flags<PC, 8>(c);
    case 16: return run_flags<PC, 16>(c);
    default: return cudaErrorInvalidValue;
  }
}

// Each codec's passes, in a translation unit of its own
// (octet_topk_batch_<name>.cu): f32 8 or 16 (FloatPass), f32_global and
// int8x4_global 8 (FloatPass, both in octet_topk_batch_f32g.cu); int8x4,
// i8s and i4s 8 or 16 (Bf16Pass).
cudaError_t run_f32(const Call& c);
cudaError_t run_f32g(const Call& c);
cudaError_t run_int8x4(const Call& c);
cudaError_t run_int8x4g(const Call& c);
cudaError_t run_i8s(const Call& c);
cudaError_t run_i4s(const Call& c);

}  // namespace k6
