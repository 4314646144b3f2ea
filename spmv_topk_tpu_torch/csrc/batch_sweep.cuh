// Pieces shared by the multi-query sweeps that read the stream once a pass
// of queries: K6 h16 (octet_topk_batch_h16.cu), K6 for the other codecs
// (octet_topk_batch.cuh), K8 (slice_topk_batch.cuh) and K12
// (bucket_topk_batch.cuh).
//
// A CUDA block of such a sweep is 8 member warps per 32 lanes of the
// stream (L lanes, 8 L threads): the warps of member m add up member m of
// each octet (slice run) for every query of the pass, and the member sums
// go through shared memory to a harvest (K8's and K12's: each member in
// turn). The (lane, query) buffers live in shared memory with their
// minima: thread (lane, m) compares the octet's largest member of queries
// m, m + 8, ... with the minimum, and only the pairs that can enter go on
// a queue that every thread then takes from, so a replacement costs a
// warp only where a pair needs it. The lane merge
// (lane_merge.cuh): each block sorts its buffers into the workspace, a
// ticket elects the last block of each set of about sqrt(slots) slots to
// merge the set's, a second ticket the last set.

#pragma once

#include <type_traits>

#include "lane_merge.cuh"
#include "octet_common.cuh"

namespace batch {

using octet::kLanes;
using octet::kMembers;

// Stream lanes a block sweeps: 64 (16 warps), or 32 where a pass's
// buffers need the shared memory or its harvest the registers (h16 at
// lane_k 16; the float passes past 128 buffer entries a lane).
// ops/kernel.py::batch_block_lanes.
template <int QP, int K, bool H16>
constexpr int kBlockLanes = (H16 ? K <= 8 : QP * K <= 128) ? 64 : 32;

// Load batches in flight ahead of the sums: 3, but 2 for h16's passes of
// 32 (their 33 sums leave no registers for a third).
template <class PC>
constexpr int kAhead = PC::kExact && PC::kQueries == 32 ? 2 : 3;

// The block's dynamic shared memory for pass codec PC (codecs.cuh), in
// this order: the pass's table; the member sums, (query, member, lane)
// float; the (lane, query) buffers, (query, entry, lane) values then tags;
// their minima, (query, lane); the harvest queue, (query, lane) pairs as
// uint16. ops/kernel.py::_pass_smem_bytes computes the same bytes.
template <class PC, int K>
struct Smem {
  static constexpr int kQ = PC::kQueries;
  static constexpr int kL = kBlockLanes<kQ, K, PC::kExact>;
  size_t sums, buf_v, buf_t, min, queue, bytes;
  __host__ __device__ explicit Smem(int table_rows) {
    sums = (PC::table_bytes(table_rows) + 15) / 16 * 16;
    buf_v = sums + sizeof(float) * kQ * kMembers * kL;
    buf_t = buf_v + sizeof(float) * kQ * K * kL;
    min = buf_t + sizeof(int32_t) * kQ * K * kL;
    queue = min + sizeof(float) * kQ * kL;
    bytes = queue + sizeof(uint16_t) * kQ * kL;
  }
};

// A launch's arguments (K6 and K8).
struct Params {
  const int32_t* words;
  const void* tables;
  const int32_t* nreal;
  const int32_t* plan;
  int num_buckets, block_sublanes, table_rows, shift, num_queries, part_rows, part_slices;
  bool merged;
  int set_size;   // lane_merge::set_size_of(slots)
  float* ws_v;
  int32_t* ws_t;
  unsigned* tickets;
  float* out_v;
  int32_t* out_t;
};

// The QP x K x L buffer entries from topk_init's and their minima, by the
// block's T threads.
template <int K, bool TIE_SAFE, int QP, int L, int T>
__device__ __forceinline__ void init_buffers(float* buf_v, int32_t* buf_t, float* buf_min) {
  float iv[K];
  int32_t it[K];
  octet::topk_init<K, TIE_SAFE>(iv, it);
  for (int i = threadIdx.x; i < QP * K * L; i += T) {
    buf_v[i] = iv[(i / L) % K];
    buf_t[i] = 0;
  }
  for (int i = threadIdx.x; i < QP * L; i += T) buf_min[i] = octet::buffer_min(iv);
}

// Puts the warp's (lane, query) pairs that `enter` on the queue.
__device__ __forceinline__ void enqueue(bool enter, int& queued, uint16_t* queue, int pair) {
  const unsigned ballot = __ballot_sync(0xFFFFFFFFu, enter);
  if (ballot) {
    const int leader = __ffs(ballot) - 1;
    int at = 0;
    if (threadIdx.x % 32 == leader) at = atomicAdd(&queued, __popc(ballot));
    at = __shfl_sync(0xFFFFFFFFu, at, leader);
    if (enter)
      queue[at + __popc(ballot & ((1u << (threadIdx.x % 32)) - 1u))] =
          static_cast<uint16_t>(pair);
  }
}

// The harvest of octet `cur` from its member sums (S: int32 for h16's
// exact sums, float for the others), after a barrier that follows the
// sums. Thread (lane, member) checks queries member, member + 8, ...: a
// (lane, query) pair goes on the queue when the octet's largest real
// member is not below its buffer's minimum (member 0 is real; fmaxf passes
// over a NaN member, which never enters); below it, nothing of the octet
// enters. Then each queued pair is harvested by one thread (top 3 of 8, or
// every member when EXACT: octet_common.cuh::harvest_above), its buffer
// read from and written back to shared memory. Ends with the sums, the
// buffers and the queue free again.
template <int K, bool TIE_SAFE, bool EXACT, int QP, int L, typename S>
__device__ __forceinline__ void octet_harvest(const S* sums, float* buf_v, int32_t* buf_t,
                                              float* buf_min, uint16_t* queue, int& queued,
                                              const octet::Octet& cur, int32_t tag0, int member,
                                              int lane, int nq) {
  constexpr int T = kMembers * L;
  const S* in = sums + lane;
  auto real = [&](int m) { return cur.index + m * cur.stride < cur.n_real; };
#pragma unroll
  for (int i = 0; i < QP / kMembers; ++i) {
    const int q = member + kMembers * i;
    if (q >= nq) break;   // uniform in the warp
    S top = in[q * kMembers * L];
#pragma unroll
    for (int m = 1; m < kMembers; ++m) {
      if (!real(m)) continue;
      if constexpr (std::is_same_v<S, float>)
        top = fmaxf(top, in[(q * kMembers + m) * L]);
      else
        top = max(top, in[(q * kMembers + m) * L]);
    }
    enqueue(static_cast<float>(top) >= buf_min[q * L + lane], queued, queue, q * L + lane);
  }
  __syncthreads();
  const int n = queued;
  for (int e = threadIdx.x; e < n; e += T) {
    const int pair = queue[e];
    const int q = pair / L, l = pair % L;
    float tv[K], sc[kMembers];
    int32_t tt[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      tv[k] = buf_v[(q * K + k) * L + l];
      tt[k] = buf_t[(q * K + k) * L + l];
    }
#pragma unroll
    for (int m = 0; m < kMembers; ++m)
      sc[m] = real(m) ? static_cast<float>(sums[(q * kMembers + m) * L + l]) : -INFINITY;
    float tmin = buf_min[q * L + l];
    octet::harvest_above<K, TIE_SAFE, EXACT>(tv, tt, tmin, sc, tag0, cur.stride);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      buf_v[(q * K + k) * L + l] = tv[k];
      buf_t[(q * K + k) * L + l] = tt[k];
    }
    buf_min[q * L + l] = tmin;
  }
  __syncthreads();   // the sums, the buffers and the queue are free again
  if (threadIdx.x == 0) queued = 0;
}

// The harvest of a run of nr members (K8's work items, K12's runs of 8
// slices) from their sums, after a barrier that follows the sums; member
// m's tag is tag0 + m * dj. Thread (lane, member) checks queries member,
// member + 8, ...: a (lane, query) pair goes on the queue when the run's
// largest real member is not below its buffer's minimum (fmaxf passes
// over a NaN member, which never enters); below it, nothing of the run
// does. Then each queued pair is harvested by one thread: the real
// members in turn, each at or above the buffer's minimum replacing the
// first slot holding it (TIE_SAFE) or every one (_topk_update), its
// buffer read from and written back to shared memory. Ends with the sums,
// the buffers and the queue free again.
template <int K, bool TIE_SAFE, int QP, int L>
__device__ __forceinline__ void member_harvest(const float* sums, float* buf_v, int32_t* buf_t,
                                               float* buf_min, uint16_t* queue, int& queued,
                                               int nr, int32_t tag0, int dj, int member,
                                               int lane, int nq) {
  constexpr int T = kMembers * L;
#pragma unroll
  for (int i = 0; i < QP / kMembers; ++i) {
    const int q = member + kMembers * i;
    if (q >= nq) break;   // uniform in the warp
    const float* in = sums + q * kMembers * L + lane;
    float top = in[0];
#pragma unroll
    for (int m = 1; m < kMembers; ++m)
      if (m < nr) top = fmaxf(top, in[m * L]);
    const bool enter = top >= buf_min[q * L + lane];
    enqueue(enter, queued, queue, q * L + lane);
  }
  __syncthreads();
  const int n = queued;   // the same in every thread
  if (n == 0) return;     // no one reads the sums again: no third barrier
  for (int e = threadIdx.x; e < n; e += T) {
    const int pair = queue[e];
    const int q = pair / L, l = pair % L;
    float tv[K];
    int32_t tt[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      tv[k] = buf_v[(q * K + k) * L + l];
      tt[k] = buf_t[(q * K + k) * L + l];
    }
    float tmin = buf_min[q * L + l];
#pragma unroll
    for (int m = 0; m < kMembers; ++m) {
      if (m >= nr) break;
      const float sc = sums[(q * kMembers + m) * L + l];
      if (sc >= tmin) {
        bool done = false;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (tv[k] == tmin && !done) {
            tv[k] = sc;
            tt[k] = tag0 + m * dj;
            if (TIE_SAFE) done = true;
          }
        }
        tmin = octet::buffer_min(tv);
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      buf_v[(q * K + k) * L + l] = tv[k];
      buf_t[(q * K + k) * L + l] = tt[k];
    }
    buf_min[q * L + l] = tmin;
  }
  __syncthreads();   // the sums, the buffers and the queue are free again
  if (threadIdx.x == 0) queued = 0;
}

// The lane merge of a pass's block (grid: slots x lane groups, partitions,
// passes), after its sweep. 1. Each (lane, query) buffer, sorted, to the
// slot's list of the query and partition: list (q * P + p) * slots + slot
// of the workspace. Unless `merged` is false: 2. the last block of each
// set of set_size slots (a ticket per set, for each lane group, partition
// and pass) merges the set's lists into the set's list, after the slots'
// lists, or into the outputs when there is one set; 3. the last set's
// merges the set lists into the outputs, (Q, P, K, 128).
template <int K, int QP, int L>
__device__ __forceinline__ void merge_pass(const float* buf_v, const int32_t* buf_t, int member,
                                           int lane, int q0, int nq, int num_queries,
                                           bool merged, int set_size, float* ws_v,
                                           int32_t* ws_t, unsigned* tickets, float* out_v,
                                           int32_t* out_t) {
  using namespace lane_merge;
  constexpr int kGroups = kLanes / L;   // blocks (lane groups) a slot
  const int slot = blockIdx.x / kGroups;
  const int num_slots = gridDim.x / kGroups;
  const int stream_lane = (blockIdx.x % kGroups) * L + lane;
  const int P = gridDim.y, p = blockIdx.y;
#pragma unroll
  for (int i = 0; i < QP / kMembers; ++i) {
    const int q = member + kMembers * i;
    if (q >= nq) break;
    float tv[K];
    int32_t tt[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      tv[k] = buf_v[(q * K + k) * L + lane];
      tt[k] = buf_t[(q * K + k) * L + lane];
    }
    sort<K>(tv, tt);
    store<K>(tv, tt, ws_v, ws_t, ((q0 + q) * P + p) * num_slots + slot, stream_lane);
  }
  if (!merged) return;
  const int sets = (num_slots + set_size - 1) / set_size;
  const int set = slot / set_size, first = set * set_size;
  const int in_set = min(set_size, num_slots - first);
  unsigned* ticket =
      tickets + (((int64_t)blockIdx.z * P + p) * kGroups + blockIdx.x % kGroups) * (1 + sets);
  const int64_t set_lists = (int64_t)num_queries * P * num_slots;
  if (!arrive(ticket + 1 + set, in_set)) return;
#pragma unroll
  for (int i = 0; i < QP / kMembers; ++i) {
    const int q = member + kMembers * i;
    if (q >= nq) break;
    const int64_t qp = (int64_t)(q0 + q) * P + p;
    float tv[K];
    int32_t tt[K];
    gather<K, 1>(tv, tt, ws_v + qp * num_slots * K * kLanes, ws_t + qp * num_slots * K * kLanes,
                 first, in_set, 0, stream_lane);
    if (sets == 1)
      store<K>(tv, tt, out_v, out_t, qp, stream_lane);
    else
      store<K>(tv, tt, ws_v, ws_t, set_lists + qp * sets + set, stream_lane);
  }
  if (sets == 1 || !arrive(ticket, sets)) return;
#pragma unroll
  for (int i = 0; i < QP / kMembers; ++i) {
    const int q = member + kMembers * i;
    if (q >= nq) break;
    const int64_t qp = (int64_t)(q0 + q) * P + p;
    float tv[K];
    int32_t tt[K];
    gather<K, 1>(tv, tt, ws_v + (set_lists + qp * sets) * K * kLanes,
                 ws_t + (set_lists + qp * sets) * K * kLanes, 0, sets, 0, stream_lane);
    store<K>(tv, tt, out_v, out_t, qp, stream_lane);
  }
}

}  // namespace batch
