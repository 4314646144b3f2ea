// The lane merge on the card, shared by K13 (bucket_topk.cu), K6 h16
// (octet_topk_batch_h16.cu), K1 (octet_topk.cuh) and K7 (slice_topk.cuh):
// sorted per-lane lists of K (value, tag) entries, merged in the order
// value descending, then tag ascending, and the tickets that elect the
// last block of a set of blocks to merge the set's lists
// (ops/kernel.py::lane_merge_plain is its plain version); merge_slots is
// K1's and K7's whole merge of a launch's slots.
//
// Top-k under one total order does not depend on how the entries are
// grouped, so any tree of these merges gives what one merge of every list
// gives. A list sorts in a bitonic network (log2(K) (log2(K) + 1) / 2
// rounds of K / 2 independent compare-exchanges), and two sorted lists
// merge in log2(K) + 1 rounds (`merge`): short dependency chains (an
// insertion into a sorted list is K dependent steps an entry).

#pragma once

#include <climits>

#include "octet_common.cuh"

namespace lane_merge {

// The merges' order: value descending, then tag ascending. A NaN value
// comes before nothing (every comparison with it is false).
__device__ __forceinline__ bool before(float av, int32_t at, float bv, int32_t bt) {
  return av > bv || (av == bv && at < bt);
}

// An empty sorted list: entries that every entry but a NaN comes before.
template <int K>
__device__ __forceinline__ void clear(float (&v)[K], int32_t (&t)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    v[k] = -INFINITY;
    t[k] = INT_MAX;
  }
}

// Entries i < j of a list in `before` order: swapped if j comes first.
template <int K>
__device__ __forceinline__ void order(float (&v)[K], int32_t (&t)[K], int i, int j) {
  if (before(v[j], t[j], v[i], t[i])) {
    const float fv = v[i];
    v[i] = v[j];
    v[j] = fv;
    const int32_t ft = t[i];
    t[i] = t[j];
    t[j] = ft;
  }
}

// Sort a list in `before` order (a bitonic network: log2(K) (log2(K) + 1)
// / 2 rounds of K / 2 independent compare-exchanges; K a power of two).
template <int K>
__device__ __forceinline__ void sort(float (&v)[K], int32_t (&t)[K]) {
#pragma unroll
  for (int size = 2; size <= K; size *= 2)
#pragma unroll
    for (int stride = size / 2; stride > 0; stride /= 2)
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const int j = i ^ stride;
        if (j > i) {
          if ((i & size) == 0)
            order<K>(v, t, i, j);
          else
            order<K>(v, t, j, i);
        }
      }
}

// The first K of two sorted lists, sorted, into (v, t): the larger of
// v[i] and (cv, ct)[K - 1 - i] holds the first K of both (a bitonic
// sequence), which log2(K) rounds of compare-exchanges sort.
template <int K>
__device__ __forceinline__ void merge(float (&v)[K], int32_t (&t)[K], const float (&cv)[K],
                                      const int32_t (&ct)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) {
    if (before(cv[K - 1 - i], ct[K - 1 - i], v[i], t[i])) {
      v[i] = cv[K - 1 - i];
      t[i] = ct[K - 1 - i];
    }
  }
#pragma unroll
  for (int stride = K / 2; stride > 0; stride /= 2)
#pragma unroll
    for (int i = 0; i < K; ++i)
      if ((i ^ stride) > i) order<K>(v, t, i, i ^ stride);
}

// Buffer `b` of (K, 128) entries at (bv, bt): a sorted list's lane.
template <int K>
__device__ __forceinline__ void store(const float (&v)[K], const int32_t (&t)[K], float* bv,
                                      int32_t* bt, int b, int lane) {
  const int64_t o = (int64_t)b * K * octet::kLanes + lane;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    bv[o + k * octet::kLanes] = v[k];
    bt[o + k * octet::kLanes] = t[k];
  }
}

// The first K, sorted, of the sorted buffers first + start, first + start
// + STRIDE, ... below first + count, for the thread's lane (an empty list
// when there is none); read through L2 (__ldcg: other blocks wrote them),
// the loads of R buffers (64 registers) issued before their merges.
template <int K, int STRIDE>
__device__ __forceinline__ void gather(float (&v)[K], int32_t (&t)[K], const float* bv,
                                       const int32_t* bt, int first, int count, int start,
                                       int lane) {
  constexpr int R = 32 / K;
  clear<K>(v, t);
  for (int b0 = start; b0 < count; b0 += R * STRIDE) {
    float cv[R][K];
    int32_t ct[R][K];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int b = b0 + r * STRIDE;
      if (b < count) {
        const int64_t o = (int64_t)(first + b) * K * octet::kLanes + lane;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          cv[r][k] = __ldcg(bv + o + k * octet::kLanes);
          ct[r][k] = __ldcg(bt + o + k * octet::kLanes);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (b0 + r * STRIDE < count) merge<K>(v, t, cv[r], ct[r]);
  }
}

// The first `count` groups' sorted lists of a block of 128-thread groups,
// through shared memory (sv, st: a list of K x 128 entries a group):
// group 0's threads end with the first K of them for their lane, sorted.
// The caller makes sure no thread still reads sv / st.
template <int K>
__device__ __forceinline__ void combine(float (&v)[K], int32_t (&t)[K], float* sv, int32_t* st,
                                        int group, int lane, int count) {
  if (group > 0 && group < count) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      sv[(group * K + k) * octet::kLanes + lane] = v[k];
      st[(group * K + k) * octet::kLanes + lane] = t[k];
    }
  }
  __syncthreads();
  if (group == 0) {
    for (int g = 1; g < count; ++g) {
      float cv[K];
      int32_t ct[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        cv[k] = sv[(g * K + k) * octet::kLanes + lane];
        ct[k] = st[(g * K + k) * octet::kLanes + lane];
      }
      merge<K>(v, t, cv, ct);
    }
  }
}

// Whether this block is the last of `count` to reach *ticket: every
// thread's writes are fenced first; the last block resets the ticket (no
// other block of the launch touches it again). Every thread of the block
// gets the answer (__syncthreads_or: no shared memory).
__device__ __forceinline__ bool arrive(unsigned* ticket, int count) {
  __threadfence();
  __syncthreads();
  bool last = false;
  if (threadIdx.x == 0) {
    last = atomicAdd(ticket, 1u) == static_cast<unsigned>(count - 1);
    if (last) *ticket = 0u;
  }
  return __syncthreads_or(last) != 0;
}

// Integer ceil(sqrt(n)): the set size of a merge over n lists, so that
// about sqrt(n) sets of about sqrt(n) lists each merge in turn.
inline int set_size_of(int n) {
  int s = 1;
  while (s * s < n) ++s;
  return s;
}

// Where merge_slots leaves its lists: unmerged, each slot's sorted buffer
// (list p * slots + slot of the workspace ws_v / ws_t); merged, the
// blocks' and sets' lists there and the result in out_v / out_t, (P, K,
// 128); tickets: P * (1 + sets) zeros, left 0.
struct SlotMerge {
  bool merged;
  int set_size;   // set_size_of(blocks)
  float* ws_v;
  int32_t* ws_t;
  unsigned* tickets;
  float* out_v;
  int32_t* out_t;
};

// The merge of a launch of G-slot blocks (128-thread groups, one lane
// buffer each; one wave of gridDim.x blocks a partition, gridDim.y
// partitions), in three levels: each slot sorts its buffer and a block
// merges its slots' in shared memory (smem: G lists of K x 128 entries,
// no longer read by anyone when called) into one list of the workspace;
// a ticket elects the last block to finish in each set of set_size
// blocks, which merges the set's lists; a second ticket elects the last
// set, which merges the sets' into the outputs. Each elected block resets
// its ticket.
template <int K, int G>
__device__ __forceinline__ void merge_slots(float (&tv)[K], int32_t (&tt)[K], unsigned char* smem,
                                            const SlotMerge& a) {
  const int lane = threadIdx.x % octet::kLanes;
  const int group = threadIdx.x / octet::kLanes;
  const int block = blockIdx.x, blocks = gridDim.x, p = blockIdx.y;
  sort<K>(tv, tt);
  if (!a.merged) {
    store<K>(tv, tt, a.ws_v, a.ws_t, (p * blocks + block) * G + group, lane);
    return;
  }
  // 1. the block's slots -> its list, p * (blocks + sets) + block
  const int sets = (blocks + a.set_size - 1) / a.set_size;
  const int64_t base = (int64_t)p * (blocks + sets) * K * octet::kLanes;
  float* wv = a.ws_v + base;
  int32_t* wt = a.ws_t + base;
  float* sv = reinterpret_cast<float*>(smem);
  int32_t* st = reinterpret_cast<int32_t*>(sv + G * K * octet::kLanes);
  __syncthreads();   // no thread reads the table any more: its bytes hold sv, st
  combine<K>(tv, tt, sv, st, group, lane, G);
  if (group == 0) store<K>(tv, tt, wv, wt, block, lane);
  // 2. the last block of each set -> the set's list, after the blocks'
  // (the outputs when there is one set)
  const int set = block / a.set_size, first = set * a.set_size;
  const int in_set = min(a.set_size, blocks - first);
  unsigned* ticket = a.tickets + (int64_t)p * (1 + sets);
  if (!arrive(ticket + 1 + set, in_set)) return;
  gather<K, G>(tv, tt, wv, wt, first, in_set, group, lane);
  combine<K>(tv, tt, sv, st, group, lane, min(G, in_set));
  if (sets == 1) {
    if (group == 0) store<K>(tv, tt, a.out_v, a.out_t, p, lane);
    return;
  }
  if (group == 0) store<K>(tv, tt, wv, wt, blocks + set, lane);
  // 3. the last set -> the outputs
  if (!arrive(ticket, sets)) return;
  gather<K, G>(tv, tt, wv, wt, blocks, sets, group, lane);
  combine<K>(tv, tt, sv, st, group, lane, min(G, sets));
  if (group == 0) store<K>(tv, tt, a.out_v, a.out_t, p, lane);
}

}  // namespace lane_merge
