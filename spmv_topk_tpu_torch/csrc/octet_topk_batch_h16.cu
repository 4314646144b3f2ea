// Multi-query octet Top-K sweep for the h16 codec (kernel K6 h16; K10d h16
// with partitions) for Hopper (sm_90a): every query of a pass of up to 32
// reads each word of the stream once.
//
// Replaces the h16 route of spmv_topk_tpu/ops/kernel.py::
// _fused_kernel_batch_octet (the pallas_calls of
// topk_spmv_fused_batch_octet_device and, with P row partitions,
// topk_spmv_fused_batch_octet_part_device). The other codecs' sweep,
// octet_topk_batch.cuh, has this kernel's design.
//
// What it computes. For each
// query, every octet's 8 member scores (int32 sums of the word products,
// exact, converted once), members past the bucket's real slices -inf,
// harvested (top 3 of 8, or every member with fold_tile 1: EXACT) into
// per-lane (value, slice tag) buffers of K entries by argmin replacement
// (octet_common.cuh::harvest), a set of buffers per slot; then, in the
// same launch, each lane's top K of every slot's entries in the order
// value descending, then tag ascending (lane_merge.cuh):
// out[q][p] = (K, 128), what ops/kernel.py::octet_topk_batch_slots_plain
// computes.
//
// Design. A CUDA block is 8 warps per 32 lanes of the stream (64 lanes,
// 16 warps, at K 4 and 8; 32 lanes at K 16; 128 / lanes blocks share a
// slot): the warps of member m add up member m of each octet, each thread
// one lane, for every query of the pass at once (codecs.cuh::H16x32: 16
// bytes of shared-memory table per column hold the pass's 32 queries, two
// gathers and about two instructions per query per word). So each word of
// the stream is read once per pass of 32 queries, by one warp, 128
// contiguous bytes a row; the loads run two batches ahead, into the next
// octet. The member sums go through shared memory to the harvest. The
// (lane, query) buffers live in shared memory, with their minima, behind
// the harvest queue of batch_sweep.cuh (shared with K6's other codecs and
// K8): only the pairs that can enter (at first most of them, soon a few)
// are harvested. Three barriers an octet. Blocks grid-stride over the
// octets, one block an SM (the registers of 512 threads; the shared
// memory); the grid is (slots x lane groups, partitions, passes of 32
// queries). The merge: each block sorts
// its buffers into the workspace, a ticket elects the last block of each
// set of about sqrt(slots) slots to merge the set's, a second ticket the
// last set (as K13 does; batch_sweep.cuh::merge_pass).
//
// Bound. Per word and pass: one coalesced load, two 16-byte gathers and
// about 66 instructions, 33 of them dp2a, for 32 queries. At the 10M x
// 1024 headline corpus (112M words) that is about 7.4e9 instructions and
// 7.2 GB of gathers a pass, each near 0.25-0.3 ms on 132 SMs, against
// 0.134 ms for the 449 MB of words: the sweep is bound by the SMs' integer
// issue and shared-memory gathers, not by device memory. On one H100
// 80GB HBM3 at 700 W it takes 0.68 ms a group of 32, 0.73 with its merge
// (chip_smoke.py, batch phase; the work an octet beside the products, at
// about 11 words a member, is most of the difference).

#include "batch_sweep.cuh"

namespace k6h16 {

using namespace octet;
using namespace lane_merge;
using codec::H16x32;

constexpr int kUnroll = 4;                            // words a load batch
constexpr int64_t kStep = (int64_t)kMembers * kLanes;  // a chunk's words
// words summed in one set of packed accumulators (codecs.cuh::H16x32: a
// span's sums stay exact below kH16x32MaxWidth words)
constexpr int kSpan = 32768;
static_assert(kSpan <= codec::kH16x32MaxWidth, "a span's packed sums must stay exact");

// Stream lanes a block sweeps: 64 (16 warps) where its buffers fit shared
// memory beside the rest, 32 at lane_k 16. ops/kernel.py::H16_BLOCK_LANES.
template <int K>
constexpr int kBlockLanes = K <= 8 ? 64 : 32;

// The block's shared memory, in this order: the table (H16x32); the
// member sums of the octet, (query, member, lane) int32; the (lane,
// query) buffers, (query, entry, lane) values then tags; their minima,
// (query, lane); the harvest queue, (query, lane) pairs as uint16.
template <int NR, int K>
struct Smem {
  static constexpr int kQ = 8 * NR, kL = kBlockLanes<K>;
  static constexpr size_t kSums = H16x32::kTableBytes;
  static constexpr size_t kBufV = kSums + sizeof(int32_t) * kQ * kMembers * kL;
  static constexpr size_t kBufT = kBufV + sizeof(float) * kQ * K * kL;
  static constexpr size_t kMin = kBufT + sizeof(int32_t) * kQ * K * kL;
  static constexpr size_t kQueue = kMin + sizeof(float) * kQ * kL;
  static constexpr size_t kBytes = kQueue + sizeof(uint16_t) * kQ * kL;
};

template <int NR, int K, bool TIE_SAFE, bool EXACT>
__global__ void __launch_bounds__(kMembers * kBlockLanes<K>, 1)
octet_topk_batch_h16_kernel(const int32_t* __restrict__ words, const int32_t* __restrict__ tables,
                            const int32_t* __restrict__ nreal, const int32_t* __restrict__ plan,
                            int num_buckets, int block_sublanes, int num_queries, int part_rows,
                            int part_slices, bool merged, int set_size, float* ws_v,
                            int32_t* ws_t, unsigned* tickets, float* __restrict__ out_v,
                            int32_t* __restrict__ out_t) {
  using S = Smem<NR, K>;
  constexpr int QP = S::kQ;    // queries a pass computes
  constexpr int L = S::kL;     // stream lanes of the block
  constexpr int T = kMembers * L;
  constexpr int kGroups = kLanes / L;   // blocks (lane groups) a slot
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int queued;
  const uint4* tab = reinterpret_cast<const uint4*>(smem);
  int32_t* sums = reinterpret_cast<int32_t*>(smem + S::kSums);
  float* buf_v = reinterpret_cast<float*>(smem + S::kBufV);
  int32_t* buf_t = reinterpret_cast<int32_t*>(smem + S::kBufT);
  float* buf_min = reinterpret_cast<float*>(smem + S::kMin);
  uint16_t* queue = reinterpret_cast<uint16_t*>(smem + S::kQueue);
  const int warp = threadIdx.x / 32;
  const int member = warp % kMembers;
  const int lane = (warp / kMembers) * 32 + threadIdx.x % 32;   // of the block's L
  const int slot = blockIdx.x / kGroups;
  const int num_slots = gridDim.x / kGroups;
  const int stream_lane = (blockIdx.x % kGroups) * L + lane;
  const int q0 = blockIdx.z * codec::kH16x32Queries;
  const int nq = min(QP, num_queries - q0);
  H16x32::load<NR>(reinterpret_cast<uint32_t*>(smem), tables, q0, nq, threadIdx.x, T);
  batch::init_buffers<K, TIE_SAFE, QP, L, T>(buf_v, buf_t, buf_min);
  if (threadIdx.x == 0) queued = 0;
  __syncthreads();

  const Partition part = partition(words, nreal, num_buckets, part_rows, part_slices);
  const int total = total_octets(plan, num_buckets);
  int b = 0;
  // the block's next octet with a real member from g on (skeleton padding
  // holds none; the whole block skips it), and the first two load batches
  // of this warp's member of it: a batch is kUnroll words, two batches are
  // in flight ahead of the products, across octets too (words past the
  // width read as 0, whose products are 0)
  uint32_t w0[kUnroll], w1[kUnroll];
  auto load = [&](uint32_t(&w)[kUnroll], const Octet& o, int j) {
#pragma unroll
    for (int i = 0; i < kUnroll; ++i)
      w[i] = j + i < o.width ? static_cast<uint32_t>(__ldg(o.src + member * kLanes +
                                                            (j + i) * kStep))
                             : 0u;
  };
  auto next = [&](int& g) {   // g moves to that octet, or past total
    Octet o{};
    for (; g < total; g += num_slots) {
      o = locate(part.words, plan, part.nreal, num_buckets, block_sublanes, g, b, stream_lane);
      if (o.index < o.n_real) break;
    }
    if (g < total) {
      load(w0, o, 0);
      load(w1, o, kUnroll);
    }
    return o;
  };
  int g = slot;
  Octet oc = next(g);
  while (g < total) {
    {
      // member `member`'s sums for the pass's queries, in spans of kSpan
      // words added up modulo 2^32 as the int32 sums of the plain version
      // are
      int32_t* out = sums + member * L + lane;
      int32_t acc[QP];
      int32_t vs = 0;
#pragma unroll
      for (int q = 0; q < QP; ++q) acc[q] = 0;
      auto flush = [&](bool first) {
#pragma unroll
        for (int q = 0; q < QP; ++q) {
          const uint32_t span = static_cast<uint32_t>(H16x32::finish(acc[q], vs, q % 8));
          int32_t& o = out[q * kMembers * L];
          o = static_cast<int32_t>(first ? span : static_cast<uint32_t>(o) + span);
          acc[q] = 0;
        }
        vs = 0;
      };
      for (int j = 0; j < oc.width; j += kUnroll) {
        if (j > 0 && j % kSpan == 0) flush(j == kSpan);
        uint32_t w2[kUnroll];
        load(w2, oc, j + 2 * kUnroll);
#pragma unroll
        for (int i = 0; i < kUnroll; ++i) H16x32::add<NR>(acc, vs, w0[i], tab);
#pragma unroll
        for (int i = 0; i < kUnroll; ++i) {
          w0[i] = w1[i];
          w1[i] = w2[i];
        }
      }
      flush(oc.width <= kSpan);
    }
    const Octet cur = oc;
    g += num_slots;
    oc = next(g);
    __syncthreads();
    batch::octet_harvest<K, TIE_SAFE, EXACT, QP, L>(sums, buf_v, buf_t, buf_min, queue, queued,
                                                   cur, part.tag_offset + cur.slice0, member,
                                                   lane, nq);
  }
  batch::merge_pass<K, QP, L>(buf_v, buf_t, member, lane, q0, nq, num_queries, merged, set_size,
                              ws_v, ws_t, tickets, out_v, out_t);
}

struct Args {
  const int32_t* words;
  const int32_t* tables;
  const int32_t* nreal;
  const int32_t* plan;
  int num_buckets, block_sublanes, num_queries, slots, num_partitions, passes, part_rows,
      part_slices;
  bool merged;
  float* ws_v;
  int32_t* ws_t;
  unsigned* tickets;
  float* out_v;
  int32_t* out_t;
  cudaStream_t stream;
};

template <int NR, int K, bool TIE_SAFE, bool EXACT>
cudaError_t launch(const Args& a) {
  auto kernel = octet_topk_batch_h16_kernel<NR, K, TIE_SAFE, EXACT>;
  constexpr size_t smem = Smem<NR, K>::kBytes;
  const cudaError_t err = codec::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  constexpr int L = kBlockLanes<K>;
  const dim3 grid(a.slots * (kLanes / L), a.num_partitions, a.passes);
  kernel<<<grid, kMembers * L, smem, a.stream>>>(
      a.words, a.tables, a.nreal, a.plan, a.num_buckets, a.block_sublanes, a.num_queries,
      a.part_rows, a.part_slices, a.merged, set_size_of(a.slots), a.ws_v, a.ws_t, a.tickets,
      a.out_v, a.out_t);
  return cudaSuccess;
}

template <int NR, int K>
cudaError_t launch_flags(const Args& a, bool tie_safe, bool exact) {
  if (tie_safe && exact) return launch<NR, K, true, true>(a);
  if (tie_safe) return launch<NR, K, true, false>(a);
  if (exact) return launch<NR, K, false, true>(a);
  return launch<NR, K, false, false>(a);
}

template <int NR>
cudaError_t launch_nr(const Args& a, int lane_k, bool tie_safe, bool exact) {
  switch (lane_k) {
    case 4: return launch_flags<NR, 4>(a, tie_safe, exact);
    case 8: return launch_flags<NR, 8>(a, tie_safe, exact);
    case 16: return launch_flags<NR, 16>(a, tie_safe, exact);
    default: return cudaErrorInvalidValue;
  }
}

// Straight-line decodes of 1 and 2 words for 32 queries, never launched:
// the difference of their SASS instruction counts is the decode's count
// per word (ops/_build.py::sass_report, chip_smoke.py's sass phase).
template <int WORDS>
__global__ void h16x32_words_probe(const uint32_t* __restrict__ w, int32_t* __restrict__ out) {
  __shared__ uint4 tab[codec::kH16Cols];
  int32_t acc[codec::kH16x32Queries] = {};
  int32_t vs = 0;
#pragma unroll
  for (int i = 0; i < WORDS; ++i) H16x32::add<4>(acc, vs, w[i * blockDim.x + threadIdx.x], tab);
#pragma unroll
  for (int q = 0; q < codec::kH16x32Queries; ++q)
    out[q * blockDim.x + threadIdx.x] = H16x32::finish(acc[q], vs, q % 8);
}

template __global__ void h16x32_words_probe<1>(const uint32_t*, int32_t*);
template __global__ void h16x32_words_probe<2>(const uint32_t*, int32_t*);

}  // namespace k6h16

extern "C" {

// words: (num_partitions * part_rows, 128) int32 h16 octet stream;
// tables: (Q, 128) int32 int4x8 tables; nreal: (num_partitions,
// num_buckets) int32; plan: (num_buckets, 8) int32; slots: blocks per
// lane group, partition and pass; workspace: int32 storage of
// workspace_lists x 2 x lane_k x 128 entries, at least Q x num_partitions
// x (slots + ceil(slots / ceil(sqrt(slots)))) lists: the slots' sorted
// lists, (Q, num_partitions, slots, lane_k, 128) values then tags, and the
// sets'; tickets: num_tickets unsigned zeros, at least ceil(Q / 32) x
// num_partitions x 4 x (1 + sets) (the kernel leaves them 0); out_v/out_t:
// (Q, num_partitions, lane_k, 128), each lane's merged top lane_k, values
// descending (then tags ascending). merged 0 stops after the slots' lists
// (out_v/out_t unused). The grid runs ceil(Q / 32) passes; a pass sizes
// its sums for min(Q, 32) queries rounded up to 8, 16 or 32. Returns
// cudaGetLastError() (or the error of a refused launch).
int octet_topk_batch_h16(const int32_t* words, const int32_t* tables, const int32_t* nreal,
                         const int32_t* plan, int num_buckets, int block_sublanes, int lane_k,
                         int exact, int tie_safe, int num_queries, int slots, int num_partitions,
                         int part_rows, int part_slices, int merged, int32_t* workspace,
                         int64_t workspace_lists, unsigned* tickets, int64_t num_tickets,
                         float* out_v, int32_t* out_t, void* stream) {
  const int passes = (num_queries + codec::kH16x32Queries - 1) / codec::kH16x32Queries;
  if (num_buckets < 1 || num_queries < 1 || slots < 1 || passes > 65535 ||
      num_partitions < 1 || num_partitions > 65535 || slots > (1 << 29))
    return cudaErrorInvalidValue;
  const int sets = (slots + lane_merge::set_size_of(slots) - 1) / lane_merge::set_size_of(slots);
  const int64_t lists = (int64_t)num_queries * num_partitions * (slots + sets);
  if (workspace_lists < lists ||
      num_tickets < (int64_t)passes * num_partitions * (octet::kLanes / 32) * (1 + sets))
    return cudaErrorInvalidValue;
  float* ws_v = reinterpret_cast<float*>(workspace);
  int32_t* ws_t = workspace + workspace_lists * lane_k * octet::kLanes;
  const k6h16::Args a{words,         tables,         nreal,         plan,
                      num_buckets,   block_sublanes, num_queries,   slots,
                      num_partitions, passes,        part_rows,     part_slices,
                      merged != 0,   ws_v,           ws_t,          tickets,
                      out_v,         out_t,          static_cast<cudaStream_t>(stream)};
  const int live = num_queries < codec::kH16x32Queries ? num_queries : codec::kH16x32Queries;
  cudaError_t err;
  if (live <= 8)
    err = k6h16::launch_nr<1>(a, lane_k, tie_safe != 0, exact != 0);
  else if (live <= 16)
    err = k6h16::launch_nr<2>(a, lane_k, tie_safe != 0, exact != 0);
  else
    err = k6h16::launch_nr<4>(a, lane_k, tie_safe != 0, exact != 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
