// Octet Top-K sweep of the h16 stream (kernel K1; K10b with partitions)
// for Hopper (sm_90a).
//
// Replaces spmv_topk_tpu/ops/kernel.py::_fused_kernel_octet together with
// its _octet_multicall dispatch: one launch sweeps every bucket. With P
// row partitions (topk_spmv_fused_octet_part_device, the (P, num_blocks)
// grid) the partition is the grid's y index: each CUDA block sweeps one
// partition's octets, tags them p * part_slices up, as the JAX kernel's
// toff does, and its buffers merge per partition into (P, lane_k, 128).
// Octets whose members are all past the bucket's real slices (the
// shared skeleton's padding) are skipped; they hold no candidate.
//
// What it computes. The stream (formats/sell_buckets.py::
// fuse_buckets_octet) is a sequence of octets; chunk j (8 sublanes x 128
// lanes of int32) of octet o holds word j of the eight member slices
// slice_base + o + m*stride, m = 0..7, one per sublane. Each lane is one
// row of its slice. A lane adds up the decoded products of the octet's W
// chunks into 8 int32 member scores, converts them to float once, sets
// members past the bucket's real slices to -inf, and harvests them into
// its own lane_k-entry (value, slice tag) buffer: the top 3 of the 8 in
// three max / lowest-index passes, or each member in turn when
// fold_tile == 1 (EXACT). The buffer update is argmin replacement
// (_topk_update): replace the first minimum (TIE_SAFE) or every slot that
// holds the minimum, when score >= minimum.
//
// Design. One CUDA block of 128 threads is the 128 lanes of one octet at
// a time, so a warp reads 128 contiguous bytes of every sublane row and
// a block 4 KB per chunk. The h16 query table (128 int32) sits in shared
// memory; the lane buffers and the 8 accumulators sit in registers
// (lane_k is a template parameter, so every index is static). Blocks
// grid-stride over the octets of all buckets (octet_common.cuh::locate);
// there is no carry between blocks, so the TPU's block-padding octets do
// not exist here. Each block writes its buffers to out[blockIdx]; one
// per-lane torch.topk over the blocks follows (ops/kernel.py::
// merge_lane_topk).
//
// Bound. A query reads every packed word once (about 450 MB at the 10M x
// 1024 headline corpus) and spends about 10 integer operations and two
// shared-memory gathers per word, so the sweep should be bound by device
// memory bytes. Eight independent loads per lane per chunk keep bytes in
// flight; wider loads, cp.async/TMA rings and more lanes per thread are
// later work.

#include "octet_common.cuh"

namespace {

using namespace octet;

// PARTS: a partitioned stream (grid y > 1). The one-partition sweep is
// its own instantiation without the partition offsets: computed at run
// time they slowed this sweep's narrow-octet loop on the H100.
template <int K, bool TIE_SAFE, bool EXACT, bool PARTS>
__global__ void __launch_bounds__(kLanes)
octet_topk_kernel(const int32_t* __restrict__ words,
                  const int32_t* __restrict__ table,
                  const int32_t* __restrict__ nreal,
                  const int32_t* __restrict__ plan, int num_buckets,
                  int block_sublanes, int part_rows, int part_slices,
                  float* __restrict__ out_v, int32_t* __restrict__ out_t) {
  __shared__ int32_t tab[kLanes];
  const int lane = threadIdx.x;
  tab[lane] = table[lane];
  __syncthreads();

  float tv[K];
  int32_t tt[K];
  topk_init<K, TIE_SAFE>(tv, tt);

  const Partition part = PARTS ? partition(words, nreal, num_buckets, part_rows, part_slices)
                               : Partition{words, nreal, 0};
  const int total = total_octets(plan, num_buckets);
  int b = 0;
  for (int g = blockIdx.x; g < total; g += gridDim.x) {
    const Octet oc = locate(part.words, plan, part.nreal, num_buckets, block_sublanes, g, b, lane);
    if (PARTS && oc.index >= oc.n_real) continue;   // skeleton padding: no real member
    int32_t acc[kMembers];
    octet_sums(oc, tab, acc);
    float sc[kMembers];
#pragma unroll
    for (int m = 0; m < kMembers; ++m)
      sc[m] = (oc.index + m * oc.stride < oc.n_real) ? static_cast<float>(acc[m]) : -INFINITY;
    harvest<K, TIE_SAFE, EXACT>(tv, tt, sc, part.tag_offset + oc.slice0, oc.stride);
  }

  const int64_t blk = PARTS ? (int64_t)blockIdx.y * gridDim.x + blockIdx.x : blockIdx.x;
  const int64_t out0 = blk * K * kLanes + lane;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    out_v[out0 + s * kLanes] = tv[s];
    out_t[out0 + s * kLanes] = tt[s];
  }
}

struct Args {
  const int32_t* words;
  const int32_t* table;
  const int32_t* nreal;
  const int32_t* plan;
  int num_buckets, block_sublanes, num_cuda_blocks, num_partitions, part_rows, part_slices;
  float* out_v;
  int32_t* out_t;
  cudaStream_t stream;
};

template <int K, bool TIE_SAFE, bool EXACT>
void launch(const Args& a) {
  const dim3 grid(a.num_cuda_blocks, a.num_partitions);
  auto kernel = a.num_partitions > 1 ? octet_topk_kernel<K, TIE_SAFE, EXACT, true>
                                     : octet_topk_kernel<K, TIE_SAFE, EXACT, false>;
  kernel<<<grid, kLanes, 0, a.stream>>>(a.words, a.table, a.nreal, a.plan, a.num_buckets,
                                        a.block_sublanes, a.part_rows, a.part_slices, a.out_v,
                                        a.out_t);
}

template <int K>
void launch_k(bool tie_safe, bool exact, const Args& a) {
  if (tie_safe && exact) launch<K, true, true>(a);
  else if (tie_safe) launch<K, true, false>(a);
  else if (exact) launch<K, false, true>(a);
  else launch<K, false, false>(a);
}

}  // namespace

extern "C" {

// words: (num_partitions * part_rows, 128) int32, part_rows a whole
// number of blocks; table: (1, 128) int32; nreal: (num_partitions,
// num_buckets) int32; plan: (num_buckets, 8) int32; part_slices: slice
// tags per partition; out_v/out_t: (num_partitions, num_cuda_blocks,
// lane_k, 128). Returns cudaGetLastError().
int octet_topk_h16(const int32_t* words, const int32_t* table,
                   const int32_t* nreal, const int32_t* plan, int num_buckets,
                   int block_sublanes, int lane_k, int exact, int tie_safe,
                   int num_cuda_blocks, int num_partitions, int part_rows,
                   int part_slices, float* out_v, int32_t* out_t, void* stream) {
  if (num_buckets < 1 || num_cuda_blocks < 1 || num_partitions < 1 || num_partitions > 65535)
    return cudaErrorInvalidValue;
  const Args a{words, table, nreal, plan, num_buckets, block_sublanes, num_cuda_blocks,
               num_partitions, part_rows, part_slices, out_v, out_t,
               static_cast<cudaStream_t>(stream)};
  switch (lane_k) {
    case 4: launch_k<4>(tie_safe, exact, a); break;
    case 8: launch_k<8>(tie_safe, exact, a); break;
    case 16: launch_k<16>(tie_safe, exact, a); break;
    default: return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
