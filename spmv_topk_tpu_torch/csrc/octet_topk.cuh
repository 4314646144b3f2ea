// Octet Top-K sweep (kernel K1; K10b with partitions) for Hopper (sm_90a),
// every query codec (codecs.cuh). octet_topk.cu holds the h16
// instantiations and the C entry point, octet_topk_q.cu the other codecs'
// (a translation unit of their own, so that nvcc builds them in parallel).
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
// chunks into 8 member scores (octet_common.cuh::octet_sums: h16 in int32,
// converted once; the float codecs in the JAX kernel's order, two
// alternating accumulators per block and block sums carried in f32), sets
// members past the bucket's real slices to -inf, and harvests them into
// its own lane_k-entry (value, slice tag) buffer: the top 3 of the 8 in
// three max / lowest-index passes, or each member in turn when
// fold_tile == 1 (EXACT). The buffer update is argmin replacement
// (_topk_update): replace the first minimum (TIE_SAFE) or every slot that
// holds the minimum, when score >= minimum.
//
// Design. One CUDA block of 128 threads is the 128 lanes of one octet at
// a time, so a warp reads 128 contiguous bytes of every sublane row and
// a block 4 KB per chunk. The query table sits in shared memory (512
// bytes for h16, up to 227 KB for f32; an f32 table past that is read
// from global memory, F32Global); the lane buffers and the accumulators
// sit in registers (lane_k is a template parameter, so every index is
// static). Blocks grid-stride over the octets of all buckets
// (octet_common.cuh::locate); there is no carry between blocks, so the
// TPU's block-padding octets do not exist here. Each block writes its
// buffers to out[blockIdx]; one per-lane torch.topk over the blocks
// follows (ops/kernel.py::merge_lane_topk).
//
// Bound. A query reads every packed word once (about 450 MB at the 10M x
// 1024 headline corpus in h16) and spends about 10 integer or float
// operations and one or two shared-memory gathers per word, so the sweep
// should be bound by device memory bytes. Eight independent loads per lane
// per chunk keep bytes in flight; wider loads, cp.async/TMA rings and more
// lanes per thread are later work.

#pragma once

#include "octet_common.cuh"

namespace k1 {

using namespace octet;

// PARTS: a partitioned stream (grid y > 1). The one-partition sweep is
// its own instantiation without the partition offsets: computed at run
// time they slowed this sweep's narrow-octet loop on the H100.
template <class C, int K, bool TIE_SAFE, bool EXACT, bool PARTS>
__global__ void __launch_bounds__(kLanes)
octet_topk_kernel(const int32_t* __restrict__ words,
                  const typename C::Tab* __restrict__ table,
                  const int32_t* __restrict__ nreal,
                  const int32_t* __restrict__ plan, int num_buckets,
                  int block_sublanes, int table_rows, int shift, int part_rows,
                  int part_slices, float* __restrict__ out_v, int32_t* __restrict__ out_t) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x;
  const auto tab = codec::stage_table<C, true>(smem, table, table_rows, shift, lane);

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
    float sc[kMembers];
    octet_sums<C>(oc, tab, block_sublanes / kMembers, sc);
#pragma unroll
    for (int m = 0; m < kMembers; ++m)
      if (oc.index + m * oc.stride >= oc.n_real) sc[m] = -INFINITY;
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
  const void* table;
  const int32_t* nreal;
  const int32_t* plan;
  int codec, num_buckets, block_sublanes, table_rows, shift, lane_k, num_cuda_blocks,
      num_partitions, part_rows, part_slices;
  bool exact, tie_safe;
  float* out_v;
  int32_t* out_t;
  cudaStream_t stream;
};

template <class C, int K, bool TIE_SAFE, bool EXACT>
cudaError_t launch(const Args& a) {
  auto kernel = a.num_partitions > 1 ? octet_topk_kernel<C, K, TIE_SAFE, EXACT, true>
                                     : octet_topk_kernel<C, K, TIE_SAFE, EXACT, false>;
  const size_t smem = codec::table_smem_bytes<C, true>(a.table_rows);
  const cudaError_t err = codec::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.num_cuda_blocks, a.num_partitions);
  kernel<<<grid, kLanes, smem, a.stream>>>(
      a.words, static_cast<const typename C::Tab*>(a.table), a.nreal, a.plan, a.num_buckets,
      a.block_sublanes, a.table_rows, a.shift, a.part_rows, a.part_slices, a.out_v, a.out_t);
  return cudaSuccess;
}

template <class C, int K>
cudaError_t launch_k(const Args& a) {
  if (a.tie_safe && a.exact) return launch<C, K, true, true>(a);
  if (a.tie_safe) return launch<C, K, true, false>(a);
  if (a.exact) return launch<C, K, false, true>(a);
  return launch<C, K, false, false>(a);
}

// Launches the sweep for the codecs of `only` (codec::dispatch).
template <unsigned only>
cudaError_t launch_codecs(const Args& a) {
  return codec::dispatch<only>(a.codec, [&](auto tag) {
    using C = typename decltype(tag)::type;
    switch (a.lane_k) {
      case 4: return launch_k<C, 4>(a);
      case 8: return launch_k<C, 8>(a);
      case 16: return launch_k<C, 16>(a);
      default: return cudaErrorInvalidValue;
    }
  });
}

// Every codec but h16 (octet_topk_q.cu).
cudaError_t launch_quantized(const Args& a);

}  // namespace k1
