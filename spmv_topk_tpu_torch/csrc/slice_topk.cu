// Slice-stream Top-K sweep of one query (kernel K7; K10a with
// partitions) for Hopper (sm_90a), every query codec (codecs.cuh).
//
// Replaces spmv_topk_tpu/ops/kernel.py::_fused_kernel (the pallas_calls
// of topk_spmv_fused_device and, with P row partitions,
// topk_spmv_fused_part_device: the partition is the grid's y index, tags
// are offset by p * part_slices as the JAX kernel's toff, and the buffers
// merge per partition into (P, lane_k, 128)).
//
// What it computes. Every real slice's 128 row scores (slice_common.cuh:
// a lane adds up its W decoded words), harvested into per-lane (value,
// slice tag) buffers of lane_k entries by argmin replacement
// (_topk_update): replace the first minimum (TIE_SAFE) or every slot
// holding it, when score >= minimum. Which scores are harvested is the
// JAX kernel's rule (ops/kernel.py::slice_work): with fold_tile > 1 and a
// block whose slice loop the TPU unrolled, each strided sub-tile of up to
// fold_tile slices gives its top 2 (lowest member among ties, the order
// of tflush; a NaN member makes tflush's maximum NaN, so that sub-tile
// gives nothing); otherwise, and for every wide slice, each slice is
// folded.
// Slices past a bucket's real count (the last block's padding) are
// skipped: they enter the JAX buffers only as -inf.
//
// Design. One CUDA block of 128 threads, one per lane; the query table
// in shared memory (128 int32 for h16; table_rows x 128 floats for f32,
// 4 KB at 1024 columns; table_rows x 128 int32 for int8x4, i8s and i4s,
// 1 KB at 1024 columns; an f32 table past a block's shared memory, above
// 58,112 columns on the H100, is gathered from global memory through the
// read-only path, F32Global); the lane buffers in registers (lane_k is a
// template parameter). Blocks grid-stride over the work items of all
// buckets (a run of slices, a sub-tile, or one wide slice with its block
// sums carried in registers), so no state crosses blocks and the TPU's
// sequential carry has no counterpart. Each block writes its buffers to
// out[blockIdx]; one per-lane torch.topk merges them (ops/kernel.py::
// merge_lane_topk).
//
// Bound. A query reads every packed word once (about 0.43 GB for the
// h16 batch engine, 0.93 GB for the default f32 engine at the 10M x 1024
// corpus) with a few integer or float operations and one shared-memory
// gather per word, so the sweep should be bound by device memory bytes;
// a warp reads 128 contiguous bytes per row, and a thread's W loads of a
// slice are independent (unrolled by 4). Wider loads and more bytes in
// flight per thread are later work.

#include "slice_common.cuh"

namespace {

using namespace slice;

template <class C, int K, bool TIE_SAFE>
__global__ void __launch_bounds__(kLanes)
slice_topk_kernel(const int32_t* __restrict__ words,
                  const typename C::Tab* __restrict__ table,
                  const int32_t* __restrict__ nreal,
                  const int32_t* __restrict__ plan, int num_buckets,
                  int block_sublanes, int table_rows, int shift, int fold_tile,
                  int part_rows, int part_slices,
                  float* __restrict__ out_v, int32_t* __restrict__ out_t) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x;
  const auto tab = codec::stage_table<C, false>(smem, table, table_rows, shift, lane);

  float tv[K];
  int32_t tt[K];
  octet::topk_init<K, TIE_SAFE>(tv, tt);

  const Partition part = partition(words, nreal, num_buckets, part_rows, part_slices);
  Walker w(part.words, plan, part.nreal, num_buckets, block_sublanes, fold_tile, lane);
  Item it;
  for (int g = blockIdx.x; w.locate(g, it); g += gridDim.x) {
    if (it.top2) {
      float m1 = -INFINITY, m2 = -INFINITY;
      int i1 = -1, i2 = -1;
      bool nan = false;
      for (int m = 0; m < it.count; ++m) {
        if (!w.real(it, m)) continue;
        const float s = member_score<C>(w, it, m, tab);
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
      if (nan) continue;
      if (i1 >= 0) octet::topk_update<K, TIE_SAFE>(tv, tt, m1, part.tag_offset + w.tag(it, i1));
      if (i2 >= 0) octet::topk_update<K, TIE_SAFE>(tv, tt, m2, part.tag_offset + w.tag(it, i2));
    } else {
      for (int m = 0; m < it.count; ++m) {
        if (!w.real(it, m)) continue;
        octet::topk_update<K, TIE_SAFE>(tv, tt, member_score<C>(w, it, m, tab),
                                        part.tag_offset + w.tag(it, m));
      }
    }
  }

  const int64_t out0 = ((int64_t)blockIdx.y * gridDim.x + blockIdx.x) * K * kLanes + lane;
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
  int num_buckets, block_sublanes, table_rows, shift, fold_tile, num_cuda_blocks,
      num_partitions, part_rows, part_slices;
  float* out_v;
  int32_t* out_t;
  cudaStream_t stream;
};

template <class C, int K, bool TIE_SAFE>
cudaError_t launch(const Args& a) {
  auto kernel = slice_topk_kernel<C, K, TIE_SAFE>;
  const size_t smem = codec::table_smem_bytes<C, false>(a.table_rows);
  const cudaError_t err = codec::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.num_cuda_blocks, a.num_partitions);
  kernel<<<grid, kLanes, smem, a.stream>>>(
      a.words, static_cast<const typename C::Tab*>(a.table), a.nreal, a.plan, a.num_buckets,
      a.block_sublanes, a.table_rows, a.shift, a.fold_tile, a.part_rows, a.part_slices,
      a.out_v, a.out_t);
  return cudaSuccess;
}

template <class C, int K>
cudaError_t launch_k(bool tie_safe, const Args& a) {
  return tie_safe ? launch<C, K, true>(a) : launch<C, K, false>(a);
}

template <class C>
cudaError_t launch_c(int lane_k, bool tie_safe, const Args& a) {
  switch (lane_k) {
    case 4: return launch_k<C, 4>(tie_safe, a);
    case 8: return launch_k<C, 8>(tie_safe, a);
    case 16: return launch_k<C, 16>(tie_safe, a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// words: (num_partitions * part_rows, 128) int32, part_rows a whole
// number of blocks; table: (table_rows, 128), int32 (f32 for the f32
// codecs), codec one of codecs.cuh::Codec; nreal: (num_partitions,
// num_buckets) int32; plan:
// (num_buckets, 6) int32; fold_tile: 1, 2, 4 or 8; part_slices: slice
// tags per partition; out_v/out_t: (num_partitions, num_cuda_blocks,
// lane_k, 128). Returns cudaGetLastError() (or the error of a refused
// launch).
int slice_topk(const int32_t* words, const void* table, const int32_t* nreal,
               const int32_t* plan, int num_buckets, int block_sublanes,
               int table_rows, int codec, int lane_k, int fold_tile,
               int tie_safe, int num_cuda_blocks, int num_partitions,
               int part_rows, int part_slices, float* out_v, int32_t* out_t,
               void* stream) {
  if (num_buckets < 1 || num_cuda_blocks < 1 || table_rows < 1 || fold_tile < 1 ||
      num_partitions < 1 || num_partitions > 65535 || !codec::table_rows_ok(codec, table_rows))
    return cudaErrorInvalidValue;
  const Args a{words, table, nreal, plan, num_buckets, block_sublanes, table_rows,
               codec::sign_shift(codec), fold_tile, num_cuda_blocks, num_partitions,
               part_rows, part_slices, out_v, out_t, static_cast<cudaStream_t>(stream)};
  const cudaError_t err = codec::dispatch(codec, [&](auto tag) {
    return launch_c<typename decltype(tag)::type>(lane_k, tie_safe, a);
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
