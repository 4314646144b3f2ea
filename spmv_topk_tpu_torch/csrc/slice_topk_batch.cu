// Multi-query slice-stream Top-K sweep (kernel K8; K10c with partitions)
// for Hopper (sm_90a), codecs h16 and f32.
//
// Replaces spmv_topk_tpu/ops/kernel.py::_fused_kernel_batch (the
// pallas_calls of topk_spmv_fused_batch_device and, with P row
// partitions, topk_spmv_fused_batch_part_device: the partition is the
// grid's y index, as in K7, and each query keeps a pool per partition,
// (Q, P, lane_k, 128) after the merge).
//
// What it computes. For each of Q queries, every real slice's 128 row
// scores (as K7 and K9 compute them), each folded into that query's
// per-lane (value, slice tag) buffers of lane_k entries by argmin
// replacement. The JAX batch kernel has no tiled fold: it folds every
// slice whatever fold_tile is, and so does this one (work items are runs
// of slices and wide slices). As in the JAX kernel the query-independent
// part of a word's decode (_codec_split: columns, values) is done once
// and applied per query.
//
// Design. Up to 8 queries (cfg.batch_subgroup) are live in one CUDA block
// of 128 threads, one per lane; their sums and buffer pairs sit in
// registers, sized for QG, the subgroup rounded up to a power of two.
// h16: the subgroup's int4x8 tables are repacked in shared memory as in
// K6 (octet_topk_batch.cu), entry c (a 10-bit column) holding that
// column's nibble for every query of the subgroup, so one gather per nnz
// serves all of them. f32: the subgroup's tables side by side, QG x
// table_rows x 512 bytes (32 KB for 8 queries at 1024 columns), one
// gather per query per nnz; the wrapper cuts the subgroup to the tables
// that fit a block's shared memory (ops/kernel.py::f32_tables_in_smem:
// 227 KB on the H100, so one table up to 58,112 columns), and past one
// table the subgroup's tables are gathered from global memory through
// the read-only path (F32Batch<false>: 256 KB a query at 65,536 columns,
// which L2 holds). The grid is (slots) x (subgroups), subgroup
// fastest, so the blocks that read the same work items for different
// subgroups are launch neighbours and can meet in L2; each block writes
// its buffers to out[q][slot] and one per-lane torch.topk per query merges
// the slots.
//
// Bound. Per word: one coalesced load, the shared decode, and per live
// query a gather and 2-4 arithmetic operations. With 32 queries the
// per-query work outweighs the bytes (the stream is read once per
// subgroup), so the sweep should be bound by the SMs' instruction
// throughput rather than by device memory.

#include "slice_common.cuh"

namespace {

using namespace slice;

// K6's repacked subgroup table (octet_common.cuh::repack_h16_tables).
// load() fills shared memory and returns what add() gathers from.
struct H16Batch {
  using Acc = int32_t;

  static size_t smem_bytes(int, int) { return octet::kH16Cols * sizeof(uint32_t); }

  template <int QG>
  __device__ static __forceinline__ const unsigned char* load(unsigned char* smem,
                                                              const void* tables, int q0,
                                                              int nq, int, int lane) {
    octet::repack_h16_tables<QG>(reinterpret_cast<uint32_t*>(smem),
                                 static_cast<const int32_t*>(tables), q0, nq, lane);
    return smem;
  }

  template <int QG>
  __device__ static __forceinline__ void add(Acc (&acc)[QG], uint32_t u,
                                             const unsigned char* tab, int, int) {
    int32_t p[QG];
    octet::prod_h16_batch<QG>(u, reinterpret_cast<const uint32_t*>(tab), p);
#pragma unroll
    for (int dq = 0; dq < QG; ++dq) acc[dq] += p[dq];
  }

  __device__ static __forceinline__ float finish(Acc a) { return static_cast<float>(a); }
};

// f32: the subgroup's tables side by side in shared memory (SHARED), or
// the caller's (Q, table_rows, 128) tables in global memory, read through
// the read-only path; the arithmetic is the same either way.
template <bool SHARED>
struct F32Batch {
  using Acc = float;

  static size_t smem_bytes(int qg, int table_rows) {
    return SHARED ? sizeof(float) * qg * table_rows * kLanes : 0;
  }

  template <int QG>
  __device__ static __forceinline__ const unsigned char* load(unsigned char* smem,
                                                              const void* tables, int q0,
                                                              int nq, int table_rows,
                                                              int lane) {
    const int cols = table_rows * kLanes;
    const float* t = static_cast<const float*>(tables) + (int64_t)q0 * cols;
    if (!SHARED) return reinterpret_cast<const unsigned char*>(t);
    float* tab = reinterpret_cast<float*>(smem);
    for (int dq = 0; dq < QG; ++dq)
      for (int i = lane; i < cols; i += kLanes)
        tab[dq * cols + i] = dq < nq ? t[(int64_t)dq * cols + i] : 0.0f;
    return smem;
  }

  template <int QG>
  __device__ static __forceinline__ void add(Acc (&acc)[QG], uint32_t u,
                                             const unsigned char* tab_bytes, int table_rows,
                                             int nq) {
    const float* tab = reinterpret_cast<const float*>(tab_bytes);
    // shared decode: table index (as F32::add) and bf16 value
    const uint32_t col = u >> 16;
    const uint32_t idx = (col >> 7) < static_cast<uint32_t>(table_rows) ? col : (col & 0x7Fu);
    const float v = __uint_as_float(u << 16);
    const int cols = table_rows * kLanes;
#pragma unroll
    for (int dq = 0; dq < QG; ++dq) {
      // global tables end at the last query: queries past the subgroup's
      // nq read query 0's table (their sums are never kept)
      const float q = SHARED ? tab[dq * cols + idx]
                             : __ldg(tab + (int64_t)(dq < nq ? dq : 0) * cols + idx);
      acc[dq] = __fadd_rn(acc[dq], __fmul_rn(v, q));
    }
  }

  __device__ static __forceinline__ float finish(Acc a) { return a; }
};

template <class C, int QG>
__device__ __forceinline__ void rows_sums(const int32_t* src, int rows, const unsigned char* tab,
                                          int table_rows, int nq, typename C::Acc (&acc)[QG]) {
#pragma unroll
  for (int dq = 0; dq < QG; ++dq) acc[dq] = 0;
#pragma unroll 2
  for (int r = 0; r < rows; ++r)
    C::template add<QG>(acc, static_cast<uint32_t>(__ldg(src + (int64_t)r * kLanes)), tab,
                        table_rows, nq);
}

// Member m's score for every live query (see member_score).
template <class C, int QG>
__device__ __forceinline__ void member_scores(const Walker& w, const Item& it, int m,
                                              const unsigned char* tab, int table_rows, int nq,
                                              float (&sc)[QG]) {
  const int32_t* src = w.rows_of(it, m);
  typename C::Acc acc[QG];
  if (w.k.mode != kWide) {
    rows_sums<C, QG>(src, w.k.width, tab, table_rows, nq, acc);
#pragma unroll
    for (int dq = 0; dq < QG; ++dq) sc[dq] = C::finish(acc[dq]);
    return;
  }
#pragma unroll
  for (int dq = 0; dq < QG; ++dq) sc[dq] = 0.0f;
  for (int blk = 0; blk < w.k.bps; ++blk) {
    const int rows = min(w.block_sublanes, w.k.width - blk * w.block_sublanes);
    rows_sums<C, QG>(src + (int64_t)blk * w.block_sublanes * kLanes, rows, tab, table_rows, nq,
                     acc);
#pragma unroll
    for (int dq = 0; dq < QG; ++dq) sc[dq] = __fadd_rn(sc[dq], C::finish(acc[dq]));
  }
}

template <class C, int K, int QG, bool TIE_SAFE>
__global__ void __launch_bounds__(kLanes)
slice_topk_batch_kernel(const int32_t* __restrict__ words, const void* __restrict__ tables,
                        const int32_t* __restrict__ nreal,
                        const int32_t* __restrict__ plan, int num_buckets,
                        int block_sublanes, int table_rows, int num_queries,
                        int subgroup, int num_subgroups, int part_rows, int part_slices,
                        float* __restrict__ out_v, int32_t* __restrict__ out_t) {
  static_assert(QG >= 1 && QG <= 8, "an h16 table entry holds 8 nibbles");
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x;
  const int sg = blockIdx.x % num_subgroups;
  const int slot = blockIdx.x / num_subgroups;
  const int num_slots = gridDim.x / num_subgroups;
  const int q0 = sg * subgroup;
  const int nq = min(subgroup, num_queries - q0);   // <= QG
  const unsigned char* tab = C::template load<QG>(smem, tables, q0, nq, table_rows, lane);
  __syncthreads();

  float tv[QG][K];
  int32_t tt[QG][K];
#pragma unroll
  for (int dq = 0; dq < QG; ++dq) octet::topk_init<K, TIE_SAFE>(tv[dq], tt[dq]);

  // fold_tile 1: runs of slices and wide slices, every slice folded
  const Partition part = partition(words, nreal, num_buckets, part_rows, part_slices);
  Walker w(part.words, plan, part.nreal, num_buckets, block_sublanes, 1, lane);
  Item it;
  for (int g = slot; w.locate(g, it); g += num_slots) {
    for (int m = 0; m < it.count; ++m) {
      if (!w.real(it, m)) continue;
      float sc[QG];
      member_scores<C, QG>(w, it, m, tab, table_rows, nq, sc);
      const int tag = part.tag_offset + w.tag(it, m);
#pragma unroll
      for (int dq = 0; dq < QG; ++dq) {
        if (dq >= nq) break;
        octet::topk_update<K, TIE_SAFE>(tv[dq], tt[dq], sc[dq], tag);
      }
    }
  }

#pragma unroll
  for (int dq = 0; dq < QG; ++dq) {
    if (dq >= nq) break;
    const int64_t out0 =
        (((int64_t)(q0 + dq) * gridDim.y + blockIdx.y) * num_slots + slot) * K * kLanes + lane;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      out_v[out0 + s * kLanes] = tv[dq][s];
      out_t[out0 + s * kLanes] = tt[dq][s];
    }
  }
}

struct Args {
  const int32_t* words;
  const void* tables;
  const int32_t* nreal;
  const int32_t* plan;
  int num_buckets, block_sublanes, table_rows, num_queries, subgroup, num_subgroups,
      num_cuda_blocks, num_partitions, part_rows, part_slices;
  float* out_v;
  int32_t* out_t;
  cudaStream_t stream;
};

template <class C, int K, int QG, bool TIE_SAFE>
cudaError_t launch(const Args& a) {
  auto kernel = slice_topk_batch_kernel<C, K, QG, TIE_SAFE>;
  const size_t smem = C::smem_bytes(QG, a.table_rows);
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.num_cuda_blocks, a.num_partitions);
  kernel<<<grid, kLanes, smem, a.stream>>>(
      a.words, a.tables, a.nreal, a.plan, a.num_buckets, a.block_sublanes, a.table_rows,
      a.num_queries, a.subgroup, a.num_subgroups, a.part_rows, a.part_slices, a.out_v,
      a.out_t);
  return cudaSuccess;
}

template <class C, int K, int QG>
cudaError_t launch_q(bool tie_safe, const Args& a) {
  return tie_safe ? launch<C, K, QG, true>(a) : launch<C, K, QG, false>(a);
}

template <class C, int K>
cudaError_t launch_k(bool tie_safe, const Args& a) {
  if (a.subgroup == 1) return launch_q<C, K, 1>(tie_safe, a);
  if (a.subgroup == 2) return launch_q<C, K, 2>(tie_safe, a);
  if (a.subgroup <= 4) return launch_q<C, K, 4>(tie_safe, a);
  return launch_q<C, K, 8>(tie_safe, a);
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
// number of blocks; tables: (Q, 1, 128) int32 (codec 0, h16) or (Q,
// table_rows, 128) f32 (codec 1, f32 in shared memory; codec 2, f32 read
// from global memory); nreal: (num_partitions, num_buckets) int32; plan:
// (num_buckets, 6) int32; subgroup: live queries per CUDA block, 1..8;
// num_cuda_blocks (per partition): a multiple of num_subgroups = ceil(Q /
// subgroup); part_slices: slice tags per partition; out_v/out_t: (Q,
// num_partitions, num_cuda_blocks / num_subgroups, lane_k, 128). Returns
// cudaGetLastError() (or the error of a refused launch).
int slice_topk_batch(const int32_t* words, const void* tables, const int32_t* nreal,
                     const int32_t* plan, int num_buckets, int block_sublanes,
                     int table_rows, int codec, int lane_k, int tie_safe,
                     int num_queries, int subgroup, int num_cuda_blocks,
                     int num_partitions, int part_rows, int part_slices,
                     float* out_v, int32_t* out_t, void* stream) {
  if (num_buckets < 1 || num_queries < 1 || subgroup < 1 || subgroup > 8 || table_rows < 1 ||
      num_partitions < 1 || num_partitions > 65535 || (codec == 0 && table_rows != 1))
    return cudaErrorInvalidValue;
  const int num_subgroups = (num_queries + subgroup - 1) / subgroup;
  if (num_cuda_blocks < num_subgroups || num_cuda_blocks % num_subgroups)
    return cudaErrorInvalidValue;
  const Args a{words, tables, nreal, plan, num_buckets, block_sublanes, table_rows,
               num_queries, subgroup, num_subgroups, num_cuda_blocks, num_partitions,
               part_rows, part_slices, out_v, out_t, static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  if (codec == 0) err = launch_c<H16Batch>(lane_k, tie_safe, a);
  else if (codec == 1) err = launch_c<F32Batch<true>>(lane_k, tie_safe, a);
  else if (codec == 2) err = launch_c<F32Batch<false>>(lane_k, tie_safe, a);
  else err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
