// Pieces shared by the measurement-lab kernels for Hopper (sm_90a):
// lab_kernel.cu (L7, experiments/kernel_lab.py), lab_fused.cu (L4,
// fused_lab.py), lab_h16.cu (L5, h16_lab.py), lab_fold.cu (L3,
// fold_lab.py), lab_batch.cu (L1, batch_lab.py), lab_dma.cu (L2,
// dma_lab.py), lab_i16.cu (L6, i16_probe.py) and lab_mxu.cu (L8,
// mxu_gather_lab.py).
//
// The skeleton of the first four labs (lab_batch.cu keeps one buffer a
// query; the other three sum without a fold). One bucket of uniform width W in nb lab
// blocks of spb slices; slice j of lab block i sits on rows
// (i * spb + j) * W .. of the (rows, 128) int32 words, its tag
// t = i * spb + j. One CUDA block of 128 threads, one thread per lane:
// a thread walks its lane's W // 8 chunks of 8 rows of each slice (a warp
// reads 128 contiguous bytes per row), adds up the decoded words into a
// slice score and folds the score into its lane's buffer of kLaneK
// (value, tag) pairs in registers. The TPU labs carry one buffer over
// their sequential grid; here CUDA blocks grid-stride over the lab blocks
// (lab block i in CUDA block i % gridDim.x, in increasing order), each
// writes its buffers to out[blockIdx.x], and one per-lane torch.topk
// (spmv_topk_tpu_torch/experiments/_common.py::merge) merges them: every
// fold of the labs keeps values that do not depend on the slice order.
//
// Sums, in the JAX labs' order as XLA's CPU backend mostly runs it: f32
// sums add each row of a chunk into one of two accumulators by chunk
// parity, the two, then the 8 rows as a halving tree; int32 sums in any
// order (exact). The lab units are built with -ftz=true (the TPU flushes
// float denormals to zero; so do these kernels, and the plain versions
// explicitly) and -fmad=false (each multiply and add rounded apart, as the
// plain versions round them), ops/_build.py::SOURCE_FLAGS.
//
// The query table (at most 8 rows of 128 32-bit entries, 4 KB) sits in
// shared memory. The TPU gathers lane l of a row with a lane gather over
// its 128 lanes, which reads the index's low 7 bits, and the JAX labs
// pick among rows with chains of gathers and selects; here one
// shared-memory load reads the entry of the selected row at index & 127.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace lab {

constexpr int kLanes = 128;
constexpr int kChunk = 8;         // rows of an (8, 128) chunk
constexpr int kLaneK = 8;         // LANE_K of every lab
constexpr int kBlocksPerSm = 8;   // __launch_bounds__: <= 64 registers
constexpr int kMaxTableRows = 8;

__device__ __forceinline__ uint32_t word(const int32_t* p) {
  return static_cast<uint32_t>(__ldg(p));
}

// The bf16 value in bits [0:16) of a word as f32.
__device__ __forceinline__ float bf16(uint32_t w) { return __uint_as_float(w << 16); }

// The query table in shared memory: entry idx & 127 of row `row`.
struct Table {
  const uint32_t* t;
  __device__ __forceinline__ uint32_t at(int row, uint32_t idx) const {
    return t[row * kLanes + (idx & 127u)];
  }
  __device__ __forceinline__ float f(int row, uint32_t idx) const {
    return __uint_as_float(at(row, idx));
  }
};

__device__ __forceinline__ Table stage_table(uint32_t* smem, const uint32_t* table, int rows,
                                             int lane) {
  for (int r = 0; r < rows; ++r) smem[r * kLanes + lane] = __ldg(table + r * kLanes + lane);
  __syncthreads();
  return Table{smem};
}

// ((s0 + s4) + (s2 + s6)) + ((s1 + s5) + (s3 + s7))
__device__ __forceinline__ float halving(const float (&s)[kChunk]) {
  return ((s[0] + s[4]) + (s[2] + s[6])) + ((s[1] + s[5]) + (s[3] + s[7]));
}

// One slice's f32 score: Body::f(word, table, lane) of each of its
// chunks' words, row r of chunk u added into a[u % 2][r], then
// halving(a[0] + a[1]). src: the lane's word of the slice's row 0.
template <class Body>
__device__ __forceinline__ float float_score(const int32_t* src, int chunks, const Table& tab,
                                             int lane) {
  float a0[kChunk], a1[kChunk];
#pragma unroll
  for (int r = 0; r < kChunk; ++r) a0[r] = a1[r] = 0.0f;
  int u = 0;
  for (; u + 1 < chunks; u += 2) {
    uint32_t e[kChunk], o[kChunk];
#pragma unroll
    for (int r = 0; r < kChunk; ++r) {
      e[r] = word(src + (int64_t)(u * kChunk + r) * kLanes);
      o[r] = word(src + (int64_t)((u + 1) * kChunk + r) * kLanes);
    }
#pragma unroll
    for (int r = 0; r < kChunk; ++r) {
      a0[r] = a0[r] + Body::f(e[r], tab, lane);
      a1[r] = a1[r] + Body::f(o[r], tab, lane);
    }
  }
  if (u < chunks) {
#pragma unroll
    for (int r = 0; r < kChunk; ++r)
      a0[r] = a0[r] + Body::f(word(src + (int64_t)(u * kChunk + r) * kLanes), tab, lane);
  }
  float s[kChunk];
#pragma unroll
  for (int r = 0; r < kChunk; ++r) s[r] = a0[r] + a1[r];
  return halving(s);
}

// One slice's score from int32 sums: Body::i of each word of its chunks,
// added in int32 and converted once.
template <class Body>
__device__ __forceinline__ float int_score(const int32_t* src, int chunks, const Table& tab,
                                           int lane) {
  int32_t acc = 0;
#pragma unroll 2
  for (int u = 0; u < chunks; ++u) {
    uint32_t w[kChunk];
#pragma unroll
    for (int r = 0; r < kChunk; ++r) w[r] = word(src + (int64_t)(u * kChunk + r) * kLanes);
#pragma unroll
    for (int r = 0; r < kChunk; ++r) acc += Body::i(w[r], tab, lane);
  }
  return static_cast<float>(acc);
}

template <class Body>
__device__ __forceinline__ float slice_score(const int32_t* src, int chunks, const Table& tab,
                                             int lane) {
  if constexpr (Body::kInt)
    return int_score<Body>(src, chunks, tab, lane);
  else
    return float_score<Body>(src, chunks, tab, lane);
}

// A lane's buffer and the labs' folds (IEEE comparisons: a NaN score
// never enters, score >= minimum being false).
struct Buffer {
  float v[kLaneK];
  int32_t t[kLaneK];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int k = 0; k < kLaneK; ++k) {
      v[k] = -INFINITY;
      t[k] = 0;
    }
  }
  __device__ __forceinline__ float least() const {
    float m = v[0];
#pragma unroll
    for (int k = 1; k < kLaneK; ++k) m = v[k] < m ? v[k] : m;
    return m;
  }
  // exact (kernel_lab.py:50-54): the first slot holding the minimum
  __device__ __forceinline__ void exact(float score, int32_t tag) {
    const float m = least();
    if (!(score >= m)) return;
    bool done = false;
#pragma unroll
    for (int k = 0; k < kLaneK; ++k) {
      if (!done && v[k] == m) {
        v[k] = score;
        t[k] = tag;
        done = true;
      }
    }
  }
  // fast (kernel_lab.py:48-49, h16_lab.py:51-56): every slot holding it
  __device__ __forceinline__ void fast(float score, int32_t tag) {
    const float m = least();
    if (!(score >= m)) return;
#pragma unroll
    for (int k = 0; k < kLaneK; ++k) {
      if (v[k] == m) {
        v[k] = score;
        t[k] = tag;
      }
    }
  }
  __device__ __forceinline__ void store(float* out_v, int32_t* out_t, int lane) const {
    const int64_t o = (int64_t)blockIdx.x * kLaneK * kLanes + lane;
#pragma unroll
    for (int k = 0; k < kLaneK; ++k) {
      out_v[o + k * kLanes] = v[k];
      out_t[o + k * kLanes] = t[k];
    }
  }
};

// kernel_lab's int8 body (kernel_lab.py:78-88), which fused_lab imports:
// row 1 when w >> 25 == 1, byte (w >> 20) & 24 of the entry, minus 128,
// times the bf16 value.
struct Int8 {
  static constexpr bool kInt = false;
  __device__ __forceinline__ static float f(uint32_t w, const Table& tab, int) {
    const uint32_t sel = tab.at((w >> 25) == 1u, w >> 16);
    return bf16(w) * static_cast<float>(static_cast<int>((sel >> ((w >> 20) & 24u)) & 0xFFu) - 128);
  }
};

// The nsh h16 decode (h16_lab.py:77-91; fold_lab.py:45-57 is its raw-
// index form): two nnz per word, col[0:10) | val6[10:16) per half, the
// column's nibble moved to the top by the complemented shift and shifted
// down arithmetically, times the 6-bit value.
__device__ __forceinline__ int32_t nsh_h16(uint32_t w, const Table& tab) {
  const uint32_t nw = ~w;
  const uint32_t g0 = tab.at(0, w), g1 = tab.at(0, w >> 16);
  const int32_t n0 = static_cast<int32_t>(g0 << ((nw >> 5) & 28u)) >> 28;
  const int32_t n1 = static_cast<int32_t>(g1 << ((nw >> 21) & 28u)) >> 28;
  const int32_t v0 = static_cast<int32_t>(w << 16) >> 26;
  const int32_t v1 = static_cast<int32_t>(w) >> 26;
  return v0 * n0 + v1 * n1;
}

// The nsh h16 decode split as the batch kernels split it
// (spmv_topk_tpu/ops/kernel.py::_h16_shared / _h16_apply, batch_lab.py::
// shared_h16 / apply_h16): the query-independent part of a word once,
// then per query row two gathers, two shifts and the products.
struct H16Split {
  uint32_t i0, i1, sh0, sh1;
  int32_t v0, v1;
};

__device__ __forceinline__ H16Split h16_shared(uint32_t w) {
  const uint32_t nw = ~w;
  return {w & 127u, (w >> 16) & 127u, (nw >> 5) & 28u, (nw >> 21) & 28u,
          static_cast<int32_t>(w << 16) >> 26, static_cast<int32_t>(w) >> 26};
}

// row: a query's int4x8 row of 128 entries in shared memory
__device__ __forceinline__ int32_t h16_apply(const uint32_t* row, const H16Split& s) {
  const int32_t n0 = static_cast<int32_t>(row[s.i0] << s.sh0) >> 28;
  const int32_t n1 = static_cast<int32_t>(row[s.i1] << s.sh1) >> 28;
  return s.v0 * n0 + s.v1 * n1;
}

}  // namespace lab
