// Batch lab (L1) for Hopper (sm_90a): the structure of the multi-query
// h16 decode under a per-query fast fold.
//
// Replaces experiments/batch_lab.py::_mk_kernel (:93) and its variants
// (:199-207), the pallas_call of batch_lab.py::run (:213).
//
// What it computes. Q queries against one h16 stream (lab_common.cuh's
// skeleton: lab block i of spb slices of `width` rows; slice tag
// i * spb + j). A slice's score for query q is the int32 sum of
// h16_apply(row q, h16_shared(w)) over its words, converted once; each
// query folds it into its buffer by the fast fold (every minimum slot
// replaced when score >= minimum). The fast fold's 8 slots start equal
// and stay equal, so a query's buffer is one (value, tag) pair: the
// kernel keeps Q pairs a lane, the wrapper returns the 8 slots. Variants:
//   cur       the full decode per query (the query-independent part
//             written Q times; whether nvcc shares it is the lab's
//             question, answered by the SASS: chip_smoke.py's `sass`)
//   shared    the query-independent part once a word
//   nofold    shared, and each slice's sum over the queries into query
//             0's pair as a running maximum (no fold)
//   sub2/4/8  queries in subgroups: the words loaded again for each
//             subgroup (volatile loads, so nvcc keeps every reload; they
//             hit L1) and the shared part recomputed
//   tilefold  shared, with each strided tile (slices gi + m * G, m < 8,
//             G = ceil(spb / 8)) giving its top 2 (lowest member among
//             ties) to the fast fold: a running top 2 per query while the
//             tile's slices are summed, as batch_lab.py:149-189's flush
//             reads its tile buffer
// CUDA blocks grid-stride over the lab blocks in increasing order, so a
// block's pair holds the last slice (in the lab's fold order) with its
// maximum; _common.merge_fast takes the maximum over the blocks and the
// largest tag holding it, the tag the TPU's sequential fold leaves.
//
// Where the buffers live. The TPU keeps Q x 8 values and tags in VMEM
// scratch; Q pairs here, in shared memory (one word per query and lane,
// lane-contiguous: no bank conflicts), with the Q query rows: 24 KiB a
// CUDA block at Q = 16 (tilefold 48 KiB: its running top 2 too), so 8
// blocks (4 for tilefold) of 128 threads fit an SM. Registers hold the Q
// int32 accumulators and a chunk's 8 words.
//
// Bound. Every word read once (1 GiB at 3.35 TB/s: 0.32 ms), but each
// word costs every query two shared-memory gathers and about 10 integer
// operations: at Q = 16 some 160 integer operations a word against the
// SM's 64 integer lanes a clock, about 2.5 clocks a word an SM, so the
// sweep is bound by integer operations near 2.6 ms at 1.98 GHz, 8x the
// bytes. The design keeps the decode out of memory (registers) and the
// gathers conflict-free; it does nothing about the operation count, which
// is the lab's subject.

#include "lab_common.cuh"

namespace {

using namespace lab;

enum Variant { kCur, kShared, kNofold, kSub2, kSub4, kSub8, kTilefold, kNumVariants };
enum Mode { kModeCur, kModeShared, kModeNofold, kModeSub, kModeTile };
constexpr int kTile = 8;

// A load nvcc must emit again (sub's reloads; the read-only path keeps
// the words in L1).
__device__ __forceinline__ uint32_t reload(const int32_t* p) {
  uint32_t v;
  asm volatile("ld.global.nc.b32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

// The fast fold of one score into a (value, tag) pair: its slots are all
// the minimum, all replaced when score >= minimum (never for NaN).
__device__ __forceinline__ void fold_pair(float* v, int32_t* t, float score, int32_t tag) {
  if (score >= *v) {
    *v = score;
    *t = tag;
  }
}

// One slice's Q int32 sums: shared part once a word (SHARE) or the whole
// decode per query.
template <int Q, bool SHARE>
__device__ __forceinline__ void slice_sums(const int32_t* src, int chunks, const uint32_t* tab,
                                           int32_t (&acc)[Q]) {
#pragma unroll
  for (int q = 0; q < Q; ++q) acc[q] = 0;
  for (int u = 0; u < chunks; ++u) {
    uint32_t w[kChunk];
#pragma unroll
    for (int r = 0; r < kChunk; ++r) w[r] = word(src + (int64_t)(u * kChunk + r) * kLanes);
#pragma unroll
    for (int r = 0; r < kChunk; ++r) {
      if (SHARE) {
        const H16Split s = h16_shared(w[r]);
#pragma unroll
        for (int q = 0; q < Q; ++q) acc[q] += h16_apply(tab + q * kLanes, s);
      } else {
#pragma unroll
        for (int q = 0; q < Q; ++q) acc[q] += h16_apply(tab + q * kLanes, h16_shared(w[r]));
      }
    }
  }
}

template <int Q, int MODE, int QG>
__global__ void __launch_bounds__(kLanes, kBlocksPerSm)
lab_batch_sweep(const int32_t* __restrict__ words, const uint32_t* __restrict__ tables, int nb,
                int width, int spb, float* __restrict__ out_v, int32_t* __restrict__ out_t) {
  extern __shared__ uint32_t smem[];
  const int lane = threadIdx.x;
  uint32_t* tab = smem;                                             // Q rows
  float* bv = reinterpret_cast<float*>(smem + Q * kLanes);          // pairs
  int32_t* bt = reinterpret_cast<int32_t*>(smem + 2 * Q * kLanes);
  float* m1 = reinterpret_cast<float*>(smem + 3 * Q * kLanes);      // tilefold
  float* m2 = reinterpret_cast<float*>(smem + 4 * Q * kLanes);
  int32_t* sl = reinterpret_cast<int32_t*>(smem + 5 * Q * kLanes);  // sl1 | sl2 << 8
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    tab[q * kLanes + lane] = __ldg(tables + q * kLanes + lane);
    bv[q * kLanes + lane] = -INFINITY;
    bt[q * kLanes + lane] = 0;
  }
  __syncthreads();

  const int chunks = width / kChunk;
  const int64_t slice_words = (int64_t)width * kLanes;
  for (int i = blockIdx.x; i < nb; i += gridDim.x) {
    const int32_t* blk = words + (int64_t)i * spb * slice_words + lane;
    if constexpr (MODE == kModeTile) {
      const int G = (spb + kTile - 1) / kTile;
      for (int gi = 0; gi < G; ++gi) {
        int cnt = 0;
        for (int m = 0; m < kTile; ++m) {
          const int j = gi + m * G;
          if (j >= spb) break;
          int32_t acc[Q];
          slice_sums<Q, true>(blk + j * slice_words, chunks, tab, acc);
#pragma unroll
          for (int q = 0; q < Q; ++q) {
            const int k = q * kLanes + lane;
            const float s = static_cast<float>(acc[q]);
            if (m == 0) {
              m1[k] = s;
              m2[k] = -INFINITY;
              sl[k] = 0;
            } else if (s > m1[k]) {
              m2[k] = m1[k];
              m1[k] = s;
              sl[k] = m | ((sl[k] & 0xFF) << 8);
            } else if (s > m2[k]) {
              m2[k] = s;
              sl[k] = (sl[k] & 0xFF) | (m << 8);
            }
          }
          ++cnt;
        }
        const int32_t t0 = i * spb + gi;
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          const int k = q * kLanes + lane;
          fold_pair(bv + k, bt + k, m1[k], t0 + (sl[k] & 0xFF) * G);
          if (cnt > 1) fold_pair(bv + k, bt + k, m2[k], t0 + (sl[k] >> 8) * G);
        }
      }
    } else {
    for (int j = 0; j < spb; ++j) {
      const int32_t* src = blk + j * slice_words;
      const int32_t tag = i * spb + j;
      if constexpr (MODE == kModeSub) {
#pragma unroll
        for (int q0 = 0; q0 < Q; q0 += QG) {
          int32_t acc[QG];
#pragma unroll
          for (int dq = 0; dq < QG; ++dq) acc[dq] = 0;
          for (int u = 0; u < chunks; ++u) {
#pragma unroll
            for (int r = 0; r < kChunk; ++r) {
              const H16Split s = h16_shared(reload(src + (int64_t)(u * kChunk + r) * kLanes));
#pragma unroll
              for (int dq = 0; dq < QG; ++dq)
                if (q0 + dq < Q) acc[dq] += h16_apply(tab + (q0 + dq) * kLanes, s);
            }
          }
#pragma unroll
          for (int dq = 0; dq < QG; ++dq) {
            if (q0 + dq >= Q) break;
            const int k = (q0 + dq) * kLanes + lane;
            fold_pair(bv + k, bt + k, static_cast<float>(acc[dq]), tag);
          }
        }
      } else {
        int32_t acc[Q];
        slice_sums<Q, MODE != kModeCur>(src, chunks, tab, acc);
        if constexpr (MODE == kModeNofold) {
          int32_t tot = 0;
#pragma unroll
          for (int q = 0; q < Q; ++q) tot += acc[q];
          const float s = static_cast<float>(tot);
          bv[lane] = s > bv[lane] ? s : bv[lane];
        } else {
#pragma unroll
          for (int q = 0; q < Q; ++q)
            fold_pair(bv + q * kLanes + lane, bt + q * kLanes + lane,
                      static_cast<float>(acc[q]), tag);
        }
      }
    }
    }
  }

  const int64_t o = (int64_t)blockIdx.x * Q * kLanes + lane;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    out_v[o + q * kLanes] = bv[q * kLanes + lane];
    out_t[o + q * kLanes] = bt[q * kLanes + lane];
  }
}

template <int Q, int MODE, int QG = 1>
cudaError_t launch(int nblk, cudaStream_t stream, const int32_t* words, const uint32_t* tables,
                   int nb, int width, int spb, float* out_v, int32_t* out_t) {
  auto kernel = lab_batch_sweep<Q, MODE, QG>;
  const size_t smem = (size_t)Q * kLanes * 4 * (MODE == kModeTile ? 6 : 3);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<nblk, kLanes, smem, stream>>>(words, tables, nb, width, spb, out_v, out_t);
  return cudaSuccess;
}

template <int Q>
cudaError_t dispatch(int variant, int nblk, cudaStream_t s, const int32_t* words,
                     const uint32_t* tables, int nb, int width, int spb, float* out_v,
                     int32_t* out_t) {
  switch (variant) {
    case kCur: return launch<Q, kModeCur>(nblk, s, words, tables, nb, width, spb, out_v, out_t);
    case kShared:
      return launch<Q, kModeShared>(nblk, s, words, tables, nb, width, spb, out_v, out_t);
    case kNofold:
      return launch<Q, kModeNofold>(nblk, s, words, tables, nb, width, spb, out_v, out_t);
    case kSub2: return launch<Q, kModeSub, 2>(nblk, s, words, tables, nb, width, spb, out_v, out_t);
    case kSub4: return launch<Q, kModeSub, 4>(nblk, s, words, tables, nb, width, spb, out_v, out_t);
    case kSub8: return launch<Q, kModeSub, 8>(nblk, s, words, tables, nb, width, spb, out_v, out_t);
    case kTilefold:
      return launch<Q, kModeTile>(nblk, s, words, tables, nb, width, spb, out_v, out_t);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// words: (nb * spb * width, 128) int32 h16 words; tables: (queries, 128)
// int32 int4x8 rows; variant: the enum above (spmv_topk_tpu_torch/
// experiments/batch_lab.py::VARIANTS); out_v/out_t: (nblk, queries, 1,
// 128), each CUDA block's (value, tag) pair of every query and lane.
// queries: 4 or 16. Returns cudaGetLastError() (or cudaErrorInvalidValue
// for arguments the kernel does not take).
int lab_batch(const int32_t* words, const uint32_t* tables, int nb, int width, int spb,
              int queries, int variant, int nblk, float* out_v, int32_t* out_t, void* stream) {
  if (nb < 1 || width < kChunk || spb < 1 || nblk < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (queries) {
    case 4: err = dispatch<4>(variant, nblk, s, words, tables, nb, width, spb, out_v, out_t); break;
    case 16:
      err = dispatch<16>(variant, nblk, s, words, tables, nb, width, spb, out_v, out_t);
      break;
    default: err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
