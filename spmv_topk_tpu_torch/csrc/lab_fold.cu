// Fold lab (L3) for Hopper (sm_90a): the per-slice Top-K fold variants on
// the production h16 chain.
//
// Replaces experiments/fold_lab.py::_mk_kernel (:68), the pallas_call of
// fold_lab.py::run (:129).
//
// What it computes (lab_common.cuh has the skeleton). Every slice's
// score, the nsh h16 decode summed in int32 and converted once
// (fold_lab.py:45-57; the raw gather index reads index & 127, as the
// TPU's lane gather does), then, with slices t >= limit not real:
//   base    score -inf at t >= limit, then the fast fold (every minimum
//           slot);
//   tguard  the fast fold only where t < limit;
//   vguard  tguard, skipped unless some lane votes score - worst >= 0
//           (worst: the lane's buffer minimum after its last fold);
//   nofold  no Top-K: slot 0 takes each real slice's score.
// vguard's vote spans the TPU kernel's 128 lanes (jnp.max over the (1,
// 128) difference); here each warp votes over its 32 lanes with
// __any_sync, with no block-wide barrier. A lane whose score is below its
// minimum folds nothing, so a vote over any set of lanes skips only folds
// that change nothing and leaves what tguard leaves (the scores are
// finite int32 sums, so no lane's difference is NaN). nofold's slot 0 is
// an order-dependent answer: a CUDA block takes its lab blocks in
// increasing order, so the block holding slice limit - 1 ends with its
// score, and the wrapper returns that block's buffer.
//
// Bound. As lab_h16.cu: each word read once, 4 bytes at 3.35 TB/s, and
// about 20 integer operations a word for the decode; the fold adds ~25
// operations a slice (8 minimum compares, 16 selects), 1.5 a word at
// W = 16.

#include "lab_common.cuh"

namespace {

using namespace lab;

enum Variant { kBase, kTguard, kVguard, kNofold, kNumVariants };

struct NshRaw {
  static constexpr bool kInt = true;
  __device__ __forceinline__ static int32_t i(uint32_t w, const Table& tab, int) {
    return nsh_h16(w, tab);
  }
};

template <int VARIANT>
__global__ void __launch_bounds__(kLanes, kBlocksPerSm)
lab_fold_sweep(const int32_t* __restrict__ words, const uint32_t* __restrict__ table, int nb,
               int width, int spb, int limit, float* __restrict__ out_v,
               int32_t* __restrict__ out_t) {
  __shared__ uint32_t smem[kLanes];
  const int lane = threadIdx.x;
  const Table tab = stage_table(smem, table, 1, lane);
  Buffer buf;
  buf.init();
  float worst = -INFINITY;
  const int chunks = width / kChunk;
  const int64_t slice_words = (int64_t)width * kLanes;
  for (int i = blockIdx.x; i < nb; i += gridDim.x) {
    const int32_t* blk = words + (int64_t)i * spb * slice_words + lane;
    for (int j = 0; j < spb; ++j) {
      const int32_t t = i * spb + j;
      const float s = int_score<NshRaw>(blk + j * slice_words, chunks, tab, lane);
      if constexpr (VARIANT == kBase) {
        buf.fast(t < limit ? s : -INFINITY, t);
      } else if constexpr (VARIANT == kTguard) {
        if (t < limit) buf.fast(s, t);
      } else if constexpr (VARIANT == kVguard) {
        if (t < limit && __any_sync(0xFFFFFFFFu, s - worst >= 0.0f)) {
          buf.fast(s, t);
          worst = buf.least();
        }
      } else {
        if (t < limit) buf.v[0] = s;
      }
    }
  }
  buf.store(out_v, out_t, lane);
}

template <int VARIANT>
cudaError_t launch(int nblk, cudaStream_t stream, const int32_t* words, const uint32_t* table,
                   int nb, int width, int spb, int limit, float* out_v, int32_t* out_t) {
  lab_fold_sweep<VARIANT><<<nblk, kLanes, 0, stream>>>(words, table, nb, width, spb, limit,
                                                       out_v, out_t);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// words: (nb * spb * width, 128) int32; table: (1, 128) int32; limit: the
// first slice that is not real; variant: the enum above
// (spmv_topk_tpu_torch/experiments/fold_lab.py::VARIANTS); out_v/out_t:
// (nblk, 8, 128). Returns cudaGetLastError() (or cudaErrorInvalidValue
// for arguments the kernel does not take).
int lab_fold(const int32_t* words, const uint32_t* table, int nb, int width, int spb, int limit,
             int variant, int nblk, float* out_v, int32_t* out_t, void* stream) {
  if (nb < 1 || width < 1 || spb < 1 || nblk < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (variant) {
    case kBase: err = launch<kBase>(nblk, s, words, table, nb, width, spb, limit, out_v, out_t); break;
    case kTguard:
      err = launch<kTguard>(nblk, s, words, table, nb, width, spb, limit, out_v, out_t);
      break;
    case kVguard:
      err = launch<kVguard>(nblk, s, words, table, nb, width, spb, limit, out_v, out_t);
      break;
    case kNofold:
      err = launch<kNofold>(nblk, s, words, table, nb, width, spb, limit, out_v, out_t);
      break;
    default: err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
