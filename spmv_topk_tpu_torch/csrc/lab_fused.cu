// Fused lab (L4) for Hopper (sm_90a): the production sweep's features
// added one at a time to kernel_lab's int8 kernel.
//
// Replaces experiments/fused_lab.py::_mk_kernel (:38), the pallas_call of
// fused_lab.py::run (:108). Its fourth variant, v_prod, is the port's own
// production sweep K7 (slice_topk.cu), launched by the lab's module.
//
// What it computes (lab_common.cuh has the skeleton): kernel_lab's int8
// body (lab_common.cuh::Int8) summed per slice and folded per lane by
// kernel_lab's exact or fast fold, with
//   v_bare    nothing more;
//   v_smem    a slice t >= nreal[0] scoring -inf (the TPU kernel's SMEM
//             input and per-slice mask; its slice base is 0);
//   v_branch  the lab blocks cut into three segments (nb / 3 blocks each,
//             the last taking the rest), a slice t of segment b scoring
//             -inf at t >= b * (nb / 3) * spb + nreal[b] (the TPU kernel's
//             three pl.when branches on block-index ranges, each with its
//             own slice base); a CUDA block picks the segment of each lab
//             block it takes from the block's index.
// The counts are read once per lab block (the TPU reads them from SMEM).
//
// Bound. As lab_kernel.cu: each word read once, 4 bytes at 3.35 TB/s; the
// mask and the segment choice add a compare and a select per slice and a
// few scalar operations per lab block.

#include "lab_common.cuh"

namespace {

using namespace lab;

enum Mode { kVBare, kVSmem, kVBranch, kNumModes };
enum Fold { kExact, kFast, kNumFolds };
constexpr int kSegments = 3;

template <int MODE, int FOLD>
__global__ void __launch_bounds__(kLanes, kBlocksPerSm)
lab_fused_sweep(const int32_t* __restrict__ words, const uint32_t* __restrict__ table,
                const int32_t* __restrict__ nreal, int nb, int width, int spb,
                float* __restrict__ out_v, int32_t* __restrict__ out_t) {
  __shared__ uint32_t smem[2 * kLanes];
  const int lane = threadIdx.x;
  const Table tab = stage_table(smem, table, 2, lane);
  Buffer buf;
  buf.init();
  const int chunks = width / kChunk;
  const int64_t slice_words = (int64_t)width * kLanes;
  const int per = nb / kSegments;
  for (int i = blockIdx.x; i < nb; i += gridDim.x) {
    int64_t limit = 0;
    if constexpr (MODE == kVSmem) limit = __ldg(nreal);
    if constexpr (MODE == kVBranch) {
      const int b = per ? min(i / per, kSegments - 1) : kSegments - 1;
      limit = (int64_t)b * per * spb + __ldg(nreal + b);
    }
    const int32_t* blk = words + (int64_t)i * spb * slice_words + lane;
    for (int j = 0; j < spb; ++j) {
      const int32_t t = i * spb + j;
      float s = float_score<Int8>(blk + j * slice_words, chunks, tab, lane);
      if (MODE != kVBare && !(t < limit)) s = -INFINITY;
      if constexpr (FOLD == kFast)
        buf.fast(s, t);
      else
        buf.exact(s, t);
    }
  }
  buf.store(out_v, out_t, lane);
}

template <int MODE>
cudaError_t launch(int fold, int nblk, cudaStream_t stream, const int32_t* words,
                   const uint32_t* table, const int32_t* nreal, int nb, int width, int spb,
                   float* out_v, int32_t* out_t) {
  switch (fold) {
    case kExact:
      lab_fused_sweep<MODE, kExact><<<nblk, kLanes, 0, stream>>>(words, table, nreal, nb, width,
                                                                spb, out_v, out_t);
      return cudaSuccess;
    case kFast:
      lab_fused_sweep<MODE, kFast><<<nblk, kLanes, 0, stream>>>(words, table, nreal, nb, width,
                                                               spb, out_v, out_t);
      return cudaSuccess;
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// words: (nb * spb * width, 128) int32; table: (2, 128) int32; nreal: 3
// int32 on the device; mode, fold: the enums above
// (spmv_topk_tpu_torch/experiments/fused_lab.py::MODES, FOLDS);
// out_v/out_t: (nblk, 8, 128). Returns cudaGetLastError() (or
// cudaErrorInvalidValue for arguments the kernel does not take).
int lab_fused(const int32_t* words, const uint32_t* table, const int32_t* nreal, int nb,
              int width, int spb, int mode, int fold, int nblk, float* out_v, int32_t* out_t,
              void* stream) {
  if (nb < 1 || width < 1 || spb < 1 || nblk < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (mode) {
    case kVBare:
      err = launch<kVBare>(fold, nblk, s, words, table, nreal, nb, width, spb, out_v, out_t);
      break;
    case kVSmem:
      err = launch<kVSmem>(fold, nblk, s, words, table, nreal, nb, width, spb, out_v, out_t);
      break;
    case kVBranch:
      err = launch<kVBranch>(fold, nblk, s, words, table, nreal, nb, width, spb, out_v, out_t);
      break;
    default: err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
