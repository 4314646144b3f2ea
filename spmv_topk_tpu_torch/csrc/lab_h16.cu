// h16 lab (L5) for Hopper (sm_90a): the decode variants of the
// two-nnz-per-word h16 codec under the fast fold.
//
// Replaces experiments/h16_lab.py::_mk_kernel (:152) and its bodies
// (:62-138), the pallas_call of h16_lab.py::run (:189).
//
// What it computes (lab_common.cuh has the skeleton). Each 16-bit half of
// a word is col[0:10) | val6[10:16) (v2: col0[0:10) | col1[10:20) |
// val0[20:26) | val1[26:32)); the query's int4x8 row holds nibble
// col >> 7 of lane col & 127. A slice's score is the sum of val * nibble
// over its words: in f32 per word (cur, nsh, stream) in the labs' order,
// or in int32 and converted once (int, nsh_int, nsh_int_raw, v2); folded
// per lane by the fast fold (every minimum slot). The TPU's lane gather
// reads the index's low 7 bits, so the raw indices of cur (i1), nsh_int_raw
// and v2 read what index & 127 reads here, and nsh_int_raw is nsh_int on
// this card (a shared-memory load needs the index masked either way).
//
// Bound. Each word read once, 4 bytes at 3.35 TB/s: device memory delivers
// about 3.2 words per SM per clock (132 SMs at 1.98 GHz). A word's decode
// is two shared-memory loads (16 words per SM per clock at 32 loads) and
// about 20 integer operations (two nnz), the heaviest decode of the labs:
// at 64 integer lanes per SM per clock that is also about 3.2 words per
// clock, so h16 sits at the edge of being bound by its integer operations
// as much as by bytes. Design as lab_kernel.cu.

#include "lab_common.cuh"

namespace {

using namespace lab;

enum Variant { kCur, kNsh, kInt, kNshInt, kNshIntRaw, kV2, kStream, kNumVariants };

// cur's decode (h16_lab.py:62-74): the nibble's sign by the xor trick
__device__ __forceinline__ int32_t cur_h16(uint32_t w, const Table& tab) {
  const int32_t n0 = static_cast<int32_t>(((tab.at(0, w) >> ((w >> 5) & 28u)) & 0xFu) ^ 8u) - 8;
  const int32_t n1 =
      static_cast<int32_t>(((tab.at(0, w >> 16) >> ((w >> 21) & 28u)) & 0xFu) ^ 8u) - 8;
  return (static_cast<int32_t>(w << 16) >> 26) * n0 + (static_cast<int32_t>(w) >> 26) * n1;
}

struct Cur {
  static constexpr bool kInt = false;
  __device__ __forceinline__ static float f(uint32_t w, const Table& tab, int) {
    return static_cast<float>(cur_h16(w, tab));
  }
};

struct Nsh {
  static constexpr bool kInt = false;
  __device__ __forceinline__ static float f(uint32_t w, const Table& tab, int) {
    return static_cast<float>(nsh_h16(w, tab));
  }
};

struct Int {
  static constexpr bool kInt = true;
  __device__ __forceinline__ static int32_t i(uint32_t w, const Table& tab, int) {
    return cur_h16(w, tab);
  }
};

struct NshInt {
  static constexpr bool kInt = true;
  __device__ __forceinline__ static int32_t i(uint32_t w, const Table& tab, int) {
    return nsh_h16(w, tab);
  }
};

// v2 (h16_lab.py:124-138): the shift to the top is 4 * g = (w >> 5) & 28
// directly against the reversed-nibble table
struct V2 {
  static constexpr bool kInt = true;
  __device__ __forceinline__ static int32_t i(uint32_t w, const Table& tab, int) {
    const int32_t n0 = static_cast<int32_t>(tab.at(0, w) << ((w >> 5) & 28u)) >> 28;
    const int32_t n1 = static_cast<int32_t>(tab.at(0, w >> 10) << ((w >> 15) & 28u)) >> 28;
    return (static_cast<int32_t>(w << 6) >> 26) * n0 + (static_cast<int32_t>(w) >> 26) * n1;
  }
};

// no decode (h16_lab.py:120-121): the word plus its lane's entry, as f32
struct Stream {
  static constexpr bool kInt = false;
  __device__ __forceinline__ static float f(uint32_t w, const Table& tab, int lane) {
    return static_cast<float>(static_cast<int32_t>(w + tab.at(0, lane)));
  }
};

template <class Body>
__global__ void __launch_bounds__(kLanes, kBlocksPerSm)
lab_h16_sweep(const int32_t* __restrict__ words, const uint32_t* __restrict__ table, int nb,
              int width, int spb, float* __restrict__ out_v, int32_t* __restrict__ out_t) {
  __shared__ uint32_t smem[kLanes];
  const int lane = threadIdx.x;
  const Table tab = stage_table(smem, table, 1, lane);
  Buffer buf;
  buf.init();
  const int chunks = width / kChunk;
  const int64_t slice_words = (int64_t)width * kLanes;
  for (int i = blockIdx.x; i < nb; i += gridDim.x) {
    const int32_t* blk = words + (int64_t)i * spb * slice_words + lane;
    for (int j = 0; j < spb; ++j)
      buf.fast(slice_score<Body>(blk + j * slice_words, chunks, tab, lane), i * spb + j);
  }
  buf.store(out_v, out_t, lane);
}

template <class Body>
cudaError_t launch(int nblk, cudaStream_t stream, const int32_t* words, const uint32_t* table,
                   int nb, int width, int spb, float* out_v, int32_t* out_t) {
  lab_h16_sweep<Body><<<nblk, kLanes, 0, stream>>>(words, table, nb, width, spb, out_v, out_t);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// words: (nb * spb * width, 128) int32; table: (1, 128) int32; variant:
// the enum above (spmv_topk_tpu_torch/experiments/h16_lab.py::VARIANTS);
// out_v/out_t: (nblk, 8, 128). Returns cudaGetLastError() (or
// cudaErrorInvalidValue for arguments the kernel does not take).
int lab_h16(const int32_t* words, const uint32_t* table, int nb, int width, int spb,
            int variant, int nblk, float* out_v, int32_t* out_t, void* stream) {
  if (nb < 1 || width < 1 || spb < 1 || nblk < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (variant) {
    case kCur: err = launch<Cur>(nblk, s, words, table, nb, width, spb, out_v, out_t); break;
    case kNsh: err = launch<Nsh>(nblk, s, words, table, nb, width, spb, out_v, out_t); break;
    case kInt: err = launch<Int>(nblk, s, words, table, nb, width, spb, out_v, out_t); break;
    case kNshInt:
    case kNshIntRaw:
      err = launch<NshInt>(nblk, s, words, table, nb, width, spb, out_v, out_t);
      break;
    case kV2: err = launch<V2>(nblk, s, words, table, nb, width, spb, out_v, out_t); break;
    case kStream: err = launch<Stream>(nblk, s, words, table, nb, width, spb, out_v, out_t); break;
    default: err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
