// Kernel lab (L7) for Hopper (sm_90a): the inner loop of a Top-K sweep
// with each of the lab's 12 decode bodies under each of its 3 folds.
//
// Replaces experiments/kernel_lab.py::make_kernel (:219) and its bodies
// (:61-200), the pallas_call of kernel_lab.py::run (:282).
//
// What it computes (lab_common.cuh has the skeleton). Every slice's
// score, f32 sums of the body's value per word (the bodies' int32
// results, h16 and i8s_int, added as the floats their bits are:
// denormals, flushed to 0, or NaN), folded per lane by the lab's
// LAB_FOLD: exact (the first minimum slot), fast (every minimum slot) or
// top1g4 (the strict maximum of each group of 4 slices of a lab block,
// the first among ties, then exact). Each body computes what the TPU
// computes: a gather index is the field's low 7 bits (the JAX lab leaves
// w >> 16 unmasked), and i8s_nomask / i8s_int shift by w >> 24 unmasked,
// which the TPU wraps mod 32: here the wrap-mode funnel shift
// (__funnelshift_l(0, x, a), one SHF.L.W), while i8s keeps its & 31.
// Where the TPU body picks a table row by a chain of lane gathers and
// selects (f32: 8 gathers and 7 selects; int8, i8s, take2sel: 2 gathers
// and a select), here one shared-memory load reads the selected row's
// entry; so each variant costs what its decode costs on this card.
//
// Bound. Each word is read once: 4 bytes per word at 3.35 TB/s, 0.32 ms
// for the 1 GiB the lab times, about 3.2 words per SM per clock (132 SMs
// at 1.98 GHz). A word's decode is one or two shared-memory loads (h16
// two, stream none; 32 loads per SM per clock) and 5-20 integer or float
// operations (64 integer and 128 f32 lanes per SM per clock), so the
// bodies up to about 15 operations stay bound by bytes and h16's ~20
// integer operations reach the integer lanes' rate. Design: 128 threads
// per CUDA block, a warp reading 128 contiguous bytes per row, a thread's
// 16 loads of two chunks issued before their decode; blocks grid-stride
// over the lab blocks, 8 CUDA blocks per SM (at most 64 registers a
// thread).

#include "lab_common.cuh"

namespace {

using namespace lab;

enum Variant {
  kStream, kH16, kF32, kInt8, kI8s, kI8sNomask, kI8sInt, kInt8Sign, kInt8Fbits, kInt4, kTake1,
  kTake2sel, kNumVariants
};
enum Fold { kExact, kFast, kTop1g4, kNumFolds };
constexpr int kGroup = 4;

__device__ __forceinline__ int sign_row(uint32_t w) { return static_cast<int32_t>(w) < 0; }

__device__ __forceinline__ float byte_times(uint32_t w, uint32_t sel, uint32_t sh) {
  return bf16(w) * static_cast<float>(static_cast<int>((sel >> sh) & 0xFFu) - 128);
}

// bodies: f(word, table, lane) -> the word's f32 contribution
struct Stream {
  static constexpr bool kInt = false;
  __device__ __forceinline__ static float f(uint32_t w, const Table& tab, int lane) {
    return bf16(w) + tab.f(0, lane);
  }
};

struct H16 {
  static constexpr bool kInt = false;
  __device__ __forceinline__ static float f(uint32_t w, const Table& tab, int) {
    const int32_t n0 = static_cast<int32_t>((tab.at(0, w) >> ((w >> 5) & 28u)) & 0xFu) - 8;
    const int32_t n1 = static_cast<int32_t>((tab.at(0, w >> 16) >> ((w >> 21) & 28u)) & 0xFu) - 8;
    const int32_t v0 = static_cast<int32_t>(w << 16) >> 26;
    const int32_t v1 = static_cast<int32_t>(w) >> 26;
    return __int_as_float(v0 * n0 + v1 * n1);
  }
};

struct F32 {
  static constexpr bool kInt = false;
  __device__ __forceinline__ static float f(uint32_t w, const Table& tab, int) {
    const uint32_t hi = w >> 23;
    return bf16(w) * tab.f(hi < 8u ? static_cast<int>(hi) : 0, w >> 16);
  }
};

struct I8s {
  static constexpr bool kInt = false;
  __device__ __forceinline__ static float f(uint32_t w, const Table& tab, int) {
    const int32_t q = static_cast<int32_t>(tab.at(sign_row(w), w >> 16) << ((w >> 24) & 31u)) >> 24;
    return bf16(w) * static_cast<float>(q);
  }
};

// the sign-select entry's signed byte, shifted by w >> 24 mod 32
__device__ __forceinline__ int32_t q_wrap(uint32_t w, const Table& tab) {
  return static_cast<int32_t>(__funnelshift_l(0u, tab.at(sign_row(w), w >> 16), w >> 24)) >> 24;
}

struct I8sNomask {
  static constexpr bool kInt = false;
  __device__ __forceinline__ static float f(uint32_t w, const Table& tab, int) {
    return bf16(w) * static_cast<float>(q_wrap(w, tab));
  }
};

struct I8sInt {
  static constexpr bool kInt = false;
  __device__ __forceinline__ static float f(uint32_t w, const Table& tab, int) {
    return __int_as_float(static_cast<int32_t>(w & 0xFFFFu) * q_wrap(w, tab));
  }
};

struct Int8Sign {
  static constexpr bool kInt = false;
  __device__ __forceinline__ static float f(uint32_t w, const Table& tab, int) {
    return byte_times(w, tab.at(sign_row(w), w >> 16), (w >> 24) & 24u);
  }
};

struct Int8Fbits {
  static constexpr bool kInt = false;
  __device__ __forceinline__ static float f(uint32_t w, const Table& tab, int) {
    const uint32_t byte = (tab.at(sign_row(w), w >> 16) >> ((w >> 24) & 24u)) & 0xFFu;
    return bf16(w) * (__uint_as_float(byte | 0x4B000000u) - (8388608.0f + 128.0f));
  }
};

struct Int4 {
  static constexpr bool kInt = false;
  __device__ __forceinline__ static float f(uint32_t w, const Table& tab, int) {
    const uint32_t nib = (tab.at(0, w >> 16) >> ((w >> 21) & 28u)) & 0xFu;
    return bf16(w) * static_cast<float>(static_cast<int>(nib) - 8);
  }
};

struct Take1 {
  static constexpr bool kInt = false;
  __device__ __forceinline__ static float f(uint32_t w, const Table& tab, int) {
    return bf16(w) * tab.f(0, w >> 16);
  }
};

struct Take2sel {
  static constexpr bool kInt = false;
  __device__ __forceinline__ static float f(uint32_t w, const Table& tab, int) {
    return bf16(w) * tab.f(sign_row(w), w >> 16);
  }
};

template <class Body, int FOLD>
__global__ void __launch_bounds__(kLanes, kBlocksPerSm)
lab_sweep(const int32_t* __restrict__ words, const uint32_t* __restrict__ table, int table_rows,
          int nb, int width, int spb, float* __restrict__ out_v, int32_t* __restrict__ out_t) {
  __shared__ uint32_t smem[kMaxTableRows * kLanes];
  const int lane = threadIdx.x;
  const Table tab = stage_table(smem, table, table_rows, lane);
  Buffer buf;
  buf.init();
  const int chunks = width / kChunk;
  const int64_t slice_words = (int64_t)width * kLanes;
  for (int i = blockIdx.x; i < nb; i += gridDim.x) {
    const int32_t* blk = words + (int64_t)i * spb * slice_words + lane;
    if constexpr (FOLD == kTop1g4) {
      for (int g = 0; g < spb; g += kGroup) {
        float gmax = 0.0f;
        int32_t gidx = 0;
        for (int jj = 0; jj < kGroup; ++jj) {
          const int j = g + jj;
          const float s = slice_score<Body>(blk + j * slice_words, chunks, tab, lane);
          if (jj == 0 || s > gmax) {
            gmax = s;
            gidx = i * spb + j;
          }
        }
        buf.exact(gmax, gidx);
      }
    } else {
      for (int j = 0; j < spb; ++j) {
        const float s = slice_score<Body>(blk + j * slice_words, chunks, tab, lane);
        if constexpr (FOLD == kFast)
          buf.fast(s, i * spb + j);
        else
          buf.exact(s, i * spb + j);
      }
    }
  }
  buf.store(out_v, out_t, lane);
}

struct Args {
  const int32_t* words;
  const uint32_t* table;
  int table_rows, nb, width, spb, nblk;
  float* out_v;
  int32_t* out_t;
  cudaStream_t stream;
};

template <class Body, int FOLD>
cudaError_t launch(const Args& a) {
  lab_sweep<Body, FOLD><<<a.nblk, kLanes, 0, a.stream>>>(a.words, a.table, a.table_rows, a.nb,
                                                          a.width, a.spb, a.out_v, a.out_t);
  return cudaSuccess;
}

template <class Body>
cudaError_t launch_fold(int fold, const Args& a) {
  switch (fold) {
    case kExact: return launch<Body, kExact>(a);
    case kFast: return launch<Body, kFast>(a);
    case kTop1g4: return launch<Body, kTop1g4>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// words: (nb * spb * width, 128) int32; table: (table_rows, 128) 32-bit
// entries (f32 or int32 by variant); variant, fold: the enums above
// (spmv_topk_tpu_torch/experiments/kernel_lab.py::VARIANTS, FOLDS);
// out_v/out_t: (nblk, 8, 128). Returns cudaGetLastError() (or
// cudaErrorInvalidValue for arguments the kernel does not take).
int lab_kernel(const int32_t* words, const uint32_t* table, int table_rows, int nb, int width,
               int spb, int variant, int fold, int nblk, float* out_v, int32_t* out_t,
               void* stream) {
  if (nb < 1 || width < 1 || spb < 1 || nblk < 1 || table_rows < 1 ||
      table_rows > kMaxTableRows || (fold == kTop1g4 && spb % kGroup))
    return cudaErrorInvalidValue;
  const Args a{words, table, table_rows, nb, width, spb, nblk, out_v, out_t,
               static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  switch (variant) {
    case kStream: err = launch_fold<Stream>(fold, a); break;
    case kH16: err = launch_fold<H16>(fold, a); break;
    case kF32: err = launch_fold<F32>(fold, a); break;
    case kInt8: err = launch_fold<Int8>(fold, a); break;
    case kI8s: err = launch_fold<I8s>(fold, a); break;
    case kI8sNomask: err = launch_fold<I8sNomask>(fold, a); break;
    case kI8sInt: err = launch_fold<I8sInt>(fold, a); break;
    case kInt8Sign: err = launch_fold<Int8Sign>(fold, a); break;
    case kInt8Fbits: err = launch_fold<Int8Fbits>(fold, a); break;
    case kInt4: err = launch_fold<Int4>(fold, a); break;
    case kTake1: err = launch_fold<Take1>(fold, a); break;
    case kTake2sel: err = launch_fold<Take2sel>(fold, a); break;
    default: err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
