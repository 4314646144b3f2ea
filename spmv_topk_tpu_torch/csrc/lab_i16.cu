// int16 probe (L6) for Hopper (sm_90a): whether 16-bit integer chains run
// at twice the density of 32-bit ones.
//
// Replaces experiments/i16_probe.py::_mk_kernel (:43), the pallas_call of
// i16_probe.py::build (:84).
//
// What it computes. The words are nb lab blocks of `sub` rows x 128 lanes,
// int32 in (8, 128) tiles or int16 in (16, 128) tiles (S rows). Row r of
// tile u adds into accumulator u % 2 of sublane r, in the words' type
// (int16 wraps at 16 bits), either
//   s32 / s16   (w >>> 3) & 127 (a logical shift of the 32- or 16-bit
//               word), or
//   g32 / g16   table[r][w & 127]: row r of the (S, 128) table, as the
//               lab's take_along_axis reads it; g16x widens the index to
//               int32 first (the same index: on this card a shared-memory
//               address is 32-bit either way, so it may compile to g16's
//               code: chip_smoke.py's `sass` compares them).
// The lab's result is salt + the sum over every tile (i16_probe.py:50-57);
// integer sums do not depend on their order, so each CUDA block writes the
// sum of its lab blocks (grid-stride) and the wrapper adds the partials and
// the salt, wrapping to the type: kernel, plain version and JAX are equal
// bit for bit on any data.
//
// No packed variant: each thread loads one 2- or 4-byte element a row
// (a warp 256 or 512 contiguous bytes) and adds in 32-bit registers, as
// written; whether nvcc packs int16 pairs is what the SASS shows.
//
// Bound. Every word read once (1 GiB at 3.35 TB/s: 0.32 ms, int16 or
// int32 alike); three integer operations an element (shift or gather, and,
// add): 2**28 int32 or 2**29 int16 elements against 64 integer lanes an SM
// a clock, 0.03-0.06 ms. Bytes bound it; a 2-byte load carries half the
// bytes of a 4-byte one, so the int16 sweeps need twice the loads for the
// same bytes.

#include "lab_common.cuh"

namespace {

using namespace lab;

enum Variant { kS32, kS16, kG32, kG16, kG16x, kNumVariants };

template <class T>
struct Bits;
template <>
struct Bits<int32_t> {
  using U = uint32_t;
  static constexpr int kRows = 8;
};
template <>
struct Bits<int16_t> {
  using U = uint16_t;
  static constexpr int kRows = 16;
};

template <class T, bool GATHER, bool WIDEN>
__device__ __forceinline__ T element(T w, const T* tab, int r) {
  using U = typename Bits<T>::U;
  if constexpr (GATHER) {
    const T idx = static_cast<T>(w & static_cast<T>(0x7F));
    if constexpr (WIDEN)
      return tab[r * kLanes + static_cast<int32_t>(idx)];
    else
      return tab[r * kLanes + idx];
  } else {
    return static_cast<T>(static_cast<U>(static_cast<U>(w) >> 3) & static_cast<U>(0x7F));
  }
}

template <class T, bool GATHER, bool WIDEN>
__global__ void __launch_bounds__(kLanes, kBlocksPerSm)
lab_i16_sweep(const T* __restrict__ words, const T* __restrict__ table, int nb, int sub,
              T* __restrict__ partials) {
  constexpr int S = Bits<T>::kRows;
  __shared__ T tab[S * kLanes];
  const int lane = threadIdx.x;
#pragma unroll
  for (int r = 0; r < S; ++r) tab[r * kLanes + lane] = table[r * kLanes + lane];
  __syncthreads();
  T a0[S], a1[S];
#pragma unroll
  for (int r = 0; r < S; ++r) a0[r] = a1[r] = 0;
  const int tiles = sub / S;
  for (int i = blockIdx.x; i < nb; i += gridDim.x) {
    const T* src = words + (int64_t)i * sub * kLanes + lane;
    int u = 0;
    for (; u + 1 < tiles; u += 2) {   // a tile's S loads in flight at a time
      T e[S];
#pragma unroll
      for (int r = 0; r < S; ++r) e[r] = src[(int64_t)(u * S + r) * kLanes];
#pragma unroll
      for (int r = 0; r < S; ++r)
        a0[r] = static_cast<T>(a0[r] + element<T, GATHER, WIDEN>(e[r], tab, r));
#pragma unroll
      for (int r = 0; r < S; ++r) e[r] = src[(int64_t)((u + 1) * S + r) * kLanes];
#pragma unroll
      for (int r = 0; r < S; ++r)
        a1[r] = static_cast<T>(a1[r] + element<T, GATHER, WIDEN>(e[r], tab, r));
    }
    if (u < tiles) {
#pragma unroll
      for (int r = 0; r < S; ++r)
        a0[r] = static_cast<T>(
            a0[r] + element<T, GATHER, WIDEN>(src[(int64_t)(u * S + r) * kLanes], tab, r));
    }
  }
  T* out = partials + (int64_t)blockIdx.x * S * kLanes + lane;
#pragma unroll
  for (int r = 0; r < S; ++r) out[r * kLanes] = static_cast<T>(a0[r] + a1[r]);
}

template <class T, bool GATHER, bool WIDEN = false>
cudaError_t launch(int nblk, cudaStream_t stream, const void* words, const void* table, int nb,
                   int sub, void* partials) {
  if (sub % Bits<T>::kRows) return cudaErrorInvalidValue;
  lab_i16_sweep<T, GATHER, WIDEN><<<nblk, kLanes, 0, stream>>>(
      static_cast<const T*>(words), static_cast<const T*>(table), nb, sub,
      static_cast<T*>(partials));
  return cudaSuccess;
}

}  // namespace

extern "C" {

// words: (nb * sub, 128) int32 (s32, g32) or int16 (s16, g16, g16x);
// table: (8, 128) int32 or (16, 128) int16; variant: the enum above
// (spmv_topk_tpu_torch/experiments/i16_probe.py::VARIANTS); partials:
// (nblk, 8, 128) int32 or (nblk, 16, 128) int16, each CUDA block's sum.
// Returns cudaGetLastError() (or cudaErrorInvalidValue for arguments the
// kernel does not take).
int lab_i16(const void* words, const void* table, int nb, int sub, int variant, int nblk,
            void* partials, void* stream) {
  if (nb < 1 || sub < 1 || nblk < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (variant) {
    case kS32: err = launch<int32_t, false>(nblk, s, words, table, nb, sub, partials); break;
    case kS16: err = launch<int16_t, false>(nblk, s, words, table, nb, sub, partials); break;
    case kG32: err = launch<int32_t, true>(nblk, s, words, table, nb, sub, partials); break;
    case kG16: err = launch<int16_t, true>(nblk, s, words, table, nb, sub, partials); break;
    case kG16x:
      err = launch<int16_t, true, true>(nblk, s, words, table, nb, sub, partials);
      break;
    default: err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
