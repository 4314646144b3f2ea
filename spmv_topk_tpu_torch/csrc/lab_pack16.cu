// 16-bit packed arithmetic lab (L9) for Hopper (sm_90a): does a 16-bit
// type run its multiply-add chains at twice the element rate of a 32-bit
// one?
//
// Replaces experiments/pack16_lab.py::make_kernel (:33), the pallas_call
// of pack16_lab.py::run (:46).
//
// What it computes. The lab's kernel reads one (sub, 128) tile x and
// writes acc after kReps = 512 rounds of acc = acc * x + x from acc = x,
// on each of GRID = 512 grid steps, every step writing the same output
// tile. Here each of `grid` CUDA blocks (512 in the lab) computes the
// whole tile and writes it: 128 threads, one a lane, each running its
// lane's chains over the tile's rows, so the element-op count is the
// lab's, 2 * 512 * 512 * sub * 128, and every block writes the same bits.
//   f32    one chain a row, each multiply and add rounded apart
//          (__fmul_rn / __fadd_rn: never contracted to an FMA, as the
//          TPU's VPU and the plain version round them);
//   bf16   rows 2p and 2p + 1 of a lane packed into one bf16x2 register,
//          one packed multiply and one packed add (mul.rn.bf16x2,
//          add.rn.bf16x2: PTX with an explicit rounding, which ptxas never
//          fuses) a round for two elements, each rounded to bf16 as the
//          plain version's bf16 tensors round every op;
//   int16  computed in uint32_t (wrapping; signed overflow is undefined in
//          C++) and truncated on the store: the low 16 bits of a product
//          or sum depend only on the operands' low 16 bits;
//   int32  uint32_t, stored as int32 (two's complement wrap).
// Rounds are fully unrolled (kReps a compile-time constant) so the SASS
// shows kReps multiply and add pairs a chain, which chip_smoke.py's `sass`
// phase counts: the chain reads x from memory and its result is stored, so
// nvcc cannot fold it away.
//
// Bound. Operations: 2 * 512 * 512 * sub * 128 element-ops against the
// card's non-tensor rate for the type (NVIDIA H100 SXM: 67 TFLOP/s f32 on
// the data sheet; 133.8 TFLOP/s bf16 and 33.5 TOP/s int32 in the Hopper
// architecture white paper; int16 runs on the int32 units). Those rates
// count a fused multiply-add as two operations; the lab's rounding keeps
// the float multiply and add apart, so f32 and bf16 can reach at most half
// of them. Bytes: a tile in, 512 tiles out (under 17 MB): far below.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kReps = 512;   // pack16_lab.py REPS

enum Dtype { kF32, kBF16, kI16, kI32, kNumDtypes };   // pack16_lab.py DTYPES

__device__ __forceinline__ uint32_t bf16x2_mul(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t bf16x2_add(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

template <int SUB>
__global__ void __launch_bounds__(kLanes) lab_pack16_f32(const float* __restrict__ x,
                                                         float* __restrict__ out) {
  const int lane = threadIdx.x;
  float xv[SUB], acc[SUB];
#pragma unroll
  for (int r = 0; r < SUB; ++r) acc[r] = xv[r] = x[r * kLanes + lane];
#pragma unroll
  for (int i = 0; i < kReps; ++i) {
#pragma unroll
    for (int r = 0; r < SUB; ++r) acc[r] = __fadd_rn(__fmul_rn(acc[r], xv[r]), xv[r]);
  }
#pragma unroll
  for (int r = 0; r < SUB; ++r) out[r * kLanes + lane] = acc[r];
}

template <int SUB>
__global__ void __launch_bounds__(kLanes) lab_pack16_bf16(const uint16_t* __restrict__ x,
                                                          uint16_t* __restrict__ out) {
  constexpr int P = SUB / 2;
  const int lane = threadIdx.x;
  uint32_t xv[P], acc[P];
#pragma unroll
  for (int p = 0; p < P; ++p)
    acc[p] = xv[p] = static_cast<uint32_t>(x[(2 * p) * kLanes + lane]) |
                     (static_cast<uint32_t>(x[(2 * p + 1) * kLanes + lane]) << 16);
#pragma unroll
  for (int i = 0; i < kReps; ++i) {
#pragma unroll
    for (int p = 0; p < P; ++p) acc[p] = bf16x2_add(bf16x2_mul(acc[p], xv[p]), xv[p]);
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    out[(2 * p) * kLanes + lane] = static_cast<uint16_t>(acc[p]);
    out[(2 * p + 1) * kLanes + lane] = static_cast<uint16_t>(acc[p] >> 16);
  }
}

template <class T, int SUB>
__global__ void __launch_bounds__(kLanes) lab_pack16_int(const T* __restrict__ x,
                                                         T* __restrict__ out) {
  const int lane = threadIdx.x;
  uint32_t xv[SUB], acc[SUB];
#pragma unroll
  for (int r = 0; r < SUB; ++r)
    acc[r] = xv[r] = static_cast<uint32_t>(static_cast<int32_t>(x[r * kLanes + lane]));
#pragma unroll
  for (int i = 0; i < kReps; ++i) {
#pragma unroll
    for (int r = 0; r < SUB; ++r) acc[r] = acc[r] * xv[r] + xv[r];
  }
#pragma unroll
  for (int r = 0; r < SUB; ++r) out[r * kLanes + lane] = static_cast<T>(acc[r]);
}

}  // namespace

extern "C" {

// x: (sub, 128) tile of `dtype` (the enum above; bf16 as its 16-bit
// pattern); out: (sub, 128) of the same type, written by each of `grid`
// CUDA blocks. The lab's cases: f32 sub 8 and 16, bf16 16 and 32, int16
// 16, int32 8. Returns cudaGetLastError() (or cudaErrorInvalidValue for a
// case the kernels are not built for).
int lab_pack16(const void* x, int dtype, int sub, int grid, void* out, void* stream) {
  if (grid < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 g(grid), b(kLanes);
  if (dtype == kF32 && sub == 8) {
    lab_pack16_f32<8><<<g, b, 0, s>>>(static_cast<const float*>(x), static_cast<float*>(out));
  } else if (dtype == kF32 && sub == 16) {
    lab_pack16_f32<16><<<g, b, 0, s>>>(static_cast<const float*>(x), static_cast<float*>(out));
  } else if (dtype == kBF16 && sub == 16) {
    lab_pack16_bf16<16><<<g, b, 0, s>>>(static_cast<const uint16_t*>(x),
                                        static_cast<uint16_t*>(out));
  } else if (dtype == kBF16 && sub == 32) {
    lab_pack16_bf16<32><<<g, b, 0, s>>>(static_cast<const uint16_t*>(x),
                                        static_cast<uint16_t*>(out));
  } else if (dtype == kI16 && sub == 16) {
    lab_pack16_int<int16_t, 16><<<g, b, 0, s>>>(static_cast<const int16_t*>(x),
                                                static_cast<int16_t*>(out));
  } else if (dtype == kI32 && sub == 8) {
    lab_pack16_int<int32_t, 8><<<g, b, 0, s>>>(static_cast<const int32_t*>(x),
                                               static_cast<int32_t*>(out));
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
