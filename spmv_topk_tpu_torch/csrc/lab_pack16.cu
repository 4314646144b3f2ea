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
// tile. Here the `copies` copies of the tile's chains (512 in the lab) are
// dealt to the warps of the launch and every copy writes its chains'
// results (the same bits), so the element-op count is the lab's, 2 * 512
// * copies * sub * 128, and no copy's work is dead code. Each element's
// chain rounds as the plain version does:
//   f32    each multiply and add rounded apart (__fmul_rn / __fadd_rn:
//          never contracted to an FMA, as the TPU's VPU and the plain
//          version round them);
//   bf16   rows 2p and 2p + 1 of a lane packed into one bf16x2 register,
//          a packed multiply and a packed add a round for two elements,
//          each rounded to bf16 as the plain version's bf16 tensors round
//          every op: PTX fma.rn.bf16x2, a * x + (-0.0) for the multiply
//          and p * 1.0 + x for the add (one rounding of the exact product
//          or sum; -0.0 keeps the sign of a zero product), which ptxas
//          never fuses into one op. It issues half of them as HFMA2.MMA,
//          the others as HMUL2 / HADD2, as it does mul.rn / add.rn; the
//          fma.rn pair ran 1% faster than mul.rn + add.rn on the H100
//          (experiments/lab_ablation.py ``forms``);
//   int16  one 32-bit multiply-add a round (mad.lo.u32 in inline PTX, so
//          NVVM cannot narrow the chain to 16-bit arithmetic, which made
//          ptxas repack the value with a PRMT after every round),
//          truncated on the store: the low 16 bits of a product or sum
//          depend only on the operands' low 16 bits;
//   int32  the same mad.lo.u32, stored as int32 (two's complement wrap).
//
// Design. The bound is the card's issue rate for the chain's instructions
// (below), so the kernel keeps every sub-partition issuing a chain
// instruction each clock:
//  - one wave: kWarps warps a block, one block an SM (the wrapper's grid
//    is the SM count), so each SM sub-partition holds 4 warps;
//  - an item is CH = C::kChains chains of one lane-warp of one copy: rows
//    (or bf16 row pairs) g * CH .. + CH of lanes 32 w .. 32 w + 31, item
//    = (copy * groups + g) * 4 + w with groups = rows / CH; the launch's
//    warps take equal shares of the items (warp v the items [v n / V, (v
//    + 1) n / V)), so the loads of two warps differ by one item at most.
//    A thread's CH independent chains and the 4 warps of its
//    sub-partition cover the latency of a multiply followed by a
//    dependent add: 8 chains for f32 and the integers, 4 bf16 pairs (on
//    the H100 4 pairs ran faster than 8, and 4 chains of the other types
//    slower than 8: lab_ablation.py ``variants``);
//  - the rounds run in a rolled loop of kReps / kUnroll trips of kUnroll
//    rounds (CH * kUnroll chain instructions and one branch a trip): the
//    body fits the instruction cache, where 512 unrolled rounds (8K-16K
//    instructions, 128-256 KiB of SASS, 70 s to build) streamed through
//    it;
//  - each copy writes a tile of its own (out is copies tiles): the 512
//    copies storing one tile's lines at the same moment held a launch
//    about 3 us longer (lab_ablation.py ``variants``, one_tile).
// A diagnostic launch (clocks non-null) records, per block, its SM and the
// SM clock cycles (clock64) and nanoseconds (%globaltimer) from the
// block's first instruction to its last, so the lab reports the clock the
// card held while the chains ran.
//
// Bound. Operations: 2 * 512 * copies * sub * 128 element-ops against the
// card's non-tensor rate for the type (NVIDIA H100 SXM: 67 TFLOP/s f32 on
// the data sheet; 133.8 TFLOP/s bf16 and 33.5 TOP/s int32 in the Hopper
// architecture white paper; int16 runs on the int32 units). Those rates
// count a fused multiply-add as two operations; the lab's rounding keeps
// the float multiply and add apart, so f32 and bf16 can reach at most half
// of them. Bytes: a tile in, copies tiles out (under 17 MB): far below.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kReps = 512;     // pack16_lab.py REPS
constexpr int kUnroll = 16;    // rounds a trip of the round loop
constexpr int kWarps = 16;     // warps a block, one block an SM
constexpr int kThreads = kWarps * 32;

enum Dtype { kF32, kBF16, kI16, kI32, kNumDtypes };   // pack16_lab.py DTYPES

constexpr uint32_t kNegZero2 = 0x80008000u;   // bf16x2 (-0.0, -0.0)
constexpr uint32_t kOne2 = 0x3F803F80u;       // bf16x2 (1.0, 1.0)

// A chain's value lives in a 32-bit register: f32 bits, a bf16x2 pair or
// an integer widened to 32 bits.
struct F32 {
  using In = float;
  static constexpr int kPack = 1;
  static constexpr int kChains = 8;   // chains a thread runs together
  static __device__ __forceinline__ uint32_t load(const In* x, int r, int lane) {
    return __float_as_uint(x[r * kLanes + lane]);
  }
  static __device__ __forceinline__ void store(In* out, int r, int lane, uint32_t v) {
    out[r * kLanes + lane] = __uint_as_float(v);
  }
  static __device__ __forceinline__ uint32_t round(uint32_t a, uint32_t x) {
    const float xf = __uint_as_float(x);
    return __float_as_uint(__fadd_rn(__fmul_rn(__uint_as_float(a), xf), xf));
  }
};

struct BF16 {
  using In = uint16_t;
  static constexpr int kPack = 2;
  static constexpr int kChains = 4;
  // chain p: rows 2p (low half) and 2p + 1 (high half)
  static __device__ __forceinline__ uint32_t load(const In* x, int p, int lane) {
    return static_cast<uint32_t>(x[(2 * p) * kLanes + lane]) |
           (static_cast<uint32_t>(x[(2 * p + 1) * kLanes + lane]) << 16);
  }
  static __device__ __forceinline__ void store(In* out, int p, int lane, uint32_t v) {
    out[(2 * p) * kLanes + lane] = static_cast<uint16_t>(v);
    out[(2 * p + 1) * kLanes + lane] = static_cast<uint16_t>(v >> 16);
  }
  static __device__ __forceinline__ uint32_t round(uint32_t a, uint32_t x) {
    uint32_t p, s;
    asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(p) : "r"(a), "r"(x), "r"(kNegZero2));
    asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(s) : "r"(p), "r"(kOne2), "r"(x));
    return s;
  }
};

template <class T>
struct Int {
  using In = T;
  static constexpr int kPack = 1;
  static constexpr int kChains = 8;
  static __device__ __forceinline__ uint32_t load(const In* x, int r, int lane) {
    return static_cast<uint32_t>(static_cast<int32_t>(x[r * kLanes + lane]));
  }
  static __device__ __forceinline__ void store(In* out, int r, int lane, uint32_t v) {
    out[r * kLanes + lane] = static_cast<T>(v);
  }
  static __device__ __forceinline__ uint32_t round(uint32_t a, uint32_t x) {
    uint32_t d;
    asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(x), "r"(x));
    return d;
  }
};

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// items: copies * groups * 4; out: copies tiles of sub rows; clocks: null,
// or (gridDim.x, 4) int64 of a diagnostic launch: SM id, clock64 cycles,
// %globaltimer ns at the block's first and at its last instruction
template <class C>
__global__ void __launch_bounds__(kThreads, 1)
lab_pack16_chains(const typename C::In* __restrict__ x, int sub, long long items,
                  typename C::In* __restrict__ out, long long* __restrict__ clocks) {
  constexpr int CH = C::kChains;
  long long c0 = 0, t0 = 0;
  if (clocks != nullptr && threadIdx.x == 0) {
    t0 = global_ns();
    c0 = clock64();
  }
  const int groups = sub / (C::kPack * CH);
  const long long warps = static_cast<long long>(gridDim.x) * kWarps;
  const long long warp = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  const long long end = items * (warp + 1) / warps;
  for (long long it = items * warp / warps; it < end; ++it) {
    const int lane = static_cast<int>(it & 3) * 32 + (threadIdx.x & 31);
    const long long copy = (it >> 2) / groups;
    const int r0 = static_cast<int>((it >> 2) - copy * groups) * CH;
    uint32_t xv[CH], acc[CH];
#pragma unroll
    for (int c = 0; c < CH; ++c) acc[c] = xv[c] = C::load(x, r0 + c, lane);
#pragma unroll 1
    for (int i = 0; i < kReps; i += kUnroll) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int c = 0; c < CH; ++c) acc[c] = C::round(acc[c], xv[c]);
      }
    }
    typename C::In* o = out + copy * sub * kLanes;
#pragma unroll
    for (int c = 0; c < CH; ++c) C::store(o, r0 + c, lane, acc[c]);
  }
  if (clocks != nullptr) {
    __syncthreads();
    if (threadIdx.x == 0) {
      const long long c1 = clock64();
      const long long t1 = global_ns();
      unsigned sm;
      asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
      long long* o = clocks + 4 * static_cast<long long>(blockIdx.x);
      o[0] = sm;
      o[1] = c1 - c0;
      o[2] = t0;
      o[3] = t1;
    }
  }
}

template <class C>
int launch(const void* x, int sub, int copies, int blocks, void* out, long long* clocks,
           cudaStream_t s) {
  const long long items = static_cast<long long>(copies) * (sub / (C::kPack * C::kChains)) * 4;
  lab_pack16_chains<C><<<blocks, kThreads, 0, s>>>(static_cast<const typename C::In*>(x), sub,
                                                   items, static_cast<typename C::In*>(out),
                                                   clocks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x: (sub, 128) tile of `dtype` (the enum above; bf16 as its 16-bit
// pattern); out: (copies, sub, 128) of the same type, tile c written by
// copy c of the chains (the lab's grid steps; every tile the same bits);
// blocks: the CUDA grid (the SM count: one wave); clocks: null or
// (blocks, 4) int64 (the diagnostic launch). The lab's cases: f32 sub 8
// and 16, bf16 16 and 32, int16 16, int32 8. Returns cudaGetLastError()
// (or cudaErrorInvalidValue for a case the kernels are not built for).
int lab_pack16(const void* x, int dtype, int sub, int copies, int blocks, void* out,
               long long* clocks, void* stream) {
  if (copies < 1 || blocks < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32 && (sub == 8 || sub == 16))
    return launch<F32>(x, sub, copies, blocks, out, clocks, s);
  if (dtype == kBF16 && (sub == 16 || sub == 32))
    return launch<BF16>(x, sub, copies, blocks, out, clocks, s);
  if (dtype == kI16 && sub == 16) return launch<Int<int16_t>>(x, sub, copies, blocks, out, clocks, s);
  if (dtype == kI32 && sub == 8) return launch<Int<int32_t>>(x, sub, copies, blocks, out, clocks, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
