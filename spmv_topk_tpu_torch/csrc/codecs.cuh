// Query codecs of the Top-K / SpMV kernels, one set for both streams: the
// octet kernels K1, K6, K4 (octet_*.cu) and the slice kernels K7, K8, K9
// (slice_*.cu). Each replaces a decode of spmv_topk_tpu/ops/kernel.py:
// _codec_prod for the single-query kernels and _codec_split (a word's
// decode once, then one apply per query) for the batch ones.
//
// A codec turns one packed int32 word into its score contribution against
// a query table of `rows` rows of 128 entries:
//   h16     two nnz per word, each half col[0:10) | val6[10:16), against
//           the int4x8 table (1 row); int32 products, summed in int32
//           (exact in any order: kExact);
//   f32     col[16:32) | bf16 value[0:16) against the f32 table: lane
//           col & 127 of row col >> 7, or of row 0 past the table
//           (_gather_from_bcs);
//   int8x4  the same word against int32 rows of 4 biased bytes: lane
//           (w >> 16) & 127 of row w >> 25, or row 0 past the table;
//           byte (w >> 20) & 24, minus 128 (_gather_from_bcs_int8);
//   i8s/i4s the sign-layout word (ops/quantized_query.py::
//           encode_words_sign_layout): lane (w >> 16) & 127 of row 1 if
//           w < 0 (and the table has it), else of row 0; the entry shifted
//           left by (w >> 24) & 31, then arithmetically right by 24 (i8s)
//           or 28 (i4s) (_gather_from_bcs_sign). One codec, Sign, serves
//           both: the final shift is a run-time argument.
// The float codecs multiply the bf16 value by the decoded query entry and
// add, each rounded (__fmul_rn, __fadd_rn): no FMA contraction, as on the
// TPU, so a kernel and a plain version that add in the same order agree
// bit for bit. Lane indices are masked to 7 bits (the TPU gather wraps,
// CUDA would read out of bounds). Shifts that must not sign-extend run on
// uint32_t.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace codec {

constexpr int kLanes = 128;

// The kernels' codec argument: ops/kernel.py::KERNEL_CODECS lists the same
// names in the same order (a CPU test holds the two together).
enum Codec { kH16, kF32, kF32Global, kInt8x4, kI8s, kI4s, kNumCodecs };

// Sign's final arithmetic shift for the i8s and i4s codec arguments.
inline int sign_shift(int codec) { return codec == kI4s ? 28 : 24; }

// Whether a table of `rows` rows is one the codec can take (h16: one
// row; i8s and i4s: at most two, the sign bit selects).
inline bool table_rows_ok(int codec, int rows) {
  if (codec < 0 || codec >= kNumCodecs || rows < 1) return false;
  if (codec == kH16) return rows == 1;
  if (codec == kI8s || codec == kI4s) return rows <= 2;
  return true;
}

// What a gather needs beside the word: the query table (in shared memory,
// or global memory for the *Global codecs), its rows, and Sign's shift.
template <typename T>
struct Table {
  const T* p;
  int rows;
  int shift;
};

template <bool SHARED, typename T>
__device__ __forceinline__ T load(const T* p) {
  return SHARED ? *p : __ldg(p);
}

// h16 word: two halves, each col[0:10) | val6[10:16) (two's complement).
__device__ __forceinline__ int32_t prod_h16(int32_t w, const int32_t* tab) {
  const uint32_t u = static_cast<uint32_t>(w);
  const int32_t g0 = tab[u & 0x7Fu];
  const int32_t g1 = tab[(u >> 16) & 0x7Fu];
  const uint32_t sh0 = (~u >> 5) & 28u;    // 28 - 4 * (col0 >> 7)
  const uint32_t sh1 = (~u >> 21) & 28u;
  const int32_t n0 = static_cast<int32_t>(static_cast<uint32_t>(g0) << sh0) >> 28;
  const int32_t n1 = static_cast<int32_t>(static_cast<uint32_t>(g1) << sh1) >> 28;
  const int32_t v0 = static_cast<int32_t>(u << 16) >> 26;
  const int32_t v1 = w >> 26;
  return v0 * n0 + v1 * n1;
}

// Single-query codecs. Tab: the table's entry type; Acc: the sum's type;
// kShared: the sweeps stage the table in shared memory (else each gather
// reads global memory through the read-only path); kExact: int sums, exact
// in any order, converted to float by finish().
struct H16 {
  using Tab = int32_t;
  using Acc = int32_t;
  static constexpr bool kShared = true;
  static constexpr bool kExact = true;
  __device__ static __forceinline__ Acc add(Acc a, uint32_t u, const Table<Tab>& t) {
    return a + prod_h16(static_cast<int32_t>(u), t.p);
  }
  __device__ static __forceinline__ float finish(Acc a) { return static_cast<float>(a); }
};

// The float codecs: decode() is the query-independent part of a word
// (_codec_split's shared), apply() the product against one query's table;
// add() both and the rounded add.
template <class D>
struct FloatCodec {
  using Acc = float;
  static constexpr bool kExact = false;
  template <typename T>
  __device__ static __forceinline__ Acc add(Acc a, uint32_t u, const Table<T>& t) {
    return __fadd_rn(a, D::apply(D::decode(u, t), t.p));
  }
  __device__ static __forceinline__ float finish(Acc a) { return a; }
};

__device__ __forceinline__ float bf16_value(uint32_t u) { return __uint_as_float(u << 16); }

template <bool SHARED>
struct F32T : FloatCodec<F32T<SHARED>> {
  using Tab = float;
  static constexpr bool kShared = SHARED;
  struct Dec {
    uint32_t idx;
    float val;
  };
  __device__ static __forceinline__ Dec decode(uint32_t u, const Table<Tab>& t) {
    const uint32_t col = u >> 16;
    return {(col >> 7) < static_cast<uint32_t>(t.rows) ? col : (col & 0x7Fu), bf16_value(u)};
  }
  __device__ static __forceinline__ float apply(const Dec& d, const Tab* tab) {
    return __fmul_rn(d.val, load<SHARED>(tab + d.idx));
  }
};
using F32 = F32T<true>;
using F32Global = F32T<false>;

struct Int8x4 : FloatCodec<Int8x4> {
  using Tab = int32_t;
  static constexpr bool kShared = true;
  struct Dec {
    uint32_t idx, sh;
    float val;
  };
  __device__ static __forceinline__ Dec decode(uint32_t u, const Table<Tab>& t) {
    const uint32_t row = u >> 25;
    const uint32_t r = row < static_cast<uint32_t>(t.rows) ? row : 0u;
    return {r * kLanes + ((u >> 16) & 0x7Fu), (u >> 20) & 24u, bf16_value(u)};
  }
  __device__ static __forceinline__ float apply(const Dec& d, const Tab* tab) {
    const int32_t byte = static_cast<int32_t>((static_cast<uint32_t>(tab[d.idx]) >> d.sh) & 0xFFu);
    return __fmul_rn(d.val, static_cast<float>(byte - 128));
  }
};

struct Sign : FloatCodec<Sign> {
  using Tab = int32_t;
  static constexpr bool kShared = true;
  struct Dec {
    uint32_t idx, a;
    int shift;
    float val;
  };
  __device__ static __forceinline__ Dec decode(uint32_t u, const Table<Tab>& t) {
    const uint32_t r = (static_cast<int32_t>(u) < 0 && t.rows > 1) ? 1u : 0u;
    return {r * kLanes + ((u >> 16) & 0x7Fu), (u >> 24) & 31u, t.shift, bf16_value(u)};
  }
  __device__ static __forceinline__ float apply(const Dec& d, const Tab* tab) {
    const int32_t q = static_cast<int32_t>(static_cast<uint32_t>(tab[d.idx]) << d.a) >> d.shift;
    return __fmul_rn(d.val, static_cast<float>(q));
  }
};

// Where a single-query sweep keeps h16's table, one 512-byte row: the
// octet kernels (K1, K4) pass STATIC_H16 and keep it in a static shared
// array, the slice kernels (K7, K9) in the kernel's dynamic shared memory
// with the other codecs' tables; each is the faster on the H100. (In
// dynamic memory nvcc rebuilt the shared window's address, S2UR
// SR_CgaCtaId, inside K4's octet loop, and K4 took 2-3% longer; as a
// static array K9 spilled 20 bytes against 8 and took 1.5% longer.)
template <class C, bool STATIC_H16>
constexpr bool kStaticTable = STATIC_H16 && std::is_same_v<C, H16>;

// The query table a single-query sweep gathers from: copied into shared
// memory by the block's threads (C::kShared), else the global table.
template <class C, bool STATIC_H16>
__device__ __forceinline__ Table<typename C::Tab> stage_table(unsigned char* smem,
                                                             const typename C::Tab* table,
                                                             int rows, int shift, int lane) {
  if constexpr (kStaticTable<C, STATIC_H16>) {
    __shared__ typename C::Tab row[kLanes];
    row[lane] = table[lane];
    __syncthreads();
    return {row, 1, shift};
  } else if constexpr (!C::kShared) {
    return {table, rows, shift};
  } else {
    typename C::Tab* tab = reinterpret_cast<typename C::Tab*>(smem);
    for (int i = lane; i < rows * kLanes; i += kLanes) tab[i] = table[i];
    __syncthreads();
    return {tab, rows, shift};
  }
}

// stage_table for a block of THREADS threads, a multiple of 128 (K1, K7):
// h16's row in a static array, the other kShared codecs' table copied by
// every thread of the block.
template <class C, int THREADS>
__device__ __forceinline__ Table<typename C::Tab> stage_block(unsigned char* smem,
                                                             const typename C::Tab* table,
                                                             int rows, int shift) {
  if constexpr (kStaticTable<C, true>) {
    __shared__ typename C::Tab row[kLanes];
    if (threadIdx.x < kLanes) row[threadIdx.x] = table[threadIdx.x];
    __syncthreads();
    return {row, 1, shift};
  } else if constexpr (!C::kShared) {
    return {table, rows, shift};
  } else {
    typename C::Tab* tab = reinterpret_cast<typename C::Tab*>(smem);
    for (int i = threadIdx.x; i < rows * kLanes; i += THREADS) tab[i] = table[i];
    __syncthreads();
    return {tab, rows, shift};
  }
}

// The dynamic shared memory of stage_table (stage_block: STATIC_H16).
template <class C, bool STATIC_H16>
inline size_t table_smem_bytes(int rows) {
  return C::kShared && !kStaticTable<C, STATIC_H16> ? sizeof(typename C::Tab) * rows * kLanes : 0;
}

// ------------------------------------------------------------- multi-query
// The batch sweeps (K6 but for h16, K8, K12) hold a subgroup of at most 8
// queries (QG, the subgroup rounded up to a power of two) in one CUDA
// block. load() fills shared memory with the subgroup's tables and returns
// what add() gathers from; add() adds word u's product for every query to
// acc[QG]. smem_bytes() is the dynamic shared memory load() takes.

// h16 (K8, K12): the QG int4x8 tables (int32 (Q, 128), queries q0 .. q0 + nq - 1)
// repacked into tab[1024]: entry c (a 10-bit column) holds that column's
// signed nibble for every query, query dq at bits [4dq, 4dq+4), so one
// shared-memory gather per nnz serves the whole subgroup (_h16_shared,
// _h16_apply). Column c = n*128 + lane is nibble n of word `lane` of each
// table; a block's 128 threads (one per lane) fill it together.
constexpr int kH16Cols = 1024;   // h16 columns: 10-bit field

struct H16Batch {
  using Acc = int32_t;
  static constexpr bool kExact = true;

  static size_t smem_bytes(int, int) { return kH16Cols * sizeof(uint32_t); }

  template <int QG>
  __device__ static __forceinline__ Table<unsigned char> load(unsigned char* smem,
                                                              const void* tables, int q0, int nq,
                                                              int rows, int shift, int lane) {
    const int32_t* t = static_cast<const int32_t*>(tables);
    uint32_t qt[QG];
#pragma unroll
    for (int dq = 0; dq < QG; ++dq)
      qt[dq] = dq < nq ? static_cast<uint32_t>(__ldg(t + (q0 + dq) * kLanes + lane)) : 0u;
    uint32_t* tab = reinterpret_cast<uint32_t*>(smem);
#pragma unroll
    for (int n = 0; n < kH16Cols / kLanes; ++n) {
      uint32_t e = 0;
#pragma unroll
      for (int dq = 0; dq < QG; ++dq) e |= ((qt[dq] >> (4 * n)) & 0xFu) << (4 * dq);
      tab[n * kLanes + lane] = e;
    }
    return {reinterpret_cast<const unsigned char*>(tab), rows, shift};
  }

  // The decode of the word's two nnz (columns, 6-bit values) once, then
  // per query its nibble to the top and sign-extended down.
  template <int QG>
  __device__ static __forceinline__ void add(Acc (&acc)[QG], uint32_t u,
                                             const Table<unsigned char>& t, int) {
    const uint32_t* tab = reinterpret_cast<const uint32_t*>(t.p);
    const uint32_t g0 = tab[u & 0x3FFu];
    const uint32_t g1 = tab[(u >> 16) & 0x3FFu];
    const int32_t v0 = static_cast<int32_t>(u << 16) >> 26;
    const int32_t v1 = static_cast<int32_t>(u) >> 26;
#pragma unroll
    for (int dq = 0; dq < QG; ++dq) {
      const int32_t n0 = static_cast<int32_t>(g0 << (28 - 4 * dq)) >> 28;
      const int32_t n1 = static_cast<int32_t>(g1 << (28 - 4 * dq)) >> 28;
      acc[dq] += v0 * n0 + v1 * n1;
    }
  }

  __device__ static __forceinline__ float finish(Acc a) { return static_cast<float>(a); }
};

// h16 for K6's 32-query sweep (octet_topk_batch_h16.cu): one pass of up
// to 32 queries reads each word once. The pass's int4x8 tables (int32
// (Q, 128), queries q0 .. q0 + nq - 1) are repacked into 16 bytes per
// column, so that one 16-byte shared-memory gather serves every query of
// the pass: word r (of 4) of column c holds queries 8r .. 8r + 7, query
// 8r + j at bits [4j, 4j+4), each nibble biased by 8 (an unsigned 0..15:
// the two's complement nibble with its top bit flipped); queries past nq
// hold 0. The products are integer dot products (dp2a): the word's two
// 6-bit values, times 4, as a signed 16-bit pair (one PRMT that
// sign-extends the bytes holding them, one AND that clears the column
// bits), against a byte pair of one query at the word's two columns (one
// PRMT puts two queries' pairs side by side, an AND keeps the low or the
// high nibbles: the high ones come times 16). Per 8 queries and word: 2
// PRMT, 4 AND and 8 dp2a; per word besides: the load, the two gathers,
// the value pair and its sum vs (4 (v0 + v1)), which takes the bias back
// out at the end. Sums wrap modulo 2^32, so a sum is exact whenever the
// true one, times 64, fits int32: a row of fewer than 2^17 nnz
// (kH16x32MaxWidth words a member).
constexpr int kH16x32Queries = 32;
constexpr int kH16x32MaxWidth = 65535;

struct H16x32 {
  static constexpr size_t kTableBytes = kH16Cols * 16;

  __device__ static __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
    uint32_t d;
    asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
    return d;
  }
  // c + a.lo16 * b.byte0 + a.hi16 * b.byte1 (LO) or with b's bytes 2, 3
  // (HI): a signed 16-bit pair against unsigned bytes
  template <bool HI>
  __device__ static __forceinline__ int32_t dp2a(uint32_t a, uint32_t b, int32_t c) {
    int32_t d;
    if constexpr (HI)
      asm("dp2a.hi.s32.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
    else
      asm("dp2a.lo.s32.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
    return d;
  }

  // Fill tab (kTableBytes of shared memory) with the first 8 * NR queries
  // of the pass: thread t of `threads` (a multiple of 128) repacks words
  // r = t / 128, r + threads / 128, ... of lane t % 128's 8 columns.
  template <int NR>
  __device__ static __forceinline__ void load(uint32_t* tab, const int32_t* tables, int q0,
                                              int nq, int t, int threads) {
    const int lane = t % kLanes;
    for (int r = t / kLanes; r < NR; r += threads / kLanes) {
      uint32_t qt[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        qt[j] = 8 * r + j < nq
                    ? static_cast<uint32_t>(__ldg(tables + (int64_t)(q0 + 8 * r + j) * kLanes + lane))
                    : 0u;
#pragma unroll
      for (int n = 0; n < kH16Cols / kLanes; ++n) {
        uint32_t e = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) e |= (((qt[j] >> (4 * n)) & 0xFu) ^ 0x8u) << (4 * j);
        tab[(n * kLanes + lane) * 4 + r] = e;
      }
    }
  }

  // Add word u's products for queries 0 .. 8 * NR - 1 of the pass to acc
  // (query 8r + j at acc[8r + j]) and 4 (v0 + v1) to vs.
  template <int NR>
  __device__ static __forceinline__ void add(int32_t (&acc)[8 * NR], int32_t& vs, uint32_t u,
                                             const uint4* tab) {
    const uint32_t a = prmt(u, 0u, 0xB391u) & 0xFFFCFFFCu;   // (4 v0, 4 v1)
    vs = dp2a<false>(a, 0x0101u, vs);
    const uint4 g0 = tab[u & 0x3FFu];
    const uint4 g1 = tab[(u >> 16) & 0x3FFu];
    const uint32_t w0[4] = {g0.x, g0.y, g0.z, g0.w};
    const uint32_t w1[4] = {g1.x, g1.y, g1.z, g1.w};
#pragma unroll
    for (int r = 0; r < NR; ++r) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // bytes (w0.b, w1.b, w0.b', w1.b') of bytes b = 2h, b' = 2h + 1:
        // queries 8r + 4h + {0, 1} (low, high nibble of b) and + {2, 3} (b')
        const uint32_t p = prmt(w0[r], w1[r], h ? 0x7362u : 0x5140u);
        const uint32_t lo = p & 0x0F0F0F0Fu;
        const uint32_t hi = p & 0xF0F0F0F0u;
        int32_t* q = acc + 8 * r + 4 * h;
        q[0] = dp2a<false>(a, lo, q[0]);
        q[1] = dp2a<false>(a, hi, q[1]);
        q[2] = dp2a<true>(a, lo, q[2]);
        q[3] = dp2a<true>(a, hi, q[3]);
      }
    }
  }

  // The integer sum of query j of the 8 in a table word (acc of query
  // 8r + j): the bias out (8 (v0 + v1) per word, times 16 for the high
  // nibbles), modulo 2^32, then the factor 4 (times 16) of the packed
  // values.
  __device__ static __forceinline__ int32_t finish(int32_t acc, int32_t vs, int j) {
    const uint32_t a = static_cast<uint32_t>(acc), v = static_cast<uint32_t>(vs);
    return (j & 1) ? static_cast<int32_t>(a - 128u * v) >> 6
                   : static_cast<int32_t>(a - 8u * v) >> 2;
  }
};

// The float codecs: the subgroup's tables side by side in shared memory,
// QG x rows x 128 entries (the wrapper cuts the subgroup to the tables that
// fit, ops/kernel.py::tables_in_smem), or, for a codec that reads global
// memory, the caller's (Q, rows, 128) tables themselves. One decode per
// word, one gather and one rounded multiply-add per query.
template <class C>
struct Batch {
  using Tab = typename C::Tab;
  using Acc = float;
  static constexpr bool kExact = false;

  static size_t smem_bytes(int qg, int rows) {
    return C::kShared ? sizeof(Tab) * qg * rows * kLanes : 0;
  }

  template <int QG>
  __device__ static __forceinline__ Table<unsigned char> load(unsigned char* smem,
                                                              const void* tables, int q0, int nq,
                                                              int rows, int shift, int lane) {
    const int cols = rows * kLanes;
    const Tab* t = static_cast<const Tab*>(tables) + (int64_t)q0 * cols;
    if (!C::kShared) return {reinterpret_cast<const unsigned char*>(t), rows, shift};
    Tab* tab = reinterpret_cast<Tab*>(smem);
    for (int dq = 0; dq < QG; ++dq)
      for (int i = lane; i < cols; i += kLanes)
        tab[dq * cols + i] = dq < nq ? t[(int64_t)dq * cols + i] : Tab(0);
    return {smem, rows, shift};
  }

  template <int QG>
  __device__ static __forceinline__ void add(Acc (&acc)[QG], uint32_t u,
                                             const Table<unsigned char>& t, int nq) {
    const Tab* tab = reinterpret_cast<const Tab*>(t.p);
    const Table<Tab> one{tab, t.rows, t.shift};
    const typename C::Dec d = C::decode(u, one);
    const int64_t cols = (int64_t)t.rows * kLanes;
#pragma unroll
    for (int dq = 0; dq < QG; ++dq) {
      // global tables end at the last query: queries past the subgroup's
      // nq read query 0's table (their sums are never kept)
      const int64_t q = C::kShared || dq < nq ? dq : 0;
      acc[dq] = __fadd_rn(acc[dq], C::apply(d, tab + q * cols));
    }
  }

  __device__ static __forceinline__ float finish(Acc a) { return a; }
};

// The batch codec of a single-query codec.
template <class C>
struct BatchOf {
  using type = Batch<C>;
};
template <>
struct BatchOf<H16> {
  using type = H16Batch;
};

// Shared memory beyond the 48 KB default needs opting in per kernel.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// dispatch(codec, f) calls f(Tag<C>{}) with the single-query codec C of a
// codec argument (f32 in shared or global memory; i8s and i4s are Sign),
// or returns cudaErrorInvalidValue. The codecs of `only` (a bit per codec
// argument) are the ones this translation unit instantiates.
template <class C>
struct Tag {
  using type = C;
};

constexpr unsigned kAllCodecs = (1u << kNumCodecs) - 1;

template <unsigned only = kAllCodecs, class F>
inline cudaError_t dispatch(int codec, F&& f) {
  if (codec < 0 || codec >= kNumCodecs || !(only >> codec & 1u)) return cudaErrorInvalidValue;
  if constexpr (only >> kH16 & 1u)
    if (codec == kH16) return f(Tag<H16>{});
  if constexpr (only >> kF32 & 1u)
    if (codec == kF32) return f(Tag<F32>{});
  if constexpr (only >> kF32Global & 1u)
    if (codec == kF32Global) return f(Tag<F32Global>{});
  if constexpr (only >> kInt8x4 & 1u)
    if (codec == kInt8x4) return f(Tag<Int8x4>{});
  if constexpr ((only >> kI8s & 1u) || (only >> kI4s & 1u))
    if (codec == kI8s || codec == kI4s) return f(Tag<Sign>{});
  return cudaErrorInvalidValue;
}

template <int... codecs>
constexpr unsigned codec_set() {
  return ((1u << codecs) | ... | 0u);
}

}  // namespace codec
