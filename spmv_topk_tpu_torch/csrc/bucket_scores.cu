// Plain SpMV over one bucket (kernel K11) for Hopper (sm_90a), every query
// codec (codecs.cuh).
//
// Replaces spmv_topk_tpu/ops/kernel.py::_bucket_scores_kernel (the
// pallas_call of spmv_bucket_scores_device).
//
// What it computes. For each of the bucket's num_slices slices (padding
// slices included: their zero words score 0), its 128 row scores, summed
// as the JAX kernel sums them (bucket_common.cuh::slice_score), written
// to row s of a (num_slices, 128) f32 output in slice order.
//
// Design. K13's sweep (bucket_topk.cu): a CUDA block is kGroups groups of
// 128 threads, one thread a lane, one resident wave of blocks
// (ops/kernel.py::_bucket_scores_slots, the occupancy API's blocks an SM);
// group j of the num_slots groups takes slices j, j + num_slots, ..., its
// threads summing their lanes with slice_score (the chunks in the outer
// loop, 16 loads in flight) and storing one float each, a coalesced
// 512-byte row a slice. The query table sits in shared memory (h16's row
// in a static array; an f32 table past a block's shared memory, above
// 58,112 columns on the H100, is read from global memory through the
// read-only path, F32Global). Each bucket is a programmatic dependent
// launch: a block computes its first slice's scores while the stream's
// previous kernel finishes, then waits for it to complete
// (griddepcontrol.wait) before it stores anything.
//
// Bound. It reads every word of the bucket once and writes 4 bytes per
// slice row, with a gather and a few operations per word, so it should be
// bound by device memory bytes. One launch per bucket: a corpus of many
// small buckets pays a launch each.

#include "bucket_common.cuh"

namespace {

using namespace bucket;

constexpr int kGroups = 4;                  // groups of 128 threads a block
constexpr int kThreads = kGroups * kLanes;  // 512

template <class C>
__global__ void __launch_bounds__(kThreads, 1)
bucket_scores_kernel(const int32_t* __restrict__ words, const typename C::Tab* __restrict__ table,
                     int num_slices, int width, int table_rows, int shift, int num_slots,
                     float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x % kLanes;
  const int slot = blockIdx.x * kGroups + threadIdx.x / kLanes;
  const auto tab = codec::stage_block<C, kThreads>(smem, table, table_rows, shift);
  const int chunks = width / kChunk;
  auto score = [&](int s) {
    return slice_score<C>(words + (int64_t)s * width * kLanes + lane, chunks, tab);
  };
  const int first = slot < num_slots ? slot : num_slices;
  float v = first < num_slices ? score(first) : 0.0f;
  // The next launch on the stream may start now; this one stores its
  // scores only once the launch before it has completed.
  asm volatile("griddepcontrol.launch_dependents;");
  asm volatile("griddepcontrol.wait;" ::: "memory");
  for (int s = first; s < num_slices; s += num_slots) {
    out[(int64_t)s * kLanes + lane] = v;
    if (s + num_slots < num_slices) v = score(s + num_slots);
  }
}

template <class C>
size_t smem_bytes(int table_rows) {
  return codec::table_smem_bytes<C, true>(table_rows);
}

}  // namespace

extern "C" {

// Resident blocks an SM of the K11 kernel of `codec` with a table of
// table_rows rows (on the current device), or a negative cudaError_t.
int bucket_scores_occupancy(int codec, int table_rows) {
  if (!codec::table_rows_ok(codec, table_rows)) return -static_cast<int>(cudaErrorInvalidValue);
  int blocks = 0;
  const cudaError_t err = codec::dispatch(codec, [&](auto tag) {
    using C = typename decltype(tag)::type;
    auto kernel = bucket_scores_kernel<C>;
    const size_t smem = smem_bytes<C>(table_rows);
    const cudaError_t e = codec::allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, smem);
  });
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// words: (num_slices * width, 128) int32; table: (table_rows, 128), int32
// (f32 for the f32 codecs), codec one of codecs.cuh::Codec; num_slots: the
// 128-thread groups (ceil(num_slots / 4) CUDA blocks of 512 threads); out:
// (num_slices, 128) f32. The launch is a programmatic dependent one (see
// the kernel). Returns cudaGetLastError() (or the error of a refused
// launch).
int bucket_scores(const int32_t* words, const void* table, int num_slices, int width,
                  int table_rows, int codec, int num_slots, float* out, void* stream) {
  if (num_slices < 1 || width < 1 || num_slots < 1 || !codec::table_rows_ok(codec, table_rows))
    return cudaErrorInvalidValue;
  const cudaError_t err = codec::dispatch(codec, [&](auto tag) {
    using C = typename decltype(tag)::type;
    auto kernel = bucket_scores_kernel<C>;
    const size_t smem = smem_bytes<C>(table_rows);
    const cudaError_t e = codec::allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr.val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((num_slots + kGroups - 1) / kGroups);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = static_cast<cudaStream_t>(stream);
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, kernel, words, static_cast<const typename C::Tab*>(table),
                              num_slices, width, table_rows, codec::sign_shift(codec), num_slots,
                              out);
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
