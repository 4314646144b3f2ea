// Kernel K8 (slice_topk_batch.cuh) for int8x4 (its tables in shared or
// global memory), i8s and i4s.

#include "slice_topk_batch.cuh"

namespace k8 {

cudaError_t run_quantized(const Call& c) {
  using namespace codec;
  return run_codecs<codec_set<kInt8x4, kInt8x4Global, kI8s, kI4s>()>(c);
}

}  // namespace k8
