// Kernel K7 (slice_topk.cuh) for int8x4, i8s and i4s.

#include "slice_topk.cuh"

namespace k7 {

cudaError_t run_quantized(const Call& c) {
  using namespace codec;
  return run_codecs<codec_set<kInt8x4, kI8s, kI4s>()>(c);
}

}  // namespace k7
