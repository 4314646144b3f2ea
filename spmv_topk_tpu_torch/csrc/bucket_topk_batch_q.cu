// Kernel K12 (bucket_topk_batch.cuh) for the int8x4, i8s and i4s codecs.

#include "bucket_topk_batch.cuh"

namespace k12 {

cudaError_t launch_quantized(const Args& a) {
  using namespace codec;
  return launch_codecs<codec_set<kInt8x4, kI8s, kI4s>()>(a);
}

}  // namespace k12
