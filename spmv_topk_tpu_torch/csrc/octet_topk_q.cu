// Kernel K1 (octet_topk.cuh) for every codec but h16: f32 (its table in
// shared or global memory), int8x4, and i8s / i4s.

#include "octet_topk.cuh"

namespace k1 {

cudaError_t launch_quantized(const Args& a) {
  using namespace codec;
  return launch_codecs<codec_set<kF32, kF32Global, kInt8x4, kI8s, kI4s>()>(a);
}

}  // namespace k1
