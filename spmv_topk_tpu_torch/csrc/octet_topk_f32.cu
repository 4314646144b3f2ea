// Kernel K1 (octet_topk.cuh) for the f32 codec, its table in shared or
// global memory.

#include "octet_topk.cuh"

namespace k1 {

cudaError_t run_f32(const Call& c) {
  using namespace codec;
  return run_codecs<codec_set<kF32, kF32Global>()>(c);
}

}  // namespace k1
