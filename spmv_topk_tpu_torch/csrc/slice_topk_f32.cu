// Kernel K7 (slice_topk.cuh) for the f32 codec, its table in shared or
// global memory.

#include "slice_topk.cuh"

namespace k7 {

cudaError_t run_f32(const Call& c) {
  using namespace codec;
  return run_codecs<codec_set<kF32, kF32Global>()>(c);
}

}  // namespace k7
