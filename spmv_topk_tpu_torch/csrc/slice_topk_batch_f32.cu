// Kernel K8 (slice_topk_batch.cuh) for the f32 codec, its tables in shared
// or global memory.

#include "slice_topk_batch.cuh"

namespace k8 {

cudaError_t run_f32(const Call& c) {
  using namespace codec;
  return run_codecs<codec_set<kF32, kF32Global>()>(c);
}

}  // namespace k8
