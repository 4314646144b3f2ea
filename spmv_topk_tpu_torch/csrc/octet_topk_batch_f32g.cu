// Kernel K6 (octet_topk_batch.cuh) for the f32 codec, its tables read from global memory: a
// translation unit of its own, so that nvcc builds it in parallel with
// the others.

#include "octet_topk_batch.cuh"

namespace k6 {

cudaError_t launch_f32g(const Args& a) {
  using namespace codec;
  return launch_codecs<codec_set<kF32Global>()>(a);
}

}  // namespace k6
