// Kernel K6 (octet_topk_batch.cuh) for the int8x4 codec: a
// translation unit of its own, so that nvcc builds it in parallel with
// the others.

#include "octet_topk_batch.cuh"

namespace k6 {

cudaError_t launch_int8x4(const Args& a) {
  using namespace codec;
  return launch_codecs<codec_set<kInt8x4>()>(a);
}

}  // namespace k6
