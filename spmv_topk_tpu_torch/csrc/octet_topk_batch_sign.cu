// Kernel K6 (octet_topk_batch.cuh) for the i8s and i4s codecs (Sign): a
// translation unit of its own, so that nvcc builds it in parallel with
// the others.

#include "octet_topk_batch.cuh"

namespace k6 {

cudaError_t launch_sign(const Args& a) {
  using namespace codec;
  return launch_codecs<codec_set<kI8s, kI4s>()>(a);
}

}  // namespace k6
