// Kernel K6 (octet_topk_batch.cuh) for the f32 codec, its tables in shared
// memory (FloatPass, passes of 8 or 16): a translation unit of its own, so
// that nvcc builds it in parallel with the others.

#include "octet_topk_batch.cuh"

namespace k6 {

cudaError_t run_f32(const Call& c) {
  using codec::F32;
  using codec::FloatPass;
  switch (c.pass_queries) {
    case 8: return run_k<FloatPass<F32, 8>>(c);
    case 16: return run_k<FloatPass<F32, 16>>(c);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace k6
