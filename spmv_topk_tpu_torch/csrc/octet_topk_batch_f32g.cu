// Kernel K6 (octet_topk_batch.cuh) for the f32 and int8x4 tables past
// shared memory, read from global memory (FloatPass of F32Global and of
// Int8x4Global, passes of 8): a translation unit of its own, so that nvcc
// builds it in parallel with the others.

#include "octet_topk_batch.cuh"

namespace k6 {

cudaError_t run_f32g(const Call& c) {
  if (c.pass_queries != 8) return cudaErrorInvalidValue;
  return run_k<codec::FloatPass<codec::F32Global, 8>>(c);
}

cudaError_t run_int8x4g(const Call& c) {
  if (c.pass_queries != 8) return cudaErrorInvalidValue;
  return run_k<codec::FloatPass<codec::Int8x4Global, 8>>(c);
}

}  // namespace k6
