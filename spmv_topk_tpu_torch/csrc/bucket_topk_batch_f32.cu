// Kernel K12 (bucket_topk_batch.cuh) for the f32 codec: its tables in
// shared memory (FloatPass) or past that in global memory (f32_global),
// passes of 8, a translation unit of its own, so that nvcc builds it in
// parallel with the others.

#include "bucket_topk_batch.cuh"

namespace k12 {

cudaError_t run_f32(const Call& c) {
  using namespace codec;
  return c.codec == kF32 ? run_8<FloatPass<F32, 8>>(c) : run_8<FloatPass<F32Global, 8>>(c);
}

}  // namespace k12
