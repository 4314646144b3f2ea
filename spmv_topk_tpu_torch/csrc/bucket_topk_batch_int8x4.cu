// Kernel K12 (bucket_topk_batch.cuh) for the int8x4 codec: passes of 8
// on Bf16Pass tables, or past those the tables in global memory
// (int8x4_global, FloatPass), a translation unit of its own, so that nvcc
// builds it in parallel with the others.

#include "bucket_topk_batch.cuh"

namespace k12 {

cudaError_t run_int8x4(const Call& c) {
  using namespace codec;
  return c.codec == kInt8x4 ? run_8<Bf16Pass<Int8x4, 8, 4>>(c)
                            : run_8<FloatPass<Int8x4Global, 8>>(c);
}

}  // namespace k12
