// Kernel K6 (octet_topk_batch.cuh) for the int8x4 codec: passes of 8 or
// 16 on Bf16Pass tables (a table too large for those is read from global
// memory, octet_topk_batch_f32g.cu), a translation unit of its own, so
// that nvcc builds it in parallel with the others.

#include "octet_topk_batch.cuh"

namespace k6 {

cudaError_t run_int8x4(const Call& c) {
  using codec::Bf16Pass;
  using codec::Int8x4;
  switch (c.pass_queries) {
    case 8: return run_k<Bf16Pass<Int8x4, 8, 4>>(c);
    case 16: return run_k<Bf16Pass<Int8x4, 16, 4>>(c);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace k6
