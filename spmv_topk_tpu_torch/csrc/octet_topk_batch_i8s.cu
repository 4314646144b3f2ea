// Kernel K6 (octet_topk_batch.cuh) for the i8s codec (Sign, a signed byte a
// field): passes of 8 or 16 on Bf16Pass tables, a translation unit of its
// own, so that nvcc builds it in parallel with the others.

#include "octet_topk_batch.cuh"

namespace k6 {

cudaError_t run_i8s(const Call& c) {
  using codec::Bf16Pass;
  using codec::Sign;
  switch (c.pass_queries) {
    case 8: return run_k<Bf16Pass<Sign, 8, 4>>(c);
    case 16: return run_k<Bf16Pass<Sign, 16, 4>>(c);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace k6
