// Kernel K6 (octet_topk_batch.cuh) for the i4s codec (Sign, a signed nibble a
// field): passes of 8 or 16 on Bf16Pass tables, a translation unit of its
// own, so that nvcc builds it in parallel with the others.

#include "octet_topk_batch.cuh"

namespace k6 {

cudaError_t run_i4s(const Call& c) {
  using codec::Bf16Pass;
  using codec::Sign;
  switch (c.pass_queries) {
    case 8: return run_k<Bf16Pass<Sign, 8, 8>>(c);
    case 16: return run_k<Bf16Pass<Sign, 16, 8>>(c);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace k6
