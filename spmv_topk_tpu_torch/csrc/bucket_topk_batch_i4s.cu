// Kernel K12 (bucket_topk_batch.cuh) for the i4s codec: passes of 8 on
// Bf16Pass tables, a translation unit of its own, so that nvcc builds it
// in parallel with the others.

#include "bucket_topk_batch.cuh"

namespace k12 {

cudaError_t run_i4s(const Call& c) { return run_8<codec::Bf16Pass<codec::Sign, 8, 8>>(c); }

}  // namespace k12
