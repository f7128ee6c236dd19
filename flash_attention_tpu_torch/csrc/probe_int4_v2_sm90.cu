// P1 v2 (scripts/probe_int4_variants.py, the int-domain unpack) on the
// split-K decode body of matmul_sm90.cuh: bf16 x, offset-binary int4
// weights widened as (u - 8) s. Compiled apart so the build runs it in
// parallel with the other sources.

#include "matmul_sm90.cuh"

namespace fa_mm {
namespace hopper {

cudaError_t probe_int4_v2(const void* x, const void* w, const void* scale,
                          const Args& a, int splits, cudaStream_t s) {
  return launch<__nv_bfloat16, kInt4Ob, 64, false>(x, w, scale, a, splits,
                                                   s);
}

}  // namespace hopper
}  // namespace fa_mm
