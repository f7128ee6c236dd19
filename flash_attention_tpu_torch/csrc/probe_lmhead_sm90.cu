// P3 (scripts/probe_lmhead_argmax.py, the fused int4 lm_head + argmax) on
// the split-K decode body of matmul_sm90.cuh: bf16 x, B7's packed int4
// lm_head, the argmax epilogue, one split (an argmax needs whole sums).
// Compiled apart so the build runs it in parallel with the other sources.

#include "matmul_sm90.cuh"

namespace fa_mm {
namespace hopper {

cudaError_t probe_lmhead(const void* x, const void* w, const void* scale,
                         const Args& a, cudaStream_t s) {
  return launch<__nv_bfloat16, kInt4, 64, false, kArgmax>(x, w, scale, a,
                                                          1, s);
}

}  // namespace hopper
}  // namespace fa_mm
