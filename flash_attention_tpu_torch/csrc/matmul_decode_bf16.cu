// B6 / B7 / B8 at the decode threshold or below (the split-K body) on
// bf16 activations: the instantiations of matmul_sm90.cuh for every
// weight storage (dense, int8, e4m3, e5m2, int4), compiled apart so the
// build runs them in parallel.

#include "matmul_sm90.cuh"

namespace fa_mm {
namespace hopper {

cudaError_t decode_bf16(const void* x, const void* w, const void* scale,
                        const Args& a, int weight, int splits,
                        cudaStream_t s) {
  return dispatch_decode<__nv_bfloat16>(x, w, scale, a, weight, splits, s);
}

}  // namespace hopper
}  // namespace fa_mm
