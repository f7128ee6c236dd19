// B6 / B7 / B8 above the decode threshold on fp16 activations: the
// instantiations of matmul_sm90.cuh for every weight storage (dense,
// int8, e4m3, e5m2, int4), compiled apart so the build runs them in
// parallel.

#include "matmul_sm90.cuh"

namespace fa_mm {
namespace hopper {

cudaError_t prefill_f16(const void* x, const void* w, const void* scale,
                        const Args& a, int weight,
                        cudaStream_t s) {
  return dispatch_prefill<__half, false>(x, w, scale, a, weight, s);
}

}  // namespace hopper
}  // namespace fa_mm
