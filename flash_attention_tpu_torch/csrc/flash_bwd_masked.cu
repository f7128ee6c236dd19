// B2 / B3 on fp16 / bf16 with a sliding window and / or segment ids
// (flash_bwd_sm90.cuh, the Masked instantiations), compiled apart from
// the unmasked ones so the build runs them in parallel.

#include "flash_bwd_sm90.cuh"

namespace fa {
namespace bwd {

cudaError_t dispatch_dq_masked(int dtype, int D, const Args& a, void* dq) {
  return dispatch<Dq, true>(dtype, D, a, dq);
}

cudaError_t dispatch_dkv_masked(int dtype, int D, const Args& a, void* dk,
                                void* dv) {
  return dispatch<Dkv, true>(dtype, D, a, dk, dv);
}

}  // namespace bwd
}  // namespace fa
