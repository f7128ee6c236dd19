// B1 on fp32 inputs (flash_fwd.cu's fa_flash_fwd with dtype fp32): the
// register-blocked FFMA body of flash_fwd_f32.cuh, instantiated here
// without a window or segment ids (causal, any offset, the split's two
// passes); the masked instantiations compile in flash_fwd_f32_masked.cu.

#include "flash_fwd_f32.cuh"

namespace fa {
namespace fwd {

cudaError_t dispatch_f32(const Args& a, int D) {
  if (a.window > 0 || a.qseg != nullptr) return dispatch_f32_masked(a, D);
  return dispatch_f32_as<false>(a, D);
}

}  // namespace fwd
}  // namespace fa
