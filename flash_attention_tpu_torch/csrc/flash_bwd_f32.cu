// B2 / B3 on fp32 inputs, masked and not: the register-blocked FFMA body
// of flash_bwd_f32.cuh (every product in full fp32 on the CUDA cores, as
// the JAX kernels compute fp32 at Precision.HIGHEST,
// flash_attention_tpu/ops/flash.py:92-101). Compiled apart from the
// fp16 / bf16 instantiations so the build runs them in parallel.

#include "flash_bwd_f32.cuh"

namespace fa {
namespace bwd {

cudaError_t dispatch_dq_f32(int D, bool masked, const Args& a, void* dq) {
  return masked ? dispatch_d<f32::DqF32, true, float>(D, a, dq)
                : dispatch_d<f32::DqF32, false, float>(D, a, dq);
}

cudaError_t dispatch_dkv_f32(int D, bool masked, const Args& a, void* dk,
                             void* dv) {
  return masked ? dispatch_d<f32::DkvF32, true, float>(D, a, dk, dv)
                : dispatch_d<f32::DkvF32, false, float>(D, a, dk, dv);
}

}  // namespace bwd
}  // namespace fa
