// B4 with an fp32 q (paged_decode.cu) over dense fp32 pools and int8
// pools (the default body and fold_scales), compiled apart from the
// fp16 / bf16 instantiations so the build runs them in parallel. The
// products are fp32 on the CUDA cores as in every type; the JAX kernel
// takes fp32 pools too (flash_attention_tpu/ops/paged.py:192).

#include "paged_decode.cuh"

namespace fa {
namespace paged {

cudaError_t dispatch_f32(const Args& a, int D, int store, bool fold) {
  if (store == kDense) return dispatch_d<kDense, false, float>(a, D);
  if (store == kInt8)
    return fold ? dispatch_d<kInt8, true, float>(a, D)
                : dispatch_d<kInt8, false, float>(a, D);
  return cudaErrorInvalidValue;
}

}  // namespace paged
}  // namespace fa
