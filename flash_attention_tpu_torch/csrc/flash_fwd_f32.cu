// B1 on fp32 inputs (flash_fwd.cu): the dense body with both products
// in full fp32 on the CUDA cores, compiled apart from the fp16 / bf16
// instantiations so the build runs them in parallel.

#include "flash_fwd.cuh"

namespace fa {
namespace fwd {

cudaError_t dispatch_f32(const Args& a, int D) {
  if (D == 128) return launch<float, 128, kDense>(a);
  if (D == 64) return launch<float, 64, kDense>(a);
  if (D == 256) return launch<float, 256, kDense>(a);
  if (D == 32) return launch<float, 32, kDense>(a);
  return cudaErrorInvalidValue;
}

}  // namespace fwd
}  // namespace fa
