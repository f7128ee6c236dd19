// B6-B8 and B9 on fp32 activations (matmul_kernels.cuh): every weight
// storage widened into fp32 shared-memory tiles and multiplied in full
// fp32 on the CUDA cores (matmul_core.cuh's FFMA branch), as the JAX
// kernels compute fp32 at Precision.HIGHEST. B8 and B9's dense stacks
// take an fp32 weight. Compiled apart from the fp16 / bf16
// instantiations so the build runs them in parallel.

#include "matmul_kernels.cuh"

namespace fa_mm {

cudaError_t dispatch_quant_f32(const void* x, const void* w,
                               const void* scale, void* y, int M, int K,
                               int F, int weight, cudaStream_t stream) {
  return dispatch_quant<float>(x, w, scale, y, M, K, F, weight, stream);
}

cudaError_t dispatch_grouped_f32(const void* x, const void* w,
                                 const void* scale, const int* offsets,
                                 void* y, int M, int K, int F, int E,
                                 int weight, cudaStream_t stream) {
  return dispatch_grouped<float>(x, w, scale, offsets, y, M, K, F, E,
                                 weight, stream);
}

}  // namespace fa_mm
