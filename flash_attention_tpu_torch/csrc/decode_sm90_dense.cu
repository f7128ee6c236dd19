// B4 / B5 over dense fp16 / bf16 K/V on the split body (decode_sm90.cuh),
// compiled apart from the quantized storages so the build runs them in
// parallel.

#include "decode_sm90.cuh"

namespace fa {
namespace split {

cudaError_t run_dense(const Args& a, bool paged, int dtype, int D,
                      cudaStream_t stream) {
  return paged ? dispatch<true, kDense, false>(a, dtype, D, stream)
               : dispatch<false, kDense, false>(a, dtype, D, stream);
}

}  // namespace split
}  // namespace fa
