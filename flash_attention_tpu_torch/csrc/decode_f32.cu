// B5 with an fp32 q (decode.cu) over dense fp32, int8, e4m3 and e5m2
// caches, compiled apart from the fp16 / bf16 instantiations so the build
// runs them in parallel. The JAX kernel takes an fp32 q over int8 caches
// as well (tests/test_decode.py:98-108).

#include "decode.cuh"

namespace fa {
namespace contiguous {

cudaError_t dispatch_f32(const Args& a, int D, int store) {
  switch (store) {
    case kDense:
      return dispatch_d<kDense, float>(a, D);
    case kInt8:
      return dispatch_d<kInt8, float>(a, D);
    case kE4M3:
      return dispatch_d<kE4M3, float>(a, D);
    case kE5M2:
      return dispatch_d<kE5M2, float>(a, D);
  }
  return cudaErrorInvalidValue;
}

}  // namespace contiguous
}  // namespace fa
