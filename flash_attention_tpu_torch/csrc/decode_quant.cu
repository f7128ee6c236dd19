// B5 over int8 / e4m3 / e5m2 caches (decode.cu), compiled apart from
// the dense instantiations so the build runs them in parallel.

#include "decode.cuh"

namespace fa {
namespace contiguous {

cudaError_t dispatch_quant(const Args& a, int dtype, int D, int store) {
  switch (store) {
    case kInt8:
      return dispatch<kInt8>(a, dtype, D);
    case kE4M3:
      return dispatch<kE4M3>(a, dtype, D);
    case kE5M2:
      return dispatch<kE5M2>(a, dtype, D);
  }
  return cudaErrorInvalidValue;
}

}  // namespace contiguous
}  // namespace fa
