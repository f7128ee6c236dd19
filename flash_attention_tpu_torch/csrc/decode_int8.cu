// B5 over int8 caches (decode.cu), compiled apart from the dense and fp8
// instantiations so the build runs them in parallel.

#include "decode.cuh"

namespace fa {
namespace contiguous {

cudaError_t dispatch_int8(const Args& a, int dtype, int D) {
  return dispatch<kInt8>(a, dtype, D);
}

}  // namespace contiguous
}  // namespace fa
