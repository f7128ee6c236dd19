// B5 over e4m3 / e5m2 caches (decode.cu), compiled apart from the dense
// and int8 instantiations so the build runs them in parallel.

#include "decode.cuh"

namespace fa {
namespace contiguous {

cudaError_t dispatch_fp8(const Args& a, int dtype, int D, int store) {
  return store == kE4M3 ? dispatch<kE4M3>(a, dtype, D)
                        : dispatch<kE5M2>(a, dtype, D);
}

}  // namespace contiguous
}  // namespace fa
