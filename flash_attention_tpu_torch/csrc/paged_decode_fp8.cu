// B4 over fp8 (e4m3, e5m2) pools (paged_decode.cu): each code widened
// by the card's native conversion, times its scale, rounded to the
// compute type; compiled apart from the dense and int8 instantiations so
// the build runs them in parallel.

#include "paged_decode.cuh"

namespace fa {
namespace paged {

cudaError_t dispatch_fp8(const Args& a, int dtype, int D, int store) {
  return store == kE4M3 ? dispatch<kE4M3, false>(a, dtype, D)
                        : dispatch<kE5M2, false>(a, dtype, D);
}

}  // namespace paged
}  // namespace fa
