// B4 over int8 pools (paged_decode.cu): the default body (each code
// times its scale, rounded to the compute type) and the fold_scales body
// (scales folded into q and into the per-block PV partials), compiled
// apart from the dense and fp8 instantiations so the build runs them in
// parallel.

#include "paged_decode.cuh"

namespace fa {
namespace paged {

cudaError_t dispatch_int8(const Args& a, int dtype, int D, bool fold) {
  return fold ? dispatch<kInt8, true>(a, dtype, D)
              : dispatch<kInt8, false>(a, dtype, D);
}

}  // namespace paged
}  // namespace fa
