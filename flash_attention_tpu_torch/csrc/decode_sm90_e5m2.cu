// B4 / B5 over e5m2 K/V on the split body (decode_sm90.cuh): each code
// widened by the card's native conversion, times its scale, rounded to the
// compute type; compiled apart from the other storages so the build runs
// them in parallel.

#include "decode_sm90.cuh"

namespace fa {
namespace split {

cudaError_t run_e5m2(const Args& a, bool paged, int dtype, int D,
                     cudaStream_t stream) {
  return paged ? dispatch<true, kE5M2, false>(a, dtype, D, stream)
               : dispatch<false, kE5M2, false>(a, dtype, D, stream);
}

}  // namespace split
}  // namespace fa
