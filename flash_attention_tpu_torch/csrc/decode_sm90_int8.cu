// B4 / B5 over int8 K/V on the split body (decode_sm90.cuh): the default
// body (each code times its scale, rounded to the compute type) and B4's
// fold_scales body, compiled apart from the other storages so the build
// runs them in parallel.

#include "decode_sm90.cuh"

namespace fa {
namespace split {

cudaError_t run_int8(const Args& a, bool paged, bool fold, int dtype, int D,
                     cudaStream_t stream) {
  if (!paged) return dispatch<false, kInt8, false>(a, dtype, D, stream);
  return fold ? dispatch<true, kInt8, true>(a, dtype, D, stream)
              : dispatch<true, kInt8, false>(a, dtype, D, stream);
}

}  // namespace split
}  // namespace fa
