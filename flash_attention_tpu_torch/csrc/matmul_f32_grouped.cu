// B9 on fp32 activations: the instantiations of the register-blocked FFMA
// body of matmul_f32.cuh for every tile height (16, 32, 64, 128 rows) and
// expert-stack storage (fp32, int8, e4m3, e5m2, int4), compiled apart
// from B6-B8's (matmul_f32.cu) so the build runs them in parallel.
// grouped_matmul.cu's entry launches them.

#include "matmul_f32.cuh"

namespace fa_mm {
namespace f32 {

cudaError_t grouped(const Params& p, int weight, int tile_rows, int splits,
                    cudaStream_t s) {
  return dispatch<true>(p, weight, tile_rows, splits, s);
}

}  // namespace f32
}  // namespace fa_mm
