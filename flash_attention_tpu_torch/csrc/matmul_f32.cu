// B6 / B7 / B8 on fp32 activations: the instantiations of the
// register-blocked FFMA body of matmul_f32.cuh for every tile height (16,
// 32, 64, 128 rows) and weight storage (fp32, int8, e4m3, e5m2, int4),
// compiled apart from B9's (matmul_f32_grouped.cu) so the build runs them
// in parallel. quant_matmul.cu's entry launches them.

#include "matmul_f32.cuh"

namespace fa_mm {
namespace f32 {

cudaError_t quant(const Params& p, int weight, int tile_rows, int splits,
                  cudaStream_t s) {
  return dispatch<false>(p, weight, tile_rows, splits, s);
}

}  // namespace f32
}  // namespace fa_mm
