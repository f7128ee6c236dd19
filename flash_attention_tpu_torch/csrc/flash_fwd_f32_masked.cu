// B1 on fp32 inputs with a window or segment ids: flash_fwd_f32.cuh's
// masked instantiations (their own source, so the build runs them beside
// the dense ones).

#include "flash_fwd_f32.cuh"

namespace fa {
namespace fwd {

cudaError_t dispatch_f32_masked(const Args& a, int D) {
  return dispatch_f32_as<true>(a, D);
}

}  // namespace fwd
}  // namespace fa
