// B1 over e4m3 K/V (flash_fwd.cu): the Hopper body with four converter
// warps widening each TMA-loaded tile of codes,
// compiled apart from the other storages so the build runs them in
// parallel.

#include "flash_fwd.cuh"

namespace fa {
namespace fwd {

cudaError_t dispatch_e4m3(const Args& a, int dtype, int D) {
  return dispatch<kE4M3>(a, dtype, D);
}

}  // namespace fwd
}  // namespace fa
