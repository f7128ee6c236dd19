// B4 with an fp32 q (paged_decode.cu) over e4m3 / e5m2 pools, compiled
// apart from the other instantiations so the build runs them in
// parallel.

#include "paged_decode.cuh"

namespace fa {
namespace paged {

cudaError_t dispatch_f32_fp8(const Args& a, int D, int store) {
  return store == kE4M3 ? dispatch_d<kE4M3, false, float>(a, D)
                        : dispatch_d<kE5M2, false, float>(a, D);
}

}  // namespace paged
}  // namespace fa
