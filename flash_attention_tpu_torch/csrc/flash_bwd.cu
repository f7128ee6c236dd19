// B2 and B3: the recompute backward of flash attention for Hopper
// (sm_90a), the backward of B1 (flash_fwd.cu). The fp16 / bf16 kernels
// (wgmma, TMA, accumulators in registers) are in flash_bwd_sm90.cuh, the
// fp32 FFMA body in flash_bwd_f32.cuh, what both compute in
// flash_bwd.cuh. This file holds
// the unmasked fp16 / bf16 instantiations and the C entry points,
// flash_bwd_masked.cu the window / segment-id instantiations and
// flash_bwd_f32.cu those of fp32 inputs, so the build compiles them in
// parallel.

#include "flash_bwd_sm90.cuh"

namespace {

// qseg / kvseg: [B, Nq] / [B, Nk] int32 segment ids, both or neither;
// window: 0 = none (causal only otherwise).
bool make_args(fa::bwd::Args* a, const void* q, const void* k,
               const void* v, const void* dout, const void* lse,
               const void* delta, const void* qseg, const void* kvseg,
               int B, int Hq, int Hkv, int Nq, int Nk, int causal,
               int offset, int window, float scale, void* stream) {
  if (Hkv <= 0 || Hq % Hkv || (qseg == nullptr) != (kvseg == nullptr) ||
      window < 0 || (window > 0 && !causal))
    return false;
  *a = fa::bwd::Args{q, k, v, dout, static_cast<const float*>(lse),
                     static_cast<const float*>(delta),
                     static_cast<const int*>(qseg),
                     static_cast<const int*>(kvseg), B, Hq, Hkv, Nq, Nk,
                     causal, offset, window, scale,
                     static_cast<cudaStream_t>(stream)};
  return true;
}

// The window / segment-id instantiations (flash_bwd_masked.cu).
bool masked(const fa::bwd::Args& a) {
  return a.window > 0 || a.qseg != nullptr;
}

}  // namespace

extern "C" int fa_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dq,
                               const void* qseg, const void* kvseg, int B,
                               int Hq, int Hkv, int Nq, int Nk, int D,
                               int causal, int offset, int window,
                               float scale, int dtype, void* stream) {
  using namespace fa::bwd;
  Args a;
  if (!make_args(&a, q, k, v, dout, lse, delta, qseg, kvseg, B, Hq, Hkv, Nq,
                 Nk, causal, offset, window, scale, stream))
    return (int)cudaErrorInvalidValue;
  if (dtype == fa::kFloat32)
    return (int)dispatch_dq_f32(D, masked(a), a, dq);
  if (masked(a)) return (int)dispatch_dq_masked(dtype, D, a, dq);
  return (int)dispatch<Dq, false>(dtype, D, a, dq);
}

extern "C" int fa_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dk, void* dv,
                                const void* qseg, const void* kvseg, int B,
                                int Hq, int Hkv, int Nq, int Nk, int D,
                                int causal, int offset, int window,
                                float scale, int dtype, void* stream) {
  using namespace fa::bwd;
  Args a;
  if (!make_args(&a, q, k, v, dout, lse, delta, qseg, kvseg, B, Hq, Hkv, Nq,
                 Nk, causal, offset, window, scale, stream))
    return (int)cudaErrorInvalidValue;
  if (dtype == fa::kFloat32)
    return (int)dispatch_dkv_f32(D, masked(a), a, dk, dv);
  if (masked(a)) return (int)dispatch_dkv_masked(dtype, D, a, dk, dv);
  return (int)dispatch<Dkv, false>(dtype, D, a, dk, dv);
}
