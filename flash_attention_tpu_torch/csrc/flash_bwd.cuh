// B2 / B3: what both bodies compute, and the Args and dispatch pieces
// that the fp16 / bf16 Hopper body (flash_bwd_sm90.cuh) and the fp32
// FFMA body (flash_bwd_f32.cuh) share.
//
// B2 (dQ) replaces the Pallas TPU kernel flash_attention_tpu/ops/flash.py
// `_bwd_dq_kernel` (flash.py:716, launched at :949); B3 (dK/dV) replaces
// `_bwd_dkv_kernel` (flash.py:773, launched at :1017). The wrapper
// (ops/flash.py) computes delta = rowsum(dO * O) in fp32 before the
// launches, as the JAX package does in XLA (flash.py:879-881).
//
// Per (q row, kv col) pair both kernels recompute, from the forward's
// LSE:
//   P  = exp2(S * scale * log2e - lse * log2e),  S = Q K^T (unscaled)
//   dP = dO V^T
//   dS = P * (dP - delta) * scale
// and B2 sums dQ = dS K over the kv tiles of one q tile, B3 sums
// dV = P^T dO and dK = dS^T Q over the GQA group's q heads and the q
// tiles of one kv tile. P is rounded to the input dtype before the dV
// product and dS before the dQ and dK products (the JAX kernels'
// numerics, flash.py:764, :822, :831; a no-op in fp32); every sum is
// fp32.
//
// Masking is by select: a pair that is causally hidden (col > row +
// offset), a kv column >= Nk or a q row >= Nq gets P = 0 exactly, never
// exp2 of a large negative. So a ragged q row that loads as zeros (with
// a zero LSE) contributes nothing to dK/dV, and a row that sees no key
// (the forward's dead row, LSE = INIT_M * scale) yields zero gradients
// without ever evaluating exp2 of its LSE.
//
// Window and segment ids (the TPU kernels' _mask_block, flash.py:201-240,
// applied through _mask_block_if_needed, :748-756): the `Masked`
// instantiations also hide col <= row + offset - window (window > 0,
// causal only) and pairs whose segment ids differ (qseg [B, Nq], kvseg
// [B, Nk], both or neither), by the same select.
//
// Determinism: the split into two kernels (rather than one fused kernel
// with fp32 atomics on dQ) makes every output the sum of a fixed
// sequence of products in one block, in a fixed order: two runs give
// identical bits, as the TPU kernels do.
//
// The fp32 body is flash_bwd_f32.cuh (register-blocked FFMA), the fp16 /
// bf16 one flash_bwd_sm90.cuh (wgmma, TMA); both take this Args and
// dispatch_d.
#pragma once

#include "common.cuh"

namespace fa {
namespace bwd {

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  const int* qseg;          // [B, Nq] or null
  const int* kvseg;         // [B, Nk] or null
  int B, Hq, Hkv, Nq, Nk, causal, offset, window;
  float scale;
  cudaStream_t stream;
};

// Dispatch over the head dim for one compute type T; F is a launcher
// templated on T, the head dim and the mask flag (Dq / Dkv of
// flash_bwd_sm90.cuh, f32::DqF32 / DkvF32 of flash_bwd_f32.cuh).
template <template <typename, int, bool> class F, bool Masked, typename T,
          typename... Out>
cudaError_t dispatch_d(int D, const Args& a, Out... out) {
  if (D == 128) return F<T, 128, Masked>::run(a, out...);
  if (D == 64) return F<T, 64, Masked>::run(a, out...);
  if (D == 256) return F<T, 256, Masked>::run(a, out...);
  if (D == 32) return F<T, 32, Masked>::run(a, out...);
  return cudaErrorInvalidValue;
}

// Defined in flash_bwd_masked.cu.
cudaError_t dispatch_dq_masked(int dtype, int D, const Args& a, void* dq);
cudaError_t dispatch_dkv_masked(int dtype, int D, const Args& a, void* dk,
                                void* dv);
// Defined in flash_bwd_f32.cu: fp32 inputs, masked or not.
cudaError_t dispatch_dq_f32(int D, bool masked, const Args& a, void* dq);
cudaError_t dispatch_dkv_f32(int D, bool masked, const Args& a, void* dk,
                             void* dv);

}  // namespace bwd
}  // namespace fa
