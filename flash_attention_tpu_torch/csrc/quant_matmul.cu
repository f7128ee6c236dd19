// B6, B7, B8: weight-only quantized and weight-streaming matrix products
// for Hopper (sm_90a), one kernel templated over the weight's storage.
//
// Replaces the Pallas TPU kernels of flash_attention_tpu/ops/quant_matmul.py:
//   B6 `_kernel` (quant_matmul.py:41, launched at :98): y = x @ (Wq * s),
//      Wq int8 / fp8 e4m3 / fp8 e5m2 [K, F], s fp32 [F];
//   B7 `_int4_kernel` (:214, launched at :305): y = x @ dequant(W), W
//      packed int4 [K/2, F] (byte j of a column = logical rows 2j in the
//      low nibble and 2j + 1 in the high nibble), scales fp32 [K/128, F];
//   B8 `_dense_kernel` (:141, launched at :189): y = x @ W, W in the
//      activation's 16-bit type.
// on the port's serving path: every weight product of the model
// (models/llama.py `_mm`) with at most 1024 activation rows, on
// quantized weights, and with FA_TPU_DENSE_PALLAS_MM=1 on dense ones.
//
// Numerics (the JAX kernels'): int8 and fp8 widen exactly to the
// activation type (the card's __nv_fp8_e4m3 / __nv_fp8_e5m2 conversions;
// NaN / inf codes, which quantization never emits, decode as NaN / inf
// where the TPU's bit-plant gave large finite values) and the
// per-channel scale multiplies the fp32 sum once at the store; an int4
// value is multiplied by its group scale in fp32 and rounded to the
// activation type before the product. Products are WMMA 16x16x16
// bf16 / fp16 with fp32 accumulation.
//
// What bounds it on the H100. Decode (M = 8..16 rows): bytes -- the
// weight is read once per call and each weight byte does 2 M FLOPs (int8)
// or 4 M (int4) against the ~295 FLOPs per byte at which the tensor
// cores become the limit; w_gate 4096 x 14336 takes 35 us in bf16,
// 17.5 us in int8 and 9.3 us in int4 at 3.35 TB/s. Prefill (M up to
// 1024): operations. The body is `fa_mm::accumulate_tile`
// (matmul_core.cuh, shared with B9) over the rows [0, M): it reads each
// weight at its storage width
// with 16-byte loads by neighbouring threads on neighbouring addresses,
// widens it in shared memory (never in HBM), and keeps the next K tile's
// loads in flight in registers while the tensor cores work on the
// current one. Each block owns a 64 x 64 tile of y and loops over K in
// steps of 128 inside the block (the TPU's sequential k grid axis);
// each of its four warps owns 16 columns and skips the 16-row groups
// that lie past M, so at decode the four warps share the few products.
// Ragged M, K and F load as zeros and store under a mask (the JAX
// wrapper's jnp.pad); rows whose stride or base is not 16-byte aligned
// fall back to byte loads.
//
// Known costs, for the speed work: a 64-wide F tile gives F / 64 blocks
// at decode (16 for wk / wv, 64 for wq / wo / w_down, 224 for w_gate /
// w_up on 132 SMs), each with a few KB in flight, so the small products
// cannot fill HBM; split-K and a decode-shaped tile are the fix. At
// prefill WMMA through shared memory runs far under wgmma's rate.

#include "matmul_core.cuh"

namespace {

using namespace fa_mm;

template <typename T, int W>
__global__ void __launch_bounds__(kThreads)
quant_matmul_kernel(const T* __restrict__ x,
                    const unsigned char* __restrict__ w,
                    const float* __restrict__ scale, T* __restrict__ y,
                    int M, int K, int F, int x_vec, int w_vec) {
  __shared__ __align__(128) unsigned char smem[smem_bytes<T>()];
  const int f0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  Acc acc[kBM / 16];
#pragma unroll
  for (int g = 0; g < kBM / 16; ++g) wmma::fill_fragment(acc[g], 0.f);
  accumulate_tile<T, W, false>(x, w, scale, 0, M, K, F, m0, f0, x_vec,
                               w_vec, smem, acc);
  store_tile<T>(acc, smem, y, channel_scaled<W>() ? scale : nullptr, M, F,
                m0, f0);
}

template <typename T, int W>
cudaError_t launch(const void* x, const void* w, const void* scale, void* y,
                   int M, int K, int F, cudaStream_t stream) {
  dim3 grid((F + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  quant_matmul_kernel<T, W><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const unsigned char*>(w),
      static_cast<const float*>(scale), static_cast<T*>(y), M, K, F,
      (int)x_aligned<T>(x, K), (int)w_aligned<W>(w, F));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_weight(const void* x, const void* w, const void* scale,
                            void* y, int M, int K, int F, int weight,
                            cudaStream_t stream) {
  switch (weight) {
    case kDense:
      return launch<T, kDense>(x, w, scale, y, M, K, F, stream);
    case kInt8:
      return launch<T, kInt8>(x, w, scale, y, M, K, F, stream);
    case kE4M3:
      return launch<T, kE4M3>(x, w, scale, y, M, K, F, stream);
    case kE5M2:
      return launch<T, kE5M2>(x, w, scale, y, M, K, F, stream);
    case kInt4:
      return launch<T, kInt4>(x, w, scale, y, M, K, F, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int fa_quant_matmul(const void* x, const void* w,
                               const void* scale, void* y, int M, int K,
                               int F, int weight, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || K < 0 || F <= 0) return (int)cudaErrorInvalidValue;
  if (weight != kDense && scale == nullptr) return (int)cudaErrorInvalidValue;
  if (weight == kInt4 && K % kGroup) return (int)cudaErrorInvalidValue;
  if (dtype == fa::kBFloat16)
    return (int)dispatch_weight<__nv_bfloat16>(x, w, scale, y, M, K, F,
                                               weight, s);
  if (dtype == fa::kFloat16)
    return (int)dispatch_weight<__half>(x, w, scale, y, M, K, F, weight, s);
  return (int)cudaErrorInvalidValue;
}
