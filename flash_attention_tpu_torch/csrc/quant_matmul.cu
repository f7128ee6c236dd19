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
// activation type before the product. fp16 / bf16 products run on the
// tensor cores with fp32 accumulation (wgmma in the Hopper bodies, WMMA
// in the first); fp32 activations (the JAX kernels' fp32 path) multiply
// in full fp32 on the CUDA cores.
//
// What bounds it on the H100. Decode (M = 8..16 rows): bytes -- the
// weight is read once per call and each weight byte does 2 M FLOPs (int8)
// or 4 M (int4) against the ~295 FLOPs per byte at which the tensor
// cores become the limit; w_gate 4096 x 14336 takes 35 us in bf16,
// 17.5 us in int8 and 9.3 us in int4 at 3.35 TB/s. Prefill (M up to
// 1024): operations, 1024 x 4096 x 14336 is 0.122 ms at 989 TFLOP/s
// (1.79 ms at fp32's 67 TFLOP/s of FFMA).
//
// Four bodies, chosen by ops/quant_matmul.py matmul_body from the shape
// before the launch (body argument):
//  - fp32 activations, any alignment: the register-blocked FFMA body of
//    matmul_f32.cuh (instantiated in matmul_f32.cu): 8 x 8 register
//    micro-tiles, tiles of 16-128 rows sized to M, cp.async staging with
//    the weight widened once per block in shared memory, and K split by
//    ffma_plan where the tiles would not fill the card (fixed-order
//    merge, identical bits on a rerun);
//  - fp16 / bf16 above DECODE_MAX_ROWS (64) rows: the wgmma prefill body
//    of matmul_sm90.cuh (matmul_sm90_{bf16,f16}.cu): a TMA ring of the
//    weight at its storage width, converter warps widening it into
//    swizzled T tiles, two consumer warpgroups on 128 x 128 tiles;
//  - fp16 / bf16 at DECODE_MAX_ROWS rows or fewer: its split-K decode
//    body (matmul_decode_{bf16,f16}.cu): y^T = W^T x^T so no tensor work
//    is spent on rows past M, K split so every product of the 8B decode
//    step puts at least two blocks on each SM (decode_split_plan), a
//    fixed-order reduction of fp32 partials by the last block of each
//    column tile (identical bits on a rerun);
//  - the first body (this file, over matmul_core.cuh): fp16 / bf16
//    operands TMA cannot address (a base or row stride that is not a
//    multiple of 16 bytes, e.g. K = 130 or F = 257). A 64 x 64 tile of y
//    a 128-thread block, WMMA 16x16x16 from shared memory, the next K
//    tile prefetched into registers; ragged M, K and F load as zeros and
//    store under a mask, unaligned rows by byte loads. Its launches are
//    counted in matmul_first_body_launches: no model path makes one.

#include "matmul_f32.cuh"
#include "matmul_kernels.cuh"
#include "matmul_sm90.cuh"

using namespace fa_mm;

// body: hopper::kFirstBody (the kernel above; fp16 / bf16 operands TMA
// cannot address), kPrefillBody or kDecodeBody (matmul_sm90.cuh; fp16 /
// bf16) or f32::kBody (matmul_f32.cuh; fp32). tile_rows, splits, k_chunk,
// ws and counters are the split bodies' plans (ops/quant_matmul.py
// ffma_plan: tile_rows, splits, k_chunk; decode_split_plan: splits,
// k_chunk); ws [splits, M, F] fp32 and counters (one zero int per tile)
// when splits > 1.
extern "C" int fa_quant_matmul(const void* x, const void* w,
                               const void* scale, void* y, int M, int K,
                               int F, int weight, int dtype, int body,
                               int tile_rows, int splits, int k_chunk,
                               void* ws, void* counters, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || K < 0 || F <= 0) return (int)cudaErrorInvalidValue;
  if (weight != kDense && scale == nullptr) return (int)cudaErrorInvalidValue;
  if (weight == kInt4 && K % kGroup) return (int)cudaErrorInvalidValue;
  if (body == f32::kBody) {
    f32::Params p;
    if (dtype != fa::kFloat32 ||
        !f32::make_params(p, x, w, scale, nullptr, y, M, K, F, 1, weight,
                          tile_rows, splits, k_chunk, ws, counters))
      return (int)cudaErrorInvalidValue;
    return (int)f32::quant(p, weight, tile_rows, splits, s);
  }
  if (body == hopper::kFirstBody) {
    if (dtype == fa::kBFloat16)
      return (int)dispatch_quant<__nv_bfloat16>(x, w, scale, y, M, K, F,
                                                weight, s);
    if (dtype == fa::kFloat16)
      return (int)dispatch_quant<__half>(x, w, scale, y, M, K, F, weight, s);
    return (int)cudaErrorInvalidValue;
  }
  if ((dtype != fa::kBFloat16 && dtype != fa::kFloat16) || K == 0)
    return (int)cudaErrorInvalidValue;
  const bool bf16 = dtype == fa::kBFloat16;
  hopper::Args a{static_cast<const float*>(scale), nullptr, y,
                 static_cast<float*>(ws), static_cast<int*>(counters),
                 M, K, F, 1, k_chunk};
  if (body == hopper::kPrefillBody)
    return (int)(bf16 ? hopper::prefill_bf16(x, w, scale, a, weight, s)
                      : hopper::prefill_f16(x, w, scale, a, weight, s));
  if (body != hopper::kDecodeBody || M > 64 || splits < 1 || k_chunk <= 0 ||
      k_chunk % kGroup || (long)(splits - 1) * k_chunk >= K ||
      (long)splits * k_chunk < K ||
      (splits > 1 && (ws == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  return (int)(bf16 ? hopper::decode_bf16(x, w, scale, a, weight, splits, s)
                    : hopper::decode_f16(x, w, scale, a, weight, splits, s));
}
