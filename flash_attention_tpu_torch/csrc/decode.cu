// B5: one-token decode attention over contiguous caches, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel flash_attention_tpu/ops/decode.py
// `_decode_kernel` (decode.py:71, launched at :229) on the port's
// `generate` path (models/llama.py `decode_step`, one launch per layer
// per step).
//
// Computes, for every sequence b and kv head h, attention of the G = Hq /
// Hkv query rows of that head's group (q [B, Hq, D]) over the first
// lengths[b] positions of the contiguous cache K/V [B, Hkv, S, D], and
// writes O [B, Hq, D] in q's dtype. Positions >= lengths[b] are never
// read; a length-0 row gives O = 0 (the TPU kernel's l_safe). With a
// sliding window (window > 0, the TPU kernel's `window` branch,
// decode.py:88-111) positions < lengths[b] - window are masked and the
// chunks entirely below it are never read. Quantized caches (the TPU
// kernel's `quantized` branch with `_dequant`, decode.py:56-68): codes
// [B, Hkv, S, D] in int8 / e4m3 / e5m2 with fp32 scales [B, Hkv, S / 128,
// D]; position pos reads scale row scales[b, h, pos / 128, :]; each code
// is widened, multiplied by its scale in fp32 and rounded to q's type
// before the product (decode_core.cuh). They compile in decode_int8.cu
// and decode_fp8.cu, apart from the dense instantiations here.
//
// What bounds it on the H100: bytes, as for B4. Each live position's K
// and V rows are read once per kv head (4*D bytes per head in bf16) for
// 4*G*D FLOPs -- G/2 FLOPs per byte, far under the ~295 at which the
// tensor cores would be the limit. The design reads only the live prefix
// and reads it once for up to 16 of the G rows (a wider group walks it
// once per 16 rows, in the same launch): one 256-thread block per (kv head,
// sequence) walks the prefix in chunks of 256 positions with 16-byte
// loads by neighbouring threads on neighbouring addresses, through the
// body B4 uses for its pages (decode_core.cuh; the products in fp32 on
// the CUDA cores, partial sums added in a fixed order).
//
// q may be fp16, bf16 or fp32 (a dense cache then in q's dtype); the fp32
// instantiations compile in decode_f32.cu.
//
// B * Hkv blocks are in flight (32 at the generate shape of 4 sequences
// and 8 kv heads, on 132 SMs); splitting a sequence's prefix across
// blocks with a merge pass is the fast shape and is later work.

#include "decode.cuh"

// kv_store: common.cuh kDense / kInt8 / kE4M3 / kE5M2; kscale / vscale
// null for dense caches (S a multiple of 128 otherwise).
extern "C" int fa_decode(const void* q, const void* k, const void* v,
                         const void* kscale, const void* vscale,
                         const void* lengths, void* o, int B, int Hq,
                         int Hkv, int S, int D, int window, float scale,
                         int dtype, int kv_store, void* stream) {
  using namespace fa;
  if (Hkv <= 0 || Hq % Hkv || S < 0) return (int)cudaErrorInvalidValue;
  if (kv_store != kDense && (kscale == nullptr || vscale == nullptr ||
                             S % decode::kQuantBlock))
    return (int)cudaErrorInvalidValue;
  const contiguous::Args a{q, k, v, static_cast<const float*>(kscale),
                           static_cast<const float*>(vscale),
                           static_cast<const int*>(lengths), o, B, Hq, Hkv,
                           S, window, scale,
                           static_cast<cudaStream_t>(stream)};
  if (dtype == kFloat32) return (int)contiguous::dispatch_f32(a, D, kv_store);
  switch (kv_store) {
    case kDense:
      return (int)contiguous::dispatch<kDense>(a, dtype, D);
    case kInt8:
      return (int)contiguous::dispatch_int8(a, dtype, D);
    case kE4M3:
    case kE5M2:
      return (int)contiguous::dispatch_fp8(a, dtype, D, kv_store);
  }
  return (int)cudaErrorInvalidValue;
}
