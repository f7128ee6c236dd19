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
// slabs entirely below it are never read. Quantized caches (the TPU
// kernel's `quantized` branch with `_dequant`, decode.py:56-68): codes
// [B, Hkv, S, D] in int8 / e4m3 / e5m2 with fp32 scales [B, Hkv, S / 128,
// D]; position pos reads scale row scales[b, h, pos / 128, :]; each code
// is widened, multiplied by its scale in fp32 and rounded to q's type
// before the product.
//
// What bounds it on the H100: bytes. Each live position's K and V rows
// are read once per kv head (4*D bytes per head in bf16) for 4*G*D FLOPs
// -- G/2 FLOPs per byte, far under the ~295 at which the tensor cores
// would be the limit.
//
// Two bodies, chosen by the wrapper (ops/decode.py decode_body):
//  - fp16 / bf16 q: the split body of decode_sm90.cuh, shared with B4:
//    the visible positions cut across `splits` blocks per (sequence, kv
//    head, 16 query rows), mma.sync products, a cp.async ring per warp,
//    and a fixed-order merge of the splits inside the launch (identical
//    bits on a rerun). Instantiated in decode_sm90_*.cu.
//  - fp32 q (a dense cache then in fp32, or any quantized storage): the
//    first body, decode_core.cuh's FFMA products in one 256-thread block
//    per (kv head, sequence) (decode.cuh, decode_f32.cu).

#include "decode.cuh"
#include "decode_sm90.cuh"

// kv_store: common.cuh kDense / kInt8 / kE4M3 / kE5M2; kscale / vscale
// null for dense caches (S a multiple of 128 otherwise). body: 0 the
// first body (fp32 q only), 1 the split body with `splits` blocks per
// (sequence, kv head, row group) and, when splits > 1, the scratch ws
// (floats) and counters (ops/decode.py split_scratch).
extern "C" int fa_decode(const void* q, const void* k, const void* v,
                         const void* kscale, const void* vscale,
                         const void* lengths, void* o, int B, int Hq,
                         int Hkv, int S, int D, int window, float scale,
                         int dtype, int kv_store, int body, int splits,
                         void* ws, void* counters, void* stream) {
  using namespace fa;
  if (Hkv <= 0 || Hq % Hkv || S < 0) return (int)cudaErrorInvalidValue;
  if (kv_store != kDense && (kscale == nullptr || vscale == nullptr ||
                             S % decode::kQuantBlock))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (body == 1) {
    if (dtype == kFloat32) return (int)cudaErrorInvalidValue;
    const int rows = Hq / Hkv;
    split::Args a{};
    a.q = q;
    a.k = k;
    a.v = v;
    a.kscale = static_cast<const float*>(kscale);
    a.vscale = static_cast<const float*>(vscale);
    a.lengths = static_cast<const int*>(lengths);
    a.o = o;
    a.ws = static_cast<float*>(ws);
    a.counters = static_cast<int*>(counters);
    a.B = B;
    a.Hq = Hq;
    a.Hkv = Hkv;
    a.rows = rows;
    a.groups = (rows + split::kRows - 1) / split::kRows;
    a.splits = splits;
    a.S = S;
    a.window = window;
    a.scale = scale;
    return (int)split::run(a, false, kv_store, false, dtype, D, st);
  }
  if (body != 0 || dtype != kFloat32) return (int)cudaErrorInvalidValue;
  const contiguous::Args a{q, k, v, static_cast<const float*>(kscale),
                           static_cast<const float*>(vscale),
                           static_cast<const int*>(lengths), o, B, Hq, Hkv,
                           S, window, scale, st};
  return (int)contiguous::dispatch_f32(a, D, kv_store);
}
