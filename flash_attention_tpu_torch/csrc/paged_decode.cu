// B4: paged decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel flash_attention_tpu/ops/paged.py
// `_paged_kernel` (paged.py:37, launched at :305) on the port's serving
// path (one launch per layer per engine decode step).
//
// Computes, for every sequence b and kv head h, attention of the R query
// rows that read kv head h (the GQA group times any folded positions,
// t fastest) over the first lengths[b] tokens of the sequence's paged
// K/V, and exports O [B, Hq, D] and LSE [B, Hq] (fp32). A length-0 row
// (a dead engine slot) gives O = 0 and LSE = INIT_M * scale. With
// window starts (starts [B], stored positions, may be negative) row r of
// the group sees positions >= starts[b] + (r % spread): `spread` folded
// query positions, t fastest (the TPU kernel's `windowed` branch and
// qpos_spread, paged.py:62-66, :124-130). Positions entirely below
// starts[b] are never read, so windowed decode reads O(window) bytes, not
// O(length); nor is any page-table entry at or beyond ceil(lengths[b] /
// page_size) (the table's tail points at a scratch page).
//
// Quantized pools (the TPU kernel's int8 / fp8 branch and its int8
// fold_scales body, paged.py:73-115, :135-168): codes [Hkv, P, ps, D] in
// int8 / e4m3 / e5m2 with fp32 scales [Hkv, P, ps / 128, D]; the scale
// row of position pos of page p is scales[h, p, (pos % ps) / 128, :].
// They halve the bytes per token (2*Hkv*D codes + 8*Hkv*D/128 scale
// bytes against 4*Hkv*D in bf16).
//
// What bounds it on the H100: bytes. Each live token's K and V rows are
// read once per kv head (4*Hkv*D bytes per token in bf16) and do 4*R*D
// FLOPs, about R/2 FLOPs per byte -- far under the ~295 FLOPs per byte
// at which the tensor cores would become the limit.
//
// Two bodies, chosen by the wrapper (ops/paged.py, decode.decode_body):
//  - fp16 / bf16 q over pools whose page size is a multiple of 16 (every
//    quantized pool, the engine's pages of 256): the split body of
//    decode_sm90.cuh, shared with B5 -- the visible tokens of a sequence
//    cut across `splits` blocks per (sequence, kv head, 16 query rows),
//    each warp a cp.async ring of 16-token slabs and mma.sync products,
//    the splits merged in a fixed order inside the launch (identical
//    bits on a rerun). Instantiated in decode_sm90_*.cu.
//  - fp32 q, and fp16 / bf16 over dense pools of another page size: the
//    first body, decode_core.cuh's FFMA products in one 256-thread block
//    per (kv head, sequence), page by page (paged_decode.cuh; fp32 in
//    paged_decode_f32.cu and paged_decode_f32_fp8.cu).

#include "paged_decode.cuh"
#include "decode_sm90.cuh"

// kv_store: common.cuh kDense / kInt8 / kE4M3 / kE5M2; kscale / vscale
// null for dense pools; fold (int8 only) takes the fold_scales body.
// body: 0 the first body, 1 the split body with `splits` blocks per
// (sequence, kv head, row group) and, when splits > 1, the scratch ws
// (floats) and counters (ops/decode.py split_scratch).
extern "C" int fa_paged_decode(const void* q, const void* kpool,
                               const void* vpool, const void* kscale,
                               const void* vscale, const void* table,
                               const void* lengths, const void* starts,
                               void* o, void* lse, int B, int Hq, int Hkv,
                               int num_pages, int page_size, int width,
                               int D, int spread, float scale, int dtype,
                               int kv_store, int fold, int body, int splits,
                               void* ws, void* counters, void* stream) {
  using namespace fa;
  if (Hkv <= 0 || Hq % Hkv || page_size <= 0 || width <= 0 || spread < 1 ||
      (Hq / Hkv) % spread)
    return (int)cudaErrorInvalidValue;
  const bool quant = kv_store != kDense;
  if (quant && (kscale == nullptr || vscale == nullptr ||
                page_size % decode::kQuantBlock))
    return (int)cudaErrorInvalidValue;
  if (fold && kv_store != kInt8) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (body == 1) {
    if (dtype == kFloat32) return (int)cudaErrorInvalidValue;
    const int rows = Hq / Hkv;
    split::Args a{};
    a.q = q;
    a.k = kpool;
    a.v = vpool;
    a.kscale = static_cast<const float*>(kscale);
    a.vscale = static_cast<const float*>(vscale);
    a.table = static_cast<const int*>(table);
    a.lengths = static_cast<const int*>(lengths);
    a.starts = static_cast<const int*>(starts);
    a.o = o;
    a.lse = static_cast<float*>(lse);
    a.ws = static_cast<float*>(ws);
    a.counters = static_cast<int*>(counters);
    a.B = B;
    a.Hq = Hq;
    a.Hkv = Hkv;
    a.rows = rows;
    a.groups = (rows + split::kRows - 1) / split::kRows;
    a.splits = splits;
    a.num_pages = num_pages;
    a.page_size = page_size;
    a.width = width;
    a.spread = spread;
    a.scale = scale;
    return (int)split::run(a, true, kv_store, fold != 0, dtype, D, st);
  }
  if (body != 0) return (int)cudaErrorInvalidValue;
  const paged::Args a{q, kpool, vpool, static_cast<const float*>(kscale),
                      static_cast<const float*>(vscale),
                      static_cast<const int*>(table),
                      static_cast<const int*>(lengths),
                      static_cast<const int*>(starts), o,
                      static_cast<float*>(lse), B, Hq, Hkv, num_pages,
                      page_size, width, spread, scale, st};
  if (dtype == kFloat32) {
    if (kv_store == kE4M3 || kv_store == kE5M2)
      return (int)paged::dispatch_f32_fp8(a, D, kv_store);
    return (int)paged::dispatch_f32(a, D, kv_store, fold != 0);
  }
  // fp16 / bf16 on the first body: dense pools of a page size the split
  // body cannot walk.
  if (kv_store != kDense) return (int)cudaErrorInvalidValue;
  return (int)paged::dispatch<kDense, false>(a, dtype, D);
}
