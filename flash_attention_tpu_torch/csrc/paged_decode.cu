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
// qpos_spread, paged.py:62-66, :124-130). Pages entirely below starts[b]
// are never read, so windowed decode reads O(window) bytes, not
// O(length).
//
// What bounds it on the H100: bytes. Each live token's K and V rows are
// read once per kv head (4*Hkv*D bytes per token in bf16) and do 4*R*D
// FLOPs, about R/2 FLOPs per byte -- far under the ~295 FLOPs per byte
// at which the tensor cores would become the limit. The design therefore
// reads only what is live and reads it once: the block walks only the
// ceil(lengths[b] / page_size) live entries of page_table[b] (never the
// table width, whose tail points at a scratch page), from the first page
// that holds a position inside the window, reads each page's
// [page_size, D] K and V rows once for up to 16 query rows (more rows
// walk the pages once per group of 16, inside the same launch), with
// 16-byte loads by neighbouring threads on neighbouring addresses, four
// tokens' loads in flight per thread. The products run on the CUDA cores
// in fp32; tensor cores would buy nothing at 16 rows.
//
// Layout: one block of 256 threads per (kv head, sequence), walking the
// sequence page by page through the body it shares with B5
// (decode_core.cuh: scores, online softmax and PV product per page,
// partial sums added in a fixed order, so results are deterministic).
//
// Quantized pools (the TPU kernel's int8 / fp8 branch and its int8
// fold_scales body, paged.py:73-115, :135-168): codes [Hkv, P, ps, D] in
// int8 / e4m3 / e5m2 with fp32 scales [Hkv, P, ps / 128, D]; the scale
// row of position pos of page p is scales[h, p, (pos % ps) / 128, :].
// They halve the bytes per token (2*Hkv*D codes + 8*Hkv*D/128 scale
// bytes against 4*Hkv*D in bf16) and add a widening per value; see
// decode_core.cuh for the two bodies. The storages compile in their own
// sources (paged_decode_int8.cu, paged_decode_fp8.cu), so the build runs
// them in parallel and the dense instantiations below are as before.
//
// q may be fp16, bf16 or fp32 (dense pools then in q's dtype); the fp32
// instantiations compile in paged_decode_f32.cu and
// paged_decode_f32_fp8.cu.
//
// Few blocks (B * Hkv) are in flight at small batch; splitting the pages
// of a sequence across blocks with a merge pass is the fast shape and is
// later work.

#include "paged_decode.cuh"

// kv_store: common.cuh kDense / kInt8 / kE4M3 / kE5M2; kscale / vscale
// null for dense pools; fold (int8 only) takes the fold_scales body.
extern "C" int fa_paged_decode(const void* q, const void* kpool,
                               const void* vpool, const void* kscale,
                               const void* vscale, const void* table,
                               const void* lengths, const void* starts,
                               void* o, void* lse, int B, int Hq, int Hkv,
                               int num_pages, int page_size, int width,
                               int D, int spread, float scale, int dtype,
                               int kv_store, int fold, void* stream) {
  using namespace fa;
  if (Hkv <= 0 || Hq % Hkv || page_size <= 0 || width <= 0 || spread < 1 ||
      (Hq / Hkv) % spread)
    return (int)cudaErrorInvalidValue;
  const bool quant = kv_store != kDense;
  if (quant && (kscale == nullptr || vscale == nullptr ||
                page_size % decode::kQuantBlock))
    return (int)cudaErrorInvalidValue;
  if (fold && kv_store != kInt8) return (int)cudaErrorInvalidValue;
  const paged::Args a{q, kpool, vpool, static_cast<const float*>(kscale),
                      static_cast<const float*>(vscale),
                      static_cast<const int*>(table),
                      static_cast<const int*>(lengths),
                      static_cast<const int*>(starts), o,
                      static_cast<float*>(lse), B, Hq, Hkv, num_pages,
                      page_size, width, spread, scale,
                      static_cast<cudaStream_t>(stream)};
  if (dtype == kFloat32) {
    if (kv_store == kE4M3 || kv_store == kE5M2)
      return (int)paged::dispatch_f32_fp8(a, D, kv_store);
    return (int)paged::dispatch_f32(a, D, kv_store, fold != 0);
  }
  switch (kv_store) {
    case kDense:
      return (int)paged::dispatch<kDense, false>(a, dtype, D);
    case kInt8:
      return (int)paged::dispatch_int8(a, dtype, D, fold != 0);
    case kE4M3:
    case kE5M2:
      return (int)paged::dispatch_fp8(a, dtype, D, kv_store);
  }
  return (int)cudaErrorInvalidValue;
}
