// B1: flash attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel flash_attention_tpu/ops/flash.py
// `_fwd_kernel` (flash.py:259, launched at :631) on the port's serving
// path (prefill, one launch per layer; chunked prefill, two per layer)
// and training forward.
//
// Computes O = softmax(scale * Q K^T) V per (batch, q-head) with an
// online softmax, and exports LSE [B, Hq, Nq] in fp32. GQA maps q head h
// to kv head h / (Hq / Hkv). The masks of the TPU kernel's _mask_block
// (flash.py:201-236) combine: causal hides col > row + offset, a sliding
// window (window > 0, causal only) hides col <= row + offset - window,
// segment ids (qseg [B, Nq], kvseg [B, Nk], both or neither) hide pairs
// whose ids differ. offset may exceed Nk - Nq (the rolling-buffer
// prefill passes offset = Nk). A row that sees nothing exports O = 0
// and LSE = INIT_M * scale, which every LSE merge weights 0. Ragged Nq
// and Nk need no host padding: the tensor maps are 3-D per head, so
// tile rows past a head's end read as zeros, and rows past Nq are never
// stored.
//
// What bounds it on the H100: causal prefill and training do 2 Hq T^2 D
// FLOPs against 2 (2 Hq + 2 Hkv) T D bytes, some 300 FLOPs a byte at T =
// 1000 and 2500 at T = 8192, so the tensor cores (989 TFLOP/s) are the
// limit, and next to them the 16 exp2 a clock of an SM's special
// function units (one per score) and the L2 traffic of re-reading each
// K/V tile once per q tile. The design (sm90_attn.cuh holds its shared
// pieces):
// - Both products are wgmma with fp32 accumulators in registers: S = Q
//   K^T (m64 x kBC x 16, Q and K from swizzled shared memory) and O += P
//   V (m64 x D x 16, P from registers in the accumulator's own layout, V
//   MN-major as stored). Nothing of S, P or O touches shared memory.
// - A block is two consumer warpgroups of 64 q rows (128 rows a block,
//   so each K/V tile read from L2 feeds 128 rows) and one producer warp,
//   whose one thread keeps a 2-stage ring of 128-row K/V tiles in flight
//   with TMA and full / empty mbarriers, so loads overlap the products.
//   Such a block gets 168 registers a thread; at D = 256 (O alone is 128
//   registers) a block is one consumer warpgroup with 64-row K/V tiles.
// - The softmax runs on the accumulator fragment: a row lies on the 4
//   threads of a quad, so its max is two shuffles; m and the row sum l
//   are fp32, O is rescaled by alpha in registers, P is rounded to T in
//   registers (the JAX kernel's numerics), exp2 with the scale folded
//   in. O is normalised by 1 / l at the end.
// - Masks are selects on the score registers, applied only to tiles
//   that need them: the causal diagonal, a window edge, segment ids, a
//   split bound, the ragged Nk tail. The kv loop runs from the first
//   tile inside the window of the block's first row
//   (_first_window_block, flash.py:160) to the causal limit of its last
//   row, so windowed prefill reads O(window) K/V rows a q tile; each
//   consumer warpgroup skips the tiles outside its own rows' range.
// - The last q tiles (the longest causal rows) launch first.
//
// Quantized K/V (the TPU kernel's `quantized` branch with
// `_dequant_tile`, flash.py:244-255, :303-304; the entry point is
// flash_attention_quantized): codes [B, Hkv, Nk, D] in int8 / e4m3 /
// e5m2 with fp32 scales [B, Hkv, Nk / 128, D]. The 1-byte codes arrive
// by TMA in a ring of their own; four converter warps in place of the
// producer warp (their thread 0 issues the loads) widen each code times
// the scale row of its 128-row block (read once a tile) in fp32, round
// to T and store the swizzled T tile the products read -- the rounding
// of the plain
// version's dequantized tile, as the JAX kernel rounds the dequantized
// tile to the compute dtype. The conversion runs beside the consumers'
// products, a tile ahead. The storages compile in flash_fwd_int8.cu,
// flash_fwd_e4m3.cu and flash_fwd_e5m2.cu, the dense instantiations
// here.
//
// fp32 inputs: flash_fwd_f32.cu (full fp32 on the CUDA cores; wgmma has
// no fp32 operand at Precision.HIGHEST). A dtype selects its body; no
// path leads from a failed launch to another.
//
// The causal split (the TPU kernel's strict_below / diag_band branches,
// flash.py:122-132, :271-278, driven by flash_attention_fwd_split :664):
// two launches, each a column range in the same body. The bulk pass
// (split = 1, non-causal) stops each 64-row q tile at (q0 / band) *
// band, so it runs mask-free tiles except where that bound cuts a tile;
// the band pass (split = 2, causal) covers [(q0 / band) * band, + band).
// The two consumer warpgroups of a block may lie in different bands
// (band 64): each keeps its own range and masks the columns outside it.
// The LSE merge of the two is elementwise PyTorch (ops/flash.py), as the
// JAX package does it outside its kernel. Rows with no bulk column
// export LSE = INIT_M * scale and weigh 0 in the merge.

#include "flash_fwd.cuh"

// kv_store: common.cuh kDense / kInt8 / kE4M3 / kE5M2; kscale / vscale
// null for dense K/V (Nk a multiple of 128 otherwise). split: 0, or the
// bulk (1, non-causal) or band (2, causal) pass of the causal split,
// band a multiple of 64.
extern "C" int fa_flash_fwd(const void* q, const void* k, const void* v,
                            const void* kscale, const void* vscale,
                            void* o, void* lse, const void* qseg,
                            const void* kvseg, int B, int Hq, int Hkv,
                            int Nq, int Nk, int D, int causal, int offset,
                            int window, int split, int band, float scale,
                            int dtype, int kv_store, void* stream) {
  using namespace fa;
  if (Hkv <= 0 || Hq % Hkv || (qseg == nullptr) != (kvseg == nullptr) ||
      (window > 0 && !causal))
    return (int)cudaErrorInvalidValue;
  if (kv_store != kDense &&
      (kscale == nullptr || vscale == nullptr || Nk % 128))
    return (int)cudaErrorInvalidValue;
  if (split != 0 &&
      (band <= 0 || band % 64 || window > 0 || qseg != nullptr ||
       (split == fwd::kSplitBulk) == (causal != 0) ||
       (split != fwd::kSplitBulk && split != fwd::kSplitBand)))
    return (int)cudaErrorInvalidValue;
  const fwd::Args a{q, k, v, static_cast<const float*>(kscale),
                    static_cast<const float*>(vscale), o,
                    static_cast<float*>(lse),
                    static_cast<const int*>(qseg),
                    static_cast<const int*>(kvseg), B, Hq, Hkv, Nq, Nk,
                    causal, offset, window, split, band, scale,
                    static_cast<cudaStream_t>(stream)};
  if (dtype == kFloat32)
    return (int)(kv_store == kDense ? fwd::dispatch_f32(a, D)
                                    : cudaErrorInvalidValue);
  switch (kv_store) {
    case kDense:
      return (int)fwd::dispatch<kDense>(a, dtype, D);
    case kInt8:
      return (int)fwd::dispatch_int8(a, dtype, D);
    case kE4M3:
      return (int)fwd::dispatch_e4m3(a, dtype, D);
    case kE5M2:
      return (int)fwd::dispatch_e5m2(a, dtype, D);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* fa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
