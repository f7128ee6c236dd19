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
// and LSE = INIT_M * scale, which every LSE merge weights 0.
// Ragged Nq and Nk are masked here: tile rows past the end load as zeros
// and are never stored, so the host pads nothing.
//
// What bounds it on the H100: at the prefill shapes (T = 512..1024, 16
// q heads, D = 128) the causal work is 2*Hq*T^2*D FLOPs against
// 2*(2*Hq + 2*Hkv)*T*D bytes -- about 300 FLOPs/byte at T = 1000, so the
// tensor cores, not HBM, are the limit beyond T ~ 1000. The design keeps
// every product on the tensor cores (WMMA 16x16x16 with fp32
// accumulation) and every intermediate (S, P, the running O) in shared
// memory, so HBM sees each Q/K/V row once per q tile and O once. The
// kv loop starts at the first tile inside the window of the tile's first
// row (_first_window_block, flash.py:160) and stops at the causal limit
// of its last row, so skipped tiles cost nothing: windowed prefill reads
// O(window) K/V rows per q tile, not O(Nk). Segment ids are read per K/V
// tile into shared memory beside it.
//
// Layout: one 128-thread block (4 warps) per (q tile of 64 rows, q head,
// batch). Q fragments stay in registers; 64-row K/V tiles stream through
// shared memory. Warp w owns S/P/O rows 16w..16w+15 and thread pair
// (2r, 2r+1) owns the softmax statistics of row r, so after each K/V
// tile lands only warp-level synchronisation is needed. The softmax is
// the textbook exp2 recurrence with the scale folded into the exp2
// constant; m, l and O stay in fp32, P is rounded to the input dtype for
// the PV product (the JAX kernel's numerics).
//
// Quantized K/V (the TPU kernel's `quantized` branch with
// `_dequant_tile`, flash.py:244-255, :303-304; the entry point is
// flash_attention_quantized): codes [B, Hkv, Nk, D] in int8 / e4m3 / e5m2
// with fp32 scales [B, Hkv, Nk / 128, D]. The K/V tile loader reads each
// row's codes (8 bytes per 8 values), widens them in registers, multiplies
// by the scale row of the row's 128-token block (scales[b, hk, row / 128,
// :]) in fp32 and stores the product rounded to T into the shared-memory
// tile that the WMMA loop reads, as the JAX kernel rounds the dequantized
// tile to the compute dtype. Nothing else in the body changes; a 64-row
// tile lies inside one 128-row scale block. The storages compile in
// flash_fwd_quant.cu, apart from the dense instantiations here.
//
// fp32 inputs (flash_fwd_f32.cu; the JAX kernel runs fp32 at
// Precision.HIGHEST, flash.py:92-101): dense K/V only. Both products run
// in full fp32 on the CUDA cores (common.cuh ffma_abt / ffma_ab, no TF32)
// on the same softmax body; P stays fp32. 64-row fp32 tiles at D = 256
// would not fit shared memory, so there the q tile is 32 rows (Smem<T,
// D>::kBQ).
//
// The causal split (the TPU kernel's strict_below / diag_band branches,
// flash.py:122-132, :271-278, driven by flash_attention_fwd_split :664):
// two launches, each a loop bound in the same body. The bulk pass
// (split = 1, non-causal) ends each q tile's kv loop at (q0 / band) *
// band, so it runs mask-free tiles only; the band pass (split = 2,
// causal) covers [(q0 / band) * band, + band). The LSE merge of the two
// is elementwise PyTorch (ops/flash.py), as the JAX package does it
// outside its kernel. Rows with no bulk column export LSE = INIT_M *
// scale and weigh 0 in the merge.
//
// A fast version (TMA loads, wgmma, a producer warp and double-buffered
// tiles) is later work; this one is simple and right first.

#include "flash_fwd.cuh"

// kv_store: common.cuh kDense / kInt8 / kE4M3 / kE5M2; kscale / vscale
// null for dense K/V (Nk a multiple of 128 otherwise). split: 0, or the
// bulk (1, non-causal) or band (2, causal) pass of the causal split,
// band a multiple of 64 (the q tile).
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
  if (kv_store == kDense) return (int)fwd::dispatch<kDense>(a, dtype, D);
  return (int)fwd::dispatch_quant(a, dtype, D, kv_store);
}

extern "C" const char* fa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
