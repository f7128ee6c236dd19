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
// read; a length-0 row gives O = 0 (the TPU kernel's l_safe). The
// quantized (int8 / fp8) and windowed branches of the TPU kernel arrive
// with their slices; the wrapper raises on them.
//
// What bounds it on the H100: bytes, as for B4. Each live position's K
// and V rows are read once per kv head (4*D bytes per head in bf16) for
// 4*G*D FLOPs -- G/2 FLOPs per byte, far under the ~295 at which the
// tensor cores would be the limit. The design reads only the live prefix
// and reads it once for all G rows: one 256-thread block per (kv head,
// sequence) walks the prefix in chunks of 256 positions with 16-byte
// loads by neighbouring threads on neighbouring addresses, through the
// body B4 uses for its pages (decode_core.cuh; the products in fp32 on
// the CUDA cores, partial sums added in a fixed order).
//
// B * Hkv blocks are in flight (32 at the generate shape of 4 sequences
// and 8 kv heads, on 132 SMs); splitting a sequence's prefix across
// blocks with a merge pass is the fast shape and is later work.

#include "decode_core.cuh"

namespace {

using fa::decode::kThreads;

constexpr int kChunk = 256;     // positions per chunk

template <typename T, int D, int R>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ lengths,
              T* __restrict__ o, int Hq, int Hkv, int S, int rows,
              float scale) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int len = max(0, min(lengths[b], S));
  const int n_chunks = (len + kChunk - 1) / kChunk;
  const size_t qrow0 = (size_t)b * Hq + (size_t)h * rows;
  const fa::decode::ContiguousChunks chunks{
      ((size_t)b * Hkv + h) * (size_t)S * D, (size_t)kChunk * D};
  fa::decode::attend<T, D, R>(q + qrow0 * D, k, v, chunks, len, n_chunks,
                              kChunk, rows, scale, o + qrow0 * D, nullptr);
}

template <typename T, int D, int R>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lengths, void* o, int B, int Hq, int Hkv,
                   int S, int rows, float scale, cudaStream_t stream) {
  const size_t bytes = fa::decode::smem_bytes<D, R>(kChunk);
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<T, D, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(Hkv, B);
  decode_kernel<T, D, R><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(o), Hq, Hkv, S,
      rows, scale);
  return cudaGetLastError();
}

// R: the smallest instantiated row bound >= the GQA group
// (config.PAGED_MAX_ROWS is the largest).
template <typename T, int D>
cudaError_t dispatch_rows(const void* q, const void* k, const void* v,
                          const int* lengths, void* o, int B, int Hq,
                          int Hkv, int S, float scale, cudaStream_t stream) {
  const int rows = Hq / Hkv;
#define FA_DECODE_LAUNCH(RB)                                             \
  if (rows <= RB)                                                        \
    return launch<T, D, RB>(q, k, v, lengths, o, B, Hq, Hkv, S, rows,    \
                            scale, stream);
  FA_DECODE_LAUNCH(2)
  FA_DECODE_LAUNCH(4)
  FA_DECODE_LAUNCH(8)
  FA_DECODE_LAUNCH(16)
#undef FA_DECODE_LAUNCH
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_dim(const void* q, const void* k, const void* v,
                         const int* lengths, void* o, int B, int Hq, int Hkv,
                         int S, int D, float scale, cudaStream_t stream) {
  if (D == 128)
    return dispatch_rows<T, 128>(q, k, v, lengths, o, B, Hq, Hkv, S, scale,
                                 stream);
  if (D == 64)
    return dispatch_rows<T, 64>(q, k, v, lengths, o, B, Hq, Hkv, S, scale,
                                stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int fa_decode(const void* q, const void* k, const void* v,
                         const void* lengths, void* o, int B, int Hq,
                         int Hkv, int S, int D, float scale, int dtype,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ln = static_cast<const int*>(lengths);
  if (Hkv <= 0 || Hq % Hkv || S < 0) return (int)cudaErrorInvalidValue;
  if (dtype == fa::kBFloat16)
    return (int)dispatch_dim<__nv_bfloat16>(q, k, v, ln, o, B, Hq, Hkv, S,
                                            D, scale, s);
  if (dtype == fa::kFloat16)
    return (int)dispatch_dim<__half>(q, k, v, ln, o, B, Hq, Hkv, S, D,
                                     scale, s);
  return (int)cudaErrorInvalidValue;
}
