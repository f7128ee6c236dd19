// B5's first body (decode.cu), for an fp32 q: one 256-thread block per
// (kv head, sequence) over the FFMA body in decode_core.cuh, walking the
// contiguous cache in chunks of 256 positions; instantiated per window
// flag, K/V storage, head dim and row bound in decode_f32.cu. fp16 / bf16
// queries run the split body (decode_sm90.cuh).
#pragma once

#include "decode_core.cuh"

namespace fa {
namespace contiguous {

using decode::kThreads;

constexpr int kChunk = 256;     // positions per chunk (two scale rows)

struct Args {
  const void* q;            // [B, Hq, D] in T
  const void* k;            // [B, Hkv, S, D] in the storage
  const void* v;
  const float* kscale;      // [B, Hkv, S / 128, D], null when dense
  const float* vscale;
  const int* lengths;       // [B]
  void* o;                  // [B, Hq, D] in T
  int B, Hq, Hkv, S, window;
  float scale;
  cudaStream_t stream;
};

template <bool Windowed, int Store, typename T, int D, int R>
__global__ void __launch_bounds__(kThreads) decode_kernel(const Args a) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int rows = a.Hq / a.Hkv;
  const int len = max(0, min(a.lengths[b], a.S));
  const int start = Windowed ? len - a.window : 0;
  const int n_chunks = (len + kChunk - 1) / kChunk;
  const size_t qrow0 = (size_t)b * a.Hq + (size_t)h * rows;
  const size_t seq = (size_t)b * a.Hkv + h;
  const decode::ContiguousChunks chunks{
      seq * (size_t)a.S * D, (size_t)kChunk * D,
      seq * (size_t)(a.S / decode::kQuantBlock) * D,
      (size_t)(kChunk / decode::kQuantBlock) * D};
  // Groups of at most R rows (a GQA group wider than R takes several).
  for (int r0 = 0; r0 < rows; r0 += R) {
    if (r0 > 0) __syncthreads();   // the last group's reduction is read
    decode::attend<Windowed, Store, false, T, D, R>(
        static_cast<const T*>(a.q) + (qrow0 + r0) * D, a.k, a.v, a.kscale,
        a.vscale, chunks, len, n_chunks, kChunk, min(R, rows - r0), r0,
        a.scale, start, 1, static_cast<T*>(a.o) + (qrow0 + r0) * D,
        nullptr);
  }
}

// Windowed: window > 0 (the other instantiation has no mask).
template <int Store, typename T, int D, int R>
cudaError_t launch(const Args& a) {
  const size_t bytes = decode::smem_bytes<D, R, false>(kChunk);
  auto kernel = a.window > 0 ? decode_kernel<true, Store, T, D, R>
                             : decode_kernel<false, Store, T, D, R>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.Hkv, a.B), kThreads, bytes, a.stream>>>(a);
  return cudaGetLastError();
}

// R: 4 for a GQA group of at most 4 rows, else 16; a wider group runs
// in groups of 16 (decode_kernel).
template <int Store, typename T, int D>
cudaError_t dispatch_rows(const Args& a) {
  if (a.Hq / a.Hkv <= 4) return launch<Store, T, D, 4>(a);
  return launch<Store, T, D, 16>(a);
}

template <int Store, typename T>
cudaError_t dispatch_d(const Args& a, int D) {
  if (D == 128) return dispatch_rows<Store, T, 128>(a);
  if (D == 64) return dispatch_rows<Store, T, 64>(a);
  if (D == 256) return dispatch_rows<Store, T, 256>(a);
  if (D == 32) return dispatch_rows<Store, T, 32>(a);
  return cudaErrorInvalidValue;
}

// Defined in decode_f32.cu: an fp32 q over any storage.
cudaError_t dispatch_f32(const Args& a, int D, int store);

}  // namespace contiguous
}  // namespace fa
