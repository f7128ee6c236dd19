// B4's first body (paged_decode.cu): one 256-thread block per (kv head,
// sequence) over the FFMA body in decode_core.cuh, instantiated per
// window flag, K/V storage, fold flag, compute type, head dim and row
// bound. It runs an fp32 q (paged_decode_f32.cu, paged_decode_f32_fp8.cu)
// and fp16 / bf16 over dense pools whose page size the split body cannot
// walk (not a multiple of 16; paged_decode.cu); every other fp16 / bf16
// launch runs the split body (decode_sm90.cuh).
#pragma once

#include "decode_core.cuh"

namespace fa {
namespace paged {

using decode::kThreads;

struct Args {
  const void* q;            // [B, Hq, D] in T
  const void* kpool;        // [Hkv, P, ps, D] in the storage
  const void* vpool;
  const float* kscale;      // [Hkv, P, ps / 128, D], null when dense
  const float* vscale;
  const int* table;         // [B, width]
  const int* lengths;       // [B]
  const int* starts;        // [B] window starts, or null
  void* o;                  // [B, Hq, D] in T
  float* lse;               // [B, Hq]
  int B, Hq, Hkv, num_pages, page_size, width, spread;
  float scale;
  cudaStream_t stream;
};

template <bool Windowed, int Store, bool Fold, typename T, int D, int R>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const Args a) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int rows = a.Hq / a.Hkv;
  const int len = a.lengths[b];
  const int start = Windowed ? a.starts[b] : 0;
  const int n_pages = min((len + a.page_size - 1) / a.page_size, a.width);
  const size_t qrow0 = (size_t)b * a.Hq + (size_t)h * rows;
  const decode::PagedChunks pages{
      a.table + (size_t)b * a.width, (size_t)h * a.num_pages,
      (size_t)a.page_size * D,
      (size_t)(a.page_size / decode::kQuantBlock) * D};
  // Groups of at most R rows (more rows than R take several).
  for (int r0 = 0; r0 < rows; r0 += R) {
    if (r0 > 0) __syncthreads();   // the last group's reduction is read
    decode::attend<Windowed, Store, Fold, T, D, R>(
        static_cast<const T*>(a.q) + (qrow0 + r0) * D, a.kpool, a.vpool,
        a.kscale, a.vscale, pages, len, n_pages, a.page_size,
        min(R, rows - r0), r0, a.scale, start, Windowed ? a.spread : 1,
        static_cast<T*>(a.o) + (qrow0 + r0) * D, a.lse + qrow0 + r0);
  }
}

// Windowed: starts != nullptr (the other instantiation has no mask).
template <int Store, bool Fold, typename T, int D, int R>
cudaError_t launch(const Args& a) {
  const size_t bytes = decode::smem_bytes<D, R, Fold>(a.page_size);
  auto kernel = a.starts != nullptr
                    ? paged_decode_kernel<true, Store, Fold, T, D, R>
                    : paged_decode_kernel<false, Store, Fold, T, D, R>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.Hkv, a.B), kThreads, bytes, a.stream>>>(a);
  return cudaGetLastError();
}

// R: 4 for at most 4 rows (the serving models' group of 4), else 16;
// more rows run in groups of 16 (paged_decode_kernel).
template <int Store, bool Fold, typename T, int D>
cudaError_t dispatch_rows(const Args& a) {
  if (a.Hq / a.Hkv <= 4) return launch<Store, Fold, T, D, 4>(a);
  return launch<Store, Fold, T, D, 16>(a);
}

template <int Store, bool Fold, typename T>
cudaError_t dispatch_d(const Args& a, int D) {
  if (D == 128) return dispatch_rows<Store, Fold, T, 128>(a);
  if (D == 64) return dispatch_rows<Store, Fold, T, 64>(a);
  if (D == 256) return dispatch_rows<Store, Fold, T, 256>(a);
  if (D == 32) return dispatch_rows<Store, Fold, T, 32>(a);
  return cudaErrorInvalidValue;
}

template <int Store, bool Fold>
cudaError_t dispatch(const Args& a, int dtype, int D) {
  if (dtype == kBFloat16) return dispatch_d<Store, Fold, __nv_bfloat16>(a, D);
  if (dtype == kFloat16) return dispatch_d<Store, Fold, __half>(a, D);
  return cudaErrorInvalidValue;
}

// Defined in paged_decode_f32.cu (dense fp32 and int8 pools) and
// paged_decode_f32_fp8.cu (e4m3 / e5m2 pools): an fp32 q.
cudaError_t dispatch_f32(const Args& a, int D, int store, bool fold);
cudaError_t dispatch_f32_fp8(const Args& a, int D, int store);

}  // namespace paged
}  // namespace fa
