// The first-body kernels of B6-B8 (quant_matmul.cu) and B9
// (grouped_matmul.cu) over matmul_core.cuh, with their launchers,
// instantiated per activation type (fp16, bf16) and weight storage in
// those two sources: the launches of fp16 / bf16 operands TMA cannot
// address. Every other fp16 / bf16 launch runs matmul_sm90.cuh, every
// fp32 launch matmul_f32.cuh.
#pragma once

#include "matmul_core.cuh"

namespace fa_mm {

// B6 / B7 / B8: one 128-thread block per 64 x 64 tile of y.
template <typename T, int W>
__global__ void __launch_bounds__(kThreads)
quant_matmul_kernel(const T* __restrict__ x,
                    const unsigned char* __restrict__ w,
                    const float* __restrict__ scale, T* __restrict__ y,
                    int M, int K, int F, int x_vec, int w_vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int f0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  Sums<T> acc;
  acc.zero(smem);
  accumulate_tile<T, W, false>(x, w, scale, 0, M, K, F, m0, f0, x_vec,
                               w_vec, smem, acc);
  store_tile<T>(acc, smem, y, channel_scaled<W>() ? scale : nullptr, M, F,
                m0, f0);
}

template <typename T, int W>
cudaError_t launch_quant(const void* x, const void* w, const void* scale,
                         void* y, int M, int K, int F, cudaStream_t stream) {
  constexpr size_t kBytes = Tile<T>::kBytes;
  cudaError_t err = allow_smem(quant_matmul_kernel<T, W>, kBytes);
  if (err != cudaSuccess) return err;
  dim3 grid((F + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  quant_matmul_kernel<T, W><<<grid, kThreads, kBytes, stream>>>(
      static_cast<const T*>(x), static_cast<const unsigned char*>(w),
      static_cast<const float*>(scale), static_cast<T*>(y), M, K, F,
      (int)x_aligned<T>(x, K), (int)w_aligned<T, W>(w, F));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_quant(const void* x, const void* w, const void* scale,
                           void* y, int M, int K, int F, int weight,
                           cudaStream_t stream) {
  switch (weight) {
    case kDense:
      return launch_quant<T, kDense>(x, w, scale, y, M, K, F, stream);
    case kInt8:
      return launch_quant<T, kInt8>(x, w, scale, y, M, K, F, stream);
    case kE4M3:
      return launch_quant<T, kE4M3>(x, w, scale, y, M, K, F, stream);
    case kE5M2:
      return launch_quant<T, kE5M2>(x, w, scale, y, M, K, F, stream);
    case kInt4:
      return launch_quant<T, kInt4>(x, w, scale, y, M, K, F, stream);
  }
  return cudaErrorInvalidValue;
}

// B9: one 128-thread block per 64 x 64 tile of y; the experts whose rows
// meet the tile sum into one set of sums.
template <typename T, int W>
__global__ void __launch_bounds__(kThreads)
grouped_matmul_kernel(const T* __restrict__ x,
                      const unsigned char* __restrict__ w,
                      const float* __restrict__ scale,
                      const int* __restrict__ offsets, T* __restrict__ y,
                      int M, int K, int F, int E, int x_vec, int w_vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int f0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int tile_end = min(m0 + kBM, M);
  // One expert's weight and scale strides.
  const size_t w_expert =
      (size_t)(W == kInt4 ? K / 2 : K) * F * weight_bytes<T, W>();
  const size_t s_expert = W == kInt4 ? (size_t)(K / kGroup) * F : (size_t)F;

  Sums<T> acc;
  acc.zero(smem);
  for (int e = 0; e < E; ++e) {
    // Uniform across the block: every thread reads the same offsets.
    const int lo = max(__ldg(offsets + e), m0);
    const int hi = min(__ldg(offsets + e + 1), tile_end);
    if (lo >= hi) continue;
    accumulate_tile<T, W, true>(
        x, w + e * w_expert, W == kDense ? nullptr : scale + e * s_expert,
        lo, hi, K, F, m0, f0, x_vec, w_vec, smem, acc);
  }
  store_tile<T>(acc, smem, y, nullptr, M, F, m0, f0);
}

template <typename T, int W>
cudaError_t launch_grouped(const void* x, const void* w, const void* scale,
                           const int* offsets, void* y, int M, int K, int F,
                           int E, cudaStream_t stream) {
  constexpr size_t kBytes = Tile<T>::kBytes;
  cudaError_t err = allow_smem(grouped_matmul_kernel<T, W>, kBytes);
  if (err != cudaSuccess) return err;
  dim3 grid((F + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  grouped_matmul_kernel<T, W><<<grid, kThreads, kBytes, stream>>>(
      static_cast<const T*>(x), static_cast<const unsigned char*>(w),
      static_cast<const float*>(scale), offsets, static_cast<T*>(y), M, K,
      F, E, (int)x_aligned<T>(x, K), (int)w_aligned<T, W>(w, F));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_grouped(const void* x, const void* w, const void* scale,
                             const int* offsets, void* y, int M, int K,
                             int F, int E, int weight, cudaStream_t stream) {
  switch (weight) {
    case kDense:
      return launch_grouped<T, kDense>(x, w, scale, offsets, y, M, K, F, E,
                                       stream);
    case kInt8:
      return launch_grouped<T, kInt8>(x, w, scale, offsets, y, M, K, F, E,
                                      stream);
    case kE4M3:
      return launch_grouped<T, kE4M3>(x, w, scale, offsets, y, M, K, F, E,
                                      stream);
    case kE5M2:
      return launch_grouped<T, kE5M2>(x, w, scale, offsets, y, M, K, F, E,
                                      stream);
    case kInt4:
      return launch_grouped<T, kInt4>(x, w, scale, offsets, y, M, K, F, E,
                                      stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace fa_mm
