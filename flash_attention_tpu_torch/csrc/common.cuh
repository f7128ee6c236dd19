// Shared helpers for the port's CUDA kernels (built for sm_90a).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fa {

// dtype codes passed from Python (ops/_cuda.py DTYPE_CODES).
constexpr int kFloat16 = 0;
constexpr int kBFloat16 = 1;

// Running-max initializer; a row that sees no key exports O = 0 and
// LSE = INIT_M * scale (finite, weighted 0 by every LSE merge).
constexpr float kInitM = -1e37f;
constexpr float kLog2e = 1.4426950408889634f;

template <typename T>
__device__ __forceinline__ float to_float(T x);
template <>
__device__ __forceinline__ float to_float<__half>(__half x) {
  return __half2float(x);
}
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half_rn(x);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// 16 bytes = 8 half-width values <-> 8 floats.
template <typename T>
__device__ __forceinline__ void unpack8(const uint4& raw, float* out) {
  const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = to_float<T>(v[i]);
}

template <typename T>
__device__ __forceinline__ uint4 pack8(const float* in) {
  uint4 raw;
  T* v = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = from_float<T>(in[i]);
  return raw;
}

// Rows [r0, r0 + kRows) of a row-major [n, D] matrix into shared memory
// (row stride ld elements) with 16-byte loads by kThreads threads; rows
// past n are written as zeros, so ragged edges need no host padding.
template <typename T, int D, int kRows, int kThreads>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src,
                                          int r0, int n, int tid) {
  constexpr int kVecPerRow = D / 8;
  for (int i = tid; i < kRows * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < n)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

}  // namespace fa

extern "C" const char* fa_error_string(int code);
