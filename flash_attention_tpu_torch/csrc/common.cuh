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

}  // namespace fa

extern "C" const char* fa_error_string(int code);
