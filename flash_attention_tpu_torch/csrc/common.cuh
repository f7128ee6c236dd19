// Shared helpers for the port's CUDA kernels (built for sm_90a).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fa {

// dtype codes passed from Python (ops/_cuda.py DTYPE_CODES).
constexpr int kFloat16 = 0;
constexpr int kBFloat16 = 1;

// Storage codes of the values a kernel reads (ops/_cuda.py STORE_CODES):
// the compute type itself, int8, fp8 e4m3, fp8 e5m2.
constexpr int kDense = 0;
constexpr int kInt8 = 1;
constexpr int kE4M3 = 2;
constexpr int kE5M2 = 3;

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

// One int8 / fp8 code to float32: exact on every int8 value and every
// finite fp8 code (the card's native e4m3 / e5m2 conversions). The JAX
// package's bit-plant widening (ops/quant.py tile_to_f32) gives the same
// values; quantization never emits NaN / inf codes.
template <int W>
__device__ __forceinline__ float widen(unsigned char b);
template <>
__device__ __forceinline__ float widen<kInt8>(unsigned char b) {
  return static_cast<float>(static_cast<signed char>(b));
}
template <>
__device__ __forceinline__ float widen<kE4M3>(unsigned char b) {
  __nv_fp8_e4m3 v;
  v.__x = b;
  return static_cast<float>(v);
}
template <>
__device__ __forceinline__ float widen<kE5M2>(unsigned char b) {
  __nv_fp8_e5m2 v;
  v.__x = b;
  return static_cast<float>(v);
}

// 8 bytes = 8 int8 / fp8 codes -> 8 floats.
template <int W>
__device__ __forceinline__ void widen8(const uint2& raw, float* out) {
  const unsigned char* b = reinterpret_cast<const unsigned char*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = widen<W>(b[i]);
}

// x rounded to T and back: the compute-type rounding of a dequantized
// value (the JAX kernels' `.astype(compute_dtype)` before the product).
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float<T>(from_float<T>(x));
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
