// Shared helpers for the port's CUDA kernels (built for sm_90a).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fa {

// dtype codes passed from Python (ops/_cuda.py DTYPE_CODES; fp32 only
// for the kernels that have it, FP32_DTYPE_CODES).
constexpr int kFloat16 = 0;
constexpr int kBFloat16 = 1;
constexpr int kFloat32 = 2;

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
__device__ __forceinline__ float to_float<float>(float x) {
  return x;
}
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
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
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

// 8 int8 / fp8 codes to exact floats, the values of widen8 in fewer
// instructions (the converter warps of B1 and matmul_sm90.cuh): int8 by
// placing code + 128 in the mantissa of 2^23 (byte permute, one
// subtraction), fp8 two at a time through fp16 (exact for every finite
// e4m3 / e5m2 code).
template <int Store>
__device__ __forceinline__ void widen8_fast(const uint2& raw, float* x) {
  if constexpr (Store == kInt8) {
    const uint32_t w[2] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u};
#pragma unroll
    for (int i = 0; i < 8; ++i)
      x[i] = __uint_as_float(__byte_perm(w[i / 4], 0x4B000000u,
                                         0x7440u + (i % 4))) -
             8388736.f;
  } else {
    constexpr __nv_fp8_interpretation_t kind =
        Store == kE4M3 ? __NV_E4M3 : __NV_E5M2;
    const uint32_t w[2] = {raw.x, raw.y};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
          static_cast<__nv_fp8x2_storage_t>(w[i / 2] >> (16 * (i % 2))),
          kind);
      const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&h));
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
}

// dst[0, N) = src[0, N) * mul in T (N a multiple of 8; 16-byte stores).
template <typename T, int N>
__device__ __forceinline__ void store_scaled(T* dst, const float* src,
                                             float mul) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int d = 0; d < N; d += 4)
      *reinterpret_cast<float4*>(dst + d) =
          make_float4(src[d] * mul, src[d + 1] * mul, src[d + 2] * mul,
                      src[d + 3] * mul);
  } else {
#pragma unroll
    for (int d = 0; d < N; d += 8) {
      float vals[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) vals[i] = src[d + i] * mul;
      *reinterpret_cast<uint4*>(dst + d) = pack8<T>(vals);
    }
  }
}

// x rounded to T and back: the compute-type rounding of a dequantized
// value (the JAX kernels' `.astype(compute_dtype)` before the product).
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float<T>(from_float<T>(x));
}

}  // namespace fa

extern "C" const char* fa_error_string(int code);
