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

// Rows [r0, r0 + kRows) of a row-major [n, D] matrix into shared memory
// (row stride ld elements, a multiple of 16 bytes) with 16-byte loads by
// kThreads threads; rows past n are written as zeros, so ragged edges
// need no host padding.
template <typename T, int D, int kRows, int kThreads>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src,
                                          int r0, int n, int tid) {
  constexpr int kVec = 16 / sizeof(T);   // elements per 16-byte load
  constexpr int kVecPerRow = D / kVec;
  for (int i = tid; i < kRows * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * kVec;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < n)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// fp32 tile products on the CUDA cores (FFMA, full fp32: no TF32), for
// the kernels' fp32 instantiations, where the JAX kernels ask the MXU for
// Precision.HIGHEST. One warp computes a [16, N] block of C from A rows
// [16, K] in shared memory: lane l owns rows l / 8 + 4 i (i < 4) and
// columns l % 8 + 8 j, so the four row reads of a step hit four banks and
// each product is a sequential fp32 sum over k. Columns go in chunks of
// at most 64 (32 accumulators a lane).

// C[16, N] = A[16, K] B^T, B [N, K] row-major (scores Q K^T).
template <int N, int K>
__device__ __forceinline__ void ffma_abt(float* c, int ldc, const float* a,
                                         int lda, const float* b, int ldb,
                                         int lane) {
  constexpr int kNC = N < 64 ? N : 64;
  const int r0 = lane >> 3, c0 = lane & 7;
  for (int n0 = 0; n0 < N; n0 += kNC) {
    float acc[4][kNC / 8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kNC / 8; ++j) acc[i][j] = 0.f;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      float av[4], bv[kNC / 8];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = a[(r0 + 4 * i) * lda + k];
#pragma unroll
      for (int j = 0; j < kNC / 8; ++j)
        bv[j] = b[(n0 + c0 + 8 * j) * ldb + k];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kNC / 8; ++j)
          acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kNC / 8; ++j)
        c[(r0 + 4 * i) * ldc + n0 + c0 + 8 * j] = acc[i][j];
  }
}

// C[16, N] = alpha_r C + beta_r (A[16, K] B), B [K, N] row-major (P V);
// alpha, beta: the warp's 16 per-row factors, or null for 1 (C += A B).
template <int N, int K>
__device__ __forceinline__ void ffma_ab(float* c, int ldc, const float* a,
                                        int lda, const float* b, int ldb,
                                        const float* alpha,
                                        const float* beta, int lane) {
  constexpr int kNC = N < 64 ? N : 64;
  const int r0 = lane >> 3, c0 = lane & 7;
  for (int n0 = 0; n0 < N; n0 += kNC) {
    float acc[4][kNC / 8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kNC / 8; ++j) acc[i][j] = 0.f;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      float av[4], bv[kNC / 8];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = a[(r0 + 4 * i) * lda + k];
#pragma unroll
      for (int j = 0; j < kNC / 8; ++j) bv[j] = b[k * ldb + n0 + c0 + 8 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kNC / 8; ++j)
          acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + 4 * i;
      const float al = alpha != nullptr ? alpha[r] : 1.f;
      const float be = beta != nullptr ? beta[r] : 1.f;
#pragma unroll
      for (int j = 0; j < kNC / 8; ++j) {
        float* cp = c + r * ldc + n0 + c0 + 8 * j;
        *cp = al * *cp + be * acc[i][j];
      }
    }
  }
}

}  // namespace fa

extern "C" const char* fa_error_string(int code);
