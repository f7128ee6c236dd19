// B6, B7, B8: weight-only quantized and weight-streaming matrix products
// for Hopper (sm_90a), one kernel templated over the weight's storage.
//
// Replaces the Pallas TPU kernels of flash_attention_tpu/ops/quant_matmul.py:
//   B6 `_kernel` (quant_matmul.py:41, launched at :98): y = x @ (Wq * s),
//      Wq int8 / fp8 e4m3 / fp8 e5m2 [K, F], s fp32 [F];
//   B7 `_int4_kernel` (:214, launched at :305): y = x @ dequant(W), W
//      packed int4 [K/2, F] (byte j of a column = logical rows 2j in the
//      low nibble and 2j + 1 in the high nibble), scales fp32 [K/128, F];
//   B8 `_dense_kernel` (:141, launched at :189): y = x @ W, W in the
//      activation's 16-bit type.
// on the port's serving path: every weight product of the model
// (models/llama.py `_mm`) with at most 1024 activation rows, on
// quantized weights, and with FA_TPU_DENSE_PALLAS_MM=1 on dense ones.
//
// Numerics (the JAX kernels'): int8 and fp8 widen exactly to the
// activation type (the card's __nv_fp8_e4m3 / __nv_fp8_e5m2 conversions;
// NaN / inf codes, which quantization never emits, decode as NaN / inf
// where the TPU's bit-plant gave large finite values) and the
// per-channel scale multiplies the fp32 sum once at the store; an int4
// value is multiplied by its group scale in fp32 and rounded to the
// activation type before the product. Products are WMMA 16x16x16
// bf16 / fp16 with fp32 accumulation.
//
// What bounds it on the H100. Decode (M = 8..16 rows): bytes -- the
// weight is read once per call and each weight byte does 2 M FLOPs (int8)
// or 4 M (int4) against the ~295 FLOPs per byte at which the tensor
// cores become the limit; w_gate 4096 x 14336 takes 35 us in bf16,
// 17.5 us in int8 and 9.3 us in int4 at 3.35 TB/s. Prefill (M up to
// 1024): operations. The design reads each weight at its storage width
// with 16-byte loads by neighbouring threads on neighbouring addresses,
// widens it in shared memory (never in HBM), and keeps the next K tile's
// loads in flight in registers while the tensor cores work on the
// current one. Each block owns a 64 x 64 tile of y and loops over K in
// steps of 128 inside the block (the TPU's sequential k grid axis);
// each of its four warps owns 16 columns and skips the 16-row groups
// that lie past M, so at decode the four warps share the few products.
// Ragged M, K and F load as zeros and store under a mask (the JAX
// wrapper's jnp.pad); rows whose stride or base is not 16-byte aligned
// fall back to byte loads.
//
// Known costs, for the speed work: a 64-wide F tile gives F / 64 blocks
// at decode (16 for wk / wv, 64 for wq / wo / w_down, 224 for w_gate /
// w_up on 132 SMs), each with a few KB in flight, so the small products
// cannot fill HBM; split-K and a decode-shaped tile are the fix. At
// prefill WMMA through shared memory runs far under wgmma's rate.

#include <cuda_fp8.h>
#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

// Weight storage codes (ops/_cuda.py WEIGHT_CODES).
constexpr int kDense = 0;
constexpr int kInt8 = 1;
constexpr int kE4M3 = 2;
constexpr int kE5M2 = 3;
constexpr int kInt4 = 4;

constexpr int kGroup = 128;   // int4 rows per scale group (INT4_GROUP)

constexpr int kBM = 64;       // rows of y per block
constexpr int kBN = 64;       // columns of y per block
constexpr int kBK = 128;      // logical K rows per step (one int4 group)
constexpr int kThreads = 128;
constexpr int kLdX = kBK + 8;     // smem row strides, in elements
constexpr int kLdW = kBN + 8;
constexpr int kLdO = kBN + 4;     // fp32 epilogue rows

template <int W>
constexpr int weight_bytes() { return W == kDense ? 2 : 1; }
template <int W>
constexpr int stored_rows() { return W == kInt4 ? kBK / 2 : kBK; }

template <typename T>
constexpr size_t smem_bytes() {
  return sizeof(T) * (kBM * kLdX + kBK * kLdW) + sizeof(float) * kBN;
}

// 16 bytes of a row of which `nvalid` bytes from `p` on exist; missing
// bytes are zero. `vec`: 16-byte loads are aligned.
__device__ __forceinline__ uint4 load16(const unsigned char* p, int nvalid,
                                        bool vec) {
  if (nvalid <= 0) return make_uint4(0, 0, 0, 0);
  if (vec && nvalid >= 16) return *reinterpret_cast<const uint4*>(p);
  uint4 out = make_uint4(0, 0, 0, 0);
  unsigned char* o = reinterpret_cast<unsigned char*>(&out);
  const int n = min(nvalid, 16);
  for (int i = 0; i < n; ++i) o[i] = p[i];
  return out;
}

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

template <typename T, int W>
__global__ void __launch_bounds__(kThreads)
quant_matmul_kernel(const T* __restrict__ x,
                    const unsigned char* __restrict__ w,
                    const float* __restrict__ scale, T* __restrict__ y,
                    int M, int K, int F, int x_vec, int w_vec) {
  constexpr int kEB = weight_bytes<W>();
  constexpr int kWRows = stored_rows<W>();
  constexpr int kWChunksPerRow = kBN * kEB / 16;        // 8 dense, 4 else
  constexpr int kWPer = kWRows * kWChunksPerRow / kThreads;
  constexpr int kXChunksPerRow = kBK * sizeof(T) / 16;  // 16
  constexpr int kXPer = kBM * kXChunksPerRow / kThreads;

  __shared__ __align__(128) unsigned char smem[smem_bytes<T>()];
  T* sX = reinterpret_cast<T*>(smem);                   // [kBM][kLdX]
  T* sW = sX + kBM * kLdX;                              // [kBK][kLdW]
  float* sScale = reinterpret_cast<float*>(sW + kBK * kLdW);   // [kBN]
  float* sO = reinterpret_cast<float*>(smem);           // after the loop

  const int f0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int nk = (K + kBK - 1) / kBK;
  const int w_rows = W == kInt4 ? K / 2 : K;            // stored rows
  const size_t w_ld = (size_t)F * kEB;                  // bytes per row
  const int w_row_bytes = F * kEB;

  uint4 xr[kXPer];
  uint4 wr[kWPer];
  float sr = 0.f;      // int4: next tile's group scale of column tid

  // Global -> registers for K tile kt.
  auto prefetch = [&](int kt) {
    const int k0 = kt * kBK;
#pragma unroll
    for (int j = 0; j < kXPer; ++j) {
      const int i = tid + j * kThreads;
      const int r = i / kXChunksPerRow;
      const int c = (i % kXChunksPerRow) * 8;
      const int row = m0 + r, col = k0 + c;
      const int nvalid = row < M ? (K - col) * (int)sizeof(T) : 0;
      xr[j] = load16(reinterpret_cast<const unsigned char*>(
                         x + (size_t)min(row, M - 1) * K + min(col, K)),
                     nvalid, x_vec);
    }
    const int r0 = W == kInt4 ? k0 / 2 : k0;
#pragma unroll
    for (int j = 0; j < kWPer; ++j) {
      const int i = tid + j * kThreads;
      const int r = i / kWChunksPerRow;
      const int byte0 = f0 * kEB + (i % kWChunksPerRow) * 16;
      const int row = r0 + r;
      const int nvalid = row < w_rows ? w_row_bytes - byte0 : 0;
      wr[j] = load16(w + (size_t)min(row, w_rows - 1) * w_ld
                         + min(byte0, w_row_bytes),
                     nvalid, w_vec);
    }
    if constexpr (W == kInt4) {
      const int col = f0 + tid;
      if (tid < kBN)
        sr = col < F ? scale[(size_t)(k0 / kGroup) * F + col] : 0.f;
    }
  };

  // Registers -> shared memory, widening the weight to T.
  auto store = [&]() {
#pragma unroll
    for (int j = 0; j < kXPer; ++j) {
      const int i = tid + j * kThreads;
      const int r = i / kXChunksPerRow;
      const int c = (i % kXChunksPerRow) * 8;
      *reinterpret_cast<uint4*>(sX + r * kLdX + c) = xr[j];
    }
    if constexpr (W == kInt4) {
      if (tid < kBN) sScale[tid] = sr;
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < kWPer; ++j) {
      const int i = tid + j * kThreads;
      const int r = i / kWChunksPerRow;
      const int cb = (i % kWChunksPerRow) * 16;          // byte column
      if constexpr (W == kDense) {
        *reinterpret_cast<uint4*>(sW + r * kLdW + cb / 2) = wr[j];
      } else {
        const unsigned char* b = reinterpret_cast<const unsigned char*>(&wr[j]);
        if constexpr (W == kInt4) {
          float lo[16], hi[16];
#pragma unroll
          for (int e = 0; e < 16; ++e) {
            const float s = sScale[cb + e];
            lo[e] = static_cast<float>(((b[e] & 0xF) ^ 8) - 8) * s;
            hi[e] = static_cast<float>((((b[e] >> 4) & 0xF) ^ 8) - 8) * s;
          }
          T* lo_row = sW + (2 * r) * kLdW + cb;
          T* hi_row = lo_row + kLdW;
          *reinterpret_cast<uint4*>(lo_row) = fa::pack8<T>(lo);
          *reinterpret_cast<uint4*>(lo_row + 8) = fa::pack8<T>(lo + 8);
          *reinterpret_cast<uint4*>(hi_row) = fa::pack8<T>(hi);
          *reinterpret_cast<uint4*>(hi_row + 8) = fa::pack8<T>(hi + 8);
        } else {
          float v[16];
#pragma unroll
          for (int e = 0; e < 16; ++e) v[e] = widen<W>(b[e]);
          T* row = sW + r * kLdW + cb;
          *reinterpret_cast<uint4*>(row) = fa::pack8<T>(v);
          *reinterpret_cast<uint4*>(row + 8) = fa::pack8<T>(v + 8);
        }
      }
    }
  };

  // Warp w owns columns 16w..16w+15 of the tile, for every 16-row group
  // that holds a real row: at decode (M <= 16) the four warps share the
  // products instead of one warp doing them all.
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kBM / 16];
#pragma unroll
  for (int g = 0; g < kBM / 16; ++g) wmma::fill_fragment(acc[g], 0.f);
  const int n_groups = min(kBM / 16, (M - m0 + 15) / 16);   // uniform

  if (nk > 0) prefetch(0);
  for (int kt = 0; kt < nk; ++kt) {
    __syncthreads();    // every warp is done with the previous tile
    store();
    __syncthreads();
    if (kt + 1 < nk) prefetch(kt + 1);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> bf;
      wmma::load_matrix_sync(bf, sW + (kk * 16) * kLdW + warp * 16, kLdW);
#pragma unroll
      for (int g = 0; g < kBM / 16; ++g) {
        if (g < n_groups) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
          wmma::load_matrix_sync(a, sX + (g * 16) * kLdX + kk * 16, kLdX);
          wmma::mma_sync(acc[g], a, bf, acc[g]);
        }
      }
    }
  }
  __syncthreads();      // the tiles are dead; sO reuses their memory
#pragma unroll
  for (int g = 0; g < kBM / 16; ++g)
    wmma::store_matrix_sync(sO + (g * 16) * kLdO + warp * 16, acc[g], kLdO,
                            wmma::mem_row_major);
  __syncthreads();

  for (int i = tid; i < kBM * kBN; i += kThreads) {
    const int r = i / kBN, c = i % kBN;
    const int row = m0 + r, col = f0 + c;
    if (row < M && col < F) {
      float v = sO[r * kLdO + c];
      if constexpr (W == kInt8 || W == kE4M3 || W == kE5M2) v *= scale[col];
      y[(size_t)row * F + col] = fa::from_float<T>(v);
    }
  }
}

template <typename T, int W>
cudaError_t launch(const void* x, const void* w, const void* scale, void* y,
                   int M, int K, int F, cudaStream_t stream) {
  const bool x_vec = K % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool w_vec = (F * weight_bytes<W>()) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(w) % 16 == 0;
  dim3 grid((F + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  quant_matmul_kernel<T, W><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const unsigned char*>(w),
      static_cast<const float*>(scale), static_cast<T*>(y), M, K, F,
      (int)x_vec, (int)w_vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_weight(const void* x, const void* w, const void* scale,
                            void* y, int M, int K, int F, int weight,
                            cudaStream_t stream) {
  switch (weight) {
    case kDense:
      return launch<T, kDense>(x, w, scale, y, M, K, F, stream);
    case kInt8:
      return launch<T, kInt8>(x, w, scale, y, M, K, F, stream);
    case kE4M3:
      return launch<T, kE4M3>(x, w, scale, y, M, K, F, stream);
    case kE5M2:
      return launch<T, kE5M2>(x, w, scale, y, M, K, F, stream);
    case kInt4:
      return launch<T, kInt4>(x, w, scale, y, M, K, F, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int fa_quant_matmul(const void* x, const void* w,
                               const void* scale, void* y, int M, int K,
                               int F, int weight, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || K < 0 || F <= 0) return (int)cudaErrorInvalidValue;
  if (weight != kDense && scale == nullptr) return (int)cudaErrorInvalidValue;
  if (weight == kInt4 && K % kGroup) return (int)cudaErrorInvalidValue;
  if (dtype == fa::kBFloat16)
    return (int)dispatch_weight<__nv_bfloat16>(x, w, scale, y, M, K, F,
                                               weight, s);
  if (dtype == fa::kFloat16)
    return (int)dispatch_weight<__half>(x, w, scale, y, M, K, F, weight, s);
  return (int)cudaErrorInvalidValue;
}
