// The weight-widening matrix-product body shared by B6 / B7 / B8
// (quant_matmul.cu) and B9 (grouped_matmul.cu), for sm_90a.
//
// A 128-thread block owns a kBM x kBN = 64 x 64 tile of y and loops over
// K in steps of kBK = 128 (one int4 scale group). Each step loads the
// x tile and the weight tile with 16-byte loads by neighbouring threads
// on neighbouring addresses, the weight at its storage width, and widens
// the weight to the activation type in shared memory (never in HBM); the
// next step's loads stay in flight in registers while the tensor cores
// (WMMA 16x16x16, fp32 sums) work on the current one. Warp w owns
// columns 16w..16w+15 of the tile, for every 16-row group that holds a
// live row. Ragged M, K and F load as zeros and store under a mask;
// rows whose stride or base is not 16-byte aligned use byte loads.
//
// `accumulate_tile` adds one weight matrix's product over a row range
// [lo, hi) of the tile to the sums (the other rows read as zeros), so a
// caller can sum several weights into one tile: B6-B8 call it once over
// [0, M), B9 once per expert whose rows meet the tile.

#pragma once

#include <cuda_fp8.h>
#include <mma.h>

#include "common.cuh"

namespace fa_mm {

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
template <int W>
constexpr bool channel_scaled() {
  return W == kInt8 || W == kE4M3 || W == kE5M2;
}

template <typename T>
constexpr size_t smem_bytes() {
  return sizeof(T) * (kBM * kLdX + kBK * kLdW) + sizeof(float) * kBN;
}

using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

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

// acc += x[rows lo..hi-1 of the tile at m0] @ W[:, f0:f0 + kBN], W one
// [K, F] weight in storage W (int4: packed [K/2, F], scales [K/128, F]).
// Rows of the tile outside [lo, hi) contribute nothing; hi <= M.
// kScaleInLoop (int8 / fp8 only): each weight is multiplied by its
// channel scale scale[F] in fp32 and rounded to T before the product;
// otherwise the caller multiplies the fp32 sum at the store. int4
// always scales in the loop, as its scale changes along K.
template <typename T, int W, bool kScaleInLoop>
__device__ __forceinline__ void accumulate_tile(
    const T* __restrict__ x, const unsigned char* __restrict__ w,
    const float* __restrict__ scale, int lo, int hi, int K, int F, int m0,
    int f0, bool x_vec, bool w_vec, unsigned char* smem,
    Acc (&acc)[kBM / 16]) {
  constexpr int kEB = weight_bytes<W>();
  constexpr int kWRows = stored_rows<W>();
  constexpr int kWChunksPerRow = kBN * kEB / 16;        // 8 dense, 4 else
  constexpr int kWPer = kWRows * kWChunksPerRow / kThreads;
  constexpr int kXChunksPerRow = kBK * sizeof(T) / 16;  // 16
  constexpr int kXPer = kBM * kXChunksPerRow / kThreads;
  constexpr bool kLoopScale =
      W == kInt4 || (kScaleInLoop && channel_scaled<W>());

  T* sX = reinterpret_cast<T*>(smem);                   // [kBM][kLdX]
  T* sW = sX + kBM * kLdX;                              // [kBK][kLdW]
  float* sScale = reinterpret_cast<float*>(sW + kBK * kLdW);   // [kBN]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int nk = (K + kBK - 1) / kBK;
  const int w_rows = W == kInt4 ? K / 2 : K;            // stored rows
  const size_t w_ld = (size_t)F * kEB;                  // bytes per row
  const int w_row_bytes = F * kEB;
  // 16-row groups of the tile that hold a row of [lo, hi) (uniform).
  const int g_lo = (max(lo, m0) - m0) / 16;
  const int g_hi = (min(hi, m0 + kBM) - m0 + 15) / 16;

  uint4 xr[kXPer];
  uint4 wr[kWPer];
  float sr = 0.f;      // next tile's scale of column tid

  // Global -> registers for K tile kt.
  auto prefetch = [&](int kt) {
    const int k0 = kt * kBK;
#pragma unroll
    for (int j = 0; j < kXPer; ++j) {
      const int i = tid + j * kThreads;
      const int r = i / kXChunksPerRow;
      const int c = (i % kXChunksPerRow) * 8;
      const int row = m0 + r, col = k0 + c;
      const bool live = row >= lo && row < hi;
      const int nvalid = live ? (K - col) * (int)sizeof(T) : 0;
      xr[j] = load16(reinterpret_cast<const unsigned char*>(
                         x + (size_t)min(max(row, lo), hi - 1) * K
                         + min(col, K)),
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
    if constexpr (kLoopScale) {
      const int col = f0 + tid;
      const size_t srow = W == kInt4 ? (size_t)(k0 / kGroup) * F : 0;
      if (tid < kBN) sr = col < F ? scale[srow + col] : 0.f;
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
    if constexpr (kLoopScale) {
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
          float lo4[16], hi4[16];
#pragma unroll
          for (int e = 0; e < 16; ++e) {
            const float s = sScale[cb + e];
            lo4[e] = static_cast<float>(((b[e] & 0xF) ^ 8) - 8) * s;
            hi4[e] = static_cast<float>((((b[e] >> 4) & 0xF) ^ 8) - 8) * s;
          }
          T* lo_row = sW + (2 * r) * kLdW + cb;
          T* hi_row = lo_row + kLdW;
          *reinterpret_cast<uint4*>(lo_row) = fa::pack8<T>(lo4);
          *reinterpret_cast<uint4*>(lo_row + 8) = fa::pack8<T>(lo4 + 8);
          *reinterpret_cast<uint4*>(hi_row) = fa::pack8<T>(hi4);
          *reinterpret_cast<uint4*>(hi_row + 8) = fa::pack8<T>(hi4 + 8);
        } else {
          float v[16];
#pragma unroll
          for (int e = 0; e < 16; ++e) {
            v[e] = widen<W>(b[e]);
            if constexpr (kLoopScale) v[e] *= sScale[cb + e];
          }
          T* row = sW + r * kLdW + cb;
          *reinterpret_cast<uint4*>(row) = fa::pack8<T>(v);
          *reinterpret_cast<uint4*>(row + 8) = fa::pack8<T>(v + 8);
        }
      }
    }
  };

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
        if (g >= g_lo && g < g_hi) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
          wmma::load_matrix_sync(a, sX + (g * 16) * kLdX + kk * 16, kLdX);
          wmma::mma_sync(acc[g], a, bf, acc[g]);
        }
      }
    }
  }
}

// y[m0.., f0..] = the tile's sums (times col_scale[col] when given),
// rounded to T, for rows < M and columns < F.
template <typename T>
__device__ __forceinline__ void store_tile(Acc (&acc)[kBM / 16],
                                           unsigned char* smem,
                                           T* __restrict__ y,
                                           const float* __restrict__ col_scale,
                                           int M, int F, int m0, int f0) {
  float* sO = reinterpret_cast<float*>(smem);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  __syncthreads();      // the operand tiles are dead; sO reuses them
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
      if (col_scale != nullptr) v *= col_scale[col];
      y[(size_t)row * F + col] = fa::from_float<T>(v);
    }
  }
}

// The 16-byte load conditions of a launch: x rows of K elements, weight
// rows of F * weight_bytes bytes.
template <typename T>
__host__ inline bool x_aligned(const void* x, int K) {
  return K % (16 / sizeof(T)) == 0 &&
         reinterpret_cast<uintptr_t>(x) % 16 == 0;
}
template <int W>
__host__ inline bool w_aligned(const void* w, int F) {
  return (F * weight_bytes<W>()) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(w) % 16 == 0;
}

}  // namespace fa_mm
