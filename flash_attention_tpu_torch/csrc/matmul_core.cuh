// The first weight-widening matrix-product body of B6 / B7 / B8
// (quant_matmul.cu) and B9 (grouped_matmul.cu), for sm_90a, on fp16 /
// bf16 activations. Since the Hopper bodies of matmul_sm90.cuh took every
// fp16 / bf16 launch whose operands TMA can address, and the FFMA body of
// matmul_f32.cuh every fp32 launch, it runs fp16 / bf16 operands with a
// base or row stride that is not a multiple of 16 bytes (counted in
// ops/quant_matmul.py matmul_first_body_launches; no model path makes
// one), and the study probes P1 (probe_int4_variants.cu, its step
// functor) and P3 (probe_lmhead_argmax.cu) where TMA cannot address their
// operands. What bounds it: at 64 x 64 tiles with WMMA from shared memory
// and two barriers a K step it reaches ~11% of the tensor cores' rate at
// prefill, and at decode F / 64 blocks keep too few bytes in flight to
// fill HBM -- the reasons those launches moved.
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
// [0, M), B9 once per expert whose rows meet the tile. A caller may pass
// a step functor, run by every thread once per K step after the step's
// tiles are in shared memory (the probe P1's offset correction).

#pragma once

#include <mma.h>

#include <type_traits>

#include "common.cuh"

namespace fa_mm {

using namespace nvcuda;

// Weight storage codes (ops/_cuda.py WEIGHT_CODES): the int8 / fp8 codes
// are common.cuh's, int4 is this body's own. kInt4Ob and kInt4ObBias are
// the probe P1's offset-binary int4 (nibble = q + 8, in [1, 15]; the
// packing and scales of kInt4): kInt4Ob widens (nibble - 8) * scale in
// the int domain, kInt4ObBias keeps the + 8 in the weight (see `store`).
using fa::kDense;
using fa::kE4M3;
using fa::kE5M2;
using fa::kInt8;
using fa::widen;
constexpr int kInt4 = 4;
constexpr int kInt4Ob = 5;
constexpr int kInt4ObBias = 6;

constexpr int kGroup = 128;   // int4 rows per scale group (INT4_GROUP)

constexpr int kBM = 64;       // rows of y per block
constexpr int kBN = 64;       // columns of y per block
constexpr int kBK = 128;      // logical K rows per step (one int4 group)
constexpr int kThreads = 128;
constexpr int kLdO = kBN + 4;     // fp32 sums / epilogue rows

template <int W>
constexpr bool packed4() {
  return W == kInt4 || W == kInt4Ob || W == kInt4ObBias;
}
template <typename T, int W>
constexpr int weight_bytes() { return W == kDense ? (int)sizeof(T) : 1; }
template <int W>
constexpr int stored_rows() { return packed4<W>() ? kBK / 2 : kBK; }
template <int W>
constexpr bool channel_scaled() {
  return W == kInt8 || W == kE4M3 || W == kE5M2;
}

// Shared memory of one block: the x tile [kBM][kLdX] and the widened
// weight tile [kBK][kLdW] in T, and the step's column scales.
template <typename T>
struct Tile {
  static_assert(sizeof(T) == 2, "the first body takes fp16 / bf16");
  static constexpr int kPad = 16 / sizeof(T);   // keeps rows 16-byte
  static constexpr int kLdX = kBK + kPad;
  static constexpr int kLdW = kBN + kPad;
  static constexpr size_t kW = sizeof(T) * kBM * kLdX;
  static constexpr size_t kScale = kW + sizeof(T) * kBK * kLdW;
  static constexpr size_t kBytes = kScale + sizeof(float) * kBN;
};

using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// A tile's fp32 sums: WMMA fragments, warp w's columns of each 16-row
// group.
template <typename T>
struct Sums {
  Acc f[kBM / 16];
  __device__ __forceinline__ void zero(unsigned char*) {
#pragma unroll
    for (int g = 0; g < kBM / 16; ++g) wmma::fill_fragment(f[g], 0.f);
  }
};

// The default step functor: nothing.
struct NoStep {
  template <typename T>
  __device__ __forceinline__ void operator()(int, const T*, const float*) {}
};

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

// Two bytes' low (or high) nibbles as a bf16x2 of exact integers in
// [0, 15] plus 128: t holds the bytes in the low byte of each half-word
// (prmt), the mask and the exponent of 128 combine in one lop3.
__device__ __forceinline__ uint32_t nibbles_plus_128(uint32_t t) {
  return (t & 0x000F000Fu) | 0x43004300u;
}

// acc += x[rows lo..hi-1 of the tile at m0] @ W[:, f0:f0 + kBN], W one
// [K, F] weight in storage W (int4: packed [K/2, F], scales [K/128, F]).
// Rows of the tile outside [lo, hi) contribute nothing; hi <= M.
// kScaleInLoop (int8 / fp8 only): each weight is multiplied by its
// channel scale scale[F] in fp32 and rounded to T before the product;
// otherwise the caller multiplies the fp32 sum at the store. int4
// always scales in the loop, as its scale changes along K. `step(kt,
// sX, sScale)` runs once per K step, after the step's tiles are stored
// (by reference: a caller's functor may keep sums in registers).
template <typename T, int W, bool kScaleInLoop, typename Step = NoStep>
__device__ __forceinline__ void accumulate_tile(
    const T* __restrict__ x, const unsigned char* __restrict__ w,
    const float* __restrict__ scale, int lo, int hi, int K, int F, int m0,
    int f0, bool x_vec, bool w_vec, unsigned char* smem, Sums<T>& acc,
    Step&& step = Step()) {
  using L = Tile<T>;
  constexpr int kLdX = L::kLdX, kLdW = L::kLdW;
  constexpr int kEB = weight_bytes<T, W>();
  constexpr int kWRows = stored_rows<W>();
  constexpr int kWChunksPerRow = kBN * kEB / 16;        // 8 (16-bit) .. 4
  constexpr int kWPer = kWRows * kWChunksPerRow / kThreads;
  constexpr int kXVec = 16 / sizeof(T);                 // x per 16 bytes
  constexpr int kXChunksPerRow = kBK / kXVec;
  constexpr int kXPer = kBM * kXChunksPerRow / kThreads;
  constexpr bool kLoopScale =
      packed4<W>() || (kScaleInLoop && channel_scaled<W>());
  static_assert(W != kInt4ObBias || sizeof(T) == 2,
                "the exponent-bias unpack is a bf16 / fp16 body");

  T* sX = reinterpret_cast<T*>(smem);                   // [kBM][kLdX]
  T* sW = reinterpret_cast<T*>(smem + L::kW);           // [kBK][kLdW]
  float* sScale = reinterpret_cast<float*>(smem + L::kScale);   // [kBN]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int nk = (K + kBK - 1) / kBK;
  const int w_rows = packed4<W>() ? K / 2 : K;          // stored rows
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
      const int c = (i % kXChunksPerRow) * kXVec;
      const int row = m0 + r, col = k0 + c;
      const bool live = row >= lo && row < hi;
      const int nvalid = live ? (K - col) * (int)sizeof(T) : 0;
      xr[j] = load16(reinterpret_cast<const unsigned char*>(
                         x + (size_t)min(max(row, lo), hi - 1) * K
                         + min(col, K)),
                     nvalid, x_vec);
    }
    const int r0 = packed4<W>() ? k0 / 2 : k0;
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
      const size_t srow = packed4<W>() ? (size_t)(k0 / kGroup) * F : 0;
      if (tid < kBN) sr = col < F ? scale[srow + col] : 0.f;
    }
  };

  // Registers -> shared memory, widening the weight to T.
  auto store = [&]() {
#pragma unroll
    for (int j = 0; j < kXPer; ++j) {
      const int i = tid + j * kThreads;
      const int r = i / kXChunksPerRow;
      const int c = (i % kXChunksPerRow) * kXVec;
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
        *reinterpret_cast<uint4*>(sW + r * kLdW + cb / kEB) = wr[j];
      } else if constexpr (W == kInt4ObBias) {
        // Offset-binary nibbles n in [1, 15], two columns at a time:
        // (128 + n) as a bf16x2 (prmt + lop3), then one packed fma with
        // the scale s rounded to T: (128 + n) s - 128 s = n s exactly
        // (128 s is exact in T), rounded once. The - 8 s is the caller's
        // per-group correction.
        using T2 =
            std::conditional_t<std::is_same_v<T, __half>, __half2,
                               __nv_bfloat162>;
        const uint32_t* words = reinterpret_cast<const uint32_t*>(&wr[j]);
        T* lo_row = sW + (2 * r) * kLdW + cb;
        T* hi_row = lo_row + kLdW;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int e = 4 * q + 2 * h;
            const uint32_t t = __byte_perm(words[q], 0, h ? 0x4342 : 0x4140);
            const uint32_t lo_bits = nibbles_plus_128(t);
            const uint32_t hi_bits = nibbles_plus_128(t >> 4);
            const float s0 = sScale[cb + e], s1 = sScale[cb + e + 1];
            T2 s2, nb2, lo2, hi2;
            s2.x = fa::from_float<T>(s0);
            s2.y = fa::from_float<T>(s1);
            nb2.x = fa::from_float<T>(-128.f * fa::to_float<T>(s2.x));
            nb2.y = fa::from_float<T>(-128.f * fa::to_float<T>(s2.y));
            lo2 = *reinterpret_cast<const T2*>(&lo_bits);
            hi2 = *reinterpret_cast<const T2*>(&hi_bits);
            *reinterpret_cast<T2*>(lo_row + e) = __hfma2(lo2, s2, nb2);
            *reinterpret_cast<T2*>(hi_row + e) = __hfma2(hi2, s2, nb2);
          }
        }
      } else {
        const unsigned char* b = reinterpret_cast<const unsigned char*>(&wr[j]);
        if constexpr (packed4<W>()) {
          // kInt4: two's-complement nibbles, (u ^ 8) - 8; kInt4Ob:
          // offset-binary, u - 8.
          constexpr int kX = W == kInt4 ? 8 : 0;
          float lo4[16], hi4[16];
#pragma unroll
          for (int e = 0; e < 16; ++e) {
            const float s = sScale[cb + e];
            lo4[e] = static_cast<float>(((b[e] & 0xF) ^ kX) - 8) * s;
            hi4[e] = static_cast<float>((((b[e] >> 4) & 0xF) ^ kX) - 8) * s;
          }
          T* lo_row = sW + (2 * r) * kLdW + cb;
          fa::store_scaled<T, 16>(lo_row, lo4, 1.f);
          fa::store_scaled<T, 16>(lo_row + kLdW, hi4, 1.f);
        } else {
          float v[16];
#pragma unroll
          for (int e = 0; e < 16; ++e) {
            v[e] = widen<W>(b[e]);
            if constexpr (kLoopScale) v[e] *= sScale[cb + e];
          }
          fa::store_scaled<T, 16>(sW + r * kLdW + cb, v, 1.f);
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
    step(kt, sX, sScale);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> bf;
      wmma::load_matrix_sync(bf, sW + (kk * 16) * kLdW + warp * 16, kLdW);
#pragma unroll
      for (int g = 0; g < kBM / 16; ++g) {
        if (g >= g_lo && g < g_hi) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
          wmma::load_matrix_sync(a, sX + (g * 16) * kLdX + kk * 16, kLdX);
          wmma::mma_sync(acc.f[g], a, bf, acc.f[g]);
        }
      }
    }
  }
}

// The tile's fp32 sums as a [kBM][kLdO] shared-memory tile, visible to
// every thread: the fragments stored over the (dead) operand tiles.
// Every thread must call it.
template <typename T>
__device__ __forceinline__ float* sums_to_smem(Sums<T>& acc,
                                               unsigned char* smem) {
  __syncthreads();      // every warp is done with the operand tiles
  float* sO = reinterpret_cast<float*>(smem);
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int g = 0; g < kBM / 16; ++g)
    wmma::store_matrix_sync(sO + (g * 16) * kLdO + warp * 16, acc.f[g],
                            kLdO, wmma::mem_row_major);
  __syncthreads();
  return sO;
}

// y[m0.., f0..] = the tile's sums (times col_scale[col] when given),
// rounded to T, for rows < M and columns < F.
template <typename T>
__device__ __forceinline__ void store_tile(Sums<T>& acc,
                                           unsigned char* smem,
                                           T* __restrict__ y,
                                           const float* __restrict__ col_scale,
                                           int M, int F, int m0, int f0) {
  const float* sO = sums_to_smem<T>(acc, smem);
  for (int i = threadIdx.x; i < kBM * kBN; i += kThreads) {
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
template <typename T, int W>
__host__ inline bool w_aligned(const void* w, int F) {
  return (F * weight_bytes<T, W>()) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(w) % 16 == 0;
}

// Raise a kernel's dynamic shared-memory limit where its tiles pass the
// 48 KB default, then launch nothing: the caller launches.
template <typename Kernel>
__host__ inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace fa_mm
