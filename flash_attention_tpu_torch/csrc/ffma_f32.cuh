// The pieces of the register-blocked fp32 FFMA bodies: B2 / B3 on fp32
// inputs (flash_bwd_f32.cuh) and the study kernels B10a-c on fp32
// inputs (study_f32.cuh). Every product is full fp32 FFMA on the CUDA
// cores (no TF32, no tensor cores), each output element a sum in a fixed
// order.
//
//  - Staging: rows of a row-major [n, D] fp32 matrix into shared memory
//    by cp.async from every thread of the block (rows past n read zeros),
//    in one of three layouts: Padded (row stride D + 4: consecutive rows
//    start 4 banks apart), Plain (stride D), or Swizzled (stride D, the
//    16-byte chunk c of row r stored at chunk c ^ (r & 7), optionally
//    with the rows of a 64-row slab permuted; study_f32.cuh says why).
//  - The micro-tile of an accumulating product C[R, D] (AccTile): thread
//    (ty, tx) of the block owns rows ty + kTY i and the W-float column
//    vectors tx + kTX j, in registers from the first tile to the store;
//    `accumulate` adds A[R, K] B[K, D] to it, each column vector's K-term
//    sum formed from zero and then combined with the accumulator.
//  - lds4: a 16-byte shared load the compiler may not merge with an
//    earlier one (accumulate re-reads A's rows for each column vector
//    rather than keep them all live, which spills at D >= 128).
//  - work_rank: the order in which a grid of causal work items meets the
//    SMs, heaviest first.
#pragma once

#include "mma_sm80.cuh"

namespace fa {
namespace ffma {

// Row layouts of a [rows, D] fp32 tile in shared memory: `at(r, c)` is
// the float offset of 16-byte chunk c of row r.
template <int D>
struct Padded {
  __device__ static int at(int r, int c) { return r * (D + 4) + 4 * c; }
};

template <int D>
struct Plain {
  __device__ static int at(int r, int c) { return r * D + 4 * c; }
};

// Stride D with chunk c of stored row p at chunk c ^ (p & 7) (D >= 32:
// eight chunks or more a row). With Permute, the rows of a 64-row slab
// are stored transposed as a 4 x 16 grid: row 4t + j at stored row 16j +
// t, so that the 16 rows 4t + j (t < 16) of one j sit on 16 stored rows
// whose chunk swizzles differ.
template <int D, bool Permute>
struct Swizzled {
  __device__ static int at(int r, int c) {
    const int p = Permute ? (r & 3) * 16 + (r >> 2) : r;
    return p * D + 4 * (c ^ (p & 7));
  }
};

// Rows [r0, r0 + N) of a row-major [n, D] fp32 matrix into shared memory
// in layout L by cp.async from every thread; rows past n read zeros.
template <int D, int N, int Threads, class L>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int r0, int n, int tid) {
  constexpr int kChunks = D / 4;
  for (int i = tid; i < N * kChunks; i += Threads) {
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = r0 + r < n;
    cp_async16(dst + L::at(r, c),
               src + (size_t)(ok ? r0 + r : 0) * D + 4 * c, ok ? 16 : 0);
  }
}

// Entries [i0, i0 + N) of a length-n vector of 4-byte values into shared
// memory by threads [t0, t0 + N); past n read zeros.
template <int N, typename V>
__device__ __forceinline__ void load_vec(V* dst, const V* src, int i0,
                                         int n, int tid, int t0) {
  const int i = tid - t0;
  if (i < 0 || i >= N) return;
  const bool ok = i0 + i < n;
  cp_async4(dst + i, src + (ok ? i0 + i : 0), ok ? 4 : 0);
}

// A 16-byte shared load the compiler may not merge with an earlier one.
__device__ __forceinline__ float4 lds4(const float* p) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(saddr(p)));
  return v;
}

// W consecutive floats (W = 2 or 4) from 4W-byte aligned memory.
template <int W>
__device__ __forceinline__ void ldv(float (&v)[W], const float* p) {
  if constexpr (W == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  } else {
    static_assert(W == 2, "ldv: 2 or 4 floats");
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x, v[1] = x.y;
  }
}

// The register tile of an accumulating product C[R, D] over Threads
// threads: thread (ty, tx) = (tid / kTX, tid % kTX) owns rows ty + kTY i
// (i < kMR) and the W-float column vectors tx + kTX j (j < kNV).
template <int R, int D, int NV, int Threads, int W = 4>
struct AccTile {
  static constexpr int kNV = NV;
  static constexpr int kW = W;
  static constexpr int kTX = D / (W * NV);
  static constexpr int kTY = Threads / kTX;
  static constexpr int kMR = R / kTY;
  static_assert(kTX * kTY == Threads && kMR * kTY == R, "AccTile");
};

template <class A>
using Acc = float[A::kMR][A::kW * A::kNV];

// The default combine of accumulate: acc += the partial sum.
struct Add {
  __device__ float operator()(int, float acc, float t) const {
    return acc + t;
  }
};

// acc = comb(i, acc, A[rows ty + kTY i][0, K) B[0, K)[column vectors tx
// + kTX j]) for each row i (fp32 FFMA): A row-major with stride lda, read
// as float4 along k; B row-major with stride ldb, read W floats along
// its row. Each column vector's K-term sum is formed from zero (k
// ascending) and then combined with acc, so an accumulator is built from
// K-term partial sums in tile order: over thousands of rows a single
// running sum would grow its rounding error with the row count. The k
// loop is unrolled 16 deep: a deeper one lets the compiler hoist B's
// loads until registers spill (K = 64 at D = 128).
template <class A, int K, class Comb = Add>
__device__ __forceinline__ void accumulate(Acc<A>& acc,
                                           const float* __restrict__ a,
                                           int lda,
                                           const float* __restrict__ b,
                                           int ldb, int ty, int tx,
                                           Comb comb = Comb()) {
  static_assert(K % 16 == 0, "accumulate takes 16 keys at a time");
  constexpr int W = A::kW;
#pragma unroll
  for (int j = 0; j < A::kNV; ++j) {
    float t[A::kMR][W];
#pragma unroll
    for (int i = 0; i < A::kMR; ++i)
#pragma unroll
      for (int e = 0; e < W; ++e) t[i][e] = 0.f;
#pragma unroll 1
    for (int k0 = 0; k0 < K; k0 += 16) {   // unrolled 16 keys at a time
#pragma unroll
      for (int k = k0; k < k0 + 16; k += 4) {
        float4 av[A::kMR];
#pragma unroll
        for (int i = 0; i < A::kMR; ++i)
          av[i] = lds4(a + (ty + A::kTY * i) * lda + k);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          float bv[W];
          ldv<W>(bv, b + (k + kk) * ldb + W * (tx + A::kTX * j));
#pragma unroll
          for (int i = 0; i < A::kMR; ++i) {
            const float ai = kk == 0 ? av[i].x
                             : kk == 1 ? av[i].y
                             : kk == 2 ? av[i].z
                                       : av[i].w;
#pragma unroll
            for (int e = 0; e < W; ++e)
              t[i][e] = fmaf(ai, bv[e], t[i][e]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < A::kMR; ++i)
#pragma unroll
      for (int e = 0; e < W; ++e)
        acc[i][W * j + e] = comb(i, acc[i][W * j + e], t[i][e]);
  }
}

// An accumulator's rows (those < n) to global memory, W-float stores.
template <class A, int D>
__device__ __forceinline__ void store_acc(const Acc<A>& acc, float* dst,
                                          int r0, int n, int ty, int tx) {
  constexpr int W = A::kW;
#pragma unroll
  for (int i = 0; i < A::kMR; ++i) {
    const int r = r0 + ty + A::kTY * i;
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < A::kNV; ++j) {
      float* p = dst + (size_t)r * D + W * (tx + A::kTX * j);
      if constexpr (W == 4)
        *reinterpret_cast<float4*>(p) =
            make_float4(acc[i][4 * j], acc[i][4 * j + 1], acc[i][4 * j + 2],
                        acc[i][4 * j + 3]);
      else
        *reinterpret_cast<float2*>(p) =
            make_float2(acc[i][2 * j], acc[i][2 * j + 1]);
    }
  }
}

template <class A>
__device__ __forceinline__ void zero(Acc<A>& acc) {
#pragma unroll
  for (int i = 0; i < A::kMR; ++i)
#pragma unroll
    for (int j = 0; j < A::kW * A::kNV; ++j) acc[i][j] = 0.f;
}

// The rank (0 = heaviest) of the work item that block L of W takes.
// Blocks reach the SMs in launch order, one an SM before any SM takes a
// second: when the whole grid is resident at once at two blocks an SM,
// the second round takes the items lightest first, so each SM's two
// items sum to about the mean; otherwise the heaviest go first.
__device__ __forceinline__ int work_rank(int L, int W, int sms,
                                         int per_sm) {
  if (per_sm < 2 || W > 2 * sms || L < sms) return L;
  return sms + (W - 1 - L);
}

// The SMs of the current device (work_rank's first round).
inline int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

}  // namespace ffma
}  // namespace fa
