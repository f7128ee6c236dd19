// B6, B7, B8 and B9 on fp32 activations for Hopper (sm_90a): the
// register-blocked FFMA body. Every fp32 launch of quant_matmul.cu and
// grouped_matmul.cu runs it (ops/quant_matmul.py matmul_body "ffma");
// matmul_f32.cu instantiates B6-B8, matmul_f32_grouped.cu B9, apart so
// the build runs them in parallel.
//
// Replaces, on fp32 activations, the Pallas TPU kernels `_kernel` (B6,
// flash_attention_tpu/ops/quant_matmul.py:41), `_int4_kernel` (B7, :214),
// `_dense_kernel` (B8, :141) and `_grouped_kernel` (B9, ops/grouped.py
// :132), which compute fp32 at Precision.HIGHEST. Every product is full
// fp32 FFMA on the CUDA cores (wgmma has no fp32 operand; no TF32). int8
// / e4m3 / e5m2 codes widen exactly; B6 multiplies the fp32 sum by its
// channel scale once at the store, B9 each widened weight in the loop (as
// its JAX kernel and plain version round); an int4 value is multiplied by
// its group scale (one per 128 K rows) in fp32 in the loop. B8 / B9's
// dense weights are fp32.
//
// What bounds it on the H100. 1024 x 4096 x 14336 is 0.12 TFLOP: 1.79 ms
// at the 67 TFLOP/s FFMA rate (operations, every storage). At 16 rows
// the products are still operations-bound on one-byte and int4 weights
// (0.028 ms against 0.018 / 0.009 ms of bytes), bytes-bound on an fp32
// weight (235 MB, 0.070 ms).
//
// The body. A 256-thread block owns a BM x 128 tile of y (BM = 16, 32,
// 64 or 128 rows, the fewest that hold M: ops/quant_matmul.py ffma_plan)
// and keeps it in registers: thread (ty, tx) of a slice holds an 8 x 8
// micro-tile, rows ty + (BM / 8) i and the float4 columns 4 tx, 64 + 4 tx.
// 16 x BM / 8 threads cover the tile, so the block holds 128 / BM such
// slices; each takes its own K rows of every step (sliced K) and the
// slices' sums are added in slice order at the end, so few rows still
// keep every thread on FFMA. Per 4 K rows a thread loads its 8 rows of x
// as float4s (ffma::lds4) and two float4s of the weight per row, 16
// shared loads for 256 FFMAs. Each step's products are summed from zero
// and then added to the tile's sums: one running sum over 4096 K rows
// (1024 x 4096 x 14336) failed the 3x gate against fp64.
//
// Sizes, chosen on the H100 from ptxas and CUDA-event times of their
// variants: one block an SM (`__launch_bounds__(256, 1)`: 255 registers,
// no spill; two blocks an SM cap a thread at 128 registers, which
// spilled and ran slower, most at 16 rows), K steps of 64 rows (128 at
// BM = 16), and a ring of 3-6 stages, the deepest the shared memory a
// block may take holds. The widening loop unrolls by 2: unrolled whole,
// a few of B9's instantiations at 16 and 32 rows spilled.
//
// Staging. The ring takes each K step by cp.async: x [BM][BK + 4], the
// weight at its storage width ([BK][128] fp32 straight into its operand
// tile; one byte or packed int4 otherwise) and the step's scale row. A
// one-byte or int4 slab is widened once per block into one of two fp32
// operand tiles in shared memory -- step s + 1's while step s multiplies
// -- so each step takes one barrier. An int4 group (128 rows) holds whole
// steps. Rows outside [lo, hi) of the weight being summed, and K / F past
// the edge, load as zeros; x rows whose K is not a multiple of 4 (or an
// unaligned base) and weight rows whose bytes are not a multiple of 16
// take a scalar staging path (4-byte cp.async, byte loads).
//
// Split K. Where the tiles would not put two blocks on every SM, the
// plan (ffma_plan) cuts K into `splits` ranges of k_chunk rows (a
// multiple of 128). Each block writes its tile's fp32 partial to a
// [splits, M, F] workspace; the last block of the tile (a per-tile
// counter it resets) sums the partials in split order, scales (B6) and
// stores: no atomics into y, and a rerun gives identical bits.
//
// B9: the grid is sized from M and F alone (the offsets stay on the
// device). A block runs the K steps of every expert whose rows meet its
// tile, one after another through the same ring, with the other rows of
// x loading as zeros, into one set of sums.
#pragma once

#include "ffma_f32.cuh"

namespace fa_mm {
namespace f32 {

using fa::kDense;
using fa::kE4M3;
using fa::kE5M2;
using fa::kInt8;
constexpr int kInt4 = 4;        // packed int4 (ops/_cuda.py WEIGHT_CODES)
constexpr int kBody = 3;        // ops/quant_matmul.py BODY_CODES["ffma"]
constexpr int kGroup = 128;     // int4 rows per scale group; split unit
constexpr int kBN = 128;        // columns of y a block
constexpr int kThreads = 256;
constexpr int kTX = 16;         // threads across a slice's columns
// Shared memory a block may take: the 227 KB (232448 bytes) of one block
// an SM, less 1 KB.
constexpr int kSmemBudget = 232448 - 1024;

template <int BM, int W>
struct Cfg {
  static constexpr bool kDenseW = W == kDense;
  static constexpr bool kPacked = W == kInt4;
  static constexpr int kTY = BM / 8;               // thread rows a slice
  static constexpr int kSlices = kThreads / (kTX * kTY);   // 128 / BM
  static constexpr int kBK = BM == 16 ? 128 : 64;  // K rows a step
  static constexpr int kKS = kBK / kSlices;        // K rows a slice a step
  static constexpr int kLdX = kBK + 4;             // x rows 4 banks apart
  static constexpr int kXBytes = 4 * BM * kLdX;
  static constexpr int kWRows = kPacked ? kBK / 2 : kBK;   // stored rows
  static constexpr int kWBytes = kDenseW ? 4 * kBK * kBN : kWRows * kBN;
  static constexpr int kStage = kXBytes + kWBytes + (kDenseW ? 0 : 4 * kBN);
  static constexpr int kOperand = kDenseW ? 0 : 2 * 4 * kBK * kBN;
  static constexpr int bytes(int stages) {
    return stages * kStage + kOperand;
  }
  // The deepest ring (3 to 6 stages) the budget holds.
  static constexpr int kStages = bytes(6) <= kSmemBudget   ? 6
                                 : bytes(5) <= kSmemBudget ? 5
                                 : bytes(4) <= kSmemBudget ? 4
                                                           : 3;
  static constexpr int kRed = 4 * kSlices * BM * kBN;   // the slices' sums
  static constexpr int kBytes =
      bytes(kStages) > kRed ? bytes(kStages) : kRed;
  static_assert(kKS % 4 == 0 && kGroup % kBK == 0, "Cfg");
  static_assert(bytes(kStages) <= kSmemBudget, "one block an SM");
};

struct Params {
  const float* x;               // [M, K]
  const unsigned char* w;       // [E,] K (int4: K / 2), F at storage W
  const float* scale;           // [E,] F; int4 [E,] K / 128, F; or null
  const int* offsets;           // B9: [E + 1] row offsets; else null
  float* y;                     // [M, F]
  float* ws;                    // splits > 1: [splits, M, F] partials
  int* counters;                // splits > 1: one zero int per tile
  int M, K, F, E, k_chunk;
  size_t w_expert;              // bytes of one expert's weight
  size_t s_expert;              // floats of one expert's scales
  int x_vec, w_vec, y_vec;      // 16-byte staging / stores allowed
};

// y[0..n) = v (n < 4: the first n lanes), 16-byte store when `vec`.
__device__ __forceinline__ void store4(float* dst, float4 v, int n,
                                       bool vec) {
  if (vec && n >= 4) {
    *reinterpret_cast<float4*>(dst) = v;
    return;
  }
  const float e[4] = {v.x, v.y, v.z, v.w};
  for (int i = 0; i < min(n, 4); ++i) dst[i] = e[i];
}

__device__ __forceinline__ float4 load4(const float* src, int n, bool vec) {
  if (vec && n >= 4) return __ldcg(reinterpret_cast<const float4*>(src));
  float e[4] = {0.f, 0.f, 0.f, 0.f};
  for (int i = 0; i < min(n, 4); ++i) e[i] = __ldcg(src + i);
  return make_float4(e[0], e[1], e[2], e[3]);
}

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x, a.y += b.y, a.z += b.z, a.w += b.w;
}

// Ring stage `st`'s one-byte / int4 slab -> the fp32 operand tile ob
// [kBK][kBN], times the stage's scale row where it has one (kScale): one
// 4-byte word (4 columns) a thread at a time, float4 stores.
template <int BM, int W, bool kScale>
__device__ __forceinline__ void widen_slab(const unsigned char* st,
                                           float* ob, int tid) {
  using C = Cfg<BM, W>;
  const uint32_t* raw = reinterpret_cast<const uint32_t*>(st + C::kXBytes);
  const float* ss =
      reinterpret_cast<const float*>(st + C::kXBytes + C::kWBytes);
  constexpr int kWords = C::kWRows * kBN / 4;
  static_assert(kWords % kThreads == 0, "widen_slab: whole rounds");
#pragma unroll 2
  for (int j = 0; j < kWords / kThreads; ++j) {
    const int i = tid + j * kThreads;
    const int r = i / (kBN / 4), c = i % (kBN / 4);
    const uint32_t word = raw[i];
    float s[4] = {1.f, 1.f, 1.f, 1.f};
    if constexpr (kScale) {
      const float4 s4 = fa::ffma::lds4(ss + 4 * c);
      s[0] = s4.x, s[1] = s4.y, s[2] = s4.z, s[3] = s4.w;
    }
    if constexpr (C::kPacked) {
      // Byte b: logical rows 2r (low nibble) and 2r + 1 (high nibble) of
      // column 4c + b, two's-complement nibbles.
      float lo[4], hi[4];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int byte = (word >> (8 * b)) & 0xFF;
        lo[b] = static_cast<float>(((byte & 0xF) ^ 8) - 8) * s[b];
        hi[b] = static_cast<float>(((byte >> 4) ^ 8) - 8) * s[b];
      }
      *reinterpret_cast<float4*>(ob + (2 * r) * kBN + 4 * c) =
          make_float4(lo[0], lo[1], lo[2], lo[3]);
      *reinterpret_cast<float4*>(ob + (2 * r + 1) * kBN + 4 * c) =
          make_float4(hi[0], hi[1], hi[2], hi[3]);
    } else {
      float v[4];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        v[b] = fa::widen<W>((word >> (8 * b)) & 0xFF);
        if constexpr (kScale) v[b] *= s[b];
      }
      *reinterpret_cast<float4*>(ob + r * kBN + 4 * c) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

// d += a rows [kTY i] (row stride kLdX) @ b (row stride kBN, float4
// columns 0 and kBN / 2) over kKS K rows: per 4 K rows, 8 float4 loads
// of a and 8 of b for 256 FFMAs.
// d += a rows [kTY i] (row stride kLdX) @ b (row stride kBN, float4
// columns 0 and kBN / 2) over kKS K rows: per 4 K rows, 8 float4 loads
// of a and 8 of b for 256 FFMAs.
template <class C>
__device__ __forceinline__ void ffma_tile(float (&d)[8][8], const float* a,
                                          const float* b) {
#pragma unroll
  for (int k = 0; k < C::kKS; k += 4) {
    float4 av[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      av[i] = fa::ffma::lds4(a + i * C::kTY * C::kLdX + k);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 b0 = fa::ffma::lds4(b + (k + q) * kBN);
      const float4 b1 = fa::ffma::lds4(b + (k + q) * kBN + kBN / 2);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float ai = q == 0 ? av[i].x
                         : q == 1 ? av[i].y
                         : q == 2 ? av[i].z
                                  : av[i].w;
        d[i][0] = fmaf(ai, b0.x, d[i][0]);
        d[i][1] = fmaf(ai, b0.y, d[i][1]);
        d[i][2] = fmaf(ai, b0.z, d[i][2]);
        d[i][3] = fmaf(ai, b0.w, d[i][3]);
        d[i][4] = fmaf(ai, b1.x, d[i][4]);
        d[i][5] = fmaf(ai, b1.y, d[i][5]);
        d[i][6] = fmaf(ai, b1.z, d[i][6]);
        d[i][7] = fmaf(ai, b1.w, d[i][7]);
      }
    }
  }
}

template <int BM, int W, bool Grouped>
__global__ void __launch_bounds__(kThreads, 1) mm_f32(const Params p) {
  using C = Cfg<BM, W>;
  constexpr bool kDenseW = C::kDenseW, kPacked = C::kPacked;
  constexpr int S = C::kStages, kBK = C::kBK;
  // A scale row in each stage: int4's group row; B9's channel scales.
  constexpr bool kStageScale = kPacked || (Grouped && !kDenseW);
  // B6: the channel scale multiplies the fp32 sum at the store.
  constexpr bool kStoreScale = !Grouped && !kDenseW && !kPacked;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int s_last;

  const int tid = threadIdx.x;
  const int nm = (p.M + BM - 1) / BM;
  const int tile = blockIdx.x;
  const int m0 = (tile % nm) * BM, f0 = (tile / nm) * kBN;
  const int split = blockIdx.y, splits = gridDim.y;
  const int k_lo = split * p.k_chunk;
  const int k_hi = min(p.K, k_lo + p.k_chunk);
  const int nkt = k_hi > k_lo ? (k_hi - k_lo + kBK - 1) / kBK : 0;
  const int E = Grouped ? p.E : 1;

  // The rows [lo, hi) of weight e within the tile (uniform per block).
  auto rows_of = [&](int e, int& lo, int& hi) {
    if constexpr (Grouped) {
      lo = max(max(__ldg(p.offsets + e), m0), 0);
      hi = min(min(__ldg(p.offsets + e + 1), m0 + BM), p.M);
    } else {
      lo = m0;
      hi = min(m0 + BM, p.M);
    }
    return lo < hi;
  };
  int n_w = 0;
  for (int e = 0; e < E; ++e) {
    int lo, hi;
    n_w += rows_of(e, lo, hi);
  }
  const int n = n_w * nkt;      // K steps of the block

  // The loader's cursor: weight le (one whose rows meet the tile), step
  // lkt.
  int le = -1, lkt = nkt - 1;
  auto advance = [&]() {
    if (++lkt < nkt) return;
    lkt = 0;
    int lo, hi;
    do {
      ++le;
    } while (le < E && !rows_of(le, lo, hi));
  };
  advance();

  // The cursor's step into ring slot `slot` by cp.async.
  auto load = [&](int slot) {
    unsigned char* st = smem + slot * C::kStage;
    float* xs = reinterpret_cast<float*>(st);
    const int k0 = k_lo + lkt * kBK;
    int llo, lhi;
    rows_of(le, llo, lhi);
    if (p.x_vec) {
      constexpr int kC = kBK / 4;
      for (int i = tid; i < BM * kC; i += kThreads) {
        const int r = i / kC, c = i % kC;
        const int row = m0 + r, col = k0 + 4 * c;
        const bool ok = row >= llo && row < lhi && col < p.K;
        fa::cp_async16(xs + r * C::kLdX + 4 * c,
                       p.x + (ok ? (size_t)row * p.K + col : 0), ok ? 16 : 0);
      }
    } else {
      for (int i = tid; i < BM * kBK; i += kThreads) {
        const int r = i / kBK, c = i % kBK;
        const int row = m0 + r, col = k0 + c;
        const bool ok = row >= llo && row < lhi && col < p.K;
        fa::cp_async4(xs + r * C::kLdX + c,
                      p.x + (ok ? (size_t)row * p.K + col : 0), ok ? 4 : 0);
      }
    }
    const unsigned char* wb = p.w + (Grouped ? (size_t)le * p.w_expert : 0);
    if constexpr (kDenseW) {
      float* wt = reinterpret_cast<float*>(st + C::kXBytes);
      const float* w = reinterpret_cast<const float*>(wb);
      if (p.w_vec) {
        for (int i = tid; i < kBK * (kBN / 4); i += kThreads) {
          const int r = i / (kBN / 4), c = i % (kBN / 4);
          const int row = k0 + r, col = f0 + 4 * c;
          const bool ok = row < p.K && col < p.F;
          fa::cp_async16(wt + r * kBN + 4 * c,
                         w + (ok ? (size_t)row * p.F + col : 0),
                         ok ? 16 : 0);
        }
      } else {
        for (int i = tid; i < kBK * kBN; i += kThreads) {
          const int r = i / kBN, c = i % kBN;
          const int row = k0 + r, col = f0 + c;
          const bool ok = row < p.K && col < p.F;
          fa::cp_async4(wt + r * kBN + c,
                        w + (ok ? (size_t)row * p.F + col : 0), ok ? 4 : 0);
        }
      }
    } else {
      unsigned char* raw = st + C::kXBytes;
      const int r0 = kPacked ? k0 / 2 : k0;
      const int w_rows = kPacked ? p.K / 2 : p.K;
      if (p.w_vec) {
        for (int i = tid; i < C::kWRows * (kBN / 16); i += kThreads) {
          const int r = i / (kBN / 16), c = i % (kBN / 16);
          const int row = r0 + r, col = f0 + 16 * c;
          const bool ok = row < w_rows && col < p.F;
          fa::cp_async16(raw + r * kBN + 16 * c,
                         wb + (ok ? (size_t)row * p.F + col : 0),
                         ok ? 16 : 0);
        }
      } else {
        // Rows of F bytes that are not 16-byte aligned: byte loads,
        // stored now (the slot is free: every thread passed the barrier
        // after its last reader).
        for (int i = tid; i < C::kWRows * kBN; i += kThreads) {
          const int r = i / kBN, c = i % kBN;
          const int row = r0 + r, col = f0 + c;
          raw[r * kBN + c] = row < w_rows && col < p.F
                                 ? __ldg(wb + (size_t)row * p.F + col)
                                 : 0;
        }
      }
      if constexpr (kStageScale) {
        float* ss = reinterpret_cast<float*>(st + C::kXBytes + C::kWBytes);
        const float* s = p.scale + (Grouped ? le * p.s_expert : 0) +
                         (kPacked ? (size_t)(k0 / kGroup) * p.F : 0);
        fa::ffma::load_vec<kBN>(ss, s, f0, p.F, tid, 0);
      }
    }
  };

  // The thread's place: slice g takes K rows [g kKS, (g + 1) kKS) of
  // every step.
  const int slice = tid / (kTX * C::kTY);
  const int ty = tid % (kTX * C::kTY) / kTX, tx = tid % kTX;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  // acc += x rows [ty + kTY i] @ wt over the slice's K rows: the step's
  // FFMA sums formed from zero, then added to acc (one running sum over
  // thousands of K rows fails the 3x gate at 1024 x 4096 x 14336).
  auto multiply = [&](const float* xs, const float* wt) {
    float t[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) t[i][j] = 0.f;
    ffma_tile<C>(t, xs + ty * C::kLdX + slice * C::kKS,
                 wt + slice * C::kKS * kBN + 4 * tx);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] += t[i][j];
  };

  // The ring: steps 0..S-2 in flight, then one barrier a step. At step s
  // (after the barrier) every thread is done with step s - 1, so its
  // slot takes step s + S - 1 and its operand tile step s + 1's widened
  // slab, while step s multiplies.
  float* ob = reinterpret_cast<float*>(smem + S * C::kStage);
  for (int q = 0; q < S - 1; ++q) {
    if (q < n) {
      load(q);
      advance();
    }
    fa::cp_async_commit();
  }
  if constexpr (!kDenseW) {
    if (n > 0) {
      fa::cp_async_wait<S - 2>();
      __syncthreads();
      widen_slab<BM, W, kStageScale>(smem, ob, tid);
    }
  }
  for (int s = 0; s < n; ++s) {
    // Landed: step s (dense), step s + 1 (widened ahead).
    if constexpr (kDenseW)
      fa::cp_async_wait<S - 2>();
    else
      fa::cp_async_wait<S - 3>();
    __syncthreads();
    if (s + S - 1 < n) {
      load((s + S - 1) % S);
      advance();
    }
    fa::cp_async_commit();
    const unsigned char* st = smem + (s % S) * C::kStage;
    const float* wt;
    if constexpr (kDenseW) {
      wt = reinterpret_cast<const float*>(st + C::kXBytes);
    } else {
      if (s + 1 < n)
        widen_slab<BM, W, kStageScale>(smem + ((s + 1) % S) * C::kStage,
                                       ob + ((s + 1) & 1) * kBK * kBN, tid);
      wt = ob + (s & 1) * kBK * kBN;
    }
    multiply(reinterpret_cast<const float*>(st), wt);
  }

  // The slices' sums -> shared memory [kSlices][BM][kBN], summed in
  // slice order by the thread that stores each float4 of the tile.
  fa::cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
  {
    float* o = red + (slice * BM + ty) * kBN + 4 * tx;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float* oi = o + i * C::kTY * kBN;
      *reinterpret_cast<float4*>(oi) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      *reinterpret_cast<float4*>(oi + kBN / 2) =
          make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
  }
  __syncthreads();
  const int rows = min(BM, p.M - m0);
  const bool vec = p.y_vec;
  auto scaled = [&](float4 v, int col) {
    if constexpr (kStoreScale) {
      const int nc = min(4, p.F - col);
      v.x *= __ldg(p.scale + col);
      if (nc > 1) v.y *= __ldg(p.scale + col + 1);
      if (nc > 2) v.z *= __ldg(p.scale + col + 2);
      if (nc > 3) v.w *= __ldg(p.scale + col + 3);
    }
    return v;
  };
  float* out = splits == 1 ? p.y : p.ws + (size_t)split * p.M * p.F;
  for (int i = tid; i < rows * (kBN / 4); i += kThreads) {
    const int r = i / (kBN / 4), col = f0 + 4 * (i % (kBN / 4));
    if (col >= p.F) continue;
    const float* src = red + r * kBN + 4 * (i % (kBN / 4));
    float4 v = *reinterpret_cast<const float4*>(src);
#pragma unroll
    for (int g = 1; g < C::kSlices; ++g)
      add4(v, *reinterpret_cast<const float4*>(src + g * BM * kBN));
    if (splits == 1) v = scaled(v, col);
    store4(out + (size_t)(m0 + r) * p.F + col, v, p.F - col, vec);
  }
  if (splits == 1) return;

  // The last split of the tile sums the partials in split order.
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(p.counters + tile, 1) == splits - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int i = tid; i < rows * (kBN / 4); i += kThreads) {
    const int r = i / (kBN / 4), col = f0 + 4 * (i % (kBN / 4));
    if (col >= p.F) continue;
    const size_t at = (size_t)(m0 + r) * p.F + col;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int z = 0; z < splits; ++z)
      add4(v, load4(p.ws + (size_t)z * p.M * p.F + at, p.F - col, vec));
    store4(p.y + at, scaled(v, col), p.F - col, vec);
  }
  if (tid == 0) p.counters[tile] = 0;
}

// --- host ---------------------------------------------------------------

template <int BM, int W, bool Grouped>
cudaError_t launch(const Params& p, int splits, cudaStream_t s) {
  using C = Cfg<BM, W>;
  cudaError_t err = cudaFuncSetAttribute(
      mm_f32<BM, W, Grouped>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kBytes);
  if (err != cudaSuccess) return err;
  const int nm = (p.M + BM - 1) / BM, nf = (p.F + kBN - 1) / kBN;
  mm_f32<BM, W, Grouped>
      <<<dim3(nm * nf, splits), kThreads, C::kBytes, s>>>(p);
  return cudaGetLastError();
}

template <int BM, bool Grouped>
cudaError_t by_weight(const Params& p, int weight, int splits,
                      cudaStream_t s) {
  switch (weight) {
    case kDense:
      return launch<BM, kDense, Grouped>(p, splits, s);
    case kInt8:
      return launch<BM, kInt8, Grouped>(p, splits, s);
    case kE4M3:
      return launch<BM, kE4M3, Grouped>(p, splits, s);
    case kE5M2:
      return launch<BM, kE5M2, Grouped>(p, splits, s);
    case kInt4:
      return launch<BM, kInt4, Grouped>(p, splits, s);
  }
  return cudaErrorInvalidValue;
}

template <bool Grouped>
cudaError_t dispatch(const Params& p, int weight, int tile_rows, int splits,
                     cudaStream_t s) {
  switch (tile_rows) {
    case 16:
      return by_weight<16, Grouped>(p, weight, splits, s);
    case 32:
      return by_weight<32, Grouped>(p, weight, splits, s);
    case 64:
      return by_weight<64, Grouped>(p, weight, splits, s);
    case 128:
      return by_weight<128, Grouped>(p, weight, splits, s);
  }
  return cudaErrorInvalidValue;
}

// The launch's Params, or false when the plan (ffma_plan) does not fit
// the shape: tile rows 16 / 32 / 64 / 128; K in `splits` ranges of
// k_chunk rows (a multiple of 128), none empty (K = 0: one split); the
// workspace and counters when splits > 1.
inline bool make_params(Params& p, const void* x, const void* w,
                        const void* scale, const int* offsets, void* y,
                        int M, int K, int F, int E, int weight,
                        int tile_rows, int splits, int k_chunk, void* ws,
                        void* counters) {
  if (M <= 0 || K < 0 || F <= 0 || E < 1 || weight < kDense ||
      weight > kInt4 || (weight != kDense && scale == nullptr) ||
      (weight == kInt4 && K % kGroup))
    return false;
  if (tile_rows != 16 && tile_rows != 32 && tile_rows != 64 &&
      tile_rows != 128)
    return false;
  if (K == 0 ? splits != 1
             : splits < 1 || k_chunk <= 0 || k_chunk % kGroup ||
                   (long)(splits - 1) * k_chunk >= K ||
                   (long)splits * k_chunk < K)
    return false;
  if (splits > 1 && (ws == nullptr || counters == nullptr)) return false;
  const bool packed = weight == kInt4;
  const int eb = weight == kDense ? 4 : 1;      // bytes a stored value
  auto al = [](const void* q) {
    return reinterpret_cast<uintptr_t>(q) % 16 == 0;
  };
  p = Params{static_cast<const float*>(x),
             static_cast<const unsigned char*>(w),
             static_cast<const float*>(scale),
             offsets,
             static_cast<float*>(y),
             static_cast<float*>(ws),
             static_cast<int*>(counters),
             M, K, F, E, K == 0 ? kGroup : k_chunk,
             (size_t)(packed ? K / 2 : K) * F * eb,
             packed ? (size_t)(K / kGroup) * F : (size_t)F,
             K % 4 == 0 && al(x),
             (F * eb) % 16 == 0 && al(w),
             F % 4 == 0 && al(y) && (ws == nullptr || al(ws))};
  return true;
}

// B6 / B7 / B8 (matmul_f32.cu) and B9 (matmul_f32_grouped.cu).
cudaError_t quant(const Params& p, int weight, int tile_rows, int splits,
                  cudaStream_t s);
cudaError_t grouped(const Params& p, int weight, int tile_rows, int splits,
                    cudaStream_t s);

}  // namespace f32
}  // namespace fa_mm
