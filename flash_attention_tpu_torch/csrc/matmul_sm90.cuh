// The Hopper bodies of B6 / B7 / B8 (ops/quant_matmul.py) and B9
// (ops/grouped.py) for fp16 / bf16 activations, over sm90_attn.cuh.
//
// Replaces the Pallas TPU kernels of flash_attention_tpu/ops:
//   B6 quant_matmul.py `_kernel` (:41, launched at :98), B7 `_int4_kernel`
//   (:214, :305), B8 `_dense_kernel` (:141, :189) and B9 grouped.py
//   `_grouped_kernel` (:132, :283).
// Instantiated per activation type in matmul_sm90_{bf16,f16}.cu (B6-B8
// above the decode threshold), matmul_decode_{bf16,f16}.cu (B6-B8 at a
// few rows) and grouped_sm90_{bf16,f16}.cu (B9). fp32 activations run
// the FFMA body of matmul_f32.cuh; fp16 / bf16 operands TMA cannot
// address (a base or row stride that is not a multiple of 16 bytes) keep
// the first body (matmul_core.cuh).
//
// What bounds it on the H100. Prefill (hundreds of rows; B9's 8192
// sorted rows): operations -- 1024 x 14336 x 4096 is 0.12 TFLOP, 0.122
// ms at 989 TFLOP/s. Decode (8-64 rows): bytes -- each weight byte is
// read once and does 2 M FLOPs (int8) or 4 M (int4), far below the ~295
// FLOPs a byte at which the tensor cores become the limit; w_down 14336 x
// 4096 is 17.7 us in int8 and 9.5 us in int4 at 3.35 TB/s.
//
// The design, one pipeline for both:
//  - a producer warp whose lane 0 keeps TMA rings full: the weight at
//    its storage width (1 byte a value for int8 / fp8, half a byte for
//    int4, with the stage's fp32 scale row; a dense weight lands directly
//    in the swizzled operand layout), and the activation tiles (2-D map
//    [M, K]; ragged M and K read as zeros through the map's
//    out-of-bounds fill);
//  - converter warps (quantized storages: 8 in a prefill block, 4 in a
//    decode block) that widen a stage of codes into a swizzled 16-bit
//    weight tile (Sw::offset), overlapping the next stage's copy and the
//    consumers' products: B6 widens each code exactly (its channel scale
//    multiplies the fp32 sum once, at the store); B7 and B9 multiply each
//    value by its fp32 scale (int4: the group's; B9 int8 / fp8: the
//    (expert, channel) one) and round it to T before the product, as the
//    JAX kernels do;
//  - consumer warpgroups issuing wgmma with fp32 accumulators in
//    registers for the whole K loop, one product in flight
//    (wgmma_wait<1>).
// Prefill (NP = 0): a block owns 128 rows x 128 columns of y (two
// consumer warpgroups of 64 rows), A = x K-major, B = the weight tile
// MN-major (Mma::sst<0, 1>), K steps of 64; blocks walk the tiles in
// groups of 16 row tiles, so a weight column tile is read once while x
// stays in L2. Decode (NP = 16 or 64): y^T = W^T x^T, so no tensor work
// is spent on rows past M: a block owns 64 columns of y, A = the widened
// weight tile (MN-major, Mma::sst<1, 0>), B = x^T with N = NP rows, K
// steps of 128 (half the hand-offs a byte of 64); K is split across
// blocks (ops/quant_matmul.py decode_split_plan: at least two blocks an
// SM on every product of the 8B decode step, two resident an SM), and
// each split writes fp32
// partials that the last block of the column tile sums in split order
// 0, 1, ... (a counter the block resets itself), scales (B6) and rounds:
// no atomics into y, and a rerun gives identical bits. What still holds
// decode at ~2.5x its byte bound is not found: neither more converter
// warps, deeper rings, 128-byte code rows, independent accumulator sets
// nor a second producer lane moved it (PERF.md §6, §7).
// B9: the grid is sized from M and F alone (the offsets never leave the
// device); every expert whose rows meet a 128-row tile runs its K loop
// into the same accumulators, and in a tile that straddles experts each
// warpgroup zeroes its rows outside the expert's [lo, hi) in the landed
// x stage (a branch uniform across the warpgroup; the products stay
// unconditional and the barrier ids immediate: with a conditional
// product and a register barrier id, B9 over one expert ran 36% slower
// than B8 on the same shape). An empty
// expert, or one outside the tile, costs nothing; a tile past the data
// stores zeros.
// Tensor maps are cached on the host, keyed on everything a map holds
// (address, type, dims, strides, box, swizzle), so a long-lived weight is
// encoded once; they reach the kernel as __grid_constant__ parameters.
//
// The probes P1 and P3 (flash_attention_tpu_torch/scripts) run the decode
// body too, bf16 at NP = 64, with x cut into 64-row slices by the grid's
// third dimension (any M): P1 v2 on offset-binary nibbles (kInt4Ob: the
// converter is B7's without its sign xor), P1 v1 (kInt4ObBias: the
// converter makes the exact bf16 of 128 + u by prmt / lop3 and one packed
// fma with the bf16 scale s_b gives u s_b; the - 8 s_b stays out of the
// weight as an fp32 correction: the converters also sum the step's x
// tile per row over its 128 rows (one scale group) and leave the sums
// and s_b in the stage's slots, the consumers grow the correction from
// them in registers beside the accumulators, and each split's partial
// subtracts 8 times its own), and P3 (storage kInt4, epilogue kArgmax:
// each x row's largest fp32 logit over the block's columns, lowest
// column first, as one 64-bit atomicMax key into the row's slot of its
// column chunk; splits = 1, since an argmax needs whole sums).
#pragma once

#include <cstring>
#include <mutex>
#include <type_traits>
#include <unordered_map>

#include "sm90_attn.cuh"

namespace fa_mm {
namespace hopper {

namespace sm90 = fa::sm90;
using fa::kDense;
using fa::kE4M3;
using fa::kE5M2;
using fa::kInt8;
constexpr int kInt4 = 4;       // packed int4 (matmul_core.cuh kInt4)
// P1's offset-binary int4 (nibble u = q + 8, kInt4's packing and scales;
// matmul_core.cuh's codes): v2 widens (u - 8) s, v1 keeps the + 8.
constexpr int kInt4Ob = 5;
constexpr int kInt4ObBias = 6;
constexpr int kGroup = 128;    // int4 rows per scale group
constexpr int kGroupRows = 16;  // row tiles a raster group walks together
// Epilogues of the decode body: store y (B6-B8, P1), P3's argmax keys.
constexpr int kStoreY = 0;
constexpr int kArgmax = 1;

struct Args {
  const float* scale;   // B6: [F] channel scales, applied at the store
  const int* offsets;   // B9: [E + 1] group offsets on the device
  void* y;              // [M, F] in T
  float* ws;            // decode with splits > 1: [splits, M, F] partials
  int* counters;        // decode: one per (x slice, column tile), 0
                        // between launches
  int M, K, F, E;
  int k_chunk;          // decode: K rows a split (a multiple of kGroup)
  unsigned long long* keys;   // P3: [ceil(F / key_chunk), M], zeroed
  int key_chunk;        // P3: columns a key slot spans (a multiple of 64)
};

struct Maps {
  CUtensorMap x, w, s;
};

// Tiles, threads and shared memory of one instantiation. T: fp16 / bf16;
// W: weight storage; NP: 0 for the prefill body, else the decode body's
// x rows (N of y^T); G: B9; E: the decode body's epilogue.
template <typename T, int W, int NP, bool G, int E = kStoreY>
struct Cfg {
  static constexpr bool kDecode = NP > 0;
  static constexpr bool kQuant = W != kDense;
  static constexpr bool kPacked =
      W == kInt4 || W == kInt4Ob || W == kInt4ObBias;
  static constexpr bool kBias = W == kInt4ObBias;   // P1 v1's correction
  // A scale row with every code stage (int4's group scales, B9's
  // per-expert channel scales); B6 scales at the store.
  static constexpr bool kScaleRow = kPacked || (G && kQuant);
  static constexpr bool kScaleAtStore = kQuant && !kScaleRow;
  static constexpr int kWG = kDecode ? 1 : 2;
  static constexpr int kRows = kDecode ? NP : 64 * kWG;   // x rows a stage
  // Logical K rows a stage: 64 (a 128-byte row of T) in the prefill body,
  // 128 in the decode body, whose stages are short: fewer hand-offs a
  // byte.
  static constexpr int kK = kDecode ? 128 : 64;
  static constexpr int kBN = kDecode ? 64 : 128;           // columns of y
  // fp32 accumulators a consumer thread keeps: one m64n128 (prefill: its
  // warpgroup's 64 rows of x against the 128 columns) or one m64nNP
  // (decode: the 64 columns against x's rows).
  static constexpr int kAcc = kDecode ? NP / 2 : kBN / 2;
  // Rings: x tiles (the producer, kXStages), widened weight tiles (the
  // converters, kStages; a dense weight lands with its x tile), codes
  // (the producer, kCodeStages). A decode block gives its shared memory
  // to codes in flight: the bytes a block keeps in flight set its rate.
  // int4 at NP = 64 (B7 at 17-64 rows, P1, P3): three of each. In
  // development a third x stage, then a third widened stage, ran faster;
  // deeper code rings, x boxes of the real rows only and one block an SM
  // with four of each did not.
  static constexpr int kStages =
      !kDecode ? 4 : kQuant ? (NP <= 16 ? 3 : kPacked ? 3 : 2)
                   : NP <= 16 ? 5 : 3;
  static constexpr int kXStages =
      !kQuant ? kStages : !kDecode ? 4 : NP <= 16 ? 4 : kPacked ? 3 : 2;
  static constexpr int kCodeStages =
      !kQuant ? 0 : !kDecode ? 4 : kPacked ? (NP <= 16 ? 10 : 3)
                                           : (NP <= 16 ? 5 : 4);
  static constexpr int kConsumers = 128 * kWG;
  // Converter threads: 8 warps beside the prefill body's two consumer
  // warpgroups (the widening keeps pace with the wgmma), 4 in a decode
  // block (two blocks an SM; more did not run faster).
  static constexpr int kConverters = !kQuant ? 0 : kDecode ? 128 : 256;
  static constexpr int kThreads = kConsumers + kConverters + 32;
  static constexpr int kMinBlocks = kDecode ? 2 : 1;
  static constexpr uint32_t kXBytes = kRows * kK * 2;
  static constexpr uint32_t kWBytes = kK * kBN * 2;
  static constexpr int kCodeRows = kPacked ? kK / 2 : kK;
  static constexpr uint32_t kCodeBytes = kCodeRows * kBN;
  static constexpr uint32_t kScaleBytes = kScaleRow ? kBN * 4 : 0;
  static constexpr uint32_t kCodeStage =
      (kCodeBytes + kScaleBytes + 127) / 128 * 128;
  static constexpr uint32_t kX = 0;
  static constexpr uint32_t kW = kX + kXStages * kXBytes;
  static constexpr uint32_t kCodes = kW + kStages * kWBytes;
  // P1 v1: each widened stage's scale row rounded to T and its x rows'
  // 128-row group sums (written by the converters, read by the consumers
  // for the correction).
  static constexpr uint32_t kSb = kCodes + kCodeStages * kCodeStage;
  static constexpr uint32_t kXsum = kSb + (kBias ? kStages * kBN * 4 : 0);
  // P3: the four consumer warps' (value, column) winners of each x row.
  static constexpr uint32_t kRed =
      kXsum + (kBias ? kStages * kRows * 4 : 0);
  static constexpr uint32_t kBars =
      kRed + (E == kArgmax ? 4 * kRows * 8 : 0);
  // xfull[XS], xempty[XS], wfull[S], wempty[S], cfull[CS], cempty[CS]
  static constexpr int kNumBars =
      2 * kXStages + 2 * kStages + 2 * kCodeStages;
  static constexpr uint32_t kFlag = kBars + 8 * kNumBars;
  static constexpr uint32_t kBytes = kFlag + 16 + 1024;
  static_assert(kXBytes % 1024 == 0 && kWBytes % 1024 == 0,
                "swizzled stages must stay 1024-byte aligned");
  static_assert(!kBias || (kDecode && NP == 64 && kConverters == 128 &&
                           std::is_same_v<T, __nv_bfloat16>),
                "P1 v1 runs the bf16 decode body at NP = 64: a converter "
                "pair a row");
  static_assert(E == kStoreY || (kDecode && !G),
                "the argmax epilogue is the decode body's");
  // 228 KB an SM, 1 KB of it reserved per block.
  static_assert((kBytes + 1024) * kMinBlocks <= 233472,
                "matmul stages exceed shared memory");
};

// 8 packed int4 bytes -> the 8 low nibbles (logical row 2j) and the 8
// high nibbles (row 2j + 1) as exact floats in -8..7: (u ^ kXor) placed in
// the mantissa of 2^23 by a byte permute, minus 2^23 + 8. kXor 8 a byte
// reads two's-complement nibbles (B7), 0 offset-binary ones (P1 v2).
template <uint32_t kXor = 0x08080808u>
__device__ __forceinline__ void nibbles8(const uint2& raw, float* lo,
                                         float* hi) {
  const uint32_t w[2] = {raw.x, raw.y};
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const uint32_t l = (w[q] & 0x0F0F0F0Fu) ^ kXor;
    const uint32_t h = ((w[q] >> 4) & 0x0F0F0F0Fu) ^ kXor;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      lo[4 * q + i] =
          __uint_as_float(__byte_perm(l, 0x4B000000u, 0x7440u + i)) -
          8388616.f;
      hi[4 * q + i] =
          __uint_as_float(__byte_perm(h, 0x4B000000u, 0x7440u + i)) -
          8388616.f;
    }
  }
}

// 8 floats rounded to T, two at a time, as one 16-byte store.
template <typename T>
__device__ __forceinline__ uint4 pack8_pairs(const float* v) {
  return make_uint4(sm90::pack2<T>(v[0], v[1]), sm90::pack2<T>(v[2], v[3]),
                    sm90::pack2<T>(v[4], v[5]), sm90::pack2<T>(v[6], v[7]));
}

// Two bytes' low (or high) nibbles as a bf16x2 of the exact integers
// 128 + u: t holds the bytes in the low byte of each half-word (prmt),
// the mask and the exponent of 128 combine in one lop3
// (matmul_core.cuh's nibbles_plus_128).
__device__ __forceinline__ uint32_t nibbles_plus_128(uint32_t t) {
  return (t & 0x000F000Fu) | 0x43004300u;
}

// (128 + u) s_b - 128 s_b for a bf16x2 pair: u s_b, rounded once (the
// packed fma is fused and 128 s_b is exact in bf16).
__device__ __forceinline__ uint32_t bias_fma(uint32_t biased, uint32_t s2,
                                             uint32_t nb2) {
  const __nv_bfloat162 r =
      __hfma2(*reinterpret_cast<const __nv_bfloat162*>(&biased),
              *reinterpret_cast<const __nv_bfloat162*>(&s2),
              *reinterpret_cast<const __nv_bfloat162*>(&nb2));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// One converter's share of a code stage: codes [kCodeRows][BN] (row-major
// bytes) widened into the swizzled [KR][BN] T tile at dst. Converter ct
// of NT owns one 8-column group and every (NT / (BN / 8))-th row; its
// loads are issued together (the trip count is a constant).
// kLoopScale: each value times srow[column] in fp32, rounded to T (int4
// always; B9's int8 / fp8); otherwise each code widens exactly.
// kInt4ObBias (P1 v1): each value u s_b with s_b = srow rounded to T, and
// the converters of the stage's first rows also write s_b to sb_out.
template <typename T, int W, int KR, int BN, int NT, bool kLoopScale>
__device__ __forceinline__ void widen_stage(unsigned char* dst,
                                            const unsigned char* codes,
                                            const float* srow, int ct,
                                            float* sb_out) {
  constexpr bool kPacked4 = W == kInt4 || W == kInt4Ob || W == kInt4ObBias;
  constexpr int kGroups = BN / 8;
  constexpr int kRowStep = NT / kGroups;
  constexpr int kCodeRows = kPacked4 ? KR / 2 : KR;
  constexpr int kPer = kCodeRows / kRowStep;
  static_assert(kCodeRows % kRowStep == 0, "converters must tile a stage");
  using L = sm90::Sw<BN>;
  const int g = ct % kGroups, r0 = ct / kGroups;
  float sc[8];
  if constexpr (kLoopScale) {
    const float4 s0 = *reinterpret_cast<const float4*>(srow + 8 * g);
    const float4 s1 = *reinterpret_cast<const float4*>(srow + 8 * g + 4);
    sc[0] = s0.x; sc[1] = s0.y; sc[2] = s0.z; sc[3] = s0.w;
    sc[4] = s1.x; sc[5] = s1.y; sc[6] = s1.z; sc[7] = s1.w;
  }
  // P1 v1: s_b and -128 s_b of the group's columns as bf16x2 pairs.
  uint32_t s2[4], nb2[4];
  if constexpr (W == kInt4ObBias) {
    float sb[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) sb[e] = fa::round_to<T>(sc[e]);
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      s2[p] = sm90::pack2<T>(sb[2 * p], sb[2 * p + 1]);
      nb2[p] = sm90::pack2<T>(-128.f * sb[2 * p], -128.f * sb[2 * p + 1]);
    }
    if (r0 == 0) {
      *reinterpret_cast<float4*>(sb_out + 8 * g) =
          make_float4(sb[0], sb[1], sb[2], sb[3]);
      *reinterpret_cast<float4*>(sb_out + 8 * g + 4) =
          make_float4(sb[4], sb[5], sb[6], sb[7]);
    }
  }
  uint2 raw[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j)
    raw[j] = *reinterpret_cast<const uint2*>(
        codes + (r0 + j * kRowStep) * BN + 8 * g);
  // kRowStep is a multiple of 8 rows, so the swizzle of a converter's
  // rows repeats: one offset, then whole rows apart.
  static_assert(kRowStep % 8 == 0, "rows of one swizzle phase");
  constexpr int kRowsPerStep = kPacked4 ? 2 * kRowStep : kRowStep;
  unsigned char* out = dst + L::offset(KR, kPacked4 ? 2 * r0 : r0, 8 * g);
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    unsigned char* o = out + j * kRowsPerStep * L::kRowBytes;
    // int4: logical rows 2r and 2r + 1 are neighbours of one swizzle
    // phase pair: their offsets differ by a row and the XOR of row bit 0.
    unsigned char* o_hi =
        dst + L::offset(KR, 2 * (r0 + j * kRowStep) + 1, 8 * g);
    if constexpr (W == kInt4ObBias) {
      // Bytes 2p, 2p + 1 into the low bytes of a word's half-words, then
      // their low and high nibbles as (128 + u) pairs.
      const uint32_t w[2] = {raw[j].x, raw[j].y};
      uint32_t lo[4], hi[4];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const uint32_t t =
            __byte_perm(w[p / 2], 0, (p & 1) ? 0x4342 : 0x4140);
        lo[p] = bias_fma(nibbles_plus_128(t), s2[p], nb2[p]);
        hi[p] = bias_fma(nibbles_plus_128(t >> 4), s2[p], nb2[p]);
      }
      *reinterpret_cast<uint4*>(o) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      *reinterpret_cast<uint4*>(o_hi) =
          make_uint4(hi[0], hi[1], hi[2], hi[3]);
    } else if constexpr (kPacked4) {
      float lo[8], hi[8];
      nibbles8<W == kInt4 ? 0x08080808u : 0u>(raw[j], lo, hi);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        lo[e] *= sc[e];
        hi[e] *= sc[e];
      }
      *reinterpret_cast<uint4*>(o) = pack8_pairs<T>(lo);
      *reinterpret_cast<uint4*>(o_hi) = pack8_pairs<T>(hi);
    } else {
      float v[8];
      fa::widen8_fast<W>(raw[j], v);
      if constexpr (kLoopScale) {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] *= sc[e];
        *reinterpret_cast<uint4*>(o) = pack8_pairs<T>(v);
      } else if constexpr (std::is_same_v<T, __nv_bfloat16>) {
        // B6: every int8 / fp8 code has at most 8 significant bits, so
        // its float's upper half is its bf16, exactly (no rounding).
        uint32_t b[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) b[e] = __float_as_uint(v[e]);
        *reinterpret_cast<uint4*>(o) =
            make_uint4(__byte_perm(b[0], b[1], 0x7632),
                       __byte_perm(b[2], b[3], 0x7632),
                       __byte_perm(b[4], b[5], 0x7632),
                       __byte_perm(b[6], b[7], 0x7632));
      } else {
        *reinterpret_cast<uint4*>(o) = pack8_pairs<T>(v);
      }
    }
  }
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

// (value, column) -> a key whose unsigned order is value order, then
// lowest column first; -0 counts as +0. Any real key is above 0.
__device__ __forceinline__ unsigned long long argmax_key(float v, int col) {
  if (v == 0.f) v = 0.f;
  unsigned int u = __float_as_uint(v);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (0xFFFFFFFFu - (unsigned int)col);
}

// Whether (ov, oc) beats (v, c) in the key order (c < 0: no candidate).
__device__ __forceinline__ bool beats(float ov, int oc, float v, int c) {
  return oc >= 0 && (c < 0 || ov > v || (ov == v && oc < c));
}

template <typename T, int W, int NP, bool G, int E = kStoreY>
__global__ void __launch_bounds__(Cfg<T, W, NP, G, E>::kThreads,
                                  Cfg<T, W, NP, G, E>::kMinBlocks)
    mm_sm90(const __grid_constant__ Maps maps, const Args a) {
  using C = Cfg<T, W, NP, G, E>;
  constexpr int kS = C::kStages, kXS = C::kXStages, kCS = C::kCodeStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = sm90::align_smem(smem_raw);
  uint64_t* xfull = reinterpret_cast<uint64_t*>(smem + C::kBars);
  uint64_t* xempty = xfull + kXS;
  uint64_t* wfull = xempty + kXS;
  uint64_t* wempty = wfull + kS;
  uint64_t* cfull = wempty + kS;
  uint64_t* cempty = cfull + kCS;

  // The block's tile: rows [m0, m0 + kRows) of y, columns [f0, f0 + kBN),
  // K steps [ks0, ks1).
  int m0 = 0, f0 = 0, k_lo = 0, k_hi = a.K;
  if constexpr (C::kDecode) {
    f0 = blockIdx.x * C::kBN;
    m0 = blockIdx.z * C::kRows;   // x in slices of NP rows (B6-B8: one)
    k_lo = blockIdx.y * a.k_chunk;
    k_hi = min(a.K, k_lo + a.k_chunk);
  } else {
    const int nm = (a.M + C::kRows - 1) / C::kRows;
    const int nf = (a.F + C::kBN - 1) / C::kBN;
    const int per_group = kGroupRows * nf;
    const int first = blockIdx.x / per_group * kGroupRows;
    const int gm = min(nm - first, kGroupRows);
    const int r = blockIdx.x % per_group;
    m0 = (first + r % gm) * C::kRows;
    f0 = (r / gm) * C::kBN;
  }
  const int ks0 = k_lo / C::kK, ks1 = (k_hi + C::kK - 1) / C::kK;
  const int tile_end = min(m0 + C::kRows, a.M);

  // Every role walks the same steps: (expert, K step) for each expert
  // whose rows meet the tile (B9), else the block's K steps. fn(it, e,
  // lo, hi, kt); lo / hi are the expert's rows within the tile.
  auto for_steps = [&](auto&& fn) {
    int it = 0;
    if constexpr (G) {
      for (int e = 0; e < a.E; ++e) {
        // Uniform across the block: every thread reads the same offsets.
        const int lo = max(__ldg(a.offsets + e), m0);
        const int hi = min(__ldg(a.offsets + e + 1), tile_end);
        if (lo >= hi) continue;
        for (int kt = ks0; kt < ks1; ++kt) fn(it++, e, lo, hi, kt);
      }
    } else {
      for (int kt = ks0; kt < ks1; ++kt) fn(it++, 0, 0, a.M, kt);
    }
  };

  // An x tile [kRows][kK] as its 64-column swizzled chunks.
  auto load_x = [&](unsigned char* dst, uint64_t* bar, int k0) {
#pragma unroll
    for (int c = 0; c < C::kK / 64; ++c)
      sm90::tma_load_3d(dst + c * C::kRows * 128, &maps.x, bar, k0 + 64 * c,
                        m0, 0);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kXS; ++s) {
      sm90::mbar_init(&xfull[s], 1);
      sm90::mbar_init(&xempty[s], 4 * C::kWG);   // one per consumer warp
    }
    for (int s = 0; s < kS; ++s) {
      sm90::mbar_init(&wfull[s], C::kConverters > 0 ? C::kConverters / 32
                                                    : 1);   // per warp
      sm90::mbar_init(&wempty[s], 4 * C::kWG);
    }
    for (int c = 0; c < kCS; ++c) {
      sm90::mbar_init(&cfull[c], 1);
      sm90::mbar_init(&cempty[c], C::kConverters / 32);   // per warp
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  const int tid = threadIdx.x;
  if (tid >= C::kConsumers + C::kConverters) {
    // --- producer: lane 0 keeps the TMA rings full ---
    if (tid != C::kConsumers + C::kConverters) return;
    for_steps([&](int it, int e, int, int, int kt) {
      const int k0 = kt * C::kK;
      if constexpr (!C::kQuant) {
        // x and the dense weight tile land together on the x ring.
        const int s = it % kS;
        sm90::mbar_wait(&xempty[s], ((it / kS) & 1) ^ 1);
        sm90::mbar_expect_tx(&xfull[s], C::kXBytes + C::kWBytes);
        load_x(smem + C::kX + s * C::kXBytes, &xfull[s], k0);
        unsigned char* wt = smem + C::kW + s * C::kWBytes;
#pragma unroll
        for (int c = 0; c < C::kBN / 64; ++c)
          sm90::tma_load_3d(wt + c * C::kK * 128, &maps.w, &xfull[s],
                            f0 + 64 * c, k0, e);
      } else {
        const int c = it % kCS;
        sm90::mbar_wait(&cempty[c], ((it / kCS) & 1) ^ 1);
        unsigned char* dst = smem + C::kCodes + c * C::kCodeStage;
        sm90::mbar_expect_tx(&cfull[c], C::kCodeBytes + C::kScaleBytes);
        sm90::tma_load_3d(dst, &maps.w, &cfull[c], f0,
                          C::kPacked ? k0 / 2 : k0, e);
        if constexpr (C::kScaleRow)
          sm90::tma_load_3d(dst + C::kCodeBytes, &maps.s, &cfull[c], f0,
                            C::kPacked ? k0 / kGroup : 0, e);
        const int xs = it % kXS;
        sm90::mbar_wait(&xempty[xs], ((it / kXS) & 1) ^ 1);
        sm90::mbar_expect_tx(&xfull[xs], C::kXBytes);
        load_x(smem + C::kX + xs * C::kXBytes, &xfull[xs], k0);
      }
    });
    return;
  }

  if constexpr (C::kQuant) {
    if (tid >= C::kConsumers) {
      // --- converters: codes ring -> swizzled T ring ---
      const int ct = tid - C::kConsumers;
      for_steps([&](int it, int, int, int, int) {
        const int s = it % kS, c = it % kCS;
        sm90::mbar_wait(&wempty[s], ((it / kS) & 1) ^ 1);
        if constexpr (C::kBias) {
          // P1 v1: converter pair (2r, 2r + 1) sums x row r's two
          // 64-column chunks of the step's x tile (16-byte units rotated
          // by row and chunk, so a quarter warp reads 8 distinct bank
          // groups) into the stage's slot. The tile is read before wfull,
          // so before the consumers can release it.
          const int xs = it % kXS, r = ct >> 1, h = ct & 1;
          sm90::mbar_wait(&xfull[xs], (it / kXS) & 1);
          const unsigned char* xrow =
              smem + C::kX + xs * C::kXBytes + h * C::kRows * 128 + r * 128;
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const uint4 u = *reinterpret_cast<const uint4*>(
                xrow + 16 * ((j + r + 4 * h) & 7));
            const uint32_t v[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
            for (int e = 0; e < 4; ++e)
              sum += __uint_as_float(v[e] << 16) +
                     __uint_as_float(v[e] & 0xFFFF0000u);
          }
          sum += __shfl_xor_sync(0xffffffffu, sum, 1);
          if (h == 0)
            reinterpret_cast<float*>(smem + C::kXsum)[s * C::kRows + r] = sum;
        }
        sm90::mbar_wait(&cfull[c], (it / kCS) & 1);
        const unsigned char* codes = smem + C::kCodes + c * C::kCodeStage;
        widen_stage<T, W, C::kK, C::kBN, C::kConverters, C::kScaleRow>(
            smem + C::kW + s * C::kWBytes, codes,
            reinterpret_cast<const float*>(codes + C::kCodeBytes), ct,
            reinterpret_cast<float*>(smem + C::kSb) + s * C::kBN);
        // Each thread orders its stores before the async proxy's reads;
        // the warp's lane 0 then releases the stage (the T tile is
        // written, the codes read).
        sm90::fence_async_smem();
        __syncwarp();
        if ((ct & 31) == 0) {
          sm90::mbar_arrive(&wfull[s]);
          sm90::mbar_arrive(&cempty[c]);
        }
      });
      return;
    }
  }

  // --- consumer warpgroups ---
  const int cw = tid / 128, t = tid % 128, lane = tid % 32;
  const sm90::Frag f(t);
  float acc[C::kAcc];
#pragma unroll
  for (int i = 0; i < C::kAcc; ++i) acc[i] = 0.f;
  // P1 v1: sum over the steps of (x row's 128-row group sum) x s_b, one
  // per accumulator (the same row and column).
  float corr[C::kBias ? C::kAcc : 1];
#pragma unroll
  for (int i = 0; i < (C::kBias ? C::kAcc : 1); ++i) corr[i] = 0.f;
  const uint32_t sx = sm90::smem_u32(smem + C::kX);
  const uint32_t sw = sm90::smem_u32(smem + C::kW);
  const int mb = m0 + 64 * cw;   // prefill: the warpgroup's first row
  int prev = -1;
  for_steps([&](int it, int, int lo, int hi, int) {
    const int s = it % kS, xs = it % kXS;
    sm90::mbar_wait(&xfull[xs], (it / kXS) & 1);
    if constexpr (C::kQuant) sm90::mbar_wait(&wfull[s], (it / kS) & 1);
    if constexpr (G) {
      if (lo > mb || hi < min(mb + 64, a.M)) {
        // The tile straddles experts: this warpgroup's rows outside
        // [lo, hi) read as zeros for this expert (rows past M already
        // do). Uniform across the warpgroup; rare (a tile an expert
        // boundary).
        const int row = mb + t / 2;
        if (row < lo || row >= hi) {
          uint4* p = reinterpret_cast<uint4*>(
              smem + C::kX + xs * C::kXBytes + (64 * cw + t / 2) * 128 +
              (t % 2) * 64);
#pragma unroll
          for (int j = 0; j < 4; ++j) p[j] = make_uint4(0, 0, 0, 0);
        }
        sm90::fence_async_smem();
        if (cw == 0)
          asm volatile("bar.sync 2, 128;\n" ::: "memory");
        else
          asm volatile("bar.sync 3, 128;\n" ::: "memory");
      }
    }
    sm90::wgmma_fence();
    const uint32_t xa = sx + xs * C::kXBytes, wa = sw + s * C::kWBytes;
#pragma unroll
    for (int kk = 0; kk < C::kK / 16; ++kk) {
      if constexpr (C::kDecode)
        sm90::Mma<T, NP>::template sst<1, 0>(
            acc, sm90::mn_major<64>(wa, C::kK, kk),
            sm90::k_major<C::kK>(xa, NP, 0, kk), 1);
      else
        sm90::Mma<T, C::kBN>::template sst<0, 1>(
            acc, sm90::k_major<C::kK>(xa, C::kRows, 64 * cw, kk),
            sm90::mn_major<C::kBN>(wa, C::kK, kk), 1);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();
    sm90::fence_regs(acc);
    // The product before this one has finished reading its stages.
    if (prev >= 0) {
      __syncwarp();
      if (lane == 0) {
        sm90::mbar_arrive(&xempty[prev % kXS]);
        if constexpr (C::kQuant) sm90::mbar_arrive(&wempty[prev % kS]);
      }
    }
    prev = it;
    if constexpr (C::kBias) {
      // While this step's product runs (its stages stay held until the
      // next step releases them): corr += the rows' 128-row group sums
      // times the columns' s_b, both left in the stage's slots by the
      // converters.
      const float* xsum =
          reinterpret_cast<const float*>(smem + C::kXsum) + s * C::kRows;
      const float* sb = reinterpret_cast<const float*>(smem + C::kSb) +
                        s * C::kBN;
      const float s_lo = sb[f.row], s_hi = sb[f.row + 8];
#pragma unroll
      for (int i = 0; i < C::kAcc; ++i)
        corr[i] += xsum[f.col_of(i)] * (sm90::Frag::row_of(i) ? s_hi : s_lo);
    }
  });
  sm90::wgmma_wait<0>();
  sm90::fence_regs(acc);

  T* __restrict__ y = static_cast<T*>(a.y);
  const int M = a.M, F = a.F;
  // acc[i] less P1 v1's correction: the value a split contributes.
  auto value = [&](int i) {
    if constexpr (C::kBias)
      return acc[i] - 8.f * corr[i];
    else
      return acc[i];
  };
  if constexpr (E == kArgmax) {
    // P3: each x row's winner over the block's columns below F from the
    // fp32 accumulators (register i: column f0 + f.row + row_of(i), row
    // m0 + col_of(i)): a thread's two, the 8 quads of its warp by
    // shuffles, the 4 warps in order through shared memory; then one
    // atomicMax of the row's key into its slot of the column chunk. The
    // key order is total, so the result does not depend on the order
    // blocks finish in.
    float* red_v = reinterpret_cast<float*>(smem + C::kRed);
    int* red_c = reinterpret_cast<int*>(red_v + 4 * C::kRows);
    const int warp = t / 32, c0 = f0 + f.row;
#pragma unroll
    for (int jb = 0; jb < NP / 8; ++jb) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * jb + e;
        float v = acc[i];
        int c = c0 < F ? c0 : -1;
        if (beats(acc[i + 2], c0 + 8 < F ? c0 + 8 : -1, v, c)) {
          v = acc[i + 2];
          c = c0 + 8;
        }
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, v, o);
          const int oc = __shfl_xor_sync(0xffffffffu, c, o);
          if (beats(ov, oc, v, c)) {
            v = ov;
            c = oc;
          }
        }
        if (lane < 4) {
          red_v[warp * C::kRows + f.col_of(i)] = v;
          red_c[warp * C::kRows + f.col_of(i)] = c;
        }
      }
    }
    consumers_sync();
    if (t < C::kRows && m0 + t < M) {
      float v = red_v[t];
      int c = red_c[t];
#pragma unroll
      for (int w = 1; w < 4; ++w) {
        if (beats(red_v[w * C::kRows + t], red_c[w * C::kRows + t], v, c)) {
          v = red_v[w * C::kRows + t];
          c = red_c[w * C::kRows + t];
        }
      }
      if (c >= 0)
        atomicMax(a.keys + (size_t)(f0 / a.key_chunk) * M + m0 + t,
                  argmax_key(v, c));
    }
    return;
  }
  if constexpr (!C::kDecode) {
    // y[row, col] = acc (times B6's channel scale) in T; F is even, so a
    // column pair is in or out together.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = mb + f.row + 8 * r;
      if (row >= M) continue;
#pragma unroll
      for (int jb = 0; jb < C::kBN / 8; ++jb) {
        const int col = f0 + f.col_of(4 * jb);
        if (col >= F) continue;
        float v0 = acc[4 * jb + 2 * r], v1 = acc[4 * jb + 2 * r + 1];
        if constexpr (C::kScaleAtStore) {
          v0 *= __ldg(a.scale + col);
          v1 *= __ldg(a.scale + col + 1);
        }
        *reinterpret_cast<uint32_t*>(y + (size_t)row * F + col) =
            sm90::pack2<T>(v0, v1);
      }
    }
  } else {
    // acc holds y^T: register i is column f0 + f.row + row_of(i) of y,
    // row col_of(i).
    const int splits = gridDim.y;
    if (splits == 1) {
#pragma unroll
      for (int i = 0; i < C::kAcc; ++i) {
        const int m = m0 + f.col_of(i);
        const int col = f0 + f.row + sm90::Frag::row_of(i);
        if (m < M && col < F) {
          float v = value(i);
          if constexpr (C::kScaleAtStore) v *= __ldg(a.scale + col);
          y[(size_t)m * F + col] = fa::from_float<T>(v);
        }
      }
      return;
    }
    float* part = a.ws + (size_t)blockIdx.y * M * F;
#pragma unroll
    for (int i = 0; i < C::kAcc; ++i) {
      const int m = m0 + f.col_of(i);
      const int col = f0 + f.row + sm90::Frag::row_of(i);
      if (m < M && col < F) part[(size_t)m * F + col] = value(i);
    }
    __threadfence();
    consumers_sync();
    int* flag = reinterpret_cast<int*>(smem + C::kFlag);
    int* counter = a.counters + blockIdx.z * gridDim.x + blockIdx.x;
    if (t == 0) *flag = atomicAdd(counter, 1) == splits - 1;
    consumers_sync();
    if (*flag) {
      // The last split of this (x slice, column tile): sum in split
      // order, scale, round, store; then reset the counter for the next
      // launch.
      __threadfence();
      const int rows = min(C::kRows, M - m0);
      for (int idx = t; idx < rows * C::kBN; idx += 128) {
        const int m = m0 + idx / C::kBN, col = f0 + idx % C::kBN;
        if (col >= F) continue;
        float sum = 0.f;
        for (int sp = 0; sp < splits; ++sp)
          sum += __ldcg(a.ws + ((size_t)sp * M + m) * F + col);
        if constexpr (C::kScaleAtStore) sum *= __ldg(a.scale + col);
        y[(size_t)m * F + col] = fa::from_float<T>(sum);
      }
      if (t == 0) *counter = 0;
    }
  }
}

// --- host ---------------------------------------------------------------

// Everything a tensor map holds (no padding bytes: pad is zero).
struct MapKey {
  const void* base;
  int type, elem, heads, rows, d, box_cols, box_rows, swizzle, pad;
  bool operator==(const MapKey& o) const {
    return std::memcmp(this, &o, sizeof(MapKey)) == 0;
  }
};

static_assert(sizeof(MapKey) == 48, "MapKey has padding");

struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    const unsigned char* p = reinterpret_cast<const unsigned char*>(&k);
    size_t h = 1469598103934665603ull;
    for (size_t i = 0; i < sizeof(MapKey); ++i)
      h = (h ^ p[i]) * 1099511628211ull;
    return h;
  }
};

// sm90::encode_map through a cache keyed on the map's whole content, so a
// long-lived weight is encoded once. A map depends on nothing else, so a
// hit is always the map encode_map would build.
inline bool cached_map(CUtensorMap* out, const void* base,
                       CUtensorMapDataType type, int elem, int heads,
                       int rows, int d, int box_cols, int box_rows,
                       CUtensorMapSwizzle swizzle) {
  static std::mutex mu;
  static std::unordered_map<MapKey, CUtensorMap, MapKeyHash> cache;
  MapKey key{};
  key.base = base;
  key.type = (int)type;
  key.elem = elem;
  key.heads = heads;
  key.rows = rows;
  key.d = d;
  key.box_cols = box_cols;
  key.box_rows = box_rows;
  key.swizzle = (int)swizzle;
  std::lock_guard<std::mutex> lock(mu);
  auto hit = cache.find(key);
  if (hit != cache.end()) {
    *out = hit->second;
    return true;
  }
  if (!sm90::encode_map(out, base, type, elem, heads, rows, d, box_cols,
                        box_rows, swizzle))
    return false;
  if (cache.size() >= 8192) cache.clear();
  cache.emplace(key, *out);
  return true;
}

template <typename T, int W, int NP, bool G, int E = kStoreY>
cudaError_t launch(const void* x, const void* w, const void* scale,
                   const Args& a, int splits, cudaStream_t stream) {
  using C = Cfg<T, W, NP, G, E>;
  auto kernel = mm_sm90<T, W, NP, G, E>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kBytes);
  if (attr != cudaSuccess) return attr;
  constexpr CUtensorMapDataType kT = std::is_same_v<T, __nv_bfloat16>
                                         ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                         : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  const int heads = G ? a.E : 1;
  Maps maps{};
  bool ok = cached_map(&maps.x, x, kT, 2, 1, a.M, a.K, 64, C::kRows,
                       CU_TENSOR_MAP_SWIZZLE_128B);
  if constexpr (!C::kQuant)
    ok = ok && cached_map(&maps.w, w, kT, 2, heads, a.K, a.F, 64, C::kK,
                          CU_TENSOR_MAP_SWIZZLE_128B);
  else
    ok = ok && cached_map(&maps.w, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, heads,
                          C::kPacked ? a.K / 2 : a.K, a.F, C::kBN,
                          C::kCodeRows, CU_TENSOR_MAP_SWIZZLE_NONE);
  if constexpr (C::kScaleRow)
    ok = ok && cached_map(&maps.s, scale, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                          heads, C::kPacked ? a.K / kGroup : 1, a.F, C::kBN,
                          1, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (!ok) return cudaErrorInvalidValue;
  Args args = a;
  args.scale = C::kScaleAtStore ? static_cast<const float*>(scale) : nullptr;
  const int nf = (a.F + C::kBN - 1) / C::kBN;
  const int nm = (a.M + C::kRows - 1) / C::kRows;
  const dim3 grid = C::kDecode ? dim3(nf, splits, nm) : dim3(nm * nf);
  kernel<<<grid, C::kThreads, C::kBytes, stream>>>(maps, args);
  return cudaGetLastError();
}

// The prefill body of B6-B8 (G = false) or B9 (G = true) for one
// activation type, by weight storage.
template <typename T, bool G>
cudaError_t dispatch_prefill(const void* x, const void* w, const void* scale,
                             const Args& a, int weight, cudaStream_t s) {
  switch (weight) {
    case kDense: return launch<T, kDense, 0, G>(x, w, scale, a, 1, s);
    case kInt8: return launch<T, kInt8, 0, G>(x, w, scale, a, 1, s);
    case kE4M3: return launch<T, kE4M3, 0, G>(x, w, scale, a, 1, s);
    case kE5M2: return launch<T, kE5M2, 0, G>(x, w, scale, a, 1, s);
    case kInt4: return launch<T, kInt4, 0, G>(x, w, scale, a, 1, s);
  }
  return cudaErrorInvalidValue;
}

template <typename T, int NP>
cudaError_t dispatch_decode_np(const void* x, const void* w,
                               const void* scale, const Args& a, int weight,
                               int splits, cudaStream_t s) {
  switch (weight) {
    case kDense: return launch<T, kDense, NP, false>(x, w, scale, a, splits, s);
    case kInt8: return launch<T, kInt8, NP, false>(x, w, scale, a, splits, s);
    case kE4M3: return launch<T, kE4M3, NP, false>(x, w, scale, a, splits, s);
    case kE5M2: return launch<T, kE5M2, NP, false>(x, w, scale, a, splits, s);
    case kInt4: return launch<T, kInt4, NP, false>(x, w, scale, a, splits, s);
  }
  return cudaErrorInvalidValue;
}

// The decode body of B6-B8: x rows padded to 16 or 64.
template <typename T>
cudaError_t dispatch_decode(const void* x, const void* w, const void* scale,
                            const Args& a, int weight, int splits,
                            cudaStream_t s) {
  if (a.M <= 16)
    return dispatch_decode_np<T, 16>(x, w, scale, a, weight, splits, s);
  return dispatch_decode_np<T, 64>(x, w, scale, a, weight, splits, s);
}

// The body codes of a launch (ops/quant_matmul.py BODY_CODES): the first
// body (matmul_core.cuh), the prefill body, the split-K decode body (3:
// fp32's FFMA body, matmul_f32.cuh f32::kBody).
constexpr int kFirstBody = 0;
constexpr int kPrefillBody = 1;
constexpr int kDecodeBody = 2;

// One activation type each, compiled apart so the build runs them in
// parallel: matmul_sm90_{bf16,f16}.cu (B6-B8 prefill),
// grouped_sm90_{bf16,f16}.cu (B9), matmul_decode_{bf16,f16}.cu (B6-B8
// decode).
cudaError_t prefill_bf16(const void* x, const void* w, const void* scale,
                         const Args& a, int weight, cudaStream_t s);
cudaError_t prefill_f16(const void* x, const void* w, const void* scale,
                        const Args& a, int weight, cudaStream_t s);
cudaError_t grouped_bf16(const void* x, const void* w, const void* scale,
                         const Args& a, int weight, cudaStream_t s);
cudaError_t grouped_f16(const void* x, const void* w, const void* scale,
                        const Args& a, int weight, cudaStream_t s);
cudaError_t decode_bf16(const void* x, const void* w, const void* scale,
                        const Args& a, int weight, int splits,
                        cudaStream_t s);
cudaError_t decode_f16(const void* x, const void* w, const void* scale,
                       const Args& a, int weight, int splits,
                       cudaStream_t s);
// The probes' instantiations of the decode body (bf16, NP = 64, x in
// 64-row slices), one source each: P1 v2 and v1 (probe_int4_v2_sm90.cu,
// probe_int4_v1_sm90.cu), P3 (probe_lmhead_sm90.cu; splits = 1).
cudaError_t probe_int4_v2(const void* x, const void* w, const void* scale,
                          const Args& a, int splits, cudaStream_t s);
cudaError_t probe_int4_v1(const void* x, const void* w, const void* scale,
                          const Args& a, int splits, cudaStream_t s);
cudaError_t probe_lmhead(const void* x, const void* w, const void* scale,
                         const Args& a, cudaStream_t s);

}  // namespace hopper
}  // namespace fa_mm
