// The Hopper body of the decode attention kernels B4 (paged_decode.cu,
// K/V in page-table-indexed pools) and B5 (decode.cu, contiguous caches)
// for fp16 / bf16 queries: split-KV across blocks, tensor-core products,
// loads kept in flight, and a fixed-order merge inside the same launch.
//
// Replaces the Pallas TPU kernels flash_attention_tpu/ops/paged.py
// `_paged_kernel` (:37, launched at :305) and ops/decode.py
// `_decode_kernel` (:71, launched at :229). decode_core.cuh stays the
// body of an fp32 q (FFMA products) and of a B4 page size this body
// cannot walk (not a multiple of kSlab).
//
// What bounds both on the H100: bytes. Each visible position's K and V
// rows are read once per kv head and do 4 R D FLOPs for the R query rows
// of the head's group: R / 2 FLOPs a byte in bf16, far under the ~295 at
// which the tensor cores would be the limit. The first body held one
// block per (kv head, sequence): 32-128 blocks on 132 SMs at the engine's
// shapes, each walking a 4096-token window alone, with its loads and its
// CUDA-core products in separate phases. This body:
//
//  - Split-KV. The grid is (splits, Hkv * row groups, B); `splits` is
//    chosen on the host from shapes alone (ops/decode.py split_plan: one
//    wave of resident blocks, two an SM, one at D = 256, where the
//    tokens allow it), and each block
//    takes a contiguous, balanced share of its sequence's *visible*
//    16-token slabs, computed on the device from lengths[b] (and
//    starts[b]): the visible range [max(start, 0) rounded down to 16,
//    len), cut evenly. Slabs wholly below the window are never read, and
//    no block reads a page-table entry at or beyond ceil(len / ps).
//  - Warps as independent pipelines. A block is 4 warps; warp w takes
//    slabs w, w + 4, ... of the block's share, keeps its own ring of
//    kStages slabs in shared memory filled by cp.async (16-byte copies,
//    rows past len zero-filled), and its own online softmax (m, l) and
//    O accumulators in registers. Nothing in the slab loop waits on
//    another warp.
//  - Tensor cores (mma.sync m16n8k16, fp32 accumulate). The block's
//    query rows (at most kRows = 16; a wider group takes more blocks) are
//    the M side: S = q K^T is [16 rows, 16 tokens] (q fragments by
//    ldmatrix, K's by ldmatrix from the [token, channel] slab), the
//    softmax runs on S's accumulator fragment (a row's values on one
//    quad), P is rounded to T and becomes the A fragment of O += P V in
//    registers (V's B fragments by ldmatrix.trans).
//  - Quantized storage (int8 / e4m3 / e5m2, with an fp32 scale row per
//    128-token block and channel): the ring holds the codes and the
//    slab's two scale rows; the warp widens its slab once into T tiles
//    (code x scale in fp32, rounded to T: the JAX kernels' `_dequant`)
//    before its products. `Fold` (int8, B4's fold_scales body): q x the
//    K scale row is rounded to T once per 128-token block, the unscaled
//    codes (exact in T) enter both products, and each slab's PV partial
//    is multiplied by the V scale row before it joins the accumulator. A
//    slab never straddles a 128-token block.
//  - The merge. The block's 4 warps merge in shared memory (warp order
//    0..3). With one split the block writes O (and B4's LSE). Otherwise
//    it writes its partial (fp32 O over its rows, m, l) to a scratch area
//    the wrapper caches per (device, stream), and the last block of each
//    (sequence, kv head, row group) -- found by a counter it resets
//    itself -- merges the partials in split order 0, 1, 2, ... and
//    writes O and the LSE: no atomics into O, and identical bits on a
//    rerun. An empty share is the neutral partial (m = kInitM, l = 0),
//    so a row that sees nothing gives exactly O = 0 and LSE = kInitM *
//    scale.
//
// Instantiated per storage in decode_sm90_{dense,int8,e4m3,e5m2}.cu
// (paged and contiguous, window flag, T, head dim), so the build runs
// them in parallel.
#pragma once

#include <atomic>
#include <cstdint>
#include <type_traits>

#include "decode_core.cuh"
#include "mma_sm80.cuh"

namespace fa {
namespace split {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kSlab = 16;          // tokens a warp takes at a time
constexpr int kRows = 16;          // query rows of a block (the mma's M)
constexpr int kMaxSplits = 64;     // ops/decode.py MAX_SPLITS
constexpr size_t kSmemBudget = 113 * 1024;   // two blocks an SM

struct Args {
  const void* q;            // [B, Hq, D] in T
  const void* k;            // B4 pool [Hkv, P, ps, D] / B5 cache [B, Hkv, S, D]
  const void* v;
  const float* kscale;      // null when dense
  const float* vscale;
  const int* table;         // B4: [B, width]
  const int* lengths;       // [B]
  const int* starts;        // B4: [B] window starts, or null
  void* o;                  // [B, Hq, D] in T
  float* lse;               // B4: [B, Hq]; null for B5
  float* ws;                // splits > 1: partials (see partial_*)
  int* counters;            // splits > 1: one per unit, 0 between launches
  int B, Hq, Hkv, rows, groups, splits;
  int num_pages, page_size, width, spread;   // B4
  int S, window;                             // B5 (window 0: none)
  float scale;
};

// Shared memory of one instantiation, in bytes from the base: q rows
// (and, under Fold, each warp's scaled q), then each warp's ring stages
// (dense: K and V slabs in T; quantized: codes and the two scale rows),
// then each warp's widened K / V tiles (quantized), then the merge's
// per-warp row stats. The merge's [warp][row][D] fp32 sums reuse the
// ring once every warp has left its loop.
template <int Store, bool Fold, typename T, int D>
struct Smem {
  static constexpr bool kQuant = Store != kDense;
  static constexpr int kLd = D + 8;        // T tile rows (bank spread)
  static constexpr size_t kTile = sizeof(T) * kSlab * kLd;
  static constexpr size_t kQ = sizeof(T) * kRows * kLd;
  static constexpr size_t kStage =
      kQuant ? 2 * kSlab * D + 2 * sizeof(float) * D : 2 * kTile;
  static constexpr size_t kWiden = kQuant ? 2 * kTile : 0;
  static constexpr size_t kFoldQ = Fold ? kQ : 0;
  static constexpr size_t kStats = sizeof(float) * kWarps * kRows * 2;
  static constexpr size_t kFixed = kQ + kWarps * (kFoldQ + kWiden) +
                                   kStats + 16 +
                                   sizeof(float) * kRows * (kMaxSplits + 2);
  // As many stages (4 down to 2) as keep two blocks on an SM.
  static constexpr int kStages =
      kFixed + 4 * kWarps * kStage <= kSmemBudget   ? 4
      : kFixed + 3 * kWarps * kStage <= kSmemBudget ? 3
                                                    : 2;
  static constexpr size_t kBytes = kFixed + kStages * kWarps * kStage;
  static constexpr size_t kRing = kQ + kWarps * kFoldQ;   // warp 0's ring
  static constexpr size_t kWarpRing = kStages * kStage;
  static constexpr size_t kWidenAt = kRing + kWarps * kWarpRing;
  static constexpr size_t kStatsAt = kWidenAt + kWarps * kWiden;
  static constexpr size_t kFlagAt = kStatsAt + kStats;
  static constexpr size_t kMergeAt = kFlagAt + 16;   // [kRows][splits + 2]
  static_assert(kBytes <= 232448, "decode body exceeds shared memory");
  static_assert(sizeof(float) * kWarps * kRows * D <= kWarps * kWarpRing,
                "the merge's sums must fit in the ring");
};

// 16 codes widened (times the 16 scales unless Unscaled) into 16 values of
// T at dst (two 16-byte stores).
template <int Store, bool Unscaled, typename T>
__device__ __forceinline__ void widen16(T* dst, const uint4& codes,
                                        const float* sc) {
  float x[16];
  widen8_fast<Store>(make_uint2(codes.x, codes.y), x);
  widen8_fast<Store>(make_uint2(codes.z, codes.w), x + 8);
  if constexpr (!Unscaled) {
#pragma unroll
    for (int i = 0; i < 16; ++i) x[i] *= sc[i];
  }
  *reinterpret_cast<uint4*>(dst) = pack8<T>(x);
  *reinterpret_cast<uint4*>(dst + 8) = pack8<T>(x + 8);
}

// --- the block ------------------------------------------------------------

// One block: query rows [row0, row0 + rows) of a (sequence, kv head)
// (q_rows / o_rows point at row row0; lse_rows may be null), split
// `split` of `splits` over the visible tokens of [0, len). `offsets`
// maps chunk p (chunk tokens) to its first K/V element and scale row;
// part / stats / counter: this unit's scratch (splits > 1).
template <bool Windowed, int Store, bool Fold, typename T, int D,
          typename Offsets>
__device__ __forceinline__ void attend(
    const Args& a, const T* __restrict__ q_rows, Offsets offsets, int chunk,
    int len, int start, int spread, int rows, int row0, int split,
    T* __restrict__ o_rows, float* __restrict__ lse_rows,
    float* __restrict__ part, float* __restrict__ stats,
    int* __restrict__ counter) {
  using L = Smem<Store, Fold, T, D>;
  constexpr bool kQuant = L::kQuant;
  constexpr int kLd = L::kLd;
  constexpr int kStages = L::kStages;
  using Elem = std::conditional_t<kQuant, unsigned char, T>;
  static_assert(!Fold || Store == kInt8, "fold_scales is the int8 body");
  static_assert(decode::kQuantBlock % kSlab == 0, "slabs tile a block");

  extern __shared__ __align__(128) unsigned char smem[];
  T* sq = reinterpret_cast<T*>(smem);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const float c = a.scale * kLog2e;
  const int splits = a.splits;

  // q rows (zero past `rows`).
  constexpr int kVec = 8;   // T values a 16-byte load
  for (int i = tid; i < kRows * D / kVec; i += kThreads) {
    const int r = i / (D / kVec), col = (i % (D / kVec)) * kVec;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < rows)
      val = *reinterpret_cast<const uint4*>(q_rows + (size_t)r * D + col);
    *reinterpret_cast<uint4*>(sq + r * kLd + col) = val;
  }

  // This block's share of the visible slabs.
  const int lo = Windowed ? max(start, 0) : 0;
  const int lo_al = lo / kSlab * kSlab;
  const int n_slabs = len > lo_al ? (len - lo_al + kSlab - 1) / kSlab : 0;
  const int s0 = (int)((long long)n_slabs * split / splits);
  const int s1 = (int)((long long)n_slabs * (split + 1) / splits);
  const int n_mine = s1 - s0 > warp ? (s1 - s0 - warp + kWarps - 1) / kWarps
                                    : 0;

  unsigned char* ring = smem + L::kRing + warp * L::kWarpRing;
  T* sqf = reinterpret_cast<T*>(smem + L::kQ + warp * L::kFoldQ);
  T* wk = reinterpret_cast<T*>(smem + L::kWidenAt + warp * L::kWiden);
  T* wv = wk + kSlab * kLd;
  const Elem* kbase = static_cast<const Elem*>(a.k);
  const Elem* vbase = static_cast<const Elem*>(a.v);

  // Where slab i of this warp (the block's slab s0 + warp + kWarps i)
  // lies: its first K / V element and (quantized) its scale row. Read a
  // slab ahead of its copy, so a page-table load never stalls the issue.
  struct Src {
    size_t kv, sc;
  };
  auto source = [&](int i) {
    const int pos0 = lo_al + (s0 + warp + kWarps * i) * kSlab;
    const int p = pos0 / chunk, r0 = pos0 % chunk;
    Src src{offsets(p) + (size_t)r0 * D, 0};
    if constexpr (kQuant)
      src.sc = offsets.scales(p) + (size_t)(r0 / decode::kQuantBlock) * D;
    return src;
  };
  // Slab i into ring stage st: 16-byte copies, rows past len zero-filled.
  auto issue = [&](int i, int st, const Src& src) {
    const int live = len - (lo_al + (s0 + warp + kWarps * i) * kSlab);
    unsigned char* stage = ring + st * L::kStage;
    const Elem* gk = kbase + src.kv;
    const Elem* gv = vbase + src.kv;
    // 16-byte chunks a row, and a lane's chunks.
    constexpr int kPerRow = D * sizeof(Elem) / 16;
    constexpr int kPer = kSlab * kPerRow / 32;
    constexpr int kElems = 16 / sizeof(Elem);
    constexpr int kStride = kQuant ? D : kLd;   // stage rows, in Elem
    Elem* sk = reinterpret_cast<Elem*>(stage);
    Elem* sv = sk + kSlab * kStride;
#pragma unroll
    for (int t = 0; t < kPer; ++t) {
      const int j = lane + 32 * t;
      const int r = j / kPerRow, col = (j % kPerRow) * kElems;
      const bool ok = r < live;
      const int off = (ok ? r : 0) * D + col;
      cp_async16(sk + r * kStride + col, gk + off, ok ? 16 : 0);
      cp_async16(sv + r * kStride + col, gv + off, ok ? 16 : 0);
    }
    if constexpr (kQuant) {
      float* ks = reinterpret_cast<float*>(sv + kSlab * D);
      float* vs = ks + D;
      for (int j = lane; j < D / 4; j += 32) {
        cp_async16(ks + 4 * j, a.kscale + src.sc + 4 * j, 16);
        cp_async16(vs + 4 * j, a.vscale + src.sc + 4 * j, 16);
      }
    }
  };

  // Lowest visible position of this thread's two rows (gid, gid + 8).
  int lo_r[2] = {0, 0};
  if constexpr (Windowed) {
    lo_r[0] = start + (row0 + gid) % spread;
    lo_r[1] = start + (row0 + gid + 8) % spread;
  }
  float m[2] = {kInitM, kInitM}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  __syncthreads();   // q rows written

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_mine) issue(s, s, source(s));
    cp_async_commit();
  }
  Src next{0, 0};   // where slab i + kStages - 1 lies
  if (kStages - 1 < n_mine) next = source(kStages - 1);
  int fold_blk = -1;
  for (int i = 0; i < n_mine; ++i) {
    if (i + kStages - 1 < n_mine) {
      issue(i + kStages - 1, (i + kStages - 1) % kStages, next);
      if (i + kStages < n_mine) next = source(i + kStages);
    }
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncwarp();
    const int pos0 = lo_al + (s0 + warp + kWarps * i) * kSlab;
    unsigned char* stage = ring + (i % kStages) * L::kStage;
    const T* sk;
    const T* sv;
    const float* vsc = nullptr;
    if constexpr (!kQuant) {
      sk = reinterpret_cast<const T*>(stage);
      sv = sk + kSlab * kLd;
    } else {
      const unsigned char* ck = stage;
      const unsigned char* cv = ck + kSlab * D;
      const float* ks = reinterpret_cast<const float*>(cv + kSlab * D);
      vsc = ks + D;
      // A lane widens 16 channels [wcol, wcol + 16) of rows wrow, wrow +
      // kRowsPass, ... of K, then of V: its scales are read once a slab,
      // and its codes four rows at a time.
      constexpr int kCpr = D / 16, kRowsPass = 32 / kCpr;
      constexpr int kPasses = kSlab / kRowsPass;
      const int wcol = (lane % kCpr) * 16, wrow = lane / kCpr;
#pragma unroll
      for (int kv = 0; kv < 2; ++kv) {
        const unsigned char* codes = kv ? cv : ck;
        T* dst = kv ? wv : wk;
        float sc[16];
        if constexpr (!Fold) {
#pragma unroll
          for (int e = 0; e < 16; e += 4)
            *reinterpret_cast<float4*>(sc + e) =
                *reinterpret_cast<const float4*>((kv ? vsc : ks) + wcol + e);
        }
#pragma unroll
        for (int t0 = 0; t0 < kPasses; t0 += 4) {
          uint4 c4[4];
#pragma unroll
          for (int t = 0; t < 4 && t0 + t < kPasses; ++t)
            c4[t] = *reinterpret_cast<const uint4*>(
                codes + (wrow + (t0 + t) * kRowsPass) * D + wcol);
#pragma unroll
          for (int t = 0; t < 4 && t0 + t < kPasses; ++t)
            widen16<Store, Fold>(
                dst + (wrow + (t0 + t) * kRowsPass) * kLd + wcol, c4[t], sc);
        }
      }
      if constexpr (Fold) {
        // q times this 128-token block's K scale row, rounded to T.
        const int blk = pos0 / decode::kQuantBlock;
        if (blk != fold_blk) {
          fold_blk = blk;
          for (int j = lane; j < kRows * D / 8; j += 32) {
            const int r = j / (D / 8), col = (j % (D / 8)) * 8;
            float x[8];
            unpack8<T>(*reinterpret_cast<const uint4*>(sq + r * kLd + col),
                       x);
#pragma unroll
            for (int e = 0; e < 8; ++e) x[e] *= ks[col + e];
            *reinterpret_cast<uint4*>(sqf + r * kLd + col) = pack8<T>(x);
          }
        }
      }
      sk = wk;
      sv = wv;
      __syncwarp();
    }
    const T* qsrc = Fold ? sqf : sq;

    // S = q K^T: [16 rows, 16 tokens] in two n8 tiles.
    float s[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], kb[4];
      ldsm_x4(qa, qsrc + (lane % 16) * kLd + (lane / 16) * 8 + 16 * kk);
      ldsm_x4(kb, sk + ((lane / 16) * 8 + lane % 8) * kLd +
                      ((lane / 8) % 2) * 8 + 16 * kk);
      mma<T>(s[0], qa, kb[0], kb[1]);
      mma<T>(s[1], qa, kb[2], kb[3]);
    }
    // Masks: positions >= len (the last slab), and under a window
    // positions below the row's start. s[n][e]: row gid + 8 (e / 2),
    // token pos0 + 8 n + 2 tig + e % 2.
    if (Windowed || pos0 + kSlab > len) {
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int pos = pos0 + 8 * n + 2 * tig + (e & 1);
          bool bad = pos >= len;
          if constexpr (Windowed) bad = bad || pos < lo_r[e >> 1];
          if (bad) s[n][e] = -INFINITY;
        }
    }
    // Online softmax per row (a row's 16 scores lie on one quad).
    float alpha[2];
    uint32_t pa[4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = fmaxf(fmaxf(s[0][2 * h], s[0][2 * h + 1]),
                       fmaxf(s[1][2 * h], s[1][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      alpha[h] = exp2f((m[h] - m_new) * c);
      m[h] = m_new;
      const float p00 = exp2f((s[0][2 * h] - m_new) * c);
      const float p01 = exp2f((s[0][2 * h + 1] - m_new) * c);
      const float p10 = exp2f((s[1][2 * h] - m_new) * c);
      const float p11 = exp2f((s[1][2 * h + 1] - m_new) * c);
      l[h] = l[h] * alpha[h] + ((p00 + p01) + (p10 + p11));
      // P rounded to T: the A fragment of P V (rows gid / gid + 8,
      // tokens 2 tig and 8 + 2 tig).
      pa[h] = pack2<T>(p00, p01);
      pa[2 + h] = pack2<T>(p10, p11);
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }
    // O += P V: V^T's fragments by ldmatrix.trans, 16 channels a load.
#pragma unroll
    for (int jj = 0; jj < D / 16; ++jj) {
      uint32_t vb[4];
      ldsm_x4_trans(vb, sv + (((lane / 8) % 2) * 8 + lane % 8) * kLd +
                            (lane / 16) * 8 + 16 * jj);
      if constexpr (Fold) {
        // The slab's PV partial over unscaled codes, times the V scale
        // row, joins the accumulator.
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          float t[4] = {0.f, 0.f, 0.f, 0.f};
          mma<T>(t, pa, vb[2 * n], vb[2 * n + 1]);
          const int col = 16 * jj + 8 * n + 2 * tig;
          const float v0 = vsc[col], v1 = vsc[col + 1];
          acc[2 * jj + n][0] += t[0] * v0;
          acc[2 * jj + n][1] += t[1] * v1;
          acc[2 * jj + n][2] += t[2] * v0;
          acc[2 * jj + n][3] += t[3] * v1;
        }
      } else {
        mma<T>(acc[2 * jj], pa, vb[0], vb[1]);
        mma<T>(acc[2 * jj + 1], pa, vb[2], vb[3]);
      }
    }
    __syncwarp();   // the stage (and widened tiles) may be refilled
  }
  cp_async_wait<0>();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }

  // Merge the 4 warps (warp order), then write O or this split's partial.
  float* wstats = reinterpret_cast<float*>(smem + L::kStatsAt);  // [w][r][2]
  float* merge = reinterpret_cast<float*>(smem + L::kMergeAt);   // [r][.]
  float* sums = reinterpret_cast<float*>(smem + L::kRing);  // [w][r][D]
  if (tig == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      wstats[(warp * kRows + gid + 8 * h) * 2] = m[h];
      wstats[(warp * kRows + gid + 8 * h) * 2 + 1] = l[h];
    }
  }
  __syncthreads();   // every warp has left its ring: sums may overwrite it
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = gid + 8 * h;
    float mx = wstats[r * 2];
#pragma unroll
    for (int w = 1; w < kWarps; ++w)
      mx = fmaxf(mx, wstats[(w * kRows + r) * 2]);
    const float f = exp2f((m[h] - mx) * c);
    float* dst = sums + (warp * kRows + r) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      dst[8 * j + 2 * tig] = acc[j][2 * h] * f;
      dst[8 * j + 2 * tig + 1] = acc[j][2 * h + 1] * f;
    }
  }
  if (tid < kRows) {
    float mx = wstats[tid * 2];
#pragma unroll
    for (int w = 1; w < kWarps; ++w)
      mx = fmaxf(mx, wstats[(w * kRows + tid) * 2]);
    float ls = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      ls += exp2f((wstats[(w * kRows + tid) * 2] - mx) * c) *
            wstats[(w * kRows + tid) * 2 + 1];
    merge[tid * 2] = mx;
    merge[tid * 2 + 1] = ls;
  }
  __syncthreads();
  if (splits == 1) {
    for (int i = tid; i < rows * D; i += kThreads) {
      const int r = i / D, d = i % D;
      float o = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) o += sums[(w * kRows + r) * D + d];
      const float ls = merge[r * 2 + 1];
      o_rows[(size_t)r * D + d] = from_float<T>(ls > 0.f ? o / ls : 0.f);
    }
    if (lse_rows != nullptr && tid < rows) {
      const float ls = merge[tid * 2 + 1];
      lse_rows[tid] =
          ls > 0.f ? merge[tid * 2] * a.scale + logf(ls) : kInitM * a.scale;
    }
    return;
  }
  // This split's partial: part [splits][kRows][D], stats [splits][kRows][2].
  for (int i = tid; i < rows * D; i += kThreads) {
    const int r = i / D, d = i % D;
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) o += sums[(w * kRows + r) * D + d];
    part[((size_t)split * kRows + r) * D + d] = o;
  }
  if (tid < rows) {
    stats[(split * kRows + tid) * 2] = merge[tid * 2];
    stats[(split * kRows + tid) * 2 + 1] = merge[tid * 2 + 1];
  }
  __threadfence();
  __syncthreads();
  int* flag = reinterpret_cast<int*>(smem + L::kFlagAt);
  if (tid == 0) *flag = atomicAdd(counter, 1) == splits - 1;
  __syncthreads();
  if (!*flag) return;
  // The last split of this unit: merge the partials in split order.
  __threadfence();
  constexpr int kW = kMaxSplits + 2;   // merge row: m, l, weights
  if (tid < rows) {
    float* row = merge + tid * kW;
    float mx = kInitM;
    for (int sp = 0; sp < splits; ++sp)
      mx = fmaxf(mx, __ldcg(stats + (sp * kRows + tid) * 2));
    float ls = 0.f;
    for (int sp = 0; sp < splits; ++sp) {
      const float w = exp2f((__ldcg(stats + (sp * kRows + tid) * 2) - mx) * c);
      row[2 + sp] = w;
      ls += w * __ldcg(stats + (sp * kRows + tid) * 2 + 1);
    }
    row[0] = mx;
    row[1] = ls;
  }
  __syncthreads();
  for (int i = tid; i < rows * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const float* row = merge + r * kW;
    float o = 0.f;
    for (int sp = 0; sp < splits; ++sp)
      o += row[2 + sp] * __ldcg(part + ((size_t)sp * kRows + r) * D + d);
    const float ls = row[1];
    o_rows[(size_t)r * D + d] = from_float<T>(ls > 0.f ? o / ls : 0.f);
  }
  if (lse_rows != nullptr && tid < rows) {
    const float* row = merge + tid * kW;
    lse_rows[tid] =
        row[1] > 0.f ? row[0] * a.scale + logf(row[1]) : kInitM * a.scale;
  }
  if (tid == 0) *counter = 0;   // ready for the next launch on this stream
}

// A unit is one (sequence, kv head, row group); its scratch: splits x
// kRows x D partial sums, then (after every unit's sums) splits x kRows x
// 2 stats.
__device__ __forceinline__ float* partial_sums(const Args& a, int unit,
                                               int D) {
  return a.ws + (size_t)unit * a.splits * kRows * D;
}

__device__ __forceinline__ float* partial_stats(const Args& a, int unit,
                                                int D) {
  const size_t units = (size_t)a.B * a.Hkv * a.groups;
  return a.ws + units * a.splits * kRows * D +
         (size_t)unit * a.splits * kRows * 2;
}

template <bool Paged, bool Windowed, int Store, bool Fold, typename T, int D>
__device__ __forceinline__ void split_block(const Args& a) {
  const int split = blockIdx.x;
  const int h = blockIdx.y / a.groups, grp = blockIdx.y % a.groups;
  const int b = blockIdx.z;
  const int row0 = grp * kRows, rows = min(kRows, a.rows - row0);
  const size_t qrow0 = (size_t)b * a.Hq + (size_t)h * a.rows + row0;
  const int unit = (b * a.Hkv + h) * a.groups + grp;
  const T* q = static_cast<const T*>(a.q) + qrow0 * D;
  T* o = static_cast<T*>(a.o) + qrow0 * D;
  float* lse = a.lse != nullptr ? a.lse + qrow0 : nullptr;
  float* part = a.splits > 1 ? partial_sums(a, unit, D) : nullptr;
  float* stats = a.splits > 1 ? partial_stats(a, unit, D) : nullptr;
  int* counter = a.splits > 1 ? a.counters + unit : nullptr;
  if constexpr (Paged) {
    const int len = max(0, min(a.lengths[b], a.width * a.page_size));
    const decode::PagedChunks pages{
        a.table + (size_t)b * a.width, (size_t)h * a.num_pages,
        (size_t)a.page_size * D,
        (size_t)(a.page_size / decode::kQuantBlock) * D};
    attend<Windowed, Store, Fold, T, D>(
        a, q, pages, a.page_size, len, Windowed ? a.starts[b] : 0,
        Windowed ? a.spread : 1, rows, row0, split, o, lse, part, stats,
        counter);
  } else {
    constexpr int kChunk = 256;   // decode.cuh kChunk
    const int len = max(0, min(a.lengths[b], a.S));
    const size_t seq = (size_t)b * a.Hkv + h;
    const decode::ContiguousChunks chunks{
        seq * (size_t)a.S * D, (size_t)kChunk * D,
        seq * (size_t)(a.S / decode::kQuantBlock) * D,
        (size_t)(kChunk / decode::kQuantBlock) * D};
    attend<Windowed, Store, false, T, D>(
        a, q, chunks, kChunk, len, len - a.window, 1, rows, row0, split, o,
        lse, part, stats, counter);
  }
}

// B4 and B5 as kernels of their own names (profiles tell them apart).
template <bool Windowed, int Store, bool Fold, typename T, int D>
__global__ void __launch_bounds__(kThreads) paged_split_kernel(const Args a) {
  split_block<true, Windowed, Store, Fold, T, D>(a);
}

template <bool Windowed, int Store, typename T, int D>
__global__ void __launch_bounds__(kThreads)
    contiguous_split_kernel(const Args a) {
  split_block<false, Windowed, Store, false, T, D>(a);
}

// Raises the kernel's dynamic shared memory limit to `bytes` once per
// device (`done`: a bit per device the kernel is set up on; the call
// costs the host microseconds a launch).
inline cudaError_t allow_smem(void (*kernel)(const Args), size_t bytes,
                              std::atomic<uint64_t>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

// Windowed: B4 with starts, B5 with window > 0 (the other instantiation
// carries no window mask).
template <bool Paged, int Store, bool Fold, typename T, int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr size_t bytes = Smem<Store, Fold, T, D>::kBytes;
  static std::atomic<uint64_t> done[2];   // window flag 0 / 1
  const bool windowed = Paged ? a.starts != nullptr : a.window > 0;
  void (*kernel)(const Args);
  if constexpr (Paged) {
    kernel = windowed ? paged_split_kernel<true, Store, Fold, T, D>
                      : paged_split_kernel<false, Store, Fold, T, D>;
  } else {
    kernel = windowed ? contiguous_split_kernel<true, Store, T, D>
                      : contiguous_split_kernel<false, Store, T, D>;
  }
  cudaError_t err = allow_smem(kernel, bytes, done[windowed]);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.splits, a.Hkv * a.groups, a.B), kThreads, bytes, stream>>>(
      a);
  return cudaGetLastError();
}

template <bool Paged, int Store, bool Fold, typename T>
cudaError_t dispatch_d(const Args& a, int D, cudaStream_t stream) {
  if (D == 128) return launch<Paged, Store, Fold, T, 128>(a, stream);
  if (D == 64) return launch<Paged, Store, Fold, T, 64>(a, stream);
  if (D == 256) return launch<Paged, Store, Fold, T, 256>(a, stream);
  if (D == 32) return launch<Paged, Store, Fold, T, 32>(a, stream);
  return cudaErrorInvalidValue;
}

template <bool Paged, int Store, bool Fold>
cudaError_t dispatch(const Args& a, int dtype, int D, cudaStream_t stream) {
  if (dtype == kBFloat16)
    return dispatch_d<Paged, Store, Fold, __nv_bfloat16>(a, D, stream);
  if (dtype == kFloat16)
    return dispatch_d<Paged, Store, Fold, __half>(a, D, stream);
  return cudaErrorInvalidValue;
}

// Defined in decode_sm90_{dense,int8,e4m3,e5m2}.cu: B4 (paged) or B5.
cudaError_t run_dense(const Args& a, bool paged, int dtype, int D,
                      cudaStream_t stream);
cudaError_t run_int8(const Args& a, bool paged, bool fold, int dtype, int D,
                     cudaStream_t stream);
cudaError_t run_e4m3(const Args& a, bool paged, int dtype, int D,
                     cudaStream_t stream);
cudaError_t run_e5m2(const Args& a, bool paged, int dtype, int D,
                     cudaStream_t stream);

// The split body for storage `store` (common.cuh codes).
inline cudaError_t run(const Args& a, bool paged, int store, bool fold,
                       int dtype, int D, cudaStream_t stream) {
  if (a.splits < 1 || a.splits > kMaxSplits || a.rows < 1 ||
      (a.splits > 1 && (a.ws == nullptr || a.counters == nullptr)))
    return cudaErrorInvalidValue;
  if (paged && a.page_size % kSlab) return cudaErrorInvalidValue;
  switch (store) {
    case kDense:
      return run_dense(a, paged, dtype, D, stream);
    case kInt8:
      return run_int8(a, paged, fold, dtype, D, stream);
    case kE4M3:
      return run_e4m3(a, paged, dtype, D, stream);
    case kE5M2:
      return run_e5m2(a, paged, dtype, D, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace split
}  // namespace fa
