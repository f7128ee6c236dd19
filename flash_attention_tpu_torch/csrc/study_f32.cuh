// B10a, B10b and B10c on fp32 inputs: one register-blocked FFMA body
// (instantiated in variants_fa1.cu, variants_fa2.cu, variants_naive.cu).
//
// Replaces, at Precision.HIGHEST (every product full fp32 FFMA on the
// CUDA cores: no TF32, no tensor cores), the Pallas TPU kernels of
// flash_attention_tpu/ops/variants.py: `_fa1_kernel` (variants.py:80,
// launched at :177) at both of its compiled tiles, `_fa2_inloop_kernel`
// (:216, launched at :318) and `_naive_kernel` (:349, launched at :428).
// What each computes is its source's note (variants_fa1.cu, _fa2.cu,
// _naive.cu): B10a the FA1 recurrence per G = 16 or 64 key columns in key
// order (tile max m~, P~ = exp(S - m~), l~ = rowsum P~, then m, l and acc
// = alpha acc + beta (P~ V)), o / m (scaled units) / l out, ragged Nq and
// Nk; B10b FA2's in-loop normalized update per 64 columns, causal (offset
// Nk - Nq) and GQA; B10c the exact two passes, every K slab read twice.
// Every output is a fixed-order sum in one block (no atomics): a rerun
// gives identical bits.
//
// What bounds it on the H100: the CUDA cores' 67 TFLOP/s over the
// function's 4 D FLOPs a visible pair: at (1, 8, 2048, 128) 0.2564 ms
// (B10b causal 0.1283; B10c does 6 D, its Q K^T twice, against the same
// bound). The first body (study.cuh's Block) ran
// blocks of 2 BR threads (one warp at 16 x 16), kept S, P and O in
// shared memory, loaded K / V between two barriers and issued scalar
// shared loads: 8.9 TFLOP/s at 16 x 16, 17.2 at 64 x 64. This body:
//
//  - A block is 4 warps over kRows q rows (F32Cfg): thread (ty, tx) of
//    8 x 16 owns rows ty + 8 i (i < kMR) of S, P and O. kRows = 64 (8
//    rows a thread) when such blocks give every other SM one at least,
//    else 32 (4 a thread), as at `cli verify`'s (1, 8, 512, 64): 64
//    blocks of 64 rows would leave half of the 132 SMs idle, 128 of 32
//    do not. D = 256 takes 32 rows (O is 4 x 16 a thread).
//  - K / V stream in slabs of 64 keys through two buffers filled by
//    cp.async from every thread, K and V of a slab in turn: V_t loads
//    while S_t = Q K_t^T runs, K_t+1 while P_t V_t runs (B10c's first
//    pass rings its K slabs through both). A ring of whole K + V slabs
//    would cost the second block an SM at D = 128.
//  - S in registers, 4 consecutive key columns a thread (a 4 kMR tile;
//    12 float4 loads per 128 FFMAs at 8 rows). Q and K are stored
//    unpadded with the 16-byte chunk c of row r at chunk c ^ (r & 7),
//    and a slab's K rows transposed (key 4 t + j at row 16 j + t): the
//    16 keys the 16 tx threads read at once sit in 8 different bank
//    groups, so each float4 load takes the least wavefronts, and every
//    address is a per-thread base plus a constant.
//  - Row statistics by shuffles within the 16 threads of a row (the 4
//    of a 16-column step at 16 x 16; each then takes the other steps'
//    maxima and sums by index). P' passes through shared memory (row
//    stride 68; B10a's per-step alpha in the row's padding, so that its
//    steps run as one loop) as the A operand of P V; O stays in registers
//    (ffma_f32.cuh's AccTile: 8 x 8 a thread at D = 128, 8 x 4 at 64, 8
//    x 2 at 32, 4 x 16 at 256), each step's P V a partial sum formed
//    from zero (accumulate) and then combined: acc = alpha acc + t.
//  - B10a's update acc = alpha acc + beta (P~ V) is taken per step as
//    acc = alpha acc + (beta P~) V: beta scales P~ as it is written to
//    shared memory (one rounding an element) instead of a fresh
//    accumulator, and the step's P V is a partial sum anyway; beta may
//    underflow to 0 there, as in the plain version. B10b folds 1 / l
//    into P the same way (acc = (carry / l) acc + (P / l) V).
//  - B10b causal: each block stops after its last real row's diagonal
//    and the grid runs the heaviest q tiles first (ffma::work_rank:
//    when every block is resident at once at two an SM, the second
//    round lightest first).
//  - Occupancy (shared bytes a block; 228 KB an SM, 1 KB reserved a
//    block; tests/test_torch_study_f32.py mirrors F32Cfg):
//      64 rows: D = 32 41,984 (5 an SM), D = 64 66,560 (3),
//               D = 128 115,712 (2)
//      32 rows: D = 32 29,184 (7), D = 64 49,664 (4), D = 128 90,624 (2),
//               D = 256 172,544 (1)
//    Registers allow fewer with 64 rows (ptxas: 168 a thread at D = 32,
//    194-216 at 64, 244-254 at 128): 3, 2 and 2 blocks an SM.
//  - Ragged Nq / Nk: rows and keys past the end load as zeros (cp.async
//    with a source size of 0), columns past Nk are -inf, B10a's steps
//    wholly past Nk are skipped, rows past Nq are not stored.
#pragma once

#include "ffma_f32.cuh"
#include "study.cuh"

namespace fa {
namespace study {

enum F32Kind { kFa1, kFa2, kNaive };

template <int D, bool Wide>
struct F32Cfg {
  static constexpr int kThreads = 128;               // 4 warps
  static constexpr int kTX = 16;                     // threads a row
  static constexpr int kTY = kThreads / kTX;         // 8
  static constexpr int kMR = Wide && D <= 128 ? 8 : 4;   // rows a thread
  static constexpr int kRows = kTY * kMR;            // q rows a block
  static constexpr int kSlab = 64;                   // keys a K / V stage
  static constexpr int kLdP = kSlab + 4;             // P row stride
  static constexpr int kW = D >= 64 ? 4 : 2;         // O floats a load
  using Acc = ffma::AccTile<kRows, D, D / (kTX * kW), kThreads, kW>;
  using QL = ffma::Swizzled<D, false>;
  using KL = ffma::Swizzled<D, true>;
  using VL = ffma::Plain<D>;
  static constexpr size_t kStage = sizeof(float) * kSlab * D;
  static constexpr size_t kBuf = sizeof(float) * kRows * D;   // after Q
  static constexpr size_t kP = kBuf + 2 * kStage;
  static constexpr size_t kBytes = kP + sizeof(float) * kRows * kLdP;
  static constexpr int kMinBlocks = kBytes + 1024 <= 233472 / 2 ? 2 : 1;
  static_assert(kBytes <= 232448, "study fp32 tiles exceed shared memory");
  static_assert(kTY % 8 == 0, "Q's swizzle is ty & 7");
};

// s[i][j] = Q[row ty + kTY i] . K[key 4 tx + j] over D (fp32 FFMA, k
// ascending), Q and K in their swizzled layouts (F32Cfg QL / KL): chunk
// c of Q row ty + kTY i sits at c ^ (ty & 7), of K key 4 tx + j (stored
// row 16 j + tx) at c ^ (tx & 7).
template <class C, int D>
__device__ __forceinline__ void slab_scores(float (&s)[C::kMR][4],
                                            const float* __restrict__ sq,
                                            const float* __restrict__ sk,
                                            int ty, int tx) {
  const float* qa = sq + ty * D;
  const float* kb = sk + tx * D;
  const int qs = ty & 7, ks = tx & 7;
#pragma unroll
  for (int i = 0; i < C::kMR; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 1
  for (int c0 = 0; c0 < D / 4; c0 += 8) {
#pragma unroll
    for (int cc = 0; cc < 8; ++cc) {
      float4 av[C::kMR], bv[4];
#pragma unroll
      for (int i = 0; i < C::kMR; ++i)
        av[i] = *reinterpret_cast<const float4*>(
            qa + C::kTY * i * D + 4 * (c0 + (cc ^ qs)));
#pragma unroll
      for (int j = 0; j < 4; ++j)
        bv[j] = *reinterpret_cast<const float4*>(kb + 16 * j * D +
                                                 4 * (c0 + (cc ^ ks)));
#pragma unroll
      for (int i = 0; i < C::kMR; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(av[i].x, bv[j].x, s[i][j]);
          s[i][j] = fmaf(av[i].y, bv[j].y, s[i][j]);
          s[i][j] = fmaf(av[i].z, bv[j].z, s[i][j]);
          s[i][j] = fmaf(av[i].w, bv[j].w, s[i][j]);
        }
    }
  }
}

// x reduced (max or sum) over the L lanes of its group (L a power of two
// up to 16, groups aligned).
template <int L, bool Max>
__device__ __forceinline__ float group_reduce(float x) {
#pragma unroll
  for (int o = 1; o < L; o *= 2) {
    const float y = __shfl_xor_sync(0xffffffffu, x, o);
    x = Max ? fmaxf(x, y) : x + y;
  }
  return x;
}

// One block per (q tile of kRows rows, q head, batch); Kind says which
// variant, G the columns of B10a's recurrence step (64 for the others).
template <int Kind, int G, int D, bool Wide>
__global__ void __launch_bounds__(F32Cfg<D, Wide>::kThreads,
                                  F32Cfg<D, Wide>::kMinBlocks)
    study_f32(const Args a, int sms, int per_sm) {
  using C = F32Cfg<D, Wide>;
  using A = typename C::Acc;
  constexpr int kMR = C::kMR, kTY = C::kTY, kSlab = C::kSlab;
  constexpr int kLdP = C::kLdP;
  constexpr int kNG = kSlab / G;   // recurrence steps a slab
  constexpr int kGL = G / 4;       // threads of a step's columns
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sBuf = reinterpret_cast<float*>(smem + C::kBuf);
  float* sP = reinterpret_cast<float*>(smem + C::kP);
  const int tid = threadIdx.x, ty = tid / C::kTX, tx = tid % C::kTX;
  const int lane = tid % 32;
  const int Nq = a.Nq, Nk = a.Nk, causal = a.causal, offset = a.offset;
  const int heads = a.B * a.Hq;
  const int n_tiles = (Nq + C::kRows - 1) / C::kRows;
  const int rank = causal ? ffma::work_rank(blockIdx.x, gridDim.x, sms,
                                            per_sm)
                          : blockIdx.x;
  const int q0 = (n_tiles - 1 - rank / heads) * C::kRows;
  const int hb = rank % heads;   // b Hq + h
  const int b = hb / a.Hq, h = hb % a.Hq;
  const size_t qbase = (size_t)hb * Nq;
  const size_t kvoff = ((size_t)b * a.Hkv + h / (a.Hq / a.Hkv)) * Nk * D;
  const float* kg = static_cast<const float*>(a.k) + kvoff;
  const float* vg = static_cast<const float*>(a.v) + kvoff;
  const float c = a.scale * kLog2e;

  // Keys any real row of the tile sees (causal: to the last real row's
  // diagonal), in slabs of 64. The loads, each into buffer (index & 1):
  // B10c's first pass takes K slabs 0 .. n_kv - 1, then every kind K_t,
  // V_t in turn.
  const int kv_end = causal ? min(Nk, min(q0 + C::kRows, Nq) + offset) : Nk;
  const int n_kv = kv_end > 0 ? (kv_end + kSlab - 1) / kSlab : 0;
  const int n_loads = (Kind == kNaive ? 3 : 2) * n_kv;
  auto issue = [&](int i) {
    float* dst = sBuf + (i & 1) * kSlab * D;
    const bool pass1 = Kind == kNaive && i < n_kv;
    const int r = Kind == kNaive && !pass1 ? i - n_kv : i;
    const int j0 = (pass1 ? r : r / 2) * kSlab;
    if (!pass1 && (r & 1))
      ffma::load_rows<D, kSlab, C::kThreads, typename C::VL>(dst, vg, j0,
                                                             Nk, tid);
    else
      ffma::load_rows<D, kSlab, C::kThreads, typename C::KL>(dst, kg, j0,
                                                             Nk, tid);
  };
  ffma::load_rows<D, C::kRows, C::kThreads, typename C::QL>(
      sQ, static_cast<const float*>(a.q) + qbase * D, q0, Nq, tid);
  if (n_loads > 0) issue(0);
  cp_async_commit();
  int next = 0;
  // The next load's buffer, once it landed and every thread left the
  // phase before (whose buffer the load after it then refills).
  auto advance = [&]() -> const float* {
    cp_async_wait<0>();
    __syncthreads();
    if (next + 1 < n_loads) issue(next + 1);
    cp_async_commit();
    return sBuf + (next++ & 1) * kSlab * D;
  };
  // S of the slab at key j0 (raw units); hidden columns (>= Nk, or past
  // the row's diagonal under causal) -inf.
  auto scores = [&](float (&s)[kMR][4], const float* sk, int j0) {
    slab_scores<C, D>(s, sQ, sk, ty, tx);
    if (j0 + kSlab > Nk || (causal && j0 + kSlab - 1 > q0 + offset)) {
#pragma unroll
      for (int i = 0; i < kMR; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = j0 + 4 * tx + j, row = q0 + ty + kTY * i;
          if (col >= Nk || (causal && col > row + offset))
            s[i][j] = -INFINITY;
        }
    }
  };
  auto store_p = [&](int i, const float (&p)[4], float mul) {
    *reinterpret_cast<float4*>(sP + (ty + kTY * i) * kLdP + 4 * tx) =
        make_float4(p[0] * mul, p[1] * mul, p[2] * mul, p[3] * mul);
  };

  float acc[A::kMR][A::kW * A::kNV];
  ffma::zero<A>(acc);
  float m[kMR], l[kMR];   // B10a: m in scaled units; B10b / B10c: raw
#pragma unroll
  for (int i = 0; i < kMR; ++i) m[i] = kInitM, l[i] = 0.f;

  if constexpr (Kind == kFa1) {
    const int own = tx / kGL;   // this thread's step of the slab
    for (int t = 0; t < n_kv; ++t) {
      const int j0 = t * kSlab;
      float s[kMR][4];
      scores(s, advance(), j0);
#pragma unroll
      for (int i = 0; i < kMR; ++i) {
        // The step's tile max m~ (raw; -inf for a step wholly past Nk,
        // whose P~ is 0), P~ = exp2((S - m~) c) and l~.
        const float x = group_reduce<kGL, true>(
            fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3])));
        const bool live = x != -INFINITY;
        float p[4], ps = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          p[j] = live ? exp2f(fmaf(s[i][j], c, -x * c)) : 0.f;
          ps += p[j];
        }
        ps = group_reduce<kGL, false>(ps);
        // The recurrence over the slab's steps in key order: m_new =
        // max(m, m~), alpha = e^{m - m_new}, beta = e^{m~ - m_new}, l =
        // alpha l + beta l~. Step g's alpha goes to column 64 + g of the
        // row's P (its padding), for the P~ V loop below.
        float beta = 0.f;
#pragma unroll
        for (int g = 0; g < kNG; ++g) {
          const int src = (lane & 16) | (g * kGL);
          const float mt = kNG == 1 ? x : __shfl_sync(0xffffffffu, x, src);
          const float lt = kNG == 1 ? ps : __shfl_sync(0xffffffffu, ps, src);
          float alpha = 1.f;
          if (mt != -INFINITY) {
            const float mt_s = mt * a.scale, m_new = fmaxf(m[i], mt_s);
            const float be = exp2f((mt_s - m_new) * kLog2e);
            alpha = exp2f((m[i] - m_new) * kLog2e);
            l[i] = alpha * l[i] + be * lt;
            m[i] = m_new;
            if (g == own) beta = be;
          }
          if (tx == g) sP[(ty + kTY * i) * kLdP + kSlab + g] = alpha;
        }
        store_p(i, p, beta);
      }
      // acc = alpha acc + (beta P~) V, one step after the other (steps
      // wholly past Nk skipped).
      const float* sv = advance();
      const int steps = min(kNG, (Nk - j0 + G - 1) / G);
#pragma unroll 1
      for (int g = 0; g < steps; ++g)
        ffma::accumulate<A, G>(acc, sP + g * G, kLdP, sv + g * G * D, D,
                               ty, tx, [&](int i, float o, float pv) {
                                 return fmaf(sP[(ty + kTY * i) * kLdP +
                                                kSlab + g],
                                             o, pv);
                               });
    }
  } else if constexpr (Kind == kFa2) {
    for (int t = 0; t < n_kv; ++t) {
      float s[kMR][4];
      scores(s, advance(), t * kSlab);
      float alpha[kMR];
#pragma unroll
      for (int i = 0; i < kMR; ++i) {
        const float mx = fmaxf(m[i], group_reduce<16, true>(fmaxf(
                                         fmaxf(s[i][0], s[i][1]),
                                         fmaxf(s[i][2], s[i][3]))));
        float p[4], ps = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          p[j] = exp2f(fmaf(s[i][j], c, -mx * c));
          ps += p[j];
        }
        const float carry = l[i] * exp2f((m[i] - mx) * c);
        const float l_ij = carry + group_reduce<16, false>(ps);
        const float l_safe = l_ij == 0.f ? 1.f : l_ij;
        alpha[i] = carry / l_safe;
        m[i] = mx;
        l[i] = l_ij;
        store_p(i, p, 1.f / l_safe);
      }
      ffma::accumulate<A, kSlab>(acc, sP, kLdP, advance(), D, ty, tx,
                                 [&](int i, float o, float pv) {
                                   return fmaf(alpha[i], o, pv);
                                 });
    }
  } else {
    // Pass 1: the row max of the raw scores (this thread's columns, then
    // the row's).
    for (int t = 0; t < n_kv; ++t) {
      float s[kMR][4];
      scores(s, advance(), t * kSlab);
#pragma unroll
      for (int i = 0; i < kMR; ++i)
        m[i] = fmaxf(m[i], fmaxf(fmaxf(s[i][0], s[i][1]),
                                 fmaxf(s[i][2], s[i][3])));
    }
#pragma unroll
    for (int i = 0; i < kMR; ++i) m[i] = group_reduce<16, true>(m[i]) * c;
    // Pass 2: P = exp2((S - m) c), l (this thread's share), O += P V.
    for (int t = 0; t < n_kv; ++t) {
      float s[kMR][4];
      scores(s, advance(), t * kSlab);
#pragma unroll
      for (int i = 0; i < kMR; ++i) {
        float p[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          p[j] = exp2f(fmaf(s[i][j], c, -m[i]));
          l[i] += p[j];
        }
        store_p(i, p, 1.f);
      }
      ffma::accumulate<A, kSlab>(acc, sP, kLdP, advance(), D, ty, tx);
    }
  }
  cp_async_wait<0>();

  // O = acc / l (B10a: l == 0 read as 1; B10b: already normalized), and
  // B10a's m and l; rows < Nq.
#pragma unroll
  for (int i = 0; i < kMR; ++i) {
    float mul = 1.f;
    if constexpr (Kind == kFa1) {
      mul = l[i] == 0.f ? 1.f : 1.f / l[i];
      const int row = q0 + ty + kTY * i;
      if (tx == 0 && row < Nq) {
        a.m[qbase + row] = m[i];
        a.l[qbase + row] = l[i];
      }
    } else if constexpr (Kind == kNaive) {
      mul = 1.f / group_reduce<16, false>(l[i]);
    }
#pragma unroll
    for (int j = 0; j < A::kW * A::kNV; ++j) acc[i][j] *= mul;
  }
  ffma::store_acc<A, D>(acc, static_cast<float*>(a.o) + qbase * D, q0, Nq,
                        ty, tx);
}

template <int Kind, int G, int D, bool Wide>
cudaError_t launch_f32_as(const Args& a, int sms) {
  using C = F32Cfg<D, Wide>;
  const auto kernel = study_f32<Kind, G, D, Wide>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kBytes);
  if (err != cudaSuccess) return err;
  // Blocks an SM (B10b's causal order): by shared memory and registers.
  static int per_sm = 0;
  if (per_sm == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, C::kThreads, C::kBytes);
    if (err != cudaSuccess) return err;
  }
  const int blocks = a.B * a.Hq * ((a.Nq + C::kRows - 1) / C::kRows);
  kernel<<<blocks, C::kThreads, C::kBytes, a.stream>>>(a, sms, per_sm);
  return cudaGetLastError();
}

// Blocks of 64 q rows when the grid gives every other SM one at least,
// else of 32 (and always 32 at D = 256).
template <int Kind, int G, int D>
cudaError_t launch_f32(const Args& a) {
  const int sms = ffma::sm_count();
  if constexpr (D <= 128) {
    const int wide = a.B * a.Hq * ((a.Nq + 63) / 64);
    if (2 * wide >= sms) return launch_f32_as<Kind, G, D, true>(a, sms);
  }
  return launch_f32_as<Kind, G, D, false>(a, sms);
}

}  // namespace study
}  // namespace fa
