// B2 (dQ) and B3 (dK, dV) on fp32 inputs: a register-blocked FFMA body
// (instantiated in flash_bwd_f32.cu, masked and not).
//
// B2 replaces the Pallas TPU kernel flash_attention_tpu/ops/flash.py
// `_bwd_dq_kernel` (flash.py:716, launched at :949), B3 `_bwd_dkv_kernel`
// (flash.py:773, launched at :1017), at Precision.HIGHEST (flash.py:92-101).
// What both compute, and the masks, are flash_bwd.cuh's contract: P =
// exp2(S c - lse log2e) with c = scale log2e and S = Q K^T unscaled, dP =
// dO V^T, dS = P (dP - delta) scale, dQ = dS K, dK = dS^T Q, dV = P^T dO
// (GQA sums dK and dV over the group's q heads); a hidden pair (causal,
// window, segment ids, a row >= Nq or a column >= Nk) gets P = 0 by
// select, so a dead row yields zero gradients. The roundings of P and dS
// to the input dtype are no-ops in fp32. Every product is full fp32 FFMA
// on the CUDA cores (no TF32, no tensor cores), every output the sum of a
// fixed sequence in one block (no atomics): a rerun gives identical bits.
//
// What bounds it on the H100: the CUDA cores' 67 TFLOP/s (6 D FLOPs a
// visible pair in B2, 8 D in B3, against 8 D bytes of operand rows
// reused across a tile). The first body kept S, dP, P, dS and the
// accumulators in shared memory, issued 12 scalar shared loads per 32
// FFMAs, and left 2 warps an SM in B3 at D >= 128 (120 KB a block). This
// body:
//
//  - A block is 4 warps (kThreads = 128) over kRows resident rows: 64 q
//    rows in B2, 64 kv rows in B3; 32 of either at D = 256, so that dQ,
//    and dK with dV in one pass, fit the registers. The other side
//    streams in tiles of kStream = 16 rows (K, V in B2; Q, dO with their
//    LSE, delta and q segment ids in B3) through a cp.async double
//    buffer: tile t + 1 loads while tile t's products run. Causal work
//    rises with the q tile in B2 and falls with the kv tile in B3: the
//    grid launches the heaviest tiles of every head first, and when the
//    whole grid is resident at two blocks an SM the second round
//    lightest first (work_rank), so that an SM's two tiles hold about
//    the mean work.
//  - The accumulators (dQ; dK and dV) stay in registers from the first
//    tile to the store, a register micro-tile of MR rows x 4 NV columns a
//    thread (AccTile: 8 x 8 at D = 128 and 256, 8 x 4 at D = 64, 4 x 4
//    at D = 32; the micro-tile, its accumulate, the cp.async staging and
//    work_rank are ffma_f32.cuh's, shared with the fp32 study body). A's values are read as float4 along k (the k loop
//    contiguous), B's as float4 along the columns: 12 16-byte loads per
//    128 FFMAs. Each streamed tile's 16-term partial sum joins the
//    accumulator whole (accumulate).
//  - S and dP in registers: warps 0-1 compute S, warps 2-3 dP,
//    each a 4 x 4 tile a thread of the [kRows, 16] score tile (2 x 4 at
//    D = 256; float4 operands along D: 8 loads per 64 FFMAs). The S warps
//    form P = exp2(S c - lse log2e) and the masks by select and write P
//    to shared memory; the dP warps read it back at the same positions
//    and write dS = P (dP - delta) scale. Only P and dS pass through
//    shared memory, as the operands of the next products (B2 writes dS
//    over P; B3 keeps both, for dV and dK).
//  - Occupancy (shared bytes a block; 227 KB a block, 228 KB an SM with
//    1 KB reserved a block; tests/test_torch_flash_bwd_f32.py mirrors it):
//      B2  D =  32:  32,896    D =  64:  57,472    D = 128: 106,624
//      B3  D =  32:  38,272    D =  64:  62,848    D = 128: 112,000
//          -> at least two blocks, 8 warps, an SM (__launch_bounds__(128,
//          2) holds a thread to 255 registers: dK and dV are 128 at D =
//          128)
//      D = 256: B2 135,808, B3 138,624 -> one block, 4 warps
//  - Loop ranges as the first body's, reckoned for these tiles: B2 runs
//    the kv tiles of 16 from the first inside its first row's window
//    (rounded down to 16) to its last real row's causal limit (the JAX
//    grid's _block_runs, flash.py:122-139); B3 the q tiles of 16 from the
//    first that sees its kv rows to the last whose window still reaches
//    them (first_valid_iq / last_window_iq, flash.py:973-992), for each q
//    head of the GQA group in turn.
#pragma once

#include "ffma_f32.cuh"
#include "flash_bwd.cuh"

namespace fa {
namespace bwd {
namespace f32 {

constexpr int kThreads = 128;       // 4 warps
constexpr int kHalf = 64;           // threads of one score product
constexpr int kStream = 16;         // rows of a streamed tile
constexpr int kLdP = kStream + 4;   // P / dS rows (floats; bank spread)

// The accumulators' register tile over the block's 128 threads
// (ffma_f32.cuh).
template <int R, int D, int NV>
using AccTile = ffma::AccTile<R, D, NV, kThreads>;

template <int D>
struct DqCfg {
  static constexpr int kRows = D > 128 ? 32 : 64;   // resident q rows
  static constexpr int kLd = D + 4;  // row stride (floats; bank spread)
  using Acc = AccTile<kRows, D, D >= 128 ? 2 : 1>;
  static constexpr int kMinBlocks = D > 128 ? 1 : 2;
  static constexpr size_t kTile = sizeof(float) * kRows * kLd;
  static constexpr size_t kStage = sizeof(float) * 2 * kStream * kLd;
  static constexpr size_t kQ = 0, kDO = kTile, kKV = 2 * kTile;
  static constexpr size_t kP = kKV + 2 * kStage;            // P, then dS
  static constexpr size_t kSeg = kP + sizeof(float) * kRows * kLdP;
  static constexpr size_t kBytes = kSeg + sizeof(int) * 2 * kStream;
  static_assert(kBytes <= 232448, "B2 fp32 tiles exceed shared memory");
};

template <int D>
struct DkvCfg {
  static constexpr int kRows = D > 128 ? 32 : 64;   // resident kv rows
  static constexpr int kLd = D + 4;
  using Acc = AccTile<kRows, D, D >= 128 ? 2 : 1>;
  static constexpr int kMinBlocks = D > 128 ? 1 : 2;
  static constexpr size_t kTile = sizeof(float) * kRows * kLd;
  static constexpr size_t kStage = sizeof(float) * 2 * kStream * kLd;
  static constexpr size_t kK = 0, kV = kTile, kQO = 2 * kTile;
  static constexpr size_t kPt = kQO + 2 * kStage;
  static constexpr size_t kDSt = kPt + sizeof(float) * kRows * kLdP;
  // per stage: lse, delta, q segment ids of the tile's 16 rows
  static constexpr size_t kStat = kDSt + sizeof(float) * kRows * kLdP;
  static constexpr size_t kBytes = kStat + sizeof(float) * 2 * 3 * kStream;
  static_assert(kBytes <= 232448, "B3 fp32 tiles exceed shared memory");
};

// Rows [r0, r0 + N) of a row-major [n, D] fp32 matrix into shared memory
// (stride D + 4) by cp.async from every thread; rows past n read zeros.
template <int D, int N>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int r0, int n, int tid) {
  ffma::load_rows<D, N, kThreads, ffma::Padded<D>>(dst, src, r0, n, tid);
}

// x[MI][4] = A[rows ty + 16 i] . B[rows tx + 4 j] over D (fp32 FFMA, k
// ascending): one thread's share of a [16 MI, 16] score tile. A and B
// are row-major with stride D + 4, read as float4 along D. kUnroll k
// steps a loop pass: their loads run ahead of the FFMAs, 4 (MI + 4)
// registers a step, so B3's threads that hold 128 accumulator registers
// take 2.
template <int MI, int D, int kUnroll>
__device__ __forceinline__ void scores(float (&x)[MI][4],
                                       const float* __restrict__ a,
                                       const float* __restrict__ b, int ty,
                                       int tx) {
  constexpr int kLd = D + 4;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) x[i][j] = 0.f;
#pragma unroll 1
  for (int k0 = 0; k0 < D; k0 += 4 * kUnroll) {
#pragma unroll
    for (int k = k0; k < k0 + 4 * kUnroll; k += 4) {
      float4 av[MI], bv[4];
#pragma unroll
      for (int i = 0; i < MI; ++i)
        av[i] =
            *reinterpret_cast<const float4*>(a + (ty + 16 * i) * kLd + k);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        bv[j] = *reinterpret_cast<const float4*>(b + (tx + 4 * j) * kLd + k);
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          x[i][j] = fmaf(av[i].x, bv[j].x, x[i][j]);
          x[i][j] = fmaf(av[i].y, bv[j].y, x[i][j]);
          x[i][j] = fmaf(av[i].z, bv[j].z, x[i][j]);
          x[i][j] = fmaf(av[i].w, bv[j].w, x[i][j]);
        }
    }
  }
}

using ffma::accumulate;
using ffma::store_acc;
using ffma::work_rank;
using ffma::zero;

// ---------------------------------------------------------------------------
// B2: dQ. One block per (batch, q head, q tile), in work_rank order of
// the q tiles (the last, heaviest under causal masks, first).
// ---------------------------------------------------------------------------

template <int D, bool Masked>
__global__ void __launch_bounds__(kThreads, DqCfg<D>::kMinBlocks)
    flash_bwd_dq_f32(const Args a, float* __restrict__ dq, int sms) {
  using C = DqCfg<D>;
  using A = typename C::Acc;
  constexpr int kR = C::kRows, kLd = C::kLd, kMI = kR / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  float* sQ = reinterpret_cast<float*>(smem + C::kQ);
  float* sdO = reinterpret_cast<float*>(smem + C::kDO);
  float* sKV = reinterpret_cast<float*>(smem + C::kKV);
  float* sP = reinterpret_cast<float*>(smem + C::kP);
  int* sSeg = reinterpret_cast<int*>(smem + C::kSeg);

  const int Nq = a.Nq, Nk = a.Nk, causal = a.causal, offset = a.offset;
  const int window = Masked ? a.window : 0;
  const int* kvseg = Masked ? a.kvseg : nullptr;
  const int heads = a.B * a.Hq;
  const int rank = work_rank(blockIdx.x, gridDim.x, sms, C::kMinBlocks);
  const int q0 = ((Nq + kR - 1) / kR - 1 - rank / heads) * kR;
  const int h = rank % heads % a.Hq, b = rank % heads / a.Hq;
  const int hk = h / (a.Hq / a.Hkv);
  const size_t qbase = ((size_t)b * a.Hq + h) * Nq;
  const size_t kvoff = ((size_t)b * a.Hkv + hk) * Nk * D;
  const float* kg = static_cast<const float*>(a.k) + kvoff;
  const float* vg = static_cast<const float*>(a.v) + kvoff;

  load_rows<D, kR>(sQ, static_cast<const float*>(a.q) + qbase * D, q0, Nq,
                   tid);
  load_rows<D, kR>(sdO, static_cast<const float*>(a.dout) + qbase * D, q0,
                   Nq, tid);

  // kv columns any real row of this tile can see: from the oldest inside
  // the first row's window (rounded down to a tile) to the last real
  // row's causal limit.
  int kv_begin = 0, kv_end = Nk;
  if (causal) kv_end = min(Nk, min(q0 + kR, Nq) - 1 + offset + 1);
  if (Masked && window > 0)
    kv_begin = max(q0 + offset - window + 1, 0) / kStream * kStream;
  const int n_steps =
      kv_end > kv_begin ? (kv_end - kv_begin + kStream - 1) / kStream : 0;
  auto issue = [&](int step) {
    const int j0 = kv_begin + step * kStream;
    float* st = sKV + (step & 1) * 2 * kStream * kLd;
    load_rows<D, kStream>(st, kg, j0, Nk, tid);
    load_rows<D, kStream>(st + kStream * kLd, vg, j0, Nk, tid);
    if (Masked && kvseg != nullptr)
      ffma::load_vec<kStream>(sSeg + (step & 1) * kStream,
                              kvseg + (size_t)b * Nk, j0, Nk, tid, 0);
  };
  if (n_steps > 0) issue(0);
  cp_async_commit();

  // Score roles: warps 0-1 S (then P), warps 2-3 dP (then dS), on rows
  // ty + 16 i and columns tx + 4 j of the [64, 16] tile.
  const bool is_s = tid < kHalf;
  const int ty = (tid % kHalf) / 4, tx = tid % 4;
  float rowv[kMI];   // lse log2e (S warps) or delta (dP warps)
  int qseg[kMI];
#pragma unroll
  for (int i = 0; i < kMI; ++i) {
    const int row = q0 + ty + 16 * i;
    const bool in = row < Nq;
    rowv[i] = !in ? 0.f : is_s ? a.lse[qbase + row] * kLog2e
                               : a.delta[qbase + row];
    qseg[i] = (kvseg != nullptr && in) ? a.qseg[(size_t)b * Nq + row] : 0;
  }
  const int aty = tid / A::kTX, atx = tid % A::kTX;
  float acc[A::kMR][4 * A::kNV];
  zero<A>(acc);
  const float c = a.scale * kLog2e, scale = a.scale;

  for (int step = 0; step < n_steps; ++step) {
    cp_async_wait<0>();
    __syncthreads();   // tile `step` landed; every thread left step - 1
    if (step + 1 < n_steps) issue(step + 1);
    cp_async_commit();
    const int j0 = kv_begin + step * kStream;
    const float* sK = sKV + (step & 1) * 2 * kStream * kLd;
    const float* sV = sK + kStream * kLd;
    const int* seg = sSeg + (step & 1) * kStream;

    float x[kMI][4];
    scores<kMI, D, 4>(
        x, is_s ? sQ : sdO, is_s ? sK : sV, ty, tx);
    if (is_s) {
#pragma unroll
      for (int i = 0; i < kMI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int row = q0 + ty + 16 * i, col = j0 + tx + 4 * j;
          bool ok = row < Nq && col < Nk && (!causal || col <= row + offset);
          if constexpr (Masked)
            ok = ok && (window <= 0 || col > row + offset - window) &&
                 (kvseg == nullptr || seg[tx + 4 * j] == qseg[i]);
          sP[(ty + 16 * i) * kLdP + tx + 4 * j] =
              ok ? exp2f(x[i][j] * c - rowv[i]) : 0.f;
        }
    }
    __syncthreads();   // P written
    if (!is_s) {
#pragma unroll
      for (int i = 0; i < kMI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float* p = sP + (ty + 16 * i) * kLdP + tx + 4 * j;
          *p = *p * (x[i][j] - rowv[i]) * scale;   // dS over P
        }
    }
    __syncthreads();   // dS written
    accumulate<A, kStream>(acc, sP, kLdP, sK, kLd, aty, atx);   // dQ
  }
  cp_async_wait<0>();
  store_acc<A, D>(acc, dq + qbase * D, q0, Nq, aty, atx);
}

// ---------------------------------------------------------------------------
// B3: dK and dV. One block per (batch, kv head, kv tile), in work_rank
// order of the kv tiles (the first, heaviest under causal masks, first);
// the q tiles of every q head of the GQA group stream through.
// ---------------------------------------------------------------------------

template <int D, bool Masked>
__global__ void __launch_bounds__(kThreads, DkvCfg<D>::kMinBlocks)
    flash_bwd_dkv_f32(const Args a, float* __restrict__ dk,
                      float* __restrict__ dv, int sms) {
  using C = DkvCfg<D>;
  using A = typename C::Acc;
  constexpr int kR = C::kRows, kLd = C::kLd, kMI = kR / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  float* sK = reinterpret_cast<float*>(smem + C::kK);
  float* sV = reinterpret_cast<float*>(smem + C::kV);
  float* sQO = reinterpret_cast<float*>(smem + C::kQO);
  float* sPt = reinterpret_cast<float*>(smem + C::kPt);
  float* sdSt = reinterpret_cast<float*>(smem + C::kDSt);
  float* sStat = reinterpret_cast<float*>(smem + C::kStat);

  const int Nq = a.Nq, Nk = a.Nk, causal = a.causal, offset = a.offset;
  const int window = Masked ? a.window : 0;
  const int* qsegs = Masked ? a.qseg : nullptr;
  const int group = a.Hq / a.Hkv;
  const int heads = a.B * a.Hkv;
  const int rank = work_rank(blockIdx.x, gridDim.x, sms, C::kMinBlocks);
  const int j0 = rank / heads * kR;
  const int hk = rank % heads % a.Hkv, b = rank % heads / a.Hkv;
  const size_t kvbase = ((size_t)b * a.Hkv + hk) * Nk;

  load_rows<D, kR>(sK, static_cast<const float*>(a.k) + kvbase * D, j0, Nk,
                   tid);
  load_rows<D, kR>(sV, static_cast<const float*>(a.v) + kvbase * D, j0, Nk,
                   tid);

  // The q tiles with a row that sees these kv rows: row j0 - offset is
  // the first to see column j0; under a window, row last - offset +
  // window - 1 is the last to see column last.
  const int nq_tiles = (Nq + kStream - 1) / kStream;
  const int iq_first = causal ? max(j0 - offset, 0) / kStream : 0;
  int iq_end = nq_tiles;
  if (Masked && window > 0) {
    const int last_q = min(j0 + kR, Nk) - 1 - offset + window - 1;
    iq_end = last_q < 0 ? 0 : min(nq_tiles, last_q / kStream + 1);
  }
  const int n_iq = max(iq_end - iq_first, 0);
  const int n_steps = group * n_iq;
  auto q_row0 = [&](int step) {
    return (iq_first + step % n_iq) * kStream;
  };
  auto q_base = [&](int step) {
    return ((size_t)b * a.Hq + (size_t)hk * group + step / n_iq) * Nq;
  };
  auto issue = [&](int step) {
    const int q0 = q_row0(step);
    const size_t qb = q_base(step);
    float* st = sQO + (step & 1) * 2 * kStream * kLd;
    load_rows<D, kStream>(st, static_cast<const float*>(a.q) + qb * D, q0,
                          Nq, tid);
    load_rows<D, kStream>(st + kStream * kLd,
                          static_cast<const float*>(a.dout) + qb * D, q0, Nq,
                          tid);
    float* stat = sStat + (step & 1) * 3 * kStream;
    ffma::load_vec<kStream>(stat, a.lse + qb, q0, Nq, tid, 0);
    ffma::load_vec<kStream>(stat + kStream, a.delta + qb, q0, Nq, tid,
                            kStream);
    if (Masked && qsegs != nullptr)
      ffma::load_vec<kStream>(reinterpret_cast<int*>(stat + 2 * kStream),
                              qsegs + (size_t)b * Nq, q0, Nq, tid,
                              2 * kStream);
  };
  if (n_steps > 0) issue(0);
  cp_async_commit();

  // Score roles: warps 0-1 S^T (then P^T), warps 2-3 dP^T (then dS^T), on
  // kv rows ty + 16 i and q columns tx + 4 j of the [kR, 16] tile.
  const bool is_s = tid < kHalf;
  const int ty = (tid % kHalf) / 4, tx = tid % 4;
  int kvseg[kMI];
#pragma unroll
  for (int i = 0; i < kMI; ++i) {
    const int kvrow = j0 + ty + 16 * i;
    kvseg[i] = (qsegs != nullptr && kvrow < Nk)
                   ? a.kvseg[(size_t)b * Nk + kvrow] : 0;
  }
  const int aty = tid / A::kTX, atx = tid % A::kTX;
  float acc_k[A::kMR][4 * A::kNV], acc_v[A::kMR][4 * A::kNV];
  zero<A>(acc_k);
  zero<A>(acc_v);
  const float c = a.scale * kLog2e, scale = a.scale;

  for (int step = 0; step < n_steps; ++step) {
    cp_async_wait<0>();
    __syncthreads();   // tile `step` landed; every thread left step - 1
    if (step + 1 < n_steps) issue(step + 1);
    cp_async_commit();
    const int q0 = q_row0(step);
    const float* sQ = sQO + (step & 1) * 2 * kStream * kLd;
    const float* sdO = sQ + kStream * kLd;
    const float* stat = sStat + (step & 1) * 3 * kStream;
    const int* seg = reinterpret_cast<const int*>(stat + 2 * kStream);

    float x[kMI][4];
    scores<kMI, D, (A::kMR * A::kNV >= 16 ? 2 : 4)>(
        x, is_s ? sK : sV, is_s ? sQ : sdO, ty, tx);
    if (is_s) {
#pragma unroll
      for (int i = 0; i < kMI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kvrow = j0 + ty + 16 * i, qi = q0 + tx + 4 * j;
          bool ok = qi < Nq && kvrow < Nk && (!causal || kvrow <= qi + offset);
          if constexpr (Masked)
            ok = ok && (window <= 0 || kvrow > qi + offset - window) &&
                 (qsegs == nullptr || seg[tx + 4 * j] == kvseg[i]);
          sPt[(ty + 16 * i) * kLdP + tx + 4 * j] =
              ok ? exp2f(x[i][j] * c - stat[tx + 4 * j] * kLog2e) : 0.f;
        }
    }
    __syncthreads();   // P^T written
    if (!is_s) {
#pragma unroll
      for (int i = 0; i < kMI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int idx = (ty + 16 * i) * kLdP + tx + 4 * j;
          sdSt[idx] = sPt[idx] * (x[i][j] - stat[kStream + tx + 4 * j]) *
                      scale;
        }
    }
    accumulate<A, kStream>(acc_v, sPt, kLdP, sdO, kLd, aty, atx);   // dV
    __syncthreads();   // dS^T written
    accumulate<A, kStream>(acc_k, sdSt, kLdP, sQ, kLd, aty, atx);   // dK
  }
  cp_async_wait<0>();
  store_acc<A, D>(acc_k, dk + kvbase * D, j0, Nk, aty, atx);
  store_acc<A, D>(acc_v, dv + kvbase * D, j0, Nk, aty, atx);
}

// The launchers: each raises the kernel's dynamic shared-memory limit
// before it launches; the grid is one block per (batch, head, tile),
// which work_rank maps to its item.
template <typename T, int D, bool Masked>
struct DqF32 {
  static cudaError_t run(const Args& a, void* dq) {
    static_assert(sizeof(T) == 4, "the FFMA body is fp32 only");
    using C = DqCfg<D>;
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_f32<D, Masked>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kBytes);
    if (err != cudaSuccess) return err;
    const int blocks = a.B * a.Hq * ((a.Nq + C::kRows - 1) / C::kRows);
    flash_bwd_dq_f32<D, Masked><<<blocks, kThreads, C::kBytes, a.stream>>>(
        a, static_cast<float*>(dq), ffma::sm_count());
    return cudaGetLastError();
  }
};

template <typename T, int D, bool Masked>
struct DkvF32 {
  static cudaError_t run(const Args& a, void* dk, void* dv) {
    static_assert(sizeof(T) == 4, "the FFMA body is fp32 only");
    using C = DkvCfg<D>;
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkv_f32<D, Masked>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kBytes);
    if (err != cudaSuccess) return err;
    const int blocks = a.B * a.Hkv * ((a.Nk + C::kRows - 1) / C::kRows);
    flash_bwd_dkv_f32<D, Masked><<<blocks, kThreads, C::kBytes, a.stream>>>(
        a, static_cast<float*>(dk), static_cast<float*>(dv),
        ffma::sm_count());
    return cudaGetLastError();
  }
};

}  // namespace f32
}  // namespace bwd
}  // namespace fa
