// B2 (dQ) and B3 (dK, dV) for fp16 / bf16 on Hopper (sm_90a), built
// from the pieces of sm90_attn.cuh. flash_bwd.cu holds the unmasked
// instantiations and the C entry points, flash_bwd_masked.cu the window /
// segment-id ones; fp32 inputs run the FFMA body of flash_bwd_f32.cuh
// (flash_bwd_f32.cu).
//
// B2 replaces the Pallas TPU kernel flash_attention_tpu/ops/flash.py
// `_bwd_dq_kernel` (flash.py:716, launched at :949), B3 `_bwd_dkv_kernel`
// (flash.py:773, launched at :1017). What they compute is flash_bwd.cuh's
// contract: P = exp2(S scale log2e - lse log2e) with S = Q K^T unscaled,
// dP = dO V^T, dS = P (dP - delta) scale with delta = rowsum(dO O) from
// the wrapper, then dQ = dS K, dK = dS^T Q, dV = P^T dO (GQA sums dK and
// dV over the group's q heads). P is rounded to T before the dV product
// and dS before the dQ and dK products, as the rs operands are packed;
// every sum is fp32. Masks are selects (a hidden pair gets P = 0, so a
// row that sees no key gets dQ = 0 exactly).
//
// What bounds them on the H100: at the training shape (q [4, 16, 2048,
// 128], kv [4, 8, 2048, 128], causal) B2 does 6 D and B3 8 D FLOPs a
// visible pair, hundreds of FLOPs a byte of traffic: both are bound by
// the tensor cores. So every product is a wgmma, the accumulators (dQ;
// dK and dV) stay in registers for the whole loop, and operand tiles
// arrive by TMA into swizzled shared memory that wgmma reads directly.
//
// B2: a block is kWG consumer warpgroups of 64 q rows (2 up to D = 128,
// 1 at D = 256, where dQ alone is 128 registers a thread) and one TMA
// producer warp. Q and dO load once; K and V tiles of 64 rows stream
// through a 2-stage ring (full / empty mbarriers). Per kv tile: S = Q K^T
// and dP = dO V^T (ss), P and dS formed on the accumulator fragment, then
// dQ += dS K (rs, K as the MN-major B operand: the tile serves both
// products). LSE and delta of a thread's two rows are plain loads into
// registers. Each warpgroup runs the kv tiles its own rows can see (the
// window's first tile to the causal end) and masks only tiles that cross
// the diagonal, the window's edge or Nk (every tile with segment ids);
// heaviest q tiles launch first.
//
// B3: a block is kWG consumer warpgroups of 64 kv rows with no producer
// warp (8 warps at most: 255 registers a thread for dK and dV at 64 each
// plus S^T, dP^T and the packed P^T, dS^T); thread 0 issues the TMA
// loads. K and V of the block load once; the Q and dO tiles (64 rows) of
// every q head of the GQA group, and every q tile that sees the block,
// stream through a 4-stage ring in a fixed order (group member, then q
// tile). Thread 0 refills the stage of the load before the previous one,
// so it never waits for the other warpgroup to finish the tile it just
// finished itself (waiting would lock the two into step, and their
// products would no longer interleave with the other's elementwise
// work). Per q tile: S^T = K Q^T and dP^T = V dO^T (ss), P^T and dS^T on
// the fragment, dV += P^T dO and dK += dS^T Q (rs, dO and Q MN-major).
// Each warpgroup stages the tile's LSE, delta and q segment ids (64 each)
// in shared memory, one plain load a thread, prefetched a tile ahead. At
// D = 256 dK and dV cannot both live in registers (256 a thread): the
// block is one warpgroup with a 2-stage ring and makes two passes over
// the q tiles, each accumulating one 128-column half of dK and dV and
// recomputing S^T and dP^T (design (a): 12 D FLOPs a pair instead of
// 8 D). The first kv tiles see the most q tiles under causal masks and
// launch first.
//
// Both stay split and deterministic: every output is a sum in one block
// in a fixed order, with no atomics.
#pragma once

#include <climits>

#include "flash_bwd.cuh"
#include "sm90_attn.cuh"

namespace fa {
namespace bwd {

// Q, dO [B * Hq, Nq, D] and K, V [B * Hkv, Nk, D] as swizzled tiles.
struct BwdMaps {
  CUtensorMap q, dout, k, v;
};

// B2: the kv columns [lo, hi) that q rows [r0, r0 + 64) can see before
// the per-pair masks; false when none.
__device__ __forceinline__ bool dq_range(const Args& a, int window, int r0,
                                         int& lo, int& hi) {
  if (r0 >= a.Nq) return false;
  const int last = min(r0 + 64, a.Nq) - 1;
  lo = 0;
  hi = a.Nk;
  if (a.causal) hi = min(a.Nk, last + a.offset + 1);
  if (window > 0) lo = max(r0 + a.offset - window + 1, 0);
  return hi > lo;
}

// B3: the q rows [lo, hi) that see some column of kv rows [j0, j0 + 64):
// row j0 - offset is the first to see column j0; under a window the
// last kv row's last viewer is last - offset + window - 1.
__device__ __forceinline__ bool dkv_range(const Args& a, int window, int j0,
                                          int& lo, int& hi) {
  if (j0 >= a.Nk) return false;
  lo = a.causal ? max(j0 - a.offset, 0) : 0;
  hi = a.Nq;
  if (window > 0)
    hi = min(a.Nq, min(j0 + 64, a.Nk) - 1 - a.offset + window);
  return hi > lo;
}

// Row r (0 or 1) of an m64nN fragment rounded to T into `orow` from
// column c0.
template <typename T, int N>
__device__ __forceinline__ void store_row(T* orow, const float (&acc)[N / 2],
                                          const sm90::Frag& f, int r,
                                          int c0) {
#pragma unroll
  for (int jb = 0; jb < N / 8; ++jb) {
    const int i = 4 * jb + 2 * r;
    *reinterpret_cast<uint32_t*>(orow + c0 + f.col_of(4 * jb)) =
        sm90::pack2<T>(acc[i], acc[i + 1]);
  }
}

// ---------------------------------------------------------------------------
// B2: dQ. One block per (q tile of 64 kWG rows, q head, batch).
// ---------------------------------------------------------------------------

template <int D>
struct DqCfg {
  static constexpr int kWG = D > 128 ? 1 : 2;
  static constexpr int kBM = 64 * kWG;            // q rows a block
  static constexpr int kBC = 64;                  // kv rows a tile
  static constexpr int kStages = 2;
  static constexpr int kConsumers = 128 * kWG;
  static constexpr int kThreads = kConsumers + 32;
  static constexpr uint32_t kQBytes = kBM * D * 2;     // Q or dO
  static constexpr uint32_t kTileBytes = kBC * D * 2;  // K or V
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kDO = kQBytes;
  static constexpr uint32_t kK = 2 * kQBytes;
  static constexpr uint32_t kV = kK + kStages * kTileBytes;
  static constexpr uint32_t kBars = kV + kStages * kTileBytes;
  // q_full, full[S], empty[S]
  static constexpr uint32_t kBytes = kBars + 8 * (1 + 2 * kStages) + 1024;
  static_assert(kBytes <= 232448, "B2 tiles exceed shared memory");
};

template <typename T, int D, bool Masked>
__global__ void __launch_bounds__(DqCfg<D>::kThreads, 1)
    flash_bwd_dq_sm90(const __grid_constant__ BwdMaps maps, const Args a,
                      T* __restrict__ dq) {
  using C = DqCfg<D>;
  constexpr int kBC = C::kBC, kS = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = sm90::align_smem(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + C::kBars);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kS;

  // Heaviest causal tiles first: the last q tile starts first.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * C::kBM;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kv_head = b * a.Hkv + h / (a.Hq / a.Hkv);
  const int window = Masked ? a.window : 0;

  int lo_blk = INT_MAX, hi_blk = INT_MIN;
#pragma unroll
  for (int w = 0; w < C::kWG; ++w) {
    int lo, hi;
    if (dq_range(a, window, q0 + 64 * w, lo, hi)) {
      lo_blk = min(lo_blk, lo);
      hi_blk = max(hi_blk, hi);
    }
  }
  const int j_first = hi_blk > lo_blk ? lo_blk / kBC * kBC : 0;
  const int n_tiles =
      hi_blk > lo_blk ? (hi_blk - j_first + kBC - 1) / kBC : 0;

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < kS; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 4 * C::kWG);   // one per consumer warp
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= C::kConsumers) {
    // --- producer: one thread keeps the K/V ring full ---
    if (threadIdx.x != C::kConsumers) return;
    const int q_head = b * a.Hq + h;
    sm90::mbar_expect_tx(q_full, 2 * C::kQBytes);
    sm90::load_tile<D>(smem + C::kQ, &maps.q, q_full, C::kBM, q0, q_head);
    sm90::load_tile<D>(smem + C::kDO, &maps.dout, q_full, C::kBM, q0,
                       q_head);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kS;
      const int j0 = j_first + it * kBC;
      sm90::mbar_wait(&empty[s], ((it / kS) & 1) ^ 1);
      sm90::mbar_expect_tx(&full[s], 2 * C::kTileBytes);
      sm90::load_tile<D>(smem + C::kK + s * C::kTileBytes, &maps.k, &full[s],
                         kBC, j0, kv_head);
      sm90::load_tile<D>(smem + C::kV + s * C::kTileBytes, &maps.v, &full[s],
                         kBC, j0, kv_head);
    }
    return;
  }

  // --- consumer warpgroups: 64 q rows each ---
  const int cw = threadIdx.x / 128;
  const int t = threadIdx.x % 128, lane = threadIdx.x % 32;
  const sm90::Frag f(t);
  const int q0w = q0 + 64 * cw;
  const int row0 = q0w + f.row;   // this thread's rows: row0, row0 + 8
  int lo = 0, hi = 0;
  const bool live = dq_range(a, window, q0w, lo, hi);
  const int Nq = a.Nq, Nk = a.Nk, causal = a.causal, offset = a.offset;
  const size_t qbase = ((size_t)b * a.Hq + h) * Nq;
  const int* __restrict__ kvseg =
      Masked && a.kvseg != nullptr ? a.kvseg + (size_t)b * Nk : nullptr;
  float lse2[2], dlt[2];
  int seg[2] = {0, 0};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const bool in = row < Nq;
    lse2[r] = in ? a.lse[qbase + row] * kLog2e : 0.f;
    dlt[r] = in ? a.delta[qbase + row] : 0.f;
    if (kvseg != nullptr && in) seg[r] = a.qseg[(size_t)b * Nq + row];
  }
  const uint32_t sq = sm90::smem_u32(smem + C::kQ);
  const uint32_t sdo = sm90::smem_u32(smem + C::kDO);
  const uint32_t sk = sm90::smem_u32(smem + C::kK);
  const uint32_t sv = sm90::smem_u32(smem + C::kV);
  const float c = a.scale * kLog2e, scale = a.scale;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  sm90::mbar_wait(q_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kS;
    const int j0 = j_first + it * kBC;
    sm90::mbar_wait(&full[s], (it / kS) & 1);
    if (live && j0 < hi && j0 + kBC > lo) {
      const uint32_t k_s = sk + s * C::kTileBytes;
      float sc[kBC / 2], dp[kBC / 2];
      // P is formed while dP = dO V^T is still in flight.
      sm90::wgmma_fence();
      sm90::qk<T, D, kBC>(sc, sq, C::kBM, 64 * cw, k_s);
      sm90::wgmma_commit();
      sm90::qk<T, D, kBC>(dp, sdo, C::kBM, 64 * cw,
                          sv + s * C::kTileBytes);
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();
      sm90::fence_regs(sc);

      const bool edge =
          kvseg != nullptr || j0 < lo || j0 + kBC > hi ||
          (causal && j0 + kBC - 1 > q0w + offset) ||
          (window > 0 && j0 <= q0w + 63 + offset - window);
#pragma unroll
      for (int jb = 0; jb < kBC / 8; ++jb) {
        const int col0 = j0 + f.col_of(4 * jb);
        int ks[2] = {0, 0};
        if (kvseg != nullptr) {
          if (col0 < Nk) ks[0] = kvseg[col0];
          if (col0 + 1 < Nk) ks[1] = kvseg[col0 + 1];
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * jb + e, r = e >> 1;
          float p = sm90::ex2(fmaf(sc[i], c, -lse2[r]));
          if (edge) {
            const int col = col0 + (e & 1);
            const int row = row0 + 8 * r;
            const bool ok =
                col >= lo && col < hi && (!causal || col <= row + offset) &&
                (window <= 0 || col > row + offset - window) &&
                (kvseg == nullptr || ks[e & 1] == seg[r]);
            p = ok ? p : 0.f;
          }
          sc[i] = p;
        }
      }
      sm90::wgmma_wait();
      sm90::fence_regs(dp);
      uint32_t ds[kBC / 4];
#pragma unroll
      for (int j = 0; j < kBC / 4; ++j) {
        const int r = j & 1;
        ds[j] = sm90::pack2<T>(sc[2 * j] * (dp[2 * j] - dlt[r]) * scale,
                               sc[2 * j + 1] * (dp[2 * j + 1] - dlt[r]) *
                                   scale);
      }

      sm90::wgmma_fence();
      sm90::pv<T, D, kBC>(acc, ds, k_s);
      sm90::wgmma_commit();
      sm90::wgmma_wait();
      sm90::fence_regs(acc);
      sm90::fence_regs(ds);
    }
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[s]);
  }

  // Every real row is stored, rows that saw nothing as zeros.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row < Nq) store_row<T, D>(dq + (qbase + row) * D, acc, f, r, 0);
  }
}

// ---------------------------------------------------------------------------
// B3: dK and dV. One block per (kv tile of 64 kWG rows, kv head, batch).
// ---------------------------------------------------------------------------

// B3's ring loads in order: q tile iq (from the block's first) of GQA
// group member g, tiles fastest, the same sequence again each pass. A
// walker steps through them without a division a load.
struct QWalk {
  int g = 0, iq = 0;
  __device__ __forceinline__ void step(int n_q, int group) {
    if (++iq == n_q) {
      iq = 0;
      if (++g == group) g = 0;
    }
  }
};

template <int D>
struct DkvCfg {
  static constexpr int kWG = D > 128 ? 1 : 2;
  static constexpr int kBK = 64 * kWG;               // kv rows a block
  static constexpr int kBQ = 64;                     // q rows a tile
  static constexpr int kDN = D > 128 ? 128 : D;      // dK / dV columns a pass
  static constexpr int kPasses = D / kDN;
  static constexpr int kStages = D > 128 ? 2 : 4;
  // Thread 0 refills the stage of load n - kLag at load n: with two
  // warpgroups the other one may still be a tile behind, so waiting for
  // load n - 1 would lock the two into step.
  static constexpr int kLag = kWG;
  static constexpr int kThreads = 128 * kWG;
  static constexpr uint32_t kKvBytes = kBK * D * 2;     // K or V
  static constexpr uint32_t kTileBytes = kBQ * D * 2;   // Q or dO
  static constexpr uint32_t kK = 0;
  static constexpr uint32_t kV = kKvBytes;
  // Stage s: Q at kQ + 2 s kTileBytes, dO right after it.
  static constexpr uint32_t kQ = 2 * kKvBytes;
  // Per warpgroup, two slots of [lse * log2e, delta, q segment id] of
  // the tile's 64 rows (4-byte values).
  static constexpr int kSlot = 3 * kBQ;
  static constexpr uint32_t kStats = kQ + kStages * 2 * kTileBytes;
  static constexpr uint32_t kBars = kStats + kWG * 2 * kSlot * 4;
  // kv_full, full[S], empty[S]
  static constexpr uint32_t kBytes = kBars + 8 * (1 + 2 * kStages) + 1024;
  static_assert(kBytes <= 232448, "B3 tiles exceed shared memory");
};

template <typename T, int D, bool Masked>
__global__ void __launch_bounds__(DkvCfg<D>::kThreads, 1)
    flash_bwd_dkv_sm90(const __grid_constant__ BwdMaps maps, const Args a,
                       T* __restrict__ dk, T* __restrict__ dv) {
  using C = DkvCfg<D>;
  constexpr int kBQ = C::kBQ, kS = C::kStages, kDN = C::kDN;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = sm90::align_smem(smem_raw);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + C::kBars);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kS;

  const int j0 = blockIdx.x * C::kBK;   // the first kv tiles are heaviest
  const int hk = blockIdx.y, b = blockIdx.z;
  const int group = a.Hq / a.Hkv;
  const int window = Masked ? a.window : 0;
  const int Nq = a.Nq, Nk = a.Nk, causal = a.causal, offset = a.offset;

  int lo_blk = INT_MAX, hi_blk = INT_MIN;
#pragma unroll
  for (int w = 0; w < C::kWG; ++w) {
    int lo, hi;
    if (dkv_range(a, window, j0 + 64 * w, lo, hi)) {
      lo_blk = min(lo_blk, lo);
      hi_blk = max(hi_blk, hi);
    }
  }
  const int iq_first = hi_blk > lo_blk ? lo_blk / kBQ : 0;
  const int n_q = hi_blk > lo_blk ? (hi_blk + kBQ - 1) / kBQ - iq_first : 0;
  const int n_it = group * n_q;            // q tiles a pass
  const int n_load = C::kPasses * n_it;    // ring loads in all

  if (threadIdx.x == 0) {
    sm90::mbar_init(kv_full, 1);
    for (int s = 0; s < kS; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 4 * C::kWG);   // one per warp
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  // The q head and first row of the load a walker points at.
  auto q_head = [&](const QWalk& w) { return b * a.Hq + hk * group + w.g; };
  auto q_row0 = [&](const QWalk& w) { return (iq_first + w.iq) * kBQ; };
  // Thread 0: issues ring load n_issued (the walker `lw`) into its stage.
  QWalk lw;
  int n_issued = 0;
  auto load_next = [&]() {
    const int s = n_issued % kS;
    unsigned char* dst = smem + C::kQ + s * 2 * C::kTileBytes;
    sm90::mbar_expect_tx(&full[s], 2 * C::kTileBytes);
    sm90::load_tile<D>(dst, &maps.q, &full[s], kBQ, q_row0(lw), q_head(lw));
    sm90::load_tile<D>(dst + C::kTileBytes, &maps.dout, &full[s], kBQ,
                       q_row0(lw), q_head(lw));
    lw.step(n_q, group);
    ++n_issued;
  };

  const int tid = threadIdx.x;
  if (tid == 0) {
    const int kv_head = b * a.Hkv + hk;
    sm90::mbar_expect_tx(kv_full, 2 * C::kKvBytes);
    sm90::load_tile<D>(smem + C::kK, &maps.k, kv_full, C::kBK, j0, kv_head);
    sm90::load_tile<D>(smem + C::kV, &maps.v, kv_full, C::kBK, j0, kv_head);
    while (n_issued < kS && n_issued < n_load) load_next();
  }
  __syncwarp();

  const int cw = tid / 128;
  const int t = tid % 128, lane = tid % 32;
  const sm90::Frag f(t);
  const int j0w = j0 + 64 * cw;
  const int kv0 = j0w + f.row;   // this thread's kv rows: kv0, kv0 + 8
  int lo = 0, hi = 0;
  const bool live = dkv_range(a, window, j0w, lo, hi);
  const int* __restrict__ qseg =
      Masked && a.qseg != nullptr ? a.qseg + (size_t)b * Nq : nullptr;
  int seg[2] = {0, 0};
  if (qseg != nullptr) {
    if (kv0 < Nk) seg[0] = a.kvseg[(size_t)b * Nk + kv0];
    if (kv0 + 8 < Nk) seg[1] = a.kvseg[(size_t)b * Nk + kv0 + 8];
  }
  float* stats =
      reinterpret_cast<float*>(smem + C::kStats) + cw * 2 * C::kSlot;
  // Thread t stages LSE * log2e (t < 64) or delta (t >= 64) of row t % 64
  // of the load the walker `sw` points at (one ahead of the consumers'
  // `cwk`), and with segment ids the row's id (t < 64).
  QWalk sw, cwk;
  const bool stage_seg = qseg != nullptr && t < kBQ;
  float stat_next = 0.f;
  int seg_next = 0;
  auto prefetch = [&]() {
    const int row = q_row0(sw) + (t % kBQ);
    const size_t i = (size_t)q_head(sw) * Nq + row;
    stat_next = row >= Nq ? 0.f
                : t < kBQ ? a.lse[i] * kLog2e
                          : a.delta[i];
    if (stage_seg) seg_next = row < Nq ? qseg[row] : 0;
    sw.step(n_q, group);
  };
  if (n_load > 0) prefetch();

  const uint32_t sk = sm90::smem_u32(smem + C::kK);
  const uint32_t sv = sm90::smem_u32(smem + C::kV);
  const uint32_t sq = sm90::smem_u32(smem + C::kQ);
  const float c = a.scale * kLog2e, scale = a.scale;
  const size_t kvbase = ((size_t)b * a.Hkv + hk) * Nk;
  // The pass's columns within a Q / dO stage tile (whole swizzled chunks).
  constexpr uint32_t kPassBytes =
      kDN / sm90::Sw<D>::kCols * kBQ * sm90::Sw<D>::kRowBytes;

  sm90::mbar_wait(kv_full, 0);
#pragma unroll 1
  for (int pass = 0; pass < C::kPasses; ++pass) {
    float dka[kDN / 2], dva[kDN / 2];
#pragma unroll
    for (int i = 0; i < kDN / 2; ++i) dka[i] = dva[i] = 0.f;

    for (int it = 0; it < n_it; ++it) {
      const int n = pass * n_it + it;
      const int s = n % kS;
      // Thread 0 refills the stage that load n - kLag used once every
      // warp has released it.
      constexpr int kLag = C::kLag;
      if (tid == 0 && n >= kLag && n - kLag + kS < n_load) {
        sm90::mbar_wait(&empty[(n - kLag) % kS], ((n - kLag) / kS) & 1);
        load_next();
      }
      __syncwarp();
      float* slot = stats + (n & 1) * C::kSlot;
      int* slot_seg = reinterpret_cast<int*>(slot + 2 * kBQ);
      slot[t] = stat_next;
      if (stage_seg) slot_seg[t] = seg_next;
      if (n + 1 < n_load) prefetch();
      // This warpgroup's stats of load n are visible; the slot it
      // overwrote was last read two loads ago, before the previous
      // barrier.
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
      sm90::mbar_wait(&full[s], (n / kS) & 1);

      const int q0 = q_row0(cwk);
      cwk.step(n_q, group);
      if (live && q0 < hi && q0 + kBQ > lo) {
        const uint32_t q_s = sq + s * 2 * C::kTileBytes;
        const uint32_t do_s = q_s + C::kTileBytes;
        float st[kBQ / 2], dpt[kBQ / 2];
        // P^T is formed while dP^T = V dO^T is in flight, dS^T while
        // dV += P^T dO is.
        sm90::wgmma_fence();
        sm90::qk<T, D, kBQ>(st, sk, C::kBK, 64 * cw, q_s);
        sm90::wgmma_commit();
        sm90::qk<T, D, kBQ>(dpt, sv, C::kBK, 64 * cw, do_s);
        sm90::wgmma_commit();
        sm90::wgmma_wait<1>();
        sm90::fence_regs(st);

        const bool edge =
            qseg != nullptr || q0 + kBQ > Nq || j0w + 64 > Nk || q0 < lo ||
            q0 + kBQ > hi || (causal && j0w + 63 > q0 + offset) ||
            (window > 0 && j0w <= q0 + kBQ - 1 + offset - window);
        uint32_t pt[kBQ / 4], dst[kBQ / 4];
#pragma unroll
        for (int jb = 0; jb < kBQ / 8; ++jb) {
          const int cl = f.col_of(4 * jb);
          const float2 l2 = *reinterpret_cast<const float2*>(slot + cl);
          const int2 qs = qseg != nullptr
                              ? *reinterpret_cast<const int2*>(slot_seg + cl)
                              : make_int2(0, 0);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * jb + e, r = e >> 1;
            float p = sm90::ex2(fmaf(st[i], c, -((e & 1) ? l2.y : l2.x)));
            if (edge) {
              const int qc = q0 + cl + (e & 1);
              const int kr = kv0 + 8 * r;
              const bool ok =
                  qc < Nq && kr < Nk && (!causal || kr <= qc + offset) &&
                  (window <= 0 || kr > qc + offset - window) &&
                  (qseg == nullptr || ((e & 1) ? qs.y : qs.x) == seg[r]);
              p = ok ? p : 0.f;
            }
            st[i] = p;
          }
          pt[2 * jb] = sm90::pack2<T>(st[4 * jb], st[4 * jb + 1]);
          pt[2 * jb + 1] = sm90::pack2<T>(st[4 * jb + 2], st[4 * jb + 3]);
        }
        sm90::wgmma_fence();
        sm90::pv<T, kDN, kBQ>(dva, pt, do_s + pass * kPassBytes);
        sm90::wgmma_commit();
        sm90::wgmma_wait<1>();
        sm90::fence_regs(dpt);
#pragma unroll
        for (int jb = 0; jb < kBQ / 8; ++jb) {
          const float2 dl =
              *reinterpret_cast<const float2*>(slot + kBQ + f.col_of(4 * jb));
          float x[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * jb + e;
            x[e] = st[i] * (dpt[i] - ((e & 1) ? dl.y : dl.x)) * scale;
          }
          dst[2 * jb] = sm90::pack2<T>(x[0], x[1]);
          dst[2 * jb + 1] = sm90::pack2<T>(x[2], x[3]);
        }
        sm90::wgmma_fence();
        sm90::pv<T, kDN, kBQ>(dka, dst, q_s + pass * kPassBytes);
        sm90::wgmma_commit();
        sm90::wgmma_wait();
        sm90::fence_regs(dva);
        sm90::fence_regs(dka);
        sm90::fence_regs(pt);
        sm90::fence_regs(dst);
      }
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&empty[s]);
    }

    // Every real kv row is stored, rows no q row saw as zeros.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = kv0 + 8 * r;
      if (row >= Nk) continue;
      store_row<T, kDN>(dk + (kvbase + row) * D, dka, f, r, pass * kDN);
      store_row<T, kDN>(dv + (kvbase + row) * D, dva, f, r, pass * kDN);
    }
  }
}

// The launchers: each raises the kernel's dynamic shared-memory limit,
// encodes the four tensor maps and launches on the caller's stream.
template <typename T, int D, bool Masked>
struct Dq {
  static cudaError_t run(const Args& a, void* dq) {
    using C = DqCfg<D>;
    auto kernel = flash_bwd_dq_sm90<T, D, Masked>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kBytes);
    if (err != cudaSuccess) return err;
    BwdMaps maps{};
    const int qh = a.B * a.Hq, kh = a.B * a.Hkv;
    if (!sm90::encode_tile_map<T, D>(&maps.q, a.q, qh, a.Nq, C::kBM) ||
        !sm90::encode_tile_map<T, D>(&maps.dout, a.dout, qh, a.Nq, C::kBM) ||
        !sm90::encode_tile_map<T, D>(&maps.k, a.k, kh, a.Nk, C::kBC) ||
        !sm90::encode_tile_map<T, D>(&maps.v, a.v, kh, a.Nk, C::kBC))
      return cudaErrorInvalidValue;
    dim3 grid((a.Nq + C::kBM - 1) / C::kBM, a.Hq, a.B);
    kernel<<<grid, C::kThreads, C::kBytes, a.stream>>>(maps, a,
                                                       static_cast<T*>(dq));
    return cudaGetLastError();
  }
};

template <typename T, int D, bool Masked>
struct Dkv {
  static cudaError_t run(const Args& a, void* dk, void* dv) {
    using C = DkvCfg<D>;
    auto kernel = flash_bwd_dkv_sm90<T, D, Masked>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kBytes);
    if (err != cudaSuccess) return err;
    BwdMaps maps{};
    const int qh = a.B * a.Hq, kh = a.B * a.Hkv;
    if (!sm90::encode_tile_map<T, D>(&maps.q, a.q, qh, a.Nq, C::kBQ) ||
        !sm90::encode_tile_map<T, D>(&maps.dout, a.dout, qh, a.Nq, C::kBQ) ||
        !sm90::encode_tile_map<T, D>(&maps.k, a.k, kh, a.Nk, C::kBK) ||
        !sm90::encode_tile_map<T, D>(&maps.v, a.v, kh, a.Nk, C::kBK))
      return cudaErrorInvalidValue;
    dim3 grid((a.Nk + C::kBK - 1) / C::kBK, a.Hkv, a.B);
    kernel<<<grid, C::kThreads, C::kBytes, a.stream>>>(
        maps, a, static_cast<T*>(dk), static_cast<T*>(dv));
    return cudaGetLastError();
  }
};

// Dispatch over the fp16 / bf16 dtypes and the head dim.
template <template <typename, int, bool> class F, bool Masked,
          typename... Out>
cudaError_t dispatch(int dtype, int D, const Args& a, Out... out) {
  if (dtype == kBFloat16)
    return dispatch_d<F, Masked, __nv_bfloat16>(D, a, out...);
  if (dtype == kFloat16) return dispatch_d<F, Masked, __half>(D, a, out...);
  return cudaErrorInvalidValue;
}

}  // namespace bwd
}  // namespace fa
