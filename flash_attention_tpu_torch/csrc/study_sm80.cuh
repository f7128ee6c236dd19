// B10a's 16 x 16 tile for fp16 / bf16 (variants_fa1.cu routes (T = fp16 /
// bf16, 16, 16) here at every head dim): a register body on mma.sync.
//
// Replaces the Pallas TPU kernel flash_attention_tpu/ops/variants.py
// `_fa1_kernel` (variants.py:80, launched at :177) at the 16 x 16 tile
// that the FA1 tile law picks at `cli verify`'s defaults (M = 4096,
// d = 64).
//
// The contract of the 16 x 16 tile (what flash_attention_fa1_plain(...,
// block_kv=16) computes): each 16-row q tile runs the FA1 recurrence of
// variants_fa1.cu over the keys 16 columns at a time; the tile max m~,
// P~ = exp(S - m~) and l~ = rowsum P~ are taken per 16-column step;
// acc = alpha acc + beta (P~ V) with P~ V in a fresh accumulator (beta =
// e^{m~ - m_new} may underflow to 0, so it cannot scale acc instead);
// P~ is rounded to T before the P~ V product, l~ sums the fp32 values.
// O = acc / l (l == 0 read as 1); m (scaled units) and l go out as fp32
// [B, H, Nq]. How many q tiles share a block and how deep the K / V
// staging is are this body's choice, not the tile's.
//
// What bounds it on the H100: every 16-row q tile reads all of K and V
// once from shared memory (B10a is MHA: nothing is shared across heads),
// 4 D bytes a key for 64 D FLOPs, so at 128 bytes a clock an SM the
// shared-memory reads, not the tensor cores, set the floor (reckoned for
// an H100 SXM at its 700 W clocks, not measured: about 0.036 ms at (1,
// 8, 2048, 128)). The first body (study.cuh's WMMA block) added
// round trips of S, P and O through shared memory and loads that never
// overlapped a product. This body:
//
//  - One warp owns one 16-row q tile and takes its 16-column steps one
//    at a time, in key order; a block is kWarps = 8 warps (128
//    q rows of one head), so each K / V slab a block stages from L2
//    feeds 8 q tiles (4 blocks of 64 rows would read K and V from L2
//    twice as often). Q's A fragments stay in registers for the whole
//    loop up to D = 128 (D / 4 registers); at D = 256 they are re-read
//    by ldmatrix from the block's resident Q tile.
//  - S = Q K^T lands in registers (two m16n8k16 accumulators, K's B
//    fragments by ldmatrix); the row max and sum use quad shuffles on the
//    accumulator fragment; P~ is packed to T in registers and is the A
//    fragment of P~ V as it stands (the m16n8 accumulator layout is the
//    m16k16 A layout), with V's B fragments by ldmatrix.trans. O stays in
//    registers (D / 2 a thread) from the first step to the store.
//  - The 8 warps share a ring of kStages K / V slabs of kSlab rows (4
//    steps of 16 up to D = 128, 2 at D = 256), filled by cp.async from
//    all 256 threads, so the loads of the next slabs overlap the
//    products of this one. Stages: as many (up to 4) as fit two blocks
//    (16 warps) an SM up to D = 64, one block above.
//  - Ragged Nq / Nk: rows and keys past the end load as zeros (cp.async
//    with a source size of 0), columns past Nk are -inf on the last step,
//    steps wholly past Nk are skipped, rows past Nq are not stored.
//
// tests/test_torch_study_tile16.py mirrors Tile16 (rows a block, warps,
// slab rows, stages, shared bytes).
#pragma once

#include "mma_sm80.cuh"
#include "sm90_attn.cuh"
#include "study.cuh"

namespace fa {
namespace study {

template <int D>
struct Tile16 {
  static constexpr int kWarps = 8;                // a 16-row q tile each
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kRows = 16 * kWarps;       // q rows of a block
  static constexpr int kSlab = D > 128 ? 32 : 64; // kv rows of a stage
  static constexpr int kLd = D + 8;               // row stride (elements)
  static constexpr size_t kRowBytes = 2 * kLd;
  static constexpr size_t kQBytes = kRows * kRowBytes;
  static constexpr size_t kStageBytes = 2 * kSlab * kRowBytes;   // K, V
  // Two blocks an SM up to D = 64, one above (a thread needs over 128
  // registers there): 228 KB an SM, 1 KB of it reserved for each block,
  // at most 227 KB a block.
  static constexpr int kBlocksPerSM = D > 64 ? 1 : 2;
  static constexpr size_t kSmBudget = 233472 / kBlocksPerSM - 1024;
  static constexpr size_t kBudget = kSmBudget < 232448 ? kSmBudget : 232448;
  static constexpr int kFit = (int)((kBudget - kQBytes) / kStageBytes);
  static constexpr int kStages = kFit > 4 ? 4 : kFit;
  static constexpr size_t kBytes = kQBytes + kStages * kStageBytes;
  static constexpr bool kQInRegs = D <= 128;
  static_assert(kStages >= 2, "the ring needs two stages");
};

template <typename T, int D>
__global__ void __launch_bounds__(Tile16<D>::kThreads,
                                  Tile16<D>::kBlocksPerSM)
    fa1_tile16(const Args a) {
  using C = Tile16<D>;
  constexpr int kLd = C::kLd, kSlab = C::kSlab, kStages = C::kStages;
  constexpr int kChunks = D / 8;   // 16-byte chunks a row
  extern __shared__ __align__(128) unsigned char smem[];
  T* sq = reinterpret_cast<T*>(smem);
  T* ring = reinterpret_cast<T*>(smem + C::kQBytes);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int q0 = blockIdx.x * C::kRows;
  const size_t head = (size_t)blockIdx.z * a.Hq + blockIdx.y;   // MHA
  const int Nq = a.Nq, Nk = a.Nk;
  const T* qg = static_cast<const T*>(a.q) + head * Nq * D;
  const T* kg = static_cast<const T*>(a.k) + head * Nk * D;
  const T* vg = static_cast<const T*>(a.v) + head * Nk * D;
  const float c = a.scale * kLog2e;
  const int n_slabs = (Nk + kSlab - 1) / kSlab;

  // The block's q rows (zeros past Nq) join the first slab's group.
  for (int i = tid; i < C::kRows * kChunks; i += C::kThreads) {
    const int r = i / kChunks, col = (i % kChunks) * 8;
    const bool ok = q0 + r < Nq;
    cp_async16(sq + r * kLd + col, qg + (size_t)(ok ? q0 + r : 0) * D + col,
               ok ? 16 : 0);
  }
  // Slab it (keys [it kSlab, (it + 1) kSlab)) into its ring stage.
  auto issue = [&](int it) {
    T* sk = ring + (it % kStages) * 2 * kSlab * kLd;
    T* sv = sk + kSlab * kLd;
    const int j0 = it * kSlab;
    for (int i = tid; i < kSlab * kChunks; i += C::kThreads) {
      const int r = i / kChunks, col = (i % kChunks) * 8;
      const bool ok = j0 + r < Nk;
      const size_t off = (size_t)(ok ? j0 + r : 0) * D + col;
      cp_async16(sk + r * kLd + col, kg + off, ok ? 16 : 0);
      cp_async16(sv + r * kLd + col, vg + off, ok ? 16 : 0);
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_slabs) issue(s);
    cp_async_commit();
  }

  const T* sqw = sq + warp * 16 * kLd;
  uint32_t qa[C::kQInRegs ? D / 16 : 1][4];
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  // Rows gid and gid + 8 of the warp's tile: m in scaled units (as the
  // plain version's), this thread's share of l.
  float m[2] = {kInitM, kInitM}, l[2] = {0.f, 0.f};

  for (int it = 0; it < n_slabs; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // slab it landed; every warp left slab it - 1
    if (it + kStages - 1 < n_slabs) issue(it + kStages - 1);
    cp_async_commit();
    if constexpr (C::kQInRegs) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          ldsm_x4(qa[kk], sqw + (lane % 16) * kLd + (lane / 16) * 8 + 16 * kk);
      }
    }
    const T* sk = ring + (it % kStages) * 2 * kSlab * kLd;
    const T* sv = sk + kSlab * kLd;
#pragma unroll 1
    for (int st = 0; st < kSlab / 16; ++st) {
      const int j0 = it * kSlab + 16 * st;
      if (j0 >= Nk) break;
      const T* kst = sk + 16 * st * kLd;
      const T* vst = sv + 16 * st * kLd;

      // S = Q K^T: [16 rows, 16 keys] in two n8 accumulators, K's B
      // fragments by ldmatrix. s[n][e]: row gid + 8 (e / 2), key 8 n +
      // 2 tig + e % 2 of the step.
      float s[2][4] = {};
      const T* kfrag = kst + ((lane / 16) * 8 + lane % 8) * kLd +
                       ((lane / 8) % 2) * 8;
      if constexpr (C::kQInRegs) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t kf[4];
          ldsm_x4(kf, kfrag + 16 * kk);
          mma<T>(s[0], qa[kk], kf[0], kf[1]);
          mma<T>(s[1], qa[kk], kf[2], kf[3]);
        }
      } else {
#pragma unroll 1
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t kf[4], qf[4];
          ldsm_x4(kf, kfrag + 16 * kk);
          ldsm_x4(qf, sqw + (lane % 16) * kLd + (lane / 16) * 8 + 16 * kk);
          mma<T>(s[0], qf, kf[0], kf[1]);
          mma<T>(s[1], qf, kf[2], kf[3]);
        }
      }

      // The step's tile max m~ per row (raw units; finite, since key j0 <
      // Nk), P~ = exp2((S - m~) c) (ex2.approx, as the Hopper bodies)
      // packed to T as the A fragment of P~ V (rows gid / gid + 8, keys
      // 2 tig and 8 + 2 tig), and this thread's share of l~ (fp32
      // values). Keys >= Nk are -inf.
      if (j0 + 16 > Nk) {
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (j0 + 8 * n + 2 * tig + (e & 1) >= Nk) s[n][e] = -INFINITY;
      }
      float alpha[2], beta[2];
      uint32_t pa[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float x = fmaxf(fmaxf(s[0][2 * h], s[0][2 * h + 1]),
                        fmaxf(s[1][2 * h], s[1][2 * h + 1]));
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
        const float mc = x * c;
        const float p00 = sm90::ex2(fmaf(s[0][2 * h], c, -mc));
        const float p01 = sm90::ex2(fmaf(s[0][2 * h + 1], c, -mc));
        const float p10 = sm90::ex2(fmaf(s[1][2 * h], c, -mc));
        const float p11 = sm90::ex2(fmaf(s[1][2 * h + 1], c, -mc));
        pa[h] = pack2<T>(p00, p01);
        pa[2 + h] = pack2<T>(p10, p11);
        // The recurrence: m_new = max(m, m~), alpha = e^{m - m_new},
        // beta = e^{m~ - m_new}, l = alpha l + beta l~.
        const float mt_s = x * a.scale;
        const float m_new = fmaxf(m[h], mt_s);
        alpha[h] = sm90::ex2((m[h] - m_new) * kLog2e);
        beta[h] = sm90::ex2((mt_s - m_new) * kLog2e);
        l[h] = alpha[h] * l[h] + beta[h] * ((p00 + p01) + (p10 + p11));
        m[h] = m_new;
      }

      // acc = alpha acc + beta (P~ V), P~ V fresh (16 channels a V^T
      // load, V's B fragments by ldmatrix.trans).
#pragma unroll
      for (int jj = 0; jj < D / 16; ++jj) {
        uint32_t vf[4];
        ldsm_x4_trans(vf, vst + (((lane / 8) % 2) * 8 + lane % 8) * kLd +
                              (lane / 16) * 8 + 16 * jj);
        float t[2][4];
        mma_fresh<T>(t[0], pa, vf[0], vf[1]);
        mma_fresh<T>(t[1], pa, vf[2], vf[3]);
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float& o = acc[2 * jj + n][e];
            o = fmaf(alpha[e >> 1], o, beta[e >> 1] * t[n][e]);
          }
      }
    }
  }
  cp_async_wait<0>();

  // O = acc / l (l == 0 read as 1), m and l; rows < Nq.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lr = l[h] + __shfl_xor_sync(0xffffffffu, l[h], 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int row = q0 + warp * 16 + gid + 8 * h;
    if (row >= Nq) continue;
    const float inv = lr == 0.f ? 1.f : 1.f / lr;
    T* orow = static_cast<T*>(a.o) + (head * Nq + row) * D + 2 * tig;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j) =
          pack2<T>(acc[j][2 * h] * inv, acc[j][2 * h + 1] * inv);
    if (tig == 0) {
      a.m[head * Nq + row] = m[h];
      a.l[head * Nq + row] = lr;
    }
  }
}

template <typename T, int D>
cudaError_t launch_tile16(const Args& a) {
  using C = Tile16<D>;
  cudaError_t err = cudaFuncSetAttribute(
      fa1_tile16<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::kBytes);
  if (err != cudaSuccess) return err;
  dim3 grid((a.Nq + C::kRows - 1) / C::kRows, a.Hq, a.B);
  fa1_tile16<T, D><<<grid, C::kThreads, C::kBytes, a.stream>>>(a);
  return cudaGetLastError();
}

}  // namespace study
}  // namespace fa
