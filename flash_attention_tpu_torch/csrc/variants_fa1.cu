// B10a: the FA1-style study forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel flash_attention_tpu/ops/variants.py
// `_fa1_kernel` (variants.py:80, launched at :177) on the kernel-study
// path (`cli verify`, `cli compare`'s `fa1` entry).
//
// Non-causal MHA attention with the FA1 recurrence of the reference
// (flashAttention.cu:115-137, variants.py:101-114): for each K/V tile,
// P~ = exp(S - m~) against the TILE max m~, l~ = rowsum(P~); then m_new =
// max(m_old, m~), l_new = e^{m_old - m_new} l_old + e^{m~ - m_new} l~, and
// acc = e^{m_old - m_new} acc + e^{m~ - m_new} (P~ V). One O = acc / l at
// the end (l == 0 guarded). m and l are exported as separate fp32 [B, H,
// Nq] tensors (the reference's split-stat contract; the JAX kernel's
// lane-replicated [..., 128] layout is a TPU device and is not kept), m
// in scaled units. Ragged Nq and Nk are masked here: rows and columns past
// the end load as zeros, columns are masked to -inf, rows are not stored.
//
// Tiles: the FA1 tile law (Bc = ceil(M / 4d), Br = min(Bc, d)) chooses
// (Br, Bc) in ops/variants.py among the pairs compiled here: 16 x 16 and
// 64 x 64 at every D and dtype but fp32 64 x 64 at D = 256 (the set the
// first body's shared memory allowed, kept; fa1_compiled_tiles).
//
// What bounds it on the H100: at the study's configurations (N = 512 to
// 8192, D = 32 to 128) attention is 4 N D FLOPs per 2 D bytes of K/V a
// q tile reads, so the tensor cores (fp16 / bf16) or the CUDA cores (fp32,
// 67 TFLOP/s) bound it, not HBM. Small tiles re-read K/V once per 16-row
// q tile, so 16 x 16 is bound by shared-memory traffic instead: that is
// the reference's point, the tile law under a small on-chip budget.
//
// fp16 / bf16 at 64 x 64 (fa1_sm90): the Hopper block of study_sm90.cuh
// (one consumer warpgroup of 64 q rows, a producer warp streaming K and V
// through a 2-stage TMA ring). S = Q K^T is wgmma with the scores in
// registers; the tile max, P~ and l~ work on the accumulator fragment;
// P~ is rounded to T in registers. Because beta = e^{m~ - m_new} may
// underflow to 0, it cannot be folded into acc's scale: P~ V goes into a
// fresh wgmma accumulator (scale-d 0) and is combined with acc on the
// fragment, acc = alpha acc + beta (P~ V). At D = 256 the product runs in
// two column halves of 128 (acc 128 + fresh 64 registers a thread; the
// V tile's 64-column chunks let a descriptor start at a half).
//
// fp16 / bf16 at 16 x 16 (fa1_tile16): the mma.sync register body of
// study_sm80.cuh (one warp a 16-row q tile, eight a block, a cp.async
// ring of K / V slabs shared by the block; its note states the 16 x 16
// tile's contract). fp32 at both tiles runs the register-blocked FFMA
// body of study_f32.cuh (fp32 has no tensor-core operand at full
// precision); its 64 x 64 tile is built up to D = 128, as before
// (ops/variants.py fa1_compiled_tiles).

#include "study_f32.cuh"
#include "study_sm80.cuh"
#include "study_sm90.cuh"

namespace fa {
namespace study {

template <typename T, int D>
__global__ void __launch_bounds__(160, StudyCfg<D>::kBlocksPerSM)
    fa1_sm90(const __grid_constant__ sm90::QkvMaps maps, const Args a) {
  using C = StudyCfg<D>;
  constexpr int kBC = C::kBC, kS = C::kStages;
  constexpr int kNC = D > 128 ? 128 : D;   // columns of one P~ V product
  constexpr int kParts = D / kNC;
  using L = sm90::Sw<D>;
  extern __shared__ unsigned char smem_raw[];
  const StudySmem<D> sm(smem_raw);
  const int q0 = blockIdx.x * C::kBM;
  const int head = blockIdx.z * a.Hq + blockIdx.y;   // MHA: kv head too
  const int n_kv = (a.Nk + kBC - 1) / kBC;

  if (threadIdx.x >= 128) {
    if (threadIdx.x == 128) {
      sm.load_q(maps, q0, head);
      for (int it = 0; it < n_kv; ++it)
        sm.load_kv(maps, it, it * kBC, head, true);
    }
    return;
  }

  // Consumer warpgroup: 64 q rows.
  const int t = threadIdx.x;
  const sm90::Frag f(t);
  const float c = a.scale * kLog2e;
  float acc[kParts][kNC / 2], fresh[kNC / 2];
#pragma unroll
  for (int h = 0; h < kParts; ++h)
#pragma unroll
    for (int i = 0; i < kNC / 2; ++i) acc[h][i] = 0.f;
#pragma unroll
  for (int i = 0; i < kNC / 2; ++i) fresh[i] = 0.f;
  float m[2] = {kInitM, kInitM};   // running max of the raw scores
  float l[2] = {0.f, 0.f};         // this thread's share of the row sums
  sm90::mbar_wait(sm.q_full, 0);

  for (int it = 0; it < n_kv; ++it) {
    const int s = it % kS, j0 = it * kBC;
    sm90::mbar_wait(&sm.full[s], (it / kS) & 1);
    float sc[kBC / 2];
    sm90::wgmma_fence();
    sm90::qk<T, D, kBC>(sc, sm.q(), C::kBM, 0, sm.k(s));
    sm90::wgmma_commit();
    sm90::wgmma_wait();
    sm90::fence_regs(sc);
    if (j0 + kBC > a.Nk) {   // the ragged last tile: columns >= Nk
#pragma unroll
      for (int i = 0; i < kBC / 2; ++i)
        if (j0 + f.col_of(i) >= a.Nk) sc[i] = -INFINITY;
    }

    // The tile max m~ (finite: column j0 < Nk), P~ = exp2((S - m~) c).
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < kBC / 2; ++i)
      mt[(i >> 1) & 1] = fmaxf(mt[(i >> 1) & 1], sc[i]);
    float mc[2], lt[2] = {0.f, 0.f}, alpha[2], beta[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = sm90::quad_max(mt[r]);
      mc[r] = mt[r] * c;
    }
    uint32_t p[kBC / 4];
#pragma unroll
    for (int j = 0; j < kBC / 4; ++j) {
      const int r = j & 1;
      const float e0 = sm90::ex2(fmaf(sc[2 * j], c, -mc[r]));
      const float e1 = sm90::ex2(fmaf(sc[2 * j + 1], c, -mc[r]));
      lt[r] += e0 + e1;
      p[j] = sm90::pack2<T>(e0, e1);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], mt[r]);
      alpha[r] = sm90::ex2((m[r] - m_new) * c);
      beta[r] = sm90::ex2((mt[r] - m_new) * c);
      l[r] = alpha[r] * l[r] + beta[r] * lt[r];
      m[r] = m_new;
    }

    // acc = alpha acc + beta (P~ V), P~ V fresh for each column part.
#pragma unroll
    for (int h = 0; h < kParts; ++h) {
      sm90::wgmma_fence();
      sm90::pv<T, kNC, kBC>(
          fresh, p, sm.v(s) + h * (kNC / L::kCols) * kBC * L::kRowBytes,
          false);
      sm90::wgmma_commit();
      sm90::wgmma_wait();
      sm90::fence_regs(fresh);
#pragma unroll
      for (int i = 0; i < kNC / 2; ++i) {
        const int r = (i >> 1) & 1;
        acc[h][i] = fmaf(alpha[r], acc[h][i], beta[r] * fresh[i]);
      }
    }
    sm90::fence_regs(p);
    sm.release(s);
  }

  // O = acc / l (l == 0 read as 1), m in scaled units, l; rows < Nq.
  const size_t qbase = (size_t)head * a.Nq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + f.row + 8 * r;
    const float lr = sm90::quad_sum(l[r]);
    if (row >= a.Nq) continue;
    T* orow = static_cast<T*>(a.o) + (qbase + row) * D;
    const float inv = lr == 0.f ? 1.f : 1.f / lr;
#pragma unroll
    for (int h = 0; h < kParts; ++h)
      store_frag_row<T, kNC>(orow, acc[h], f, r, h * kNC, inv);
    if ((t & 3) == 0) {
      a.m[qbase + row] = m[r] * a.scale;
      a.l[qbase + row] = lr;
    }
  }
}

template <typename T, int D, int BR, int BC>
cudaError_t fa1_run(const Args& a) {
  if constexpr (sizeof(T) == 2 && BR == 64 && BC == 64)
    return launch_sm90<T, D>(fa1_sm90<T, D>, a);
  else if constexpr (sizeof(T) == 2 && BR == 16 && BC == 16)
    return launch_tile16<T, D>(a);
  else if constexpr (sizeof(T) == 4 && (BC == 16 || D <= 128))
    return launch_f32<kFa1, BC, D>(a);   // fp32 64 x 64: D <= 128 only
  return cudaErrorInvalidValue;
}

template <typename T, int D>
cudaError_t fa1_by_tile(const Args& a, int br, int bc) {
  if (br == 16 && bc == 16) return fa1_run<T, D, 16, 16>(a);
  if (br == 64 && bc == 64) return fa1_run<T, D, 64, 64>(a);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t fa1_by_dim(const Args& a, int D, int br, int bc) {
  if (D == 32) return fa1_by_tile<T, 32>(a, br, bc);
  if (D == 64) return fa1_by_tile<T, 64>(a, br, bc);
  if (D == 128) return fa1_by_tile<T, 128>(a, br, bc);
  if (D == 256) return fa1_by_tile<T, 256>(a, br, bc);
  return cudaErrorInvalidValue;
}

}  // namespace study
}  // namespace fa

// q, k, v, o [B, H, N, D] in dtype; m, l [B, H, Nq] fp32; (br, bc) one
// of the compiled tiles.
extern "C" int fa_fa1_fwd(const void* q, const void* k, const void* v,
                          void* o, void* m, void* l, int B, int H, int Nq,
                          int Nk, int D, int br, int bc, float scale,
                          int dtype, void* stream) {
  using namespace fa;
  const study::Args a{q, k, v, o, static_cast<float*>(m),
                      static_cast<float*>(l), B, H, H, Nq, Nk, 0, 0,
                      scale, static_cast<cudaStream_t>(stream)};
  if (dtype == kFloat32)
    return (int)study::fa1_by_dim<float>(a, D, br, bc);
  if (dtype == kBFloat16)
    return (int)study::fa1_by_dim<__nv_bfloat16>(a, D, br, bc);
  if (dtype == kFloat16)
    return (int)study::fa1_by_dim<__half>(a, D, br, bc);
  return (int)cudaErrorInvalidValue;
}
