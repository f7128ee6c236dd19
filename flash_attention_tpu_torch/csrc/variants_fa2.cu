// B10b: the FA2 in-loop-normalized study forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel flash_attention_tpu/ops/variants.py
// `_fa2_inloop_kernel` (variants.py:216, launched at :318) on the
// kernel-study path (`cli compare`'s `fa2_inloop` entry).
//
// The FA2-paper variant the reference's Triton kernel implements
// (FA2-triton.py:75-84, variants.py:252-261): the accumulator is kept
// NORMALIZED inside the loop. Per K/V tile, m_ij = max(m_i, rowmax S),
// P = exp(S - m_ij), l_ij = l_i e^{m_i - m_ij} + rowsum P, and acc =
// alpha acc + beta (P V) with alpha = l_i e^{m_i - m_ij} / l_ij and beta =
// 1 / l_ij (l_ij == 0 read as 1): one more divide a step, no final
// normalization. Causal with offset = Nk - Nq: the kv loop of a q tile
// stops after its last row's diagonal (the block skip of
// `_below_or_on_diag`), and the diagonal tiles mask col > row + offset.
// GQA maps q head h to kv head h / (Hq / Hkv). The wrapper requires the
// tile to divide Nq and Nk, as the JAX kernel does (variants.py:300-302).
//
// Tile: 64 x 64, 32 x 64 for fp32 at D = 256 (study.cuh DefaultTile).
//
// What bounds it on the H100: the same work as B1 (4 D FLOPs a visible
// pair), so the tensor cores (fp16 / bf16) or fp32 CUDA cores at these
// shapes.
//
// fp16 / bf16 (fa2_sm90): the Hopper block of study_sm90.cuh (one
// consumer warpgroup of 64 q rows, a producer warp streaming K and V
// through a 2-stage TMA ring; heaviest causal q tiles first). S = Q K^T
// and P V are wgmma with fp32 accumulators in registers, the softmax
// works on the accumulator fragment, P is rounded to T in registers.
// The normalized update is taken as acc *= l_i e^{m_i - m_ij}, then acc
// += P V (wgmma into acc), then acc *= 1 / l_ij: one more pass over the
// accumulator a step than B1, and one divide a row; it differs from the
// JAX kernel's acc * (carry / l_ij) + (P V) / l_ij in fp32 rounding only.
// Only the tiles the causal diagonal crosses are masked.
//
// fp32: the register-blocked FFMA body of study_f32.cuh (the normalized
// update as acc = (carry / l) acc + (P / l) V; heaviest causal q tiles
// first).

#include "study_f32.cuh"
#include "study_sm90.cuh"

namespace fa {
namespace study {

template <typename T, int D>
__global__ void __launch_bounds__(160, StudyCfg<D>::kBlocksPerSM)
    fa2_sm90(const __grid_constant__ sm90::QkvMaps maps, const Args a) {
  using C = StudyCfg<D>;
  constexpr int kBC = C::kBC, kS = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  const StudySmem<D> sm(smem_raw);
  // Heaviest causal q tiles first: the last q tile starts first.
  const int q0 =
      (a.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * C::kBM;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kv_end = a.causal ? min(a.Nk, q0 + C::kBM + a.offset) : a.Nk;
  const int n_kv = kv_end > 0 ? (kv_end + kBC - 1) / kBC : 0;

  if (threadIdx.x >= 128) {
    if (threadIdx.x == 128) {
      sm.load_q(maps, q0, b * a.Hq + h);
      const int kv_head = b * a.Hkv + h / (a.Hq / a.Hkv);
      for (int it = 0; it < n_kv; ++it)
        sm.load_kv(maps, it, it * kBC, kv_head, true);
    }
    return;
  }

  // Consumer warpgroup: 64 q rows.
  const int t = threadIdx.x;
  const sm90::Frag f(t);
  const int row0 = q0 + f.row;   // this thread's rows: row0, row0 + 8
  const float c = a.scale * kLog2e;
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {kInitM, kInitM};   // running max of the raw scores
  float l[2] = {0.f, 0.f};         // the row sums (whole rows)
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
    // The causal mask, only on tiles the diagonal crosses.
    if (a.causal && j0 + kBC - 1 > q0 + a.offset) {
#pragma unroll
      for (int i = 0; i < kBC / 2; ++i)
        if (j0 + f.col_of(i) > row0 + sm90::Frag::row_of(i) + a.offset)
          sc[i] = -INFINITY;
    }

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < kBC / 2; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    float mc[2], ps[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = sm90::quad_max(mx[r]);
      mc[r] = mx[r] * c;
    }
    uint32_t p[kBC / 4];
#pragma unroll
    for (int j = 0; j < kBC / 4; ++j) {
      const int r = j & 1;
      const float e0 = sm90::ex2(fmaf(sc[2 * j], c, -mc[r]));
      const float e1 = sm90::ex2(fmaf(sc[2 * j + 1], c, -mc[r]));
      ps[r] += e0 + e1;
      p[j] = sm90::pack2<T>(e0, e1);
    }
    float carry[2], inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      carry[r] = l[r] * sm90::ex2((m[r] - mx[r]) * c);
      const float l_ij = carry[r] + sm90::quad_sum(ps[r]);
      inv[r] = l_ij == 0.f ? 1.f : 1.f / l_ij;
      m[r] = mx[r];
      l[r] = l_ij;
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= carry[(i >> 1) & 1];

    sm90::wgmma_fence();
    sm90::pv<T, D, kBC>(o, p, sm.v(s));
    sm90::wgmma_commit();
    sm90::wgmma_wait();
    sm90::fence_regs(o);
    sm90::fence_regs(p);
    sm.release(s);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= inv[(i >> 1) & 1];
  }

  // Already normalized; rows < Nq (block-divisible: all of them).
  const size_t qbase = ((size_t)b * a.Hq + h) * a.Nq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row < a.Nq)
      store_frag_row<T, D>(static_cast<T*>(a.o) + (qbase + row) * D, o, f,
                           r, 0, 1.f);
  }
}

template <typename T, int D>
cudaError_t fa2_run(const Args& a, int br, int bc) {
  using Tile = DefaultTile<T, D>;
  if (br != Tile::kBR || bc != Tile::kBC) return cudaErrorInvalidValue;
  if (a.Nq % Tile::kBR || a.Nk % Tile::kBC) return cudaErrorInvalidValue;
  if constexpr (sizeof(T) == 2) {
    static_assert(Tile::kBR == StudyCfg<D>::kBM &&
                  Tile::kBC == StudyCfg<D>::kBC);
    return launch_sm90<T, D>(fa2_sm90<T, D>, a);
  } else {
    return launch_f32<kFa2, Tile::kBC, D>(a);
  }
}

template <typename T>
cudaError_t fa2_by_dim(const Args& a, int D, int br, int bc) {
  if (D == 32) return fa2_run<T, 32>(a, br, bc);
  if (D == 64) return fa2_run<T, 64>(a, br, bc);
  if (D == 128) return fa2_run<T, 128>(a, br, bc);
  if (D == 256) return fa2_run<T, 256>(a, br, bc);
  return cudaErrorInvalidValue;
}

}  // namespace study
}  // namespace fa

// q, o [B, Hq, Nq, D], k, v [B, Hkv, Nk, D] in dtype; (br, bc) the
// compiled tile; causal hides col > row + Nk - Nq.
extern "C" int fa_fa2_inloop_fwd(const void* q, const void* k,
                                 const void* v, void* o, int B, int Hq,
                                 int Hkv, int Nq, int Nk, int D, int br,
                                 int bc, int causal, float scale, int dtype,
                                 void* stream) {
  using namespace fa;
  if (Hkv <= 0 || Hq % Hkv) return (int)cudaErrorInvalidValue;
  const study::Args a{q, k, v, o, nullptr, nullptr, B, Hq, Hkv, Nq, Nk,
                      causal, Nk - Nq, scale,
                      static_cast<cudaStream_t>(stream)};
  if (dtype == kFloat32)
    return (int)study::fa2_by_dim<float>(a, D, br, bc);
  if (dtype == kBFloat16)
    return (int)study::fa2_by_dim<__nv_bfloat16>(a, D, br, bc);
  if (dtype == kFloat16)
    return (int)study::fa2_by_dim<__half>(a, D, br, bc);
  return (int)cudaErrorInvalidValue;
}
