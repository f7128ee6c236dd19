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
// shapes; the design is study.cuh's, all intermediates in shared memory.

#include "study.cuh"

namespace fa {
namespace study {

template <typename T, int D, int BR, int BC>
__global__ void __launch_bounds__(2 * BR) fa2_inloop_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  Block<T, D, BR, BC> blk(a, smem);
  blk.start(a);
  const float c = a.scale * kLog2e;
  float m_i = kInitM;   // unscaled, as S
  float l_i = 0.f;
  int kv_end = a.Nk;
  if (a.causal) {
    const int last_row = min(blk.q0 + BR, a.Nq) - 1;
    kv_end = min(a.Nk, last_row + a.offset + 1);
  }
  for (int j0 = 0; j0 < kv_end; j0 += BC) {
    blk.load_kv(a, j0, true);
    blk.scores();
    float sv[BC / 2];
    const float m_ij = fmaxf(m_i, blk.row_scores(a, j0, sv));
    const float psum = blk.row_probs(sv, m_ij, c);
    const float carry = l_i * exp2f((m_i - m_ij) * c);
    const float l_ij = carry + psum;
    const float l_safe = l_ij == 0.f ? 1.f : l_ij;
    if (blk.half == 0) {
      blk.sAlpha[blk.row] = carry / l_safe;
      blk.sBeta[blk.row] = 1.f / l_safe;
    }
    m_i = m_ij;
    l_i = l_ij;
    blk.pv(true);
  }
  blk.store(a, 1.f);   // already normalized
}

template <typename T, int D>
cudaError_t fa2_run(const Args& a, int br, int bc) {
  using Tile = DefaultTile<T, D>;
  if (br != Tile::kBR || bc != Tile::kBC) return cudaErrorInvalidValue;
  return launch<T, D, Tile::kBR, Tile::kBC>(
      fa2_inloop_kernel<T, D, Tile::kBR, Tile::kBC>, a);
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
