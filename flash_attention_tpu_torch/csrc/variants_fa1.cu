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
// 64 x 64, each where it fits shared memory at that D and dtype (all but
// fp32 64 x 64 at D = 256). The tile is a template parameter, so each
// pair is its own instantiation.
//
// What bounds it on the H100: at the study's configurations (N = 512 to
// 8192, D = 32 to 128) attention is 4 N D FLOPs per 2 D bytes of K/V a
// q tile reads, so the tensor cores (fp16 / bf16) or the CUDA cores (fp32,
// 67 TFLOP/s) bound it, not HBM. Small tiles re-read K/V once per 16-row
// q tile, so 16 x 16 is bound by shared-memory traffic instead: that is
// the reference's point, the tile law under a small on-chip budget. The
// design keeps both products on the tensor cores (fp16 / bf16) and every
// intermediate in shared memory (study.cuh).

#include "study.cuh"

namespace fa {
namespace study {

template <typename T, int D, int BR, int BC>
__global__ void __launch_bounds__(2 * BR) fa1_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  Block<T, D, BR, BC> blk(a, smem);
  blk.start(a);
  const float c = a.scale * kLog2e;
  float m_i = kInitM;   // scaled units, as the JAX kernel's m
  float l_i = 0.f;
  for (int j0 = 0; j0 < a.Nk; j0 += BC) {
    blk.load_kv(a, j0, true);
    blk.scores();
    float sv[BC / 2];
    const float mt = blk.row_scores(a, j0, sv);   // tile max, unscaled
    const float l_t = blk.row_probs(sv, mt, c);   // P~, l~
    const float mt_s = mt * a.scale;
    const float m_new = fmaxf(m_i, mt_s);
    const float alpha = exp2f((m_i - m_new) * kLog2e);
    const float beta = exp2f((mt_s - m_new) * kLog2e);
    l_i = alpha * l_i + beta * l_t;
    m_i = m_new;
    if (blk.half == 0) {
      blk.sAlpha[blk.row] = alpha;
      blk.sBeta[blk.row] = beta;
    }
    blk.pv(true);
  }
  blk.store(a, l_i == 0.f ? 1.f : 1.f / l_i);
  if (blk.half == 0 && blk.qrow < a.Nq) {
    a.m[blk.qbase + blk.qrow] = m_i;
    a.l[blk.qbase + blk.qrow] = l_i;
  }
}

template <typename T, int D, int BR, int BC>
cudaError_t fa1_run(const Args& a) {
  if constexpr (Tiles<T, D, BR, BC>::kFits)
    return launch<T, D, BR, BC>(fa1_kernel<T, D, BR, BC>, a);
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
