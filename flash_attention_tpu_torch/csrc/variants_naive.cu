// B10c: the naive two-pass study forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel flash_attention_tpu/ops/variants.py
// `_naive_kernel` (variants.py:349, launched at :428) on the
// kernel-study path (`cli compare`'s `naive_pallas` entry).
//
// Exact two-pass softmax attention, the algorithm of the reference's
// naive baseline (main.cu:136-203) without its [B, H, N, N] score spill:
// pass 1 sweeps every K tile for the row max m; pass 2 sweeps K and V
// again for P = exp(S - m), l = rowsum P and acc += P V; O = acc / l. No
// online rescaling. Every K tile is read twice ON PURPOSE: the double
// read is what the study measures, so the passes are not fused.
// Non-causal MHA; the wrapper requires the tile to divide Nq and Nk, as
// the JAX kernel does.
//
// Tile: 64 x 64, 32 x 64 for fp32 at D = 256 (study.cuh DefaultTile).
//
// What bounds it on the H100: 6 D FLOPs a pair (QK^T twice, PV once)
// on the tensor cores (fp16 / bf16) or fp32 CUDA cores at these shapes;
// the K reads double, still far below HBM's rate at N >= 512.

#include "study.cuh"

namespace fa {
namespace study {

template <typename T, int D, int BR, int BC>
__global__ void __launch_bounds__(2 * BR) naive_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  Block<T, D, BR, BC> blk(a, smem);
  blk.start(a);
  const float c = a.scale * kLog2e;
  float m_i = kInitM;   // unscaled, as S
  float sv[BC / 2];
  for (int j0 = 0; j0 < a.Nk; j0 += BC) {   // pass 1: the row max
    blk.load_kv(a, j0, false);
    blk.scores();
    m_i = fmaxf(m_i, blk.row_scores(a, j0, sv));
  }
  float l_i = 0.f;
  for (int j0 = 0; j0 < a.Nk; j0 += BC) {   // pass 2: exp, sum, P V
    blk.load_kv(a, j0, true);
    blk.scores();
    blk.row_scores(a, j0, sv);
    l_i += blk.row_probs(sv, m_i, c);
    blk.pv(false);
  }
  blk.store(a, 1.f / l_i);
}

template <typename T, int D>
cudaError_t naive_run(const Args& a, int br, int bc) {
  using Tile = DefaultTile<T, D>;
  if (br != Tile::kBR || bc != Tile::kBC) return cudaErrorInvalidValue;
  return launch<T, D, Tile::kBR, Tile::kBC>(
      naive_kernel<T, D, Tile::kBR, Tile::kBC>, a);
}

template <typename T>
cudaError_t naive_by_dim(const Args& a, int D, int br, int bc) {
  if (D == 32) return naive_run<T, 32>(a, br, bc);
  if (D == 64) return naive_run<T, 64>(a, br, bc);
  if (D == 128) return naive_run<T, 128>(a, br, bc);
  if (D == 256) return naive_run<T, 256>(a, br, bc);
  return cudaErrorInvalidValue;
}

}  // namespace study
}  // namespace fa

// q, k, v, o [B, H, N, D] in dtype; (br, bc) the compiled tile.
extern "C" int fa_naive_fwd(const void* q, const void* k, const void* v,
                            void* o, int B, int H, int Nq, int Nk, int D,
                            int br, int bc, float scale, int dtype,
                            void* stream) {
  using namespace fa;
  const study::Args a{q, k, v, o, nullptr, nullptr, B, H, H, Nq, Nk, 0, 0,
                      scale, static_cast<cudaStream_t>(stream)};
  if (dtype == kFloat32)
    return (int)study::naive_by_dim<float>(a, D, br, bc);
  if (dtype == kBFloat16)
    return (int)study::naive_by_dim<__nv_bfloat16>(a, D, br, bc);
  if (dtype == kFloat16)
    return (int)study::naive_by_dim<__half>(a, D, br, bc);
  return (int)cudaErrorInvalidValue;
}
