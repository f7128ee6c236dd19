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
// What bounds it on the H100: 6 D FLOPs a pair (Q K^T twice, P V once)
// on the tensor cores; the K reads double, far below HBM's rate at N >=
// 512, but each 64-row K / V tile serves only 64 q rows, so L2 traffic
// and the per-tile synchronisation weigh more than in B1.
//
// fp16 / bf16 (naive_sm90): the study's public tile, 64 q rows (one
// consumer warpgroup) by 64 kv columns, on the Hopper block of
// study_sm90.cuh: one producer thread streams K tiles (pass 1) and then
// K and V tiles (pass 2) through a 2-stage TMA ring with full / empty
// mbarriers; S = Q K^T and O += P V are wgmma with fp32 accumulators in
// registers, P rounded to T in registers; the row max and sum are quad
// shuffles on the accumulator fragment. Two blocks fit an SM at D <= 128.
//
// fp32: the register-blocked FFMA body of study_f32.cuh (64-key slabs;
// the tile 64 x 64, 32 x 64 at D = 256, study.cuh DefaultTile, is what
// the wrapper requires to divide Nq and Nk).

#include "study_f32.cuh"
#include "study_sm90.cuh"

namespace fa {
namespace study {

template <typename T, int D>
__global__ void __launch_bounds__(160, StudyCfg<D>::kBlocksPerSM)
    naive_sm90(const __grid_constant__ sm90::QkvMaps maps, const Args a) {
  using C = StudyCfg<D>;
  constexpr int kBC = C::kBC, kS = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  const StudySmem<D> sm(smem_raw);
  const int q0 = blockIdx.x * C::kBM;
  const int head = blockIdx.z * a.Hq + blockIdx.y;   // MHA: kv head too
  const int n_kv = a.Nk / kBC;

  if (threadIdx.x >= 128) {
    // Producer: pass 1's K tiles, then pass 2's K and V tiles.
    if (threadIdx.x == 128) {
      sm.load_q(maps, q0, head);
      for (int it = 0; it < 2 * n_kv; ++it)
        sm.load_kv(maps, it, (it % n_kv) * kBC, head, it >= n_kv);
    }
    return;
  }

  // Consumer warpgroup: 64 q rows.
  const int t = threadIdx.x;
  const sm90::Frag f(t);
  const float c = a.scale * kLog2e;
  float sc[kBC / 2];
  sm90::mbar_wait(sm.q_full, 0);

  // Pass 1: the row max of the raw scores.
  float m[2] = {kInitM, kInitM};
  for (int it = 0; it < n_kv; ++it) {
    const int s = it % kS;
    sm90::mbar_wait(&sm.full[s], (it / kS) & 1);
    sm90::wgmma_fence();
    sm90::qk<T, D, kBC>(sc, sm.q(), C::kBM, 0, sm.k(s));
    sm90::wgmma_commit();
    sm90::wgmma_wait();
    sm90::fence_regs(sc);
    sm.release(s);
#pragma unroll
    for (int i = 0; i < kBC / 2; ++i)
      m[(i >> 1) & 1] = fmaxf(m[(i >> 1) & 1], sc[i]);
  }
  float mc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) mc[r] = sm90::quad_max(m[r]) * c;

  // Pass 2: P = exp2((S - m) c), l, O += P V.
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float l[2] = {0.f, 0.f};
  for (int it = n_kv; it < 2 * n_kv; ++it) {
    const int s = it % kS;
    sm90::mbar_wait(&sm.full[s], (it / kS) & 1);
    sm90::wgmma_fence();
    sm90::qk<T, D, kBC>(sc, sm.q(), C::kBM, 0, sm.k(s));
    sm90::wgmma_commit();
    sm90::wgmma_wait();
    sm90::fence_regs(sc);
    uint32_t p[kBC / 4];
#pragma unroll
    for (int j = 0; j < kBC / 4; ++j) {
      const int r = j & 1;
      const float e0 = sm90::ex2(fmaf(sc[2 * j], c, -mc[r]));
      const float e1 = sm90::ex2(fmaf(sc[2 * j + 1], c, -mc[r]));
      l[r] += e0 + e1;
      p[j] = sm90::pack2<T>(e0, e1);
    }
    sm90::wgmma_fence();
    sm90::pv<T, D, kBC>(o, p, sm.v(s));
    sm90::wgmma_commit();
    sm90::wgmma_wait();
    sm90::fence_regs(o);
    sm90::fence_regs(p);
    sm.release(s);
  }

  T* __restrict__ og = static_cast<T*>(a.o) + ((size_t)head * a.Nq + q0) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r)
    store_frag_row<T, D>(og + (f.row + 8 * r) * D, o, f, r, 0,
                         1.f / sm90::quad_sum(l[r]));
}

template <typename T, int D>
cudaError_t naive_run(const Args& a, int br, int bc) {
  using Tile = DefaultTile<T, D>;
  if (br != Tile::kBR || bc != Tile::kBC) return cudaErrorInvalidValue;
  if (a.Nq % Tile::kBR || a.Nk % Tile::kBC) return cudaErrorInvalidValue;
  if constexpr (sizeof(T) == 4) {
    return launch_f32<kNaive, Tile::kBC, D>(a);
  } else {
    static_assert(Tile::kBR == StudyCfg<D>::kBM &&
                  Tile::kBC == StudyCfg<D>::kBC);
    return launch_sm90<T, D>(naive_sm90<T, D>, a);
  }
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
