// B1 on fp32 inputs: the register-blocked FFMA body of the fp32 study
// kernels (study_f32.cuh: the F32Cfg plan, slab_scores, group_reduce;
// ffma_f32.cuh: the cp.async staging, the O micro-tile, work_rank) with
// B1's LSE, kv ranges and masks. Instantiated in flash_fwd_f32.cu (no
// window, no segment ids: causal, any offset, the split's two passes)
// and flash_fwd_f32_masked.cu (a window or segment ids), so the dense
// path carries no mask it does not need.
//
// Replaces, at Precision.HIGHEST (flash.py:92-101), the Pallas TPU kernel
// flash_attention_tpu/ops/flash.py `_fwd_kernel` (:259, launched at :631)
// on fp32 inputs: every product is full fp32 FFMA on the CUDA cores
// (wgmma has no fp32 operand at that precision; no TF32).
//
// What bounds it on the H100: the CUDA cores' 67 TFLOP/s over 4 D FLOPs
// a visible pair, 0.1283 ms at (1, 8, 2048, 128) causal. The first body
// ran blocks of 2 x 64 threads with S, P and O in shared memory, O
// rescaled there every step, K / V loaded between two barriers and
// scalar shared loads: 10.1 TFLOP/s. This body:
//
//  - A block is F32Cfg<D, true>: 4 warps over 64 q rows (32 at D = 256;
//    B1's fp32 tile, config.b1_tile), thread (ty, tx) of 8 x 16 owning
//    rows ty + 8 i of S, P and O and key columns 4 tx .. 4 tx + 3 of a
//    64-key slab. K / V slabs stream through two cp.async buffers (V_t
//    loads while S_t = Q K_t^T runs, K_t+1 while P_t V_t runs); Q and K
//    swizzled, S and O in registers, P through shared memory. Shared
//    bytes are F32Cfg's: 115,712 at D = 128, exactly half an SM with the
//    1 KB a block the card reserves, so not one byte is added and two
//    blocks an SM fit up to D = 128.
//  - The kv range of a q tile, in whole slabs: causal, to the last real
//    row's diagonal (any offset, also offset > Nk - Nq); a window, from
//    the first row's oldest visible column rounded down to a slab; the
//    split's bulk pass below band0 = (q0 / band) band, its band pass
//    [band0, band0 + band) (band a multiple of 64: a block never
//    straddles two bands).
//  - Element masks (-inf) only on a slab that crosses Nk, the first
//    row's diagonal or the last row's window edge, or under segment ids.
//    Segment ids: each row's q id in registers, the kv ids of a thread's
//    4 columns read from global memory (in shared memory they would
//    cost the second block an SM at D = 128).
//  - m on the raw scores, l a thread's share of the row until the end,
//    each slab's P V a partial sum from zero joined as acc = alpha acc +
//    t (one running sum over thousands of keys can miss the 3x gate
//    against fp64); O = acc / l, LSE = m scale + log l. A row that sees
//    nothing gives O = 0 and LSE = kInitM scale.
//  - Causal tiles and the bulk pass's differ in work: the heaviest run
//    first (ffma::work_rank).
//  - Every output is a fixed-order sum within one block (no atomics): a
//    rerun gives identical bits.
#pragma once

#include "flash_fwd.cuh"
#include "study_f32.cuh"

namespace fa {
namespace fwd {

// B1's fp32 plan: the study body's 64-row block (32 rows at D = 256).
template <int D>
using F32Plan = study::F32Cfg<D, true>;

template <int D, bool Masked>
__global__ void __launch_bounds__(F32Plan<D>::kThreads,
                                  F32Plan<D>::kMinBlocks)
    flash_fwd_f32_kernel(const Args a, int sms, int per_sm) {
  using C = F32Plan<D>;
  using A = typename C::Acc;
  constexpr int kMR = C::kMR, kTY = C::kTY, kSlab = C::kSlab;
  constexpr int kRows = C::kRows, kLdP = C::kLdP;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sBuf = reinterpret_cast<float*>(smem + C::kBuf);
  float* sP = reinterpret_cast<float*>(smem + C::kP);
  const int tid = threadIdx.x, ty = tid / C::kTX, tx = tid % C::kTX;
  const int Nq = a.Nq, Nk = a.Nk, causal = a.causal, offset = a.offset;
  const int window = Masked ? a.window : 0;
  const int heads = a.B * a.Hq;
  const int n_tiles = (Nq + kRows - 1) / kRows;
  const int rank = causal || a.split == kSplitBulk
                       ? ffma::work_rank(blockIdx.x, gridDim.x, sms, per_sm)
                       : blockIdx.x;
  const int q0 = (n_tiles - 1 - rank / heads) * kRows;
  const int hb = rank % heads;   // b Hq + h
  const int b = hb / a.Hq, h = hb % a.Hq;
  const size_t qbase = (size_t)hb * Nq;
  const size_t kvoff = ((size_t)b * a.Hkv + h / (a.Hq / a.Hkv)) * Nk * D;
  const float* kg = static_cast<const float*>(a.k) + kvoff;
  const float* vg = static_cast<const float*>(a.v) + kvoff;
  const float c = a.scale * kLog2e;

  // The tile's kv range [lo, hi), lo a multiple of the slab.
  const int last = min(q0 + kRows, Nq) - 1;
  int lo = 0, hi = Nk;
  if (causal) hi = min(Nk, last + offset + 1);
  if (window > 0) lo = max(q0 + offset - window + 1, 0) / kSlab * kSlab;
  if (a.split) {
    const int band0 = q0 / a.band * a.band;
    if (a.split == kSplitBulk) {
      hi = min(hi, band0);
    } else {
      lo = band0;
      hi = min(hi, band0 + a.band);
    }
  }
  const int n_kv = hi > lo ? (hi - lo + kSlab - 1) / kSlab : 0;

  // Segment ids: this thread's rows' q ids, the batch row's kv ids.
  const int* kvid = nullptr;
  int qid[kMR];
  if constexpr (Masked) {
    if (a.kvseg != nullptr) {
      kvid = a.kvseg + (size_t)b * Nk;
#pragma unroll
      for (int i = 0; i < kMR; ++i) {
        const int row = q0 + ty + kTY * i;
        qid[i] = row < Nq ? a.qseg[(size_t)b * Nq + row] : 0;
      }
    }
  }

  // The loads, each into buffer (index & 1): K_t, V_t in turn.
  auto issue = [&](int i) {
    float* dst = sBuf + (i & 1) * kSlab * D;
    const int j0 = lo + (i >> 1) * kSlab;
    if (i & 1)
      ffma::load_rows<D, kSlab, C::kThreads, typename C::VL>(dst, vg, j0,
                                                             Nk, tid);
    else
      ffma::load_rows<D, kSlab, C::kThreads, typename C::KL>(dst, kg, j0,
                                                             Nk, tid);
  };
  ffma::load_rows<D, kRows, C::kThreads, typename C::QL>(
      sQ, static_cast<const float*>(a.q) + qbase * D, q0, Nq, tid);
  if (n_kv > 0) issue(0);
  cp_async_commit();
  int next = 0;
  // The next load's buffer, once it landed and every thread left the
  // phase before (whose buffer the load after it then refills).
  auto advance = [&]() -> const float* {
    cp_async_wait<0>();
    __syncthreads();
    if (next + 1 < 2 * n_kv) issue(next + 1);
    cp_async_commit();
    return sBuf + (next++ & 1) * kSlab * D;
  };

  float acc[A::kMR][A::kW * A::kNV];
  ffma::zero<A>(acc);
  float m[kMR], l[kMR];   // m on raw scores; l this thread's columns
#pragma unroll
  for (int i = 0; i < kMR; ++i) m[i] = kInitM, l[i] = 0.f;

  for (int t = 0; t < n_kv; ++t) {
    const int j0 = lo + t * kSlab;
    float s[kMR][4];
    study::slab_scores<C, D>(s, sQ, advance(), ty, tx);
    // Hidden columns -inf, on the slabs where any column of any row of
    // the tile may be hidden.
    bool need = j0 + kSlab > Nk || (causal && j0 + kSlab - 1 > q0 + offset);
    if constexpr (Masked)
      need = need || kvid != nullptr ||
             (window > 0 && j0 <= last + offset - window);
    if (need) {
      int kid[4] = {0, 0, 0, 0};
      if constexpr (Masked) {
        if (kvid != nullptr) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int col = j0 + 4 * tx + j;
            kid[j] = col < Nk ? __ldg(kvid + col) : 0;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kMR; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = j0 + 4 * tx + j, row = q0 + ty + kTY * i;
          bool bad = col >= Nk || (causal && col > row + offset);
          if constexpr (Masked)
            bad = bad || (window > 0 && col <= row + offset - window) ||
                  (kvid != nullptr && kid[j] != qid[i]);
          if (bad) s[i][j] = -INFINITY;
        }
    }
    // Online softmax: the row max over its 16 threads; P unnormalized.
    float alpha[kMR];
#pragma unroll
    for (int i = 0; i < kMR; ++i) {
      const float mx = fmaxf(m[i], study::group_reduce<16, true>(fmaxf(
                                       fmaxf(s[i][0], s[i][1]),
                                       fmaxf(s[i][2], s[i][3]))));
      alpha[i] = exp2f((m[i] - mx) * c);
      float p[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) p[j] = exp2f(fmaf(s[i][j], c, -mx * c));
      l[i] = fmaf(alpha[i], l[i], (p[0] + p[1]) + (p[2] + p[3]));
      m[i] = mx;
      *reinterpret_cast<float4*>(sP + (ty + kTY * i) * kLdP + 4 * tx) =
          make_float4(p[0], p[1], p[2], p[3]);
    }
    // acc = alpha acc + P V (the slab's sum formed from zero).
    ffma::accumulate<A, kSlab>(acc, sP, kLdP, advance(), D, ty, tx,
                               [&](int i, float o, float pv) {
                                 return fmaf(alpha[i], o, pv);
                               });
  }
  cp_async_wait<0>();

  // O = acc / l and LSE = m scale + log l; rows < Nq.
#pragma unroll
  for (int i = 0; i < kMR; ++i) {
    const float lt = study::group_reduce<16, false>(l[i]);
    const int row = q0 + ty + kTY * i;
    if (tx == 0 && row < Nq)
      a.lse[qbase + row] =
          lt > 0.f ? m[i] * a.scale + logf(lt) : kInitM * a.scale;
    const float inv = lt > 0.f ? 1.f / lt : 0.f;
#pragma unroll
    for (int j = 0; j < A::kW * A::kNV; ++j) acc[i][j] *= inv;
  }
  ffma::store_acc<A, D>(acc, static_cast<float*>(a.o) + qbase * D, q0, Nq,
                        ty, tx);
}

template <int D, bool Masked>
cudaError_t launch_f32(const Args& a) {
  using C = F32Plan<D>;
  const auto kernel = flash_fwd_f32_kernel<D, Masked>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kBytes);
  if (err != cudaSuccess) return err;
  // Blocks an SM (work_rank's order): by shared memory and registers.
  static int per_sm = 0;
  if (per_sm == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, C::kThreads, C::kBytes);
    if (err != cudaSuccess) return err;
  }
  const int blocks = a.B * a.Hq * ((a.Nq + C::kRows - 1) / C::kRows);
  kernel<<<blocks, C::kThreads, C::kBytes, a.stream>>>(a, ffma::sm_count(),
                                                      per_sm);
  return cudaGetLastError();
}

template <bool Masked>
cudaError_t dispatch_f32_as(const Args& a, int D) {
  if (D == 128) return launch_f32<128, Masked>(a);
  if (D == 64) return launch_f32<64, Masked>(a);
  if (D == 256) return launch_f32<256, Masked>(a);
  if (D == 32) return launch_f32<32, Masked>(a);
  return cudaErrorInvalidValue;
}

// Defined in flash_fwd_f32_masked.cu: a window or segment ids.
cudaError_t dispatch_f32_masked(const Args& a, int D);

}  // namespace fwd
}  // namespace fa
