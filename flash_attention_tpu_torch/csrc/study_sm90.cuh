// The Hopper block of the fp16 / bf16 study forwards B10a
// (variants_fa1.cu), B10b (variants_fa2.cu) and B10c (variants_naive.cu),
// on the pieces of sm90_attn.cuh:
//
// - a block is one consumer warpgroup of 64 q rows (threads 0-127) and
//   one producer warp (thread 128 issues every TMA load): 160 threads,
//   two blocks an SM up to D = 128, one at D = 256, where the tiles take
//   160 KB;
// - Q [64, D] is loaded once; K (and V) tiles [64, D] stream through a
//   2-stage ring with full / empty mbarriers;
// - the 3-D tensor maps [heads, rows, D] read zeros past a head's end,
//   so ragged Nq and Nk need only a column mask on the last kv tile and
//   no store of rows >= Nq.
#pragma once

#include "sm90_attn.cuh"
#include "study.cuh"

namespace fa {
namespace study {

template <int D>
struct StudyCfg {
  static constexpr int kBM = 64, kBC = 64, kStages = 2, kThreads = 160;
  static constexpr int kBlocksPerSM = D > 128 ? 1 : 2;
  static constexpr uint32_t kTileBytes = 64 * D * 2;
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kK = kTileBytes;
  static constexpr uint32_t kV = kK + kStages * kTileBytes;
  static constexpr uint32_t kBars = kV + kStages * kTileBytes;
  // q_full, full[kStages], empty[kStages]
  static constexpr uint32_t kBytes = kBars + 8 * (1 + 2 * kStages) + 1024;
};

// The block's shared memory and barriers; initialised by thread 0, then
// every thread of the block synchronises.
template <int D>
struct StudySmem {
  using C = StudyCfg<D>;
  unsigned char* base;
  uint64_t *q_full, *full, *empty;

  __device__ __forceinline__ explicit StudySmem(unsigned char* raw) {
    base = sm90::align_smem(raw);
    q_full = reinterpret_cast<uint64_t*>(base + C::kBars);
    full = q_full + 1;
    empty = full + C::kStages;
    if (threadIdx.x == 0) {
      sm90::mbar_init(q_full, 1);
      for (int s = 0; s < C::kStages; ++s) {
        sm90::mbar_init(&full[s], 1);
        sm90::mbar_init(&empty[s], 4);   // one per consumer warp
      }
      sm90::fence_barrier_init();
    }
    __syncthreads();
  }

  __device__ __forceinline__ uint32_t q() const {
    return sm90::smem_u32(base + C::kQ);
  }
  __device__ __forceinline__ uint32_t k(int s) const {
    return sm90::smem_u32(base + C::kK + s * C::kTileBytes);
  }
  __device__ __forceinline__ uint32_t v(int s) const {
    return sm90::smem_u32(base + C::kV + s * C::kTileBytes);
  }

  // Producer thread: the Q tile at row q0 of head q_head.
  __device__ __forceinline__ void load_q(const sm90::QkvMaps& maps, int q0,
                                         int q_head) const {
    sm90::mbar_expect_tx(q_full, C::kTileBytes);
    sm90::load_tile<D>(base + C::kQ, &maps.q, q_full, C::kBM, q0, q_head);
  }

  // Producer thread: load number `it` of the ring, the K (and V) tile of
  // rows [j0, j0 + 64) of kv_head into stage it % kStages, once its
  // consumers have released that stage.
  __device__ __forceinline__ void load_kv(const sm90::QkvMaps& maps, int it,
                                          int j0, int kv_head,
                                          bool with_v) const {
    const int s = it % C::kStages;
    sm90::mbar_wait(&empty[s], ((it / C::kStages) & 1) ^ 1);
    sm90::mbar_expect_tx(&full[s], (with_v ? 2 : 1) * C::kTileBytes);
    sm90::load_tile<D>(base + C::kK + s * C::kTileBytes, &maps.k, &full[s],
                       C::kBC, j0, kv_head);
    if (with_v)
      sm90::load_tile<D>(base + C::kV + s * C::kTileBytes, &maps.v,
                         &full[s], C::kBC, j0, kv_head);
  }

  // Consumer warp: stage s is read (lane 0 arrives for its warp).
  __device__ __forceinline__ void release(int s) const {
    __syncwarp();
    if (threadIdx.x % 32 == 0) sm90::mbar_arrive(&empty[s]);
  }
};

// Row r (0: the thread's first row, 1: that + 8) of an m64nN fragment
// times `mul`, rounded to T, into `orow` (the row's [D] output), columns
// from c0.
template <typename T, int N>
__device__ __forceinline__ void store_frag_row(T* orow, const float (&o)[N / 2],
                                               const sm90::Frag& f, int r,
                                               int c0, float mul) {
#pragma unroll
  for (int jb = 0; jb < N / 8; ++jb) {
    const int i = 4 * jb + 2 * r;
    *reinterpret_cast<uint32_t*>(orow + c0 + f.col_of(4 * jb)) =
        sm90::pack2<T>(o[i] * mul, o[i + 1] * mul);
  }
}

// Launches `kernel` on a grid of (ceil(Nq / 64), Hq, B) with maps over Q
// [B * Hq, Nq, D] and K, V [B * Hkv, Nk, D].
template <typename T, int D, typename Kernel>
cudaError_t launch_sm90(Kernel kernel, const Args& a) {
  using C = StudyCfg<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kBytes);
  if (err != cudaSuccess) return err;
  sm90::QkvMaps maps{};
  if (!sm90::encode_tile_map<T, D>(&maps.q, a.q, a.B * a.Hq, a.Nq, C::kBM) ||
      !sm90::encode_tile_map<T, D>(&maps.k, a.k, a.B * a.Hkv, a.Nk, C::kBC) ||
      !sm90::encode_tile_map<T, D>(&maps.v, a.v, a.B * a.Hkv, a.Nk, C::kBC))
    return cudaErrorInvalidValue;
  dim3 grid((a.Nq + C::kBM - 1) / C::kBM, a.Hq, a.B);
  kernel<<<grid, C::kThreads, C::kBytes, a.stream>>>(maps, a);
  return cudaGetLastError();
}

}  // namespace study
}  // namespace fa
