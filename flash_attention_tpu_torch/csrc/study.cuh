// The first body of the kernel-study variants, which now runs their fp32
// instantiations only: B10a at 16 x 16 and 64 x 64, B10b and B10c
// (variants_fa1.cu, variants_fa2.cu, variants_naive.cu). fp16 / bf16 run
// elsewhere: B10a's 16 x 16 tile on study_sm80.cuh's mma.sync body, the
// 64 x 64 tiles of B10a-c on the Hopper block of study_sm90.cuh. It holds
// the shared-memory layout of a (BR x BC)-tiled attention block, the tile
// loads and the two tile products on the CUDA cores in full fp32
// (common.cuh ffma_abt / ffma_ab; the JAX kernels ask the MXU for
// Precision.HIGHEST), and the Args every study kernel takes.
//
// Layout: one block of 2 * BR threads (BR / 16 warps) per (q tile of BR
// rows, q head, batch). Warp w owns S / P / O rows 16w..16w+15; thread
// pair (2r, 2r+1) owns the softmax statistics of row r, each thread half
// of the row's BC columns. K / V tiles of BC rows stream through shared
// memory; S, P and the fp32 accumulator O stay there, so only warp-level
// synchronisation is needed between the loads.
//
// What bounds it on the H100: the CUDA cores' 67 TFLOP/s in principle;
// in practice the round trips of S, P and O through shared memory and
// loads that never overlap a product (PERF.md has its times).
#pragma once

#include "common.cuh"

namespace fa {
namespace study {

// The byte offsets of a (BR x BC) block's tiles. ops/variants.py
// `_smem_bytes` mirrors kBytes to know which tiles are compiled.
template <typename T, int D, int BR, int BC>
struct Tiles {
  static constexpr int kThreads = 2 * BR;       // a thread pair a row
  static constexpr int kPad = 16 / sizeof(T);   // 16-byte aligned rows
  static constexpr int kLdT = D + kPad;         // Q, K, V rows (T)
  static constexpr int kLdS = BC + 4;           // S rows (float)
  static constexpr int kLdP = BC + kPad;        // P rows (T)
  static constexpr int kLdO = D + 4;            // O rows (float)
  static constexpr size_t kQ = 0;
  static constexpr size_t kK = kQ + sizeof(T) * BR * kLdT;
  static constexpr size_t kV = kK + sizeof(T) * BC * kLdT;
  static constexpr size_t kS = kV + sizeof(T) * BC * kLdT;
  static constexpr size_t kP = kS + sizeof(float) * BR * kLdS;
  static constexpr size_t kO = kP + sizeof(T) * BR * kLdP;
  static constexpr size_t kAlpha = kO + sizeof(float) * BR * kLdO;
  static constexpr size_t kBeta = kAlpha + sizeof(float) * BR;
  static constexpr size_t kBytes = kBeta + sizeof(float) * BR;
  static constexpr bool kFits = kBytes <= 232448;   // 227 KB a block
};

// The one tile B10b and B10c are built for: 64 x 64, or 32 x 64 where
// 64 rows do not fit (fp32 at D = 256), as B1 does.
template <typename T, int D>
struct DefaultTile {
  static constexpr int kBR = Tiles<T, D, 64, 64>::kFits ? 64 : 32;
  static constexpr int kBC = 64;
};

struct Args {
  const void* q;     // [B, Hq, Nq, D]
  const void* k;     // [B, Hkv, Nk, D]
  const void* v;
  void* o;           // [B, Hq, Nq, D]
  float* m;          // [B, Hq, Nq] (B10a only)
  float* l;
  int B, Hq, Hkv, Nq, Nk, causal, offset;
  float scale;
  cudaStream_t stream;
};

// Pointers and indices of one block (blockIdx: q tile, q head, batch).
template <typename T, int D, int BR, int BC>
struct Block {
  using L = Tiles<T, D, BR, BC>;
  T *sQ, *sK, *sV, *sP;
  float *sS, *sO, *sAlpha, *sBeta;
  const T *kg, *vg;
  size_t qbase;          // row index of (b, h, 0) in q / o / m / l
  int q0, tid, warp, row, half, qrow;

  __device__ __forceinline__ Block(const Args& a, unsigned char* smem) {
    sQ = reinterpret_cast<T*>(smem + L::kQ);
    sK = reinterpret_cast<T*>(smem + L::kK);
    sV = reinterpret_cast<T*>(smem + L::kV);
    sS = reinterpret_cast<float*>(smem + L::kS);
    sP = reinterpret_cast<T*>(smem + L::kP);
    sO = reinterpret_cast<float*>(smem + L::kO);
    sAlpha = reinterpret_cast<float*>(smem + L::kAlpha);
    sBeta = reinterpret_cast<float*>(smem + L::kBeta);
    q0 = blockIdx.x * BR;
    const int h = blockIdx.y, b = blockIdx.z;
    const size_t kv_head = (size_t)b * a.Hkv + h / (a.Hq / a.Hkv);
    qbase = ((size_t)b * a.Hq + h) * a.Nq;
    kg = static_cast<const T*>(a.k) + kv_head * a.Nk * D;
    vg = static_cast<const T*>(a.v) + kv_head * a.Nk * D;
    tid = threadIdx.x;
    warp = tid / 32;
    row = tid >> 1;
    half = tid & 1;
    qrow = q0 + row;
  }

  // Q tile into shared memory, O zeroed.
  __device__ __forceinline__ void start(const Args& a) {
    fa::load_rows<T, D, BR, L::kThreads>(
        sQ, L::kLdT, static_cast<const T*>(a.q) + qbase * D, q0, a.Nq, tid);
    for (int i = tid; i < BR * D; i += L::kThreads)
      sO[(i / D) * L::kLdO + (i % D)] = 0.f;
  }

  // K (and V) rows [j0, j0 + BC) into shared memory; rows past Nk zero.
  __device__ __forceinline__ void load_kv(const Args& a, int j0, bool with_v) {
    __syncthreads();   // every warp is done with the previous tiles
    fa::load_rows<T, D, BC, L::kThreads>(sK, L::kLdT, kg, j0, a.Nk, tid);
    if (with_v)
      fa::load_rows<T, D, BC, L::kThreads>(sV, L::kLdT, vg, j0, a.Nk, tid);
    __syncthreads();
  }

  // S = Q K^T (unscaled) for this warp's 16 rows (fp32 FFMA).
  __device__ __forceinline__ void scores() {
    static_assert(sizeof(T) == 4, "study.cuh is the fp32 body");
    fa::ffma_abt<BC, D>(sS + (warp * 16) * L::kLdS, L::kLdS,
                        sQ + (warp * 16) * L::kLdT, L::kLdT, sK, L::kLdT,
                        tid & 31);
    __syncwarp();
  }

  // This thread's half of row `row` of S: masked columns (col >= Nk, or
  // col > qrow + offset under causal) are -inf. Returns the half-row max
  // combined across the pair.
  __device__ __forceinline__ float row_scores(const Args& a, int j0,
                                              float* sv) const {
    const float* srow = sS + row * L::kLdS + half * (BC / 2);
    float mx = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < BC / 2; ++jj) {
      const int col = j0 + half * (BC / 2) + jj;
      const bool ok =
          col < a.Nk && (!a.causal || col <= qrow + a.offset);
      sv[jj] = ok ? srow[jj] : -INFINITY;
      mx = fmaxf(mx, sv[jj]);
    }
    return fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  }

  // P = exp2((s - pivot) * c) rounded to T into this thread's half of
  // row `row` of the P tile. Returns the row sum (across the pair) of
  // the fp32 values.
  __device__ __forceinline__ float row_probs(const float* sv, float pivot,
                                             float c) {
    T* prow = sP + row * L::kLdP + half * (BC / 2);
    float psum = 0.f;
#pragma unroll
    for (int jj = 0; jj < BC / 2; ++jj) {
      const float p = exp2f((sv[jj] - pivot) * c);
      psum += p;
      prow[jj] = fa::from_float<T>(p);
    }
    return psum + __shfl_xor_sync(0xffffffffu, psum, 1);
  }

  // O = alpha_r O + beta_r (P V) for this warp's 16 rows, with the
  // per-row factors in sAlpha / sBeta when `combine`, else O += P V.
  __device__ __forceinline__ void pv(bool combine) {
    __syncwarp();      // P and the row factors are written
    fa::ffma_ab<D, BC>(sO + (warp * 16) * L::kLdO, L::kLdO,
                       sP + (warp * 16) * L::kLdP, L::kLdP, sV, L::kLdT,
                       combine ? sAlpha + warp * 16 : nullptr,
                       combine ? sBeta + warp * 16 : nullptr, tid & 31);
    __syncwarp();
  }

  // Row `row` of O times `mul` to global memory (rows past Nq skipped).
  __device__ __forceinline__ void store(const Args& a, float mul) const {
    if (qrow >= a.Nq) return;
    T* og = static_cast<T*>(a.o) + (qbase + qrow) * D + half * (D / 2);
    fa::store_scaled<T, D / 2>(og, sO + row * L::kLdO + half * (D / 2),
                               mul);
  }
};

// Launches `kernel`, an instantiation for (T, D, BR, BC), on a grid of
// (q tiles, q heads, batch).
template <typename T, int D, int BR, int BC>
cudaError_t launch(void (*kernel)(Args), const Args& a) {
  using L = Tiles<T, D, BR, BC>;
  static_assert(L::kFits, "study tiles exceed shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(kernel),
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kBytes);
  if (err != cudaSuccess) return err;
  dim3 grid((a.Nq + BR - 1) / BR, a.Hq, a.B);
  kernel<<<grid, L::kThreads, L::kBytes, a.stream>>>(a);
  return cudaGetLastError();
}

}  // namespace study
}  // namespace fa
