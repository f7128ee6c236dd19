// B2 / B3 on fp32 inputs (flash_bwd_f32.cu): the FFMA body, and the
// Args and dispatch pieces that the fp16 / bf16 Hopper body
// (flash_bwd_sm90.cuh) shares with it.
//
// B2 (dQ) replaces the Pallas TPU kernel flash_attention_tpu/ops/flash.py
// `_bwd_dq_kernel` (flash.py:716, launched at :949); B3 (dK/dV) replaces
// `_bwd_dkv_kernel` (flash.py:773, launched at :1017). The wrapper
// (ops/flash.py) computes delta = rowsum(dO * O) in fp32 before the
// launches, as the JAX package does in XLA (flash.py:879-881).
//
// Per (q row, kv col) pair both kernels recompute, from the forward's
// LSE:
//   P  = exp2(S * scale * log2e - lse * log2e),  S = Q K^T (unscaled)
//   dP = dO V^T
//   dS = P * (dP - delta) * scale
// and B2 sums dQ = dS K over the kv tiles of one q tile, B3 sums
// dV = P^T dO and dK = dS^T Q over the GQA group's q heads and the q
// tiles of one kv tile. P is rounded to the input dtype before the dV
// product and dS before the dQ and dK products (the JAX kernels'
// numerics, flash.py:764, :822, :831; a no-op in fp32); every sum is
// fp32.
//
// Masking is by select: a pair that is causally hidden (col > row +
// offset), a kv column >= Nk or a q row >= Nq gets P = 0 exactly, never
// exp2 of a large negative. So a ragged q row that loads as zeros (with
// a zero LSE) contributes nothing to dK/dV, and a row that sees no key
// (the forward's dead row, LSE = INIT_M * scale) yields zero gradients
// without ever evaluating exp2 of its LSE.
//
// Window and segment ids (the TPU kernels' _mask_block, flash.py:201-240,
// applied through _mask_block_if_needed, :748-756): the `Masked`
// instantiations also hide col <= row + offset - window (window > 0,
// causal only) and pairs whose segment ids differ (qseg [B, Nq], kvseg
// [B, Nk], both or neither), by the same select.
//
// Determinism: the split into two kernels (rather than one fused kernel
// with fp32 atomics on dQ) makes every output the sum of a fixed
// sequence of products in one block, in a fixed order: two runs give
// identical bits, as the TPU kernels do.
//
// What bounds this body on the H100: the JAX kernels compute fp32 at
// Precision.HIGHEST, and wgmma has no fp32 operand at that precision, so
// every product runs in full fp32 on the CUDA cores (common.cuh ffma_abt
// / ffma_ab warp tiles) at the card's 67 TFLOP/s: bound by operations.
// S, dP, P, dS and the accumulators live in shared memory, so device
// memory sees each input row once per tile pass and each gradient once.
// Tiles that see nothing are never loaded: B2's kv loop runs from the
// first tile inside the window of its first row (the JAX grid's
// _block_runs, flash.py:122-139) to the causal limit of its last row, and
// B3's q loop from the first q tile that sees its kv tile to the last
// one whose window still reaches it (first_valid_iq / last_window_iq,
// flash.py:973-992).
//
// Layout: 2 * kTile threads per block, kTile / 16 warps. Warp w owns rows
// 16w..16w+15 of every per-block tile (q rows in B2, kv rows in B3), and
// thread pair (2r, 2r+1) does the elementwise work of row r. kTile is 64
// rows up to D = 64 and 32 above (120,064 bytes of shared memory for B3
// at D = 128, 218,368 at D = 256; 64-row tiles would take 272,896 at
// D = 128), past the 48 KB default, so the launch raises the kernel's
// dynamic limit first.
#pragma once

#include "common.cuh"

namespace fa {
namespace bwd {

template <typename T, int D>
struct Layout {
  // q and kv tile rows: 64 up to 256 bytes of head dim a row, else 32.
  static_assert(sizeof(T) == 4, "the FFMA body is fp32 only");
  static constexpr int kTile = sizeof(T) * D > 256 ? 32 : 64;
  static constexpr int kThreads = 2 * kTile;        // a thread pair a row
  static constexpr int kPad = 16 / sizeof(T);       // keeps rows 16-byte
  static constexpr int kLdT = D + kPad;     // Q/K/V/dO tile rows (T)
  static constexpr int kLdS = kTile + 4;    // S and dP tiles (float)
  static constexpr int kLdP = kTile + kPad; // P and dS tiles (T)
  static constexpr int kLdA = D + 4;        // fp32 accumulators
  static constexpr size_t kT = sizeof(T) * kTile * kLdT;
  static constexpr size_t kS = sizeof(float) * kTile * kLdS;
  static constexpr size_t kP = sizeof(T) * kTile * kLdP;
  static constexpr size_t kA = sizeof(float) * kTile * kLdA;
  static constexpr size_t kRowStats = sizeof(float) * kTile;
  static constexpr size_t kSeg = sizeof(int) * kTile;   // Masked only
  // B2: Q, dO, K, V | S, dP | dS | dQ | (kv segment ids)
  static constexpr size_t kDqBytes = 4 * kT + 2 * kS + kP + kA;
  // B3: K, V, Q, dO | S^T, dP^T | P^T, dS^T | dK, dV | lse, delta |
  // (q segment ids)
  static constexpr size_t kDkvBytes =
      4 * kT + 2 * kS + 2 * kP + 2 * kA + 2 * kRowStats;
};

template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int r0,
                                          int n, int tid) {
  using L = Layout<T, D>;
  fa::load_rows<T, D, L::kTile, L::kThreads>(dst, L::kLdT, src, r0, n, tid);
}

// C[16, kTile] = A[16, D] B^T for one warp: A row-major (stride kLdT), B
// [kTile, D] row-major, C (stride kLdS); full fp32 FFMA.
template <typename T, int D>
__device__ __forceinline__ void mm_abt(float* c, const T* a, const T* b) {
  using L = Layout<T, D>;
  fa::ffma_abt<L::kTile, D>(c, L::kLdS, a, L::kLdT, b, L::kLdT,
                            threadIdx.x & 31);
}

// C[16, D] += A[16, kTile] B for one warp: A row-major (stride kLdP), B
// [kTile, D] row-major (stride kLdT), C (stride kLdA); full fp32 FFMA.
template <typename T, int D>
__device__ __forceinline__ void mm_ab_acc(float* c, const T* a,
                                          const T* b) {
  using L = Layout<T, D>;
  fa::ffma_ab<D, L::kTile>(c, L::kLdA, a, L::kLdP, b, L::kLdT, nullptr,
                           nullptr, threadIdx.x & 31);
}

// Half a row (D / 2 fp32 values of an accumulator) to global memory.
template <typename T, int D>
__device__ __forceinline__ void store_half_row(T* dst, const float* src) {
  fa::store_scaled<T, D / 2>(dst, src, 1.f);
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  const int* qseg;          // [B, Nq] or null
  const int* kvseg;         // [B, Nk] or null
  int B, Hq, Hkv, Nq, Nk, causal, offset, window;
  float scale;
  cudaStream_t stream;
};

// ---------------------------------------------------------------------------
// B2: dQ. One block per (q tile, q head, batch); kv tiles stream through.
// ---------------------------------------------------------------------------

template <typename T, int D, bool Masked>
__global__ void __launch_bounds__(Layout<T, D>::kThreads)
flash_bwd_dq_kernel(const Args a, T* __restrict__ dq) {
  using L = Layout<T, D>;
  constexpr int kTile = L::kTile, kThreads = L::kThreads;
  const T* __restrict__ q = static_cast<const T*>(a.q);
  const T* __restrict__ dout = static_cast<const T*>(a.dout);
  const float* __restrict__ lse = a.lse;
  const float* __restrict__ delta = a.delta;
  const int Hq = a.Hq, Hkv = a.Hkv, Nq = a.Nq, Nk = a.Nk;
  const int causal = a.causal, offset = a.offset;
  const int window = Masked ? a.window : 0;
  const int* __restrict__ kvseg = Masked ? a.kvseg : nullptr;
  const float scale = a.scale;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sdO = reinterpret_cast<T*>(smem + L::kT);
  T* sK = reinterpret_cast<T*>(smem + 2 * L::kT);
  T* sV = reinterpret_cast<T*>(smem + 3 * L::kT);
  float* sS = reinterpret_cast<float*>(smem + 4 * L::kT);
  float* sdP = reinterpret_cast<float*>(smem + 4 * L::kT + L::kS);
  T* sdS = reinterpret_cast<T*>(smem + 4 * L::kT + 2 * L::kS);
  float* sdQ = reinterpret_cast<float*>(smem + 4 * L::kT + 2 * L::kS + L::kP);
  int* sKseg = reinterpret_cast<int*>(smem + L::kDqBytes);

  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const size_t qbase = ((size_t)b * Hq + h) * Nq;
  const T* kg = static_cast<const T*>(a.k) + ((size_t)b * Hkv + hk) * Nk * D;
  const T* vg = static_cast<const T*>(a.v) + ((size_t)b * Hkv + hk) * Nk * D;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int row = tid >> 1;          // elementwise row of this thread pair
  const int c0 = (tid & 1) * (kTile / 2);
  const int qrow = q0 + row;
  const int my_seg =
      (kvseg != nullptr && qrow < Nq) ? a.qseg[(size_t)b * Nq + qrow] : 0;

  load_tile<T, D>(sQ, q + qbase * D, q0, Nq, tid);
  load_tile<T, D>(sdO, dout + qbase * D, q0, Nq, tid);
  for (int i = tid; i < kTile * D; i += kThreads)
    sdQ[(i / D) * L::kLdA + (i % D)] = 0.f;
  const float c = scale * fa::kLog2e;
  const float lse2 = qrow < Nq ? lse[qbase + qrow] * fa::kLog2e : 0.f;
  const float dlt = qrow < Nq ? delta[qbase + qrow] : 0.f;
  __syncthreads();

  // kv columns any real row of this tile can see: from the oldest column
  // inside the first row's window (rounded down to a tile) to the last
  // row's causal limit.
  int kv_begin = 0, kv_end = Nk;
  if (causal) {
    const int last_row = min(q0 + kTile, Nq) - 1;
    kv_end = min(Nk, last_row + offset + 1);
  }
  if (Masked && window > 0)
    kv_begin = max(q0 + offset - window + 1, 0) / kTile * kTile;

  const int w16 = warp * 16;
  for (int j0 = kv_begin; j0 < kv_end; j0 += kTile) {
    __syncthreads();   // every warp is done with the previous K/V tile
    load_tile<T, D>(sK, kg, j0, Nk, tid);
    load_tile<T, D>(sV, vg, j0, Nk, tid);
    if (Masked && kvseg != nullptr)
      for (int i = tid; i < kTile; i += kThreads)
        sKseg[i] = j0 + i < Nk ? kvseg[(size_t)b * Nk + j0 + i] : 0;
    __syncthreads();

    mm_abt<T, D>(sS + w16 * L::kLdS, sQ + w16 * L::kLdT, sK);    // S
    mm_abt<T, D>(sdP + w16 * L::kLdS, sdO + w16 * L::kLdT, sV);  // dP
    __syncwarp();

    const float* srow = sS + row * L::kLdS;
    const float* dprow = sdP + row * L::kLdS;
    T* dsrow = sdS + row * L::kLdP;
#pragma unroll 8
    for (int jj = c0; jj < c0 + kTile / 2; ++jj) {
      const int col = j0 + jj;
      bool ok = qrow < Nq && col < Nk && (!causal || col <= qrow + offset);
      if constexpr (Masked)
        ok = ok && (window <= 0 || col > qrow + offset - window) &&
             (kvseg == nullptr || sKseg[jj] == my_seg);
      const float p = ok ? exp2f(srow[jj] * c - lse2) : 0.f;
      dsrow[jj] = fa::from_float<T>(p * (dprow[jj] - dlt) * scale);
    }
    __syncwarp();

    mm_ab_acc<T, D>(sdQ + w16 * L::kLdA, sdS + w16 * L::kLdP, sK);  // dQ
    __syncwarp();
  }

  if (qrow < Nq) {
    const int half = (tid & 1) * (D / 2);
    store_half_row<T, D>(dq + (qbase + qrow) * D + half,
                         sdQ + row * L::kLdA + half);
  }
}

// ---------------------------------------------------------------------------
// B3: dK and dV. One block per (kv tile, kv head, batch); the q tiles of
// every q head of the GQA group stream through.
// ---------------------------------------------------------------------------

template <typename T, int D, bool Masked>
__global__ void __launch_bounds__(Layout<T, D>::kThreads)
flash_bwd_dkv_kernel(const Args a, T* __restrict__ dk, T* __restrict__ dv) {
  using L = Layout<T, D>;
  constexpr int kTile = L::kTile, kThreads = L::kThreads;
  const T* __restrict__ q = static_cast<const T*>(a.q);
  const T* __restrict__ dout = static_cast<const T*>(a.dout);
  const float* __restrict__ lse = a.lse;
  const float* __restrict__ delta = a.delta;
  const int Hq = a.Hq, Hkv = a.Hkv, Nq = a.Nq, Nk = a.Nk;
  const int causal = a.causal, offset = a.offset;
  const int window = Masked ? a.window : 0;
  const int* __restrict__ qseg = Masked ? a.qseg : nullptr;
  const float scale = a.scale;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = reinterpret_cast<T*>(smem + L::kT);
  T* sQ = reinterpret_cast<T*>(smem + 2 * L::kT);
  T* sdO = reinterpret_cast<T*>(smem + 3 * L::kT);
  unsigned char* rest = smem + 4 * L::kT;
  float* sS = reinterpret_cast<float*>(rest);                  // S^T
  float* sdP = reinterpret_cast<float*>(rest + L::kS);         // dP^T
  T* sPt = reinterpret_cast<T*>(rest + 2 * L::kS);
  T* sdSt = reinterpret_cast<T*>(rest + 2 * L::kS + L::kP);
  float* sdK = reinterpret_cast<float*>(rest + 2 * L::kS + 2 * L::kP);
  float* sdV = reinterpret_cast<float*>(rest + 2 * L::kS + 2 * L::kP + L::kA);
  float* sLse = reinterpret_cast<float*>(rest + 2 * L::kS + 2 * L::kP +
                                         2 * L::kA);
  float* sDelta = sLse + kTile;
  int* sQseg = reinterpret_cast<int*>(smem + L::kDkvBytes);

  const int j0 = blockIdx.x * kTile;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int group = Hq / Hkv;
  const size_t kvbase = ((size_t)b * Hkv + hk) * Nk;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int row = tid >> 1;          // elementwise kv row of this pair
  const int c0 = (tid & 1) * (kTile / 2);
  const int kvrow = j0 + row;
  const int my_seg =
      (qseg != nullptr && kvrow < Nk) ? a.kvseg[(size_t)b * Nk + kvrow] : 0;

  load_tile<T, D>(sK, static_cast<const T*>(a.k) + kvbase * D, j0, Nk, tid);
  load_tile<T, D>(sV, static_cast<const T*>(a.v) + kvbase * D, j0, Nk, tid);
  for (int i = tid; i < kTile * D; i += kThreads) {
    const int idx = (i / D) * L::kLdA + (i % D);
    sdK[idx] = 0.f;
    sdV[idx] = 0.f;
  }
  __syncthreads();

  // The q tiles with a row that sees this kv tile: row j0 - offset is the
  // first to see column j0; under a window, row last - offset + window -
  // 1 is the last to see column last.
  const int nq_tiles = (Nq + kTile - 1) / kTile;
  const int iq_first = causal ? max(j0 - offset, 0) / kTile : 0;
  int iq_end = nq_tiles;
  if (Masked && window > 0) {
    const int last_q = min(j0 + kTile, Nk) - 1 - offset + window - 1;
    iq_end = last_q < 0 ? 0 : min(nq_tiles, last_q / kTile + 1);
  }
  const float c = scale * fa::kLog2e;
  const int w16 = warp * 16;

  for (int g = 0; g < group; ++g) {
    const size_t qbase = ((size_t)b * Hq + hk * group + g) * Nq;
    for (int iq = iq_first; iq < iq_end; ++iq) {
      const int q0 = iq * kTile;
      __syncthreads();   // every warp is done with the previous Q/dO tile
      load_tile<T, D>(sQ, q + qbase * D, q0, Nq, tid);
      load_tile<T, D>(sdO, dout + qbase * D, q0, Nq, tid);
      if (tid < kTile) {
        const bool in = q0 + tid < Nq;
        sLse[tid] = in ? lse[qbase + q0 + tid] * fa::kLog2e : 0.f;
        sDelta[tid] = in ? delta[qbase + q0 + tid] : 0.f;
        if (Masked && qseg != nullptr)
          sQseg[tid] = in ? qseg[(size_t)b * Nq + q0 + tid] : 0;
      }
      __syncthreads();

      mm_abt<T, D>(sS + w16 * L::kLdS, sK + w16 * L::kLdT, sQ);    // S^T
      mm_abt<T, D>(sdP + w16 * L::kLdS, sV + w16 * L::kLdT, sdO);  // dP^T
      __syncwarp();

      const float* srow = sS + row * L::kLdS;
      const float* dprow = sdP + row * L::kLdS;
      T* prow = sPt + row * L::kLdP;
      T* dsrow = sdSt + row * L::kLdP;
#pragma unroll 8
      for (int ii = c0; ii < c0 + kTile / 2; ++ii) {
        const int qi = q0 + ii;
        bool ok = qi < Nq && kvrow < Nk && (!causal || kvrow <= qi + offset);
        if constexpr (Masked)
          ok = ok && (window <= 0 || kvrow > qi + offset - window) &&
               (qseg == nullptr || sQseg[ii] == my_seg);
        const float p = ok ? exp2f(srow[ii] * c - sLse[ii]) : 0.f;
        prow[ii] = fa::from_float<T>(p);
        dsrow[ii] = fa::from_float<T>(p * (dprow[ii] - sDelta[ii]) * scale);
      }
      __syncwarp();

      mm_ab_acc<T, D>(sdV + w16 * L::kLdA, sPt + w16 * L::kLdP, sdO);  // dV
      mm_ab_acc<T, D>(sdK + w16 * L::kLdA, sdSt + w16 * L::kLdP, sQ);  // dK
      __syncwarp();
    }
  }

  if (kvrow < Nk) {
    const int half = (tid & 1) * (D / 2);
    store_half_row<T, D>(dk + (kvbase + kvrow) * D + half,
                         sdK + row * L::kLdA + half);
    store_half_row<T, D>(dv + (kvbase + kvrow) * D + half,
                         sdV + row * L::kLdA + half);
  }
}

// The launchers: each raises the kernel's dynamic shared-memory limit
// (past the 48 KB default from D = 64) before it launches.
template <typename T, int D, bool Masked>
struct DqFfma {
  static cudaError_t run(const Args& a, void* dq) {
    using L = Layout<T, D>;
    constexpr size_t kBytes = L::kDqBytes + (Masked ? L::kSeg : 0);
    static_assert(kBytes <= 232448, "B2 tiles exceed shared memory");
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_kernel<T, D, Masked>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kBytes);
    if (err != cudaSuccess) return err;
    dim3 grid((a.Nq + L::kTile - 1) / L::kTile, a.Hq, a.B);
    flash_bwd_dq_kernel<T, D, Masked><<<grid, L::kThreads, kBytes,
                                        a.stream>>>(a, static_cast<T*>(dq));
    return cudaGetLastError();
  }
};

template <typename T, int D, bool Masked>
struct DkvFfma {
  static cudaError_t run(const Args& a, void* dk, void* dv) {
    using L = Layout<T, D>;
    constexpr size_t kBytes = L::kDkvBytes + (Masked ? L::kSeg : 0);
    static_assert(kBytes <= 232448, "B3 tiles exceed shared memory");
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkv_kernel<T, D, Masked>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kBytes);
    if (err != cudaSuccess) return err;
    dim3 grid((a.Nk + L::kTile - 1) / L::kTile, a.Hkv, a.B);
    flash_bwd_dkv_kernel<T, D, Masked><<<grid, L::kThreads, kBytes,
                                         a.stream>>>(
        a, static_cast<T*>(dk), static_cast<T*>(dv));
    return cudaGetLastError();
  }
};

// Dispatch over the head dim for one compute type T; F is a launcher
// templated on T, the head dim and the mask flag (DqFfma / DkvFfma here,
// Dq / Dkv of flash_bwd_sm90.cuh).
template <template <typename, int, bool> class F, bool Masked, typename T,
          typename... Out>
cudaError_t dispatch_d(int D, const Args& a, Out... out) {
  if (D == 128) return F<T, 128, Masked>::run(a, out...);
  if (D == 64) return F<T, 64, Masked>::run(a, out...);
  if (D == 256) return F<T, 256, Masked>::run(a, out...);
  if (D == 32) return F<T, 32, Masked>::run(a, out...);
  return cudaErrorInvalidValue;
}

// Defined in flash_bwd_masked.cu.
cudaError_t dispatch_dq_masked(int dtype, int D, const Args& a, void* dq);
cudaError_t dispatch_dkv_masked(int dtype, int D, const Args& a, void* dk,
                                void* dv);
// Defined in flash_bwd_f32.cu: fp32 inputs, masked or not.
cudaError_t dispatch_dq_f32(int D, bool masked, const Args& a, void* dq);
cudaError_t dispatch_dkv_f32(int D, bool masked, const Args& a, void* dk,
                             void* dv);

}  // namespace bwd
}  // namespace fa
