// B2 and B3: the recompute backward of flash attention for Hopper
// (sm_90a), the backward of B1 (flash_fwd.cu).
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
// numerics, flash.py:764, :822, :831); every sum is fp32.
//
// Masking is by select: a pair that is causally hidden (col > row +
// offset), a kv column >= Nk or a q row >= Nq gets P = 0 exactly, never
// exp2 of a large negative. So a ragged q row that loads as zeros (with
// a zero LSE) contributes nothing to dK/dV, and a row that sees no key
// (the forward's dead row, LSE = INIT_M * scale) yields zero gradients
// without ever evaluating exp2 of its LSE.
//
// Determinism: the split into two kernels (rather than one fused kernel
// with fp32 atomics on dQ) makes every output the sum of a fixed
// sequence of products in one block, in a fixed order: two runs give
// identical bits, as the TPU kernels do.
//
// What bounds them on the H100: at the training shape (q [4, 16, 2048,
// 128], kv [4, 8, 2048, 128], causal) B2 does 6*D and B3 8*D FLOPs per
// visible pair against ~135 MB of traffic -- ~760 (B2) and ~1020 (B3)
// FLOPs/byte, far above the card's ~295 bf16 FLOPs/byte, so both are
// operation-bound. The design keeps every product on the tensor cores
// (WMMA 16x16x16, bf16/fp16 in, fp32 accumulate) and every intermediate
// (S, dP, P, dS and the fp32 accumulators) in shared memory, so device
// memory sees each input row once per tile pass and each gradient once.
// Causal tiles that see nothing are never loaded: B2 stops its kv loop
// at the diagonal and B3 starts its q loop at the first q tile that sees
// its kv tile (JAX's first_valid_iq, flash.py:973-975).
//
// Layout: 128 threads (4 warps) per block. Warp w owns rows 16w..16w+15
// of every per-block tile (q rows in B2, kv rows in B3), and thread pair
// (2r, 2r+1) does the elementwise work of row r, so only warp-level
// synchronisation is needed between the loads of the streamed tiles.
// The accumulators (dQ; dK and dV) live in shared memory, not in WMMA
// fragments: at D = 128 two accumulators in fragments would take 128
// registers a thread. B3's shared memory is 190,976 bytes at D = 128,
// past the 48 KB default, so the launch raises the kernel's dynamic
// limit first (the card allows 227 KB).
//
// A fast version (wgmma, TMA, a producer warp, double-buffered tiles,
// accumulators in registers) is later work; this one is simple and
// right first.

#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int kTile = 64;     // rows of every q and kv tile
constexpr int kThreads = 128;

template <typename T, int D>
struct Layout {
  static constexpr int kLdT = D + 8;        // Q/K/V/dO tile rows (T)
  static constexpr int kLdS = kTile + 4;    // S and dP tiles (float)
  static constexpr int kLdP = kTile + 8;    // P and dS tiles (T)
  static constexpr int kLdA = D + 4;        // fp32 accumulators
  static constexpr size_t kT = sizeof(T) * kTile * kLdT;
  static constexpr size_t kS = sizeof(float) * kTile * kLdS;
  static constexpr size_t kP = sizeof(T) * kTile * kLdP;
  static constexpr size_t kA = sizeof(float) * kTile * kLdA;
  static constexpr size_t kRowStats = sizeof(float) * kTile;
  // B2: Q, dO, K, V | S, dP | dS | dQ
  static constexpr size_t kDqBytes = 4 * kT + 2 * kS + kP + kA;
  // B3: K, V, Q, dO | S^T, dP^T | P^T, dS^T | dK, dV | lse, delta
  static constexpr size_t kDkvBytes =
      4 * kT + 2 * kS + 2 * kP + 2 * kA + 2 * kRowStats;
};

template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int r0,
                                          int n, int tid) {
  fa::load_rows<T, D, kTile, kThreads>(dst, Layout<T, D>::kLdT, src, r0, n,
                                       tid);
}

// C[16, 64] = A[16, D] B^T for one warp: A row-major (stride kLdT), B
// [64, D] row-major (read as a col-major D x 64 operand), C fp32 (stride
// kLdS).
template <typename T, int D>
__device__ __forceinline__ void mm_abt(float* c, const T* a, const T* b) {
  using L = Layout<T, D>;
  wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> af[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wmma::load_matrix_sync(af[kk], a + kk * 16, L::kLdT);
#pragma unroll
  for (int n = 0; n < kTile / 16; ++n) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> cf;
    wmma::fill_fragment(cf, 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> bf;
      wmma::load_matrix_sync(bf, b + (n * 16) * L::kLdT + kk * 16, L::kLdT);
      wmma::mma_sync(cf, af[kk], bf, cf);
    }
    wmma::store_matrix_sync(c + n * 16, cf, L::kLdS, wmma::mem_row_major);
  }
}

// C[16, D] += A[16, 64] B for one warp: A row-major (stride kLdP), B
// [64, D] row-major (stride kLdT), C fp32 (stride kLdA).
template <typename T, int D>
__device__ __forceinline__ void mm_ab_acc(float* c, const T* a,
                                          const T* b) {
  using L = Layout<T, D>;
  wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major>
      af[kTile / 16];
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk)
    wmma::load_matrix_sync(af[kk], a + kk * 16, L::kLdP);
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> cf;
    wmma::load_matrix_sync(cf, c + n * 16, L::kLdA, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> bf;
      wmma::load_matrix_sync(bf, b + (kk * 16) * L::kLdT + n * 16, L::kLdT);
      wmma::mma_sync(cf, af[kk], bf, cf);
    }
    wmma::store_matrix_sync(c + n * 16, cf, L::kLdA, wmma::mem_row_major);
  }
}

// Half a row (D / 2 fp32 values of an accumulator) to global memory.
template <typename T, int D>
__device__ __forceinline__ void store_half_row(T* dst, const float* src) {
#pragma unroll
  for (int d = 0; d < D / 2; d += 8) {
    float vals[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) vals[i] = src[d + i];
    *reinterpret_cast<uint4*>(dst + d) = fa::pack8<T>(vals);
  }
}

// ---------------------------------------------------------------------------
// B2: dQ. One block per (q tile, q head, batch); kv tiles stream through.
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int Hq, int Hkv, int Nq, int Nk, int causal, int offset,
                    float scale) {
  using L = Layout<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sdO = reinterpret_cast<T*>(smem + L::kT);
  T* sK = reinterpret_cast<T*>(smem + 2 * L::kT);
  T* sV = reinterpret_cast<T*>(smem + 3 * L::kT);
  float* sS = reinterpret_cast<float*>(smem + 4 * L::kT);
  float* sdP = reinterpret_cast<float*>(smem + 4 * L::kT + L::kS);
  T* sdS = reinterpret_cast<T*>(smem + 4 * L::kT + 2 * L::kS);
  float* sdQ = reinterpret_cast<float*>(smem + 4 * L::kT + 2 * L::kS + L::kP);

  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const size_t qbase = ((size_t)b * Hq + h) * Nq;
  const T* kg = k + ((size_t)b * Hkv + hk) * Nk * D;
  const T* vg = v + ((size_t)b * Hkv + hk) * Nk * D;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int row = tid >> 1;          // elementwise row of this thread pair
  const int c0 = (tid & 1) * (kTile / 2);
  const int qrow = q0 + row;

  load_tile<T, D>(sQ, q + qbase * D, q0, Nq, tid);
  load_tile<T, D>(sdO, dout + qbase * D, q0, Nq, tid);
  for (int i = tid; i < kTile * D; i += kThreads)
    sdQ[(i / D) * L::kLdA + (i % D)] = 0.f;
  const float c = scale * fa::kLog2e;
  const float lse2 = qrow < Nq ? lse[qbase + qrow] * fa::kLog2e : 0.f;
  const float dlt = qrow < Nq ? delta[qbase + qrow] : 0.f;
  __syncthreads();

  // kv columns any real row of this tile can see.
  int kv_end = Nk;
  if (causal) {
    const int last_row = min(q0 + kTile, Nq) - 1;
    kv_end = min(Nk, last_row + offset + 1);
  }

  const int w16 = warp * 16;
  for (int j0 = 0; j0 < kv_end; j0 += kTile) {
    __syncthreads();   // every warp is done with the previous K/V tile
    load_tile<T, D>(sK, kg, j0, Nk, tid);
    load_tile<T, D>(sV, vg, j0, Nk, tid);
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
      const bool ok = qrow < Nq && col < Nk &&
                      (!causal || col <= qrow + offset);
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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int Hq, int Hkv, int Nq, int Nk,
                     int causal, int offset, float scale) {
  using L = Layout<T, D>;
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

  load_tile<T, D>(sK, k + kvbase * D, j0, Nk, tid);
  load_tile<T, D>(sV, v + kvbase * D, j0, Nk, tid);
  for (int i = tid; i < kTile * D; i += kThreads) {
    const int idx = (i / D) * L::kLdA + (i % D);
    sdK[idx] = 0.f;
    sdV[idx] = 0.f;
  }
  __syncthreads();

  // The first q tile with a row that sees this kv tile: row j0 - offset
  // is the first to see column j0.
  const int nq_tiles = (Nq + kTile - 1) / kTile;
  const int iq_first = causal ? max(j0 - offset, 0) / kTile : 0;
  const float c = scale * fa::kLog2e;
  const int w16 = warp * 16;

  for (int g = 0; g < group; ++g) {
    const size_t qbase = ((size_t)b * Hq + hk * group + g) * Nq;
    for (int iq = iq_first; iq < nq_tiles; ++iq) {
      const int q0 = iq * kTile;
      __syncthreads();   // every warp is done with the previous Q/dO tile
      load_tile<T, D>(sQ, q + qbase * D, q0, Nq, tid);
      load_tile<T, D>(sdO, dout + qbase * D, q0, Nq, tid);
      if (tid < kTile) {
        const bool in = q0 + tid < Nq;
        sLse[tid] = in ? lse[qbase + q0 + tid] * fa::kLog2e : 0.f;
        sDelta[tid] = in ? delta[qbase + q0 + tid] : 0.f;
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
        const bool ok = qi < Nq && kvrow < Nk &&
                        (!causal || kvrow <= qi + offset);
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

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  int B, Hq, Hkv, Nq, Nk, causal, offset;
  float scale;
  cudaStream_t stream;
};

// Dispatch over (dtype, head dim); F is a functor templated on both.
template <template <typename, int> class F, typename... Out>
int dispatch(int dtype, int D, const Args& a, Out... out) {
  if (a.Hkv <= 0 || a.Hq % a.Hkv) return (int)cudaErrorInvalidValue;
  if (dtype == fa::kBFloat16) {
    if (D == 128) return (int)F<__nv_bfloat16, 128>::run(a, out...);
    if (D == 64) return (int)F<__nv_bfloat16, 64>::run(a, out...);
  } else if (dtype == fa::kFloat16) {
    if (D == 128) return (int)F<__half, 128>::run(a, out...);
    if (D == 64) return (int)F<__half, 64>::run(a, out...);
  }
  return (int)cudaErrorInvalidValue;
}

// The launchers: each raises the kernel's dynamic shared-memory limit
// (past the 48 KB default at D = 128) before it launches.
template <typename T, int D>
struct Dq {
  static cudaError_t run(const Args& a, void* dq) {
    constexpr size_t kBytes = Layout<T, D>::kDqBytes;
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kBytes);
    if (err != cudaSuccess) return err;
    dim3 grid((a.Nq + kTile - 1) / kTile, a.Hq, a.B);
    flash_bwd_dq_kernel<T, D><<<grid, kThreads, kBytes, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
        a.delta, static_cast<T*>(dq), a.Hq, a.Hkv, a.Nq, a.Nk, a.causal,
        a.offset, a.scale);
    return cudaGetLastError();
  }
};

template <typename T, int D>
struct Dkv {
  static cudaError_t run(const Args& a, void* dk, void* dv) {
    constexpr size_t kBytes = Layout<T, D>::kDkvBytes;
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkv_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kBytes);
    if (err != cudaSuccess) return err;
    dim3 grid((a.Nk + kTile - 1) / kTile, a.Hkv, a.B);
    flash_bwd_dkv_kernel<T, D><<<grid, kThreads, kBytes, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
        a.delta, static_cast<T*>(dk), static_cast<T*>(dv), a.Hq, a.Hkv,
        a.Nq, a.Nk, a.causal, a.offset, a.scale);
    return cudaGetLastError();
  }
};

}  // namespace

extern "C" int fa_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dq, int B, int Hq,
                               int Hkv, int Nq, int Nk, int D, int causal,
                               int offset, float scale, int dtype,
                               void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), B, Hq, Hkv, Nq, Nk, causal,
               offset, scale, static_cast<cudaStream_t>(stream)};
  return dispatch<Dq>(dtype, D, a, dq);
}

extern "C" int fa_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dk, void* dv, int B,
                                int Hq, int Hkv, int Nq, int Nk, int D,
                                int causal, int offset, float scale,
                                int dtype, void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), B, Hq, Hkv, Nq, Nk, causal,
               offset, scale, static_cast<cudaStream_t>(stream)};
  return dispatch<Dkv>(dtype, D, a, dk, dv);
}
