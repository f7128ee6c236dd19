// B1: flash attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel flash_attention_tpu/ops/flash.py
// `_fwd_kernel` (flash.py:259, launched at :631) on the port's serving
// path (prefill, one launch per layer; chunked prefill, two per layer)
// and training forward.
//
// Computes O = softmax(scale * Q K^T) V per (batch, q-head) with an
// online softmax, and exports LSE [B, Hq, Nq] in fp32. GQA maps q head h
// to kv head h / (Hq / Hkv). The masks of the TPU kernel's _mask_block
// (flash.py:201-236) combine: causal hides col > row + offset, a sliding
// window (window > 0, causal only) hides col <= row + offset - window,
// segment ids (qseg [B, Nq], kvseg [B, Nk], both or neither) hide pairs
// whose ids differ. offset may exceed Nk - Nq (the rolling-buffer
// prefill passes offset = Nk). A row that sees nothing exports O = 0
// and LSE = INIT_M * scale, which every LSE merge weights 0.
// Ragged Nq and Nk are masked here: tile rows past the end load as zeros
// and are never stored, so the host pads nothing.
//
// What bounds it on the H100: at the prefill shapes (T = 512..1024, 16
// q heads, D = 128) the causal work is 2*Hq*T^2*D FLOPs against
// 2*(2*Hq + 2*Hkv)*T*D bytes -- about 300 FLOPs/byte at T = 1000, so the
// tensor cores, not HBM, are the limit beyond T ~ 1000. The design keeps
// every product on the tensor cores (WMMA 16x16x16 with fp32
// accumulation) and every intermediate (S, P, the running O) in shared
// memory, so HBM sees each Q/K/V row once per q tile and O once. The
// kv loop starts at the first tile inside the window of the tile's first
// row (_first_window_block, flash.py:160) and stops at the causal limit
// of its last row, so skipped tiles cost nothing: windowed prefill reads
// O(window) K/V rows per q tile, not O(Nk). Segment ids are read per K/V
// tile into shared memory beside it.
//
// Layout: one 128-thread block (4 warps) per (q tile of 64 rows, q head,
// batch). Q fragments stay in registers; 64-row K/V tiles stream through
// shared memory. Warp w owns S/P/O rows 16w..16w+15 and thread pair
// (2r, 2r+1) owns the softmax statistics of row r, so after each K/V
// tile lands only warp-level synchronisation is needed. The softmax is
// the textbook exp2 recurrence with the scale folded into the exp2
// constant; m, l and O stay in fp32, P is rounded to the input dtype for
// the PV product (the JAX kernel's numerics).
//
// A fast version (TMA loads, wgmma, a producer warp and double-buffered
// tiles) is later work; this one is simple and right first.

#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int kBQ = 64;       // q rows per block
constexpr int kBKV = 64;      // kv rows per tile
constexpr int kThreads = 128;

template <typename T, int D>
struct Smem {
  static constexpr int kLdQ = D + 8;       // Q/K/V rows (T elements)
  static constexpr int kLdS = kBKV + 4;    // S rows (floats)
  static constexpr int kLdP = kBKV + 8;    // P rows (T elements)
  static constexpr int kLdO = D + 4;       // O rows (floats)
  static constexpr size_t kQ = 0;
  static constexpr size_t kK = kQ + sizeof(T) * kBQ * kLdQ;
  static constexpr size_t kV = kK + sizeof(T) * kBKV * kLdQ;
  static constexpr size_t kS = kV + sizeof(T) * kBKV * kLdQ;
  static constexpr size_t kP = kS + sizeof(float) * kBQ * kLdS;
  static constexpr size_t kO = kP + sizeof(T) * kBQ * kLdP;
  static constexpr size_t kSeg = kO + sizeof(float) * kBQ * kLdO;
  static constexpr size_t kBytes = kSeg + sizeof(int) * kBKV;
};

// rows [r0, r0 + 64) of a [n, D] matrix into shared memory (row stride
// ld); rows past n are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src,
                                          int r0, int n, int tid) {
  fa::load_rows<T, D, 64, kThreads>(dst, ld, src, r0, n, tid);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, const int* __restrict__ qseg,
                 const int* __restrict__ kvseg, int Hq, int Hkv, int Nq,
                 int Nk, int causal, int offset, int window, float scale) {
  using L = Smem<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem + L::kQ);
  T* sK = reinterpret_cast<T*>(smem + L::kK);
  T* sV = reinterpret_cast<T*>(smem + L::kV);
  float* sS = reinterpret_cast<float*>(smem + L::kS);
  T* sP = reinterpret_cast<T*>(smem + L::kP);
  float* sO = reinterpret_cast<float*>(smem + L::kO);
  int* sKseg = reinterpret_cast<int*>(smem + L::kSeg);

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const size_t qbase = ((size_t)b * Hq + h) * Nq;
  const T* qg = q + qbase * D;
  const T* kg = k + ((size_t)b * Hkv + hk) * Nk * D;
  const T* vg = v + ((size_t)b * Hkv + hk) * Nk * D;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int row = tid >> 1;          // softmax row owned by this thread pair
  const int half = tid & 1;
  const int qrow = q0 + row;
  const int my_seg =
      (kvseg != nullptr && qrow < Nq) ? qseg[(size_t)b * Nq + qrow] : 0;

  load_tile<T, D>(sQ, L::kLdQ, qg, q0, Nq, tid);
  for (int i = tid; i < kBQ * D; i += kThreads)
    sO[(i / D) * L::kLdO + (i % D)] = 0.f;
  __syncthreads();

  wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> qf[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wmma::load_matrix_sync(qf[kk], sQ + (warp * 16) * L::kLdQ + kk * 16,
                           L::kLdQ);

  const float c = scale * fa::kLog2e;
  float m_i = fa::kInitM;
  float l_i = 0.f;

  // kv columns any real row of this tile can see: from the oldest
  // column inside the first row's window (rounded down to a tile) to the
  // last row's causal limit.
  int kv_begin = 0, kv_end = Nk;
  if (causal) {
    const int last_row = min(q0 + kBQ, Nq) - 1;
    kv_end = min(Nk, last_row + offset + 1);
  }
  if (window > 0)
    kv_begin = max(q0 + offset - window + 1, 0) / kBKV * kBKV;

  for (int j0 = kv_begin; j0 < kv_end; j0 += kBKV) {
    __syncthreads();   // every warp is done with the previous K/V tile
    load_tile<T, D>(sK, L::kLdQ, kg, j0, Nk, tid);
    load_tile<T, D>(sV, L::kLdQ, vg, j0, Nk, tid);
    if (kvseg != nullptr)
      for (int i = tid; i < kBKV; i += kThreads)
        sKseg[i] = j0 + i < Nk ? kvseg[(size_t)b * Nk + j0 + i] : 0;
    __syncthreads();

    // S = Q K^T for this warp's 16 rows (unscaled scores).
#pragma unroll
    for (int n = 0; n < kBKV / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf;
      wmma::fill_fragment(sf, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, sK + (n * 16) * L::kLdQ + kk * 16,
                               L::kLdQ);
        wmma::mma_sync(sf, qf[kk], kf, sf);
      }
      wmma::store_matrix_sync(sS + (warp * 16) * L::kLdS + n * 16, sf,
                              L::kLdS, wmma::mem_row_major);
    }
    __syncwarp();

    // Online softmax over this thread's half of the row.
    const float* srow = sS + row * L::kLdS;
    const int c0 = half * (kBKV / 2);
    float sv[kBKV / 2];
    float mx = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < kBKV / 2; ++jj) {
      const int col = j0 + c0 + jj;
      const bool ok = col < Nk && (!causal || col <= qrow + offset) &&
                      (window <= 0 || col > qrow + offset - window) &&
                      (kvseg == nullptr || sKseg[c0 + jj] == my_seg);
      sv[jj] = ok ? srow[c0 + jj] : -INFINITY;
      mx = fmaxf(mx, sv[jj]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_i, mx);
    const float alpha = exp2f((m_i - m_new) * c);
    float psum = 0.f;
    T* prow = sP + row * L::kLdP;
#pragma unroll
    for (int jj = 0; jj < kBKV / 2; ++jj) {
      const float p = exp2f((sv[jj] - m_new) * c);
      psum += p;
      prow[c0 + jj] = fa::from_float<T>(p);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l_i = l_i * alpha + psum;
    m_i = m_new;
    float* orow = sO + row * L::kLdO + half * (D / 2);
#pragma unroll 8
    for (int d = 0; d < D / 2; ++d) orow[d] *= alpha;
    __syncwarp();

    // O += P V for this warp's 16 rows.
    wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major>
        pf[kBKV / 16];
#pragma unroll
    for (int kk = 0; kk < kBKV / 16; ++kk)
      wmma::load_matrix_sync(pf[kk], sP + (warp * 16) * L::kLdP + kk * 16,
                             L::kLdP);
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> of;
      float* optr = sO + (warp * 16) * L::kLdO + n * 16;
      wmma::load_matrix_sync(of, optr, L::kLdO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kBKV / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> vf;
        wmma::load_matrix_sync(vf, sV + (kk * 16) * L::kLdQ + n * 16,
                               L::kLdQ);
        wmma::mma_sync(of, pf[kk], vf, of);
      }
      wmma::store_matrix_sync(optr, of, L::kLdO, wmma::mem_row_major);
    }
    __syncwarp();
  }

  if (qrow < Nq) {
    const float inv = l_i > 0.f ? 1.f / l_i : 0.f;
    const float* orow = sO + row * L::kLdO + half * (D / 2);
    T* og = o + (qbase + qrow) * D + half * (D / 2);
#pragma unroll
    for (int d = 0; d < D / 2; d += 8) {
      float vals[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) vals[i] = orow[d + i] * inv;
      *reinterpret_cast<uint4*>(og + d) = fa::pack8<T>(vals);
    }
    if (half == 0)
      lse[qbase + qrow] =
          l_i > 0.f ? m_i * scale + logf(l_i) : fa::kInitM * scale;
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, const int* qseg, const int* kvseg, int B,
                   int Hq, int Hkv, int Nq, int Nk, int causal, int offset,
                   int window, float scale, cudaStream_t stream) {
  constexpr size_t kBytes = Smem<T, D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kBytes);
  if (err != cudaSuccess) return err;
  dim3 grid((Nq + kBQ - 1) / kBQ, Hq, B);
  flash_fwd_kernel<T, D><<<grid, kThreads, kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, qseg, kvseg, Hq,
      Hkv, Nq, Nk, causal, offset, window, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fa_flash_fwd(const void* q, const void* k, const void* v,
                            void* o, void* lse, const void* qseg,
                            const void* kvseg, int B, int Hq, int Hkv,
                            int Nq, int Nk, int D, int causal, int offset,
                            int window, float scale, int dtype,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  const int* qs = static_cast<const int*>(qseg);
  const int* ks = static_cast<const int*>(kvseg);
  if (Hkv <= 0 || Hq % Hkv || (qs == nullptr) != (ks == nullptr) ||
      (window > 0 && !causal))
    return (int)cudaErrorInvalidValue;
#define FA_FWD_LAUNCH(T, DIM)                                              \
  return (int)launch<T, DIM>(q, k, v, o, l, qs, ks, B, Hq, Hkv, Nq, Nk,   \
                             causal, offset, window, scale, s);
  if (dtype == fa::kBFloat16) {
    if (D == 128) FA_FWD_LAUNCH(__nv_bfloat16, 128)
    if (D == 64) FA_FWD_LAUNCH(__nv_bfloat16, 64)
  } else if (dtype == fa::kFloat16) {
    if (D == 128) FA_FWD_LAUNCH(__half, 128)
    if (D == 64) FA_FWD_LAUNCH(__half, 64)
  }
#undef FA_FWD_LAUNCH
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* fa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
