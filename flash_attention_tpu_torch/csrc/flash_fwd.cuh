// The B1 forward kernel template (flash_fwd.cu), instantiated per
// compute type, head dim and K/V storage. flash_fwd.cu holds the dense
// fp16 / bf16 instantiations and the C entry point, flash_fwd_quant.cu
// the int8 / fp8 ones, flash_fwd_f32.cu the fp32 ones (dense K/V only).
#pragma once

#include <mma.h>

#include <type_traits>

#include "common.cuh"

namespace fa {
namespace fwd {

using namespace nvcuda;

constexpr int kBKV = 64;      // kv rows per tile

// The q row tile is 64 rows (128 threads, a thread pair a row) except
// for fp32 at D = 256, where 64-row fp32 tiles would take 305 KB: 32
// rows (64 threads) take 217,344 bytes. At D = 256 the bf16 / fp16 tiles
// take 194,816 bytes, inside the 227 KB a block may use.
template <typename T, int D>
struct Smem {
  static constexpr int kBQ = sizeof(T) == 4 && D > 128 ? 32 : 64;
  static constexpr int kThreads = 2 * kBQ;
  static constexpr int kPad = 16 / sizeof(T);   // keeps rows 16-byte aligned
  static constexpr int kLdQ = D + kPad;    // Q/K/V rows (T elements)
  static constexpr int kLdS = kBKV + 4;    // S rows (floats)
  static constexpr int kLdP = kBKV + kPad; // P rows (T elements)
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

// rows [r0, r0 + kRows) of a [n, D] matrix into shared memory (row
// stride ld); rows past n are zero.
template <typename T, int D, int kRows = kBKV>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src,
                                          int r0, int n, int tid) {
  fa::load_rows<T, D, kRows, Smem<T, D>::kThreads>(dst, ld, src, r0, n,
                                                    tid);
}

// K/V rows [r0, r0 + 64) in storage Store into a T tile: dense rows as
// load_tile; int8 / fp8 codes widened, times the fp32 scale row of each
// row's 128-row block (scales: [n / 128, D]), rounded to T. Rows past n
// are zero.
template <typename T, int D, int Store>
__device__ __forceinline__ void load_kv_tile(T* dst, int ld, const void* src,
                                             const float* scales, int r0,
                                             int n, int tid) {
  if constexpr (Store == kDense) {
    load_tile<T, D>(dst, ld, static_cast<const T*>(src), r0, n, tid);
  } else {
    const unsigned char* codes = static_cast<const unsigned char*>(src);
    constexpr int kVecPerRow = D / 8;
    for (int i = tid; i < kBKV * kVecPerRow; i += Smem<T, D>::kThreads) {
      const int r = i / kVecPerRow;
      const int c = (i % kVecPerRow) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (r0 + r < n) {
        const int row = r0 + r;
        float x[8];
        widen8<Store>(*reinterpret_cast<const uint2*>(
                          codes + (size_t)row * D + c),
                      x);
        const float* srow = scales + (size_t)(row / 128) * D + c;
#pragma unroll
        for (int e = 0; e < 8; ++e) x[e] *= srow[e];
        val = pack8<T>(x);
      }
      *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
    }
  }
}

struct Args {
  const void* q;            // [B, Hq, Nq, D] in T
  const void* k;            // [B, Hkv, Nk, D] in the storage
  const void* v;
  const float* kscale;      // [B, Hkv, Nk / 128, D], null when dense
  const float* vscale;
  void* o;                  // [B, Hq, Nq, D] in T
  float* lse;               // [B, Hq, Nq]
  const int* qseg;          // [B, Nq] or null
  const int* kvseg;         // [B, Nk] or null
  int B, Hq, Hkv, Nq, Nk, causal, offset, window;
  // The two passes of the causal split (flash_attention_fwd_split): 0
  // none; kSplitBulk the mask-free pass over the kv columns below each q
  // tile's band, [0, (q0 / band) * band); kSplitBand the causal pass
  // over the band itself, [(q0 / band) * band, + band). band is a
  // multiple of the q tile.
  int split, band;
  float scale;
  cudaStream_t stream;
};

constexpr int kSplitBulk = 1;
constexpr int kSplitBand = 2;

// S[16, kBKV] = Q K^T (unscaled) for one warp's 16 query rows. fp16 /
// bf16 keep the warp's Q rows in tensor-core fragments (WMMA 16x16x16,
// fp32 accumulation); fp32 reads them from shared memory and multiplies
// on the CUDA cores in full fp32 (fa::ffma_abt).
template <typename T, int D>
struct QRows {
  wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> f[D / 16];

  __device__ __forceinline__ void load(const T* q, int ld) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wmma::load_matrix_sync(f[kk], q + kk * 16, ld);
  }

  __device__ __forceinline__ void scores(float* s, int lds, const T* k,
                                         int ldk) {
#pragma unroll
    for (int n = 0; n < kBKV / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf;
      wmma::fill_fragment(sf, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, k + (n * 16) * ldk + kk * 16, ldk);
        wmma::mma_sync(sf, f[kk], kf, sf);
      }
      wmma::store_matrix_sync(s + n * 16, sf, lds, wmma::mem_row_major);
    }
  }
};

template <int D>
struct QRows<float, D> {
  const float* q;
  int ld;

  __device__ __forceinline__ void load(const float* q_, int ld_) {
    q = q_;
    ld = ld_;
  }

  __device__ __forceinline__ void scores(float* s, int lds, const float* k,
                                         int ldk) {
    fa::ffma_abt<kBKV, D>(s, lds, q, ld, k, ldk, threadIdx.x & 31);
  }
};

// O[16, D] += P[16, kBKV] V for one warp's 16 rows (WMMA for fp16 /
// bf16, FFMA for fp32).
template <typename T, int D>
__device__ __forceinline__ void pv_accumulate(float* o, int ldo, const T* p,
                                              int ldp, const T* v, int ldv) {
  if constexpr (sizeof(T) == 4) {
    fa::ffma_ab<D, kBKV>(o, ldo, p, ldp, v, ldv, nullptr, nullptr,
                         threadIdx.x & 31);
  } else {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major>
        pf[kBKV / 16];
#pragma unroll
    for (int kk = 0; kk < kBKV / 16; ++kk)
      wmma::load_matrix_sync(pf[kk], p + kk * 16, ldp);
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> of;
      float* optr = o + n * 16;
      wmma::load_matrix_sync(of, optr, ldo, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kBKV / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> vf;
        wmma::load_matrix_sync(vf, v + (kk * 16) * ldv + n * 16, ldv);
        wmma::mma_sync(of, pf[kk], vf, of);
      }
      wmma::store_matrix_sync(optr, of, ldo, wmma::mem_row_major);
    }
  }
}

template <typename T, int D, int Store>
__global__ void __launch_bounds__(Smem<T, D>::kThreads)
    flash_fwd_kernel(const Args a) {
  using L = Smem<T, D>;
  constexpr int kBQ = L::kBQ;
  constexpr int kThreads = L::kThreads;
  using Elem = std::conditional_t<Store == kDense, T, unsigned char>;
  const int Hq = a.Hq, Hkv = a.Hkv, Nq = a.Nq, Nk = a.Nk;
  const int causal = a.causal, offset = a.offset, window = a.window;
  const float scale = a.scale;
  const int* __restrict__ qseg = a.qseg;
  const int* __restrict__ kvseg = a.kvseg;
  T* __restrict__ o = static_cast<T*>(a.o);
  float* __restrict__ lse = a.lse;
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
  const T* qg = static_cast<const T*>(a.q) + qbase * D;
  const size_t kv_head = (size_t)b * Hkv + hk;
  const Elem* kg = static_cast<const Elem*>(a.k) + kv_head * Nk * D;
  const Elem* vg = static_cast<const Elem*>(a.v) + kv_head * Nk * D;
  const size_t sbase = kv_head * (size_t)(Nk / 128) * D;
  const float* ksg = Store == kDense ? nullptr : a.kscale + sbase;
  const float* vsg = Store == kDense ? nullptr : a.vscale + sbase;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int row = tid >> 1;          // softmax row owned by this thread pair
  const int half = tid & 1;
  const int qrow = q0 + row;
  const int my_seg =
      (kvseg != nullptr && qrow < Nq) ? qseg[(size_t)b * Nq + qrow] : 0;

  load_tile<T, D, kBQ>(sQ, L::kLdQ, qg, q0, Nq, tid);
  for (int i = tid; i < kBQ * D; i += kThreads)
    sO[(i / D) * L::kLdO + (i % D)] = 0.f;
  __syncthreads();

  QRows<T, D> qrows;
  qrows.load(sQ + (warp * 16) * L::kLdQ, L::kLdQ);

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
  // The causal split: every row of the tile shares one band.
  const int band0 = a.split ? q0 / a.band * a.band : 0;
  if (a.split == kSplitBulk) kv_end = min(kv_end, band0);
  if (a.split == kSplitBand) {
    kv_begin = band0;
    kv_end = min(kv_end, band0 + a.band);
  }

  for (int j0 = kv_begin; j0 < kv_end; j0 += kBKV) {
    __syncthreads();   // every warp is done with the previous K/V tile
    load_kv_tile<T, D, Store>(sK, L::kLdQ, kg, ksg, j0, Nk, tid);
    load_kv_tile<T, D, Store>(sV, L::kLdQ, vg, vsg, j0, Nk, tid);
    if (kvseg != nullptr)
      for (int i = tid; i < kBKV; i += kThreads)
        sKseg[i] = j0 + i < Nk ? kvseg[(size_t)b * Nk + j0 + i] : 0;
    __syncthreads();

    // S = Q K^T for this warp's 16 rows (unscaled scores).
    qrows.scores(sS + (warp * 16) * L::kLdS, L::kLdS, sK, L::kLdQ);
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
    pv_accumulate<T, D>(sO + (warp * 16) * L::kLdO, L::kLdO,
                        sP + (warp * 16) * L::kLdP, L::kLdP, sV, L::kLdQ);
    __syncwarp();
  }

  if (qrow < Nq) {
    const float inv = l_i > 0.f ? 1.f / l_i : 0.f;
    const float* orow = sO + row * L::kLdO + half * (D / 2);
    T* og = o + (qbase + qrow) * D + half * (D / 2);
    fa::store_scaled<T, D / 2>(og, orow, inv);
    if (half == 0)
      lse[qbase + qrow] =
          l_i > 0.f ? m_i * scale + logf(l_i) : fa::kInitM * scale;
  }
}

template <typename T, int D, int Store>
cudaError_t launch(const Args& a) {
  using L = Smem<T, D>;
  static_assert(L::kBytes <= 232448, "B1 tiles exceed shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D, Store>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kBytes);
  if (err != cudaSuccess) return err;
  dim3 grid((a.Nq + L::kBQ - 1) / L::kBQ, a.Hq, a.B);
  flash_fwd_kernel<T, D, Store>
      <<<grid, L::kThreads, L::kBytes, a.stream>>>(a);
  return cudaGetLastError();
}

template <int Store>
cudaError_t dispatch(const Args& a, int dtype, int D) {
  if (dtype == kBFloat16) {
    if (D == 128) return launch<__nv_bfloat16, 128, Store>(a);
    if (D == 64) return launch<__nv_bfloat16, 64, Store>(a);
    if (D == 256) return launch<__nv_bfloat16, 256, Store>(a);
    if (D == 32) return launch<__nv_bfloat16, 32, Store>(a);
  } else if (dtype == kFloat16) {
    if (D == 128) return launch<__half, 128, Store>(a);
    if (D == 64) return launch<__half, 64, Store>(a);
    if (D == 256) return launch<__half, 256, Store>(a);
    if (D == 32) return launch<__half, 32, Store>(a);
  }
  return cudaErrorInvalidValue;
}

// Defined in flash_fwd_quant.cu.
cudaError_t dispatch_quant(const Args& a, int dtype, int D, int store);
// Defined in flash_fwd_f32.cu: fp32 q / k / v, dense.
cudaError_t dispatch_f32(const Args& a, int D);

}  // namespace fwd
}  // namespace fa
