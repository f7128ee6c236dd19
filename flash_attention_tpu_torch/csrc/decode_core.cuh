// The body shared by the decode attention kernels B4 (paged_decode.cu,
// K/V in page-table-indexed pools) and B5 (decode.cu, K/V in contiguous
// per-sequence caches). Only the addressing differs: an `Offsets`
// functor maps chunk p of a sequence's tokens to the element offset of
// its first K/V row; inside a chunk the rows are contiguous [n, D].
//
// One block of kThreads threads attends the R-bounded `rows` query rows
// of one (sequence, kv head) over the first `len` tokens, chunk by
// chunk: (A) D/8 lanes per token compute the rows' scores of a token,
// reduced with shuffles; (B) one warp per row turns the chunk's scores
// into probabilities against the running max (exp2 with the scale folded
// in; m, l in fp32); (C) each thread accumulates R x 8 output channels
// over its share of the chunk's tokens. Per-thread partial sums are added
// in a fixed order at the end, so results are deterministic. A length-0
// row writes O = 0 and, where asked, LSE = INIT_M * scale.
//
// Sliding window (the TPU kernels' `windowed` branches, paged.py:62-66,
// :124-130 and decode.py:88-111): row r sees only positions >= start +
// (r % spread) -- `spread` folded query positions, t fastest, each one
// position later than the last. Chunks entirely below `start` are never
// read; a row whose window holds nothing exports O = 0 and LSE =
// INIT_M * scale. The window is a template parameter: the dense
// instantiation (Windowed = false) ignores start and spread and carries
// no mask in its score loop.
#pragma once

#include "common.cuh"

namespace fa {
namespace decode {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;      // token loads in flight per thread

template <int D, int R>
size_t smem_bytes(int chunk) {
  constexpr int kTokGroups = kThreads / (D / 8);
  return sizeof(float) * (R * D + R * chunk + kTokGroups * D + 3 * R);
}

// Chunk p of a sequence in page-table-indexed pools [Hkv, P, ps, D].
struct PagedChunks {
  const int* table;       // this sequence's page-table row
  size_t head_page0;      // h * num_pages
  size_t page_elems;      // page_size * D
  __device__ __forceinline__ size_t operator()(int p) const {
    return (head_page0 + table[p]) * page_elems;
  }
};

// Chunk p of a sequence in a contiguous cache [B, Hkv, S, D].
struct ContiguousChunks {
  size_t seq_base;        // ((b * Hkv + h) * S) * D
  size_t chunk_elems;     // chunk * D
  __device__ __forceinline__ size_t operator()(int p) const {
    return seq_base + (size_t)p * chunk_elems;
  }
};

// q_rows / o_rows: `rows` consecutive rows of D values; lse_rows may be
// null. Every thread of the block must call it.
template <bool Windowed, typename T, int D, int R, typename Offsets>
__device__ __forceinline__ void attend(
    const T* __restrict__ q_rows, const T* __restrict__ kbase,
    const T* __restrict__ vbase, Offsets offsets, int len, int n_chunks,
    int chunk, int rows, float scale, int start, int spread,
    T* __restrict__ o_rows, float* __restrict__ lse_rows) {
  constexpr int kLanesPerTok = D / 8;               // 16-byte chunks per row
  constexpr int kTokPerPass = kThreads / kLanesPerTok;
  constexpr int kDimGroups = D / 8;
  constexpr int kTokGroups = kThreads / kDimGroups;

  extern __shared__ __align__(16) float smem[];
  float* sq = smem;                                 // [R][D]
  float* ss = sq + R * D;                           // [R][chunk]
  float* sred = ss + R * chunk;                     // [kTokGroups][D]
  float* sm = sred + kTokGroups * D;                // [R] running max
  float* sl = sm + R;                               // [R] running sum
  float* salpha = sl + R;                           // [R] rescale factor

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const float c = scale * kLog2e;

  for (int i = tid; i < rows * D; i += kThreads)
    sq[i] = to_float<T>(q_rows[i]);
  if (tid < R) {
    sm[tid] = kInitM;
    sl[tid] = 0.f;
  }

  // Phase A/C thread roles.
  const int a_tok = tid / kLanesPerTok, a_chunk = (tid % kLanesPerTok) * 8;
  const int c_tok = tid / kDimGroups, c_chunk = (tid % kDimGroups) * 8;
  // Lowest visible position of each row, computed once: a modulo by the
  // runtime spread would otherwise sit in the per-score loop.
  int lo[Windowed ? R : 1];
  if constexpr (Windowed) {
#pragma unroll
    for (int r = 0; r < R; ++r) lo[r] = start + r % spread;
  }
  float acc[R][8];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[r][i] = 0.f;
  __syncthreads();

  for (int p = Windowed ? max(start, 0) / chunk : 0; p < n_chunks; ++p) {
    const int n = min(chunk, len - p * chunk);
    const size_t off = offsets(p);
    const T* kp = kbase + off;
    const T* vp = vbase + off;

    // (A) scores s[r][t] = q_r . k_t (unscaled). The loop bound is
    // uniform across the block, so every lane reaches the shuffles.
    for (int t0 = 0; t0 < n; t0 += kTokPerPass * kUnroll) {
      uint4 raw[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int t = t0 + u * kTokPerPass + a_tok;
        raw[u] = t < n ? *reinterpret_cast<const uint4*>(
                             kp + (size_t)t * D + a_chunk)
                       : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int t = t0 + u * kTokPerPass + a_tok;
        float kf[8];
        unpack8<T>(raw[u], kf);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (r < rows) {
            const float* qq = sq + r * D + a_chunk;
            float dot = 0.f;
#pragma unroll
            for (int i = 0; i < 8; ++i) dot += qq[i] * kf[i];
#pragma unroll
            for (int o = kLanesPerTok / 2; o > 0; o >>= 1)
              dot += __shfl_xor_sync(0xffffffffu, dot, o);
            if (a_chunk == 0 && t < n) {
              if constexpr (Windowed)
                ss[r * chunk + t] = p * chunk + t >= lo[r] ? dot : -INFINITY;
              else
                ss[r * chunk + t] = dot;
            }
          }
        }
      }
    }
    __syncthreads();

    // (B) probabilities for this chunk against the running max.
    for (int r = warp; r < rows; r += kThreads / 32) {
      float* srow = ss + r * chunk;
      float mx = -INFINITY;
      for (int t = lane; t < n; t += 32) mx = fmaxf(mx, srow[t]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = sm[r];
      const float m_new = fmaxf(m_old, mx);
      float psum = 0.f;
      for (int t = lane; t < n; t += 32) {
        const float pr = exp2f((srow[t] - m_new) * c);
        psum += pr;
        // The PV product takes p rounded to the input dtype.
        srow[t] = to_float<T>(from_float<T>(pr));
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, o);
      if (lane == 0) {
        const float alpha = exp2f((m_old - m_new) * c);
        salpha[r] = alpha;
        sl[r] = sl[r] * alpha + psum;
        sm[r] = m_new;
      }
    }
    __syncthreads();

    // (C) acc[r] = alpha[r] * acc[r] + sum_t p[r][t] * v_t.
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < rows) {
        const float a = salpha[r];
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[r][i] *= a;
      }
    }
    for (int t0 = 0; t0 < n; t0 += kTokGroups * kUnroll) {
      uint4 raw[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int t = t0 + u * kTokGroups + c_tok;
        raw[u] = t < n ? *reinterpret_cast<const uint4*>(
                             vp + (size_t)t * D + c_chunk)
                       : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int t = t0 + u * kTokGroups + c_tok;
        if (t < n) {
          float vf[8];
          unpack8<T>(raw[u], vf);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            if (r < rows) {
              const float pr = ss[r * chunk + t];
#pragma unroll
              for (int i = 0; i < 8; ++i) acc[r][i] += pr * vf[i];
            }
          }
        }
      }
    }
    __syncthreads();   // ss is rewritten by the next chunk's phase A
  }

  // Sum the token groups' partials in a fixed order, one row at a time.
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r < rows) {
#pragma unroll
      for (int i = 0; i < 8; ++i) sred[c_tok * D + c_chunk + i] = acc[r][i];
      __syncthreads();
      if (tid < D) {
        float sum = 0.f;
        for (int g = 0; g < kTokGroups; ++g) sum += sred[g * D + tid];
        const float l = sl[r];
        o_rows[r * D + tid] = from_float<T>(l > 0.f ? sum / l : 0.f);
        if (tid == 0 && lse_rows != nullptr)
          lse_rows[r] = sm[r] * scale + logf(l > 0.f ? l : 1.f);
      }
      __syncthreads();
    }
  }
}

}  // namespace decode
}  // namespace fa
