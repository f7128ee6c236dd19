// The first body of the decode attention kernels B4 (paged_decode.cu,
// K/V in page-table-indexed pools) and B5 (decode.cu, K/V in contiguous
// per-sequence caches): the FFMA body of an fp32 q, and of B4 fp16 /
// bf16 over dense pools whose page size is not a multiple of 16. Every
// other fp16 / bf16 launch runs the split body of decode_sm90.cuh, which
// reuses this file's addressing functors (PagedChunks, ContiguousChunks)
// and kQuantBlock. Only the addressing differs between B4 and B5: an
// `Offsets` functor maps chunk p of a sequence's tokens to the element
// offset of its first K/V row; inside a chunk the rows are contiguous
// [n, D].
//
// One block of kThreads threads attends the R-bounded `rows` query rows
// of one (sequence, kv head) over the first `len` tokens, chunk by
// chunk: (A) D/8 lanes per token compute the rows' scores of a token,
// reduced with shuffles; (B) one warp per row turns the chunk's scores
// into probabilities against the running max (exp2 with the scale folded
// in; m, l in fp32); (C) each thread accumulates R x 8 output channels
// over its share of the chunk's tokens. Per-thread partial sums are added
// in a fixed order at the end, so results are deterministic. A length-0
// row writes O = 0 and, where asked, LSE = INIT_M * scale. The kernels
// (B4, B5) call it once per group of at most R rows of a (sequence, kv
// head): any row count runs in one launch, and K/V are read once per
// group (the accumulators of R = 16 rows already take 128 registers a
// thread).
//
// Sliding window (the TPU kernels' `windowed` branches, paged.py:62-66,
// :124-130 and decode.py:88-111): row r sees only positions >= start +
// (r % spread) -- `spread` folded query positions, t fastest, each one
// position later than the last. Chunks entirely below `start` are never
// read; a row whose window holds nothing exports O = 0 and LSE =
// INIT_M * scale. The window is a template parameter: the dense
// instantiation (Windowed = false) ignores start and spread and carries
// no mask in its score loop.
//
// Quantized K/V (the TPU kernels' int8 / fp8 branches, decode.py:56-68,
// paged.py:73-115, :135-168): `Store` names the storage of the K/V
// values (common.cuh kDense / kInt8 / kE4M3 / kE5M2), a template
// parameter like the window, so the dense instantiations compile as
// before. A quantized lane loads 8 codes (8 bytes) where a dense one
// loads 8 values (16 bytes) and widens them in registers; the fp32 scale
// row of each 128-token block ([D] per block: per (token block, channel)
// scales) is read by each lane for its 8 channels once per 128 tokens.
// The default body multiplies each widened code by its scale in fp32 and
// rounds the product to T before the product with q or p (the JAX
// kernels' roundings). `Fold` (int8 only, the TPU kernel's fold_scales
// body, paged.py:73-96, :135-146) moves the scales out of the
// per-element work: per 128-token block the K scale row multiplies q in
// fp32, rounded to T (staged in shared memory for the whole block), and
// each thread's partial PV sum over the block's tokens is multiplied by
// the V scale row; the int8 codes enter the products unscaled (exact in
// T). Chunks (pages of a multiple of 128 tokens, or B5's 256-position
// chunks) hold whole scale blocks, and every token loop below steps by a
// divisor of 128, so a step never straddles two blocks.
//
// The compute type T (q, O, and dense K/V) is fp16, bf16 or fp32, as the
// JAX kernels take all three: the products are fp32 on the CUDA cores in
// every type, so fp32 only changes the loads (8 dense fp32 values are two
// 16-byte loads; codes are the same 8 bytes) and makes every rounding to
// T exact.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace fa {
namespace decode {

constexpr int kThreads = 256;

constexpr int kQuantBlock = 128;   // tokens per scale row (QUANT_BLOCK)

// Token loads in flight per thread: 4, or fewer where 4 passes of the
// block would straddle a scale block (D = 32: 64 tokens a pass).
template <int D>
constexpr int unroll() {
  constexpr int kTokPerPass = kThreads / (D / 8);
  return kTokPerPass * 4 <= kQuantBlock ? 4 : kQuantBlock / kTokPerPass;
}

// Fold keeps the block's scaled q in shared memory.
template <int D, int R, bool Fold>
size_t smem_bytes(int chunk) {
  constexpr int kTokGroups = kThreads / (D / 8);
  return sizeof(float) *
         (R * D * (Fold ? 2 : 1) + R * chunk + kTokGroups * D + 3 * R);
}

// Chunk p of a sequence in page-table-indexed pools [Hkv, P, ps, D]
// (scales [Hkv, P, ps / 128, D]).
struct PagedChunks {
  const int* table;       // this sequence's page-table row
  size_t head_page0;      // h * num_pages
  size_t page_elems;      // page_size * D
  size_t page_scales;     // page_size / 128 * D
  __device__ __forceinline__ size_t operator()(int p) const {
    return (head_page0 + table[p]) * page_elems;
  }
  __device__ __forceinline__ size_t scales(int p) const {
    return (head_page0 + table[p]) * page_scales;
  }
};

// Chunk p of a sequence in a contiguous cache [B, Hkv, S, D] (scales
// [B, Hkv, S / 128, D]).
struct ContiguousChunks {
  size_t seq_base;        // ((b * Hkv + h) * S) * D
  size_t chunk_elems;     // chunk * D
  size_t seq_scales;      // ((b * Hkv + h) * S / 128) * D
  size_t chunk_scales;    // chunk / 128 * D
  __device__ __forceinline__ size_t operator()(int p) const {
    return seq_base + (size_t)p * chunk_elems;
  }
  __device__ __forceinline__ size_t scales(int p) const {
    return seq_scales + (size_t)p * chunk_scales;
  }
};

// The 8 channels [c, c + 8) of a scale row.
__device__ __forceinline__ void load_scales8(const float* row, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(row);
  const float4 b = *reinterpret_cast<const float4*>(row + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

// 8 dense fp32 values: two 16-byte loads (4 values each).
struct alignas(16) Raw32 {
  uint4 lo, hi;
};

// Storage of K/V values: the element a row is made of and the 8-value
// load (16 bytes of fp16 / bf16, 32 of fp32, 8 bytes of codes).
template <typename T, int Store>
struct KV {
  static constexpr bool kQuant = Store != kDense;
  using Elem = std::conditional_t<kQuant, unsigned char, T>;
  using Raw = std::conditional_t<
      kQuant, uint2, std::conditional_t<sizeof(T) == 4, Raw32, uint4>>;
  __device__ __forceinline__ static Raw load(const Elem* p) {
    return *reinterpret_cast<const Raw*>(p);
  }
  __device__ __forceinline__ static Raw zero() { return Raw{}; }
  // 8 values as float: dense converted, codes widened (unscaled).
  __device__ __forceinline__ static void widen(const Raw& raw, float* out) {
    if constexpr (kQuant) {
      widen8<Store>(raw, out);
    } else {
      const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < 8; ++i) out[i] = to_float<T>(v[i]);
    }
  }
};

// q_rows / o_rows: `rows` (<= R) consecutive rows of D values, the
// first of them row `row0` of its (sequence, kv head); lse_rows may be
// null; kscale / vscale: the scale pools (null when Store is kDense).
// Every thread of the block must call it.
template <bool Windowed, int Store, bool Fold, typename T, int D, int R,
          typename Offsets>
__device__ __forceinline__ void attend(
    const T* __restrict__ q_rows, const void* __restrict__ kpool,
    const void* __restrict__ vpool, const float* __restrict__ kscale,
    const float* __restrict__ vscale, Offsets offsets, int len,
    int n_chunks, int chunk, int rows, int row0, float scale, int start,
    int spread, T* __restrict__ o_rows, float* __restrict__ lse_rows) {
  using S = KV<T, Store>;
  using Elem = typename S::Elem;
  using Raw = typename S::Raw;
  constexpr bool kQuant = S::kQuant;
  static_assert(!Fold || Store == kInt8, "fold_scales is the int8 body");
  constexpr int kLanesPerTok = D / 8;               // 8 values per lane
  constexpr int kTokPerPass = kThreads / kLanesPerTok;
  constexpr int kDimGroups = D / 8;
  constexpr int kTokGroups = kThreads / kDimGroups;
  constexpr int kUnroll = unroll<D>();
  static_assert(kQuantBlock % (kTokPerPass * kUnroll) == 0 &&
                    kQuantBlock % (kTokGroups * kUnroll) == 0,
                "a token step must not straddle two scale blocks");
  const Elem* kbase = static_cast<const Elem*>(kpool);
  const Elem* vbase = static_cast<const Elem*>(vpool);

  extern __shared__ __align__(16) float smem[];
  float* sq = smem;                                 // [R][D]
  float* ss = sq + R * D;                           // [R][chunk]
  float* sred = ss + R * chunk;                     // [kTokGroups][D]
  float* sm = sred + kTokGroups * D;                // [R] running max
  float* sl = sm + R;                               // [R] running sum
  float* salpha = sl + R;                           // [R] rescale factor
  float* sqs = salpha + R;                          // [R][D] Fold: q * ks

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
    for (int r = 0; r < R; ++r) lo[r] = start + (row0 + r) % spread;
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
    const Elem* kp = kbase + off;
    const Elem* vp = vbase + off;
    const float* ksp = kQuant ? kscale + offsets.scales(p) : nullptr;
    const float* vsp = kQuant ? vscale + offsets.scales(p) : nullptr;

    // (A) scores s[r][t] = q_r . k_t (unscaled). The loop bound is
    // uniform across the block, so every lane reaches the shuffles (and,
    // under Fold, the barriers).
    float ksc[kQuant && !Fold ? 8 : 1];
    for (int t0 = 0; t0 < n; t0 += kTokPerPass * kUnroll) {
      if constexpr (kQuant) {
        if (t0 % kQuantBlock == 0) {
          const float* srow = ksp + (t0 / kQuantBlock) * D;
          if constexpr (Fold) {
            __syncthreads();     // every lane is done with the last block
            for (int i = tid; i < rows * D; i += kThreads)
              sqs[i] = round_to<T>(sq[i] * srow[i % D]);
            __syncthreads();
          } else {
            load_scales8(srow + a_chunk, ksc);
          }
        }
      }
      const float* qsrc = Fold ? sqs : sq;
      Raw raw[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int t = t0 + u * kTokPerPass + a_tok;
        raw[u] = t < n ? S::load(kp + (size_t)t * D + a_chunk) : S::zero();
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int t = t0 + u * kTokPerPass + a_tok;
        float kf[8];
        S::widen(raw[u], kf);
        if constexpr (kQuant && !Fold) {
#pragma unroll
          for (int i = 0; i < 8; ++i) kf[i] = round_to<T>(kf[i] * ksc[i]);
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (r < rows) {
            const float* qq = qsrc + r * D + a_chunk;
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
    float vsc[kQuant ? 8 : 1];
    for (int t0 = 0; t0 < n; t0 += kTokGroups * kUnroll) {
      if constexpr (kQuant) {
        if (t0 % kQuantBlock == 0)
          load_scales8(vsp + (t0 / kQuantBlock) * D + c_chunk, vsc);
      }
      Raw raw[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int t = t0 + u * kTokGroups + c_tok;
        raw[u] = t < n ? S::load(vp + (size_t)t * D + c_chunk) : S::zero();
      }
      if constexpr (Fold) {
        // Unscaled codes; this thread's partial sum over the step's
        // tokens (all in one block) is scaled once per channel.
        float vf[kUnroll][8];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) S::widen(raw[u], vf[u]);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (r < rows) {
            float part[8];
#pragma unroll
            for (int i = 0; i < 8; ++i) part[i] = 0.f;
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
              const int t = t0 + u * kTokGroups + c_tok;
              const float pr = t < n ? ss[r * chunk + t] : 0.f;
#pragma unroll
              for (int i = 0; i < 8; ++i) part[i] += pr * vf[u][i];
            }
#pragma unroll
            for (int i = 0; i < 8; ++i) acc[r][i] += part[i] * vsc[i];
          }
        }
      } else {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int t = t0 + u * kTokGroups + c_tok;
          if (t < n) {
            float vf[8];
            S::widen(raw[u], vf);
            if constexpr (kQuant) {
#pragma unroll
              for (int i = 0; i < 8; ++i) vf[i] = round_to<T>(vf[i] * vsc[i]);
            }
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
