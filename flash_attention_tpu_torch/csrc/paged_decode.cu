// B4: paged decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel flash_attention_tpu/ops/paged.py
// `_paged_kernel` (paged.py:37, launched at :305) on the port's serving
// path (one launch per layer per engine decode step).
//
// Computes, for every sequence b and kv head h, attention of the R query
// rows that read kv head h (the GQA group times any folded positions,
// t fastest) over the first lengths[b] tokens of the sequence's paged
// K/V, and exports O [B, Hq, D] and LSE [B, Hq] (fp32). A length-0 row
// (a dead engine slot) gives O = 0 and LSE = INIT_M * scale.
//
// What bounds it on the H100: bytes. Each live token's K and V rows are
// read once per kv head (4*Hkv*D bytes per token in bf16) and do 4*R*D
// FLOPs, about R/2 FLOPs per byte -- far under the ~295 FLOPs per byte
// at which the tensor cores would become the limit. The design therefore
// reads only what is live and reads it once: the block walks only the
// ceil(lengths[b] / page_size) live entries of page_table[b] (never the
// table width, whose tail points at a scratch page), reads each page's
// [page_size, D] K and V rows once for all R query rows, with 16-byte
// loads by neighbouring threads on neighbouring addresses, four tokens'
// loads in flight per thread. The products run on the CUDA cores in
// fp32; tensor cores would buy nothing at R <= 16.
//
// Layout: one block of 256 threads per (kv head, sequence). Per page:
// (A) D/8 lanes per token compute the R scores of a token, reduced with
// shuffles; (B) one warp per row turns the page's scores into
// probabilities against the running max (exp2 with the scale folded in;
// m, l in fp32); (C) each thread accumulates R x 8 output channels over
// its share of the page's tokens. The per-thread partial sums are added
// in a fixed order at the end, so results are deterministic.
//
// Few blocks (B * Hkv) are in flight at small batch; splitting the pages
// of a sequence across blocks with a merge pass is the fast shape and is
// later work.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;      // token loads in flight per thread

template <typename T, int D, int R>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kpool,
                    const T* __restrict__ vpool,
                    const int* __restrict__ table,
                    const int* __restrict__ lengths, T* __restrict__ o,
                    float* __restrict__ lse, int Hq, int Hkv, int num_pages,
                    int page_size, int width, int rows, float scale) {
  constexpr int kLanesPerTok = D / 8;               // 16-byte chunks per row
  constexpr int kTokPerPass = kThreads / kLanesPerTok;
  constexpr int kDimGroups = D / 8;
  constexpr int kTokGroups = kThreads / kDimGroups;

  extern __shared__ __align__(16) float smem[];
  float* sq = smem;                                 // [R][D]
  float* ss = sq + R * D;                           // [R][page_size]
  float* sred = ss + R * page_size;                 // [kTokGroups][D]
  float* sm = sred + kTokGroups * D;                // [R] running max
  float* sl = sm + R;                               // [R] running sum
  float* salpha = sl + R;                           // [R] rescale factor

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const float c = scale * fa::kLog2e;

  const int len = lengths[b];
  const int n_pages = min((len + page_size - 1) / page_size, width);
  const size_t qrow0 = (size_t)b * Hq + (size_t)h * rows;

  for (int i = tid; i < rows * D; i += kThreads)
    sq[i] = fa::to_float<T>(q[qrow0 * D + i]);
  if (tid < R) {
    sm[tid] = fa::kInitM;
    sl[tid] = 0.f;
  }

  // Phase A/C thread roles.
  const int a_tok = tid / kLanesPerTok, a_chunk = (tid % kLanesPerTok) * 8;
  const int c_tok = tid / kDimGroups, c_chunk = (tid % kDimGroups) * 8;
  float acc[R][8];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[r][i] = 0.f;
  __syncthreads();

  for (int p = 0; p < n_pages; ++p) {
    const int page = table[(size_t)b * width + p];
    const int n = min(page_size, len - p * page_size);
    const size_t page_base = ((size_t)h * num_pages + page) * page_size;
    const T* kp = kpool + page_base * D;
    const T* vp = vpool + page_base * D;

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
        fa::unpack8<T>(raw[u], kf);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (r < rows) {
            const float* qq = sq + r * D + a_chunk;
            float dot = 0.f;
#pragma unroll
            for (int i = 0; i < 8; ++i) dot += qq[i] * kf[i];
#pragma unroll
            for (int off = kLanesPerTok / 2; off > 0; off >>= 1)
              dot += __shfl_xor_sync(0xffffffffu, dot, off);
            if (a_chunk == 0 && t < n) ss[r * page_size + t] = dot;
          }
        }
      }
    }
    __syncthreads();

    // (B) probabilities for this page against the running max.
    for (int r = warp; r < rows; r += kThreads / 32) {
      float* srow = ss + r * page_size;
      float mx = -INFINITY;
      for (int t = lane; t < n; t += 32) mx = fmaxf(mx, srow[t]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = sm[r];
      const float m_new = fmaxf(m_old, mx);
      float psum = 0.f;
      for (int t = lane; t < n; t += 32) {
        const float pr = exp2f((srow[t] - m_new) * c);
        psum += pr;
        // The PV product takes p rounded to the input dtype.
        srow[t] = fa::to_float<T>(fa::from_float<T>(pr));
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
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
          fa::unpack8<T>(raw[u], vf);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            if (r < rows) {
              const float pr = ss[r * page_size + t];
#pragma unroll
              for (int i = 0; i < 8; ++i) acc[r][i] += pr * vf[i];
            }
          }
        }
      }
    }
    __syncthreads();   // ss is rewritten by the next page's phase A
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
        o[(qrow0 + r) * D + tid] = fa::from_float<T>(l > 0.f ? sum / l : 0.f);
        if (tid == 0)
          lse[qrow0 + r] = sm[r] * scale + logf(l > 0.f ? l : 1.f);
      }
      __syncthreads();
    }
  }
}

template <typename T, int D, int R>
cudaError_t launch(const void* q, const void* kpool, const void* vpool,
                   const int* table, const int* lengths, void* o,
                   float* lse, int B, int Hq, int Hkv, int num_pages,
                   int page_size, int width, int rows, float scale,
                   cudaStream_t stream) {
  constexpr int kTokGroups = kThreads / (D / 8);
  const size_t bytes =
      sizeof(float) * (R * D + R * page_size + kTokGroups * D + 3 * R);
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<T, D, R>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(Hkv, B);
  paged_decode_kernel<T, D, R><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kpool),
      static_cast<const T*>(vpool), table, lengths, static_cast<T*>(o),
      lse, Hq, Hkv, num_pages, page_size, width, rows, scale);
  return cudaGetLastError();
}

// R: the smallest instantiated row bound >= the rows (config.PAGED_MAX_ROWS
// is the largest).
template <typename T, int D>
cudaError_t dispatch_rows(const void* q, const void* kpool,
                          const void* vpool, const int* table,
                          const int* lengths, void* o, float* lse, int B,
                          int Hq, int Hkv, int num_pages, int page_size,
                          int width, float scale, cudaStream_t stream) {
  const int rows = Hq / Hkv;
#define FA_PAGED_LAUNCH(RB)                                                 \
  if (rows <= RB)                                                           \
    return launch<T, D, RB>(q, kpool, vpool, table, lengths, o, lse, B, Hq, \
                            Hkv, num_pages, page_size, width, rows, scale,  \
                            stream);
  FA_PAGED_LAUNCH(2)
  FA_PAGED_LAUNCH(4)
  FA_PAGED_LAUNCH(8)
  FA_PAGED_LAUNCH(16)
#undef FA_PAGED_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int fa_paged_decode(const void* q, const void* kpool,
                               const void* vpool, const void* table,
                               const void* lengths, void* o, void* lse,
                               int B, int Hq, int Hkv, int num_pages,
                               int page_size, int width, int D, float scale,
                               int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(table);
  const int* ln = static_cast<const int*>(lengths);
  float* l = static_cast<float*>(lse);
  if (Hkv <= 0 || Hq % Hkv || page_size <= 0 || width <= 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == fa::kBFloat16) {
    if (D == 128)
      return (int)dispatch_rows<__nv_bfloat16, 128>(
          q, kpool, vpool, tb, ln, o, l, B, Hq, Hkv, num_pages, page_size,
          width, scale, s);
    if (D == 64)
      return (int)dispatch_rows<__nv_bfloat16, 64>(
          q, kpool, vpool, tb, ln, o, l, B, Hq, Hkv, num_pages, page_size,
          width, scale, s);
  } else if (dtype == fa::kFloat16) {
    if (D == 128)
      return (int)dispatch_rows<__half, 128>(q, kpool, vpool, tb, ln, o, l,
                                             B, Hq, Hkv, num_pages,
                                             page_size, width, scale, s);
    if (D == 64)
      return (int)dispatch_rows<__half, 64>(q, kpool, vpool, tb, ln, o, l,
                                            B, Hq, Hkv, num_pages,
                                            page_size, width, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
