// P2 v2: the probe scripts/probe_paged_int8.py's blocked int8 paged
// decode body, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_v2_kernel` (probe_paged_int8.py:76,
// launched at :145). It computes what B4's int8 branch computes
// (paged_decode.cu; the JAX `_paged_kernel`'s quantized body): for every
// sequence b and kv head h, attention of the G = Hq / Hkv query rows of
// the head's group over the first lengths[b] tokens of int8 K/V pools
// [Hkv, P, ps, D] with fp32 scales per (128-token block, channel)
// [Hkv, P, ps / 128, D], O [B, Hq, D] in bf16 and LSE [B, Hq] in fp32.
// The numerics are v2's: each 128-token block of K and V is dequantized
// to bf16 (code times scale in fp32, one rounding), the scores are fp32
// sums of bf16 products, P is rounded to bf16 before P V, the online
// softmax runs in fp32 over the live tokens, and a row with no token
// (l == 0) gives O = 0, LSE = INIT_M * scale. The port's wrapper is
// flash_attention_tpu_torch/scripts/probe_paged_int8.py `paged_int8_v2`;
// paged_flash_decode gains no option, as in JAX.
//
// What it changes against B4: the products go to the tensor cores. B4
// multiplies on the CUDA cores, each widened value feeding R fp32 FMAs,
// which holds its int8 body at 4.4x its bound at the probe's shape. Here
// one 256-thread block per (kv head, sequence) walks the sequence one
// 128-token quant block at a time:
//   * the block's int8 K and V rows are loaded into registers one block
//     ahead, widened and scaled into bf16 tiles in shared memory, double
//     buffered: block i + 1's widen is issued right after block i's P V
//     products, so the tensor cores' work and the widen overlap;
//   * S^T [128 tokens, 8] = K_i q^T with mma.sync m16n8k16: the tokens
//     on the M side (warp w takes tokens 16w..16w + 15), the group's q
//     rows on N (G <= 8 of the 8 columns; 4 at the probe's 32 / 8
//     heads), q's fragments loaded once;
//   * four warps take one q row each for the online softmax of the
//     block's 128 scores (tokens >= lengths[b] masked) and write P in
//     bf16;
//   * O^T [D, 8] += V_i^T P^T with mma.sync: V^T's fragments come from
//     the [token, channel] tile through ldmatrix.trans, warp w owns
//     channels 16w..16w + 15 and rescales its fp32 accumulators by the
//     row's alpha first.
// Three barriers a block: after S, after the softmax, after P V and the
// widen.
//
// What bounds it on the H100: bytes. At the probe's shape (B = 64, 32 q /
// 8 kv heads, D = 128, 4088 tokens a sequence) the live codes are 535.8
// MB plus 16.7 MB of scales: 0.165 ms at 3.35 TB/s; the 17.1 GFLOP are
// far below the tensor cores' rate. The block count (B * Hkv = 512 at
// 148 KB of shared memory each, one a SM) and the per-token widen set its
// pace; split-KV and a warp-specialised producer are the speed work.

#include <cuda_bf16.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;          // 8 warps
constexpr int kBlock = 128;            // tokens per quant block
constexpr int kN = 8;                  // MMA columns: the group's q rows

template <int D>
struct Smem {
  static constexpr int kLd = D + 8;          // K / V / q rows (bf16)
  static constexpr int kLdP = kBlock + 8;    // P rows (bf16)
  static constexpr int kLdS = kBlock + 4;    // S^T as [q row][token], fp32
  static constexpr size_t kKV = sizeof(bf16) * kBlock * kLd;
  static constexpr size_t kQ = 4 * kKV;      // K0, V0, K1, V1 first
  static constexpr size_t kP = kQ + sizeof(bf16) * kN * kLd;
  static constexpr size_t kS = kP + sizeof(bf16) * kN * kLdP;
  static constexpr size_t kStats = kS + sizeof(float) * kN * kLdS;
  static constexpr size_t kBytes = kStats + sizeof(float) * 3 * kN;
};

struct Args {
  const bf16* q;                  // [B, Hq, D]
  const signed char* kpool;       // [Hkv, P, ps, D]
  const signed char* vpool;
  const float* kscale;            // [Hkv, P, ps / 128, D]
  const float* vscale;
  const int* table;               // [B, width]
  const int* lengths;             // [B]
  bf16* o;                        // [B, Hq, D]
  float* lse;                     // [B, Hq]
  int B, Hq, Hkv, num_pages, page_size, width;
  float scale;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c[16 x 8] += a[16 x 16] b[16 x 8], bf16 in, fp32 sums.
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One quant block's int8 K and V rows, in flight in registers: thread t
// holds 16 channels [c, c + 16) (c = 16 (t % (D / 16))) of kPasses rows,
// and those channels' scales.
template <int D>
struct Codes {
  static constexpr int kChunks = D / 16;               // 16 codes a load
  static constexpr int kRowsPerPass = kThreads / kChunks;
  static constexpr int kPasses = kBlock / kRowsPerPass;
  uint4 k[kPasses], v[kPasses];
  float4 ks[4], vs[4];

  // Block j of sequence b, kv head h.
  __device__ __forceinline__ void load(const Args& a, const int* table,
                                       int h, int j) {
    const int tid = threadIdx.x;
    const int pos = j * kBlock;
    const size_t page =
        (size_t)h * a.num_pages + table[pos / a.page_size];
    const int off = pos % a.page_size;
    const size_t row0 = page * a.page_size + off;
    const size_t srow =
        (page * (a.page_size / kBlock) + off / kBlock) * D;
    const int c = (tid % kChunks) * 16;
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const size_t at = (row0 + tid / kChunks + p * kRowsPerPass) * D + c;
      k[p] = *reinterpret_cast<const uint4*>(a.kpool + at);
      v[p] = *reinterpret_cast<const uint4*>(a.vpool + at);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      ks[i] = *reinterpret_cast<const float4*>(a.kscale + srow + c + 4 * i);
      vs[i] = *reinterpret_cast<const float4*>(a.vscale + srow + c + 4 * i);
    }
  }

  // Codes times scales, rounded to bf16, into the [kBlock][kLd] tiles.
  __device__ __forceinline__ void widen(bf16* sk, bf16* sv) const {
    constexpr int kLd = Smem<D>::kLd;
    const int tid = threadIdx.x;
    const int c = (tid % kChunks) * 16;
    const float* ksf = reinterpret_cast<const float*>(ks);
    const float* vsf = reinterpret_cast<const float*>(vs);
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const int r = tid / kChunks + p * kRowsPerPass;
      const signed char* kb = reinterpret_cast<const signed char*>(&k[p]);
      const signed char* vb = reinterpret_cast<const signed char*>(&v[p]);
      float kf[16], vf[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        kf[e] = static_cast<float>(kb[e]) * ksf[e];
        vf[e] = static_cast<float>(vb[e]) * vsf[e];
      }
      fa::store_scaled<bf16, 16>(sk + r * kLd + c, kf, 1.f);
      fa::store_scaled<bf16, 16>(sv + r * kLd + c, vf, 1.f);
    }
  }
};

template <int D>
__global__ void __launch_bounds__(kThreads)
paged_int8_v2_kernel(const Args a) {
  using L = Smem<D>;
  constexpr int kLd = L::kLd, kLdP = L::kLdP, kLdS = L::kLdS;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK[2] = {reinterpret_cast<bf16*>(smem),
                 reinterpret_cast<bf16*>(smem + 2 * L::kKV)};
  bf16* sV[2] = {reinterpret_cast<bf16*>(smem + L::kKV),
                 reinterpret_cast<bf16*>(smem + 3 * L::kKV)};
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::kQ);
  bf16* sP = reinterpret_cast<bf16*>(smem + L::kP);
  float* sS = reinterpret_cast<float*>(smem + L::kS);
  float* sm = reinterpret_cast<float*>(smem + L::kStats);
  float* sl = sm + kN;
  float* salpha = sl + kN;

  const int h = blockIdx.x, b = blockIdx.y;
  const int G = a.Hq / a.Hkv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int len = max(0, min(a.lengths[b], a.width * a.page_size));
  const int nblk = (len + kBlock - 1) / kBlock;
  const int* table = a.table + (size_t)b * a.width;
  const size_t qrow0 = (size_t)b * a.Hq + (size_t)h * G;
  const float c = a.scale * fa::kLog2e;

  for (int i = tid; i < kN * D; i += kThreads) {
    const int g = i / D, d = i % D;
    sQ[g * kLd + d] =
        g < G ? a.q[(qrow0 + g) * D + d] : __float2bfloat16(0.f);
  }
  for (int i = tid; i < kN * kLdP; i += kThreads)
    sP[i] = __float2bfloat16(0.f);
  if (tid < kN) {
    sm[tid] = fa::kInitM;
    sl[tid] = 0.f;
    salpha[tid] = 1.f;
  }
  Codes<D> codes;
  if (nblk > 0) {
    codes.load(a, table, h, 0);
    codes.widen(sK[0], sV[0]);
    if (nblk > 1) codes.load(a, table, h, 1);
  }
  __syncthreads();

  // q^T as B fragments: k-steps 2i and 2i + 1 in qb[i].
  uint32_t qb[D / 32][4];
#pragma unroll
  for (int i = 0; i < D / 32; ++i)
    ldsm_x4(qb[i], sQ + (lane % 8) * kLd + i * 32 + (lane / 8) * 8);

  static_assert(D % 128 == 0, "eight warps of 16 channels");
  float acc[D / 128][4] = {};   // O^T: this warp's channel tiles
  for (int j = 0; j < nblk; ++j) {
    const int cur = j & 1;
    // S^T for tokens 16 warp .. + 16 of block j.
    {
      float s[4] = {0.f, 0.f, 0.f, 0.f};
      const bf16* kt =
          sK[cur] + (16 * warp + lane % 16) * kLd + (lane / 16) * 8;
#pragma unroll
      for (int i = 0; i < D / 32; ++i) {
        uint32_t af[4];
        ldsm_x4(af, kt + i * 32);
        mma_bf16(s, af, qb[i][0], qb[i][1]);
        ldsm_x4(af, kt + i * 32 + 16);
        mma_bf16(s, af, qb[i][2], qb[i][3]);
      }
      const int t = 16 * warp + gid, g = 2 * tig;
      sS[g * kLdS + t] = s[0];
      sS[(g + 1) * kLdS + t] = s[1];
      sS[g * kLdS + t + 8] = s[2];
      sS[(g + 1) * kLdS + t + 8] = s[3];
    }
    __syncthreads();

    // Online softmax: warp g takes q row g.
    if (warp < G) {
      const int g = warp;
      const int base = j * kBlock;
      float sv[kBlock / 32];
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < kBlock / 32; ++i) {
        const int t = lane + 32 * i;
        sv[i] = base + t < len ? sS[g * kLdS + t] : -INFINITY;
        mx = fmaxf(mx, sv[i]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = sm[g];
      const float m_new = fmaxf(m_old, mx);
      float psum = 0.f;
#pragma unroll
      for (int i = 0; i < kBlock / 32; ++i) {
        const float p = exp2f((sv[i] - m_new) * c);
        psum += p;
        sP[g * kLdP + lane + 32 * i] = __float2bfloat16_rn(p);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, o);
      if (lane == 0) {
        const float alpha = exp2f((m_old - m_new) * c);
        salpha[g] = alpha;
        sl[g] = sl[g] * alpha + psum;
        sm[g] = m_new;
      }
    }
    __syncthreads();

    // O^T = alpha O^T + V^T P^T for channels 16 (warp + 8 n) .. + 16.
    {
      const float a0 = salpha[2 * tig], a1 = salpha[2 * tig + 1];
      const int mi = lane / 8;
#pragma unroll
      for (int n = 0; n < D / 128; ++n) {
        acc[n][0] *= a0;
        acc[n][1] *= a1;
        acc[n][2] *= a0;
        acc[n][3] *= a1;
        const bf16* vt = sV[cur] + ((lane % 8) + (mi / 2) * 8) * kLd +
                         16 * (warp + 8 * n) + (mi % 2) * 8;
#pragma unroll
        for (int i = 0; i < kBlock / 32; ++i) {
          uint32_t pb[4], af[4];
          ldsm_x4(pb, sP + (lane % 8) * kLdP + i * 32 + (lane / 8) * 8);
          ldsm_x4_trans(af, vt + (32 * i) * kLd);
          mma_bf16(acc[n], af, pb[0], pb[1]);
          ldsm_x4_trans(af, vt + (32 * i + 16) * kLd);
          mma_bf16(acc[n], af, pb[2], pb[3]);
        }
      }
    }
    // Block j + 1 into the other buffers (its last readers finished
    // before this block's first barrier), block j + 2 into registers.
    if (j + 1 < nblk) {
      codes.widen(sK[cur ^ 1], sV[cur ^ 1]);
      if (j + 2 < nblk) codes.load(a, table, h, j + 2);
    }
    __syncthreads();
  }

  // O = O^T / l, transposed back; LSE.
#pragma unroll
  for (int n = 0; n < D / 128; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int g = 2 * tig + (e & 1);
      const int d = 16 * (warp + 8 * n) + gid + (e >> 1) * 8;
      if (g < G) {
        const float l = sl[g];
        a.o[(qrow0 + g) * D + d] =
            __float2bfloat16_rn(l > 0.f ? acc[n][e] / l : 0.f);
      }
    }
  }
  if (tid < G) {
    const float l = sl[tid];
    a.lse[qrow0 + tid] =
        l > 0.f ? sm[tid] * a.scale + logf(l) : fa::kInitM * a.scale;
  }
}

template <int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr size_t kBytes = Smem<D>::kBytes;
  static_assert(kBytes <= 232448, "P2 v2 tiles exceed shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      paged_int8_v2_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kBytes);
  if (err != cudaSuccess) return err;
  paged_int8_v2_kernel<D><<<dim3(a.Hkv, a.B), kThreads, kBytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// q bf16 [B, Hq, D]; int8 pools [Hkv, P, ps, D] with fp32 scales [Hkv, P,
// ps / 128, D]; page_table int32 [B, width]; lengths int32 [B]; o bf16
// [B, Hq, D]; lse fp32 [B, Hq]. Hq / Hkv <= 8, ps a multiple of 128,
// D = 128.
extern "C" int fa_probe_paged_int8_v2(
    const void* q, const void* kpool, const void* vpool, const void* kscale,
    const void* vscale, const void* table, const void* lengths, void* o,
    void* lse, int B, int Hq, int Hkv, int num_pages, int page_size,
    int width, int D, float scale, void* stream) {
  if (Hkv <= 0 || Hq % Hkv || Hq / Hkv > kN || page_size <= 0 ||
      page_size % kBlock || width <= 0 || D != 128)
    return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const bf16*>(q),
               static_cast<const signed char*>(kpool),
               static_cast<const signed char*>(vpool),
               static_cast<const float*>(kscale),
               static_cast<const float*>(vscale),
               static_cast<const int*>(table),
               static_cast<const int*>(lengths), static_cast<bf16*>(o),
               static_cast<float*>(lse), B, Hq, Hkv, num_pages, page_size,
               width, scale};
  return (int)launch<128>(a, static_cast<cudaStream_t>(stream));
}
