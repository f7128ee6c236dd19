// The B1 forward kernel for fp16 / bf16 (flash_fwd.cu), instantiated per
// compute type, head dim and K/V storage: flash_fwd.cu holds the dense
// instantiations and the C entry point, flash_fwd_int8.cu,
// flash_fwd_e4m3.cu and flash_fwd_e5m2.cu the quantized ones, and
// flash_fwd_f32.cu the fp32 body (dense K/V only).
#pragma once

#include <climits>

#include "sm90_attn.cuh"

namespace fa {
namespace fwd {

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
  // none; kSplitBulk the mask-free pass over the kv columns below each
  // 64-row q tile's band, [0, (q0 / band) * band); kSplitBand the causal
  // pass over the band itself, [(q0 / band) * band, + band). band is a
  // multiple of 64.
  int split, band;
  float scale;
  cudaStream_t stream;
};

constexpr int kSplitBulk = 1;
constexpr int kSplitBand = 2;

// The kv columns [lo, hi) that rows [r0, r0 + 64) can see (before the
// per-element masks); false when no row of them is real.
__device__ __forceinline__ bool row_range(const Args& a, int r0, int& lo,
                                          int& hi) {
  if (r0 >= a.Nq) return false;
  const int last = min(r0 + 64, a.Nq) - 1;
  lo = 0;
  hi = a.Nk;
  if (a.causal) hi = min(a.Nk, last + a.offset + 1);
  if (a.window > 0) lo = max(r0 + a.offset - a.window + 1, 0);
  if (a.split) {
    const int band0 = r0 / a.band * a.band;
    if (a.split == kSplitBulk) {
      hi = min(hi, band0);
    } else {
      lo = band0;
      hi = min(hi, band0 + a.band);
    }
  }
  return true;
}

// Tiles and shared memory of one instantiation. A block is kWG consumer
// warpgroups of 64 q rows each (threads [0, 128 kWG)), then the
// producer: one TMA warp, or four converter warps (thread 0 issuing the
// TMA loads) for the quantized storages. ptxas allots a block of 9 to 12
// warps 168 registers a thread (65536 / 384), a block of 5 to 8 warps
// 255: at D = 256, where O alone is 128 registers a thread, a block has
// one consumer warpgroup.
template <typename T, int D, int Store>
struct Cfg {
  static constexpr bool kQuant = Store != kDense;
  static constexpr int kWG = D > 128 ? 1 : 2;
  static constexpr int kBM = 64 * kWG;              // q rows a block
  static constexpr int kBC = D > 128 ? 64 : 128;    // kv rows a tile
  static constexpr int kStages = 2;                 // K/V ring
  static constexpr int kCodeStages = kQuant ? 2 : 0;   // codes ring
  static constexpr int kConsumers = 128 * kWG;
  static constexpr int kThreads = kConsumers + (kQuant ? 128 : 32);
  static constexpr uint32_t kQBytes = kBM * D * 2;
  static constexpr uint32_t kTileBytes = kBC * D * 2;   // K or V in T
  static constexpr uint32_t kCodeBytes = kBC * D;       // K or V codes
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kK = kQ + kQBytes;
  static constexpr uint32_t kV = kK + kStages * kTileBytes;
  static constexpr uint32_t kCodes = kV + kStages * kTileBytes;
  static constexpr uint32_t kBars = kCodes + kCodeStages * 2 * kCodeBytes;
  // q_full, full[S], empty[S], code_full[CS]
  static constexpr int kNumBars = 1 + 2 * kStages + kCodeStages;
  static constexpr uint32_t kBytes = kBars + 8 * kNumBars + 1024;
  static_assert(kBytes <= 232448, "B1 tiles exceed shared memory");
};

// The converters' share of one K or V tile of codes: each code times the
// fp32 scale row of its 128-row block (scales [Nk / 128, D] of this kv
// head) in fp32, rounded to T and stored swizzled -- the rounding of the
// plain version's dequantized tile. Converter ct of 128 owns one
// 8-column group and every (128 / (D / 8))-th row.
template <typename T, int D, int BC, int Store>
__device__ __forceinline__ void widen_tile(unsigned char* dst,
                                           const unsigned char* codes,
                                           const float* srow, int ct) {
  constexpr int kGroups = D / 8;
  constexpr int kRowStep = 128 / kGroups;
  const int g = ct % kGroups;
  float sc[8];
  const float4 s0 = __ldg(reinterpret_cast<const float4*>(srow + g * 8));
  const float4 s1 = __ldg(reinterpret_cast<const float4*>(srow + g * 8 + 4));
  sc[0] = s0.x; sc[1] = s0.y; sc[2] = s0.z; sc[3] = s0.w;
  sc[4] = s1.x; sc[5] = s1.y; sc[6] = s1.z; sc[7] = s1.w;
#pragma unroll
  for (int r = ct / kGroups; r < BC; r += kRowStep) {
    float x[8];
    widen8_fast<Store>(
        *reinterpret_cast<const uint2*>(codes + r * D + g * 8), x);
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] *= sc[e];
    *reinterpret_cast<uint4*>(dst + sm90::Sw<D>::offset(BC, r, g * 8)) =
        pack8<T>(x);
  }
}

template <typename T, int D, int Store>
__global__ void __launch_bounds__(Cfg<T, D, Store>::kThreads, 1)
    flash_fwd_sm90(const __grid_constant__ sm90::QkvMaps maps, const Args a) {
  using C = Cfg<T, D, Store>;
  constexpr int kBC = C::kBC, kS = C::kStages, kCS = C::kCodeStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = sm90::align_smem(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + C::kBars);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kS;
  uint64_t* code_full = empty + kS;

  // Heaviest causal tiles first: the last q tile starts first.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * C::kBM;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const int kv_head = b * a.Hkv + hk;

  // The block's kv tiles: every column a consumer warpgroup's rows can
  // see, from the first tile of the lowest range to the highest end.
  int lo_blk = INT_MAX, hi_blk = INT_MIN;
#pragma unroll
  for (int w = 0; w < C::kWG; ++w) {
    int lo, hi;
    if (row_range(a, q0 + 64 * w, lo, hi) && hi > lo) {
      lo_blk = min(lo_blk, lo);
      hi_blk = max(hi_blk, hi);
    }
  }
  const int j_first = hi_blk > lo_blk ? lo_blk / kBC * kBC : 0;
  const int n_tiles =
      hi_blk > lo_blk ? (hi_blk - j_first + kBC - 1) / kBC : 0;

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < kS; ++s) {
      // Dense: the TMA thread's arrival; quantized: the 128 converters'.
      sm90::mbar_init(&full[s], C::kQuant ? 128 : 1);
      sm90::mbar_init(&empty[s], 4 * C::kWG);   // one per consumer warp
    }
    for (int s = 0; s < kCS; ++s) sm90::mbar_init(&code_full[s], 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= C::kConsumers) {
    // --- producer ---
    const int pt = threadIdx.x - C::kConsumers;
    if (pt == 0) {
      sm90::mbar_expect_tx(q_full, C::kQBytes);
      sm90::load_tile<D>(smem + C::kQ, &maps.q, q_full, C::kBM, q0,
                         b * a.Hq + h);
    }
    if constexpr (!C::kQuant) {
      // One TMA thread keeps the K/V ring full.
      if (pt != 0) return;
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kS;
        const int j0 = j_first + it * kBC;
        sm90::mbar_wait(&empty[s], ((it / kS) & 1) ^ 1);
        sm90::mbar_expect_tx(&full[s], 2 * C::kTileBytes);
        sm90::load_tile<D>(smem + C::kK + s * C::kTileBytes, &maps.k,
                           &full[s], kBC, j0, kv_head);
        sm90::load_tile<D>(smem + C::kV + s * C::kTileBytes, &maps.v,
                           &full[s], kBC, j0, kv_head);
      }
    } else {
      // Four converter warps turn the codes ring into the T ring; their
      // thread 0 refills a codes slot once all 128 have read it.
      auto load_codes = [&](int it) {
        const int cs = it % kCS;
        unsigned char* codes = smem + C::kCodes + cs * 2 * C::kCodeBytes;
        const int j0 = j_first + it * kBC;
        sm90::mbar_expect_tx(&code_full[cs], 2 * C::kCodeBytes);
        sm90::tma_load_3d(codes, &maps.k, &code_full[cs], 0, j0, kv_head);
        sm90::tma_load_3d(codes + C::kCodeBytes, &maps.v, &code_full[cs], 0,
                          j0, kv_head);
      };
      if (pt == 0)
        for (int it = 0; it < kCS && it < n_tiles; ++it) load_codes(it);
      const size_t srow0 = (size_t)kv_head * (a.Nk / 128);
      for (int it = 0; it < n_tiles; ++it) {
        const int j0 = j_first + it * kBC;
        const int s = it % kS, cs = it % kCS;
        const unsigned char* codes =
            smem + C::kCodes + cs * 2 * C::kCodeBytes;
        sm90::mbar_wait(&code_full[cs], (it / kCS) & 1);
        sm90::mbar_wait(&empty[s], ((it / kS) & 1) ^ 1);
        const size_t srow = (srow0 + j0 / 128) * D;
        widen_tile<T, D, kBC, Store>(smem + C::kK + s * C::kTileBytes, codes,
                                     a.kscale + srow, pt);
        widen_tile<T, D, kBC, Store>(smem + C::kV + s * C::kTileBytes,
                                     codes + C::kCodeBytes, a.vscale + srow,
                                     pt);
        sm90::fence_async_smem();
        sm90::mbar_arrive(&full[s]);
        // Every converter is done reading codes slot cs.
        asm volatile("bar.sync 1, 128;\n" ::: "memory");
        if (pt == 0 && it + kCS < n_tiles) load_codes(it + kCS);
      }
    }
    return;
  }

  // --- consumer warpgroups: 64 q rows each ---
  const int cw = threadIdx.x / 128;
  const int t = threadIdx.x % 128, lane = threadIdx.x % 32;
  const sm90::Frag f(t);
  const int q0w = q0 + 64 * cw;
  const int row0 = q0w + f.row;   // this thread's rows: row0, row0 + 8
  int lo = 0, hi = 0;
  const bool live = row_range(a, q0w, lo, hi) && hi > lo;
  const int Nq = a.Nq, Nk = a.Nk, causal = a.causal, offset = a.offset;
  const int window = a.window;
  const int* __restrict__ kvseg =
      a.kvseg != nullptr ? a.kvseg + (size_t)b * Nk : nullptr;
  int seg[2] = {0, 0};
  if (kvseg != nullptr) {
    if (row0 < Nq) seg[0] = a.qseg[(size_t)b * Nq + row0];
    if (row0 + 8 < Nq) seg[1] = a.qseg[(size_t)b * Nq + row0 + 8];
  }
  const uint32_t sq = sm90::smem_u32(smem + C::kQ);
  const uint32_t sk = sm90::smem_u32(smem + C::kK);
  const uint32_t sv = sm90::smem_u32(smem + C::kV);
  const float c = a.scale * kLog2e;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {kInitM, kInitM};   // running max of the raw scores
  float l[2] = {0.f, 0.f};         // this thread's share of the row sums

  sm90::mbar_wait(q_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kS;
    const int j0 = j_first + it * kBC;
    sm90::mbar_wait(&full[s], (it / kS) & 1);
    if (live && j0 < hi && j0 + kBC > lo) {
      float sc[kBC / 2];
      sm90::wgmma_fence();
      sm90::qk<T, D, kBC>(sc, sq, C::kBM, 64 * cw, sk + s * C::kTileBytes);
      sm90::wgmma_commit();
      sm90::wgmma_wait();
      sm90::fence_regs(sc);

      // Masks only on the tiles that need them: a range edge (window
      // start, causal end, split bounds, ragged Nk), the causal
      // diagonal, the window's edge, segment ids.
      const bool edge =
          kvseg != nullptr || j0 < lo || j0 + kBC > hi ||
          (causal && j0 + kBC - 1 > q0w + offset) ||
          (window > 0 && j0 <= q0w + 63 + offset - window);
      if (edge) {
#pragma unroll
        for (int jb = 0; jb < kBC / 8; ++jb) {
          const int col0 = j0 + f.col_of(4 * jb);
          int ks[2] = {0, 0};
          if (kvseg != nullptr) {
            if (col0 < Nk) ks[0] = kvseg[col0];
            if (col0 + 1 < Nk) ks[1] = kvseg[col0 + 1];
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = col0 + (e & 1);
            const int row = row0 + sm90::Frag::row_of(e);
            const bool ok =
                col >= lo && col < hi && (!causal || col <= row + offset) &&
                (window <= 0 || col > row + offset - window) &&
                (kvseg == nullptr || ks[e & 1] == seg[e >> 1]);
            if (!ok) sc[4 * jb + e] = -INFINITY;
          }
        }
      }

      // Online softmax in registers (exp2, the scale folded in).
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < kBC / 2; ++i)
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      float alpha[2], mc[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = sm90::quad_max(mx[r]);
        alpha[r] = sm90::ex2((m[r] - mx[r]) * c);
        m[r] = mx[r];
        mc[r] = mx[r] * c;
      }
      uint32_t p[kBC / 4];
      float ls[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < kBC / 4; ++j) {
        const int r = j & 1;
        const float e0 = sm90::ex2(fmaf(sc[2 * j], c, -mc[r]));
        const float e1 = sm90::ex2(fmaf(sc[2 * j + 1], c, -mc[r]));
        ls[r] += e0 + e1;
        p[j] = sm90::pack2<T>(e0, e1);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + ls[r];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

      sm90::wgmma_fence();
      sm90::pv<T, D, kBC>(o, p, sv + s * C::kTileBytes);
      sm90::wgmma_commit();
      sm90::wgmma_wait();
      sm90::fence_regs(o);
      sm90::fence_regs(p);
    }
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[s]);
  }

  // O / l in T; LSE in fp32 (a row that saw nothing: O = 0, LSE = INIT_M
  // * scale).
  const size_t qbase = ((size_t)b * a.Hq + h) * Nq;
  T* __restrict__ og = static_cast<T*>(a.o) + qbase * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const float lr = sm90::quad_sum(l[r]);
    if (row >= Nq) continue;
    const float inv = lr > 0.f ? 1.f / lr : 0.f;
#pragma unroll
    for (int jb = 0; jb < D / 8; ++jb) {
      const int i = 4 * jb + 2 * r;
      *reinterpret_cast<uint32_t*>(og + (size_t)row * D + f.col_of(4 * jb)) =
          sm90::pack2<T>(o[i] * inv, o[i + 1] * inv);
    }
    if ((t & 3) == 0)
      a.lse[qbase + row] =
          lr > 0.f ? m[r] * a.scale + logf(lr) : kInitM * a.scale;
  }
}

template <typename T, int D, int Store>
cudaError_t launch(const Args& a) {
  using C = Cfg<T, D, Store>;
  auto kernel = flash_fwd_sm90<T, D, Store>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kBytes);
  if (err != cudaSuccess) return err;
  sm90::QkvMaps maps{};
  bool ok = sm90::encode_tile_map<T, D>(&maps.q, a.q, a.B * a.Hq, a.Nq,
                                        C::kBM);
  if (a.Nk > 0) {
    const int heads = a.B * a.Hkv;
    if constexpr (C::kQuant) {
      ok = ok &&
           sm90::encode_map(&maps.k, a.k, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1,
                            heads, a.Nk, D, D, C::kBC,
                            CU_TENSOR_MAP_SWIZZLE_NONE) &&
           sm90::encode_map(&maps.v, a.v, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1,
                            heads, a.Nk, D, D, C::kBC,
                            CU_TENSOR_MAP_SWIZZLE_NONE);
    } else {
      ok = ok &&
           sm90::encode_tile_map<T, D>(&maps.k, a.k, heads, a.Nk, C::kBC) &&
           sm90::encode_tile_map<T, D>(&maps.v, a.v, heads, a.Nk, C::kBC);
    }
  }
  if (!ok) return cudaErrorInvalidValue;
  dim3 grid((a.Nq + C::kBM - 1) / C::kBM, a.Hq, a.B);
  kernel<<<grid, C::kThreads, C::kBytes, a.stream>>>(maps, a);
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

// Defined in flash_fwd_int8.cu, flash_fwd_e4m3.cu, flash_fwd_e5m2.cu.
cudaError_t dispatch_int8(const Args& a, int dtype, int D);
cudaError_t dispatch_e4m3(const Args& a, int dtype, int D);
cudaError_t dispatch_e5m2(const Args& a, int dtype, int D);
// Defined in flash_fwd_f32.cu: fp32 q / k / v, dense.
cudaError_t dispatch_f32(const Args& a, int D);

}  // namespace fwd
}  // namespace fa
