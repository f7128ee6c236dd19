// P1: the int4 unpack variants of the probe
// scripts/probe_int4_variants.py, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `k_v1_float` (probe_int4_variants.py:87)
// and `k_v2_int` (:125), launched through `_call` (:69). Both compute
// y = x @ ((b - 8) * sc) for offset-binary int4 weights: b = q + 8 in
// [1, 15], packed two a byte as B7's weights are (byte j of a column =
// logical rows 2j, low nibble, and 2j + 1, high nibble), with one fp32
// scale per 128 rows and column (the scales of quantize_weight_int4).
// The port's wrapper is flash_attention_tpu_torch/scripts/
// probe_int4_variants.py `int4_variant_matmul`; the question the probe
// asks is whether B7's nibble unpack is what holds B7 at its time.
//
// Two bodies, chosen before the launch (scripts/_common.py
// int4_probe_body, by ops/quant_matmul.py tma_ready):
//  - the split-K decode body of matmul_sm90.cuh whenever TMA can address
//    x, the packed weight and its scales (16-byte aligned bases, F % 16):
//    v2 in probe_int4_v2_sm90.cu, v1 in probe_int4_v1_sm90.cu, x in
//    64-row slices, K split by decode_split_plan (2 splits of 3456 rows at
//    the probe's shape: 448 blocks, two resident an SM), TMA rings of
//    codes, scale rows and x, wgmma with fp32 accumulators in registers,
//    fixed-order split sums (identical bits on a rerun). v1's correction
//    grows a stage at a time in registers beside the accumulators (each
//    K step is one 128-row scale group: the landed x stage's row sums,
//    which the converter warps take beside the widening, times the
//    stage's bf16 scale row) and each split's partial carries its own;
//  - the first body (this file), B7's old one, for operands TMA cannot
//    address (matmul_core.cuh `accumulate_tile`: a 64 x 64 tile of y per
//    128-thread block, K in steps of one 128-row scale group, WMMA bf16
//    products with fp32 sums), counted in the wrapper's
//    first_body_launches.
// Only the widening differs between v1 and v2:
//   v2, int domain (kInt4Ob): (u & 0xF) - 8 per nibble, converted to
//      fp32, times the scale, rounded to bf16 -- B7's unpack without its
//      sign xor;
//   v1, float domain (kInt4ObBias): no integer subtract. prmt places two
//      bytes in the low bytes of a word's half-words, one lop3 masks a
//      nibble into the mantissa of a bf16 whose exponent encodes 128, so
//      each half is the exact bf16 128 + b; one packed fma with the
//      bf16-rounded scale s_b gives (128 + b) s_b - 128 s_b = b s_b,
//      rounded once. The - 8 stays in the weight: a per-group correction
//      accumulates (sum over the group of x) * s_b per (row, column) in
//      fp32 registers beside the products (`BiasCorrection`), and the
//      store subtracts 8 times it, as the probe's correction dot does. v1
//      rounds b s_b (b up to 15) where v2 rounds (b - 8) s, so its error
//      is larger by design.
//
// What bounds it on the H100: bytes at the probe's shape (M = 32, K =
// 4096, F = 14336): 29.4 MB of packed weights and 1.8 MB of scales,
// 0.0095 ms at 3.35 TB/s (3.8 GFLOP, 0.0038 ms at 989 TFLOP/s).

#include "matmul_core.cuh"
#include "matmul_sm90.cuh"

namespace {

using namespace fa_mm;
using bf16 = __nv_bfloat16;

// v1's correction: c[j] += (sum of row r of the step's x tile) * s_b[col
// j] in fp32, in registers. Thread pair (2r, 2r + 1) sums half a row
// each, in a fixed order, and keeps half the row's columns.
struct BiasCorrection {
  float c[kBN / 2] = {};

  __device__ __forceinline__ void operator()(int, const bf16* sX,
                                             const float* sScale) {
    constexpr int kLdX = Tile<bf16>::kLdX;
    const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
    const bf16* xr = sX + r * kLdX + half * (kBK / 2);
    float xs = 0.f;
#pragma unroll 16
    for (int k = 0; k < kBK / 2; ++k) xs += __bfloat162float(xr[k]);
    xs += __shfl_xor_sync(0xffffffffu, xs, 1);
#pragma unroll
    for (int j = 0; j < kBN / 2; ++j)
      c[j] += xs * fa::round_to<bf16>(sScale[half * (kBN / 2) + j]);
  }
};

template <int W>
__global__ void __launch_bounds__(kThreads)
probe_int4_kernel(const bf16* __restrict__ x,
                  const unsigned char* __restrict__ w,
                  const float* __restrict__ scale, bf16* __restrict__ y,
                  int M, int K, int F, int x_vec, int w_vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int f0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  Sums<bf16> acc;
  acc.zero(smem);
  if constexpr (W == kInt4ObBias) {
    BiasCorrection corr;
    accumulate_tile<bf16, W, false>(x, w, scale, 0, M, K, F, m0, f0, x_vec,
                                    w_vec, smem, acc, corr);
    const float* sO = sums_to_smem<bf16>(acc, smem);
    const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
    const int row = m0 + r;
#pragma unroll
    for (int j = 0; j < kBN / 2; ++j) {
      const int c = half * (kBN / 2) + j;
      if (row < M && f0 + c < F)
        y[(size_t)row * F + f0 + c] = __float2bfloat16_rn(
            sO[r * kLdO + c] - 8.f * corr.c[j]);
    }
  } else {
    accumulate_tile<bf16, W, false>(x, w, scale, 0, M, K, F, m0, f0, x_vec,
                                    w_vec, smem, acc);
    store_tile<bf16>(acc, smem, y, nullptr, M, F, m0, f0);
  }
}

template <int W>
cudaError_t launch(const void* x, const void* w, const void* scale, void* y,
                   int M, int K, int F, cudaStream_t stream) {
  constexpr size_t bytes = Tile<bf16>::kBytes;
  cudaError_t err = allow_smem(probe_int4_kernel<W>, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((F + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  probe_int4_kernel<W><<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const unsigned char*>(w),
      static_cast<const float*>(scale), static_cast<bf16*>(y), M, K, F,
      (int)x_aligned<bf16>(x, K), (int)w_aligned<bf16, W>(w, F));
  return cudaGetLastError();
}

}  // namespace

// x [M, K] bf16, w packed offset-binary int4 [K/2, F], scale fp32
// [K/128, F], y [M, F] bf16; variant 1 (float domain) or 2 (int domain);
// body hopper::kFirstBody (the kernel above) or kDecodeBody
// (matmul_sm90.cuh) with splits and k_chunk from decode_split_plan and,
// for splits > 1, ws [splits, M, F] fp32 and counters [ceil(M / 64) x
// ceil(F / 64)] int32, zero between launches.
extern "C" int fa_probe_int4_matmul(const void* x, const void* w,
                                    const void* scale, void* y, int M,
                                    int K, int F, int variant, int body,
                                    int splits, int k_chunk, void* ws,
                                    void* counters, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || K <= 0 || F <= 0 || K % kGroup || scale == nullptr ||
      (variant != 1 && variant != 2))
    return (int)cudaErrorInvalidValue;
  if (body == hopper::kFirstBody)
    return (int)(variant == 1
                     ? launch<kInt4ObBias>(x, w, scale, y, M, K, F, s)
                     : launch<kInt4Ob>(x, w, scale, y, M, K, F, s));
  if (body != hopper::kDecodeBody || splits < 1 || k_chunk <= 0 ||
      k_chunk % kGroup || (long)(splits - 1) * k_chunk >= K ||
      (long)splits * k_chunk < K ||
      (splits > 1 && (ws == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  hopper::Args a{};
  a.y = y;
  a.ws = static_cast<float*>(ws);
  a.counters = static_cast<int*>(counters);
  a.M = M;
  a.K = K;
  a.F = F;
  a.E = 1;
  a.k_chunk = k_chunk;
  return (int)(variant == 1 ? hopper::probe_int4_v1(x, w, scale, a, splits, s)
                            : hopper::probe_int4_v2(x, w, scale, a, splits,
                                                    s));
}
