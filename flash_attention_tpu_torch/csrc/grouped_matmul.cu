// B9: ragged grouped matrix product over expert-sorted rows for Hopper
// (sm_90a): y[i] = x[i] @ W[g(i)], templated over {fp16, bf16}
// activations and {dense, int8, e4m3, e5m2, int4} expert stacks.
//
// Replaces the Pallas TPU kernel `_grouped_kernel` of
// flash_attention_tpu/ops/grouped.py (:132, launched at :283), which runs
// the dropless MoE FFN (models/moe.py `moe_mlp_grouped`): three launches
// per MoE layer (w_gate, w_up, w_down) for a dispatch of at least
// GROUPED_MIN_TOKENS tokens.
//
// Semantics: rows are sorted by group; offsets [E + 1] (device memory,
// int32: [0, cumsum(group_sizes)] + base) give group g the rows
// [offsets[g], offsets[g + 1]). Rows outside [offsets[0], offsets[E])
// come back zero. x [M, K]; W dense [E, K, F] in x's type, int8 / fp8
// [E, K, F] with fp32 scales [E, F], or packed int4 [E, K/2, F] (byte j
// = logical rows 2j, low nibble, and 2j + 1, high nibble) with fp32
// scales [E, K/128, F]. fp32 sums, y in x's type.
//
// Numerics (the JAX kernel's): an int8 / fp8 weight is multiplied by its
// (expert, channel) scale in fp32 and rounded to the activation type
// before the product -- the scale enters in the loop, not at the store,
// so the kernel rounds where the JAX kernel and the plain version
// (ops/grouped.py) do; an int4 value is multiplied by its group scale
// in fp32 and rounded likewise.
//
// Schedule. The grid is sized from M and F alone -- one 128-thread block
// per 64 x 64 tile of y -- so the group offsets never leave the device
// (no host sync in an MoE layer). A block reads the E + 1 offsets, and
// for each expert whose row range meets its 64 rows runs the shared
// weight-widening K loop (matmul_core.cuh `accumulate_tile`, the body of
// B6-B8) on that expert's weight with the other rows masked to zero,
// summing into one set of fragments: a tile that straddles experts
// loops over them, an empty expert or one outside the tile costs
// nothing, and a tile past the data stores zeros. This replaces the TPU
// grid's visit plan (`make_visit_plan`), its padding of x and W (masked
// loads here) and its even/odd split of x for int4 (x is read at full
// width).
//
// What bounds it on the H100. Prefill (a 4096-token bucket, M = 8192
// sorted rows, Mixtral w_gate 4096 x 14336): operations, 0.96 TFLOP =
// 0.97 ms at 989 TFLOP/s. Decode-shaped dispatches (16 rows): bytes --
// every expert with a row is read once per column tile; w_gate's eight
// experts are 235 MB int4 / 470 MB int8 / 940 MB bf16. This first
// version keeps B6-B8's 64 x 64 WMMA tile and serial K loop; wgmma,
// deeper prefetch and a decode-shaped split are the speed work.

#include "matmul_core.cuh"

namespace {

using namespace fa_mm;

template <typename T, int W>
__global__ void __launch_bounds__(kThreads)
grouped_matmul_kernel(const T* __restrict__ x,
                      const unsigned char* __restrict__ w,
                      const float* __restrict__ scale,
                      const int* __restrict__ offsets, T* __restrict__ y,
                      int M, int K, int F, int E, int x_vec, int w_vec) {
  __shared__ __align__(128) unsigned char smem[smem_bytes<T>()];
  const int f0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int tile_end = min(m0 + kBM, M);
  // One expert's weight and scale strides.
  const size_t w_expert =
      (size_t)(W == kInt4 ? K / 2 : K) * F * weight_bytes<W>();
  const size_t s_expert = W == kInt4 ? (size_t)(K / kGroup) * F : (size_t)F;

  Acc acc[kBM / 16];
#pragma unroll
  for (int g = 0; g < kBM / 16; ++g) wmma::fill_fragment(acc[g], 0.f);
  for (int e = 0; e < E; ++e) {
    // Uniform across the block: every thread reads the same offsets.
    const int lo = max(__ldg(offsets + e), m0);
    const int hi = min(__ldg(offsets + e + 1), tile_end);
    if (lo >= hi) continue;
    accumulate_tile<T, W, true>(
        x, w + e * w_expert, W == kDense ? nullptr : scale + e * s_expert,
        lo, hi, K, F, m0, f0, x_vec, w_vec, smem, acc);
  }
  store_tile<T>(acc, smem, y, nullptr, M, F, m0, f0);
}

template <typename T, int W>
cudaError_t launch(const void* x, const void* w, const void* scale,
                   const int* offsets, void* y, int M, int K, int F, int E,
                   cudaStream_t stream) {
  dim3 grid((F + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  grouped_matmul_kernel<T, W><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const unsigned char*>(w),
      static_cast<const float*>(scale), offsets, static_cast<T*>(y), M, K,
      F, E, (int)x_aligned<T>(x, K), (int)w_aligned<W>(w, F));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_weight(const void* x, const void* w, const void* scale,
                            const int* offsets, void* y, int M, int K,
                            int F, int E, int weight, cudaStream_t stream) {
  switch (weight) {
    case kDense:
      return launch<T, kDense>(x, w, scale, offsets, y, M, K, F, E, stream);
    case kInt8:
      return launch<T, kInt8>(x, w, scale, offsets, y, M, K, F, E, stream);
    case kE4M3:
      return launch<T, kE4M3>(x, w, scale, offsets, y, M, K, F, E, stream);
    case kE5M2:
      return launch<T, kE5M2>(x, w, scale, offsets, y, M, K, F, E, stream);
    case kInt4:
      return launch<T, kInt4>(x, w, scale, offsets, y, M, K, F, E, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int fa_grouped_matmul(const void* x, const void* w,
                                 const void* scale, const void* offsets,
                                 void* y, int M, int K, int F, int E,
                                 int weight, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || K < 0 || F <= 0 || E < 0 || offsets == nullptr)
    return (int)cudaErrorInvalidValue;
  if (weight != kDense && scale == nullptr) return (int)cudaErrorInvalidValue;
  if (weight == kInt4 && K % kGroup) return (int)cudaErrorInvalidValue;
  const int* offs = static_cast<const int*>(offsets);
  if (dtype == fa::kBFloat16)
    return (int)dispatch_weight<__nv_bfloat16>(x, w, scale, offs, y, M, K,
                                               F, E, weight, s);
  if (dtype == fa::kFloat16)
    return (int)dispatch_weight<__half>(x, w, scale, offs, y, M, K, F, E,
                                        weight, s);
  return (int)cudaErrorInvalidValue;
}
