// B9: ragged grouped matrix product over expert-sorted rows for Hopper
// (sm_90a): y[i] = x[i] @ W[g(i)], templated over {fp16, bf16, fp32}
// activations and {dense, int8, e4m3, e5m2, int4} expert stacks (the
// kernel template in matmul_kernels.cuh; fp32 instantiated in
// matmul_f32.cu, products in full fp32 on the CUDA cores).
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

#include "matmul_kernels.cuh"

using namespace fa_mm;

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
    return (int)dispatch_grouped<__nv_bfloat16>(x, w, scale, offs, y, M, K,
                                                F, E, weight, s);
  if (dtype == fa::kFloat16)
    return (int)dispatch_grouped<__half>(x, w, scale, offs, y, M, K, F, E,
                                         weight, s);
  if (dtype == fa::kFloat32)
    return (int)dispatch_grouped_f32(x, w, scale, offs, y, M, K, F, E,
                                     weight, s);
  return (int)cudaErrorInvalidValue;
}
