// B9: ragged grouped matrix product over expert-sorted rows for Hopper
// (sm_90a): y[i] = x[i] @ W[g(i)], over {fp16, bf16, fp32} activations
// and {dense, int8, e4m3, e5m2, int4} expert stacks (fp32 products in
// full fp32 on the CUDA cores).
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
// Schedule. The grid is sized from M and F alone, so the group offsets
// never leave the device (no host sync in an MoE layer). A block reads
// the E + 1 offsets and, for each expert whose row range meets its rows,
// runs the weight-widening K loop on that expert's weight with the other
// rows contributing zero, summing into one set of accumulators: a tile
// that straddles experts loops over them, an empty expert or one outside
// the tile costs nothing, and a tile past the data stores zeros. This
// replaces the TPU grid's visit plan (`make_visit_plan`), its padding of
// x and W (out-of-bounds reads are zeros here) and its even/odd split of
// x for int4 (x is read at full width).
//
// What bounds it on the H100. Prefill (a 4096-token bucket, M = 8192
// sorted rows, Mixtral w_gate 4096 x 14336): operations, 0.96 TFLOP =
// 0.97 ms at 989 TFLOP/s. Decode-shaped dispatches (16 rows, the forced
// path only): bytes -- every expert with a row is read once.
//
// Three bodies, chosen from the shape before the launch
// (ops/quant_matmul.py matmul_body, body argument): fp32 activations take
// the register-blocked FFMA body of matmul_f32.cuh (instantiated in
// matmul_f32_grouped.cu: tiles of 16-128 rows sized to M, the experts
// meeting a tile run their K steps through one cp.async ring into one set
// of register sums, K split by ffma_plan where the tiles would not fill
// the card, partials merged in split order); fp16 / bf16 operands TMA can
// address take the wgmma body of matmul_sm90.cuh at any row count
// (grouped_sm90_{bf16,f16}.cu: 128-row tiles, every expert meeting the
// tile runs its own K loop into the same accumulators, a warpgroup
// zeroes its rows outside the expert in the landed x stage of a
// straddling tile); other fp16 / bf16 operands keep the first body here
// (matmul_kernels.cuh over matmul_core.cuh: 64 x 64 WMMA tiles, masked
// rows read as zeros).

#include "matmul_f32.cuh"
#include "matmul_kernels.cuh"
#include "matmul_sm90.cuh"

using namespace fa_mm;

// body: hopper::kFirstBody (the kernel above; fp16 / bf16 operands TMA
// cannot address), kPrefillBody (matmul_sm90.cuh; fp16 / bf16, any M) or
// f32::kBody (matmul_f32.cuh; fp32). tile_rows, splits, k_chunk, ws and
// counters are the FFMA body's plan (ops/quant_matmul.py ffma_plan); ws
// [splits, M, F] fp32 and counters (one zero int per tile) when splits >
// 1.
extern "C" int fa_grouped_matmul(const void* x, const void* w,
                                 const void* scale, const void* offsets,
                                 void* y, int M, int K, int F, int E,
                                 int weight, int dtype, int body,
                                 int tile_rows, int splits, int k_chunk,
                                 void* ws, void* counters, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || K < 0 || F <= 0 || E < 0 || offsets == nullptr)
    return (int)cudaErrorInvalidValue;
  if (weight != kDense && scale == nullptr) return (int)cudaErrorInvalidValue;
  if (weight == kInt4 && K % kGroup) return (int)cudaErrorInvalidValue;
  const int* offs = static_cast<const int*>(offsets);
  if (body == f32::kBody) {
    f32::Params p;
    if (dtype != fa::kFloat32 || E == 0 ||
        !f32::make_params(p, x, w, scale, offs, y, M, K, F, E, weight,
                          tile_rows, splits, k_chunk, ws, counters))
      return (int)cudaErrorInvalidValue;
    return (int)f32::grouped(p, weight, tile_rows, splits, s);
  }
  if (body == hopper::kFirstBody) {
    if (dtype == fa::kBFloat16)
      return (int)dispatch_grouped<__nv_bfloat16>(x, w, scale, offs, y, M,
                                                  K, F, E, weight, s);
    if (dtype == fa::kFloat16)
      return (int)dispatch_grouped<__half>(x, w, scale, offs, y, M, K, F, E,
                                           weight, s);
    return (int)cudaErrorInvalidValue;
  }
  if (body != hopper::kPrefillBody ||
      (dtype != fa::kBFloat16 && dtype != fa::kFloat16) || K == 0)
    return (int)cudaErrorInvalidValue;
  hopper::Args a{nullptr, offs, y, nullptr, nullptr, M, K, F, E, 0};
  return (int)(dtype == fa::kBFloat16
                   ? hopper::grouped_bf16(x, w, scale, a, weight, s)
                   : hopper::grouped_f16(x, w, scale, a, weight, s));
}
