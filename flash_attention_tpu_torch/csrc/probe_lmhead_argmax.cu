// P3: the fused int4 lm_head + greedy argmax of the probe
// scripts/probe_lmhead_argmax.py, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_fused_kernel`
// (probe_lmhead_argmax.py:40, launched at :112). For every row m of x
// [M, K] (bf16) it returns the index and value of the largest of the V
// logits x[m] @ dequant(W) (W B7's packed two's-complement int4 [K/2, V]
// with fp32 scales [K/128, V]) without writing the [M, V] logits: ids
// int32 [M], values fp32 [M]. The port's wrapper is
// flash_attention_tpu_torch/scripts/probe_lmhead_argmax.py
// `lmhead_argmax`.
//
// Each block streams one vocab chunk of kChunk columns (1024, 2048 or
// 4096: the probe's sweep) for 64 rows, 64 columns at a time through B7's
// dequantize-and-multiply body (matmul_core.cuh `accumulate_tile`: each
// weight times its group scale in fp32, rounded to bf16, WMMA products
// with fp32 sums), and after each 64-column tile folds the tile's fp32
// logits into a running (max, first index) per row held by the row's
// thread pair. The chunks combine by one 64-bit atomicMax per row on
// (order-preserving float bits << 32 | (0xFFFFFFFF - index)): the largest
// value wins and, among equal values, the lowest index, as the probe's
// strict > (:77) and jnp.argmax do; the max of integers does not depend
// on the order the blocks finish, so the result is deterministic. A
// second tiny kernel turns the keys into ids and values.
//
// Unlike the JAX probe, which pads V to a multiple of the chunk with zero
// columns (:98-108) so that a padded logit 0 wins any row whose real
// logits are all negative, the port reduces over the V real columns only.
//
// What bounds it on the H100: bytes at the probe's shape (M = 32, K =
// 4096, V = 128256): 262.7 MB of packed weights and 16.4 MB of scales,
// 0.083 ms at 3.35 TB/s (the 33.6 GFLOP take 0.034 ms at 989 TFLOP/s).
// One block per chunk gives V / kChunk blocks (126 / 63 / 32), each
// walking its chunk tile by tile: few bytes are in flight at the wider
// chunks.

#include "matmul_core.cuh"

namespace {

using namespace fa_mm;
using bf16 = __nv_bfloat16;

// (value, index) -> a key whose unsigned order is value order, then
// lowest index first; -0 counts as +0.
__device__ __forceinline__ unsigned long long argmax_key(float v, int col) {
  if (v == 0.f) v = 0.f;
  unsigned int u = __float_as_uint(v);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (0xFFFFFFFFu - (unsigned int)col);
}

template <int kChunk>
__global__ void __launch_bounds__(kThreads)
lmhead_argmax_kernel(const bf16* __restrict__ x,
                     const unsigned char* __restrict__ w,
                     const float* __restrict__ scale,
                     unsigned long long* __restrict__ keys, int M, int K,
                     int V, int x_vec, int w_vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int c0 = blockIdx.x * kChunk;
  const int m0 = blockIdx.y * kBM;
  const int c_end = min(c0 + kChunk, V);
  const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
  float best = -INFINITY;
  int best_col = -1;
  for (int f0 = c0; f0 < c_end; f0 += kBN) {
    Sums<bf16> acc;
    acc.zero(smem);
    accumulate_tile<bf16, kInt4, false>(x, w, scale, 0, M, K, V, m0, f0,
                                        x_vec, w_vec, smem, acc);
    const float* sO = sums_to_smem<bf16>(acc, smem);
    // This thread's half of row r, in increasing column order: strict >
    // keeps the first of equal values.
    const float* row = sO + r * kLdO + half * (kBN / 2);
    const int col0 = f0 + half * (kBN / 2);
#pragma unroll 8
    for (int j = 0; j < kBN / 2; ++j) {
      if (col0 + j < c_end && row[j] > best) {
        best = row[j];
        best_col = col0 + j;
      }
    }
    // sO overlays the operand tiles the next tile's loads overwrite after
    // accumulate_tile's first barrier.
  }
  const float ob = __shfl_xor_sync(0xffffffffu, best, 1);
  const int oc = __shfl_xor_sync(0xffffffffu, best_col, 1);
  if (oc >= 0 &&
      (best_col < 0 || ob > best || (ob == best && oc < best_col))) {
    best = ob;
    best_col = oc;
  }
  if (half == 0 && m0 + r < M && best_col >= 0)
    atomicMax(keys + m0 + r, argmax_key(best, best_col));
}

__global__ void decode_keys(const unsigned long long* __restrict__ keys,
                            int* __restrict__ ids, float* __restrict__ vals,
                            int M) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  const unsigned long long key = keys[m];
  const unsigned int u = (unsigned int)(key >> 32);
  ids[m] = (int)(0xFFFFFFFFu - (unsigned int)(key & 0xFFFFFFFFu));
  vals[m] = __uint_as_float((u & 0x80000000u) ? (u & 0x7FFFFFFFu) : ~u);
}

template <int kChunk>
cudaError_t launch(const void* x, const void* w, const void* scale,
                   unsigned long long* keys, int M, int K, int V,
                   cudaStream_t stream) {
  constexpr size_t kBytes = Tile<bf16>::kBytes;
  cudaError_t err = allow_smem(lmhead_argmax_kernel<kChunk>, kBytes);
  if (err != cudaSuccess) return err;
  dim3 grid((V + kChunk - 1) / kChunk, (M + kBM - 1) / kBM);
  lmhead_argmax_kernel<kChunk><<<grid, kThreads, kBytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const unsigned char*>(w),
      static_cast<const float*>(scale), keys, M, K, V,
      (int)x_aligned<bf16>(x, K), (int)w_aligned<bf16, kInt4>(w, V));
  return cudaGetLastError();
}

}  // namespace

// x [M, K] bf16, w packed int4 [K/2, V], scale fp32 [K/128, V]; keys
// [M] uint64 scratch; ids [M] int32 and vals [M] fp32 out; chunk 1024,
// 2048 or 4096.
extern "C" int fa_probe_lmhead_argmax(const void* x, const void* w,
                                      const void* scale, void* keys,
                                      void* ids, void* vals, int M, int K,
                                      int V, int chunk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || K <= 0 || V <= 0 || K % kGroup)
    return (int)cudaErrorInvalidValue;
  auto* k = static_cast<unsigned long long*>(keys);
  cudaError_t err = cudaMemsetAsync(k, 0, sizeof(unsigned long long) * M, s);
  if (err != cudaSuccess) return (int)err;
  if (chunk == 1024)
    err = launch<1024>(x, w, scale, k, M, K, V, s);
  else if (chunk == 2048)
    err = launch<2048>(x, w, scale, k, M, K, V, s);
  else if (chunk == 4096)
    err = launch<4096>(x, w, scale, k, M, K, V, s);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  decode_keys<<<(M + 127) / 128, 128, 0, s>>>(
      k, static_cast<int*>(ids), static_cast<float*>(vals), M);
  return (int)cudaGetLastError();
}
