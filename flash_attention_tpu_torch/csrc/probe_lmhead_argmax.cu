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
// Two bodies, chosen before the launch (scripts/_common.py
// int4_probe_body, by ops/quant_matmul.py tma_ready):
//  - the split-K decode body of matmul_sm90.cuh (probe_lmhead_sm90.cu)
//    whenever TMA can address x, the packed lm_head and its scales (16-byte
//    aligned bases, V % 16): a sibling of B7's decode instantiation
//    (storage kInt4, B7's codes and converter: each value times its group
//    scale in fp32, rounded to bf16; y^T = W^T x^T with NP = 64; TMA rings
//    of codes, scale rows and x; wgmma with fp32 accumulators in
//    registers) whose epilogue replaces the store: each x row's (largest
//    fp32 logit, lowest column) over the block's 64 columns below V, by
//    warp shuffles and then the four warps in order through shared
//    memory, and one 64-bit atomicMax of its key. One block per (64-column
//    tile, 64-row slice of x): 2004 blocks at the probe's V, 15 an SM, two
//    resident; splits = 1 (an argmax needs whole sums).
//    The chunk width selects the key slots: the tiles of one chunk of
//    `chunk` columns combine by atomicMax into one key per row (16, 32 or
//    64 atomics an address at 1024, 2048, 4096, where one slot for the
//    whole vocab would take 2004), and a second tiny kernel reduces each
//    row's V / chunk slot keys (126, 63, 32) and decodes the winner. The
//    grid does not depend on the chunk;
//  - the first body (this file), for operands TMA cannot address (e.g. V
//    = 5000): each block streams one vocab chunk of kChunk columns for 64
//    rows, 64 columns at a time through B7's old dequantize-and-multiply
//    body (matmul_core.cuh `accumulate_tile`, WMMA products with fp32
//    sums), folding each tile's fp32 logits into a running (max, first
//    index) per row held by the row's thread pair, then one atomicMax per
//    row into a single key slot. Counted in the wrapper's
//    first_body_launches.
// Keys are (order-preserving float bits << 32 | (0xFFFFFFFF - index))
// (matmul_sm90.cuh argmax_key): the largest value wins and, among equal
// values, the lowest index, as the probe's strict > (:77) and jnp.argmax
// do; -0 counts as +0; the max of integers does not depend on the order
// the blocks finish, so the result is deterministic.
//
// Unlike the JAX probe, which pads V to a multiple of the chunk with zero
// columns (:98-108) so that a padded logit 0 wins any row whose real
// logits are all negative, the port reduces over the V real columns only.
//
// What bounds it on the H100: bytes at the probe's shape (M = 32, K =
// 4096, V = 128256): 262.7 MB of packed weights and 16.4 MB of scales,
// 0.083 ms at 3.35 TB/s (the 33.6 GFLOP take 0.034 ms at 989 TFLOP/s).

#include "matmul_core.cuh"
#include "matmul_sm90.cuh"

namespace {

using namespace fa_mm;
using bf16 = __nv_bfloat16;

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
    atomicMax(keys + m0 + r, hopper::argmax_key(best, best_col));
}

// Row m's winner: the largest of its `slots` keys ([slots, M]).
__global__ void decode_keys(const unsigned long long* __restrict__ keys,
                            int slots, int* __restrict__ ids,
                            float* __restrict__ vals, int M) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  unsigned long long key = 0;
  for (int c = 0; c < slots; ++c) key = max(key, keys[(size_t)c * M + m]);
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
// uint64 scratch, [M] on the first body and [ceil(V / chunk), M] on the
// decode body; ids [M] int32 and vals [M] fp32 out; chunk 1024, 2048 or
// 4096; body hopper::kFirstBody or kDecodeBody.
extern "C" int fa_probe_lmhead_argmax(const void* x, const void* w,
                                      const void* scale, void* keys,
                                      void* ids, void* vals, int M, int K,
                                      int V, int chunk, int body,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || K <= 0 || V <= 0 || K % kGroup ||
      (chunk != 1024 && chunk != 2048 && chunk != 4096) ||
      (body != hopper::kFirstBody && body != hopper::kDecodeBody))
    return (int)cudaErrorInvalidValue;
  const bool decode = body == hopper::kDecodeBody;
  const int slots = decode ? (V + chunk - 1) / chunk : 1;
  auto* k = static_cast<unsigned long long*>(keys);
  cudaError_t err = cudaMemsetAsync(
      k, 0, sizeof(unsigned long long) * (size_t)slots * M, s);
  if (err != cudaSuccess) return (int)err;
  if (decode) {
    hopper::Args a{};
    a.M = M;
    a.K = K;
    a.F = V;
    a.E = 1;
    a.k_chunk = K;
    a.keys = k;
    a.key_chunk = chunk;
    err = hopper::probe_lmhead(x, w, scale, a, s);
  } else if (chunk == 1024)
    err = launch<1024>(x, w, scale, k, M, K, V, s);
  else if (chunk == 2048)
    err = launch<2048>(x, w, scale, k, M, K, V, s);
  else
    err = launch<4096>(x, w, scale, k, M, K, V, s);
  if (err != cudaSuccess) return (int)err;
  decode_keys<<<(M + 127) / 128, 128, 0, s>>>(
      k, slots, static_cast<int*>(ids), static_cast<float*>(vals), M);
  return (int)cudaGetLastError();
}
