// B1 on fp32 inputs (flash_fwd.cu; the JAX kernel runs fp32 at
// Precision.HIGHEST, flash.py:92-101): dense K/V only. wgmma has no fp32
// operand at full precision, so both products run in full fp32 on the
// CUDA cores (common.cuh ffma_abt / ffma_ab, no TF32) and every tile
// lives in shared memory: one block of 2 * kBQ threads per (q tile,
// q head, batch), warp w owning S / P / O rows 16w..16w+15 and thread
// pair (2r, 2r+1) the softmax statistics of row r. The masks, loop
// bounds and numerics are the fp16 / bf16 body's (flash_fwd.cuh); P stays
// fp32. 64-row fp32 tiles at D = 256 would not fit shared memory, so
// there the q tile is 32 rows. What bounds it: the 67 TFLOP/s FFMA rate.

#include "flash_fwd.cuh"

namespace fa {
namespace fwd {

constexpr int kBKV = 64;      // kv rows per tile

template <int D>
struct Smem32 {
  static constexpr int kBQ = D > 128 ? 32 : 64;
  static constexpr int kThreads = 2 * kBQ;
  static constexpr int kLdQ = D + 4;       // Q/K/V rows (floats)
  static constexpr int kLdS = kBKV + 4;    // S rows
  static constexpr int kLdP = kBKV + 4;    // P rows
  static constexpr int kLdO = D + 4;       // O rows
  static constexpr size_t kQ = 0;
  static constexpr size_t kK = kQ + sizeof(float) * kBQ * kLdQ;
  static constexpr size_t kV = kK + sizeof(float) * kBKV * kLdQ;
  static constexpr size_t kS = kV + sizeof(float) * kBKV * kLdQ;
  static constexpr size_t kP = kS + sizeof(float) * kBQ * kLdS;
  static constexpr size_t kO = kP + sizeof(float) * kBQ * kLdP;
  static constexpr size_t kSeg = kO + sizeof(float) * kBQ * kLdO;
  static constexpr size_t kBytes = kSeg + sizeof(int) * kBKV;
};

template <int D>
__global__ void __launch_bounds__(Smem32<D>::kThreads)
    flash_fwd_f32_kernel(const Args a) {
  using L = Smem32<D>;
  constexpr int kBQ = L::kBQ;
  constexpr int kThreads = L::kThreads;
  const int Hq = a.Hq, Hkv = a.Hkv, Nq = a.Nq, Nk = a.Nk;
  const int causal = a.causal, offset = a.offset, window = a.window;
  const float scale = a.scale;
  const int* __restrict__ qseg = a.qseg;
  const int* __restrict__ kvseg = a.kvseg;
  float* __restrict__ o = static_cast<float*>(a.o);
  float* __restrict__ lse = a.lse;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem + L::kQ);
  float* sK = reinterpret_cast<float*>(smem + L::kK);
  float* sV = reinterpret_cast<float*>(smem + L::kV);
  float* sS = reinterpret_cast<float*>(smem + L::kS);
  float* sP = reinterpret_cast<float*>(smem + L::kP);
  float* sO = reinterpret_cast<float*>(smem + L::kO);
  int* sKseg = reinterpret_cast<int*>(smem + L::kSeg);

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const size_t qbase = ((size_t)b * Hq + h) * Nq;
  const float* qg = static_cast<const float*>(a.q) + qbase * D;
  const size_t kv_head = (size_t)b * Hkv + hk;
  const float* kg = static_cast<const float*>(a.k) + kv_head * Nk * D;
  const float* vg = static_cast<const float*>(a.v) + kv_head * Nk * D;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid & 31;
  const int row = tid >> 1;          // softmax row owned by this thread pair
  const int half = tid & 1;
  const int qrow = q0 + row;
  const int my_seg =
      (kvseg != nullptr && qrow < Nq) ? qseg[(size_t)b * Nq + qrow] : 0;

  fa::load_rows<float, D, kBQ, kThreads>(sQ, L::kLdQ, qg, q0, Nq, tid);
  for (int i = tid; i < kBQ * D; i += kThreads)
    sO[(i / D) * L::kLdO + (i % D)] = 0.f;
  __syncthreads();

  const float* qw = sQ + (warp * 16) * L::kLdQ;
  const float c = scale * fa::kLog2e;
  float m_i = fa::kInitM;
  float l_i = 0.f;

  // kv columns any real row of this tile can see: from the oldest
  // column inside the first row's window (rounded down to a tile) to the
  // last row's causal limit.
  int kv_begin = 0, kv_end = Nk;
  if (causal) {
    const int last_row = min(q0 + kBQ, Nq) - 1;
    kv_end = min(Nk, last_row + offset + 1);
  }
  if (window > 0)
    kv_begin = max(q0 + offset - window + 1, 0) / kBKV * kBKV;
  // The causal split: every row of the tile shares one band.
  const int band0 = a.split ? q0 / a.band * a.band : 0;
  if (a.split == kSplitBulk) kv_end = min(kv_end, band0);
  if (a.split == kSplitBand) {
    kv_begin = band0;
    kv_end = min(kv_end, band0 + a.band);
  }

  for (int j0 = kv_begin; j0 < kv_end; j0 += kBKV) {
    __syncthreads();   // every warp is done with the previous K/V tile
    fa::load_rows<float, D, kBKV, kThreads>(sK, L::kLdQ, kg, j0, Nk, tid);
    fa::load_rows<float, D, kBKV, kThreads>(sV, L::kLdQ, vg, j0, Nk, tid);
    if (kvseg != nullptr)
      for (int i = tid; i < kBKV; i += kThreads)
        sKseg[i] = j0 + i < Nk ? kvseg[(size_t)b * Nk + j0 + i] : 0;
    __syncthreads();

    // S = Q K^T for this warp's 16 rows (unscaled scores).
    fa::ffma_abt<kBKV, D>(sS + (warp * 16) * L::kLdS, L::kLdS, qw, L::kLdQ,
                          sK, L::kLdQ, lane);
    __syncwarp();

    // Online softmax over this thread's half of the row.
    const float* srow = sS + row * L::kLdS;
    const int c0 = half * (kBKV / 2);
    float sv[kBKV / 2];
    float mx = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < kBKV / 2; ++jj) {
      const int col = j0 + c0 + jj;
      const bool ok = col < Nk && (!causal || col <= qrow + offset) &&
                      (window <= 0 || col > qrow + offset - window) &&
                      (kvseg == nullptr || sKseg[c0 + jj] == my_seg);
      sv[jj] = ok ? srow[c0 + jj] : -INFINITY;
      mx = fmaxf(mx, sv[jj]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_i, mx);
    const float alpha = exp2f((m_i - m_new) * c);
    float psum = 0.f;
    float* prow = sP + row * L::kLdP;
#pragma unroll
    for (int jj = 0; jj < kBKV / 2; ++jj) {
      const float p = exp2f((sv[jj] - m_new) * c);
      psum += p;
      prow[c0 + jj] = p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l_i = l_i * alpha + psum;
    m_i = m_new;
    float* orow = sO + row * L::kLdO + half * (D / 2);
#pragma unroll 8
    for (int d = 0; d < D / 2; ++d) orow[d] *= alpha;
    __syncwarp();

    // O += P V for this warp's 16 rows.
    fa::ffma_ab<D, kBKV>(sO + (warp * 16) * L::kLdO, L::kLdO,
                         sP + (warp * 16) * L::kLdP, L::kLdP, sV, L::kLdQ,
                         nullptr, nullptr, lane);
    __syncwarp();
  }

  if (qrow < Nq) {
    const float inv = l_i > 0.f ? 1.f / l_i : 0.f;
    const float* orow = sO + row * L::kLdO + half * (D / 2);
    float* og = o + (qbase + qrow) * D + half * (D / 2);
    fa::store_scaled<float, D / 2>(og, orow, inv);
    if (half == 0)
      lse[qbase + qrow] =
          l_i > 0.f ? m_i * scale + logf(l_i) : fa::kInitM * scale;
  }
}

template <int D>
cudaError_t launch_f32(const Args& a) {
  using L = Smem32<D>;
  static_assert(L::kBytes <= 232448, "B1 fp32 tiles exceed shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L::kBytes);
  if (err != cudaSuccess) return err;
  dim3 grid((a.Nq + L::kBQ - 1) / L::kBQ, a.Hq, a.B);
  flash_fwd_f32_kernel<D><<<grid, L::kThreads, L::kBytes, a.stream>>>(a);
  return cudaGetLastError();
}

cudaError_t dispatch_f32(const Args& a, int D) {
  if (D == 128) return launch_f32<128>(a);
  if (D == 64) return launch_f32<64>(a);
  if (D == 256) return launch_f32<256>(a);
  if (D == 32) return launch_f32<32>(a);
  return cudaErrorInvalidValue;
}

}  // namespace fwd
}  // namespace fa
