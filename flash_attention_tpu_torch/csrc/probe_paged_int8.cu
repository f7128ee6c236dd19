// P2 v2: the probe scripts/probe_paged_int8.py's blocked int8 paged
// decode body, for Hopper (sm_90a), on the split-KV pieces of
// decode_sm90.cuh and the mma.sync fragments of mma_sm80.cuh.
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
// The probe's question is v2's design choice, kept here: each whole
// 128-token quant block of K and V is widened once into bf16 tiles that
// the block's warps share, before their tensor-core products (B4's split
// body, v0, widens 16-token slabs per warp). What bounds it on the H100:
// bytes. At the probe's shape (B = 64, 32 q / 8 kv heads, D = 128, 4088
// tokens a sequence) the live codes are 535.8 MB plus 16.7 MB of scales:
// 0.1653 ms at 3.35 TB/s. The first body held one 256-thread block
// per (kv head, sequence) at about 148 KB of shared memory, one block an
// SM, loaded codes through registers and took three barriers a block.
// This body:
//
//  - Split-KV from shapes alone (scripts/probe_paged_int8.py v2_splits:
//    the split count whose grid (splits, Hkv, B) takes the fewest waves
//    of resident blocks per unit of work, at least four quant blocks a
//    split); each block takes an even share of its sequence's live quant
//    blocks, computed on the device from lengths[b], and never reads a
//    page-table entry past them.
//  - A cp.async ring of two stages, each one quant block's K and V codes
//    and its two scale rows (rows past lengths[b] zero-filled): block
//    j + 1 is in flight while block j is widened and multiplied, and its
//    page-table entry was read a block before that.
//  - One widened bf16 tile [128 tokens, D], shared by the block's 8
//    warps: K_j is widened into it, the scores run, then V_j is widened
//    into it, then P V runs (four barriers a quant block). The ring and
//    this one tile keep the block at 110,288 bytes, under kSmemBudget:
//    two blocks an SM (a tile each for K and V would allow one).
//  - Tokens on the mma's M side, the group's q rows on N (G <= 8 of its 8
//    columns; 4 at the probe's 32 / 8 heads): S^T [16 tokens, 8] = K q^T
//    and O^T [D, 8] += V^T P^T, so a 16-token step is 16 mma.sync
//    m16n8k16 where rows on M (B4's way) would take 32 with 12 of 16 rows
//    empty. Warp w takes tokens 16 w .. 16 w + 15 of every quant block
//    and keeps its own online softmax (m, l of its columns' q rows) and
//    O^T in registers, so no barrier is spent on a row's statistics.
//  - The merge: the 8 warps in warp order, then decode_sm90.cuh's
//    write_unit: one split writes O and the LSE; more write partials to
//    the wrapper's scratch and the unit's last block merges them in split
//    order (no atomics into O; identical bits on a rerun).

#include <cuda_bf16.h>

#include "decode_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using fa::split::kMaxSplits;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlock = 128;     // tokens of a quant block
constexpr int kN = 8;           // MMA columns: the group's q rows
constexpr int kD = 128;         // head dim
constexpr int kStages = 2;      // codes ring

// Shared memory, in bytes from the base: the ring (a stage: K codes, V
// codes, K scale row, V scale row), the widened tile, q, each warp's P^T,
// the warps' row stats, the merge's flag and rows. The merge's [warp][row]
// [D] fp32 sums reuse the ring once every warp has left its loop.
struct Smem {
  static constexpr int kLd = kD + 8;         // tile and q rows (bf16)
  static constexpr int kLdP = 16 + 8;        // P^T rows (bf16)
  static constexpr size_t kStage = 2 * kBlock * kD + 2 * sizeof(float) * kD;
  static constexpr size_t kTile = kStages * kStage;
  static constexpr size_t kQ = kTile + sizeof(bf16) * kBlock * kLd;
  static constexpr size_t kP = kQ + sizeof(bf16) * kN * kLd;
  static constexpr size_t kStats = kP + sizeof(bf16) * kWarps * kN * kLdP;
  static constexpr size_t kFlag = kStats + sizeof(float) * kWarps * kN * 2;
  static constexpr size_t kMerge = kFlag + 16;
  static constexpr size_t kBytes =
      kMerge + sizeof(float) * kN * (kMaxSplits + 2);
  static_assert(kBytes <= fa::split::kSmemBudget, "two blocks an SM");
  static_assert(sizeof(float) * kWarps * kN * kD <= kTile,
                "the merge's sums must fit in the ring");
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
  float* ws;                      // splits > 1: partials, then stats
  int* counters;                  // splits > 1: one per (b, h)
  int B, Hq, Hkv, num_pages, page_size, width, splits;
  float scale;
};

__global__ void __launch_bounds__(kThreads, 2)
    paged_int8_v2_kernel(const Args a) {
  using L = Smem;
  constexpr int kLd = L::kLd, kLdP = L::kLdP;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* tile = reinterpret_cast<bf16*>(smem + L::kTile);
  bf16* sq = reinterpret_cast<bf16*>(smem + L::kQ);
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int G = a.Hq / a.Hkv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  bf16* sp = reinterpret_cast<bf16*>(smem + L::kP) + warp * kN * kLdP;
  const int len = max(0, min(a.lengths[b], a.width * a.page_size));
  const int n_blk = (len + kBlock - 1) / kBlock;
  const int j0 = (int)((long long)n_blk * split / a.splits);
  const int n_mine = (int)((long long)n_blk * (split + 1) / a.splits) - j0;
  const int* table = a.table + (size_t)b * a.width;
  const size_t qrow0 = (size_t)b * a.Hq + (size_t)h * G;
  const float c = a.scale * fa::kLog2e;

  // q rows (zero past G).
  for (int i = tid; i < kN * kD / 8; i += kThreads) {
    const int r = i / (kD / 8), col = (i % (kD / 8)) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < G)
      val = *reinterpret_cast<const uint4*>(a.q + (qrow0 + r) * kD + col);
    *reinterpret_cast<uint4*>(sq + r * kLd + col) = val;
  }

  // The page-table entry of quant block j, read a block ahead of its
  // copy so that no copy waits on it.
  auto entry = [&](int j) { return table[j * kBlock / a.page_size]; };
  // Quant block j (on page table entry `pg`) into ring stage st: its
  // codes and scale rows.
  auto issue = [&](int j, int pg, int st) {
    unsigned char* stage = smem + st * L::kStage;
    const int pos = j * kBlock;
    const size_t page = (size_t)h * a.num_pages + pg;
    const int off = pos % a.page_size;
    const size_t row0 = page * a.page_size + off;
    const int live = len - pos;
    constexpr int kPerRow = kD / 16;
    for (int i = tid; i < kBlock * kPerRow; i += kThreads) {
      const int r = i / kPerRow, col = (i % kPerRow) * 16;
      const bool ok = r < live;
      const size_t at = (row0 + (ok ? r : 0)) * kD + col;
      fa::cp_async16(stage + r * kD + col, a.kpool + at, ok ? 16 : 0);
      fa::cp_async16(stage + (kBlock + r) * kD + col, a.vpool + at,
                     ok ? 16 : 0);
    }
    if (tid < 2 * kD / 4) {
      const int kv = tid / (kD / 4), col = (tid % (kD / 4)) * 4;
      const size_t srow =
          (page * (a.page_size / kBlock) + off / kBlock) * kD;
      float* dst = reinterpret_cast<float*>(stage + 2 * kBlock * kD);
      fa::cp_async16(dst + kv * kD + col,
                     (kv ? a.vscale : a.kscale) + srow + col, 16);
    }
  };
  // K (kv = 0) or V (1) of stage st, times its scale row, rounded to bf16
  // into the tile: a thread widens channels [16 (tid % 8), + 16) of rows
  // tid / 8 + 32 p.
  auto widen = [&](int st, int kv) {
    const unsigned char* stage = smem + st * L::kStage;
    const unsigned char* codes = stage + kv * kBlock * kD;
    const float* srow =
        reinterpret_cast<const float*>(stage + 2 * kBlock * kD) + kv * kD;
    constexpr int kPerRow = kD / 16, kRowsPass = kThreads / kPerRow;
    const int col = (tid % kPerRow) * 16, row = tid / kPerRow;
    float sc[16];
#pragma unroll
    for (int e = 0; e < 16; e += 4)
      *reinterpret_cast<float4*>(sc + e) =
          *reinterpret_cast<const float4*>(srow + col + e);
    uint4 c4[kBlock / kRowsPass];
#pragma unroll
    for (int p = 0; p < kBlock / kRowsPass; ++p)
      c4[p] = *reinterpret_cast<const uint4*>(
          codes + (row + p * kRowsPass) * kD + col);
#pragma unroll
    for (int p = 0; p < kBlock / kRowsPass; ++p)
      fa::split::widen16<fa::kInt8, false, bf16>(
          tile + (row + p * kRowsPass) * kLd + col, c4[p], sc);
  };

  if (n_mine > 0) issue(j0, entry(j0), 0);
  fa::cp_async_commit();
  int next = n_mine > 1 ? entry(j0 + 1) : 0;   // block j + 1's entry
  __syncthreads();   // q rows written

  // q^T as B fragments: k-steps 2i and 2i + 1 in qb[i].
  uint32_t qb[kD / 32][4];
#pragma unroll
  for (int i = 0; i < kD / 32; ++i)
    fa::ldsm_x4(qb[i], sq + (lane % 8) * kLd + i * 32 + (lane / 8) * 8);

  // This thread's q rows 2 tig + e: the warp's running max and its
  // columns' share of the sum; O^T channels 16 n + gid (+ 8), those rows.
  float m[2] = {fa::kInitM, fa::kInitM}, l[2] = {0.f, 0.f};
  float acc[kD / 16][4];
#pragma unroll
  for (int n = 0; n < kD / 16; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int i = 0; i < n_mine; ++i) {
    const int j = j0 + i, st = i % kStages;
    // Block j + 1 into the other stage (block j - 1's, widened by now).
    if (i + 1 < n_mine) {
      issue(j + 1, next, (i + 1) % kStages);
      if (i + 2 < n_mine) next = entry(j + 2);
    }
    fa::cp_async_commit();
    fa::cp_async_wait<1>();
    __syncthreads();   // block j landed; the tile's last readers are done
    widen(st, 0);
    __syncthreads();

    // S^T for tokens 16 warp .. + 16 of block j: s[e] token gid + 8 (e /
    // 2), q row 2 tig + e % 2.
    uint32_t pb[4];
    {
      float s[4] = {0.f, 0.f, 0.f, 0.f};
      const bf16* kt = tile + (16 * warp + lane % 16) * kLd + (lane / 16) * 8;
#pragma unroll
      for (int k = 0; k < kD / 32; ++k) {
        uint32_t af[4];
        fa::ldsm_x4(af, kt + k * 32);
        fa::mma<bf16>(s, af, qb[k][0], qb[k][1]);
        fa::ldsm_x4(af, kt + k * 32 + 16);
        fa::mma<bf16>(s, af, qb[k][2], qb[k][3]);
      }
      const int t = j * kBlock + 16 * warp + gid;
      if (t >= len) s[0] = s[1] = -INFINITY;
      if (t + 8 >= len) s[2] = s[3] = -INFINITY;
      // Online softmax over the warp's 16 tokens; P^T rounded to bf16
      // into the warp's [q row][token] tile.
      float alpha[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float mx = fmaxf(s[e], s[2 + e]);
#pragma unroll
        for (int o = 4; o < 32; o *= 2)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_new = fmaxf(m[e], mx);
        alpha[e] = exp2f((m[e] - m_new) * c);
        const float p0 = exp2f((s[e] - m_new) * c);
        const float p1 = exp2f((s[2 + e] - m_new) * c);
        l[e] = l[e] * alpha[e] + (p0 + p1);
        m[e] = m_new;
        sp[(2 * tig + e) * kLdP + gid] = __float2bfloat16_rn(p0);
        sp[(2 * tig + e) * kLdP + gid + 8] = __float2bfloat16_rn(p1);
      }
#pragma unroll
      for (int n = 0; n < kD / 16; ++n) {
        acc[n][0] *= alpha[0];
        acc[n][1] *= alpha[1];
        acc[n][2] *= alpha[0];
        acc[n][3] *= alpha[1];
      }
      __syncwarp();
      // P^T's B fragment (tokens 0-7, 8-15; lanes 16-31 repeat 0-15).
      fa::ldsm_x4(pb, sp + (lane % 8) * kLdP + ((lane / 8) % 2) * 8);
    }
    __syncthreads();   // every warp is done with K_j
    widen(st, 1);
    __syncthreads();

    // O^T += V^T P^T over the warp's 16 tokens, 16 channels an mma.
    const int mi = lane / 8;
    const bf16* vt = tile + (16 * warp + lane % 8 + (mi / 2) * 8) * kLd +
                     (mi % 2) * 8;
#pragma unroll
    for (int n = 0; n < kD / 16; ++n) {
      uint32_t af[4];
      fa::ldsm_x4_trans(af, vt + 16 * n);
      fa::mma<bf16>(acc[n], af, pb[0], pb[1]);
    }
  }
  fa::cp_async_wait<0>();
#pragma unroll
  for (int e = 0; e < 2; ++e)
#pragma unroll
    for (int o = 4; o < 32; o *= 2)
      l[e] += __shfl_xor_sync(0xffffffffu, l[e], o);

  // Merge the 8 warps (warp order), then write O or this split's partial.
  float* wstats = reinterpret_cast<float*>(smem + L::kStats);  // [w][r][2]
  float* merge = reinterpret_cast<float*>(smem + L::kMerge);
  float* sums = reinterpret_cast<float*>(smem);   // [w][r][D], the ring
  if (gid == 0) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      wstats[(warp * kN + 2 * tig + e) * 2] = m[e];
      wstats[(warp * kN + 2 * tig + e) * 2 + 1] = l[e];
    }
  }
  __syncthreads();   // every warp has left its ring: sums may overwrite it
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = 2 * tig + e;
    const float f = exp2f(
        (m[e] - fa::split::warps_max<kWarps, kN>(wstats, r)) * c);
    float* dst = sums + (warp * kN + r) * kD;
#pragma unroll
    for (int n = 0; n < kD / 16; ++n) {
      dst[16 * n + gid] = acc[n][e] * f;
      dst[16 * n + gid + 8] = acc[n][2 + e] * f;
    }
  }
  fa::split::merge_warps<kWarps, kN>(wstats, merge, c);
  __syncthreads();
  const size_t unit = (size_t)b * a.Hkv + h;
  const size_t units = (size_t)a.B * a.Hkv;
  float* part = a.splits > 1 ? a.ws + unit * a.splits * kN * kD : nullptr;
  float* stats = a.splits > 1
                     ? a.ws + units * a.splits * kN * kD + unit * a.splits * kN * 2
                     : nullptr;
  fa::split::write_unit<kWarps, kN, bf16, kD>(
      G, split, a.splits, a.scale, sums, merge,
      reinterpret_cast<int*>(smem + L::kFlag), a.o + qrow0 * kD,
      a.lse + qrow0, part, stats,
      a.splits > 1 ? a.counters + unit : nullptr);
}

}  // namespace

// q bf16 [B, Hq, D]; int8 pools [Hkv, P, ps, D] with fp32 scales [Hkv, P,
// ps / 128, D]; page_table int32 [B, width]; lengths int32 [B]; o bf16
// [B, Hq, D]; lse fp32 [B, Hq]; with splits > 1, ws at least B Hkv splits
// 8 (D + 2) floats and counters B Hkv zero ints. Hq / Hkv <= 8, ps a
// multiple of 128, D = 128, 1 <= splits <= 64.
extern "C" int fa_probe_paged_int8_v2(
    const void* q, const void* kpool, const void* vpool, const void* kscale,
    const void* vscale, const void* table, const void* lengths, void* o,
    void* lse, void* ws, void* counters, int B, int Hq, int Hkv,
    int num_pages, int page_size, int width, int D, int splits, float scale,
    void* stream) {
  if (Hkv <= 0 || Hq % Hkv || Hq / Hkv > kN || page_size <= 0 ||
      page_size % kBlock || width <= 0 || D != kD || splits < 1 ||
      splits > kMaxSplits ||
      (splits > 1 && (ws == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const bf16*>(q),
               static_cast<const signed char*>(kpool),
               static_cast<const signed char*>(vpool),
               static_cast<const float*>(kscale),
               static_cast<const float*>(vscale),
               static_cast<const int*>(table),
               static_cast<const int*>(lengths), static_cast<bf16*>(o),
               static_cast<float*>(lse), static_cast<float*>(ws),
               static_cast<int*>(counters), B, Hq, Hkv, num_pages,
               page_size, width, splits, scale};
  static std::atomic<uint64_t> done{0};
  cudaError_t err =
      fa::split::allow_smem(paged_int8_v2_kernel, Smem::kBytes, done);
  if (err != cudaSuccess) return (int)err;
  paged_int8_v2_kernel<<<dim3(splits, Hkv, B), kThreads, Smem::kBytes,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
