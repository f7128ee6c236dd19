// What every body of the kernel-study variants shares (B10a at 16 x 16
// and 64 x 64, B10b, B10c in variants_fa1.cu, variants_fa2.cu,
// variants_naive.cu): the launch arguments and the one tile B10b and
// B10c are built for. The bodies: study_sm90.cuh (fp16 / bf16 at 64 x
// 64), study_sm80.cuh (fp16 / bf16 B10a at 16 x 16), study_f32.cuh (fp32
// at every tile).
#pragma once

#include "common.cuh"

namespace fa {
namespace study {

// The one tile B10b and B10c are built for (ops/variants.py study_tile):
// 64 x 64, or 32 x 64 for fp32 at D = 256. The tile is what the wrapper
// requires to divide Nq and Nk, as the JAX kernels do; B10b / B10c take
// the softmax over 64-column tiles whatever the body's rows a block.
template <typename T, int D>
struct DefaultTile {
  static constexpr int kBR = sizeof(T) == 4 && D > 128 ? 32 : 64;
  static constexpr int kBC = 64;
};

struct Args {
  const void* q;     // [B, Hq, Nq, D]
  const void* k;     // [B, Hkv, Nk, D]
  const void* v;
  void* o;           // [B, Hq, Nq, D]
  float* m;          // [B, Hq, Nq] (B10a only)
  float* l;
  int B, Hq, Hkv, Nq, Nk, causal, offset;
  float scale;
  cudaStream_t stream;
};

}  // namespace study
}  // namespace fa
