// B4: paged decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel flash_attention_tpu/ops/paged.py
// `_paged_kernel` (paged.py:37, launched at :305) on the port's serving
// path (one launch per layer per engine decode step).
//
// Computes, for every sequence b and kv head h, attention of the R query
// rows that read kv head h (the GQA group times any folded positions,
// t fastest) over the first lengths[b] tokens of the sequence's paged
// K/V, and exports O [B, Hq, D] and LSE [B, Hq] (fp32). A length-0 row
// (a dead engine slot) gives O = 0 and LSE = INIT_M * scale.
//
// What bounds it on the H100: bytes. Each live token's K and V rows are
// read once per kv head (4*Hkv*D bytes per token in bf16) and do 4*R*D
// FLOPs, about R/2 FLOPs per byte -- far under the ~295 FLOPs per byte
// at which the tensor cores would become the limit. The design therefore
// reads only what is live and reads it once: the block walks only the
// ceil(lengths[b] / page_size) live entries of page_table[b] (never the
// table width, whose tail points at a scratch page), reads each page's
// [page_size, D] K and V rows once for all R query rows, with 16-byte
// loads by neighbouring threads on neighbouring addresses, four tokens'
// loads in flight per thread. The products run on the CUDA cores in
// fp32; tensor cores would buy nothing at R <= 16.
//
// Layout: one block of 256 threads per (kv head, sequence), walking the
// sequence page by page through the body it shares with B5
// (decode_core.cuh: scores, online softmax and PV product per page,
// partial sums added in a fixed order, so results are deterministic).
//
// Few blocks (B * Hkv) are in flight at small batch; splitting the pages
// of a sequence across blocks with a merge pass is the fast shape and is
// later work.

#include "decode_core.cuh"

namespace {

using fa::decode::kThreads;

template <typename T, int D, int R>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kpool,
                    const T* __restrict__ vpool,
                    const int* __restrict__ table,
                    const int* __restrict__ lengths, T* __restrict__ o,
                    float* __restrict__ lse, int Hq, int Hkv, int num_pages,
                    int page_size, int width, int rows, float scale) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int len = lengths[b];
  const int n_pages = min((len + page_size - 1) / page_size, width);
  const size_t qrow0 = (size_t)b * Hq + (size_t)h * rows;
  const fa::decode::PagedChunks pages{table + (size_t)b * width,
                                      (size_t)h * num_pages,
                                      (size_t)page_size * D};
  fa::decode::attend<T, D, R>(q + qrow0 * D, kpool, vpool, pages, len,
                              n_pages, page_size, rows, scale,
                              o + qrow0 * D, lse + qrow0);
}

template <typename T, int D, int R>
cudaError_t launch(const void* q, const void* kpool, const void* vpool,
                   const int* table, const int* lengths, void* o,
                   float* lse, int B, int Hq, int Hkv, int num_pages,
                   int page_size, int width, int rows, float scale,
                   cudaStream_t stream) {
  const size_t bytes = fa::decode::smem_bytes<D, R>(page_size);
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<T, D, R>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(Hkv, B);
  paged_decode_kernel<T, D, R><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kpool),
      static_cast<const T*>(vpool), table, lengths, static_cast<T*>(o),
      lse, Hq, Hkv, num_pages, page_size, width, rows, scale);
  return cudaGetLastError();
}

// R: the smallest instantiated row bound >= the rows (config.PAGED_MAX_ROWS
// is the largest).
template <typename T, int D>
cudaError_t dispatch_rows(const void* q, const void* kpool,
                          const void* vpool, const int* table,
                          const int* lengths, void* o, float* lse, int B,
                          int Hq, int Hkv, int num_pages, int page_size,
                          int width, float scale, cudaStream_t stream) {
  const int rows = Hq / Hkv;
#define FA_PAGED_LAUNCH(RB)                                                 \
  if (rows <= RB)                                                           \
    return launch<T, D, RB>(q, kpool, vpool, table, lengths, o, lse, B, Hq, \
                            Hkv, num_pages, page_size, width, rows, scale,  \
                            stream);
  FA_PAGED_LAUNCH(2)
  FA_PAGED_LAUNCH(4)
  FA_PAGED_LAUNCH(8)
  FA_PAGED_LAUNCH(16)
#undef FA_PAGED_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int fa_paged_decode(const void* q, const void* kpool,
                               const void* vpool, const void* table,
                               const void* lengths, void* o, void* lse,
                               int B, int Hq, int Hkv, int num_pages,
                               int page_size, int width, int D, float scale,
                               int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(table);
  const int* ln = static_cast<const int*>(lengths);
  float* l = static_cast<float*>(lse);
  if (Hkv <= 0 || Hq % Hkv || page_size <= 0 || width <= 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == fa::kBFloat16) {
    if (D == 128)
      return (int)dispatch_rows<__nv_bfloat16, 128>(
          q, kpool, vpool, tb, ln, o, l, B, Hq, Hkv, num_pages, page_size,
          width, scale, s);
    if (D == 64)
      return (int)dispatch_rows<__nv_bfloat16, 64>(
          q, kpool, vpool, tb, ln, o, l, B, Hq, Hkv, num_pages, page_size,
          width, scale, s);
  } else if (dtype == fa::kFloat16) {
    if (D == 128)
      return (int)dispatch_rows<__half, 128>(q, kpool, vpool, tb, ln, o, l,
                                             B, Hq, Hkv, num_pages,
                                             page_size, width, scale, s);
    if (D == 64)
      return (int)dispatch_rows<__half, 64>(q, kpool, vpool, tb, ln, o, l,
                                            B, Hq, Hkv, num_pages,
                                            page_size, width, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
