// paged_prefill_wgmma_kernel at head_dim 128, and the C entry point of
// both head dims: see prefill_wgmma.cuh. Head_dim 256 is built beside it,
// in prefill_wgmma_hd256.cu.

#include "prefill_wgmma.cuh"

extern "C" int pst_paged_prefill_wgmma_hd256(
    int cache_dtype, const void* q, const void* cache, const int* tables,
    const int* kv_lens, const int* starts, void* out, float* ws,
    int* counters, int B, int T_len, int H, int KH, int nb, int bs, int W,
    int layer, int window, float scale, float softcap, int splits,
    void* stream);

// cache_dtype: 1 = bfloat16, 2 = float8_e4m3fn (q is bf16); HD 128 or 256.
// splits > 1 needs ws (q-tiles * splits * 128 * (HD + 2) floats, q-tiles =
// B * KH * ceil(T / (128 / G))) and counters (q-tiles int32, zero; left
// zero). Returns a cudaError_t (0 = success).
extern "C" int pst_paged_prefill_wgmma(int cache_dtype, const void* q,
                                       const void* cache, const int* tables,
                                       const int* kv_lens, const int* starts,
                                       void* out, float* ws, int* counters,
                                       int B, int T_len, int H, int KH,
                                       int HD, int nb, int bs, int W,
                                       int layer, int window, float scale,
                                       float softcap, int splits,
                                       void* stream) {
  if (HD == 128) {
    return prefill_wgmma<128>(cache_dtype, q, cache, tables, kv_lens, starts,
                              out, ws, counters, B, T_len, H, KH, nb, bs, W,
                              layer, window, scale, softcap, splits, stream);
  }
  if (HD == 256) {
    return pst_paged_prefill_wgmma_hd256(
        cache_dtype, q, cache, tables, kv_lens, starts, out, ws, counters, B,
        T_len, H, KH, nb, bs, W, layer, window, scale, softcap, splits,
        stream);
  }
  return (int)cudaErrorInvalidValue;
}
