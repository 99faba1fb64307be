// paged_prefill_wgmma_kernel at head_dim 256 (gemma-7b, gemma2-9b): see
// prefill_wgmma.cuh. Called through pst_paged_prefill_wgmma
// (prefill_wgmma.cu).

#include "prefill_wgmma.cuh"

extern "C" int pst_paged_prefill_wgmma_hd256(
    int cache_dtype, const void* q, const void* cache, const int* tables,
    const int* kv_lens, const int* starts, void* out, float* ws,
    int* counters, int B, int T_len, int H, int KH, int nb, int bs, int W,
    int layer, int window, float scale, float softcap, int splits,
    void* stream) {
  return prefill_wgmma<256>(cache_dtype, q, cache, tables, kv_lens, starts,
                            out, ws, counters, B, T_len, H, KH, nb, bs, W,
                            layer, window, scale, softcap, splits, stream);
}
