// decode_split_kernel at head_dim 256 (gemma-7b, gemma2-9b): see
// decode_splitkv.cuh. Called through pst_decode_split (decode_splitkv.cu).

#include "decode_splitkv.cuh"

extern "C" int pst_decode_split_hd256(
    int cache_dtype, const void* q, void* cache, const void* k_new,
    const void* v_new, const int* write_flat, const int* tables,
    const int* kv_lens, void* out, float* ws, int* counters, int B, int H,
    int KH, int nb, int bs, int W, int layer, int window, float scale,
    float softcap, int splits, void* stream) {
  return decode_split<256>(cache_dtype, q, cache, k_new, v_new, write_flat,
                           tables, kv_lens, out, ws, counters, B, H, KH, nb,
                           bs, W, layer, window, scale, softcap, splits,
                           stream);
}
