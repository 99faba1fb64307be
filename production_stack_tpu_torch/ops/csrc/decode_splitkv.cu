// decode_split_kernel at head_dim 128, and the C entry point of both head
// dims: see decode_splitkv.cuh. Head_dim 256 is built beside it, in
// decode_splitkv_hd256.cu.

#include "decode_splitkv.cuh"

extern "C" int pst_decode_split_hd256(
    int cache_dtype, const void* q, void* cache, const void* k_new,
    const void* v_new, const int* write_flat, const int* tables,
    const int* kv_lens, void* out, float* ws, int* counters, int B, int H,
    int KH, int nb, int bs, int W, int layer, int window, float scale,
    float softcap, int splits, void* stream);

// cache_dtype: 1 = bfloat16, 2 = float8_e4m3fn (q is bf16); HD 128 or 256.
// write_flat == nullptr: decode; else decode-write (k_new, v_new [B, KH*HD]
// bf16, cast into an e4m3 cache here). splits > 1 needs ws
// (B*KH*splits*G*(HD+2) floats) and counters (B*KH int32, zero; left
// zero). Returns a cudaError_t.
extern "C" int pst_decode_split(int cache_dtype, const void* q, void* cache,
                                const void* k_new, const void* v_new,
                                const int* write_flat, const int* tables,
                                const int* kv_lens, void* out, float* ws,
                                int* counters, int B, int H, int KH, int HD,
                                int nb, int bs, int W, int layer, int window,
                                float scale, float softcap, int splits,
                                void* stream) {
  if (HD == 128) {
    return decode_split<128>(cache_dtype, q, cache, k_new, v_new, write_flat,
                             tables, kv_lens, out, ws, counters, B, H, KH, nb,
                             bs, W, layer, window, scale, softcap, splits,
                             stream);
  }
  if (HD == 256) {
    return pst_decode_split_hd256(cache_dtype, q, cache, k_new, v_new,
                                  write_flat, tables, kv_lens, out, ws,
                                  counters, B, H, KH, nb, bs, W, layer,
                                  window, scale, softcap, splits, stream);
  }
  return (int)cudaErrorInvalidValue;
}
