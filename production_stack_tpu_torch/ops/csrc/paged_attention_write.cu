// paged_decode_kernel<..., true> (the decode-write): see
// paged_attention.cuh.

#include "paged_attention.cuh"

// k_new, v_new: [B, KH*HD] in q's type; write_flat: [B] int32. splits > 1
// needs ws and counters, as pst_paged_decode.
extern "C" int pst_paged_decode_write(int q_dtype, int cache_dtype,
                                      const void* q, void* cache,
                                      const void* k_new, const void* v_new,
                                      const int* write_flat,
                                      const int* tables, const int* kv_lens,
                                      void* out, float* ws, int* counters,
                                      int B, int H, int KH, int HD, int nb,
                                      int bs, int W, int layer, int window,
                                      float scale, float softcap, int splits,
                                      void* stream) {
  Params p = make_params(q, cache, tables, kv_lens, out, B, 1, H, KH, HD, nb,
                         bs, W, layer, window, scale, softcap, stream);
  p.k_new = k_new;
  p.v_new = v_new;
  p.write_flat = write_flat;
  return dispatch<kDecodeWrite>(q_dtype, cache_dtype,
                            Launch{p, splits, ws, counters});
}
