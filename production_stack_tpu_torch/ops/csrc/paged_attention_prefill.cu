// paged_prefill_kernel: see paged_attention.cuh.

#include "paged_attention.cuh"

extern "C" int pst_paged_prefill(int q_dtype, int cache_dtype, const void* q,
                                 const void* cache, const int* tables,
                                 const int* kv_lens, const int* starts,
                                 void* out, int B, int T_len, int H, int KH,
                                 int HD, int nb, int bs, int W, int layer,
                                 int window, float scale, float softcap,
                                 void* stream) {
  Params p =
      make_params(q, const_cast<void*>(cache), tables, kv_lens, out, B, T_len,
                  H, KH, HD, nb, bs, W, layer, window, scale, softcap, stream);
  p.starts = starts;
  return dispatch<kPrefill>(q_dtype, cache_dtype,
                           Launch{p, 1, nullptr, nullptr});
}
