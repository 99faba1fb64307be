// paged_decode_kernel<..., false>: see paged_attention.cuh.

#include "paged_attention.cuh"

// splits > 1 needs ws (B*H*splits*(HD+2) floats) and counters (B*KH int32,
// zero; left zero). Returns a cudaError_t (0 = success).
extern "C" int pst_paged_decode(int q_dtype, int cache_dtype, const void* q,
                                const void* cache, const int* tables,
                                const int* kv_lens, void* out, float* ws,
                                int* counters, int B, int H, int KH, int HD,
                                int nb, int bs, int W, int layer, int window,
                                float scale, float softcap, int splits,
                                void* stream) {
  const Params p =
      make_params(q, const_cast<void*>(cache), tables, kv_lens, out, B, 1, H,
                  KH, HD, nb, bs, W, layer, window, scale, softcap, stream);
  return dispatch<kDecode>(q_dtype, cache_dtype,
                            Launch{p, splits, ws, counters});
}
