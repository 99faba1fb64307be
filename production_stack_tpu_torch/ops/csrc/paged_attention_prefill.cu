// paged_prefill_kernel: see paged_attention.cuh.

#include "paged_attention.cuh"

// splits > 1 needs ws (B*KH*q-tiles*splits*rows*(HD+2) floats, rows =
// PrefillGeo::kRows) and counters (B*KH*q-tiles int32, zero; left zero).
// Returns a cudaError_t (0 = success).
extern "C" int pst_paged_prefill(int q_dtype, int cache_dtype, const void* q,
                                 const void* cache, const int* tables,
                                 const int* kv_lens, const int* starts,
                                 void* out, float* ws, int* counters, int B,
                                 int T_len, int H, int KH, int HD, int nb,
                                 int bs, int W, int layer, int window,
                                 float scale, float softcap, int splits,
                                 void* stream) {
  if (B == 0 || T_len == 0) return 0;
  if (KH <= 0 || H % KH || H / KH < 1 || H / KH > 8 || KH > 65535 ||
      B > 65535 || splits < 1 || splits > kPrefillMaxSplits ||
      (splits > 1 && (ws == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  PrefillLaunch lp{};
  lp.q = q;
  lp.cache = cache;
  lp.tables = tables;
  lp.kv_lens = kv_lens;
  lp.starts = starts;
  lp.out = out;
  lp.ws = ws;
  lp.counters = counters;
  lp.T = T_len;
  lp.KH = KH;
  lp.G = H / KH;
  lp.nb = nb;
  lp.bs = bs;
  lp.W = W;
  lp.layer = layer;
  lp.window = window;
  lp.splits = splits;
  lp.scale = scale;
  lp.softcap = softcap;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && cache_dtype == 0)
    return (int)prefill_by_head_dim<float, float>(HD, lp, B, st);
  if (q_dtype == 0 && cache_dtype == 2)
    return (int)prefill_by_head_dim<float, e4m3>(HD, lp, B, st);
  if (q_dtype == 1 && cache_dtype == 1)
    return (int)prefill_by_head_dim<bf16, bf16>(HD, lp, B, st);
  if (q_dtype == 1 && cache_dtype == 2)
    return (int)prefill_by_head_dim<bf16, e4m3>(HD, lp, B, st);
  return (int)cudaErrorInvalidValue;
}
