// Paged attention over the stacked KV cache on the CUDA cores, in fp32,
// hand-written for Hopper (sm_90a).
//
// Three kernels, each replacing one Pallas TPU kernel of the JAX package
// (production_stack_tpu/ops/paged_attention_pallas.py) where the tensor-core
// kernels do not apply: fp32 q (tests and debug models such as the tiny
// presets), and bf16 q at head_dim 16, 32 or 64. bf16 q at head_dim 128
// and 256 runs elsewhere: decode and decode-write on the split-KV kernel
// of decode_splitkv.cuh, prefill on the tensor cores (prefill_wgmma.cuh).
//
//   paged_decode_kernel        <- _decode_kernel (one query token per
//                                 sequence)
//   paged_decode_write_kernel  <- _decode_write_kernel (the decode step with
//                                 this step's K/V row written into its page
//                                 first; PST_FUSED_KV_WRITE=1)
//   paged_prefill_kernel       <- _prefill_kernel (chunked-prefill flash
//                                 attention)
//
// Layouts (identical to the JAX package):
//   cache        [L, nb, 2, bs, KH*HD]  page = K rows (index 0) then V rows
//   q (decode)   [B, H, HD]             q (prefill) [B, T, H, HD]
//   tables       [B, W] int32           kv_lens [B] int32, starts [B] int32
// Types: q and out are Tq (fp32 or bf16); the cache is Tc, q's type or
// e4m3 (kv_cache_dtype="float8_e4m3fn"). HD is 16, 32, 64, 128 or 256
// (bf16 q: not 128 or 256), G = H / KH from 1 to 8.
//
// Precision contract: every element is up-converted exactly to fp32 (every
// bf16 and every e4m3 value is an fp32 value; e4m3 goes through the
// hardware's e4m3 -> f16 conversion). Q·Kᵀ, the softmax and P·V run in
// fp32; P is not rounded. A bf16 output is rounded once, at the end. The
// JAX kernel's _pv_dot keeps P to about 2^-8 on an e4m3 cache; this is at
// least as precise. The decode-write casts its rows into an e4m3 cache by
// fp8.cuh's cast_e4m3, the JAX package's cast bit for bit (as
// ops/fp8.py's).
//
// The TPU kernels streamed whole pages into VMEM with double-buffered DMAs
// and carried the flash state across a sequential grid. Neither exists
// here: every block looks up its own page ids, computes its own offsets
// into the full stacked cache from `layer`, and walks its keys in a loop;
// the online softmax (m, l, acc) lives in registers in fp32.
//
// Masked keys are never folded into the softmax (m starts at -inf and a
// key outside a row's [low, bound) range is skipped), so a row whose live
// keys all lie in later chunks is exact, and a row with no live key at
// all writes zeros (the kv_len == 0 padding-row contract). A NaN in a live
// K or V row (an e4m3 cast past 464) reaches the output, as in the plain
// version.
//
// What bounds them on an H100 (3.35 TB/s; 67 TFLOP/s fp32 off the tensor
// cores): decode reads every live K/V row of the sequence once, one block
// per (sequence, kv head) with no split of the keys; decode-write adds one
// K and one V row per (sequence, kv head). Prefill is bound by operations,
// 4*H*HD*T*(start+T/2) FLOP per layer, run on the CUDA cores in fp32 so
// that the products are not rounded to bf16.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "fp8.cuh"

// Included by paged_attention.cu (decode), paged_attention_write.cu
// (decode-write) and paged_attention_prefill.cu (prefill): one nvcc each,
// run in parallel, so the kernels' many instantiations build side by side.

namespace {

using bf16 = __nv_bfloat16;
using e4m3 = __nv_fp8_e4m3;

// Everything a launch needs; kernels take it by value.
struct Params {
  const void* q;
  void* cache;
  const void* k_new;  // decode-write: [B, KH*HD] in q's type
  const void* v_new;
  const int* write_flat;  // decode-write: [B] flat slot blk * bs + row
  const int* tables;
  const int* kv_lens;
  const int* starts;  // prefill
  void* out;
  int B, T, KH, G, HD, nb, bs, W, layer, window;
  float scale, softcap;
  cudaStream_t stream;
};

// ---------------------------------------------------------------------------
// Four consecutive elements (16, 8 or 4 bytes) loaded and converted to
// fp32. The read-only path (ld.global.nc) is not coherent with stores made
// earlier in the same kernel, so a kernel that writes the cache before
// reading it loads through L2 (ld.global.cg) instead: kCoherent.
// ---------------------------------------------------------------------------

template <bool kCoherent, typename V>
__device__ __forceinline__ V load_vec(const void* p) {
  if constexpr (kCoherent) return __ldcg(reinterpret_cast<const V*>(p));
  return __ldg(reinterpret_cast<const V*>(p));
}

template <typename T>
struct Vec4;

template <>
struct Vec4<float> {
  template <bool kCoherent>
  __device__ static inline void load(const float* p, float* o) {
    const uint4 r = load_vec<kCoherent, uint4>(p);
    o[0] = __uint_as_float(r.x);
    o[1] = __uint_as_float(r.y);
    o[2] = __uint_as_float(r.z);
    o[3] = __uint_as_float(r.w);
  }
  __device__ static inline float store(float v) { return v; }
};

template <>
struct Vec4<bf16> {
  template <bool kCoherent>
  __device__ static inline void load(const bf16* p, float* o) {
    const uint2 r = load_vec<kCoherent, uint2>(p);
    o[0] = __uint_as_float(r.x << 16);
    o[1] = __uint_as_float(r.x & 0xffff0000u);
    o[2] = __uint_as_float(r.y << 16);
    o[3] = __uint_as_float(r.y & 0xffff0000u);
  }
  __device__ static inline bf16 store(float v) { return __float2bfloat16(v); }
};

template <>
struct Vec4<e4m3> {
  template <bool kCoherent>
  __device__ static inline void load(const e4m3* p, float* o) {
    const unsigned r = load_vec<kCoherent, unsigned>(p);
    const float2 a = pst_fp8::e4m3x2_to_float2(r);
    const float2 b = pst_fp8::e4m3x2_to_float2(r >> 16);
    o[0] = a.x;
    o[1] = a.y;
    o[2] = b.x;
    o[3] = b.y;
  }
};

// One value of q's type (a row of k_new / v_new) into the cache's type:
// exact into its own type, by cast_e4m3 (JAX's cast) into e4m3.
template <typename Tc>
__device__ inline Tc to_cache(float x);
template <>
__device__ inline float to_cache<float>(float x) { return x; }
template <>
__device__ inline bf16 to_cache<bf16>(float x) { return __float2bfloat16(x); }
template <>
__device__ inline e4m3 to_cache<e4m3>(float x) {
  e4m3 y;
  y.__x = (__nv_fp8_storage_t)pst_fp8::cast_e4m3(x);
  return y;
}

__device__ inline float to_float(float x) { return x; }
__device__ inline float to_float(bf16 x) { return __bfloat162float(x); }

__device__ inline float softcap_score(float s, float scale, float softcap) {
  s *= scale;
  if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
  return s;
}

__device__ inline int window_eff(int window) {
  return window > 0 ? window : (1 << 30);
}

// ---------------------------------------------------------------------------
// Decode: grid (B, KH), block kDecodeWarps warps.
//
// A key row of one kv head is HD values = LPK lanes of VPL values (4, or
// HD / 32 where that is more: 8 at HD 256), so a warp processes KPW = 32 /
// LPK keys at once; each warp walks its own interleaved slice of
// [lo, kv_len) with UNR independent loads in flight (kDecodeUnroll, half
// that at 8 values a lane), keeps (m, l, acc) for each of the G query
// heads in registers, and the partial states are merged across lanes, then
// warps, at the end, through dynamic shared memory (decode_smem: 64 KB at
// HD 256 and 8 heads). The state arrays hold GM >= G heads (GM in 1, 2, 4,
// 8); heads G.. GM - 1 run on zero queries and are never stored.
// ---------------------------------------------------------------------------

constexpr int kDecodeWarps = 8;
constexpr int kDecodeUnroll = 4;
constexpr int kVec = 4;

template <int GM, int HD>
constexpr size_t decode_smem() {
  return sizeof(float) * (size_t)kDecodeWarps * GM * HD;  // the warps' acc
}

template <typename Tq, typename Tc, int GM, int HD, bool kCoherent>
__device__ __forceinline__ void decode_body(const Params& p) {
  constexpr int VPL = HD / kVec > 32 ? HD / 32 : kVec;  // values a lane
  constexpr int LPK = HD / VPL;  // lanes per key row
  constexpr int KPW = 32 / LPK;  // keys per warp step
  constexpr int UNR = VPL > kVec ? kDecodeUnroll / 2 : kDecodeUnroll;
  static_assert(LPK <= 32 && 32 % LPK == 0, "head_dim / lane mismatch");

  __shared__ float sm_m[kDecodeWarps][GM];
  __shared__ float sm_l[kDecodeWarps][GM];
  extern __shared__ float smem[];  // [kDecodeWarps][GM][HD]
  float (*sm_acc)[GM][HD] = reinterpret_cast<float (*)[GM][HD]>(smem);

  const Tq* q = static_cast<const Tq*>(p.q);
  const Tc* cache = static_cast<const Tc*>(p.cache);
  const int b = blockIdx.x;
  const int kh = blockIdx.y;
  const int G = p.G;
  const int H = p.KH * G;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int sub = lane / LPK;  // which key of the warp step
  const int sl = lane % LPK;   // which 4-value slice of the row

  const int kv_len = p.kv_lens[b];
  // The query sits at position kv_len - 1 and sees keys >= kv_len - window:
  // pages wholly below that are never read.
  const int lo = max(kv_len - window_eff(p.window), 0);

  float qv[GM][VPL];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
#pragma unroll
    for (int v = 0; v < VPL; v += kVec) {
      if (g < G) {
        Vec4<Tq>::template load<false>(
            q + ((size_t)b * H + kh * G + g) * HD + sl * VPL + v, qv[g] + v);
      } else {
#pragma unroll
        for (int i = 0; i < kVec; ++i) qv[g][v + i] = 0.f;
      }
    }
  }
  float m[GM], l[GM], acc[GM][VPL];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < VPL; ++i) acc[g][i] = 0.f;
  }

  const size_t lanes = (size_t)p.KH * HD;
  const size_t page_stride = 2 * (size_t)p.bs * lanes;
  const Tc* base_ptr = cache + (size_t)p.layer * p.nb * page_stride +
                       (size_t)kh * HD + sl * VPL;
  const int* trow = p.tables + (size_t)b * p.W;
  constexpr int kStep = kDecodeWarps * KPW;

  for (int base = lo + warp * KPW; base < kv_len; base += kStep * UNR) {
    float kf[UNR][VPL], vf[UNR][VPL];
    bool live[UNR];
#pragma unroll
    for (int u = 0; u < UNR; ++u) {
      const int pos = base + u * kStep + sub;
      live[u] = pos < kv_len;
      if (live[u]) {
        // A table shorter than kv_len is a caller error; the clamp (as in
        // the TPU kernel's page loop) keeps the read inside the table.
        const Tc* kp = base_ptr +
                       (size_t)trow[min(pos / p.bs, p.W - 1)] * page_stride +
                       (size_t)(pos % p.bs) * lanes;
#pragma unroll
        for (int v = 0; v < VPL; v += kVec) {
          Vec4<Tc>::template load<kCoherent>(kp + v, kf[u] + v);
          Vec4<Tc>::template load<kCoherent>(kp + (size_t)p.bs * lanes + v,
                                             vf[u] + v);
        }
      } else {
#pragma unroll
        for (int i = 0; i < VPL; ++i) kf[u][i] = vf[u][i] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < UNR; ++u) {
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < VPL; ++i) s += qv[g][i] * kf[u][i];
#pragma unroll
        for (int off = LPK / 2; off > 0; off >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, off);
        if (live[u]) {
          s = softcap_score(s, p.scale, p.softcap);
          const float mn = fmaxf(m[g], s);
          const float alpha = expf(m[g] - mn);
          const float pr = expf(s - mn);
          l[g] = l[g] * alpha + pr;
#pragma unroll
          for (int i = 0; i < VPL; ++i)
            acc[g][i] = acc[g][i] * alpha + pr * vf[u][i];
          m[g] = mn;
        }
      }
    }
  }

  // Merge the KPW key slots of the warp (lanes that share `sl`).
#pragma unroll
  for (int off = LPK; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo_ = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mn = fmaxf(m[g], mo);
      const float a = m[g] == -INFINITY ? 0.f : expf(m[g] - mn);
      const float c = mo == -INFINITY ? 0.f : expf(mo - mn);
      l[g] = l[g] * a + lo_ * c;
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[g][i], off);
        acc[g][i] = acc[g][i] * a + ao * c;
      }
      m[g] = mn;
    }
  }
  if (sub == 0) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (sl == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
#pragma unroll
      for (int i = 0; i < VPL; ++i) sm_acc[warp][g][sl * VPL + i] = acc[g][i];
    }
  }
  __syncthreads();

  // Merge the warps; one thread per (head, element) of the G live heads.
  Tq* out = static_cast<Tq*>(p.out);
  for (int t = threadIdx.x; t < G * HD; t += blockDim.x) {
    const int g = t / HD, d = t % HD;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w) M = fmaxf(M, sm_m[w][g]);
    // No live key: every l is 0 and the row writes 0. A NaN score (an e4m3
    // K past 464) leaves m at -inf but l NaN, which carries to the output.
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w) {
      const float mw = sm_m[w][g];
      const float c = mw == -INFINITY ? 0.f : expf(mw - M);
      L += sm_l[w][g] * c;
      A += sm_acc[w][g][d] * c;
    }
    const float res = L == 0.f ? 0.f : A / L;
    out[((size_t)b * H + kh * G + g) * HD + d] = Vec4<Tq>::store(res);
  }
}

template <typename Tq, typename Tc, int GM, int HD>
__global__ void __launch_bounds__(kDecodeWarps * 32)
paged_decode_kernel(const Params p) {
  decode_body<Tq, Tc, GM, HD, false>(p);
}

// ---------------------------------------------------------------------------
// Decode with the KV write folded in: grid (B, KH), as decode.
//
// Block (b, kh) first writes lanes [kh*HD, (kh+1)*HD) of k_new[b] and
// v_new[b] (q's type, cast into the cache's by to_cache) into layer
// `layer`, page write_flat[b] / bs, row write_flat[b] %
// bs (K row, and the V row bs rows later); a slot outside [0, nb*bs) writes
// nothing. Then __syncthreads() and the decode loop, which reads the row
// back from the cache, as the TPU kernel does (write_flat need not be
// position kv_len - 1). A block reads only its own kv head's lanes, and a
// sequence writes only into its own last page (shared prefix pages are
// full), so no block depends on another block's write. The loop's cache
// loads are coherent (load_vec<true>).
// ---------------------------------------------------------------------------

template <typename Tq, typename Tc, int GM, int HD>
__global__ void __launch_bounds__(kDecodeWarps * 32)
paged_decode_write_kernel(const Params p) {
  const int b = blockIdx.x;
  const int kh = blockIdx.y;
  const size_t lanes = (size_t)p.KH * HD;
  const int wf = p.write_flat[b];
  if (wf >= 0 && wf < p.nb * p.bs) {
    Tc* krow = static_cast<Tc*>(p.cache) +
               (((size_t)p.layer * p.nb + wf / p.bs) * 2 * p.bs + wf % p.bs) *
                   lanes +
               (size_t)kh * HD;
    Tc* vrow = krow + (size_t)p.bs * lanes;
    const size_t src = (size_t)b * lanes + (size_t)kh * HD;
    const Tq* kn = static_cast<const Tq*>(p.k_new);
    const Tq* vn = static_cast<const Tq*>(p.v_new);
    for (int i = threadIdx.x; i < HD; i += blockDim.x) {
      krow[i] = to_cache<Tc>(to_float(kn[src + i]));
      vrow[i] = to_cache<Tc>(to_float(vn[src + i]));
    }
  }
  __syncthreads();
  decode_body<Tq, Tc, GM, HD, true>(p);
}

// ---------------------------------------------------------------------------
// Prefill: grid (ceil(T / TQ), B, KH), block 128 threads.
//
// A block holds TQ * G of its kRows = 64 query rows (TQ = 64 / G
// consecutive positions times the G heads of one kv head; rows past TQ * G
// are dead, as are rows past T) and walks key chunks of kKeys from the
// first row's window start up to the tile's causal horizon. Each thread
// owns a 4 x 4 tile of the score chunk (rows tr + 16i, keys tk + 8j) and
// the same four rows of the output accumulator, so the row statistics it
// computes for the softmax are the ones it applies to its accumulator.
// ---------------------------------------------------------------------------

constexpr int kPrefillThreads = 128;
constexpr int kRows = 64;
constexpr int kKeys = 32;
constexpr int kKP = kKeys + 1;

template <int HD>
constexpr size_t prefill_smem() {
  // sQ [kRows][HD+1], sK [kKeys][HD+1], sV [kKeys][HD], sP [kRows][kKP];
  // the padded rows spread the banks.
  return sizeof(float) * ((size_t)kRows * (HD + 1) + (size_t)kKeys * (HD + 1) +
                          (size_t)kKeys * HD + (size_t)kRows * kKP);
}

template <typename Tq, typename Tc, int HD>
__global__ void __launch_bounds__(kPrefillThreads)
paged_prefill_kernel(const Params p) {
  constexpr int HDP = HD + 1;
  constexpr int CPR = HD / kVec;  // 4-value chunks per row
  constexpr int DPT = HD / 8;     // accumulator columns per thread
  static_assert(HD % 8 == 0, "a thread owns HD / 8 output columns");

  extern __shared__ float smem[];
  float* sQ = smem;               // [kRows][HDP]
  float* sK = sQ + kRows * HDP;   // [kKeys][HDP]
  float* sV = sK + kKeys * HDP;   // [kKeys][HD]
  float* sP = sV + kKeys * HD;    // [kRows][kKP]

  const Tq* q = static_cast<const Tq*>(p.q);
  const Tc* cache = static_cast<const Tc*>(p.cache);
  const int G = p.G;
  const int TQ = kRows / G;
  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const int kh = blockIdx.z;
  const int H = p.KH * G;
  const int T_len = p.T;
  const int tid = threadIdx.x;
  const int tr = tid / 8;  // 0..15
  const int tk = tid % 8;  // 0..7

  const int kv_len = p.kv_lens[b];
  const int start = p.starts[b];
  const int t0 = tile * TQ;
  const int t_end = min(t0 + TQ, T_len);  // ragged end of T
  const int win = window_eff(p.window);
  // Keys the tile may read: from its first row's window start up to its
  // last row's causal horizon (never past kv_len).
  const int k_lo = max(start + t0 + 1 - win, 0);
  const int k_hi = min(kv_len, start + t_end);

  // Row r is position t0 + r / G, head r % G: r / G reaches TQ only on
  // the dead rows past TQ * G, whose t is at or past t_end.
  for (int idx = tid; idx < kRows * CPR; idx += kPrefillThreads) {
    const int r = idx / CPR, c = idx % CPR;
    const int t = t0 + r / G, g = r % G;
    float f[kVec];
    if (t < t_end) {
      Vec4<Tq>::template load<false>(
          q + (((size_t)b * T_len + t) * H + kh * G + g) * HD + c * kVec, f);
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) f[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < kVec; ++i) sQ[r * HDP + c * kVec + i] = f[i];
  }

  int bound[4], low[4];
  float m[4], l[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr + 16 * i;
    const int t = t0 + r / G;
    const int pos = start + t;
    bound[i] = t < t_end ? min(pos + 1, kv_len) : 0;  // exclusive
    low[i] = max(pos + 1 - win, 0);                    // inclusive
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  const size_t lanes = (size_t)p.KH * HD;
  const size_t page_stride = 2 * (size_t)p.bs * lanes;
  const Tc* layer_base =
      cache + (size_t)p.layer * p.nb * page_stride + (size_t)kh * HD;
  const int* trow = p.tables + (size_t)b * p.W;

  for (int kb = k_lo; kb < k_hi; kb += kKeys) {
    __syncthreads();  // the previous chunk's readers are done
    for (int idx = tid; idx < kKeys * CPR; idx += kPrefillThreads) {
      const int key = idx / CPR, c = idx % CPR;
      const int kp = kb + key;
      float kf[kVec], vf[kVec];
      if (kp < k_hi) {
        const Tc* src = layer_base +
                        (size_t)trow[min(kp / p.bs, p.W - 1)] * page_stride +
                        (size_t)(kp % p.bs) * lanes + c * kVec;
        Vec4<Tc>::template load<false>(src, kf);
        Vec4<Tc>::template load<false>(src + (size_t)p.bs * lanes, vf);
      } else {
#pragma unroll
        for (int i = 0; i < kVec; ++i) kf[i] = vf[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        sK[key * HDP + c * kVec + i] = kf[i];
        sV[key * HD + c * kVec + i] = vf[i];
      }
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = sQ[(tr + 16 * i) * HDP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) ka[j] = sK[(tk + 8 * j) * HDP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += qa[i] * ka[j];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = kb + tk + 8 * j;
        const bool live = kp < bound[i] && kp >= low[i];
        s[i][j] = live ? softcap_score(s[i][j], p.scale, p.softcap) : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      // The 8 threads of a row are lanes differing in their low 3 bits.
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float mn = fmaxf(m[i], mx);
      // No live key for this row yet (mn == -inf): every p is 0 and l, acc
      // stay 0. A NaN score (an e4m3 K past 464) makes l NaN.
      const float base = mn == -INFINITY ? 0.f : mn;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - base);
        rs += s[i][j];
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      rs += __shfl_xor_sync(0xffffffffu, rs, 4);
      const float alpha = expf(m[i] - base);
      l[i] = l[i] * alpha + rs;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= alpha;
      m[i] = mn;
#pragma unroll
      for (int j = 0; j < 4; ++j) sP[(tr + 16 * i) * kKP + tk + 8 * j] = s[i][j];
    }
    __syncthreads();

#pragma unroll 4
    for (int k = 0; k < kKeys; ++k) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(tr + 16 * i) * kKP + k];
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const float v = sV[k * HD + tk + 8 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] += pv[i] * v;
      }
    }
  }

  Tq* out = static_cast<Tq*>(p.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr + 16 * i;
    const int t = t0 + r / G, g = r % G;
    if (t >= t_end) continue;
    const float inv = l[i] == 0.f ? 0.f : 1.f / l[i];
    Tq* dst = out + (((size_t)b * T_len + t) * H + kh * G + g) * HD;
#pragma unroll
    for (int j = 0; j < DPT; ++j)
      dst[tk + 8 * j] = Vec4<Tq>::store(acc[i][j] * inv);
  }
}

// ---------------------------------------------------------------------------
// Host-side dispatch: kind, then types, head dim and the head-group bound
// GM (G rounded up to 1, 2, 4 or 8; prefill takes G at run time).
// ---------------------------------------------------------------------------

enum Kind { kDecode, kDecodeWrite, kPrefill };

template <Kind K, typename Tq, typename Tc, int GM, int HD>
cudaError_t launch(const Params& p) {
  if constexpr (K == kPrefill) {
    constexpr size_t smem = prefill_smem<HD>();
    static bool smem_set = false;  // idempotent: a race only repeats the call
    if (!smem_set) {
      cudaError_t e = cudaFuncSetAttribute(
          paged_prefill_kernel<Tq, Tc, HD>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return e;
      smem_set = true;
    }
    const int TQ = kRows / p.G;
    dim3 grid((p.T + TQ - 1) / TQ, p.B, p.KH);
    paged_prefill_kernel<Tq, Tc, HD>
        <<<grid, kPrefillThreads, smem, p.stream>>>(p);
  } else {
    // The warps' accumulators: dynamic shared memory, past 48 KB at HD 256.
    constexpr size_t smem = decode_smem<GM, HD>();
    static bool smem_set = false;  // idempotent: a race only repeats the call
    if constexpr (K == kDecode) {
      if (!smem_set) {
        cudaError_t e = cudaFuncSetAttribute(
            paged_decode_kernel<Tq, Tc, GM, HD>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return e;
        smem_set = true;
      }
      paged_decode_kernel<Tq, Tc, GM, HD>
          <<<dim3(p.B, p.KH), kDecodeWarps * 32, smem, p.stream>>>(p);
    } else {
      if (!smem_set) {
        cudaError_t e = cudaFuncSetAttribute(
            paged_decode_write_kernel<Tq, Tc, GM, HD>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return e;
        smem_set = true;
      }
      paged_decode_write_kernel<Tq, Tc, GM, HD>
          <<<dim3(p.B, p.KH), kDecodeWarps * 32, smem, p.stream>>>(p);
    }
  }
  return cudaGetLastError();
}

template <Kind K, typename Tq, typename Tc, int HD>
cudaError_t by_group(const Params& p) {
  if constexpr (K == kPrefill) {
    return launch<K, Tq, Tc, 1, HD>(p);
  } else {
    if (p.G == 1) return launch<K, Tq, Tc, 1, HD>(p);
    if (p.G == 2) return launch<K, Tq, Tc, 2, HD>(p);
    if (p.G <= 4) return launch<K, Tq, Tc, 4, HD>(p);
    return launch<K, Tq, Tc, 8, HD>(p);
  }
}

template <Kind K, typename Tq, typename Tc>
cudaError_t by_head_dim(const Params& p) {
  switch (p.HD) {
    case 16: return by_group<K, Tq, Tc, 16>(p);
    case 32: return by_group<K, Tq, Tc, 32>(p);
    case 64: return by_group<K, Tq, Tc, 64>(p);
    case 128:
      // bf16 q at head_dim 128 and 256 runs on the tensor-core kernels.
      if constexpr (std::is_same_v<Tq, float>) return by_group<K, Tq, Tc, 128>(p);
      break;
    case 256:
      if constexpr (std::is_same_v<Tq, float>) return by_group<K, Tq, Tc, 256>(p);
      break;
  }
  return cudaErrorInvalidValue;
}

// Type codes: 0 = float32, 1 = bfloat16, 2 = float8_e4m3fn (cache only).
template <Kind K>
int dispatch(int q_dtype, int cache_dtype, const Params& p) {
  if (p.B == 0 || p.T == 0) return 0;
  if (p.KH <= 0 || p.G < 1 || p.G > 8 || p.KH > 65535 || p.B > 65535)
    return (int)cudaErrorInvalidValue;
  if (q_dtype == 0 && cache_dtype == 0) return (int)by_head_dim<K, float, float>(p);
  if (q_dtype == 0 && cache_dtype == 2) return (int)by_head_dim<K, float, e4m3>(p);
  if (q_dtype == 1 && cache_dtype == 1) return (int)by_head_dim<K, bf16, bf16>(p);
  if (q_dtype == 1 && cache_dtype == 2) return (int)by_head_dim<K, bf16, e4m3>(p);
  return (int)cudaErrorInvalidValue;
}

Params make_params(const void* q, void* cache, const int* tables,
                   const int* kv_lens, void* out, int B, int T, int H, int KH,
                   int HD, int nb, int bs, int W, int layer, int window,
                   float scale, float softcap, void* stream) {
  Params p{};
  p.q = q;
  p.cache = cache;
  p.tables = tables;
  p.kv_lens = kv_lens;
  p.out = out;
  p.B = B;
  p.T = T;
  p.KH = KH;
  p.G = KH > 0 && H % KH == 0 ? H / KH : 0;
  p.HD = HD;
  p.nb = nb;
  p.bs = bs;
  p.W = W;
  p.layer = layer;
  p.window = window;
  p.scale = scale;
  p.softcap = softcap;
  p.stream = static_cast<cudaStream_t>(stream);
  return p;
}

}  // namespace

