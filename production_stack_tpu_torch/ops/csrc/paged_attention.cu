// Paged attention over the stacked KV cache in fp32, hand-written for
// Hopper (sm_90a).
//
// Three kernels, each replacing one Pallas TPU kernel of the JAX package
// (production_stack_tpu/ops/paged_attention_pallas.py) for fp32 caches
// (tests and debug models). bf16 runs elsewhere: decode and decode-write
// on the split-KV kernel of decode_splitkv.cu, prefill on the tensor cores
// (prefill_wgmma.cu).
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
// all writes zeros (the kv_len == 0 padding-row contract).
//
// What bounds them on an H100 (3.35 TB/s; 67 TFLOP/s fp32 off the tensor
// cores): decode reads every live K/V row of the sequence once, one block
// per (sequence, kv head) with no split of the keys; decode-write adds one
// K and one V row per (sequence, kv head). Prefill is bound by operations,
// 4*H*HD*T*(start+T/2) FLOP per layer, run on the CUDA cores in fp32 so
// that the products are not rounded to bf16.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 128;

// ---------------------------------------------------------------------------
// 16-byte vector loads converted to fp32.
// ---------------------------------------------------------------------------

template <typename T>
struct VecTraits;

template <>
struct VecTraits<float> {
  static constexpr int kVec = 4;
  __device__ static inline void to_float(const uint4& r, float* o) {
    o[0] = __uint_as_float(r.x);
    o[1] = __uint_as_float(r.y);
    o[2] = __uint_as_float(r.z);
    o[3] = __uint_as_float(r.w);
  }
  __device__ static inline float store(float v) { return v; }
};

template <typename T>
__device__ inline uint4 load16(const T* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// Cache loads. The read-only path (ld.global.nc) is not coherent with
// stores made earlier in the same kernel, so a kernel that writes the cache
// before reading it loads through L2 (ld.global.cg) instead.
template <bool kCoherent, typename T>
__device__ inline uint4 load_cache16(const T* p) {
  if constexpr (kCoherent) return __ldcg(reinterpret_cast<const uint4*>(p));
  return __ldg(reinterpret_cast<const uint4*>(p));
}

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
// A key row of one kv head is HD values = LPK lanes of 16 bytes, so a warp
// processes KPW = 32 / LPK keys at once; each warp walks its own
// interleaved slice of [lo, kv_len) with kDecodeUnroll independent loads
// in flight, keeps (m, l, acc) for each of the G query heads in registers,
// and the partial states are merged across lanes, then warps, at the end.
// ---------------------------------------------------------------------------

constexpr int kDecodeWarps = 8;
constexpr int kDecodeUnroll = 4;

template <typename T, int G, bool kCoherent>
__device__ __forceinline__ void decode_body(
    const T* __restrict__ q, const T* cache, const int* __restrict__ tables,
    const int* __restrict__ kv_lens, T* __restrict__ out, int nb, int bs,
    int KH, int W, int layer, int window, float scale, float softcap) {
  using VT = VecTraits<T>;
  constexpr int HD = kHeadDim;
  constexpr int VEC = VT::kVec;
  constexpr int LPK = HD / VEC;  // lanes per key row
  constexpr int KPW = 32 / LPK;  // keys per warp step
  static_assert(LPK <= 32 && 32 % LPK == 0, "head_dim / lane mismatch");

  __shared__ float sm_m[kDecodeWarps][G];
  __shared__ float sm_l[kDecodeWarps][G];
  __shared__ float sm_acc[kDecodeWarps][G][HD];

  const int b = blockIdx.x;
  const int kh = blockIdx.y;
  const int H = KH * G;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int sub = lane / LPK;  // which key of the warp step
  const int sl = lane % LPK;   // which 16-byte slice of the row

  const int kv_len = kv_lens[b];
  // The query sits at position kv_len - 1 and sees keys >= kv_len - window:
  // pages wholly below that are never read.
  const int lo = max(kv_len - window_eff(window), 0);

  float qv[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    VT::to_float(load16(q + ((size_t)b * H + kh * G + g) * HD + sl * VEC),
                 qv[g]);
  }
  float m[G], l[G], acc[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[g][i] = 0.f;
  }

  const size_t lanes = (size_t)KH * HD;
  const size_t page_stride = 2 * (size_t)bs * lanes;
  const T* base_ptr =
      cache + (size_t)layer * nb * page_stride + (size_t)kh * HD + sl * VEC;
  const int* trow = tables + (size_t)b * W;
  constexpr int kStep = kDecodeWarps * KPW;

  for (int base = lo + warp * KPW; base < kv_len;
       base += kStep * kDecodeUnroll) {
    uint4 kr[kDecodeUnroll], vr[kDecodeUnroll];
    bool live[kDecodeUnroll];
#pragma unroll
    for (int u = 0; u < kDecodeUnroll; ++u) {
      const int pos = base + u * kStep + sub;
      live[u] = pos < kv_len;
      if (live[u]) {
        // A table shorter than kv_len is a caller error; the clamp (as in
        // the TPU kernel's page loop) keeps the read inside the table.
        const T* kp = base_ptr +
                      (size_t)trow[min(pos / bs, W - 1)] * page_stride +
                      (size_t)(pos % bs) * lanes;
        kr[u] = load_cache16<kCoherent>(kp);
        vr[u] = load_cache16<kCoherent>(kp + (size_t)bs * lanes);
      } else {
        kr[u] = make_uint4(0, 0, 0, 0);
        vr[u] = make_uint4(0, 0, 0, 0);
      }
    }
#pragma unroll
    for (int u = 0; u < kDecodeUnroll; ++u) {
      float kf[VEC], vf[VEC];
      VT::to_float(kr[u], kf);
      VT::to_float(vr[u], vf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < VEC; ++i) s += qv[g][i] * kf[i];
#pragma unroll
        for (int off = LPK / 2; off > 0; off >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, off);
        if (live[u]) {
          s = softcap_score(s, scale, softcap);
          const float mn = fmaxf(m[g], s);
          const float alpha = expf(m[g] - mn);
          const float p = expf(s - mn);
          l[g] = l[g] * alpha + p;
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[g][i] = acc[g][i] * alpha + p * vf[i];
          m[g] = mn;
        }
      }
    }
  }

  // Merge the KPW key slots of the warp (lanes that share `sl`).
#pragma unroll
  for (int off = LPK; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo_ = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mn = fmaxf(m[g], mo);
      const float a = m[g] == -INFINITY ? 0.f : expf(m[g] - mn);
      const float c = mo == -INFINITY ? 0.f : expf(mo - mn);
      l[g] = l[g] * a + lo_ * c;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[g][i], off);
        acc[g][i] = acc[g][i] * a + ao * c;
      }
      m[g] = mn;
    }
  }
  if (sub == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (sl == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) sm_acc[warp][g][sl * VEC + i] = acc[g][i];
    }
  }
  __syncthreads();

  // Merge the warps; one thread per (head, element).
  for (int t = threadIdx.x; t < G * HD; t += blockDim.x) {
    const int g = t / HD, d = t % HD;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w) M = fmaxf(M, sm_m[w][g]);
    float res = 0.f;
    if (M != -INFINITY) {
      float L = 0.f, A = 0.f;
#pragma unroll
      for (int w = 0; w < kDecodeWarps; ++w) {
        const float mw = sm_m[w][g];
        const float c = mw == -INFINITY ? 0.f : expf(mw - M);
        L += sm_l[w][g] * c;
        A += sm_acc[w][g][d] * c;
      }
      res = A / L;
    }
    out[((size_t)b * H + kh * G + g) * HD + d] = VT::store(res);
  }
}

template <typename T, int G>
__global__ void __launch_bounds__(kDecodeWarps * 32)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ cache,
                    const int* __restrict__ tables,
                    const int* __restrict__ kv_lens, T* __restrict__ out,
                    int nb, int bs, int KH, int W, int layer, int window,
                    float scale, float softcap) {
  decode_body<T, G, false>(q, cache, tables, kv_lens, out, nb, bs, KH, W,
                           layer, window, scale, softcap);
}

// ---------------------------------------------------------------------------
// Decode with the KV write folded in: grid (B, KH), as decode.
//
// Block (b, kh) first writes lanes [kh*HD, (kh+1)*HD) of k_new[b] and
// v_new[b] into layer `layer`, page write_flat[b] / bs, row write_flat[b] %
// bs (K row, and the V row bs rows later); a slot outside [0, nb*bs) writes
// nothing. Then __syncthreads() and the decode loop, which reads the row
// back from the cache, as the TPU kernel does (write_flat need not be
// position kv_len - 1). A block reads only its own kv head's lanes, and a
// sequence writes only into its own last page (shared prefix pages are
// full), so no block depends on another block's write. The cache pointer is
// not __restrict__ and the loop's cache loads are coherent (load_cache16).
// ---------------------------------------------------------------------------

template <typename T, int G>
__global__ void __launch_bounds__(kDecodeWarps * 32)
paged_decode_write_kernel(const T* __restrict__ q, T* cache,
                          const T* __restrict__ k_new,
                          const T* __restrict__ v_new,
                          const int* __restrict__ write_flat,
                          const int* __restrict__ tables,
                          const int* __restrict__ kv_lens,
                          T* __restrict__ out, int nb, int bs, int KH, int W,
                          int layer, int window, float scale, float softcap) {
  const int b = blockIdx.x;
  const int kh = blockIdx.y;
  const size_t lanes = (size_t)KH * kHeadDim;
  const int wf = write_flat[b];
  if (wf >= 0 && wf < nb * bs) {
    T* krow = cache + (((size_t)layer * nb + wf / bs) * 2 * bs + wf % bs) * lanes +
              (size_t)kh * kHeadDim;
    T* vrow = krow + (size_t)bs * lanes;
    const size_t src = (size_t)b * lanes + (size_t)kh * kHeadDim;
    for (int i = threadIdx.x; i < kHeadDim; i += blockDim.x) {
      krow[i] = k_new[src + i];
      vrow[i] = v_new[src + i];
    }
  }
  __syncthreads();
  decode_body<T, G, true>(q, cache, tables, kv_lens, out, nb, bs, KH, W,
                          layer, window, scale, softcap);
}

// ---------------------------------------------------------------------------
// Prefill: grid (ceil(T / TQ), B, KH), block 128 threads.
//
// A block holds kRows = TQ * G query rows (TQ consecutive positions times
// the G heads of one kv head) and walks key chunks of kKeys from the first
// row's window start up to the tile's causal horizon. Each thread owns a
// 4 x 4 tile of the score chunk (rows tr + 16i, keys tk + 8j) and the same
// four rows of the output accumulator, so the row statistics it computes
// for the softmax are the ones it applies to its accumulator.
// ---------------------------------------------------------------------------

constexpr int kPrefillThreads = 128;
constexpr int kRows = 64;
constexpr int kKeys = 32;
constexpr int kHDP = kHeadDim + 1;  // padded row: spreads smem banks
constexpr int kKP = kKeys + 1;
constexpr size_t kPrefillSmem =
    sizeof(float) * ((size_t)kRows * kHDP + (size_t)kKeys * kHDP +
                     (size_t)kKeys * kHeadDim + (size_t)kRows * kKP);

template <typename T, int G>
__global__ void __launch_bounds__(kPrefillThreads)
paged_prefill_kernel(const T* __restrict__ q, const T* __restrict__ cache,
                     const int* __restrict__ tables,
                     const int* __restrict__ kv_lens,
                     const int* __restrict__ starts, T* __restrict__ out,
                     int T_len, int nb, int bs, int KH, int W, int layer,
                     int window, float scale, float softcap) {
  using VT = VecTraits<T>;
  constexpr int HD = kHeadDim;
  constexpr int VEC = VT::kVec;
  constexpr int CPR = HD / VEC;  // 16-byte chunks per row
  constexpr int TQ = kRows / G;
  constexpr int DPT = HD / 8;  // accumulator columns per thread

  extern __shared__ float smem[];
  float* sQ = smem;                // [kRows][kHDP]
  float* sK = sQ + kRows * kHDP;   // [kKeys][kHDP]
  float* sV = sK + kKeys * kHDP;   // [kKeys][HD]
  float* sP = sV + kKeys * HD;     // [kRows][kKP]

  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const int kh = blockIdx.z;
  const int H = KH * G;
  const int tid = threadIdx.x;
  const int tr = tid / 8;  // 0..15
  const int tk = tid % 8;  // 0..7

  const int kv_len = kv_lens[b];
  const int start = starts[b];
  const int t0 = tile * TQ;
  const int t_end = min(t0 + TQ, T_len);  // ragged end of T
  const int win = window_eff(window);
  // Keys the tile may read: from its first row's window start up to its
  // last row's causal horizon (never past kv_len).
  const int k_lo = max(start + t0 + 1 - win, 0);
  const int k_hi = min(kv_len, start + t_end);

  for (int idx = tid; idx < kRows * CPR; idx += kPrefillThreads) {
    const int r = idx / CPR, c = idx % CPR;
    const int t = t0 + r / G, g = r % G;
    float f[VEC];
    if (t < t_end) {
      VT::to_float(
          load16(q + (((size_t)b * T_len + t) * H + kh * G + g) * HD + c * VEC),
          f);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) f[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) sQ[r * kHDP + c * VEC + i] = f[i];
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

  const size_t lanes = (size_t)KH * HD;
  const size_t page_stride = 2 * (size_t)bs * lanes;
  const T* layer_base =
      cache + (size_t)layer * nb * page_stride + (size_t)kh * HD;
  const int* trow = tables + (size_t)b * W;

  for (int kb = k_lo; kb < k_hi; kb += kKeys) {
    __syncthreads();  // the previous chunk's readers are done
    for (int idx = tid; idx < kKeys * CPR; idx += kPrefillThreads) {
      const int key = idx / CPR, c = idx % CPR;
      const int kp = kb + key;
      float kf[VEC], vf[VEC];
      if (kp < k_hi) {
        const T* src = layer_base +
                       (size_t)trow[min(kp / bs, W - 1)] * page_stride +
                       (size_t)(kp % bs) * lanes + c * VEC;
        VT::to_float(load16(src), kf);
        VT::to_float(load16(src + (size_t)bs * lanes), vf);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) kf[i] = vf[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        sK[key * kHDP + c * VEC + i] = kf[i];
        sV[key * HD + c * VEC + i] = vf[i];
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
      for (int i = 0; i < 4; ++i) qa[i] = sQ[(tr + 16 * i) * kHDP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) ka[j] = sK[(tk + 8 * j) * kHDP + d];
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
        s[i][j] = live ? softcap_score(s[i][j], scale, softcap) : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      // The 8 threads of a row are lanes differing in their low 3 bits.
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float mn = fmaxf(m[i], mx);
      // No live key for this row yet (mn == -inf): fold nothing, p = 0.
      // The shuffles stay outside that branch: the four rows of a warp
      // may take different sides of it.
      const bool any = mn != -INFINITY;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = any ? expf(s[i][j] - mn) : 0.f;
        rs += s[i][j];
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      rs += __shfl_xor_sync(0xffffffffu, rs, 4);
      if (any) {
        const float alpha = expf(m[i] - mn);
        l[i] = l[i] * alpha + rs;
#pragma unroll
        for (int j = 0; j < DPT; ++j) acc[i][j] *= alpha;
        m[i] = mn;
      }
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

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr + 16 * i;
    const int t = t0 + r / G, g = r % G;
    if (t >= t_end) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    T* dst = out + (((size_t)b * T_len + t) * H + kh * G + g) * HD;
#pragma unroll
    for (int j = 0; j < DPT; ++j) dst[tk + 8 * j] = VT::store(acc[i][j] * inv);
  }
}

// ---------------------------------------------------------------------------
// Host-side dispatch.
// ---------------------------------------------------------------------------

template <typename T, int G>
cudaError_t launch_decode(const void* q, const void* cache, const int* tables,
                          const int* kv_lens, void* out, int B, int KH, int nb,
                          int bs, int W, int layer, int window, float scale,
                          float softcap, cudaStream_t stream) {
  dim3 grid(B, KH);
  paged_decode_kernel<T, G><<<grid, kDecodeWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(cache), tables, kv_lens,
      static_cast<T*>(out), nb, bs, KH, W, layer, window, scale, softcap);
  return cudaGetLastError();
}

template <typename T, int G>
cudaError_t launch_decode_write(const void* q, void* cache, const void* k_new,
                                const void* v_new, const int* write_flat,
                                const int* tables, const int* kv_lens,
                                void* out, int B, int KH, int nb, int bs,
                                int W, int layer, int window, float scale,
                                float softcap, cudaStream_t stream) {
  dim3 grid(B, KH);
  paged_decode_write_kernel<T, G><<<grid, kDecodeWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<T*>(cache),
      static_cast<const T*>(k_new), static_cast<const T*>(v_new), write_flat,
      tables, kv_lens, static_cast<T*>(out), nb, bs, KH, W, layer, window,
      scale, softcap);
  return cudaGetLastError();
}

template <typename T, int G>
cudaError_t launch_prefill(const void* q, const void* cache, const int* tables,
                           const int* kv_lens, const int* starts, void* out,
                           int B, int T_len, int KH, int nb, int bs, int W,
                           int layer, int window, float scale, float softcap,
                           cudaStream_t stream) {
  static bool smem_set = false;  // idempotent: a race only repeats the call
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_prefill_kernel<T, G>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kPrefillSmem);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  constexpr int TQ = kRows / G;
  dim3 grid((T_len + TQ - 1) / TQ, B, KH);
  paged_prefill_kernel<T, G><<<grid, kPrefillThreads, kPrefillSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(cache), tables, kv_lens,
      starts, static_cast<T*>(out), T_len, nb, bs, KH, W, layer, window,
      scale, softcap);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (the only one these kernels take). Returns a
// cudaError_t (0 = success).
extern "C" int pst_paged_decode(int dtype, const void* q, const void* cache,
                                const int* tables, const int* kv_lens,
                                void* out, int B, int H, int KH, int HD,
                                int nb, int bs, int W, int layer, int window,
                                float scale, float softcap, void* stream) {
  if (B == 0) return 0;
  if (HD != kHeadDim || KH <= 0 || H % KH) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PST_DECODE(TYPE, GG)                                                 \
  return (int)launch_decode<TYPE, GG>(q, cache, tables, kv_lens, out, B, KH, \
                                      nb, bs, W, layer, window, scale,       \
                                      softcap, s)
#define PST_DECODE_G(TYPE)          \
  switch (H / KH) {                 \
    case 1: PST_DECODE(TYPE, 1);    \
    case 2: PST_DECODE(TYPE, 2);    \
    case 4: PST_DECODE(TYPE, 4);    \
    case 8: PST_DECODE(TYPE, 8);    \
    default: return (int)cudaErrorInvalidValue; \
  }
  if (dtype == 0) { PST_DECODE_G(float) }  // bf16: decode_splitkv.cu
#undef PST_DECODE_G
#undef PST_DECODE
  return (int)cudaErrorInvalidValue;
}

// k_new, v_new: [B, KH*HD] in the cache dtype; write_flat: [B] int32.
extern "C" int pst_paged_decode_write(int dtype, const void* q, void* cache,
                                      const void* k_new, const void* v_new,
                                      const int* write_flat,
                                      const int* tables, const int* kv_lens,
                                      void* out, int B, int H, int KH, int HD,
                                      int nb, int bs, int W, int layer,
                                      int window, float scale, float softcap,
                                      void* stream) {
  if (B == 0) return 0;
  if (HD != kHeadDim || KH <= 0 || H % KH) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PST_DECODE_WRITE(TYPE, GG)                                          \
  return (int)launch_decode_write<TYPE, GG>(                                \
      q, cache, k_new, v_new, write_flat, tables, kv_lens, out, B, KH, nb,  \
      bs, W, layer, window, scale, softcap, s)
#define PST_DECODE_WRITE_G(TYPE)        \
  switch (H / KH) {                     \
    case 1: PST_DECODE_WRITE(TYPE, 1);  \
    case 2: PST_DECODE_WRITE(TYPE, 2);  \
    case 4: PST_DECODE_WRITE(TYPE, 4);  \
    case 8: PST_DECODE_WRITE(TYPE, 8);  \
    default: return (int)cudaErrorInvalidValue; \
  }
  if (dtype == 0) { PST_DECODE_WRITE_G(float) }  // bf16: decode_splitkv.cu
#undef PST_DECODE_WRITE_G
#undef PST_DECODE_WRITE
  return (int)cudaErrorInvalidValue;
}

extern "C" int pst_paged_prefill(int dtype, const void* q, const void* cache,
                                 const int* tables, const int* kv_lens,
                                 const int* starts, void* out, int B, int T_len,
                                 int H, int KH, int HD, int nb, int bs, int W,
                                 int layer, int window, float scale,
                                 float softcap, void* stream) {
  if (B == 0 || T_len == 0) return 0;
  if (HD != kHeadDim || KH <= 0 || H % KH) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PST_PREFILL(TYPE, GG)                                                \
  return (int)launch_prefill<TYPE, GG>(q, cache, tables, kv_lens, starts,   \
                                       out, B, T_len, KH, nb, bs, W, layer, \
                                       window, scale, softcap, s)
#define PST_PREFILL_G(TYPE)         \
  switch (H / KH) {                 \
    case 1: PST_PREFILL(TYPE, 1);   \
    case 2: PST_PREFILL(TYPE, 2);   \
    case 4: PST_PREFILL(TYPE, 4);   \
    case 8: PST_PREFILL(TYPE, 8);   \
    default: return (int)cudaErrorInvalidValue; \
  }
  if (dtype == 0) { PST_PREFILL_G(float) }  // bf16: prefill_wgmma.cu
#undef PST_PREFILL_G
#undef PST_PREFILL
  return (int)cudaErrorInvalidValue;
}
