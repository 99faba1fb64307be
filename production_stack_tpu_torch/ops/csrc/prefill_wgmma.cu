// Chunked-prefill paged attention in bf16 on Hopper's tensor cores (wgmma).
//
// Replaces, for bf16, production_stack_tpu/ops/paged_attention_pallas.py::
// _prefill_kernel (launched by _prefill_call). The fp32 route keeps the
// CUDA-core paged_prefill_kernel of paged_attention.cu. The contract is that
// kernel's, unchanged:
//   q      [B, T, H, 128] bf16      cache [L, nb, 2, bs, KH*128] bf16
//   tables [B, W] int32             kv_lens, starts [B] int32
// Row t of sequence b sits at position pos = starts[b] + t and attends to
// the keys in [max(pos + 1 - window, 0), min(pos + 1, kv_len)); scores are
// scaled, then soft-capped; a row with no live key writes zeros; a ragged
// T is masked here; G = H / KH in {1, 2, 4, 8}.
//
// Design. Grid (KH, B, ceil(T / (128 / G))), 256 threads = two consumer
// warpgroups. A block owns one (sequence, kv head) and 128 query rows:
// 128 / G positions times the G heads of the kv head, position-major; each
// warpgroup owns 64 of them (one wgmma M tile). The tile index runs
// backwards along gridDim.z, so the tiles with the longest causal key
// range start first.
//   - Q is loaded once into shared memory (cp.async, rows past T zeroed).
//   - Keys go in tiles of 64. Each 16-byte piece of a K or V row is
//     gathered through the block table (any block size works) by cp.async
//     into a 4-slot ring, two tiles ahead, zero-filled past the block's key
//     range, in the 128-byte-swizzled layout the wgmma descriptors read.
//     Tiles wholly outside the block's causal and window range are never
//     loaded. mbarriers, not block barriers, hand the slots over: a slot is
//     full once every thread's copies into it have landed
//     (cp.async.mbarrier.arrive), and empty once every warp is done with
//     it. So the two warpgroups do not meet at every tile, and one runs its
//     softmax while the other's products run. (Making them take turns at
//     the tensor cores with named barriers, or skipping a tile that none of
//     a warpgroup's rows sees, was slower on an NVIDIA H100 80GB HBM3 at
//     700 W: the skip's branch around the products makes ptxas serialize
//     the wgmmas.)
//   - S = Q Kᵀ: 8 x wgmma m64n64k16, both operands from shared memory,
//     K-major. The online softmax runs in fp32 (log2 domain) on the
//     accumulator registers; each register's (row, key) comes from the
//     fragment layout, which gives the causal / window / kv_len masks.
//   - P is rounded to bf16 in registers and used directly as the register
//     A operand of 4 x wgmma m64n128k16 for O += P V, V read from shared
//     memory MN-major (transposed B), so P never touches shared memory.
//   - O, m and l stay in registers; the epilogue divides by l and writes
//     bf16.
// Shared memory: Q 32 KB + 4 slots x (K 16 KB + V 16 KB) = 160 KB (+1 KB
// for alignment), one block per SM, 8 warps.
//
// Bound on an NVIDIA H100 80GB HBM3 at its 700 W limit (data sheet: 989
// TFLOP/s bf16 dense, 3.35 TB/s): operations,
// 4 * H * 128 * T * (start + T/2) FLOP per layer for a causal chunk (the
// window lowers it): at H = 32, a fresh T = 512 chunk is 2.15 GFLOP,
// 0.0022 ms; T = 512 at start 3584 is 32.2 GFLOP, 0.0326 ms; a fresh
// T = 2048 chunk 34.4 GFLOP, 0.0348 ms. The fresh T = 512 chunk reads
// 4.2 MB of q/out and 1 MB of K/V: 0.0031 ms of bytes, so it is bound by
// bytes (PERF.md has the measured times).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using namespace pst_sm90;

constexpr int kHD = 128;
constexpr int kRows = 128;  // query rows per block
constexpr int kKeys = 64;   // keys per tile
constexpr int kStages = 4;  // K/V ring slots
constexpr int kAhead = 2;   // key tiles loaded ahead of the current
constexpr int kThreads = 256;
constexpr int kQBytes = kRows * kHD * 2;        // 32 KB: 2 x [128 x 64]
constexpr int kQHalf = kRows * 128;             // one 64-dim half of Q
constexpr int kKVBytes = kKeys * kHD * 2;       // 16 KB: K (or V) of a tile
constexpr int kKVHalf = kKeys * 128;            // one 64-dim half of K / V
constexpr int kStageBytes = 2 * kKVBytes;
constexpr int kSmem = kQBytes + kStages * kStageBytes + 1024;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

template <int G>
__global__ void __launch_bounds__(kThreads, 1)
paged_prefill_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ cache,
                           const int* __restrict__ tables,
                           const int* __restrict__ kv_lens,
                           const int* __restrict__ starts,
                           __nv_bfloat16* __restrict__ out, int T_len, int nb,
                           int bs, int KH, int W, int layer, int window,
                           float scale, float softcap) {
  constexpr int TQ = kRows / G;  // positions per block
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t sQ = smem_u32(align1024(smem_raw));
  const uint32_t sKV = sQ + kQBytes;

  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int tile = gridDim.z - 1 - blockIdx.z;  // longest key range first
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int quad = lane & 3;
  const int H = KH * G;

  const int kv_len = kv_lens[b];
  const int start = starts[b];
  const int t0 = tile * TQ;
  const int t_end = min(t0 + TQ, T_len);
  const int win = window > 0 ? window : (1 << 30);
  // Keys any row of the block sees.
  const int k_lo = max(start + t0 + 1 - win, 0);
  const int k_hi = min(kv_len, start + t_end);
  const int n_kv = k_hi > k_lo ? (k_hi - k_lo + kKeys - 1) / kKeys : 0;

  // Q: 128 rows x 16 chunks of 16 bytes; row r is (t0 + r / G, head g).
  for (int i = tid; i < kRows * 16; i += kThreads) {
    const int r = i / 16, c = i % 16;
    const int t = t0 + r / G, g = r % G;
    const bool ok = t < t_end;
    const __nv_bfloat16* src =
        ok ? q + (((size_t)b * T_len + t) * H + kh * G + g) * kHD + c * 8 : q;
    cp_async16(sQ + (c / 8) * kQHalf + sw128(r, c % 8), src, ok);
  }
  cp_async_commit();

  const size_t lanes = (size_t)KH * kHD;
  const size_t page_stride = 2 * (size_t)bs * lanes;
  const __nv_bfloat16* layer_base =
      cache + (size_t)layer * nb * page_stride + (size_t)kh * kHD;
  const int* trow = tables + (size_t)b * W;

  // Key tile `it` into ring slot `slot`: thread tid copies chunk tid % 16
  // of keys tid / 16 + 16j, for K and V.
  auto load_kv = [&](int it, int slot) {
    const int kb = k_lo + it * kKeys;
    const uint32_t sK = sKV + slot * kStageBytes;
    const uint32_t sV = sK + kKVBytes;
    const int c = tid % 16;
#pragma unroll
    for (int j = 0; j < kKeys * 16 / kThreads; ++j) {
      const int r = tid / 16 + 16 * j;
      const int kp = kb + r;
      const bool ok = kp < k_hi;
      const __nv_bfloat16* src = cache;
      if (ok) {
        src = layer_base + (size_t)trow[min(kp / bs, W - 1)] * page_stride +
              (size_t)(kp % bs) * lanes + c * 8;
      }
      const uint32_t off = (c / 8) * kKVHalf + sw128(r, c % 8);
      cp_async16(sK + off, src, ok);
      cp_async16(sV + off, ok ? src + (size_t)bs * lanes : cache, ok);
    }
  };

  // Ring slot s is full once every thread's copies into it (and, for the
  // first tile, Q) have landed, and empty once every warp is done with it.
  __shared__ __align__(8) uint64_t bars[2 * kStages];
  const uint32_t full0 = smem_u32(bars);
  const uint32_t empty0 = full0 + 8 * kStages;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, kThreads);
      mbar_init(empty0 + 8 * s, kThreads / 32);
    }
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < kAhead; ++s) {
    if (s < n_kv) {
      load_kv(s, s);
      cp_async_mbar_arrive(full0 + 8 * s);
    }
  }

  // This thread's two rows of its warpgroup's M tile (fragment rows
  // 16 * warp + lane / 4 and + 8) and their live key ranges.
  int low[2], bound[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = 64 * wg + 16 * warp + lane / 4 + 8 * h;
    const int t = t0 + m / G;
    const int pos = start + t;
    bound[h] = t < t_end ? min(pos + 1, kv_len) : 0;
    low[h] = max(pos + 1 - win, 0);
  }
  const bool capped = softcap > 0.f;
  const float c_scale = capped ? scale / softcap : scale * kLog2e;
  const float c_cap = softcap * kLog2e;

  float o[64], s[32];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // this thread's share of the row sum

  const uint32_t qa = sQ + wg * 64 * 128;
  for (int it = 0; it < n_kv; ++it) {
    const int nx = it + kAhead;  // refill the slot of tile nx - kStages
    if (nx < n_kv) {
      const int ns = nx % kStages;
      if (nx >= kStages) mbar_wait(empty0 + 8 * ns, (nx / kStages - 1) & 1);
      load_kv(nx, ns);
      cp_async_mbar_arrive(full0 + 8 * ns);
    }
    const int slot = it % kStages;
    mbar_wait(full0 + 8 * slot, (it / kStages) & 1);
    fence_proxy_async();  // the landed tiles, to wgmma's async proxy
    const int kb = k_lo + it * kKeys;
    const uint32_t sK = sKV + slot * kStageBytes;
    const uint32_t sV = sK + kKVBytes;

    // S = Q Kᵀ over the 128 dims: 8 k-steps of 16.
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      const uint64_t da =
          desc_sw128(qa + (ks / 4) * kQHalf + (ks % 4) * 32, 16, 1024);
      const uint64_t db =
          desc_sw128(sK + (ks / 4) * kKVHalf + (ks % 4) * 32, 16, 1024);
      wgmma_m64n64k16_ss(s, da, db, ks > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // Register i holds row h = (i / 2) % 2, key kb + 8 * (i / 4) +
    // 2 * quad + i % 2. A tile that none of a row's keys is in leaves the
    // row as it was (every p is 0, alpha 1).
    const bool masked = kb < low[0] || kb + kKeys > bound[0] ||
                        kb < low[1] || kb + kKeys > bound[1];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float v = capped ? tanhf(s[i] * c_scale) * c_cap : s[i] * c_scale;
      if (masked) {
        const int h = (i >> 1) & 1;
        const int key = kb + 8 * (i >> 2) + 2 * quad + (i & 1);
        if (key < low[h] || key >= bound[h]) v = -INFINITY;
      }
      s[i] = v;
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mx = fmaxf(mx, fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[h], mx);
      // No live key for the row yet: every p is 0 and nothing is rescaled.
      const float base = m_new == -INFINITY ? 0.f : m_new;
      alpha[h] = fast_exp2(m_run[h] - base);
      m_run[h] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p0 = fast_exp2(s[4 * j + 2 * h] - base);
        const float p1 = fast_exp2(s[4 * j + 2 * h + 1] - base);
        s[4 * j + 2 * h] = p0;
        s[4 * j + 2 * h + 1] = p1;
        rs += p0 + p1;
      }
      l_run[h] = l_run[h] * alpha[h] + rs;
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] *= alpha[(i >> 1) & 1];

    // P as the A fragments of the 4 key k-steps: register r of k-step kk
    // holds S registers 8 * kk + 2 * r and + 1.
    uint32_t p[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        p[kk][r] = pack_bf16x2(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);

    // O += P V: V is [64 keys x 128 dims], dims contiguous (MN-major B);
    // lbo = the next 64-dim half, sbo = the next 8 keys.
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t db = desc_sw128(sV + kk * 16 * 128, kKVHalf, 1024);
      wgmma_m64n128k16_rs<1>(o, p[kk], db, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    if (lane == 0) mbar_arrive(empty0 + 8 * slot);  // this warp is done
  }
  cp_async_wait<0>();

  // Register i of O holds row h = (i / 2) % 2, dim 8 * (i / 4) + 2 * quad +
  // i % 2.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_run[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = l > 0.f ? 1.f / l : 0.f;
    const int m = 64 * wg + 16 * warp + lane / 4 + 8 * h;
    const int t = t0 + m / G, g = m % G;
    if (t >= t_end) continue;
    __nv_bfloat16* dst =
        out + (((size_t)b * T_len + t) * H + kh * G + g) * kHD + 2 * quad;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) = __floats2bfloat162_rn(
          o[4 * j + 2 * h] * inv, o[4 * j + 2 * h + 1] * inv);
    }
  }
}

template <int G>
cudaError_t launch(const void* q, const void* cache, const int* tables,
                   const int* kv_lens, const int* starts, void* out, int B,
                   int T_len, int KH, int nb, int bs, int W, int layer,
                   int window, float scale, float softcap,
                   cudaStream_t stream) {
  static bool smem_set = false;  // idempotent: a race only repeats the call
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_prefill_wgmma_kernel<G>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  constexpr int TQ = kRows / G;
  dim3 grid(KH, B, (T_len + TQ - 1) / TQ);
  paged_prefill_wgmma_kernel<G><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(cache), tables, kv_lens, starts,
      static_cast<__nv_bfloat16*>(out), T_len, nb, bs, KH, W, layer, window,
      scale, softcap);
  return cudaGetLastError();
}

}  // namespace

// bf16 only. Returns a cudaError_t (0 = success).
extern "C" int pst_paged_prefill_wgmma(const void* q, const void* cache,
                                       const int* tables, const int* kv_lens,
                                       const int* starts, void* out, int B,
                                       int T_len, int H, int KH, int HD,
                                       int nb, int bs, int W, int layer,
                                       int window, float scale, float softcap,
                                       void* stream) {
  if (B == 0 || T_len == 0) return 0;
  if (HD != kHD || KH <= 0 || H % KH || B > 65535 || KH > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PST_PREFILL(GG)                                                     \
  return (int)launch<GG>(q, cache, tables, kv_lens, starts, out, B, T_len, \
                         KH, nb, bs, W, layer, window, scale, softcap, s)
  switch (H / KH) {
    case 1: PST_PREFILL(1);
    case 2: PST_PREFILL(2);
    case 4: PST_PREFILL(4);
    case 8: PST_PREFILL(8);
    default: return (int)cudaErrorInvalidValue;
  }
#undef PST_PREFILL
}
