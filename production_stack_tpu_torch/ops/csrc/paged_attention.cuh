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
//   paged_decode_kernel<..., false> <- _decode_kernel (one query token per
//                                      sequence)
//   paged_decode_kernel<..., true>  <- _decode_write_kernel (the decode step
//                                      with this step's K/V row written into
//                                      its page; PST_FUSED_KV_WRITE=1)
//   paged_prefill_kernel            <- _prefill_kernel (chunked-prefill
//                                      flash attention)
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
// cores): decode and decode-write read every live K/V row once (bytes).
// Prefill is bound by operations, 4*H*HD*T*(start+T/2) FLOP per layer, run
// on the CUDA cores in fp32 so that the products are not rounded to bf16.
//
// Decode design: grid (B, KH, S), 8 warps. The keys of each (sequence, kv
// head) are cut into S runs of tiles (splits.cuh's split_run, as the
// split-KV kernel cuts them); S comes from a plan of shapes only
// (simt_decode_plan in paged_attention_cuda.py: as many as fill one wave
// of the blocks an SM's shared memory holds, at most one a tile and one a
// 256 KB of K and V), and the S partial states merge in the same launch
// through splits.cuh's ticket, in split order, so two launches give the
// same bits. A tile (about 16 KB of K rows) is gathered through the table
// by cp.async into a 3-slot ring, so two tiles are in flight while one is
// read. A tile's scores of a lane group are computed first, then one max
// update, one rescale and the exp2s of the tile (log2 domain); the
// softcap's tanhf runs only with a softcap. Measured on an NVIDIA H100
// 80GB HBM3 at 700 W (PERF.md), at fp32 Llama-3-8B heads, B = 8 x 4096
// (the byte bound 0.080 ms): the previous form (grid (B, KH), each lane
// four key rows in flight, two expf a key) 0.437 ms; this one at 4 warps
// a block 0.167, at 8 warps 0.101. At tiny-llama-debug's heads (B = 8 x
// 1024, 8.4 MB) it is 0.0092 ms at one split (0.0086-0.0095 at 2 to 8)
// against an empty kernel's 0.0019 queued the same way: the table, the
// data and (with S > 1) the merge's fence, ticket and reload are serial
// round trips, so a row's 128 KB takes one split.
//
// Prefill design: grid (KH, B, q-tiles * S), 8 warps; a 128-row q-tile
// (64 at HD 256) walks 32-key tiles (16 at HD 256) of its split's run out
// of a 3-slot cp.async ring, a lane computing 4 x 4 scores (2 x 2 at HD
// 256) from 16-byte shared loads and sharing p by shuffle for P.V; S from
// a plan of shapes only (simt_prefill_plan), the runs merged in the launch
// through splits.cuh as the decode's are. The previous form (grid (T /
// TQ, B, KH), 4 warps, one 32-key chunk at a time loaded synchronously,
// three barriers a chunk, scalar shared loads) took 0.0228 ms at
// tiny-llama-debug's heads (T = 256) and 1.647 ms at fp32 Llama-3-8B heads
// (T = 512 at 3584); the figures of this form are in PERF.md.
//
// Decode-write: blocks of a launch are not ordered, so no block reads the
// row this step writes: every split casts the new K and V rows (by
// to_cache) into shared memory and substitutes them for the key whose
// flat slot table[pos / bs] * bs + pos % bs is write_flat[b]; split 0
// alone stores them into the cache; a slot outside [0, nb*bs) stores and
// substitutes nothing. This needs the rule the engine keeps (checked on
// the CPU by tests/test_torch_decode_split.py): a sequence writes only
// into its own last page, and shared prefix pages are full, so no other
// row reads the written slot in the same step.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "fp8.cuh"
#include "sm90.cuh"
#include "splits.cuh"

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
  void* out;
  int B, T, KH, G, HD, nb, bs, W, layer, window;
  float scale, softcap;
  cudaStream_t stream;
};

// A decode launch: Params, the split count and, with S > 1, the splits'
// partial states and B*KH tickets (zero, and left zero). (Three more
// fields in this struct once moved ptxas to spill in the prefill, which
// took it then: the prefill has its own, PrefillLaunch.)
struct Launch {
  Params p;
  int splits;
  float* ws;
  int* counters;
};

// ---------------------------------------------------------------------------
// Four consecutive elements (16, 8 or 4 bytes) loaded through the
// read-only path (ld.global.nc, not coherent with stores made earlier in
// the same kernel: every caller reads what its launch does not write) and
// converted to fp32.
// ---------------------------------------------------------------------------

constexpr int kVec = 4;  // values a load

template <typename V>
__device__ __forceinline__ V load_vec(const void* p) {
  return __ldg(reinterpret_cast<const V*>(p));
}

template <typename T>
struct Vec4;

template <>
struct Vec4<float> {
  __device__ static inline void load(const float* p, float* o) {
    const uint4 r = load_vec<uint4>(p);
    o[0] = __uint_as_float(r.x);
    o[1] = __uint_as_float(r.y);
    o[2] = __uint_as_float(r.z);
    o[3] = __uint_as_float(r.w);
  }
  __device__ static inline float store(float v) { return v; }
};

template <>
struct Vec4<bf16> {
  __device__ static inline void load(const bf16* p, float* o) {
    const uint2 r = load_vec<uint2>(p);
    o[0] = __uint_as_float(r.x << 16);
    o[1] = __uint_as_float(r.x & 0xffff0000u);
    o[2] = __uint_as_float(r.y << 16);
    o[3] = __uint_as_float(r.y & 0xffff0000u);
  }
  __device__ static inline bf16 store(float v) { return __float2bfloat16(v); }
};

template <>
struct Vec4<e4m3> {
  __device__ static inline void load(const e4m3* p, float* o) {
    const unsigned r = load_vec<unsigned>(p);
    const float2 a = pst_fp8::e4m3x2_to_float2(r);
    const float2 b = pst_fp8::e4m3x2_to_float2(r >> 16);
    o[0] = a.x;
    o[1] = a.y;
    o[2] = b.x;
    o[3] = b.y;
  }
};

// The decode's four values from its shared-memory ring, converted to fp32
// as Vec4 converts them.
__device__ __forceinline__ void lds4(const float* p, float* o) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  o[0] = r.x;
  o[1] = r.y;
  o[2] = r.z;
  o[3] = r.w;
}
__device__ __forceinline__ void lds4(const bf16* p, float* o) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  o[0] = __uint_as_float(r.x << 16);
  o[1] = __uint_as_float(r.x & 0xffff0000u);
  o[2] = __uint_as_float(r.y << 16);
  o[3] = __uint_as_float(r.y & 0xffff0000u);
}
__device__ __forceinline__ void lds4(const e4m3* p, float* o) {
  const unsigned r = *reinterpret_cast<const unsigned*>(p);
  const float2 a = pst_fp8::e4m3x2_to_float2(r);
  const float2 b = pst_fp8::e4m3x2_to_float2(r >> 16);
  o[0] = a.x;
  o[1] = a.y;
  o[2] = b.x;
  o[3] = b.y;
}

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
// Decode and decode-write: grid (B, KH, S), kDecodeThreads threads.
//
// A key row of one kv head is HD values = LPK lanes of VPL values (4, or
// HD / 32 where that is more: 8 at HD 256), so a warp takes KPW = 32 / LPK
// keys a step. The block's run of key tiles (split_run, as the split-KV
// kernel cuts them) is gathered through the table by cp.async into a
// kDecodeStages-slot ring; warp w takes keys (i * kDecodeWarps + w) * KPW
// + lane / LPK of a tile in its steps i = 0 .. kSteps - 1, each lane group
// with its own (m, l, acc) for the GM heads. A tile's kSteps scores of a
// lane group are computed first, then one max update, one rescale and
// kSteps exp2s (log2 domain) a head. The lane groups merge by shuffles,
// the warps in shared memory, the splits through splits.cuh's ticket in
// split order. GM >= G heads (1, 2, 4, 8); heads G.. GM - 1 run on zero
// queries and are never stored.
// ---------------------------------------------------------------------------

constexpr int kDecodeWarps = 8;
constexpr int kDecodeThreads = 32 * kDecodeWarps;
constexpr int kDecodeStages = 3;
constexpr int kDecodeMaxSplits = 64;
constexpr int kDecodePageCap = 1024;  // table entries kept in shared memory
constexpr float kLog2e = 1.4426950408889634f;

// The tile of a cache of Tc at head dim HD (paged_attention_cuda.py's
// simt_tile mirrors kKeys): about 16 KB of K rows, at most 8 steps a warp
// and 128 keys.
template <typename Tc, int HD>
struct SimtGeo {
  static constexpr int VPL = HD / 4 > 32 ? HD / 32 : 4;  // values a lane
  static constexpr int LPK = HD / VPL;                    // lanes a key row
  static constexpr int KPW = 32 / LPK;                    // keys a warp step
  static constexpr int kRowBytes = HD * (int)sizeof(Tc);
  static constexpr int kStepKeys = kDecodeWarps * KPW;
  static constexpr int kByBytes = 16384 / kRowBytes;
  static constexpr int kCap = 8 * kStepKeys < 128 ? 8 * kStepKeys : 128;
  static constexpr int kKeys =
      kByBytes < kStepKeys ? kStepKeys : (kByBytes < kCap ? kByBytes : kCap);
  static constexpr int kSteps = kKeys / kStepKeys;
  static constexpr int kChunks = kRowBytes / 16;  // 16-byte pieces a row
  static constexpr int kPieces = kKeys * kChunks;  // of K (and of V) a tile
  static constexpr int kTileBytes = kKeys * kRowBytes;
  static constexpr int kSmem = kDecodeStages * 2 * kTileBytes;
  static_assert(LPK <= 32 && 32 % LPK == 0, "head_dim / lane mismatch");
  static_assert(kKeys % kStepKeys == 0 && kSteps <= 8, "steps a tile");
};

template <typename Tq, typename Tc, int GM, int HD, bool kWrite>
__global__ void __launch_bounds__(kDecodeThreads)
paged_decode_kernel(const Launch dp) {
  const Params& p = dp.p;
  using Gm = SimtGeo<Tc, HD>;
  constexpr int VPL = Gm::VPL, LPK = Gm::LPK, KPW = Gm::KPW;
  constexpr int kKeys = Gm::kKeys, kSteps = Gm::kSteps;
  static_assert(kDecodeWarps * GM * (HD + 2) * 4 <= Gm::kSmem,
                "the warps' states fit the ring");
  static_assert(2 * kDecodeMaxSplits * GM * 4 <= Gm::kSmem,
                "the merge's weights fit the ring");
  extern __shared__ __align__(16) uint8_t ring[];
  __shared__ int sPages[kDecodePageCap];
  // Decode-write: the new K and V rows in the cache's type.
  __shared__ __align__(16) uint8_t sNew[2][kWrite ? Gm::kRowBytes : 16];
  __shared__ float sL[GM];

  const Tq* q = static_cast<const Tq*>(p.q);
  const Tc* cache = static_cast<const Tc*>(p.cache);
  const int b = blockIdx.x;
  const int kh = blockIdx.y;
  const int split = blockIdx.z;
  const int S = gridDim.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int G = p.G;
  const int H = p.KH * G;
  const int sub = lane / LPK;  // which key of the warp step
  const int sl = lane % LPK;   // which VPL-value slice of the row

  const int kv_len = p.kv_lens[b];
  // The query sits at position kv_len - 1 and sees keys >= kv_len - window:
  // tiles wholly below that are never read.
  const int lo = max(kv_len - window_eff(p.window), 0);
  int t0;
  const int n_t = pst_splits::split_run(lo, kv_len, kKeys, split, S, t0);

  const size_t lanes = (size_t)p.KH * HD;
  const size_t page_stride = 2 * (size_t)p.bs * lanes;
  const Tc* layer_base =
      cache + (size_t)p.layer * p.nb * page_stride + (size_t)kh * HD;
  const int* trow = p.tables + (size_t)b * p.W;

  // Decode-write: this step's row cast into the cache's type (sNew), which
  // every split substitutes for the key at the write slot and split 0
  // alone stores. No block reads the slot from the cache: blocks of a
  // launch are not ordered.
  int wf = -1;
  if constexpr (kWrite) {
    const int w = p.write_flat[b];
    if (w >= 0 && w < p.nb * p.bs) {
      wf = w;
      Tc* krow = static_cast<Tc*>(p.cache) +
                 (((size_t)p.layer * p.nb + w / p.bs) * 2 * p.bs + w % p.bs) *
                     lanes +
                 (size_t)kh * HD;
      const size_t src = (size_t)b * lanes + (size_t)kh * HD;
      const Tq* kn = static_cast<const Tq*>(p.k_new) + src;
      const Tq* vn = static_cast<const Tq*>(p.v_new) + src;
      for (int i = tid; i < HD; i += kDecodeThreads) {
        const Tc kc = to_cache<Tc>(to_float(kn[i]));
        const Tc vc = to_cache<Tc>(to_float(vn[i]));
        reinterpret_cast<Tc*>(sNew[0])[i] = kc;
        reinterpret_cast<Tc*>(sNew[1])[i] = vc;
        if (split == 0) {
          krow[i] = kc;
          krow[(size_t)p.bs * lanes + i] = vc;
        }
      }
    }
  }

  // The block's slice of the table row, loaded once up front: entries
  // [p_lo, p_lo + kDecodePageCap) live in shared memory, any beyond are
  // read from the table.
  const int p_lo = min(t0 * kKeys / p.bs, p.W - 1);
  const int p_n = min((t0 + n_t) * kKeys / p.bs, p.W - 1) + 1 - p_lo;
  for (int i = tid; i < min(p_n, kDecodePageCap); i += kDecodeThreads)
    sPages[i] = __ldg(trow + p_lo + i);
  __syncthreads();  // sPages and sNew
  auto page_of = [&](int pos) {
    // A table shorter than kv_len is a caller error; the clamp (as in the
    // TPU kernel's page loop) keeps the read inside the table.
    const int pi = min(pos / p.bs, p.W - 1) - p_lo;
    return pi < kDecodePageCap ? sPages[pi] : __ldg(trow + p_lo + pi);
  };
  // Thread tid copies 16-byte pieces tid + j * kDecodeThreads of a tile's
  // K rows (and the same of its V rows), row-major: piece i is chunk i %
  // kChunks of row i / kChunks. Keys outside [lo, kv_len) are zero-filled.
  auto copy_tile = [&](int it) {
    uint8_t* const slot = ring + (it % kDecodeStages) * 2 * Gm::kTileBytes;
    const uint32_t sK = pst_sm90::smem_u32(slot);
    const uint32_t sV = sK + Gm::kTileBytes;
#pragma unroll
    for (int j = 0; j < (Gm::kPieces + kDecodeThreads - 1) / kDecodeThreads;
         ++j) {
      const int i = tid + j * kDecodeThreads;
      if (Gm::kPieces % kDecodeThreads && i >= Gm::kPieces) break;
      const int r = i / Gm::kChunks, c = i % Gm::kChunks;
      const int pos = (t0 + it) * kKeys + r;
      const bool ok = pos >= lo && pos < kv_len;
      const void* src_k = cache;  // a valid address when nothing is read
      const void* src_v = cache;
      if (ok) {
        const int pg = page_of(pos);
        if (kWrite && pg * p.bs + pos % p.bs == wf) {
          *reinterpret_cast<uint4*>(slot + 16 * i) =
              *reinterpret_cast<const uint4*>(&sNew[0][16 * c]);
          *reinterpret_cast<uint4*>(slot + Gm::kTileBytes + 16 * i) =
              *reinterpret_cast<const uint4*>(&sNew[1][16 * c]);
          continue;
        }
        const uint8_t* row = reinterpret_cast<const uint8_t*>(
            layer_base + (size_t)pg * page_stride +
            (size_t)(pos % p.bs) * lanes);
        src_k = row + 16 * c;
        src_v = row + (size_t)p.bs * lanes * sizeof(Tc) + 16 * c;
      }
      pst_sm90::cp_async16(sK + 16 * i, src_k, ok);
      pst_sm90::cp_async16(sV + 16 * i, src_v, ok);
    }
  };
#pragma unroll
  for (int s = 0; s < kDecodeStages - 1; ++s) {
    if (s < n_t) copy_tile(s);
    pst_sm90::cp_async_commit();
  }

  float qv[GM][VPL];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
#pragma unroll
    for (int v = 0; v < VPL; v += 4) {
      if (g < G) {
        Vec4<Tq>::load(
            q + ((size_t)b * H + kh * G + g) * HD + sl * VPL + v, qv[g] + v);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[g][v + i] = 0.f;
      }
    }
  }
  const bool capped = p.softcap > 0.f;
  const float c_scale = capped ? p.scale / p.softcap : p.scale * kLog2e;
  const float c_cap = p.softcap * kLog2e;
  float m[GM], l[GM], acc[GM][VPL];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < VPL; ++i) acc[g][i] = 0.f;
  }

  for (int it = 0; it < n_t; ++it) {
    pst_sm90::cp_async_wait<kDecodeStages - 2>();
    // Tile it has landed for every thread, and every thread is done with
    // tile it - 1, whose slot the next copy refills.
    __syncthreads();
    if (it + kDecodeStages - 1 < n_t) copy_tile(it + kDecodeStages - 1);
    pst_sm90::cp_async_commit();

    const Tc* const sk = reinterpret_cast<const Tc*>(
        ring + (it % kDecodeStages) * 2 * Gm::kTileBytes);
    const Tc* const sv = sk + kKeys * HD;
    const int key0 = (t0 + it) * kKeys + warp * KPW + sub;
    // Scores of this lane group's kSteps keys (log2 domain; -inf where
    // masked), then one max update a head. The softcap's branch is taken
    // once a tile, around the loops: tanhf is not evaluated without one.
    float x[kSteps][GM];
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      const int r = i * Gm::kStepKeys + warp * KPW + sub;
      float kf[VPL];
#pragma unroll
      for (int v = 0; v < VPL; v += 4) lds4(sk + r * HD + sl * VPL + v, kf + v);
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        float d = 0.f;
#pragma unroll
        for (int v = 0; v < VPL; ++v) d += qv[g][v] * kf[v];
#pragma unroll
        for (int off = LPK / 2; off > 0; off >>= 1)
          d += __shfl_xor_sync(0xffffffffu, d, off);
        x[i][g] = d;
      }
    }
    if (capped) {
#pragma unroll
      for (int i = 0; i < kSteps; ++i)
#pragma unroll
        for (int g = 0; g < GM; ++g) x[i][g] = tanhf(x[i][g] * c_scale) * c_cap;
    } else {
#pragma unroll
      for (int i = 0; i < kSteps; ++i)
#pragma unroll
        for (int g = 0; g < GM; ++g) x[i][g] *= c_scale;
    }
    float mx[GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) mx[g] = -INFINITY;
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      const int pos = key0 + i * Gm::kStepKeys;
      const bool live = pos >= lo && pos < kv_len;
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        x[i][g] = live ? x[i][g] : -INFINITY;
        mx[g] = fmaxf(mx[g], x[i][g]);
      }
    }
    float mb[GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      const float m_new = fmaxf(m[g], mx[g]);
      // No live key yet: every p is 0 and nothing is rescaled.
      mb[g] = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = pst_sm90::fast_exp2(m[g] - mb[g]);
      m[g] = m_new;
      l[g] *= alpha;
#pragma unroll
      for (int v = 0; v < VPL; ++v) acc[g][v] *= alpha;
    }
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      const int r = i * Gm::kStepKeys + warp * KPW + sub;
      float vf[VPL];
#pragma unroll
      for (int v = 0; v < VPL; v += 4) lds4(sv + r * HD + sl * VPL + v, vf + v);
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        // A NaN score (an e4m3 K past 464) passes fmaxf by, but its p is
        // NaN, and so are l and the output.
        const float pr = pst_sm90::fast_exp2(x[i][g] - mb[g]);
        l[g] += pr;
#pragma unroll
        for (int v = 0; v < VPL; ++v) acc[g][v] += pr * vf[v];
      }
    }
  }
  pst_sm90::cp_async_wait<0>();
  __syncthreads();  // the ring is free: the warps' states meet in it

  // Merge the KPW lane groups of the warp (lanes that share `sl`).
#pragma unroll
  for (int off = LPK; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo_ = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mn = fmaxf(m[g], mo);
      const float a = m[g] == -INFINITY ? 0.f : pst_sm90::fast_exp2(m[g] - mn);
      const float c = mo == -INFINITY ? 0.f : pst_sm90::fast_exp2(mo - mn);
      l[g] = l[g] * a + lo_ * c;
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[g][i], off);
        acc[g][i] = acc[g][i] * a + ao * c;
      }
      m[g] = mn;
    }
  }
  float* sAcc = reinterpret_cast<float*>(ring);   // [kDecodeWarps][GM][HD]
  float* sML = sAcc + kDecodeWarps * GM * HD;     // [kDecodeWarps][GM][2]
  if (sub == 0) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (sl == 0) {
        sML[(warp * GM + g) * 2] = m[g];
        sML[(warp * GM + g) * 2 + 1] = l[g];
      }
#pragma unroll
      for (int i = 0; i < VPL; ++i)
        sAcc[(warp * GM + g) * HD + sl * VPL + i] = acc[g][i];
    }
  }
  __syncthreads();

  // The block's state, one thread a (head, dim) of the G live heads: with
  // one split the output, else this split's partial in the workspace
  // (acc [B*KH][S][G][HD], then (m, l) [B*KH][S][G][2]).
  Tq* out = static_cast<Tq*>(p.out);
  const size_t pair = (size_t)b * p.KH + kh;
  float* accs = dp.ws + pair * S * G * HD;
  float* mls = dp.ws + (size_t)gridDim.x * p.KH * S * G * HD + pair * S * G * 2;
  for (int t = tid; t < G * HD; t += kDecodeThreads) {
    const int g = t / HD, d = t % HD;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w) M = fmaxf(M, sML[(w * GM + g) * 2]);
    // No live key: every l is 0 and the row writes 0. A NaN score leaves
    // m at -inf but l NaN, which carries to the output.
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w) {
      const float mw = sML[(w * GM + g) * 2];
      const float c = mw == -INFINITY ? 0.f : pst_sm90::fast_exp2(mw - M);
      L += sML[(w * GM + g) * 2 + 1] * c;
      A += sAcc[(w * GM + g) * HD + d] * c;
    }
    if (S == 1) {
      out[((size_t)b * H + kh * G + g) * HD + d] =
          Vec4<Tq>::store(L == 0.f ? 0.f : A / L);
    } else {
      accs[((size_t)split * G + g) * HD + d] = A;
      if (d == 0) {
        mls[(split * G + g) * 2] = M;
        mls[(split * G + g) * 2 + 1] = L;
      }
    }
  }
  if (S == 1 || !pst_splits::last_split(dp.counters + pair, S)) return;

  // The last block of (b, kh) merges the splits in split order: the
  // weights 2^(m_s - M) of every (split, head), then one (head, dim) a
  // thread. The weights live in the ring, which no copy uses any more.
  float* sW = reinterpret_cast<float*>(ring);  // [kDecodeMaxSplits][GM]
  float* sWl = sW + kDecodeMaxSplits * GM;
  for (int i = tid; i < S * G; i += kDecodeThreads) {
    sW[(i / G) * GM + i % G] = __ldcg(mls + 2 * i);
    sWl[(i / G) * GM + i % G] = __ldcg(mls + 2 * i + 1);
  }
  __syncthreads();
  if (tid < G) sL[tid] = pst_splits::merge_weights(sW + tid, sWl + tid, GM, S);
  __syncthreads();
  for (int t = tid; t < G * HD; t += kDecodeThreads) {
    const int g = t / HD;
    float A = 0.f;
#pragma unroll 8
    for (int s = 0; s < S; ++s)
      A += __ldcg(accs + (size_t)s * G * HD + t) * sW[s * GM + g];
    const float L = sL[g];
    out[((size_t)b * H + kh * G + g) * HD + t % HD] =
        Vec4<Tq>::store(L == 0.f ? 0.f : A / L);
  }
  if (tid == 0) dp.counters[pair] = 0;
}

// ---------------------------------------------------------------------------
// Prefill: grid (KH, B, Q * S), kPrefillThreads threads (8 warps).
//
// A block owns one q-tile of a (sequence, kv head): kRows query rows, TQ =
// kRows / G consecutive positions times the G heads (row r is position t0
// + r / G, head r % G; rows past TQ * G or past T are dead), and split
// `split` of the q-tile's live keys: from its first row's window start to
// its last row's causal bound, cut into S runs of kKeys-key tiles by
// splits.cuh's split_run (the q-tile index runs backwards along gridDim.z,
// so the longest key ranges start first). With S > 1 each block writes its
// partial (O, m, l) to a workspace and the block taking the q-tile's last
// ticket merges the runs in split order (two launches give the same bits)
// and resets the ticket.
//
// The block's page-table entries go to shared memory once; K and V tiles
// are gathered raw, in the cache's type, by cp.async into a kPrefillStages
// ring (two tiles in flight while one is read; kTPR threads share a staged
// row and its one page lookup) and converted to fp32 where they are read
// (lds4). Q is converted to fp32 once, into shared memory.
//
// Register tile: a warp owns RY * RM rows; lane (ry, kx) = (lane / KX,
// lane % KX) takes rows warp * RY * RM + ry + RY * i (i < RM) and keys kx
// + KX * j (j < KN) of a tile's scores, one 16-byte Q load (4 dims) and KN
// four-value K loads feeding 4 * RM * KN FMAs. For P.V the KX lanes of a
// row set share each p by shuffle and lane kx accumulates dim quads s * KX
// + kx (s < NQ) of its RM rows over every key: RM shuffles and NQ V loads
// a key for 4 * RM * NQ FMAs. Staged rows are padded by 16 bytes (Q rows
// always, K/V rows of 32 bytes and more), so the RY rows or KX keys one
// load instruction touches fall in distinct banks.
//
// Softmax: log2 domain, one max update a tile (the row's max over its KX
// lanes by shuffles), fast_exp2; the softcap is exact (tanhf of the scaled
// score, then the rescale); O is rescaled only when a row of the warp saw
// its max move. Each lane keeps its own part of l, summed at the end. A
// row with no live key writes 0. All arithmetic is fp32 FMA on the CUDA
// cores: TF32 would round the products against the JAX kernel's fp32.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md; the bound is
// 4 * H * HD * the keys each row sees, at 67 TFLOP/s): P shared through a
// per-warp shared-memory tile instead of shuffles used 254 registers at
// HD 128 and was 1.6 % slower there; 64-row q-tiles with 16-key tiles at
// HD 128 (two blocks an SM, 2 x 2 a lane) were 50 % slower.
// ---------------------------------------------------------------------------

constexpr int kPrefillWarps = 8;
constexpr int kPrefillThreads = 32 * kPrefillWarps;
constexpr int kPrefillStages = 3;
constexpr int kPrefillMaxSplits = 16;
constexpr int kPrefillPageCap = 512;  // table entries kept in shared memory

// The prefill's own launch: fields added to the decode's Params once made
// ptxas spill in the prefill's instantiations (fp32 at head_dim 16 became
// 17 % slower on an NVIDIA H100 80GB HBM3), so it takes nothing it does not
// read.
struct PrefillLaunch {
  const void* q;
  const void* cache;
  const int* tables;
  const int* kv_lens;
  const int* starts;
  void* out;
  float* ws;      // S > 1: [pairs][S][kRows][HD] O, then [pairs][S][kRows][2]
  int* counters;  // S > 1: one ticket a q-tile (zero, and left zero)
  int T, KH, G, nb, bs, W, layer, window, splits;
  float scale, softcap;
};

// The tile geometry at head dim HD over a cache of Tc
// (paged_attention_cuda.py's SIMT_PREFILL_TILES mirrors kRows and kKeys,
// _SIMT_PREFILL_BLOCKS_PER_SM kMinBlocks).
template <typename Tc, int HD>
struct PrefillGeo {
  static constexpr int kRows = HD == 256 ? 64 : 128;  // query rows a block
  static constexpr int kKeys = HD == 256 ? 16 : 32;   // keys a tile
  static constexpr int KX = HD / 4 < 8 ? HD / 4 : 8;  // lanes sharing rows
  static constexpr int RY = 32 / KX;                  // row lanes a warp
  static constexpr int RM = kRows / (kPrefillWarps * RY);  // rows a lane
  static constexpr int KN = kKeys / KX;               // keys a lane (scores)
  static constexpr int NQ = HD / (4 * KX);            // dim quads a lane (P.V)
  static constexpr int kRowBytes = HD * (int)sizeof(Tc);
  static constexpr int kRowStride = kRowBytes + (kRowBytes >= 32 ? 16 : 0);
  static constexpr int kChunks = kRowBytes / 16;      // 16-byte pieces a row
  static constexpr int kPieces = kKeys * kChunks;     // of K (and of V) a tile
  static constexpr int kTileBytes = kKeys * kRowStride;
  static constexpr int kQStride = HD + 4;             // floats a staged Q row
  static constexpr int kQBytes = kRows * kQStride * 4;
  static constexpr int kRingBytes = kPrefillStages * 2 * kTileBytes;
  static constexpr int kTPR = kPrefillThreads / kKeys;  // copy threads a row
  static constexpr int kMergeBytes = (2 * kPrefillMaxSplits + 1) * kRows * 4;
  static constexpr int kSmem = kQBytes + kRingBytes > kMergeBytes
                                   ? kQBytes + kRingBytes
                                   : kMergeBytes;
  // Two blocks an SM at head_dim 16 (at most 128 registers); one above,
  // where 128 registers spill (head_dim 32 and 64) or the ring and Q take
  // 166-169 KB (128 and 256).
  static constexpr int kMinBlocks = HD == 16 ? 2 : 1;
  static_assert(KX * RY == 32 && RM >= 1 && KN >= 1 && NQ >= 1,
                "lanes / tile mismatch");
  static_assert(kRows % (kPrefillWarps * RY) == 0 && kKeys % KX == 0 &&
                    HD % (4 * KX) == 0,
                "the tile divides over the lanes");
  static_assert(kQBytes % 16 == 0 && kTileBytes % 16 == 0, "16-byte rows");
};

template <typename Tq, typename Tc, int HD>
__global__ void __launch_bounds__(kPrefillThreads,
                                  (PrefillGeo<Tc, HD>::kMinBlocks))
paged_prefill_kernel(const PrefillLaunch lp) {
  using Geo = PrefillGeo<Tc, HD>;
  constexpr int kRows = Geo::kRows, kKeys = Geo::kKeys;
  constexpr int KX = Geo::KX, RY = Geo::RY, RM = Geo::RM, KN = Geo::KN,
                NQ = Geo::NQ;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int sPages[kPrefillPageCap];
  float* const sQ = reinterpret_cast<float*>(smem);  // [kRows][kQStride]
  uint8_t* const ring = smem + Geo::kQBytes;

  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int S = lp.splits;
  const int n_qt = gridDim.z / S;
  const int qt = n_qt - 1 - (int)blockIdx.z / S;  // longest key range first
  const int split = blockIdx.z % S;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int ry = lane / KX, kx = lane % KX;
  const int G = lp.G, KH = lp.KH, T = lp.T;
  const int H = KH * G;
  const int TQ = kRows / G;

  const int kv_len = lp.kv_lens[b];
  const int start = lp.starts[b];
  const int t0 = qt * TQ;
  const int t_end = min(t0 + TQ, T);  // ragged end of T
  const int win = window_eff(lp.window);
  // Keys any row of the q-tile may read: from its first row's window
  // start up to its last row's causal bound (never past kv_len); this
  // split's run of their kKeys-aligned tiles.
  const int k_lo = max(start + t0 + 1 - win, 0);
  const int k_hi = min(kv_len, start + t_end);
  int f0;
  const int n_t = pst_splits::split_run(k_lo, k_hi, kKeys, split, S, f0);

  int row[RM], bound[RM], low[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    row[i] = warp * (RY * RM) + ry + RY * i;
    const int t = t0 + row[i] / G;
    const int pos = start + t;
    bound[i] = t < t_end ? min(pos + 1, kv_len) : 0;  // exclusive
    low[i] = max(pos + 1 - win, 0);                   // inclusive
  }

  const size_t lanes = (size_t)KH * HD;
  const size_t page_stride = 2 * (size_t)lp.bs * lanes;
  const Tc* const cache = static_cast<const Tc*>(lp.cache);
  const Tc* const layer_base =
      cache + (size_t)lp.layer * lp.nb * page_stride + (size_t)kh * HD;
  const int* const trow = lp.tables + (size_t)b * lp.W;

  // The run's slice of the table row, loaded once: entries [p_lo, p_lo +
  // kPrefillPageCap) in shared memory, any beyond read from the table.
  const int p_lo = min(f0 * kKeys / lp.bs, lp.W - 1);
  if (n_t > 0) {
    const int p_n = min((f0 + n_t) * kKeys / lp.bs, lp.W - 1) + 1 - p_lo;
    for (int i = tid; i < min(p_n, kPrefillPageCap); i += kPrefillThreads)
      sPages[i] = __ldg(trow + p_lo + i);
  }
  __syncthreads();
  auto page_of = [&](int pos) {
    // A table shorter than kv_len is a caller error; the clamp keeps the
    // read inside the table.
    const int pi = min(pos / lp.bs, lp.W - 1) - p_lo;
    return pi < kPrefillPageCap ? sPages[pi] : __ldg(trow + p_lo + pi);
  };
  // The tile's K rows and V rows, 16-byte pieces. Where a row has at least
  // kTPR pieces, kTPR threads share a row (one page lookup each, the row's
  // pieces side by side for each copy instruction); else thread i copies
  // piece i, chunk i % kChunks of row i / kChunks. Keys outside [k_lo,
  // k_hi) are zero-filled.
  auto copy_row = [&](uint32_t sK, int it, int r, int c0, int dc, int nc) {
    const int pos = (f0 + it) * kKeys + r;
    const bool ok = pos >= k_lo && pos < k_hi;
    const uint8_t* src_k = reinterpret_cast<const uint8_t*>(cache);
    size_t v_off = 0;  // valid addresses when nothing is read
    if (ok) {
      src_k = reinterpret_cast<const uint8_t*>(
          layer_base + (size_t)page_of(pos) * page_stride +
          (size_t)(pos % lp.bs) * lanes);
      v_off = (size_t)lp.bs * lanes * sizeof(Tc);
    }
#pragma unroll
    for (int j = 0; j < nc; ++j) {
      const int c = c0 + j * dc;
      const uint32_t dst = sK + r * Geo::kRowStride + 16 * c;
      pst_sm90::cp_async16(dst, src_k + (ok ? 16 * c : 0), ok);
      pst_sm90::cp_async16(dst + Geo::kTileBytes,
                           src_k + (ok ? v_off + 16 * c : 0), ok);
    }
  };
  auto copy_tile = [&](int it) {
    const uint32_t sK = pst_sm90::smem_u32(
        ring + (it % kPrefillStages) * 2 * Geo::kTileBytes);
    if constexpr (Geo::kChunks >= Geo::kTPR) {
      copy_row(sK, it, tid / Geo::kTPR, tid % Geo::kTPR, Geo::kTPR,
               Geo::kChunks / Geo::kTPR);
    } else if (tid < Geo::kPieces) {
      copy_row(sK, it, tid / Geo::kChunks, tid % Geo::kChunks, 0, 1);
    }
  };
#pragma unroll
  for (int s = 0; s < kPrefillStages - 1; ++s) {
    if (s < n_t) copy_tile(s);
    pst_sm90::cp_async_commit();
  }

  // Q in fp32 while the first tiles are in flight; dead rows are zeros.
  const Tq* const q = static_cast<const Tq*>(lp.q);
  if (n_t > 0) {
    for (int idx = tid; idx < kRows * (HD / 4); idx += kPrefillThreads) {
      const int r = idx / (HD / 4), c = idx % (HD / 4);
      const int t = t0 + r / G;
      float f[4] = {0.f, 0.f, 0.f, 0.f};
      if (t < t_end)
        Vec4<Tq>::load(q + (((size_t)b * T + t) * H + kh * G + r % G) * HD +
                           4 * c,
                       f);
      *reinterpret_cast<float4*>(sQ + r * Geo::kQStride + 4 * c) =
          make_float4(f[0], f[1], f[2], f[3]);
    }
  }

  const bool capped = lp.softcap > 0.f;
  const float c_scale = capped ? lp.scale / lp.softcap : lp.scale * kLog2e;
  const float c_cap = lp.softcap * kLog2e;
  float m[RM], l[RM], acc[RM][4 * NQ];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int d = 0; d < 4 * NQ; ++d) acc[i][d] = 0.f;
  }

  for (int it = 0; it < n_t; ++it) {
    pst_sm90::cp_async_wait<kPrefillStages - 2>();
    // Tile it (and, the first time, Q) is in place for every thread, and
    // every thread is done with tile it - 1, whose slot the next copy fills.
    __syncthreads();
    if (it + kPrefillStages - 1 < n_t) copy_tile(it + kPrefillStages - 1);
    pst_sm90::cp_async_commit();

    const uint8_t* const sk = ring + (it % kPrefillStages) * 2 * Geo::kTileBytes;
    const uint8_t* const sv = sk + Geo::kTileBytes;
    const int key0 = (f0 + it) * kKeys;

    // Scores of the lane's RM rows and KN keys, over the dims in quads.
    float x[RM][KN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < KN; ++j) x[i][j] = 0.f;
#pragma unroll
    for (int c = 0; c < HD / 4; ++c) {
      float qa[RM][4], ka[KN][4];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        lds4(sQ + row[i] * Geo::kQStride + 4 * c, qa[i]);
#pragma unroll
      for (int j = 0; j < KN; ++j)
        lds4(reinterpret_cast<const Tc*>(sk + (kx + KX * j) * Geo::kRowStride) +
                 4 * c,
             ka[j]);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < KN; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) x[i][j] = fmaf(qa[i][e], ka[j][e], x[i][j]);
    }

    // Log2-domain scores, masked to each row's [low, bound); one max
    // update a row and tile. The softcap's branch is taken once a tile:
    // tanhf is not evaluated without one.
    if (capped) {
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < KN; ++j) x[i][j] = tanhf(x[i][j] * c_scale) * c_cap;
    } else {
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < KN; ++j) x[i][j] *= c_scale;
    }
    float alpha[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < KN; ++j) {
        const int kp = key0 + kx + KX * j;
        x[i][j] = kp >= low[i] && kp < bound[i] ? x[i][j] : -INFINITY;
        mx = fmaxf(mx, x[i][j]);
      }
#pragma unroll
      for (int off = 1; off < KX; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      // No live key for this row yet: every p is 0 and nothing is
      // rescaled. A NaN score (an e4m3 K past 464) passes fmaxf by, but its
      // p is NaN, and so are l and the output.
      const float base = m_new == -INFINITY ? 0.f : m_new;
      alpha[i] = pst_sm90::fast_exp2(m[i] - base);
      m[i] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < KN; ++j) {
        x[i][j] = pst_sm90::fast_exp2(x[i][j] - base);
        rs += x[i][j];
      }
      l[i] = l[i] * alpha[i] + rs;
    }
    // O is rescaled only where a row's max moved (alpha is then not 1).
    bool moved = false;
#pragma unroll
    for (int i = 0; i < RM; ++i) moved |= alpha[i] != 1.f;
    if (__any_sync(0xffffffffu, moved)) {
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int d = 0; d < 4 * NQ; ++d) acc[i][d] *= alpha[i];
    }

    // P.V: key kx' + KX * j's p from lane kx' of the row set, every key in
    // order; the lane's NQ dim quads of V.
#pragma unroll
    for (int j = 0; j < KN; ++j) {
#pragma unroll
      for (int src = 0; src < KX; ++src) {
        float pr[RM];
#pragma unroll
        for (int i = 0; i < RM; ++i)
          pr[i] = __shfl_sync(0xffffffffu, x[i][j], src, KX);
        const Tc* const vrow =
            reinterpret_cast<const Tc*>(sv + (src + KX * j) * Geo::kRowStride);
#pragma unroll
        for (int s = 0; s < NQ; ++s) {
          float vf[4];
          lds4(vrow + 4 * (s * KX + kx), vf);
#pragma unroll
          for (int i = 0; i < RM; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[i][4 * s + e] = fmaf(pr[i], vf[e], acc[i][4 * s + e]);
        }
      }
    }
  }
  pst_sm90::cp_async_wait<0>();

  // The row sums over the KX lanes that share the rows.
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int off = 1; off < KX; off <<= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);

  Tq* const out = static_cast<Tq*>(lp.out);
  auto store = [&](int i, int s, const float* v) {
    const int t = t0 + row[i] / G;
    Tq* dst = out + (((size_t)b * T + t) * H + kh * G + row[i] % G) * HD +
              4 * (s * KX + kx);
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[e] = Vec4<Tq>::store(v[e]);
  };
  if (S == 1) {
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      if (t0 + row[i] / G >= t_end) continue;
      const float inv = l[i] == 0.f ? 0.f : 1.f / l[i];
#pragma unroll
      for (int s = 0; s < NQ; ++s) {
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = acc[i][4 * s + e] * inv;
        store(i, s, v);
      }
    }
    return;
  }

  // S > 1: this run's partial, then the q-tile's ticket.
  const size_t pair = ((size_t)b * KH + kh) * n_qt + qt;
  const size_t n_pairs = (size_t)gridDim.y * KH * n_qt;
  float* const ws_o = lp.ws + pair * S * kRows * HD;
  float* const ws_ml = lp.ws + n_pairs * S * kRows * HD + pair * S * kRows * 2;
  if (n_t > 0) {
#pragma unroll
    for (int i = 0; i < RM; ++i) {
#pragma unroll
      for (int s = 0; s < NQ; ++s)
        *reinterpret_cast<float4*>(ws_o + ((size_t)split * kRows + row[i]) *
                                              HD + 4 * (s * KX + kx)) =
            make_float4(acc[i][4 * s], acc[i][4 * s + 1], acc[i][4 * s + 2],
                        acc[i][4 * s + 3]);
      if (kx == 0) {
        ws_ml[(split * kRows + row[i]) * 2] = m[i];
        ws_ml[(split * kRows + row[i]) * 2 + 1] = l[i];
      }
    }
  }
  if (!pst_splits::last_split(lp.counters + pair, S)) return;

  // The last block merges the runs in split order: the weights 2^(m_s -
  // M) of every (run, row), an empty run's skipped; then its rows' quads.
  // Its shared memory is free: the ring's copies have all landed.
  float* const sM = reinterpret_cast<float*>(smem);  // [S][kRows]
  float* const sLs = sM + S * kRows;                 // [S][kRows]
  float* const sL = sLs + S * kRows;                 // [kRows]
  for (int idx = tid; idx < S * kRows; idx += kPrefillThreads) {
    int first;
    const bool live =
        pst_splits::split_run(k_lo, k_hi, kKeys, idx / kRows, S, first) > 0;
    sM[idx] = live ? __ldcg(ws_ml + 2 * idx) : -INFINITY;
    sLs[idx] = live ? __ldcg(ws_ml + 2 * idx + 1) : 0.f;
  }
  __syncthreads();
  if (tid < kRows)
    sL[tid] = pst_splits::merge_weights(sM + tid, sLs + tid, kRows, S);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    if (t0 + row[i] / G >= t_end) continue;
    const float L = sL[row[i]];
    const float inv = L == 0.f ? 0.f : 1.f / L;
#pragma unroll
    for (int s = 0; s < NQ; ++s) {
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      for (int s2 = 0; s2 < S; ++s2) {
        int first;
        if (pst_splits::split_run(k_lo, k_hi, kKeys, s2, S, first) == 0)
          continue;
        const float c = sM[s2 * kRows + row[i]];
        const float4 a = __ldcg(reinterpret_cast<const float4*>(
            ws_o + ((size_t)s2 * kRows + row[i]) * HD + 4 * (s * KX + kx)));
        v[0] += a.x * c;
        v[1] += a.y * c;
        v[2] += a.z * c;
        v[3] += a.w * c;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] *= inv;
      store(i, s, v);
    }
  }
  if (tid == 0) lp.counters[pair] = 0;
}

// ---------------------------------------------------------------------------
// Host-side dispatch: kind, then types, head dim and the head-group bound
// GM (G rounded up to 1, 2, 4 or 8; prefill takes G at run time).
// ---------------------------------------------------------------------------

enum Kind { kDecode, kDecodeWrite };

template <Kind K, typename Tq, typename Tc, int GM, int HD>
cudaError_t launch(const Launch& dp) {
  const Params& p = dp.p;
  // The ring: dynamic shared memory, past 48 KB for the larger rows.
  constexpr bool kW = K == kDecodeWrite;
  constexpr int smem = SimtGeo<Tc, HD>::kSmem;
  static bool smem_set = false;  // idempotent: a race only repeats the call
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel<Tq, Tc, GM, HD, kW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  paged_decode_kernel<Tq, Tc, GM, HD, kW>
      <<<dim3(p.B, p.KH, dp.splits), kDecodeThreads, smem, p.stream>>>(dp);
  return cudaGetLastError();
}

template <Kind K, typename Tq, typename Tc, int HD>
cudaError_t by_group(const Launch& dp) {
  const Params& p = dp.p;
  if (p.G == 1) return launch<K, Tq, Tc, 1, HD>(dp);
  if (p.G == 2) return launch<K, Tq, Tc, 2, HD>(dp);
  if (p.G <= 4) return launch<K, Tq, Tc, 4, HD>(dp);
  return launch<K, Tq, Tc, 8, HD>(dp);
}

template <Kind K, typename Tq, typename Tc>
cudaError_t by_head_dim(const Launch& dp) {
  const Params& p = dp.p;
  switch (p.HD) {
    case 16: return by_group<K, Tq, Tc, 16>(dp);
    case 32: return by_group<K, Tq, Tc, 32>(dp);
    case 64: return by_group<K, Tq, Tc, 64>(dp);
    case 128:
      // bf16 q at head_dim 128 and 256 runs on the tensor-core kernels.
      if constexpr (std::is_same_v<Tq, float>) return by_group<K, Tq, Tc, 128>(dp);
      break;
    case 256:
      if constexpr (std::is_same_v<Tq, float>) return by_group<K, Tq, Tc, 256>(dp);
      break;
  }
  return cudaErrorInvalidValue;
}

// Type codes: 0 = float32, 1 = bfloat16, 2 = float8_e4m3fn (cache only).
template <Kind K>
int dispatch(int q_dtype, int cache_dtype, const Launch& dp) {
  const Params& p = dp.p;
  if (p.B == 0 || p.T == 0) return 0;
  if (p.KH <= 0 || p.G < 1 || p.G > 8 || p.KH > 65535 || p.B > 65535)
    return (int)cudaErrorInvalidValue;
  if (dp.splits < 1 || dp.splits > kDecodeMaxSplits ||
      (dp.splits > 1 && (dp.ws == nullptr || dp.counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (q_dtype == 0 && cache_dtype == 0) return (int)by_head_dim<K, float, float>(dp);
  if (q_dtype == 0 && cache_dtype == 2) return (int)by_head_dim<K, float, e4m3>(dp);
  if (q_dtype == 1 && cache_dtype == 1) return (int)by_head_dim<K, bf16, bf16>(dp);
  if (q_dtype == 1 && cache_dtype == 2) return (int)by_head_dim<K, bf16, e4m3>(dp);
  return (int)cudaErrorInvalidValue;
}

// The prefill: grid (KH, B, q-tiles * S), the q-tiles' count from the
// geometry's rows.
template <typename Tq, typename Tc, int HD>
cudaError_t launch_prefill(const PrefillLaunch& lp, int B,
                           cudaStream_t stream) {
  using Geo = PrefillGeo<Tc, HD>;
  static bool smem_set = false;  // idempotent: a race only repeats the call
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_prefill_kernel<Tq, Tc, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, Geo::kSmem);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  const int TQ = Geo::kRows / lp.G;
  const long long z = (long long)((lp.T + TQ - 1) / TQ) * lp.splits;
  if (z > 65535) return cudaErrorInvalidValue;
  paged_prefill_kernel<Tq, Tc, HD>
      <<<dim3(lp.KH, B, (unsigned)z), kPrefillThreads, Geo::kSmem, stream>>>(
          lp);
  return cudaGetLastError();
}

template <typename Tq, typename Tc>
cudaError_t prefill_by_head_dim(int HD, const PrefillLaunch& lp, int B,
                                cudaStream_t stream) {
  switch (HD) {
    case 16: return launch_prefill<Tq, Tc, 16>(lp, B, stream);
    case 32: return launch_prefill<Tq, Tc, 32>(lp, B, stream);
    case 64: return launch_prefill<Tq, Tc, 64>(lp, B, stream);
    case 128:
      if constexpr (std::is_same_v<Tq, float>)
        return launch_prefill<Tq, Tc, 128>(lp, B, stream);
      break;
    case 256:
      if constexpr (std::is_same_v<Tq, float>)
        return launch_prefill<Tq, Tc, 256>(lp, B, stream);
      break;
  }
  return cudaErrorInvalidValue;
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

