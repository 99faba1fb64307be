// Chunked-prefill paged attention with bf16 q on Hopper's tensor cores
// (wgmma), over a bf16 or an e4m3 cache, at head_dim HD = 128 or 256.
// Built once a head dim: prefill_wgmma.cu (HD 128, and the C entry point)
// and prefill_wgmma_hd256.cu (HD 256, the Gemma family), two nvcc
// processes side by side.
//
// Replaces, for bf16 q at head_dim 128 and 256, production_stack_tpu/ops/
// paged_attention_pallas.py::_prefill_kernel (launched by _prefill_call),
// and its e4m3-cache form (kFp8, kv_cache_dtype="float8_e4m3fn"). fp32 q
// and other head dims keep the CUDA-core paged_prefill_kernel of
// paged_attention.cuh. The contract is that kernel's, unchanged:
//   q      [B, T, H, HD] bf16       cache [L, nb, 2, bs, KH*HD] bf16 or
//                                   e4m3
//   tables [B, W] int32             kv_lens, starts [B] int32
// Row t of sequence b sits at position pos = starts[b] + t and attends to
// the keys in [max(pos + 1 - window, 0), min(pos + 1, kv_len)); scores are
// scaled, then soft-capped; a row with no live key writes zeros (a NaN in
// a live K or V row, an e4m3 cast past 464, reaches the output); a ragged
// T is masked here; G = H / KH from 1 to 8.
//
// Precision contract: K and V are up-converted exactly to bf16 (every
// e4m3 value is a bf16 value). Q·Kᵀ accumulates in fp32; the softmax runs
// in fp32; P is rounded to bf16 before P·V, which accumulates in fp32 —
// as precise as the JAX kernel's _pv_dot (P to about 2^-8) or more.
//
// Design. Grid (KH, B, ceil(T / (128 / G)) * S), 256 threads = two
// consumer warpgroups. A q-tile is one (sequence, kv head) and 128 query
// rows: TQ = 128 / G positions times the G heads of the kv head,
// position-major (row r is position r / G, head r % G); where G does not
// divide 128 (3, 5, 6, 7) the rows past TQ * G fall at a position past
// the block's last, so the Q load zeroes them, the masks give them no key
// and the epilogue skips them. Each warpgroup owns 64 rows (one wgmma M
// tile). The q-tile index runs backwards along gridDim.z, so the q-tiles
// with the longest causal key range start first.
//   - Split keys. The wrapper picks S (prefill_plan in
//     paged_attention_cuda.py) from the shapes alone, never from kv_lens
//     or starts, so that the grid fills about one wave of the SMs: at
//     gemma2-9b's and gemma-7b's heads a 512-token chunk has 64 q-tiles,
//     and S = 2 gives 128 blocks where one block a q-tile left 68 of the
//     H100's 132 SMs idle. The q-tile's live keys (the window's lower
//     bound of its first row to the causal bound of its last) in tiles
//     aligned to kKeys are cut into S runs (splits.cuh::split_run, the
//     formula of paged_attention_cuda.py::prefill_split_keys); block
//     (q-tile, s) walks run s. With S > 1 a block writes its O (fp32, in
//     the fragment order of its registers), m and l to the workspace and
//     takes a ticket from the q-tile's counter; the block that takes the
//     last ticket merges the runs in split order (two launches give the
//     same bits), writes bf16 and resets the counter (splits.cuh, shared
//     with the split-KV decode). The merge is a function of its own
//     (merge_splits, not inlined) that sums in shared memory, so that it
//     adds no register to the tile loop. An empty run (a q-tile with fewer
//     tiles than S) loads nothing, writes nothing and only takes its
//     ticket; the merge skips it. S = 1 writes bf16 directly.
//   - Q is loaded once into shared memory (cp.async, rows past T zeroed).
//   - Keys go in tiles of kKeys = 64 at both head dims (16 KB of bf16 K at
//     HD 128, 32 KB at HD 256). Each 16-byte piece of a K or V row is
//     gathered through the block table (any block size works) by cp.async
//     into a ring of kStages slots, kAhead tiles ahead (4 slots, 2 ahead at
//     HD 128; 2 slots, 1 ahead at HD 256), zero-filled outside the q-tile's
//     key range, in the 128-byte-swizzled layout the wgmma descriptors
//     read: a tile (and Q) is HD / 64 blocks of 64 dims, each a stack of
//     128-byte rows. (At HD 256, 32-key tiles with 4 slots, 2 ahead, were
//     slower on an NVIDIA H100 80GB HBM3: twice the per-tile softmax,
//     barrier hand-over and O rescale per key; PERF.md has the times.)
//     Tiles wholly outside the q-tile's causal and window range are never
//     loaded. mbarriers, not block barriers, hand the slots over: a slot is
//     full once every thread's copies into it have landed
//     (cp.async.mbarrier.arrive), and empty once every warp is done with
//     it. So the two warpgroups do not meet at every tile, and one runs its
//     softmax while the other's products run. (Making them take turns at
//     the tensor cores with named barriers, or skipping a tile that none of
//     a warpgroup's rows sees, was slower on an NVIDIA H100 80GB HBM3 at
//     700 W: the skip's branch around the products makes ptxas serialize
//     the wgmmas.)
//   - S = Q Kᵀ: HD / 16 x wgmma m64n64k16, both operands from shared
//     memory, K-major. The online softmax runs in fp32 (log2 domain) on the
//     accumulator registers; each register's (row, key) comes from the
//     fragment layout, which gives the causal / window / kv_len masks.
//   - P is rounded to bf16 in registers and used directly as the register
//     A operand of wgmma m64n128k16 for O += P V (kKeys / 16 k-steps, HD /
//     128 products a k-step, one a 128-dim slice of O), V read from shared
//     memory MN-major (transposed B), so P never touches shared memory.
//   - O, m and l stay in registers; the epilogue divides by l (the merged
//     one with S > 1) and writes bf16.
//   - An e4m3 cache: each 16-byte piece (16 dims of one key row) comes by
//     cp.async into a staging ring of kAhead e4m3 tiles, a commit group a
//     tile. The thread that copied a piece waits for its own group,
//     converts the piece exactly to bf16 into the swizzled ring slot the
//     wgmma descriptors read, arrives on the slot's full barrier, and only
//     then copies its pieces of the tile kAhead ahead into the staging it
//     just read (its own pieces, so no other thread is in the way); the
//     empty barriers guard the bf16 slots as in bf16. (e4m3 operands on
//     the tensor cores, wgmma k32, would halve the shared memory the
//     products read: later work.)
// Shared memory at HD 128: Q 32 KB + 4 slots x (K 16 KB + V 16 KB) =
// 160 KB (+1 KB for alignment); e4m3 adds 2 x 16 KB of staging: 192 KB
// (+1 KB) of the 227 KB a block may have. At HD 256: Q 64 KB + 2 slots x
// 64 KB = 192 KB (+1 KB); e4m3 adds one 32 KB staging tile: 224 KB
// (+1 KB). One block per SM, 8 warps. Registers at HD 256: O is 128 fp32
// a thread (m64n256 over a warpgroup), S 32. The workspace of a launch
// with S > 1: q-tiles x S x 128 x (HD + 2) floats (16.9 MB for gemma2-9b's
// 512-token chunk at S = 2, written and read through the 50 MB L2).
//
// Bound on an NVIDIA H100 80GB HBM3 at its 700 W limit (data sheet: 989
// TFLOP/s bf16 dense, 3.35 TB/s): operations,
// 4 * H * 128 * T * (start + T/2) FLOP per layer for a causal chunk (the
// window lowers it): at H = 32, a fresh T = 512 chunk is 2.15 GFLOP,
// 0.0022 ms; T = 512 at start 3584 is 32.2 GFLOP, 0.0326 ms; a fresh
// T = 2048 chunk 34.4 GFLOP, 0.0348 ms. The fresh T = 512 chunk reads
// 4.2 MB of q/out and 1 MB of K/V: 0.0031 ms of bytes, so it is bound by
// bytes (PERF.md has the measured times). gemma2-9b's heads (H 16, HD 256)
// do the same operations: H * HD is the same.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "fp8.cuh"
#include "sm90.cuh"
#include "splits.cuh"

namespace {

using namespace pst_fp8;
using namespace pst_sm90;
using namespace pst_splits;

constexpr int kRows = 128;  // query rows per block
constexpr int kKeys = 64;   // keys a tile
constexpr int kThreads = 256;
constexpr int kQBlock = kRows * 128;  // one 64-dim block of Q, 16 KB
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxSplits = 32;  // the merge keeps S x 128 weights in smem

// The geometry of head dim HD (and cache form): ring slots, tiles loaded
// ahead of the current one, e4m3 staging slots, Q's bytes, a tile's K (or
// V) in bf16 and e4m3, one 64-dim block of a tile's K / V, and the shared
// memory a block asks for (1 KB more than the tiles, for the 1024-byte
// alignment).
template <int HD, bool kFp8>
struct Geo {
  static_assert(HD == 128 || HD == 256, "the wgmma kernel takes HD 128, 256");
  static constexpr int kStages = HD == 128 ? 4 : 2;
  static constexpr int kAhead = HD == 128 ? 2 : 1;
  static constexpr int kStaging = kAhead;
  static constexpr int kSlices = HD / 128;  // n128 products of O
  static constexpr int kQBytes = kRows * HD * 2;
  static constexpr int kKVBytes = kKeys * HD * 2;
  static constexpr int kKVBytes8 = kKVBytes / 2;
  static constexpr int kStageBytes = 2 * kKVBytes;
  static constexpr int kStageBytes8 = 2 * kKVBytes8;
  static constexpr int kKVBlock = kKeys * 128;
  static constexpr int kSmem = kQBytes + kStages * kStageBytes +
                               (kFp8 ? kStaging * kStageBytes8 : 0) + 1024;
  static_assert(kStages > kAhead, "a slot is free to refill");
  static_assert(kSmem <= 232448, "the tiles fit a block");
  static_assert(kRows * HD * 4 + (2 * kMaxSplits + 1) * kRows * 4 <=
                    kSmem - 1024,
                "the merge's sums and weights fit the tiles' shared memory");
};

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// The merge of a q-tile's S runs, out of line so that its code takes no
// part in the tile loop's register allocation. Every thread of the block
// calls it once the block's partial is in the workspace (ws_o: split 0's O
// of the q-tile, ws_ml: its (m, l)); the block that takes the last ticket
// writes the q-tile's output.
template <int HD, int G>
__device__ __noinline__ void merge_splits(
    const float4* ws_o, const float* ws_ml, int* counter, uint8_t* smem_raw,
    __nv_bfloat16* out, int b, int kh, int KH, int T_len, int t0, int t_end,
    int k_lo, int k_hi, int S) {
  constexpr int kO4 = HD / 8;  // float4 groups of a thread's O
  constexpr size_t per_split = (size_t)kO4 * kThreads;
  if (!last_split(counter, S)) return;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int quad = lane & 3;
  const int H = KH * G;
  int row[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    row[h] = 64 * (tid / 128) + 16 * ((tid % 128) / 32) + lane / 4 + 8 * h;
  ws_o += tid;

  // The runs in split order: every (split, row)'s weight 2^(m_s - M)
  // first (an empty run's m is -inf and its l 0), then each thread its own
  // fragment of every split's O, summed in shared memory (the ring and Q,
  // which no copy uses any more) with 16 loads in flight.
  float4* acc = reinterpret_cast<float4*>(align1024(smem_raw)) + tid;
  float* sM = reinterpret_cast<float*>(align1024(smem_raw) +
                                       kO4 * kThreads * 16);  // [S][kRows]
  float* sLs = sM + S * kRows;                                // [S][kRows]
  float* sL = sLs + S * kRows;                                // [kRows]
  for (int i = tid; i < S * kRows; i += kThreads) {
    int first;
    const bool live = split_run(k_lo, k_hi, kKeys, i / kRows, S, first) > 0;
    sM[i] = live ? __ldcg(ws_ml + 2 * i) : -INFINITY;
    sLs[i] = live ? __ldcg(ws_ml + 2 * i + 1) : 0.f;
  }
  __syncthreads();
  if (tid < kRows) sL[tid] = merge_weights(sM + tid, sLs + tid, kRows, S);
  __syncthreads();
  bool none = true;  // no run summed yet
  for (int s2 = 0; s2 < S; ++s2) {
    int first;
    if (split_run(k_lo, k_hi, kKeys, s2, S, first) == 0) continue;
    const float c0 = sM[s2 * kRows + row[0]];
    const float c1 = sM[s2 * kRows + row[1]];
    const float4* src = ws_o + s2 * per_split;
#pragma unroll 16
    for (int j = 0; j < kO4; ++j) {
      const float4 a = __ldcg(src + j * kThreads);
      float4 v = none ? make_float4(0.f, 0.f, 0.f, 0.f) : acc[j * kThreads];
      v.x += a.x * c0;
      v.y += a.y * c0;
      v.z += a.z * c1;
      v.w += a.w * c1;
      acc[j * kThreads] = v;
    }
    none = false;
  }
  if (tid == 0) *counter = 0;
  // Group j holds dims 128 (j / 16) + 8 (j % 16) + 2 quad + {0, 1} of
  // rows row[0] (x, y) and row[1] (z, w).
  float inv[2];
  __nv_bfloat16* dst[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float l = sL[row[h]];
    inv[h] = l == 0.f ? 0.f : 1.f / l;
    const int t = t0 + row[h] / G, g = row[h] % G;
    dst[h] = t < t_end ? out + (((size_t)b * T_len + t) * H + kh * G + g) *
                                   HD + 2 * quad
                       : nullptr;
  }
#pragma unroll 4
  for (int j = 0; j < kO4; ++j) {
    const float4 v = none ? make_float4(0.f, 0.f, 0.f, 0.f)
                          : acc[j * kThreads];
    const int d = 128 * (j / 16) + 8 * (j % 16);
    if (dst[0])
      *reinterpret_cast<__nv_bfloat162*>(dst[0] + d) =
          __floats2bfloat162_rn(v.x * inv[0], v.y * inv[0]);
    if (dst[1])
      *reinterpret_cast<__nv_bfloat162*>(dst[1] + d) =
          __floats2bfloat162_rn(v.z * inv[1], v.w * inv[1]);
  }
}

// CT: the cache's element, bf16 or (kFp8) one e4m3 byte.
template <int HD, int G, bool kFp8,
          typename CT = std::conditional_t<kFp8, uint8_t, __nv_bfloat16>>
__global__ void __launch_bounds__(kThreads, 1)
paged_prefill_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                           const CT* __restrict__ cache,
                           const int* __restrict__ tables,
                           const int* __restrict__ kv_lens,
                           const int* __restrict__ starts,
                           __nv_bfloat16* __restrict__ out,
                           float* __restrict__ ws, int* __restrict__ counters,
                           int T_len, int nb, int bs, int KH, int W,
                           int layer, int window, float scale, float softcap,
                           int S) {
  using Gm = Geo<HD, kFp8>;
  constexpr int kStages = Gm::kStages;
  constexpr int kAhead = Gm::kAhead, kStaging = Gm::kStaging;
  constexpr int kSlices = Gm::kSlices, kKVBlock = Gm::kKVBlock;
  constexpr int kKVBytes = Gm::kKVBytes, kKVBytes8 = Gm::kKVBytes8;
  constexpr int kStageBytes = Gm::kStageBytes;
  constexpr int kStageBytes8 = Gm::kStageBytes8;
  constexpr int TQ = kRows / G;  // positions per block
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t sQ = smem_u32(align1024(smem_raw));
  const uint32_t sKV = sQ + Gm::kQBytes;
  const uint32_t s8 = sKV + kStages * kStageBytes;  // e4m3 staging

  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int n_qt = gridDim.z / S;
  const int qt = n_qt - 1 - blockIdx.z / S;  // longest key range first
  const int split = blockIdx.z % S;
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int quad = lane & 3;
  const int H = KH * G;

  const int kv_len = kv_lens[b];
  const int start = starts[b];
  const int t0 = qt * TQ;
  const int t_end = min(t0 + TQ, T_len);
  const int win = window > 0 ? window : (1 << 30);
  // Keys any row of the q-tile sees, and this split's run of its tiles:
  // n_kv tiles from tile ta.
  const int k_lo = max(start + t0 + 1 - win, 0);
  const int k_hi = min(kv_len, start + t_end);
  int ta;
  const int n_kv = split_run(k_lo, k_hi, kKeys, split, S, ta);

  // Q: 128 rows x HD / 8 chunks of 16 bytes; row r is (t0 + r / G,
  // head g). An empty run needs none.
  if (n_kv > 0) {
    for (int i = tid; i < kRows * (HD / 8); i += kThreads) {
      const int r = i / (HD / 8), c = i % (HD / 8);
      const int t = t0 + r / G, g = r % G;
      const bool ok = t < t_end;
      const __nv_bfloat16* src =
          ok ? q + (((size_t)b * T_len + t) * H + kh * G + g) * HD + c * 8
             : q;
      cp_async16(sQ + (c / 8) * kQBlock + sw128(r, c % 8), src, ok);
    }
  }
  cp_async_commit();

  const size_t lanes = (size_t)KH * HD;
  const size_t page_stride = 2 * (size_t)bs * lanes;
  const CT* layer_base =
      cache + (size_t)layer * nb * page_stride + (size_t)kh * HD;
  const int* trow = tables + (size_t)b * W;

  // A cache row of one kv head is kChunks 16-byte pieces of kPer values;
  // thread tid copies piece tid % kChunks of keys tid / kChunks + j *
  // kThreads / kChunks, for K and V.
  constexpr int kPer = 16 / sizeof(CT);
  constexpr int kChunks = HD / kPer;
  constexpr int kRowStep = kThreads / kChunks;
  const int c = tid % kChunks;
  // Key tile `it` into ring slot `slot` (bf16), or into its e4m3 staging
  // slot, unswizzled: only its copier reads it.
  auto load_kv = [&](int it, int slot) {
    const int kb = (ta + it) * kKeys;
    const uint32_t sK = kFp8 ? s8 + (it % kStaging) * kStageBytes8
                             : sKV + slot * kStageBytes;
    const uint32_t sV = sK + (kFp8 ? kKVBytes8 : kKVBytes);
#pragma unroll
    for (int j = 0; j < kKeys / kRowStep; ++j) {
      const int r = tid / kChunks + kRowStep * j;
      const int kp = kb + r;
      const bool ok = kp >= k_lo && kp < k_hi;
      const CT* src = cache;
      if (ok) {
        src = layer_base + (size_t)trow[min(kp / bs, W - 1)] * page_stride +
              (size_t)(kp % bs) * lanes + c * kPer;
      }
      const uint32_t off =
          kFp8 ? r * HD + c * 16 : (c / 8) * kKVBlock + sw128(r, c % 8);
      cp_async16(sK + off, src, ok);
      cp_async16(sV + off, ok ? src + (size_t)bs * lanes : cache, ok);
    }
  };
  // e4m3: this thread's pieces of tile it, landed, into ring slot `slot`
  // as bf16 (piece c is bf16 chunks 2 c and 2 c + 1, in one 64-dim block).
  auto convert_kv = [&](int it, int slot) {
    const uint32_t k8 = s8 + (it % kStaging) * kStageBytes8;
    const uint32_t sK = sKV + slot * kStageBytes;
#pragma unroll
    for (int j = 0; j < kKeys / kRowStep; ++j) {
      const int r = tid / kChunks + kRowStep * j;
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // K, then V
        uint32_t v[4];
        asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                     : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
                     : "r"(k8 + h * kKVBytes8 + r * HD + c * 16));
        uint32_t w[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          w[2 * i] = e4m3x2_to_bf16x2(v[i]);
          w[2 * i + 1] = e4m3x2_to_bf16x2(v[i] >> 16);
        }
        const uint32_t dst = sK + h * kKVBytes + (c / 4) * kKVBlock;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n"
                       ::"r"(dst + sw128(r, (2 * c + e) % 8)),
                       "r"(w[4 * e]), "r"(w[4 * e + 1]), "r"(w[4 * e + 2]),
                       "r"(w[4 * e + 3])
                       : "memory");
        }
      }
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
  // bf16: a slot is full once its copies land (cp.async.mbarrier.arrive).
  // e4m3: one commit group a tile (empty where there is none), and a slot
  // is full once every thread has converted its pieces into it.
#pragma unroll
  for (int s = 0; s < kAhead; ++s) {
    if (s < n_kv) {
      load_kv(s, s);
      if constexpr (!kFp8) cp_async_mbar_arrive(full0 + 8 * s);
    }
    if constexpr (kFp8) cp_async_commit();
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

  // O in kSlices 128-dim slices of 64 registers; S over kKeys keys.
  constexpr int kS = kKeys / 2;
  float o[kSlices][64], s[kS];
#pragma unroll
  for (int sl = 0; sl < kSlices; ++sl)
#pragma unroll
    for (int i = 0; i < 64; ++i) o[sl][i] = 0.f;
#pragma unroll
  for (int i = 0; i < kS; ++i) s[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // this thread's share of the row sum

  const uint32_t qa = sQ + wg * 64 * 128;
  for (int it = 0; it < n_kv; ++it) {
    const int slot = it % kStages;
    if constexpr (kFp8) {
      // This thread's pieces of tile it (and Q) have landed: into ring slot
      // `slot` (cleared for it kAhead tiles ago, below) as bf16. That frees
      // their staging slot for the same thread's pieces of tile it +
      // kAhead.
      cp_async_wait<kAhead - 1>();
      convert_kv(it, slot);
      fence_proxy_async();  // the converted tile, to wgmma's async proxy
      mbar_arrive(full0 + 8 * slot);
    }
    const int nx = it + kAhead;  // refill the slot of tile nx - kStages
    if (nx < n_kv) {
      const int ns = nx % kStages;
      // bf16: slot ns is refilled now; e4m3: tile nx is converted into it
      // kAhead tiles from now, and this wait is what clears it for that.
      if (nx >= kStages) mbar_wait(empty0 + 8 * ns, (nx / kStages - 1) & 1);
      load_kv(nx, ns);
      if constexpr (!kFp8) cp_async_mbar_arrive(full0 + 8 * ns);
    }
    if constexpr (kFp8) cp_async_commit();  // tile nx's group, maybe empty
    mbar_wait(full0 + 8 * slot, (it / kStages) & 1);
    fence_proxy_async();  // the landed tiles, to wgmma's async proxy
    const int kb = (ta + it) * kKeys;
    const uint32_t sK = sKV + slot * kStageBytes;
    const uint32_t sV = sK + kKVBytes;

    // S = Q Kᵀ over the HD dims: HD / 16 k-steps of 16.
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      const uint64_t da =
          desc_sw128(qa + (ks / 4) * kQBlock + (ks % 4) * 32, 16, 1024);
      const uint64_t db =
          desc_sw128(sK + (ks / 4) * kKVBlock + (ks % 4) * 32, 16, 1024);
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
    for (int i = 0; i < kS; ++i) {
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
      for (int j = 0; j < kKeys / 8; ++j) {
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
      for (int j = 0; j < kKeys / 8; ++j) {
        const float p0 = fast_exp2(s[4 * j + 2 * h] - base);
        const float p1 = fast_exp2(s[4 * j + 2 * h + 1] - base);
        s[4 * j + 2 * h] = p0;
        s[4 * j + 2 * h + 1] = p1;
        rs += p0 + p1;
      }
      l_run[h] = l_run[h] * alpha[h] + rs;
    }
#pragma unroll
    for (int sl = 0; sl < kSlices; ++sl)
#pragma unroll
      for (int i = 0; i < 64; ++i) o[sl][i] *= alpha[(i >> 1) & 1];

    // P as the A fragments of the kKeys / 16 key k-steps: register r of
    // k-step kk holds S registers 8 * kk + 2 * r and + 1.
    uint32_t p[kKeys / 16][4];
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        p[kk][r] = pack_bf16x2(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);

    // O += P V: V is [kKeys keys x HD dims], dims contiguous (MN-major B);
    // slice sl reads its two 64-dim blocks: lbo = the next 64-dim block,
    // sbo = the next 8 keys.
#pragma unroll
    for (int sl = 0; sl < kSlices; ++sl) fence_regs(o[sl]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
#pragma unroll
      for (int sl = 0; sl < kSlices; ++sl) {
        const uint64_t db = desc_sw128(
            sV + 2 * sl * kKVBlock + kk * 16 * 128, kKVBlock, 1024);
        wgmma_m64n128k16_rs<1>(o[sl], p[kk], db, 1);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int sl = 0; sl < kSlices; ++sl) fence_regs(o[sl]);
    if (lane == 0) mbar_arrive(empty0 + 8 * slot);  // this warp is done
  }
  cp_async_wait<0>();

  // This thread's two rows (fragment rows of its warp) and their sums, its
  // quad's shares added. Register i of O's slice sl holds row h = (i / 2)
  // % 2, dim 128 * sl + 8 * (i / 4) + 2 * quad + i % 2.
  int row[2];
  float l_row[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = 64 * wg + 16 * warp + lane / 4 + 8 * h;
    float l = l_run[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l_row[h] = l;
  }
  if (S > 1) {
    // Workspace: O [q-tiles][S][kO4][kThreads] float4, a thread's registers
    // 4 j .. 4 j + 3 (slices in order) at [j][tid], so every store and load
    // is a warp's 512 contiguous bytes; then (m, l) [q-tiles][S][kRows][2].
    constexpr int kO4 = kSlices * 16;
    const size_t pair = ((size_t)b * KH + kh) * n_qt + qt;
    const size_t n_pairs = (size_t)gridDim.y * KH * n_qt;
    const size_t per_split = (size_t)kO4 * kThreads;
    float4* ws_o = reinterpret_cast<float4*>(ws) + pair * S * per_split + tid;
    float* ws_ml = ws + n_pairs * S * kRows * HD + pair * S * kRows * 2;
    if (n_kv > 0) {
      float4* dst = ws_o + split * per_split;
#pragma unroll
      for (int sl = 0; sl < kSlices; ++sl)
#pragma unroll
        for (int j = 0; j < 16; ++j)
          dst[(sl * 16 + j) * kThreads] =
              make_float4(o[sl][4 * j], o[sl][4 * j + 1], o[sl][4 * j + 2],
                          o[sl][4 * j + 3]);
      if (quad == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          ws_ml[(split * kRows + row[h]) * 2] = m_run[h];
          ws_ml[(split * kRows + row[h]) * 2 + 1] = l_row[h];
        }
      }
    }
    merge_splits<HD, G>(reinterpret_cast<float4*>(ws) + pair * S * per_split,
                        ws_ml, counters + pair, smem_raw, out, b, kh, KH,
                        T_len, t0, t_end, k_lo, k_hi, S);
    return;
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float l = l_row[h];
    const float inv = l == 0.f ? 0.f : 1.f / l;
    const int m = row[h];
    const int t = t0 + m / G, g = m % G;
    if (t >= t_end) continue;
    __nv_bfloat16* dst =
        out + (((size_t)b * T_len + t) * H + kh * G + g) * HD + 2 * quad;
#pragma unroll
    for (int sl = 0; sl < kSlices; ++sl) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(dst + 128 * sl + 8 * j) =
            __floats2bfloat162_rn(o[sl][4 * j + 2 * h] * inv,
                                  o[sl][4 * j + 2 * h + 1] * inv);
      }
    }
  }
}

template <int HD, int G, bool kFp8>
cudaError_t launch(const void* q, const void* cache, const int* tables,
                   const int* kv_lens, const int* starts, void* out,
                   float* ws, int* counters, int B, int T_len, int KH, int nb,
                   int bs, int W, int layer, int window, float scale,
                   float softcap, int splits, cudaStream_t stream) {
  using CT = std::conditional_t<kFp8, uint8_t, __nv_bfloat16>;
  constexpr int smem = Geo<HD, kFp8>::kSmem;
  static bool smem_set = false;  // idempotent: a race only repeats the call
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_prefill_wgmma_kernel<HD, G, kFp8>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  constexpr int TQ = kRows / G;
  const long long z = (long long)((T_len + TQ - 1) / TQ) * splits;
  if (z > 65535) return cudaErrorInvalidValue;
  dim3 grid(KH, B, (unsigned)z);
  paged_prefill_wgmma_kernel<HD, G, kFp8><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const CT*>(cache),
      tables, kv_lens, starts, static_cast<__nv_bfloat16*>(out), ws,
      counters, T_len, nb, bs, KH, W, layer, window, scale, softcap, splits);
  return cudaGetLastError();
}

template <int HD, bool kFp8>
int by_group(int G, const void* q, const void* cache, const int* tables,
             const int* kv_lens, const int* starts, void* out, float* ws,
             int* counters, int B, int T_len, int KH, int nb, int bs, int W,
             int layer, int window, float scale, float softcap, int splits,
             cudaStream_t s) {
#define PST_PREFILL(GG)                                                    \
  return (int)launch<HD, GG, kFp8>(q, cache, tables, kv_lens, starts, out, \
                                   ws, counters, B, T_len, KH, nb, bs, W,  \
                                   layer, window, scale, softcap, splits, s)
  switch (G) {
    case 1: PST_PREFILL(1);
    case 2: PST_PREFILL(2);
    case 3: PST_PREFILL(3);
    case 4: PST_PREFILL(4);
    case 5: PST_PREFILL(5);
    case 6: PST_PREFILL(6);
    case 7: PST_PREFILL(7);
    case 8: PST_PREFILL(8);
    default: return (int)cudaErrorInvalidValue;
  }
#undef PST_PREFILL
}

// The launch at head dim HD: cache_dtype 1 = bfloat16, 2 = float8_e4m3fn
// (q is bf16). splits > 1 needs ws (q-tiles * splits * 128 * (HD + 2)
// floats, q-tiles = B * KH * ceil(T / (128 / G))) and counters (q-tiles
// int32, zero; left zero). Returns a cudaError_t (0 = success).
template <int HD>
int prefill_wgmma(int cache_dtype, const void* q, const void* cache,
                  const int* tables, const int* kv_lens, const int* starts,
                  void* out, float* ws, int* counters, int B, int T_len,
                  int H, int KH, int nb, int bs, int W, int layer, int window,
                  float scale, float softcap, int splits, void* stream) {
  if (B == 0 || T_len == 0) return 0;
  if (KH <= 0 || H % KH || B > 65535 || KH > 65535 || splits < 1 ||
      splits > kMaxSplits ||
      (splits > 1 && (ws == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = H / KH;
#define PST_ARGS                                                          \
  G, q, cache, tables, kv_lens, starts, out, ws, counters, B, T_len, KH,  \
      nb, bs, W, layer, window, scale, softcap, splits, s
  if (cache_dtype == 1) return by_group<HD, false>(PST_ARGS);
  if (cache_dtype == 2) return by_group<HD, true>(PST_ARGS);
#undef PST_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // namespace
