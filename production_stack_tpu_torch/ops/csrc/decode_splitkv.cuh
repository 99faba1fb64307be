// Split-KV ("flash-decoding") paged decode attention with bf16 q for
// Hopper, over a bf16 or an e4m3 cache, at head_dim HD = 128 or 256.
// Built once a head dim: decode_splitkv.cu (HD 128, and the C entry
// point) and decode_splitkv_hd256.cu (HD 256, the Gemma family), two nvcc
// processes side by side.
//
// Replaces, for bf16 q at head_dim 128 and 256, two Pallas TPU kernels of
// production_stack_tpu/ops/paged_attention_pallas.py:
//   decode_split_kernel<HD, G, false, *>  <- _decode_kernel (one query
//                                            token per sequence)
//   decode_split_kernel<HD, G, true, *>   <- _decode_write_kernel (the
//                                            same decode with this step's
//                                            K/V row written into its
//                                            page; PST_FUSED_KV_WRITE=1)
// and their e4m3-cache forms (kFp8, kv_cache_dtype="float8_e4m3fn"). fp32 q
// and other head dims keep paged_decode_kernel (decode and decode-write)
// of paged_attention.cuh. The contract is theirs, unchanged:
//   q      [B, H, HD] bf16          cache [L, nb, 2, bs, KH*HD] bf16 or
//                                   e4m3
//   tables [B, W] int32             kv_lens [B] int32 (the query sits at
//                                   kv_len - 1 and sees keys >= kv_len -
//                                   window); a table shorter than kv_len is
//                                   clamped to its last entry
//   k_new, v_new [B, KH*HD] bf16, write_flat [B] int32
//   (decode-write: flat slot blk * bs + row; outside [0, nb*bs) nothing is
//   written)
// Scores are scaled, then soft-capped; a row with no live key writes zeros;
// a NaN in a live K or V row (an e4m3 cast past 464) reaches the output, as
// in the plain version; G = H / KH from 1 to 8 (rows G..15 of the m16 tile
// are padding).
//
// Precision contract: K and V are up-converted exactly to bf16 (every
// e4m3 value is a bf16 value). Q·Kᵀ accumulates in fp32; the softmax runs
// in fp32; P is rounded to bf16 before P·V, which accumulates in fp32 —
// as precise as the JAX kernel's _pv_dot (P to about 2^-8) or more. Into
// an e4m3 cache the decode-write casts the new row by fp8.cuh's cast_e4m3,
// the JAX package's cast bit for bit (as ops/fp8.py's); split 0 stores it
// and every split reads the same bytes back for that key.
//
// Bound on an NVIDIA H100 80GB HBM3 at its 700 W limit (3.35 TB/s): bytes.
// Every live K/V row is read once: at B = 8, kv_len 4096 and Llama-3-8B
// heads that is 134 MB, 0.040 ms; at gemma2-9b's (KH 8, HD 256) 268 MB,
// 0.080 ms. The G query heads of a kv head share each row read.
//
// Design. Grid (B, KH, S), 128 threads (4 warps). The wrapper picks S
// (decode_plan in paged_attention_cuda.py) from B, KH, the table width and
// the SM count, never from kv_lens, so B * KH * S blocks fill the card
// whatever the batch: one interactive user (B = 1) gets tens of blocks per
// kv head instead of one.
//   - Keys go in tiles of kKeys positions (bf16: 64 at HD 128, 32 at HD
//     256, a tile is 16 KB of K at either; e4m3: 64 at both), aligned to
//     multiples of kKeys.
//     Row b's live tiles [lo / kKeys, ceil(kv_len / kKeys)) are cut into
//     S runs of consecutive tiles (run s starts at n * s / S); keys outside
//     [lo, kv_len) are zero-filled and masked. A run with no tile records
//     m = -inf, l = 0.
//   - The block first copies its slice of the table row into shared
//     memory, so no K/V copy waits on a table load. (Page ids prefetched
//     into registers one tile ahead left a table load's latency exposed
//     every tile: slower on the H100 at every shape timed.)
//   - A 3-slot ring (two tiles, 64 KB, in flight ahead of the one being
//     read; two blocks an SM, so about 128 KB an SM); one block barrier a
//     tile hands it over. bf16 at HD 128 and e4m3: each 16-byte piece of a
//     K or V row is gathered through the table by cp.async, the chunk
//     position swizzled by the row (bf16: chunk c of row r at c ^ (r % 8))
//     so that ldmatrix's eight rows of one chunk hit every bank once; a
//     4-slot ring at one block an SM, or a 2-slot ring at three, was slower
//     (bf16 at HD 128). bf16 at HD 256: warp 0 gathers the tile, one lane a
//     key row, each whole 512-byte K or V row by one bulk copy (the TMA
//     unit's cp.async.bulk, no tensor map, so any bs works), completed on
//     the slot's mbarrier; rows are padded by 16 bytes instead of swizzled
//     (528 bytes apart, eight rows of one chunk hit every bank once), and a
//     row outside [lo, kv_len) is zero-filled by its lane. On an NVIDIA
//     H100 80GB HBM3 at 700 W, with cp.async pieces this form matched the
//     previous one (below); with bulk copies it was 5 % faster (PERF.md).
//   - Products on the tensor cores (mma.sync), in the log2 domain; every
//     warp keeps its own flash state, so the warps never wait for each
//     other inside a tile, and their states merge in shared memory at the
//     end. S = Q Kᵀ has the G heads as its rows (padded to 16: q is the
//     register A operand, loaded once), K's B fragments come by ldmatrix;
//     a head's scores sit in the 4 lanes of a quad (two shuffles for its
//     max). P is rounded to bf16 as prefill_wgmma.cu rounds it.
//     * bf16 at HD 128: a warp owns 16 keys of every tile and all 128
//       dims; P is the A operand of O += P V straight from the score
//       registers (m16n8k16, heads padded to 16), V's B fragments by
//       ldmatrix.trans. (A first version on the CUDA cores, a lane per key
//       and three block barriers a 32-key tile, was slower at every shape
//       timed; O kept transposed, as at HD 256, was 0.1-1.4 % faster at
//       the four shapes timed in one call, within the spread, so this
//       layout stays.)
//     * bf16 at HD 256 (kNarrow): a warp owns 8 keys of every 32-key tile
//       and all 256 dims, so no two warps compute the same scores: S over
//       one n8 tile (in two accumulators, even and odd k-steps), and P·V
//       runs transposed, Oᵀ[dims][heads] += Vᵀ Pᵀ on m16n8k8 (the 8 keys
//       as k, the G <= 8 heads as n8): the lane's score accumulator is
//       already Pᵀ's B fragment, no product and no register of O holds a
//       padding head (O is 64 registers a thread), and one ldmatrix.trans
//       gives Vᵀ's A fragments of two m-tiles. O is rescaled only when a
//       head's max moved. Measured alternatives (NVIDIA H100 80GB HBM3,
//       700 W, PERF.md): 16 keys a warp in 64-key tiles, a 192 KB ring
//       and one block an SM (four warps an SM) was 18 % slower than the
//       previous form at B = 8 x 4096 (0.1234 against 0.1049 ms) and 26 %
//       at B = 64; this form on cp.async pieces matched the previous one
//       (0.1019 against 0.1030, 0.7314 against 0.7316): the loop is bound
//       by its copies, not by its products.
//   - Splits combine in the same launch: a block with S > 1 writes its
//     (acc[G][HD], m[G], l[G]) in fp32 to the workspace the wrapper
//     allocates, fences, and takes a ticket from the (b, kh) counter; the
//     block that takes the last ticket merges the S partials in split
//     order (so two launches give bit-identical outputs), writes bf16 and
//     resets the counter to 0 for the next launch (splits.cuh: the run,
//     the ticket and the merge weights, shared with prefill_wgmma.cuh).
//     The counters live in a buffer the wrapper keeps per device: launches
//     that share it must be ordered (one stream), as the engine's are.
//   - An e4m3 cache (redesigned for Hopper): the ring holds the e4m3 bytes
//     as they are, and the warps build their tensor-core fragments from
//     them in registers, converting exactly (fp8.cuh) as they go. No bf16
//     tile, no ldmatrix, and one block barrier a tile, as in bf16. (The
//     first e4m3 form converted each staged tile into one bf16 tile in
//     shared memory behind a second barrier: 80 KB of shared-memory
//     traffic a 64-key tile at HD 128 against bf16's 32 KB, and a tile's
//     conversion could not overlap the products of the one before; 43-45 %
//     of the byte bound at B = 8, PERF.md, PR 6.)
//     * Each warp owns 16 keys of a tile and all HD dims of O, so a tile is
//       64 keys (4 warps) at either head dim: 8 KB of K at HD 128, 16 KB at
//       256. P·V runs transposed, Oᵀ[dims][heads] += Vᵀ Pᵀ (m16n8k16: 16
//       dims, the G <= 8 heads as n8), so O is HD / 4 registers a thread
//       with no padding rows (32 at HD 128, 64 at 256), and P, the
//       accumulator of S = Q Kᵀ, is already Pᵀ's B fragment.
//     * K: Q·Kᵀ sums over dims, so which dims a k-step takes is the
//       kernel's choice. Lane (grp, tig) takes, in k-step kk = 4 h + w, the
//       dims 16 (tig + 4 h) + 4 w + {0..3} (b0, b1): one 16-byte load of a
//       staged K row gives it 4 k-steps' fragments. Q's A fragments are
//       loaded once in the same order (paged_attention_cuda.py::
//       e4m3_k_dims mirrors the map for the CPU tests).
//     * V: P·V sums over keys, and which key each column of S stands for
//       is the kernel's choice too (each lane supplies one K row): column
//       n of n8 tile j of a 16-key step is key 4 (n / 2) + 2 j + n % 2, so
//       a lane's four P values are 4 consecutive keys 4 tig .. 4 tig + 3.
//       Its Vᵀ A fragments need those 4 keys at dims 16 grp + {0..15} (+128
//       per half at HD 256): four 16-byte loads (one a key row) and a byte
//       permute (prmt) give each register its key pair at one dim.
//     * Staging layout: 16-byte chunk c of key row r at chunk c ^ sig(r),
//       sig(r) = 4 ((r ^ r >> 2) & 1) + 2 ((r >> 3) & 1), so both fragment
//       loads hit every bank once a quarter-warp (e4m3_stage_offset).
//     * Shared memory: the e4m3 ring alone, 3 slots of 16 KB at HD 128 (48
//       KB) and of 32 KB at 256 (96 KB, 2 blocks an SM), and q's G rows:
//       at HD 128 the registers hold 4 blocks an SM (128 a thread) only
//       with Q's fragments read from shared memory 16 dims at a time, not
//       kept in registers. Four blocks an SM, not three, because at B = 64
//       the 512 blocks of a step then make one wave, not 1.3 (on an NVIDIA
//       H100 80GB HBM3 at 700 W, three were 23 % slower there; a 6-slot
//       ring at two blocks an SM was slower at every shape; PERF.md, PR 9).
//     * What bounds it: bytes, half of bf16's. On an NVIDIA H100 80GB HBM3
//       at 700 W it reaches 57 % of the byte bound at B = 8 x 4096 (hd
//       128) and 80 % at B = 64; a build with the conversions taken out
//       (wrong values) was only 2.5 % faster at B = 8, so the loop is not
//       bound by them, and a conversion by integer ops and a bf16 multiply
//       (0x7f made NaN by hand) was 19 % slower than the hardware's
//       cvt. The other route, e4m3 operands for P·V (m16n8k32, P split
//       into an e4m3 part and a 16x residual as the TPU kernel's _pv_dot
//       does), skips V's conversion; a build of it spilled, was 29 % (hd
//       128) and 88 % (hd 256) slower at B = 8 and disagreed with the
//       plain version (PERF.md, PR 9).
//   - Decode-write: blocks of a launch are not ordered, so no block reads
//     the row this step writes. Every block compares each key's flat slot
//     table[pos / bs] * bs + pos % bs with write_flat[b] and copies that
//     key from k_new / v_new instead of the cache; split 0 alone stores the
//     row into the cache. A slot outside [0, nb*bs) stores and substitutes
//     nothing. This needs the rule the engine keeps (checked on the CPU by
//     tests/test_torch_decode_split.py): a sequence writes only into its
//     own last page, and shared prefix pages are full, so no other row
//     reads the written slot in the same step.

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
using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSplits = 64;
constexpr int kPageCap = 1024;  // table entries a block keeps in shared memory
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kThreads == 128,
              "the merges give each thread one dim of each 128-dim slice");

// The geometry of head dim HD and cache form kFp8. Every warp owns
// kKeysPerWarp keys of a tile and all HD dims of O. kOT: O is kept
// transposed, Oᵀ [dims][heads] (the e4m3 forms and bf16 at HD 256); bf16
// at HD 128 keeps O [heads][dims] with the heads padded to 16. kNarrow
// (bf16 at HD 256): 8 keys a warp, a 32-key tile, P·V on m16n8k8.
template <int HD, bool kFp8>
struct Geo {
  static_assert(HD == 128 || HD == 256, "the split kernel takes HD 128, 256");
  static constexpr bool kOT = kFp8 || HD == 256;
  static constexpr bool kNarrow = !kFp8 && HD == 256;
  static constexpr int kKeysPerWarp = kNarrow ? 8 : 16;
  static constexpr int kKeys = kKeysPerWarp * kWarps;       // 32 or 64
  static constexpr int kRowBytes = HD * (kFp8 ? 1 : 2);     // a cache row
  // A staged row: kNarrow's rows are copied whole by the bulk copy engine
  // and padded by 16 bytes, so that ldmatrix's 8 rows of a chunk hit
  // every bank once; the others are swizzled (swz, swz8).
  static constexpr int kRowStride = kRowBytes + (kNarrow ? 16 : 0);
  static constexpr int kTileBytes = kKeys * kRowStride;     // K (or V)
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kStages = 3;  // ring slots
  // bf16 96 KB (HD 128), 99 KB (256); e4m3 48 KB (HD 128), 96 KB (256).
  static constexpr int kSmem = kStages * kStageBytes;
  // Blocks an SM (paged_attention_cuda.py's plan assumes the same): e4m3
  // at HD 128 is held to 128 registers a thread.
  static constexpr int kMinBlocks = kFp8 && HD == 128 ? 4 : 1;
  static_assert(kWarps * 8 * (HD + 2) * 4 <= kSmem,
                "the warps' states fit the ring");
  static_assert(2 * kMaxSplits * 8 * 4 <= kSmem,
                "the merge's weights fit the ring");
};

// Byte offset of 16-byte chunk c (0..HD/8 - 1) of bf16 key row r in a
// tile.
template <int HD>
__device__ __forceinline__ int swz(int r, int c) {
  return r * HD * 2 + ((c ^ (r & 7)) << 4);
}

// e4m3 staging: chunk c (0..HD/16 - 1) of key row r sits at chunk
// c ^ sig(r). A quarter-warp's K loads read rows 2i, 2i + 1 of a 16-key
// group at 4 chunks each, and its V loads rows i, i + 4, i + 8, i + 12 at
// 2 chunks each; sig flips bit 2 between the first pair and takes 4
// values over the second, so each reads 8 distinct chunks of the 8 a
// 128-byte bank line holds (paged_attention_cuda.py::e4m3_stage_offset).
__device__ __forceinline__ int sig8(int r) {
  return (((r ^ (r >> 2)) & 1) << 2) | (((r >> 3) & 1) << 1);
}
template <int HD>
__device__ __forceinline__ int swz8(int r, int c) {
  return r * HD + ((c ^ sig8(r)) << 4);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Four 8 x 8 bf16 matrices from shared memory; lanes 8 i .. 8 i + 7 give
// the row addresses of matrix i, and register i receives it as an mma
// fragment (row lane / 4, columns 2 (lane % 4) + {0, 1}), or transposed.
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0,
                                        uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t& r0,
                                              uint32_t& r1, uint32_t& r2,
                                              uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

// D[16 x 8] += A[16 x 8] B[8 x 8] in fp32 (bf16 at HD 256's Oᵀ += Vᵀ Pᵀ
// over a warp's 8 keys).
__device__ __forceinline__ void mma_bf16_k8(float (&d)[4], uint32_t a0,
                                            uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// D[16 x 8] += A[16 x 16] B[16 x 8] in fp32; A's rows 8..15 are zero (the
// padding heads), so only its registers a0 and a2 are given.
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a2, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

// The same with all four A registers (e4m3's Oᵀ += Vᵀ Pᵀ).
__device__ __forceinline__ void mma_bf16_a4(float (&d)[4], uint32_t a0,
                                            uint32_t a1, uint32_t a2,
                                            uint32_t a3, uint32_t b0,
                                            uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t word(const uint4& v, int w) {
  return w == 0 ? v.x : w == 1 ? v.y : w == 2 ? v.z : v.w;
}

// CT: the cache's element, bf16 or (kFp8) one e4m3 byte.
template <int HD, int G, bool kWrite, bool kFp8,
          typename CT = std::conditional_t<kFp8, uint8_t, bf16>>
__global__ void __launch_bounds__(kThreads, (Geo<HD, kFp8>::kMinBlocks))
decode_split_kernel(const bf16* __restrict__ q, CT* cache,
                    const bf16* __restrict__ k_new,
                    const bf16* __restrict__ v_new,
                    const int* __restrict__ write_flat,
                    const int* __restrict__ tables,
                    const int* __restrict__ kv_lens, bf16* __restrict__ out,
                    float* __restrict__ ws, int* __restrict__ counters,
                    int nb, int bs, int KH, int W, int layer, int window,
                    float scale, float softcap) {
  using Gm = Geo<HD, kFp8>;
  constexpr int kKeys = Gm::kKeys;
  extern __shared__ __align__(16) uint8_t ring[];
  __shared__ int sPages[kPageCap];
  __shared__ __align__(16) uint8_t sNew[2][HD];  // e4m3: the cast K, V rows
  // e4m3 at HD 128: q's G rows (bf16), read 16 dims at a time; rows padded
  // by 16 bytes so that a quarter-warp's two rows hit other banks.
  constexpr bool kQs = kFp8 && HD == 128;
  constexpr int kQRow = HD + 8;
  __shared__ __align__(16) bf16 sQ[kQs ? G : 1][kQs ? kQRow : 1];
  __shared__ float sL[G];
  __shared__ __align__(8) uint64_t sBar[Gm::kNarrow ? Gm::kStages : 1];

  const int b = blockIdx.x;
  const int kh = blockIdx.y;
  const int split = blockIdx.z;
  const int S = gridDim.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int H = KH * G;

  const int kv_len = kv_lens[b];
  const int win = window > 0 ? window : (1 << 30);
  const int lo = max(kv_len - win, 0);
  int t0;
  const int n_t = split_run(lo, kv_len, kKeys, split, S, t0);

  // A cache row of one kv head is kChunks 16-byte pieces of kPer values.
  constexpr int kPer = 16 / sizeof(CT);
  constexpr int kChunks = HD / kPer;
  const size_t lanes = (size_t)KH * HD;
  const size_t page_stride = 2 * (size_t)bs * lanes;
  const CT* layer_base =
      cache + (size_t)layer * nb * page_stride + (size_t)kh * HD;
  const int* trow = tables + (size_t)b * W;

  // Decode-write: this step's row (bf16), its slot, and split 0's store
  // of it. An e4m3 cache takes the row cast by cast_e4m3 (JAX's cast):
  // every block casts it into sNew, whence its key is substituted, and
  // split 0 stores those bytes.
  int wf = -1;
  const bf16* knew = nullptr;
  const bf16* vnew = nullptr;
  if constexpr (kWrite) {
    const int w = write_flat[b];
    if (w >= 0 && w < nb * bs) {
      wf = w;
      knew = k_new + (size_t)b * lanes + (size_t)kh * HD;
      vnew = v_new + (size_t)b * lanes + (size_t)kh * HD;
      CT* row = cache +
                (((size_t)layer * nb + w / bs) * 2 * bs + w % bs) * lanes +
                (size_t)kh * HD;
      if constexpr (kFp8) {
        if (tid < HD / 4) {  // HD / 8 threads a row, 8 values each
          const int h = tid / (HD / 8), c = tid % (HD / 8);
          const uint2 e = cast_e4m3x8(*reinterpret_cast<const uint4*>(
              (h ? vnew : knew) + c * 8));
          *reinterpret_cast<uint2*>(&sNew[h][c * 8]) = e;
          if (split == 0)
            *reinterpret_cast<uint2*>(row + h * (size_t)bs * lanes + c * 8) = e;
        }
      } else if (split == 0 && tid < 2 * kChunks) {
        const int c = tid % kChunks;
        if (tid < kChunks) {
          *reinterpret_cast<uint4*>(row + c * kPer) =
              *reinterpret_cast<const uint4*>(knew + c * kPer);
        } else {
          *reinterpret_cast<uint4*>(row + (size_t)bs * lanes + c * kPer) =
              *reinterpret_cast<const uint4*>(vnew + c * kPer);
        }
      }
    }
  }

  // Q as the A fragments of S = Q Kᵀ, whose rows are the G heads padded
  // to 16 (rows 8..15 are always padding: a1 = a3 = 0), loaded once into
  // registers. bf16: k-step kk holds dims 16 kk + 2 (lane % 4) + {0, 1}
  // and + 8 of head lane / 4. e4m3: k-step kk = 4 h + w holds dims 16
  // (lane % 4 + 4 h) + 4 w + {0, 1} and + {2, 3}, the order in which a K
  // row's 16-byte chunk lands in a lane's registers; at HD 128 (kQs) they
  // are read from shared memory 16 dims at a time instead, so that four
  // blocks an SM fit the registers without a spill.
  const int grp = lane / 4, tig = lane % 4;
  uint32_t qa[kQs ? 1 : HD / 16][2];
  const bf16* qb = q + ((size_t)b * H + kh * G) * HD;
  if constexpr (kQs) {
    for (int i = tid; i < G * HD / 4; i += kThreads) {
      const int g = i / (HD / 4), c = i % (HD / 4);
      *reinterpret_cast<uint2*>(&sQ[g][4 * c]) =
          *reinterpret_cast<const uint2*>(qb + g * HD + 4 * c);
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      qa[kk][0] = qa[kk][1] = 0u;
      if (grp < G) {
        if constexpr (kFp8) {
          const uint2 v = *reinterpret_cast<const uint2*>(
              qb + grp * HD + 16 * (tig + 4 * (kk / 4)) + 4 * (kk % 4));
          qa[kk][0] = v.x;
          qa[kk][1] = v.y;
        } else {
          const bf16* qr = qb + grp * HD + 16 * kk + 2 * tig;
          qa[kk][0] = *reinterpret_cast<const uint32_t*>(qr);
          qa[kk][1] = *reinterpret_cast<const uint32_t*>(qr + 8);
        }
      }
    }
  }

  // Thread tid copies piece tid % kChunks of rows tid / kChunks + j *
  // kThreads / kChunks of each tile: 8 (HD 128) or 16 (HD 256) bf16 rows,
  // or 4 or 8 e4m3 rows.
  const int cc = tid % kChunks;
  constexpr int kRowsPerThread = kKeys * kChunks / kThreads;
  // The block's slice of the table row, loaded once up front: entries
  // [p_lo, p_lo + kPageCap) live in shared memory, any beyond (a split of
  // more than kPageCap pages) are read from the table.
  const int p_lo = min(t0 * kKeys / bs, W - 1);
  const int p_n = min((t0 + n_t) * kKeys / bs, W - 1) + 1 - p_lo;
  for (int i = tid; i < min(p_n, kPageCap); i += kThreads)
    sPages[i] = __ldg(trow + p_lo + i);
  if (Gm::kNarrow && tid == 0) {  // a ring slot's arrivals: its copier's
#pragma unroll
    for (int s = 0; s < Gm::kStages; ++s) mbar_init(smem_u32(&sBar[s]), 1);
    fence_mbarrier_init();
  }
  __syncthreads();
  auto page_of = [&](int pos) {
    const int p = min(pos / bs, W - 1) - p_lo;
    return p < kPageCap ? sPages[p] : __ldg(trow + p_lo + p);
  };
  auto copy_tile = [&](int it) {
    uint8_t* const slot = ring + (it % Gm::kStages) * Gm::kStageBytes;
    const uint32_t sK = smem_u32(slot);
    const uint32_t sV = sK + Gm::kTileBytes;
    if constexpr (Gm::kNarrow) {
      // Warp 0 copies the tile: lane r key row r of K and of V, each one
      // bulk copy of the whole row, completed on the slot's mbarrier; a
      // row outside [lo, kv_len) is zero-filled by its lane (a stale row
      // could hold a NaN, which P = 0 would not cancel).
      if (warp != 0) return;
      const int pos = (t0 + it) * kKeys + lane;
      const bool ok = pos >= lo && pos < kv_len;
      const uint32_t bar = smem_u32(&sBar[it % Gm::kStages]);
      const int n_ok = __popc(__ballot_sync(0xffffffffu, ok));
      if (lane == 0) mbar_arrive_expect_tx(bar, n_ok * 2 * Gm::kRowBytes);
      const uint32_t dk = sK + lane * Gm::kRowStride;
      if (ok) {
        const int pg = page_of(pos);
        const CT* row =
            layer_base + (size_t)pg * page_stride + (size_t)(pos % bs) * lanes;
        const void* src_k = row;
        const void* src_v = row + (size_t)bs * lanes;
        if (kWrite && pg * bs + pos % bs == wf) {
          src_k = knew;
          src_v = vnew;
        }
        bulk_copy_g2s(dk, src_k, Gm::kRowBytes, bar);
        bulk_copy_g2s(dk + Gm::kTileBytes, src_v, Gm::kRowBytes, bar);
      } else {
        uint4* zk = reinterpret_cast<uint4*>(slot + lane * Gm::kRowStride);
        uint4* zv = reinterpret_cast<uint4*>(slot + Gm::kTileBytes +
                                             lane * Gm::kRowStride);
#pragma unroll 8
        for (int c = 0; c < Gm::kRowBytes / 16; ++c)
          zk[c] = zv[c] = make_uint4(0u, 0u, 0u, 0u);
        fence_proxy_async();  // before a later bulk copy into the row
      }
      return;
    }
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      const int r = tid / kChunks + (kThreads / kChunks) * j;
      const int pos = (t0 + it) * kKeys + r;
      const bool ok = pos >= lo && pos < kv_len;
      const int off = kFp8 ? swz8<HD>(r, cc) : swz<HD>(r, cc);
      const void* src_k = cache;  // a valid address when nothing is read
      const void* src_v = cache;
      if (ok) {
        const int pg = page_of(pos);
        const CT* row = layer_base + (size_t)pg * page_stride +
                        (size_t)(pos % bs) * lanes + cc * kPer;
        src_k = row;
        src_v = row + (size_t)bs * lanes;
        if constexpr (kWrite) {
          if (pg * bs + pos % bs == wf) {
            if constexpr (kFp8) {  // the cast row, from sNew
              *reinterpret_cast<uint4*>(slot + off) =
                  *reinterpret_cast<const uint4*>(&sNew[0][cc * 16]);
              *reinterpret_cast<uint4*>(slot + Gm::kTileBytes + off) =
                  *reinterpret_cast<const uint4*>(&sNew[1][cc * 16]);
              continue;
            } else {
              src_k = knew + cc * kPer;
              src_v = vnew + cc * kPer;
            }
          }
        }
      }
      cp_async16(sK + off, src_k, ok);
      cp_async16(sV + off, src_v, ok);
    }
  };

#pragma unroll
  for (int s = 0; s < Gm::kStages - 1; ++s) {
    if (s < n_t) copy_tile(s);
    cp_async_commit();
  }

  const bool capped = softcap > 0.f;
  const float c_scale = capped ? scale / softcap : scale * kLog2e;
  const float c_cap = softcap * kLog2e;
  // This warp's flash state. bf16 at HD 128: head grp's O over the 128
  // dims (registers c0, c1 of each of the 16 dim tiles; c2, c3 belong to
  // the padding rows). Oᵀ (kOT): HD / 16 m-tiles of 16 dims by the 8
  // heads, tile T's registers heads 2 tig, 2 tig + 1 (c0, c1) at one dim
  // and (c2, c3) at another: e4m3 dims 128 (T / 8) + 16 grp + 2 (T % 8)
  // and the next; bf16 16 T + grp and 16 T + grp + 8. Then head grp's
  // running max and this thread's share of its row sum.
  constexpr int kOTiles = Gm::kOT ? HD / 16 : 16;
  float o[kOTiles][4];
#pragma unroll
  for (int n = 0; n < kOTiles; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] = 0.f;
  float m_run = -INFINITY, l_run = 0.f;
  const int kw = Gm::kKeysPerWarp * warp;  // the warp's keys in a tile
  // e4m3: the K row (of the warp's 16) a lane reads for S's n8 tile j,
  // and the staging chunk order of that row and of the lane's V rows.
  const int krow0 = 4 * (grp >> 1) + (grp & 1);
  const int ksig0 = sig8(krow0), ksig1 = sig8(krow0 + 2);

  for (int it = 0; it < n_t; ++it) {
    if constexpr (Gm::kNarrow)
      mbar_wait(smem_u32(&sBar[it % Gm::kStages]), (it / Gm::kStages) & 1);
    else
      cp_async_wait<Gm::kStages - 2>();
    // Tile it has landed for every thread, and every thread is done with
    // tile it - 1, whose slot the next copy refills.
    __syncthreads();
    const int nx = it + Gm::kStages - 1;
    if (nx < n_t) copy_tile(nx);
    cp_async_commit();

    const int key0 = (t0 + it) * kKeys + kw;  // position of the warp's key 0
    if (key0 >= kv_len || key0 + Gm::kKeysPerWarp <= lo) continue;  // no key

    const uint8_t* const slot = ring + (it % Gm::kStages) * Gm::kStageBytes;
    const uint32_t sK = smem_u32(slot);
    const uint32_t sV = sK + Gm::kTileBytes;

    if constexpr (Gm::kNarrow) {
      // S = Q Kᵀ over the warp's 8 keys (one n8 tile: column n is key kw +
      // n), K's B fragments by ldmatrix (matrix i of call p: chunk 4 p + i,
      // i.e. k-steps 2 p and 2 p + 1), in two accumulators (even and odd
      // p) for two independent mma chains. Lane l gives row kw + l % 8.
      const uint32_t krow = sK + (kw + (lane & 7)) * Gm::kRowStride;
      float s2[2][4] = {};
#pragma unroll
      for (int p = 0; p < HD / 32; ++p) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4(krow + ((4 * p + (lane >> 3)) << 4), b0, b1, b2, b3);
        mma_bf16(s2[p & 1], qa[2 * p][0], qa[2 * p][1], b0, b1);
        mma_bf16(s2[p & 1], qa[2 * p + 1][0], qa[2 * p + 1][1], b2, b3);
      }
      // One softmax update a tile: head grp's scores at keys key0 + 2 tig
      // + e, spread over the 4 lanes of a quad.
      float x[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int pos = key0 + 2 * tig + e;
        const float d = s2[0][e] + s2[1][e];
        const float v = capped ? tanhf(d * c_scale) * c_cap : d * c_scale;
        x[e] = pos >= lo && pos < kv_len ? v : -INFINITY;
      }
      float mx = fmaxf(x[0], x[1]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run, mx);
      const float mb = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = fast_exp2(m_run - mb);
      m_run = m_new;
      const float p0 = fast_exp2(x[0] - mb), p1 = fast_exp2(x[1] - mb);
      l_run = l_run * alpha + (p0 + p1);
      // P, rounded to bf16: keys 2 tig, 2 tig + 1 of head grp, the B
      // fragment of Oᵀ += Vᵀ Pᵀ (m16n8k8: k the 8 keys, n8 the heads).
      const uint32_t pb = pack_bf16x2(p0, p1);
      // Rescale only where a head's max moved (alpha != 1 in some lane;
      // skipping a multiply by 1 changes no bit).
      if (__any_sync(0xffffffffu, alpha != 1.f)) {
        const float a_lo = __shfl_sync(0xffffffffu, alpha, 8 * tig);
        const float a_hi = __shfl_sync(0xffffffffu, alpha, 8 * tig + 4);
#pragma unroll
        for (int n = 0; n < kOTiles; ++n) {
          o[n][0] *= a_lo;
          o[n][1] *= a_hi;
          o[n][2] *= a_lo;
          o[n][3] *= a_hi;
        }
      }
      // Vᵀ's A fragments by ldmatrix.trans, one x4 two m-tiles: matrix
      // i = lane / 8 is the warp's 8 keys at chunk 4 u + i, so registers
      // (0, 1) are a0 (dims 16 (2 u) + grp, keys 2 tig, + 1) and a1 (dims
      // + 8) of m-tile 2 u, (2, 3) those of m-tile 2 u + 1.
      const uint32_t vrow = krow + Gm::kTileBytes;
#pragma unroll
      for (int u = 0; u < HD / 32; ++u) {
        uint32_t a0, a1, a2, a3;
        ldsm_x4_trans(vrow + ((4 * u + (lane >> 3)) << 4), a0, a1, a2, a3);
        mma_bf16_k8(o[2 * u], a0, a1, pb);
        mma_bf16_k8(o[2 * u + 1], a2, a3, pb);
      }
      continue;
    }

    // S = Q Kᵀ over the warp's 16 keys (two n-tiles of 8). bf16: K's B
    // fragments by ldmatrix from the swizzled rows: matrix i of an x4 is
    // chunk 4 p + i of 8 keys, i.e. k-steps 2 p and 2 p + 1. e4m3: n-tile
    // j, column grp is key krow0 + 2 j, whose chunk tig + 4 h is the
    // lane's (b0, b1) of k-steps 4 h .. 4 h + 3, converted exactly.
    float sc[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[j][i] = 0.f;
    if constexpr (kFp8) {
#pragma unroll
      for (int h = 0; h < HD / 64; ++h) {
        uint4 q0 = make_uint4(0u, 0u, 0u, 0u), q1 = q0;  // kQs: dims +0..15
        if (kQs && grp < G) {
          const bf16* qr = &sQ[grp][16 * (tig + 4 * h)];
          q0 = *reinterpret_cast<const uint4*>(qr);
          q1 = *reinterpret_cast<const uint4*>(qr + 8);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const uint4 v = *reinterpret_cast<const uint4*>(
              slot + (kw + krow0 + 2 * j) * HD +
              (((tig + 4 * h) ^ (j ? ksig1 : ksig0)) << 4));
#pragma unroll
          for (int w = 0; w < 4; ++w) {
            uint32_t b0, b1;
            e4m3x4_to_bf16x2x2(word(v, w), b0, b1);
            const uint4& qw = w < 2 ? q0 : q1;
            if constexpr (kQs)
              mma_bf16(sc[j], word(qw, 2 * (w % 2)), word(qw, 2 * (w % 2) + 1),
                       b0, b1);
            else
              mma_bf16(sc[j], qa[4 * h + w][0], qa[4 * h + w][1], b0, b1);
          }
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int p = 0; p < HD / 32; ++p) {
          uint32_t b0, b1, b2, b3;
          ldsm_x4(sK + swz<HD>(kw + 8 * j + (lane & 7), 4 * p + (lane >> 3)),
                  b0, b1, b2, b3);
          mma_bf16(sc[j], qa[2 * p][0], qa[2 * p][1], b0, b1);
          mma_bf16(sc[j], qa[2 * p + 1][0], qa[2 * p + 1][1], b2, b3);
        }
      }
    }

    // One softmax update a tile: head grp's score sc[j][e] is at key
    // key0 + 8 j + 2 tig + e (bf16) or key0 + 4 tig + 2 j + e (e4m3); the
    // row's 16 keys are spread over the 4 lanes of a quad.
    float x[4];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int pos = key0 + (kFp8 ? 4 * tig + 2 * j : 8 * j + 2 * tig) + e;
        float v = capped ? tanhf(sc[j][e] * c_scale) * c_cap
                         : sc[j][e] * c_scale;
        v = pos >= lo && pos < kv_len ? v : -INFINITY;
        x[2 * j + e] = v;
        mx = fmaxf(mx, v);
      }
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run, mx);
    // No live key yet: every p is 0 and nothing is rescaled.
    const float mb = m_new == -INFINITY ? 0.f : m_new;
    const float alpha = fast_exp2(m_run - mb);
    m_run = m_new;
    float pr[4], rs = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      pr[i] = fast_exp2(x[i] - mb);
      rs += pr[i];
    }
    l_run = l_run * alpha + rs;
    // P, rounded to bf16: keys 0..7 of the bf16 order in pa0, 8..15 in
    // pa2 (the A fragment of O += P V); e4m3: keys 4 tig, 4 tig + 1 and
    // 4 tig + 2, 4 tig + 3 (the B fragment of Oᵀ += Vᵀ Pᵀ).
    const uint32_t pa0 = pack_bf16x2(pr[0], pr[1]);
    const uint32_t pa2 = pack_bf16x2(pr[2], pr[3]);
    if constexpr (kFp8) {
      // Heads 2 tig and 2 tig + 1 (the columns of Oᵀ this lane holds) take
      // their alphas from lanes 8 tig and 8 tig + 4.
      const float a_lo = __shfl_sync(0xffffffffu, alpha, 8 * tig);
      const float a_hi = __shfl_sync(0xffffffffu, alpha, 8 * tig + 4);
#pragma unroll
      for (int n = 0; n < kOTiles; ++n) {
        o[n][0] *= a_lo;
        o[n][1] *= a_hi;
        o[n][2] *= a_lo;
        o[n][3] *= a_hi;
      }
      // Vᵀ's A fragments: key rows 4 tig + i (i = 0..3), chunk grp + 8 hh;
      // word w's bytes 2 s, 2 s + 1 are the dims of m-tile 8 hh + 2 w + s
      // (rows grp, grp + 8), each register a key pair at one dim.
      const uint8_t* vr = slot + Gm::kTileBytes + (kw + 4 * tig) * HD;
#pragma unroll
      for (int hh = 0; hh < HD / 128; ++hh) {
        uint4 vk[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          vk[i] = *reinterpret_cast<const uint4*>(
              vr + i * HD + (((grp + 8 * hh) ^ sig8(4 * tig + i)) << 4));
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          uint32_t a01[4], a23[4];
          e4m3_key_pairs(word(vk[0], w), word(vk[1], w), a01);
          e4m3_key_pairs(word(vk[2], w), word(vk[3], w), a23);
          mma_bf16_a4(o[8 * hh + 2 * w], a01[0], a01[1], a23[0], a23[1],
                      pa0, pa2);
          mma_bf16_a4(o[8 * hh + 2 * w + 1], a01[2], a01[3], a23[2], a23[3],
                      pa0, pa2);
        }
      }
    } else {
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        o[n][0] *= alpha;
        o[n][1] *= alpha;
      }
      // V's B fragments by ldmatrix.trans: matrix i of an x4 is keys
      // 8 (i % 2).. of chunk m + i / 2.
#pragma unroll
      for (int m = 0; m < 16; m += 2) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4_trans(sV + swz<HD>(kw + 8 * ((lane >> 3) & 1) + (lane & 7),
                                   m + (lane >> 4)),
                      b0, b1, b2, b3);
        mma_bf16(o[m], pa0, pa2, b0, b1);
        mma_bf16(o[m + 1], pa0, pa2, b2, b3);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the warps' states meet in it

  l_run += __shfl_xor_sync(0xffffffffu, l_run, 1);
  l_run += __shfl_xor_sync(0xffffffffu, l_run, 2);
  float* sO = reinterpret_cast<float*>(ring);  // [kWarps][G][HD]
  float* sML = sO + kWarps * G * HD;           // [kWarps][G][2]
  if constexpr (Gm::kOT) {
#pragma unroll
    for (int n = 0; n < kOTiles; ++n) {
      // The dims of this lane's rows of m-tile n: (c0, c1) at d, (c2, c3)
      // at d + dd.
      const int d = kFp8 ? 128 * (n / 8) + 16 * grp + 2 * (n % 8)
                         : 16 * n + grp;
      constexpr int dd = kFp8 ? 1 : 8;
      float* r0 = sO + (warp * G + 2 * tig) * HD + d;
      if (2 * tig < G) {
        r0[0] = o[n][0];
        r0[dd] = o[n][2];
      }
      if (2 * tig + 1 < G) {
        r0[HD] = o[n][1];
        r0[HD + dd] = o[n][3];
      }
    }
  }
  if (grp < G) {
    if constexpr (!Gm::kOT) {
      float* row = sO + (warp * G + grp) * HD + 2 * tig;
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        row[8 * n] = o[n][0];
        row[8 * n + 1] = o[n][1];
      }
    }
    if (tig == 0) {
      sML[(warp * G + grp) * 2] = m_run;
      sML[(warp * G + grp) * 2 + 1] = l_run;
    }
  }
  __syncthreads();

  // The block's state: thread tid merges dim tid of each 128-dim slice of
  // every head over the four warps.
  constexpr int kSlices = HD / 128;
  float acc[kSlices][G], Mg[G], Lg[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sML[(w * G + g) * 2]);
    float L = 0.f, A[kSlices] = {};
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c =
          M == -INFINITY ? 0.f : fast_exp2(sML[(w * G + g) * 2] - M);
      L += sML[(w * G + g) * 2 + 1] * c;
#pragma unroll
      for (int sl = 0; sl < kSlices; ++sl)
        A[sl] += sO[(w * G + g) * HD + 128 * sl + tid] * c;
    }
#pragma unroll
    for (int sl = 0; sl < kSlices; ++sl) acc[sl][g] = A[sl];
    Mg[g] = M;
    Lg[g] = L;
  }

  bf16* dst = out + ((size_t)b * H + kh * G) * HD + tid;
  if (S == 1) {
#pragma unroll
    for (int sl = 0; sl < kSlices; ++sl) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        dst[g * HD + 128 * sl] =
            __float2bfloat16(Lg[g] == 0.f ? 0.f : acc[sl][g] / Lg[g]);
      }
    }
    return;
  }

  // Workspace: acc [B*KH][S][G][HD], then (m, l) [B*KH][S][G][2].
  const size_t pair = (size_t)b * KH + kh;
  float* accs = ws + pair * S * G * HD;
  float* mls = ws + (size_t)gridDim.x * KH * S * G * HD + pair * S * G * 2;
#pragma unroll
  for (int sl = 0; sl < kSlices; ++sl) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      accs[((size_t)split * G + g) * HD + 128 * sl + tid] = acc[sl][g];
    }
  }
  if (tid == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      mls[(split * G + g) * 2] = Mg[g];
      mls[(split * G + g) * 2 + 1] = Lg[g];
    }
  }
  if (!last_split(counters + pair, S)) return;

  // The last block of (b, kh) merges the splits in split order: the
  // weights 2^(m_s - M) of every (split, head) first, then 4 dims of a head
  // a thread, 8 splits' loads in flight. The weights live in the ring,
  // which no copy uses any more.
  float (*sW)[G] = reinterpret_cast<float (*)[G]>(ring);
  float (*sWl)[G] = sW + kMaxSplits;
  for (int i = tid; i < S * G; i += kThreads) {
    sW[i / G][i % G] = __ldcg(mls + 2 * i);
    sWl[i / G][i % G] = __ldcg(mls + 2 * i + 1);
  }
  __syncthreads();
  if (tid < G) sL[tid] = merge_weights(&sW[0][tid], &sWl[0][tid], G, S);
  __syncthreads();
  for (int i = tid; i < G * HD / 4; i += kThreads) {
    const int g = i / (HD / 4), d4 = 4 * (i % (HD / 4));
    float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int s = 0; s < S; ++s) {
      const float4 a = __ldcg(reinterpret_cast<const float4*>(
          accs + ((size_t)s * G + g) * HD + d4));
      const float c = sW[s][g];
      A.x += a.x * c;
      A.y += a.y * c;
      A.z += a.z * c;
      A.w += a.w * c;
    }
    const float L = sL[g];
    const float inv = L == 0.f ? 0.f : 1.f / L;
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(
        out + ((size_t)b * H + kh * G + g) * HD + d4);
    o[0] = __floats2bfloat162_rn(A.x * inv, A.y * inv);
    o[1] = __floats2bfloat162_rn(A.z * inv, A.w * inv);
  }
  if (tid == 0) counters[pair] = 0;
}

template <int HD, int G, bool kWrite, bool kFp8>
cudaError_t launch(const void* q, void* cache, const void* k_new,
                   const void* v_new, const int* write_flat,
                   const int* tables, const int* kv_lens, void* out,
                   float* ws, int* counters, int B, int KH, int nb, int bs,
                   int W, int layer, int window, float scale, float softcap,
                   int splits, cudaStream_t stream) {
  using CT = std::conditional_t<kFp8, uint8_t, bf16>;
  constexpr int smem = Geo<HD, kFp8>::kSmem;
  static bool smem_set = false;  // idempotent: a race only repeats the call
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_split_kernel<HD, G, kWrite, kFp8>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  dim3 grid(B, KH, splits);
  decode_split_kernel<HD, G, kWrite, kFp8><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<CT*>(cache),
      static_cast<const bf16*>(k_new), static_cast<const bf16*>(v_new),
      write_flat, tables, kv_lens, static_cast<bf16*>(out), ws, counters, nb,
      bs, KH, W, layer, window, scale, softcap);
  return cudaGetLastError();
}

template <int HD, bool kWrite, bool kFp8>
int by_group(int G, const void* q, void* cache, const void* k_new,
             const void* v_new, const int* write_flat, const int* tables,
             const int* kv_lens, void* out, float* ws, int* counters, int B,
             int KH, int nb, int bs, int W, int layer, int window,
             float scale, float softcap, int splits, cudaStream_t s) {
#define PST_SPLIT(GG)                                                      \
  return (int)launch<HD, GG, kWrite, kFp8>(                               \
      q, cache, k_new, v_new, write_flat, tables, kv_lens, out, ws,        \
      counters, B, KH, nb, bs, W, layer, window, scale, softcap, splits, s)
  switch (G) {
    case 1: PST_SPLIT(1);
    case 2: PST_SPLIT(2);
    case 3: PST_SPLIT(3);
    case 4: PST_SPLIT(4);
    case 5: PST_SPLIT(5);
    case 6: PST_SPLIT(6);
    case 7: PST_SPLIT(7);
    case 8: PST_SPLIT(8);
    default: return (int)cudaErrorInvalidValue;
  }
#undef PST_SPLIT
}

// The launch at head dim HD: cache_dtype 1 = bfloat16, 2 = float8_e4m3fn
// (q is bf16). write_flat == nullptr: decode; else decode-write (k_new,
// v_new [B, KH*HD] bf16, cast into an e4m3 cache here). splits > 1 needs
// ws (B*KH*splits*G*(HD+2) floats) and counters (B*KH int32, zero; left
// zero). Returns a cudaError_t.
template <int HD>
int decode_split(int cache_dtype, const void* q, void* cache,
                 const void* k_new, const void* v_new, const int* write_flat,
                 const int* tables, const int* kv_lens, void* out, float* ws,
                 int* counters, int B, int H, int KH, int nb, int bs, int W,
                 int layer, int window, float scale, float softcap,
                 int splits, void* stream) {
  if (B == 0) return 0;
  if (KH <= 0 || H % KH || KH > 65535 || splits < 1 || splits > kMaxSplits ||
      (splits > 1 && (ws == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = H / KH;
#define PST_ARGS                                                          \
  G, q, cache, k_new, v_new, write_flat, tables, kv_lens, out, ws,        \
      counters, B, KH, nb, bs, W, layer, window, scale, softcap, splits, s
  const bool write = write_flat != nullptr;
  if (cache_dtype == 1) {
    return write ? by_group<HD, true, false>(PST_ARGS)
                 : by_group<HD, false, false>(PST_ARGS);
  }
  if (cache_dtype == 2) {
    return write ? by_group<HD, true, true>(PST_ARGS)
                 : by_group<HD, false, true>(PST_ARGS);
  }
#undef PST_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // namespace
