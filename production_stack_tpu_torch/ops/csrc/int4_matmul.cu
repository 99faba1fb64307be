// W4A16 matmul over packed int4 weights, hand-written for Hopper (sm_90a).
//
// Replaces production_stack_tpu/ops/int4_matmul.py::_kernel, the Pallas TPU
// kernel behind the JAX package's int4_matmul:
//
//   out[N, dout] (fp32) = x[N, din] @ W,   W[k, n] = q[k, n] * scales[k / G, n]
//
// Layouts (identical to the JAX package's quantize_leaf_int4):
//   x        [N, din]       bf16 or fp32
//   packed   [din/2, dout]  int8; packed row i holds q[2i] in its low nibble
//                           and q[2i+1] in its high nibble, both signed
//   scales   [din/G, dout]  fp32
//
// The TPU kernel pre-split x into even and odd columns and ran two MXU dots
// a tile. Hopper needs none of that: with the product transposed, outᵀ =
// Wᵀ xᵀ, a register of the tensor cores' A fragment holds the k-pair (2i,
// 2i+1) of one output column, which is exactly one packed byte. The
// weights are read from device memory once, 0.5 byte per weight, and are
// never written back dequantized.
//
// Three routes; the wrapper picks one per call (int4_matmul.py::route), and
// every shape the quantizer makes is taken:
//   int4_wgmma_kernel    bf16 x, G % 16 == 0, more rows than decode takes,
//                        dout % 16 == 0 (every real checkpoint's prefill).
//                        wgmma with the weights as the register A operand;
//                        see its note below.
//   int4_decode_kernel   bf16 x, G % 16 == 0, otherwise (decode rows; odd
//                        dout; unaligned operands): int4_decode.cu.
//   int4_simt_kernel     fp32 x (exact fp32: no weight or partial sum is
//                        rounded to bf16), and bf16 x with a group size below
//                        16 (tiny debug models). CUDA cores; see its note.
// Both bf16 routes multiply what the TPU kernel multiplies: the levels
// times the scale, rounded to bf16 (int4_bits.cuh). Ragged N and dout are
// masked. A split of the contraction (din) on group boundaries gives the
// card enough blocks where the output tiles alone do not. wgmma's partial
// sums go to a workspace that a second pass (splitk_sum_kernel) adds in a
// fixed order; the CUDA-core route's splits add up in the launch, in a
// fixed order too. No float atomics: the result is deterministic.
//
// What bounds it on an NVIDIA H100 80GB HBM3 at its 700 W limit (data
// sheet: 3.35 TB/s, 989 TFLOP/s bf16 dense): at prefill (N = 512, din
// 4096, dout 14336), operations: 60.1 GFLOP, 61 us. PERF.md has the wgmma
// route's measured time.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "int4_bits.cuh"
#include "sm90.cuh"

namespace {

using pst_int4::weights_bits;

// ---------------------------------------------------------------------------
// CUDA-core route (fp32 x, or bf16 x with G < 16): grid (column tiles, row
// tiles of 8, splits), 128 threads. What bounds it on an NVIDIA H100 80GB
// HBM3 at 700 W: at the shapes it serves (the tiny debug engines, e.g. N 8,
// din 128, dout 256) the latency of one launch; at a Llama projection in
// fp32 (N 8, 4096 x 14336) the fp32 products (0.94 GFLOP, 14 us at 67
// TFLOP/s) before the bytes (29.4 MB of packed weights, 8.8 us).
//
// Design (redesigned for Hopper; the first form gave a thread one output
// column and walked the block's whole contraction one byte a step, so a
// one-group projection ran 2 blocks on 2 of 132 SMs):
//   - A thread owns 4 adjacent columns: one 32-bit load of a packed row
//     gives their k-pair (2p, 2p + 1). The cols / 4 threads of a column
//     tile share each row; the block's other threads ("k-lanes", 128 /
//     (cols / 4) of them) take other parts of the contraction. The
//     wrapper picks cols from 8 to 128 (int4_matmul.py::plan), as narrow
//     as gives the card its blocks: the tiny engine's w_gate gets 32.
//   - The contraction is cut into units: each group of G / 2 packed rows
//     into `kslices` equal runs. k-lane l takes units l, l + lanes, ...;
//     in a unit it sums x q in fp32, kSimtBatch packed rows loaded ahead
//     of use (a fixed, unrolled count), then adds scale * sum, as the
//     first form did: no weight or partial sum is rounded to bf16.
//   - Nibbles become floats exactly without a conversion instruction:
//     2^23 + (n ^ 8) - (2^23 + 8).
//   - The k-lanes' sums meet in shared memory and add in lane order. Where
//     the output tiles alone leave SMs idle, up to 8 blocks split a tile's
//     groups; they are one thread block cluster and block 0 adds their
//     sums in split order through distributed shared memory: one launch,
//     no workspace, and two launches give the same bits.
// ---------------------------------------------------------------------------

constexpr int kSimtThreads = 128;
constexpr int kSimtRows = 8;    // rows of x per block
constexpr int kSimtBatch = 4;   // packed rows a thread loads ahead of use
constexpr int kSimtMaxCols = 128;
constexpr int kSimtMaxSplits = 8;  // a tile's blocks: one portable cluster
// The k-lanes' sums: (128 / (cols / 4)) lanes x 8 rows x cols floats.
constexpr int kSimtRed = 4 * kSimtThreads * kSimtRows;

// Signed nibble i (0..7) of w, exactly, as a float.
__device__ __forceinline__ float nib_f(uint32_t w, int i) {
  return __uint_as_float(((w >> (4 * i)) & 0xfu) ^ 0x4b000008u) - 8388616.f;
}

// x[k], x[k + 1] as floats (k even).
__device__ __forceinline__ float2 load_x2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_x2(const __nv_bfloat16* p) {
  const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

// kVec: dout % 4 == 0 and 4-byte aligned packed rows, so a thread's 4
// columns are one 32-bit load; else 4 byte loads, masked at dout.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kSimtThreads)
int4_simt_kernel(const T* __restrict__ x, const int8_t* __restrict__ packed,
                 const float* __restrict__ scales, float* __restrict__ out,
                 int N, int din, int dout, int G, int cols, int kslices,
                 int per_split) {
  __shared__ __align__(16) float red[kSimtRed];
  __shared__ __align__(16) float part[kSimtRows * kSimtMaxCols];
  const int tid = threadIdx.x;
  const int ctn = cols / 4;                // column threads
  const int lanes = kSimtThreads / ctn;    // k-lanes
  const int ct = tid % ctn, kl = tid / ctn;
  const int n0 = blockIdx.x * cols + 4 * ct;  // the thread's first column
  const int r0 = blockIdx.y * kSimtRows;
  const int rows = min(kSimtRows, N - r0);
  const int groups = din / G, gp = G / 2, ru = gp / kslices;
  const int g_lo = blockIdx.z * per_split;
  const int units = (min(g_lo + per_split, groups) - g_lo) * kslices;

  auto load_w = [&](int p) -> uint32_t {  // packed row p, the 4 columns
    const int8_t* src = packed + (size_t)p * dout + n0;
    if constexpr (kVec) {
      return n0 < dout ? __ldg(reinterpret_cast<const unsigned*>(src)) : 0u;
    } else {
      uint32_t w = 0u;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (n0 + c < dout) w |= (uint32_t)(uint8_t)__ldg(src + c) << (8 * c);
      return w;
    }
  };

  float acc[kSimtRows][4];
#pragma unroll
  for (int r = 0; r < kSimtRows; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  for (int u = kl; u < units; u += lanes) {
    const int g = g_lo + u / kslices;
    const int p0 = g * gp + (u % kslices) * ru;
    float sum[kSimtRows][4];
#pragma unroll
    for (int r = 0; r < kSimtRows; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) sum[r][c] = 0.f;
    for (int i0 = 0; i0 < ru; i0 += kSimtBatch) {
      uint32_t wv[kSimtBatch];
#pragma unroll
      for (int i = 0; i < kSimtBatch; ++i)
        wv[i] = i0 + i < ru ? load_w(p0 + i0 + i) : 0u;
#pragma unroll
      for (int i = 0; i < kSimtBatch; ++i) {
        if (i0 + i < ru) {
          const int k = 2 * (p0 + i0 + i);
          float lo[4], hi[4];  // levels of k and k + 1, by column
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            lo[c] = nib_f(wv[i], 2 * c);
            hi[c] = nib_f(wv[i], 2 * c + 1);
          }
#pragma unroll
          for (int r = 0; r < kSimtRows; ++r) {
            if (r < rows) {
              const float2 xv = load_x2(x + (size_t)(r0 + r) * din + k);
#pragma unroll
              for (int c = 0; c < 4; ++c)
                sum[r][c] = fmaf(xv.y, hi[c], fmaf(xv.x, lo[c], sum[r][c]));
            }
          }
        }
      }
    }
    float s[4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      s[c] = n0 + c < dout ? __ldg(scales + (size_t)g * dout + n0 + c) : 0.f;
#pragma unroll
    for (int r = 0; r < kSimtRows; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(s[c], sum[r][c], acc[r][c]);
  }

  // The k-lanes' sums, added in lane order: element e = r * cols + column.
#pragma unroll
  for (int r = 0; r < kSimtRows; ++r)
    *reinterpret_cast<float4*>(red + (kl * kSimtRows + r) * cols + 4 * ct) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  __syncthreads();
  const int S = gridDim.z;
  auto store = [&](int e, float v) {
    const int r = e / cols, n = blockIdx.x * cols + e % cols;
    if (r < rows && n < dout) out[(size_t)(r0 + r) * dout + n] = v;
  };
  for (int e = tid; e < kSimtRows * cols; e += kSimtThreads) {
    float v = red[e];
    for (int l = 1; l < lanes; ++l) v += red[l * kSimtRows * cols + e];
    if (S == 1) {
      store(e, v);
    } else {
      part[e] = v;
    }
  }
  if (S == 1) return;
  // The tile's S blocks are one cluster: block 0 adds their sums in split
  // order once every block's are in its shared memory, and the others wait
  // for it before they exit (their shared memory must outlive its reads).
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (blockIdx.z == 0) {
    for (int e = tid; e < kSimtRows * cols; e += kSimtThreads) {
      float v = part[e];
      for (int z = 1; z < S; ++z) v += *cluster.map_shared_rank(part + e, z);
      store(e, v);
    }
  }
  cluster.sync();
}

template <typename T, bool kVec>
cudaError_t launch_simt(dim3 grid, const void* x, const int8_t* pk,
                        const float* sc, float* out, int N, int din, int dout,
                        int G, int cols, int kslices, int per_split,
                        cudaStream_t s) {
  auto* k = int4_simt_kernel<T, kVec>;
  const T* xt = static_cast<const T*>(x);
  if (grid.z == 1) {
    k<<<grid, kSimtThreads, 0, s>>>(xt, pk, sc, out, N, din, dout, G, cols,
                                    kslices, per_split);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kSimtThreads);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = grid.z;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, k, xt, pk, sc, out, N, din, dout, G, cols,
                            kslices, per_split);
}

// ---------------------------------------------------------------------------
// wgmma route (bf16 x, more rows than the decode route takes, dout % 16 ==
// 0, G % 16 == 0 dividing or a multiple of 128): grid (ceil(N/128),
// ceil(dout/256), splits), 512 threads = four warpgroups.
//
// The product is computed transposed, outᵀ = Wᵀ xᵀ: the weights are the
// register A operand of wgmma m64n128k16 (M = output columns, K = din), the
// activations the shared-memory B operand (a K-major [128 rows of x, 64]
// bf16 tile, 128-byte swizzled). A block owns 128 rows of x and 256 output
// columns; warpgroup w owns columns [64w, 64w + 64) as one M tile, and all
// four read the same x tile.
//
// Fragments. A register of the A fragment holds the k-pair (2i, 2i+1) of
// one fragment row: one packed byte. A thread holds fragment rows r and
// r + 8. Which output column a fragment row stands for is the kernel's
// choice, and `colmap` (built by the wrapper, int4_matmul.py::
// fragment_columns) gives it: thread t of a warpgroup holds the columns
// colmap[2t], colmap[2t + 1] for rows r and r + 8. The two are adjacent, so
// one 16-bit load of a staged packed row fills two A registers, and the
// epilogue writes them as one float2.
//
// Dequantizing without conversions (int4_bits.cuh::weights_bits): prmt and
// one lop3 make each half of a register the bf16 136 + q, a bf16x2
// subtract leaves q, and a bf16x2 multiply by the group's scale, rounded to
// bf16 first, gives the weight the TPU kernel feeds its MXU bit for bit. So
// one fp32 accumulator takes every k-step and no product is waited for at
// a group's end. (Scaling each group's integer product in fp32 afterwards
// needs a second accumulator and a wait on the tensor cores at every
// group's end; PERF.md, PR 3, has the times of the version that did.)
//
// Pipeline: a 3-slot cp.async ring of 128-row chunks (x 32 KB; packed 64
// rows x 256 bytes, rows padded to 288 so that the fragment loads of a
// warp hit distinct banks; the chunk's group scales), zero-filled past N,
// dout and the split's end (a zero byte is level 0, a zero scale weight
// 0), loaded one chunk ahead. mbarriers, not block barriers, hand the
// slots over: a slot is full once every thread's copies into it have
// landed (cp.async.mbarrier.arrive), and empty once every warp's products
// that read it are done. So the warpgroups do not meet at every chunk, and
// each builds its next A fragments while the others' products run. (On an
// NVIDIA H100 80GB HBM3 at 700 W, making them take turns at the tensor
// cores with named barriers was slower.) Within a warpgroup a chunk's
// products are waited for before the next chunk's fragments are built:
// building them under products in flight makes ptxas serialize the
// wgmmas.
//
// Sharing: blockIdx.x (the 128-row tile of x) runs fastest, so the
// ceil(N/128) blocks of one column block run side by side: the first reads
// the 256-column weight tile from device memory and the others re-read it
// from L2, (ceil(N/128) - 1) / ceil(N/128) of its reads (3/4 at N = 512).
// Each x tile is read once per column block: dout / 256 times.
// ---------------------------------------------------------------------------

constexpr int kWgWarpgroups = 4;
constexpr int kWgThreads = 128 * kWgWarpgroups;
constexpr int kWgRows = 128;         // rows of x per block (the wgmma N)
constexpr int kWgCols = 64 * kWgWarpgroups;  // output columns per block
constexpr int kWgChunk = 128;        // contraction rows per stage
constexpr int kWgSteps = kWgChunk / 16;  // k-steps a chunk
constexpr int kWgStages = 3;         // ring slots
constexpr int kWgAhead = 1;          // chunks loaded ahead of the current
constexpr int kWgPRow = kWgCols + 32;  // bytes a staged packed row
constexpr int kWgXHalf = kWgRows * 128;                 // 64 k of x
constexpr int kWgXBytes = 2 * kWgXHalf;
constexpr int kWgPBytes = (kWgChunk / 2) * kWgPRow;
constexpr int kWgSBytes = kWgSteps * kWgCols * 4;  // up to a group a k-step
constexpr int kWgStageBytes = kWgXBytes + kWgPBytes + kWgSBytes;
constexpr int kWgSmem = kWgStages * kWgStageBytes + 1024;
constexpr int kWgAcc = kWgRows / 2;  // accumulator registers a thread
static_assert(kWgStageBytes % 1024 == 0, "x tiles sit on swizzle atoms");

// kSteps: k-steps of 16 per scale group within a chunk, min(G, 128) / 16.
template <int kSteps>
__global__ void __launch_bounds__(kWgThreads, 1)
int4_wgmma_kernel(const __nv_bfloat16* __restrict__ x,
                  const int8_t* __restrict__ packed,
                  const float* __restrict__ scales, float* __restrict__ out,
                  const int* __restrict__ colmap, int N, int din, int dout,
                  int G, int per_split) {
  using namespace pst_sm90;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const uint32_t sbase = smem_u32(smem);

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int quad = tid & 3;
  const int m0 = blockIdx.x * kWgRows;
  const int n0 = blockIdx.y * kWgCols;
  const int groups = din / G;
  const int g_lo = blockIdx.z * per_split;
  const int g_hi = min(g_lo + per_split, groups);
  const int k_lo = g_lo * G, k_hi = g_hi * G;
  const int n_chunks = k_hi > k_lo ? (k_hi - k_lo + kWgChunk - 1) / kWgChunk : 0;
  // Block column of this thread's fragment row r; row r + 8 is the next
  // one (fragment_columns keeps them adjacent).
  const int col0 = 64 * wg + colmap[2 * (tid % 128)];

  // Chunk kc into ring slot `slot`: x rows p / 16, 16-byte chunk p % 16
  // (two 64-k halves); packed rows p / (kWgCols / 16), chunk p % (kWgCols /
  // 16) of the block's columns; scale row p / (kWgCols / 4) (group k0 / G +
  // that row), 4 columns p % (kWgCols / 4); for p = tid + kWgThreads * j.
  auto load_chunk = [&](int kc, int slot) {
    const int k0 = k_lo + kc * kWgChunk;
    const uint32_t sx = sbase + slot * kWgStageBytes;
    const uint32_t sp = sx + kWgXBytes;
    const uint32_t ss = sp + kWgPBytes;
#pragma unroll
    for (int j = 0; j < kWgRows * 16 / kWgThreads; ++j) {
      const int p = tid + kWgThreads * j;
      const int row = p / 16, ch = p % 16;
      const int k = k0 + 8 * ch;
      const bool ok = m0 + row < N && k < k_hi;
      cp_async16(sx + (ch / 8) * kWgXHalf + sw128(row, ch % 8),
                 ok ? x + (size_t)(m0 + row) * din + k : x, ok);
    }
#pragma unroll
    for (int j = 0; j < (kWgChunk / 2) * (kWgCols / 16) / kWgThreads; ++j) {
      const int p = tid + kWgThreads * j;
      const int pr = p / (kWgCols / 16), ch = p % (kWgCols / 16);
      const int kp = k0 / 2 + pr;
      const int n = n0 + 16 * ch;
      const bool ok = 2 * kp < k_hi && n < dout;
      cp_async16(sp + pr * kWgPRow + 16 * ch,
                 ok ? packed + (size_t)kp * dout + n : packed, ok);
    }
    // Scale rows: one per group the chunk spans.
    constexpr int kScalePieces = (kWgSteps / kSteps) * (kWgCols / 4);
#pragma unroll
    for (int j = 0; j < (kScalePieces + kWgThreads - 1) / kWgThreads; ++j) {
      const int p = tid + kWgThreads * j;
      if (p >= kScalePieces) break;
      const int r = p / (kWgCols / 4), ch = p % (kWgCols / 4);
      const int g = k0 / G + r;
      const int n = n0 + 4 * ch;
      const bool ok = g < g_hi && n < dout;
      cp_async16(ss + r * (kWgCols * 4) + 16 * ch,
                 ok ? scales + (size_t)g * dout + n : scales, ok);
    }
  };

  // Ring slot s is full when every thread's copies into it have landed,
  // and empty again when every warp's reads of it are done.
  __shared__ __align__(8) uint64_t bars[2 * kWgStages];
  const uint32_t full0 = smem_u32(bars);
  const uint32_t empty0 = full0 + 8 * kWgStages;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(full0 + 8 * s, kWgThreads);
      mbar_init(empty0 + 8 * s, kWgThreads / 32);
    }
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < kWgAhead; ++s) {
    if (s < n_chunks) {
      load_chunk(s, s);
      cp_async_mbar_arrive(full0 + 8 * s);
    }
  }

  float acc[kWgAcc];
#pragma unroll
  for (int i = 0; i < kWgAcc; ++i) acc[i] = 0.f;
  uint32_t a[kWgSteps][4];

  for (int kc = 0; kc < n_chunks; ++kc) {
    const int nx = kc + kWgAhead;  // refill the slot of chunk nx - kWgStages
    if (nx < n_chunks) {
      const int ns = nx % kWgStages;
      if (nx >= kWgStages) mbar_wait(empty0 + 8 * ns, (nx / kWgStages - 1) & 1);
      load_chunk(nx, ns);
      cp_async_mbar_arrive(full0 + 8 * ns);
    }
    const int slot = kc % kWgStages;
    mbar_wait(full0 + 8 * slot, (kc / kWgStages) & 1);
    fence_proxy_async();  // the landed x tile, to wgmma's async proxy
    const uint32_t sx = sbase + slot * kWgStageBytes;
    const uint8_t* sp = smem + slot * kWgStageBytes + kWgXBytes + col0;
    const float* ss = reinterpret_cast<const float*>(
                          smem + slot * kWgStageBytes + kWgXBytes + kWgPBytes) +
                      col0;
    // Packed rows 8ks + quad (k-pair 2quad, +1) and 8ks + 4 + quad (k-pair
    // 8 + 2quad, +1) of the chunk; byte 0 is row r, byte 1 row r + 8.
    __nv_bfloat162 s_r, s_r8;
#pragma unroll
    for (int ks = 0; ks < kWgSteps; ++ks) {
      if (ks % kSteps == 0) {  // the group's scales of columns col0, col0 + 1
        const float2 sc =
            *reinterpret_cast<const float2*>(ss + (ks / kSteps) * kWgCols);
        s_r = __float2bfloat162_rn(sc.x);
        s_r8 = __float2bfloat162_rn(sc.y);
      }
      const uint32_t w0 = *reinterpret_cast<const uint16_t*>(
          sp + (8 * ks + quad) * kWgPRow);
      const uint32_t w1 = *reinterpret_cast<const uint16_t*>(
          sp + (8 * ks + 4 + quad) * kWgPRow);
      a[ks][0] = weights_bits(w0, w0 >> 4, 0, s_r);
      a[ks][1] = weights_bits(w0, w0 >> 4, 1, s_r8);
      a[ks][2] = weights_bits(w1, w1 >> 4, 0, s_r);
      a[ks][3] = weights_bits(w1, w1 >> 4, 1, s_r8);
    }
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kWgSteps; ++ks) {
      const uint64_t db =
          desc_sw128(sx + (ks / 4) * kWgXHalf + (ks % 4) * 32, 16, 1024);
      wgmma_m64n128k16_rs<0>(acc, a[ks], db, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    if ((tid & 31) == 0) mbar_arrive(empty0 + 8 * slot);
  }
  fence_regs(acc);

  // Register i: x row 8 * (i / 4) + 2 * quad + i % 2, column col0 +
  // (i / 2) % 2.
  float* dst = out + (size_t)blockIdx.z * N * dout;
  const int col = n0 + col0;
#pragma unroll
  for (int jn = 0; jn < kWgAcc / 4; ++jn) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = m0 + 8 * jn + 2 * quad + e;
      if (row >= N) continue;
      float* o = dst + (size_t)row * dout + col;
      if (col + 1 < dout) {
        *reinterpret_cast<float2*>(o) =
            make_float2(acc[4 * jn + e], acc[4 * jn + 2 + e]);
      } else if (col < dout) {
        o[0] = acc[4 * jn + e];
      }
    }
  }
}

// Second pass of a split contraction: out = sum over splits, in order.
__global__ void splitk_sum_kernel(const float* __restrict__ ws,
                                  float* __restrict__ out, size_t count,
                                  int splits) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < count;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += ws[(size_t)z * count + i];
    out[i] = s;
  }
}

template <int kSteps>
cudaError_t launch_wgmma(dim3 grid, const __nv_bfloat16* x, const int8_t* pk,
                         const float* sc, float* dst, const int* colmap, int N,
                         int din, int dout, int G, int per_split,
                         cudaStream_t s) {
  static bool smem_set = false;  // idempotent: a race only repeats the call
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        int4_wgmma_kernel<kSteps>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kWgSmem);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  int4_wgmma_kernel<kSteps><<<grid, kWgThreads, kWgSmem, s>>>(
      x, pk, sc, dst, colmap, N, din, dout, G, per_split);
  return cudaSuccess;
}

}  // namespace

// int4_wgmma_kernel (bf16 x; the wrapper's route "wgmma",
// int4_matmul.py::route). grid_x, grid_y and the splits are the wrapper's
// plan (int4_matmul.py::plan); colmap is fragment_columns() on the device.
// ws is [splits, N, dout] fp32 (the output itself when splits == 1); split
// z covers the groups [z * per_split, (z + 1) * per_split), and a second
// pass (splitk_sum_kernel) adds the splits in order. Returns a cudaError_t
// (0 = success).
extern "C" int pst_int4_matmul(const void* x, const void* packed,
                               const void* scales, const int* colmap,
                               void* out, void* ws, int N, int din, int dout,
                               int G, int grid_x, int grid_y, int splits,
                               int per_split, void* stream) {
  if (N <= 0 || dout <= 0) return 0;
  if (din <= 0 || G <= 0 || G % 16 || din % G || splits < 1 ||
      per_split < 1 || (long long)splits * per_split < din / G ||
      grid_x < 1 || grid_y < 1 || grid_y > 65535 || splits > 65535)
    return (int)cudaErrorInvalidValue;
  // G divides or is a multiple of the 128-row chunk, so a group's share of
  // every chunk is whole k-steps and the same size.
  if (!(kWgChunk % G == 0 || G % kWgChunk == 0) || dout % 16 || din % 8 ||
      colmap == nullptr || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(packed) % 16 ||
      reinterpret_cast<uintptr_t>(scales) % 16 ||
      (long long)grid_x * kWgRows < N || (long long)grid_y * kWgCols < dout)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dst = static_cast<float*>(splits > 1 ? ws : out);
  const int8_t* pk = static_cast<const int8_t*>(packed);
  const float* sc = static_cast<const float*>(scales);
  const dim3 grid(grid_x, grid_y, splits);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  // A group's share of a 128-row chunk, in k-steps of 16.
  const int steps = G < kWgChunk ? G / 16 : kWgChunk / 16;
  cudaError_t e = cudaErrorInvalidValue;
  switch (steps) {
    case 1: e = launch_wgmma<1>(grid, xb, pk, sc, dst, colmap, N, din, dout, G, per_split, s); break;
    case 2: e = launch_wgmma<2>(grid, xb, pk, sc, dst, colmap, N, din, dout, G, per_split, s); break;
    case 4: e = launch_wgmma<4>(grid, xb, pk, sc, dst, colmap, N, din, dout, G, per_split, s); break;
    case 8: e = launch_wgmma<8>(grid, xb, pk, sc, dst, colmap, N, din, dout, G, per_split, s); break;
    default: break;
  }
  if (e == cudaSuccess) e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  const size_t count = (size_t)N * dout;
  const size_t want = (count + 255) / 256;
  const int blocks = want < 4096 ? (int)want : 4096;
  splitk_sum_kernel<<<blocks, 256, 0, s>>>(static_cast<const float*>(ws),
                                           static_cast<float*>(out), count,
                                           splits);
  return (int)cudaGetLastError();
}

// int4_simt_kernel (the wrapper's route "simt": fp32 x, or bf16 x with G <
// 16); dtype: 0 = float32, 1 = bfloat16 (of x). cols (8 to 128, a power of
// two: output columns a block), kslices (runs of each group, dividing G /
// 2), the grid and the splits (at most 8, one cluster a tile) are the
// wrapper's plan (int4_matmul.py::plan): grid_x column tiles, grid_y row
// tiles of 8, split z covers the groups [z * per_split, (z + 1) *
// per_split). One launch, no workspace. Returns a cudaError_t.
extern "C" int pst_int4_simt(int dtype, const void* x, const void* packed,
                             const void* scales, void* out, int N, int din,
                             int dout, int G, int cols, int kslices,
                             int grid_x, int grid_y, int splits,
                             int per_split, void* stream) {
  if (N <= 0 || dout <= 0) return 0;
  const int groups = G > 0 ? din / G : 0;
  if (din <= 0 || G <= 0 || G % 2 || din % G || cols < 4 ||
      cols > kSimtMaxCols || (cols & (cols - 1)) || kslices < 1 ||
      (G / 2) % kslices || per_split < 1 || splits < 1 ||
      splits > kSimtMaxSplits || (long long)splits * per_split < groups ||
      (long long)(splits - 1) * per_split >= groups || grid_x < 1 ||
      grid_y < 1 || grid_y > 65535 || (long long)grid_x * cols < dout ||
      (long long)grid_y * kSimtRows < N)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(grid_x, grid_y, splits);
  const int8_t* pk = static_cast<const int8_t*>(packed);
  const float* sc = static_cast<const float*>(scales);
  float* o = static_cast<float*>(out);
  const bool vec = dout % 4 == 0 && reinterpret_cast<uintptr_t>(packed) % 4 == 0;
  if (dtype == 0) {
    if (reinterpret_cast<uintptr_t>(x) % 8) return (int)cudaErrorInvalidValue;
    return (int)(vec ? launch_simt<float, true>(grid, x, pk, sc, o, N, din, dout, G, cols, kslices, per_split, s)
                     : launch_simt<float, false>(grid, x, pk, sc, o, N, din, dout, G, cols, kslices, per_split, s));
  }
  if (dtype == 1) {
    if (reinterpret_cast<uintptr_t>(x) % 4) return (int)cudaErrorInvalidValue;
    return (int)(vec ? launch_simt<__nv_bfloat16, true>(grid, x, pk, sc, o, N, din, dout, G, cols, kslices, per_split, s)
                     : launch_simt<__nv_bfloat16, false>(grid, x, pk, sc, o, N, din, dout, G, cols, kslices, per_split, s));
  }
  return (int)cudaErrorInvalidValue;
}
