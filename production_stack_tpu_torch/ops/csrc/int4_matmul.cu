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
//                        16 (tiny debug models). CUDA cores.
// Both bf16 routes multiply what the TPU kernel multiplies: the levels
// times the scale, rounded to bf16 (int4_bits.cuh). Ragged N and dout are
// masked. Here a split of the contraction (din) on group boundaries gives
// the card enough blocks where the output tiles alone do not; the partial
// sums go to a workspace that a second pass (splitk_sum_kernel) adds in a
// fixed order, so the result is deterministic (no float atomics).
//
// What bounds it on an NVIDIA H100 80GB HBM3 at its 700 W limit (data
// sheet: 3.35 TB/s, 989 TFLOP/s bf16 dense): at prefill (N = 512, din
// 4096, dout 14336), operations: 60.1 GFLOP, 61 us. PERF.md has the wgmma
// route's measured time.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "int4_bits.cuh"
#include "sm90.cuh"

namespace {

using pst_int4::weights_bits;

constexpr int kThreads = 128;  // CUDA-core route: a thread an output column
constexpr int kCols = 128;     // output columns per block
constexpr int kChunk = 64;     // contraction rows staged per step
constexpr int kSimtRows = 8;   // rows of x per block

// Signed nibbles of a packed byte b (b sign-extended from int8). The cast
// back to int8_t matters: b << 4 is an int, and without it the low nibble
// would not be sign-extended.
__device__ __forceinline__ int nib_lo(int b) { return (int)(int8_t)(b << 4) >> 4; }
__device__ __forceinline__ int nib_hi(int b) { return b >> 4; }

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// ---------------------------------------------------------------------------
// CUDA-core route: grid (ceil(dout/128), ceil(N/8), splits), 128 threads.
// Thread t owns output column n0 + t for the block's 8 rows; x is staged in
// shared memory and read as a broadcast, each packed byte is read once
// (consecutive threads read consecutive bytes). Products and sums in fp32.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
int4_simt_kernel(const T* __restrict__ x, const int8_t* __restrict__ packed,
                 const float* __restrict__ scales, float* __restrict__ out,
                 int N, int din, int dout, int G, int per_split) {
  __shared__ float sx[kSimtRows][kChunk];
  const int n = blockIdx.x * kCols + threadIdx.x;
  const int r0 = blockIdx.y * kSimtRows;
  const int groups = din / G;
  const int g_lo = blockIdx.z * per_split;
  const int g_hi = min(g_lo + per_split, groups);
  const int k_lo = g_lo * G, k_hi = g_hi * G;

  float acc[kSimtRows], part[kSimtRows];
#pragma unroll
  for (int r = 0; r < kSimtRows; ++r) acc[r] = part[r] = 0.f;

  for (int k0 = k_lo; k0 < k_hi; k0 += kChunk) {
    __syncthreads();
    for (int i = threadIdx.x; i < kSimtRows * kChunk; i += kThreads) {
      const int r = i / kChunk, kk = i % kChunk;
      const int row = r0 + r, k = k0 + kk;
      sx[r][kk] = row < N && k < k_hi ? to_float(x[(size_t)row * din + k]) : 0.f;
    }
    __syncthreads();
    if (n >= dout) continue;
    const int kend = min(kChunk, k_hi - k0);  // even: G is even
    for (int kk = 0; kk < kend; kk += 2) {
      const int k = k0 + kk;
      const int b = packed[(size_t)(k >> 1) * dout + n];
      const float lo = (float)nib_lo(b), hi = (float)nib_hi(b);
#pragma unroll
      for (int r = 0; r < kSimtRows; ++r)
        part[r] = fmaf(sx[r][kk + 1], hi, fmaf(sx[r][kk], lo, part[r]));
      if ((k + 2) % G == 0) {  // end of a group
        const float s = scales[(size_t)(k / G) * dout + n];
#pragma unroll
        for (int r = 0; r < kSimtRows; ++r) {
          acc[r] = fmaf(s, part[r], acc[r]);
          part[r] = 0.f;
        }
      }
    }
  }
  if (n >= dout) return;
  float* dst = out + (size_t)blockIdx.z * N * dout;
#pragma unroll
  for (int r = 0; r < kSimtRows; ++r)
    if (r0 + r < N) dst[(size_t)(r0 + r) * dout + n] = acc[r];
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

// route: 0 = int4_simt_kernel, 2 = int4_wgmma_kernel, chosen by the
// wrapper (int4_matmul.py::route; its decode route is pst_int4_decode in
// int4_decode.cu); dtype: 0 = float32, 1 = bfloat16 (of x). grid_x, grid_y and the splits are the wrapper's plan
// (int4_matmul.py::plan); colmap is fragment_columns() on the device
// (route 2 only). ws is [splits, N, dout] fp32 (the output itself when
// splits == 1); split z covers the groups [z * per_split, (z + 1) *
// per_split). Returns a cudaError_t (0 = success).
extern "C" int pst_int4_matmul(int route, int dtype, const void* x,
                               const void* packed, const void* scales,
                               const int* colmap, void* out, void* ws, int N,
                               int din, int dout, int G, int grid_x,
                               int grid_y, int splits, int per_split,
                               void* stream) {
  if (N <= 0 || dout <= 0) return 0;
  if (din <= 0 || G <= 0 || G % 2 || din % G || splits < 1 ||
      per_split < 1 || (long long)splits * per_split < din / G ||
      grid_x < 1 || grid_y < 1 || grid_y > 65535 || splits > 65535)
    return (int)cudaErrorInvalidValue;
  const bool tc = dtype == 1 && G % 16 == 0;  // the tensor cores take it
  const auto covers = [&](int rows, int cols, bool by_rows) {
    return by_rows ? (long long)grid_x * rows >= N && (long long)grid_y * cols >= dout
                   : (long long)grid_x * cols >= dout && (long long)grid_y * rows >= N;
  };
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dst = static_cast<float*>(splits > 1 ? ws : out);
  const int8_t* pk = static_cast<const int8_t*>(packed);
  const float* sc = static_cast<const float*>(scales);
  const dim3 grid(grid_x, grid_y, splits);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  if (route == 2) {
    // G divides or is a multiple of the 128-row chunk, so a group's share
    // of every chunk is whole k-steps and the same size.
    if (!tc || !(kWgChunk % G == 0 || G % kWgChunk == 0) || dout % 16 ||
        din % 8 || colmap == nullptr ||
        reinterpret_cast<uintptr_t>(x) % 16 ||
        reinterpret_cast<uintptr_t>(packed) % 16 ||
        reinterpret_cast<uintptr_t>(scales) % 16 ||
        !covers(kWgRows, kWgCols, true))
      return (int)cudaErrorInvalidValue;
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
    if (e != cudaSuccess) return (int)e;
  } else if (route == 0) {
    if (!covers(kSimtRows, kCols, false)) return (int)cudaErrorInvalidValue;
    if (dtype == 0) {
      int4_simt_kernel<float><<<grid, kThreads, 0, s>>>(
          static_cast<const float*>(x), pk, sc, dst, N, din, dout, G, per_split);
    } else if (dtype == 1) {
      int4_simt_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x), pk, sc, dst, N, din, dout, G,
          per_split);
    } else {
      return (int)cudaErrorInvalidValue;
    }
  } else {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  const size_t count = (size_t)N * dout;
  const size_t want = (count + 255) / 256;
  const int blocks = want < 4096 ? (int)want : 4096;
  splitk_sum_kernel<<<blocks, 256, 0, s>>>(static_cast<const float*>(ws),
                                           static_cast<float*>(out), count,
                                           splits);
  return (int)cudaGetLastError();
}
