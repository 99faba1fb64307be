// W4A16 matmul at decode rows, hand-written for Hopper (sm_90a).
//
// Replaces production_stack_tpu/ops/int4_matmul.py::_kernel, the Pallas TPU
// kernel behind the JAX package's int4_matmul, for bf16 x with a group size
// G % 16 == 0 wherever the wgmma route (int4_matmul.cu) is not taken: decode
// rows, and the shapes wgmma refuses at any N (dout % 16 != 0, a group size
// that neither divides nor is a multiple of its 128-row chunk, unaligned
// operands). It computes what the TPU kernel computes:
//
//   out[N, dout] (fp32) = x[N, din] (bf16) @ W,
//   W[k, n] = bf16(bf16(q[k, n]) * bf16(scales[k / G, n]))
//
// Layouts are the JAX package's quantize_leaf_int4 (int4_matmul.cu has them).
//
// What bounds it on an NVIDIA H100 80GB HBM3 at 700 W (data sheet: 3.35
// TB/s, 989 TFLOP/s bf16 dense): bytes. At N = 8, din 4096, dout 14336 the
// packed weights (29.4 MB) and scales (1.8 MB) take 9.5 us; the products,
// 0.94 GFLOP, 1 us. What the design does about it:
//
// - Swapped operands: outᵀ = Wᵀ xᵀ on mma.sync m16n8k16. The weights are
//   the m16 A operand (16 output columns a tile), the rows of x the n8 B
//   operand, so N = 8 fills an n8 tile and N = 16 takes two tiles that
//   share their A fragments: no tensor-core row is padding at the engine's
//   decode buckets. A register of the A fragment holds the k-pair (2i,
//   2i + 1) of one output column: one packed byte.
// - Column map (int4_matmul.py::decode_columns): fragment row r of m-tile
//   mt of lane l stands for column 2*MT*(l/4) + 2*mt of the warp's 16*MT
//   columns, row r + 8 for the next one. A thread's columns are then 2*MT
//   adjacent bytes of a packed row: one 16-byte (MT = 8) or 8-byte (MT = 4)
//   load fills its A registers of that row for every m-tile, and the eight
//   threads of a row read 128 (64) contiguous bytes. The wrapper takes the
//   64-column tile where it gives the launch more blocks (decode_tile).
// - Bytes in flight with no block barrier: each weight byte is used by one
//   thread only, so it goes from device memory straight into registers
//   (ld.global.nc, not kept in L1, evict-first in L2: a step reads a weight
//   once) through a ring of kStages k-steps a thread; the B fragments (x,
//   small and read from L2) ride in the same ring. At 4 blocks of 128
//   threads an SM and 4 stages of 32 bytes a thread (MT = 8), 64 KB of
//   weights are in flight an SM. (On an NVIDIA H100 80GB HBM3 at 700 W,
//   rings of 2, 3, 5 and 8 stages were no faster, and x staged once a
//   block in shared memory was slower at most shapes; PERF.md, PR 5.)
// - Conversion a word at a time (int4_bits.cuh::weights_bits), in the TPU
//   kernel's rounding; the products accumulate straight into fp32.
// - Split-K in the launch: the split's k-steps are cut evenly among the
//   block's 4 warps (a split itself ends on a group boundary), which add
//   their sums in warp order in shared memory. The S <= 8 splits of a tile
//   are one thread block cluster: each block pushes its part of every
//   block's share of the tile into that block's shared memory, one cluster
//   barrier later each block adds its share in split order and stores it.
//   One launch a call, no workspace, and two launches give the same bits.
//   (A ticket merge through a device-memory workspace, as the split-KV
//   decode kernel does, was as fast at 4096 x 14336, slower at the small
//   projections and faster at 14336 x 4096, where it allows 16 splits of
//   128 columns; clusters of 16 were slower than 8. PERF.md, PR 5.)

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "int4_bits.cuh"
#include "sm90.cuh"

namespace {

using pst_int4::weights_bits;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 4;  // k-steps a thread has in flight
// Dynamic shared memory a block may take: its groups' scales, or its warps'
// sums, and the cluster's partial sums of its share of the tile
// (int4_matmul.py::_DECODE_SMEM bounds a split by it).
constexpr int kMaxSmem = 96 * 1024;
constexpr int kMaxCluster = 8;  // splits of a tile: one portable cluster

// NT: n8 tiles (8 rows of x each) a block. MT: m16 tiles a warp (8: 128
// columns, 16-byte loads; 4: 64 columns, 8-byte loads).
template <int NT, int MT>
struct Tile {
  static constexpr int BR = 8 * NT;    // rows of x a block
  static constexpr int BC = 16 * MT;   // output columns a block (and warp)
  static constexpr int W = MT / 2;     // 32-bit words a thread loads of a packed row
  static constexpr int RS = BC + 4;    // floats a row of the warp-sum tile
  static constexpr int kRedBytes = kWarps * BR * RS * 4;
  // The cluster's partials of a block's share: BR * BC / S float4s from
  // each of S blocks, rounded up.
  static constexpr int kRecvBytes = BR * BC * 4 + kMaxCluster * 16;
  // Blocks an SM the plan counts on (int4_matmul.py::_DECODE_BLOCKS_PER_SM).
  static constexpr int kMinBlocks = NT * MT >= 16 ? 3 : 4;
};

__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a,
                                               const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}

// W 32-bit words of streamed weights: not allocated in L1, evict-first in L2.
template <int W>
__device__ __forceinline__ void ld_stream(uint32_t* d, const void* p,
                                          uint64_t pol) {
  if constexpr (W == 4) {
    asm volatile(
        "ld.global.nc.L1::no_allocate.L2::cache_hint.v4.u32 "
        "{%0, %1, %2, %3}, [%4], %5;\n"
        : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
        : "l"(p), "l"(pol));
  } else {
    static_assert(W == 2, "a thread loads 8 or 16 bytes of a packed row");
    asm volatile(
        "ld.global.nc.L1::no_allocate.L2::cache_hint.v2.u32 {%0, %1}, [%2], "
        "%3;\n"
        : "=r"(d[0]), "=r"(d[1])
        : "l"(p), "l"(pol));
  }
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// ---------------------------------------------------------------------------
// Grid (ceil(N / BR), ceil(dout / BC), splits), 128 threads. Row tiles run
// fastest, so the blocks that share a weight tile start together and all
// but the first read it from L2. Split z covers the groups [z * per_split,
// (z + 1) * per_split); warp w of it the k-steps [w * n / 4, (w + 1) * n /
// 4) of the split's n. The grid's z (the splits of a tile) is one cluster.
// kVec: dout % (2 * MT) == 0 and aligned x and packed, so every load is a
// whole vector.
//
// Fragments a k-step (16 contraction rows k0.., packed rows k0/2..):
//   A reg 0 / 1 = packed row k0/2 + tig, byte 2mt / 2mt + 1 of the thread's
//                 2*MT columns (fragment rows gid / gid + 8)
//   A reg 2 / 3 = packed row k0/2 + 4 + tig, the same bytes
//   B reg 0 / 1 = x row m0 + 8nt + gid, columns k0 + 2tig (+1) / k0 + 8 +
//                 2tig (+1)
// and the accumulator holds, for x rows 8nt + 2tig (+1), the columns
// 2*MT*gid + 2mt (regs 0, 1) and + 1 (regs 2, 3).
// ---------------------------------------------------------------------------

template <int NT, int MT, bool kVec>
__global__ void __launch_bounds__(kThreads, Tile<NT, MT>::kMinBlocks)
int4_decode_kernel(const __nv_bfloat16* __restrict__ x,
                   const int8_t* __restrict__ packed,
                   const float* __restrict__ scales, float* __restrict__ out,
                   int N, int din, int dout, int G, int per_split,
                   size_t recv_off, bool vec_s) {
  using T = Tile<NT, MT>;
  constexpr int BR = T::BR, BC = T::BC, W = T::W, RS = T::RS;
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int m0 = blockIdx.x * BR, n0 = blockIdx.y * BC;
  const int groups = din / G;
  const int g_blk = blockIdx.z * per_split;
  const int g_end = min(g_blk + per_split, groups);
  const int spg = G / 16;  // k-steps a group
  // The block's k-steps, cut evenly among its warps.
  const int n_blk = (g_end - g_blk) * spg;
  const int s_lo = warp * n_blk / kWarps, s_hi = (warp + 1) * n_blk / kWarps;
  const int nsteps = s_hi - s_lo;
  const int k_lo = g_blk * G + 16 * s_lo;  // the warp's first contraction row
  const int col = n0 + 2 * MT * gid;  // the first of this thread's columns
  const uint64_t pol = evict_first_policy();
  // This block has started: peers may write to its shared memory once the
  // matching wait (before the merge) returns.
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // Running pointers of the next k-step to load: packed row k/2 + tig (and
  // + 4), x rows m0 + 8nt + gid at column k + 2tig (and + 8). On the kVec
  // path rows past N and columns past dout read row N - 1 and the last
  // columns instead (their products land in outputs that are not stored).
  const int8_t* pn;
  const __nv_bfloat16* xn[NT];
  if (kVec) {
    pn = packed + (size_t)(k_lo / 2 + tig) * dout + min(col, dout - 2 * MT);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      xn[nt] = x + (size_t)min(m0 + 8 * nt + gid, N - 1) * din + k_lo + 2 * tig;
  } else {
    pn = packed + (size_t)(k_lo / 2 + tig) * dout + col;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      xn[nt] = x + (size_t)(m0 + 8 * nt + gid) * din + k_lo + 2 * tig;
  }
  const size_t step_p = (size_t)8 * dout;

  struct Stage {
    uint32_t w0[W], w1[W];  // packed rows k0/2 + tig and k0/2 + 4 + tig
    uint32_t b[NT][2];
  };
  // The next k-step of the warp into a ring slot.
  auto load = [&](Stage& st) {
    if (kVec) {
      ld_stream<W>(st.w0, pn, pol);
      ld_stream<W>(st.w1, pn + 4 * (size_t)dout, pol);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        st.b[nt][0] = __ldg(reinterpret_cast<const unsigned int*>(xn[nt]));
        st.b[nt][1] = __ldg(reinterpret_cast<const unsigned int*>(xn[nt] + 8));
      }
    } else {  // bytes and halves, zero past dout and N
#pragma unroll
      for (int i = 0; i < W; ++i) {
        uint32_t a = 0, b = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (col + 4 * i + e < dout) {
            const unsigned char* q =
                reinterpret_cast<const unsigned char*>(pn + 4 * i + e);
            a |= (uint32_t)__ldg(q) << (8 * e);
            b |= (uint32_t)__ldg(q + 4 * (size_t)dout) << (8 * e);
          }
        }
        st.w0[i] = a;
        st.w1[i] = b;
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t b0 = 0, b1 = 0;
        if (m0 + 8 * nt + gid < N) {
          const unsigned short* h = reinterpret_cast<const unsigned short*>(xn[nt]);
          b0 = (uint32_t)__ldg(h) | ((uint32_t)__ldg(h + 1) << 16);
          b1 = (uint32_t)__ldg(h + 8) | ((uint32_t)__ldg(h + 9) << 16);
        }
        st.b[nt][0] = b0;
        st.b[nt][1] = b1;
      }
    }
    pn += step_p;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) xn[nt] += 16;
  };

  Stage ring[kStages];
#pragma unroll
  for (int d = 0; d < kStages; ++d)
    if (d < nsteps) load(ring[d]);

  // The block's scales [g_end - g_blk][BC], zero past dout, while the first
  // weights are on their way.
  float* ss = smem;
  const int ng = g_end - g_blk;
  if (vec_s) {  // dout % 4 == 0 and 16-byte aligned rows
    for (int p = tid; p < ng * (BC / 4); p += kThreads) {
      const int r = p / (BC / 4), c = 4 * (p % (BC / 4));
      const bool ok = n0 + c < dout;
      pst_sm90::cp_async16(
          pst_sm90::smem_u32(ss + r * BC + c),
          ok ? scales + (size_t)(g_blk + r) * dout + n0 + c : scales, ok);
    }
    pst_sm90::cp_async_commit();
    pst_sm90::cp_async_wait<0>();
  } else {
    for (int p = tid; p < ng * BC; p += kThreads) {
      const int r = p / BC, c = p % BC;
      ss[p] = n0 + c < dout ? __ldg(scales + (size_t)(g_blk + r) * dout + n0 + c)
                            : 0.f;
    }
  }
  __syncthreads();

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
  __nv_bfloat162 sc[2 * MT];  // the group's scales of the thread's columns
  int sg = s_lo % spg;        // k-step within the group
  const float* srow = ss + (s_lo / spg) * BC + 2 * MT * gid;
  auto read_scales = [&]() {
#pragma unroll
    for (int i = 0; i < 2 * MT; i += 4) {
      const float4 f = *reinterpret_cast<const float4*>(srow + i);
      sc[i] = __float2bfloat162_rn(f.x);
      sc[i + 1] = __float2bfloat162_rn(f.y);
      sc[i + 2] = __float2bfloat162_rn(f.z);
      sc[i + 3] = __float2bfloat162_rn(f.w);
    }
    srow += BC;
  };
  if (nsteps > 0) read_scales();

  for (int s0 = 0; s0 < nsteps; s0 += kStages) {
#pragma unroll
    for (int d = 0; d < kStages; ++d) {
      if (s0 + d < nsteps) {
        const Stage& cur = ring[d];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int w = mt / 2, j = 2 * (mt % 2);
          uint32_t a[4];
          a[0] = weights_bits(cur.w0[w], cur.w0[w] >> 4, j, sc[2 * mt]);
          a[1] = weights_bits(cur.w0[w], cur.w0[w] >> 4, j + 1, sc[2 * mt + 1]);
          a[2] = weights_bits(cur.w1[w], cur.w1[w] >> 4, j, sc[2 * mt]);
          a[3] = weights_bits(cur.w1[w], cur.w1[w] >> 4, j + 1, sc[2 * mt + 1]);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma_bf16_16816(acc[mt][nt], a, cur.b[nt]);
        }
        // The slot is free: the step kStages ahead goes into it.
        if (s0 + d + kStages < nsteps) load(ring[d]);
        if (++sg == spg) {  // the next step starts a group: its scales
          sg = 0;
          if (s0 + d + 1 < nsteps) read_scales();
        }
      }
    }
  }

  // The warps' sums meet in shared memory (the scales are done with).
  __syncthreads();
  float* red = smem;  // [kWarps][BR][RS]
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float* o = red + (warp * BR + 8 * nt + 2 * tig) * RS + 2 * MT * gid + 2 * mt;
      *reinterpret_cast<float2*>(o) = make_float2(acc[mt][nt][0], acc[mt][nt][2]);
      *reinterpret_cast<float2*>(o + RS) =
          make_float2(acc[mt][nt][1], acc[mt][nt][3]);
    }
  }
  __syncthreads();

  const bool vec_o = (dout & 3) == 0;
  auto store = [&](int e, float4 v) {  // element e of the block tile
    const int row = m0 + e / BC, n = n0 + e % BC;
    if (row >= N) return;
    float* o = out + (size_t)row * dout + n;
    if (vec_o && n + 3 < dout) {
      *reinterpret_cast<float4*>(o) = v;
    } else {
      const float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (n + i < dout) o[i] = f[i];
    }
  };
  const int S = gridDim.z;
  // The tile's S blocks are one cluster. Block z owns float4s [z * per,
  // (z + 1) * per) of the tile: every block adds its warps' sums in warp
  // order and pushes its part of each owner's share into the owner's
  // shared memory, slot z; after one cluster barrier each owner adds the
  // S slots in split order and stores its share.
  namespace cg = cooperative_groups;
  const int per = (BR * BC / 4 + S - 1) / S;  // float4s a block owns
  float4* recv = reinterpret_cast<float4*>(reinterpret_cast<char*>(smem) + recv_off);
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");  // all started
  for (int e4 = tid; e4 < BR * BC / 4; e4 += kThreads) {
    const int r = 4 * e4 / BC, c = 4 * e4 % BC;
    float4 v = *reinterpret_cast<const float4*>(red + r * RS + c);
#pragma unroll
    for (int w = 1; w < kWarps; ++w)
      v = add4(v, *reinterpret_cast<const float4*>(red + (w * BR + r) * RS + c));
    if (S == 1) {
      store(4 * e4, v);
    } else {
      const int owner = e4 / per;
      *cg::this_cluster().map_shared_rank(recv + blockIdx.z * per + (e4 - owner * per),
                                          owner) = v;
    }
  }
  if (S == 1) return;
  cg::this_cluster().sync();
  for (int i = tid; i < per && blockIdx.z * per + i < BR * BC / 4; i += kThreads) {
    float4 v = recv[i];
    for (int q = 1; q < S; ++q) v = add4(v, recv[q * per + i]);
    store(4 * (blockIdx.z * per + i), v);
  }
}

template <int NT, int MT>
size_t recv_offset(int per_split) {
  using T = Tile<NT, MT>;
  const size_t scale = (size_t)per_split * T::BC * 4;
  const size_t used = scale > (size_t)T::kRedBytes ? scale : (size_t)T::kRedBytes;
  return (used + 15) / 16 * 16;
}

template <int NT, int MT>
size_t smem_bytes(int per_split) {
  return recv_offset<NT, MT>(per_split) + Tile<NT, MT>::kRecvBytes;
}

template <int NT, int MT, bool kVec>
cudaError_t launch_k(dim3 grid, int per_split, const void* x,
                     const void* packed, const void* scales, void* out, int N,
                     int din, int dout, int G, bool vec_s, cudaStream_t s) {
  auto* k = int4_decode_kernel<NT, MT, kVec>;
  static bool attrs_set = false;  // idempotent: a race only repeats the call
  if (!attrs_set) {
    cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return e;
    attrs_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes<NT, MT>(per_split);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = grid.z;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(
      &cfg, k, static_cast<const __nv_bfloat16*>(x),
      static_cast<const int8_t*>(packed), static_cast<const float*>(scales),
      static_cast<float*>(out), N, din, dout, G, per_split,
      recv_offset<NT, MT>(per_split), vec_s);
}

template <int NT, int MT>
cudaError_t launch(dim3 grid, const void* x, const void* packed,
                   const void* scales, void* out, int N, int din, int dout,
                   int G, int per_split, cudaStream_t s) {
  using T = Tile<NT, MT>;
  if (smem_bytes<NT, MT>(per_split) > (size_t)kMaxSmem ||
      (long long)grid.x * T::BR < N || (long long)grid.y * T::BC < dout ||
      grid.z > kMaxCluster)
    return cudaErrorInvalidValue;
  const bool vec = reinterpret_cast<uintptr_t>(x) % 4 == 0 &&
                   dout % (2 * MT) == 0 &&
                   reinterpret_cast<uintptr_t>(packed) % (2 * MT) == 0;
  const bool vec_s = dout % 4 == 0 && reinterpret_cast<uintptr_t>(scales) % 16 == 0;
  if (vec)
    return launch_k<NT, MT, true>(grid, per_split, x, packed, scales, out, N,
                                  din, dout, G, vec_s, s);
  return launch_k<NT, MT, false>(grid, per_split, x, packed, scales, out, N,
                                 din, dout, G, vec_s, s);
}

}  // namespace

// bf16 x only. nt (1, 2 or 4: n8 tiles a block), mt (8: 128 columns a
// block, nt = 1 only; 4: 64), the grid and the split are the wrapper's
// plan (int4_matmul.py::plan, route "decode"): grid_x row tiles of 8 * nt,
// grid_y column tiles, `splits` (at most 8) splits of per_split groups; the
// splits of a tile are one thread block cluster. Returns a cudaError_t
// (0 = success).
extern "C" int pst_int4_decode(const void* x, const void* packed,
                               const void* scales, void* out, int N, int din,
                               int dout, int G, int nt, int mt, int grid_x,
                               int grid_y, int splits, int per_split,
                               void* stream) {
  if (N <= 0 || dout <= 0) return 0;
  const int groups = G > 0 ? din / G : 0;
  if (din <= 0 || G <= 0 || G % 16 || din % G || per_split < 1 ||
      splits < 1 || (long long)splits * per_split < groups ||
      (long long)(splits - 1) * per_split >= groups || grid_x < 1 ||
      grid_y < 1 || grid_y > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(grid_x, grid_y, splits);
#define PST_DECODE(NT, MT)                                                  \
  if (nt == NT && mt == MT)                                                 \
    return (int)launch<NT, MT>(grid, x, packed, scales, out, N, din, dout,  \
                               G, per_split, s)
  PST_DECODE(1, 8);
  PST_DECODE(1, 4);
  PST_DECODE(2, 4);
  PST_DECODE(4, 4);
#undef PST_DECODE
  return (int)cudaErrorInvalidValue;
}

// Blocks of the aligned int4_decode_kernel<nt, mt> an SM holds at a split
// of per_split groups (registers, shared memory), into *blocks.
extern "C" int pst_int4_decode_occupancy(int nt, int mt, int per_split,
                                         int* blocks) {
#define PST_OCC(NT, MT)                                                      \
  if (nt == NT && mt == MT)                                                  \
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(              \
        blocks, int4_decode_kernel<NT, MT, true>, kThreads,                 \
        smem_bytes<NT, MT>(per_split))
  PST_OCC(1, 8);
  PST_OCC(1, 4);
  PST_OCC(2, 4);
  PST_OCC(4, 4);
#undef PST_OCC
  return (int)cudaErrorInvalidValue;
}
