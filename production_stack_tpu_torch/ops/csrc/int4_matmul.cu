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
// a tile. Hopper needs none of that: the m16n8k16 B fragment of mma.sync
// holds the k-pairs (2i, 2i+1) of one column in one register, which is
// exactly one packed byte, so a thread turns each byte it reads into one
// bf16x2 register. The weights are read from device memory once, 0.5 byte
// per weight, and are never written back dequantized.
//
// Two routes, chosen per call (every shape the quantizer makes is taken):
//   int4_mma_kernel   bf16 x and G % 16 == 0 (every real checkpoint: G =
//                     128). Tensor cores, bf16 in, fp32 accumulate. Each
//                     group's partial product runs on the integer levels
//                     alone (exact in bf16) and is scaled in fp32 after the
//                     group: a group's scale varies only along dout, so it
//                     commutes with the contraction. This is more exact than
//                     the JAX bf16 path, which rounds q * s to bf16 first.
//   int4_simt_kernel  fp32 x (exact fp32: no weight or partial sum is
//                     rounded to bf16), and bf16 x with a group size below
//                     16 (tiny debug models). CUDA cores.
// Ragged N and dout are masked in both. A split of the contraction (din) on
// group boundaries gives the card enough blocks at decode shapes; the
// partial sums go to a workspace that a second pass adds in a fixed order,
// so the result is deterministic (no float atomics).
//
// What bounds it on an H100 (3.35 TB/s, 989 TFLOP/s bf16 dense):
//   decode  (N = 8, din 4096, dout 14336): bytes. 29.4 MB of packed weights
//           + 1.8 MB of scales: 9.5 us. The next chunk's tiles are loaded
//           into registers while the current one is multiplied.
//   prefill (N = 512, same weight): operations. 60.1 GFLOP: 61 us. This
//           first version feeds mma.sync from shared memory with scalar
//           fragment loads and no cp.async / TMA pipeline, so it is far
//           from that bound; wgmma and a Marlin-style layout are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kCols = 128;     // output columns per block (32 per warp)
constexpr int kChunk = 64;     // contraction rows staged per step
constexpr int kSimtRows = 8;   // rows of x per block on the CUDA-core route
constexpr int kXStride = kChunk + 8;  // bf16 per staged x row (spreads banks)
constexpr int kPStride = kCols + 16;  // bytes per staged packed row

// Signed nibbles of a packed byte b (b sign-extended from int8). The cast
// back to int8_t matters: b << 4 is an int, and without it the low nibble
// would not be sign-extended.
__device__ __forceinline__ int nib_lo(int b) { return (int)(int8_t)(b << 4) >> 4; }
__device__ __forceinline__ int nib_hi(int b) { return b >> 4; }

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Two signed levels as one bf16x2 register: lo in the low half.
__device__ __forceinline__ uint32_t levels_bf16x2(int b) {
  __nv_bfloat162 h = __floats2bfloat162_rn((float)nib_lo(b), (float)nib_hi(b));
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a,
                                               const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ---------------------------------------------------------------------------
// Tensor-core route: grid (ceil(dout/128), ceil(N/BM), splits), 4 warps.
//
// A block owns BM = 16*MT rows x 128 columns of the output and the groups
// [g_lo, g_hi) of the contraction; warp w owns columns [32w, 32w+32), i.e.
// MT x 4 m16n8 tiles. Per 64-row chunk the block stages x (bf16) and the
// packed bytes in shared memory; per k16 step a thread builds its A
// fragments from x and its B fragments from two packed bytes per n8 tile:
//   B reg 0 = rows k0 + 2*tig, +1      = packed row k0/2 + tig
//   B reg 1 = rows k0 + 8 + 2*tig, +1  = packed row k0/2 + 4 + tig
// at column gid of the tile (gid = lane / 4, tig = lane % 4).
// ---------------------------------------------------------------------------

template <int MT>
__global__ void __launch_bounds__(kThreads)
int4_mma_kernel(const __nv_bfloat16* __restrict__ x,
                const int8_t* __restrict__ packed,
                const float* __restrict__ scales, float* __restrict__ out,
                int N, int din, int dout, int G, int per_split, bool vec_x,
                bool vec_p) {
  constexpr int BM = 16 * MT;
  constexpr int XP = BM * (kChunk / 8) / kThreads;          // x pieces / thread
  constexpr int PP = (kChunk / 2) * (kCols / 16) / kThreads;  // packed pieces
  static_assert(XP >= 1 && PP >= 1, "tile / thread mismatch");
  __shared__ __align__(16) __nv_bfloat16 sx[BM][kXStride];
  __shared__ __align__(16) int8_t sp[kChunk / 2][kPStride];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int n0 = blockIdx.x * kCols;
  const int m0 = blockIdx.y * BM;
  const int groups = din / G;
  const int g_lo = blockIdx.z * per_split;
  const int g_hi = min(g_lo + per_split, groups);
  const int k_lo = g_lo * G, k_hi = g_hi * G;
  const int wn = warp * 32;

  float acc[MT][4][4], part[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = part[mt][nt][i] = 0.f;

  // One 16-byte piece per slot: x row r, columns [c, c+8) of the chunk;
  // packed row r, columns [c, c+16) of the tile. Zero outside N, dout, k_hi
  // (k_hi is a multiple of 16, so a piece is wholly inside or outside).
  uint4 xr[XP], pr[PP];
  auto load_chunk = [&](int k0) {
#pragma unroll
    for (int j = 0; j < XP; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const int r = i / (kChunk / 8), c = (i % (kChunk / 8)) * 8;
      const int row = m0 + r, k = k0 + c;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (row < N && k < k_hi) {
        const __nv_bfloat16* src = x + (size_t)row * din + k;
        if (vec_x) {
          v = __ldg(reinterpret_cast<const uint4*>(src));
        } else {
          const unsigned short* src16 =
              reinterpret_cast<const unsigned short*>(src);
          union { uint4 u; unsigned short h[8]; } t;
#pragma unroll
          for (int e = 0; e < 8; ++e) t.h[e] = src16[e];
          v = t.u;
        }
      }
      xr[j] = v;
    }
#pragma unroll
    for (int j = 0; j < PP; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const int r = i / (kCols / 16), c = (i % (kCols / 16)) * 16;
      const int kp = (k0 >> 1) + r, n = n0 + c;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (2 * kp < k_hi && n < dout) {
        const int8_t* src = packed + (size_t)kp * dout + n;
        if (vec_p) {  // dout % 16 == 0: the piece is whole
          v = __ldg(reinterpret_cast<const uint4*>(src));
        } else {
          union { uint4 u; int8_t b[16]; } t;
#pragma unroll
          for (int e = 0; e < 16; ++e) t.b[e] = n + e < dout ? src[e] : 0;
          v = t.u;
        }
      }
      pr[j] = v;
    }
  };

  if (k_lo < k_hi) load_chunk(k_lo);
  for (int k0 = k_lo; k0 < k_hi; k0 += kChunk) {
    __syncthreads();  // the previous chunk's readers are done
#pragma unroll
    for (int j = 0; j < XP; ++j) {
      const int i = threadIdx.x + j * kThreads;
      *reinterpret_cast<uint4*>(&sx[i / (kChunk / 8)][(i % (kChunk / 8)) * 8]) =
          xr[j];
    }
#pragma unroll
    for (int j = 0; j < PP; ++j) {
      const int i = threadIdx.x + j * kThreads;
      *reinterpret_cast<uint4*>(&sp[i / (kCols / 16)][(i % (kCols / 16)) * 16]) =
          pr[j];
    }
    __syncthreads();
    // The next chunk's loads are in flight while this one is multiplied.
    if (k0 + kChunk < k_hi) load_chunk(k0 + kChunk);

    const int ksteps = min(kChunk, k_hi - k0) / 16;
    for (int ks = 0; ks < ksteps; ++ks) {
      const int kk = ks * 16;
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const __nv_bfloat16* p = &sx[mt * 16 + gid][kk + 2 * tig];
        a[mt][0] = *reinterpret_cast<const uint32_t*>(p);
        a[mt][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kXStride);
        a[mt][2] = *reinterpret_cast<const uint32_t*>(p + 8);
        a[mt][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kXStride + 8);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = wn + nt * 8 + gid;
        uint32_t b[2];
        b[0] = levels_bf16x2(sp[kk / 2 + tig][col]);
        b[1] = levels_bf16x2(sp[kk / 2 + 4 + tig][col]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_bf16_16816(part[mt][nt], a[mt], b);
      }
      const int k_next = k0 + kk + 16;
      if (k_next % G == 0) {  // end of a group: scale its product in fp32
        const float* srow = scales + (size_t)(k_next / G - 1) * dout;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int col = n0 + wn + nt * 8 + 2 * tig;
          const float s0 = col < dout ? __ldg(srow + col) : 0.f;
          const float s1 = col + 1 < dout ? __ldg(srow + col + 1) : 0.f;
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            float* p = part[mt][nt];
            float* o = acc[mt][nt];
            o[0] = fmaf(s0, p[0], o[0]);
            o[1] = fmaf(s1, p[1], o[1]);
            o[2] = fmaf(s0, p[2], o[2]);
            o[3] = fmaf(s1, p[3], o[3]);
            p[0] = p[1] = p[2] = p[3] = 0.f;
          }
        }
      }
    }
  }

  float* dst = out + (size_t)blockIdx.z * N * dout;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int row = m0 + mt * 16 + gid;
      const int col = n0 + wn + nt * 8 + 2 * tig;
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // rows gid and gid + 8
        const int r = row + 8 * h;
        if (r >= N) continue;
        if (col < dout) dst[(size_t)r * dout + col] = acc[mt][nt][2 * h];
        if (col + 1 < dout) dst[(size_t)r * dout + col + 1] = acc[mt][nt][2 * h + 1];
      }
    }
  }
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of x). ws is [splits, N, dout] fp32
// (the output itself when splits == 1); split z covers the groups
// [z * per_split, (z + 1) * per_split). Returns a cudaError_t (0 = success).
extern "C" int pst_int4_matmul(int dtype, const void* x, const void* packed,
                               const void* scales, void* out, void* ws, int N,
                               int din, int dout, int G, int splits,
                               int per_split, void* stream) {
  if (N <= 0 || dout <= 0) return 0;
  if (din <= 0 || G <= 0 || G % 2 || din % G || splits < 1 ||
      per_split < 1 || (long long)splits * per_split < din / G)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cols = (dout + kCols - 1) / kCols;
  float* dst = static_cast<float*>(splits > 1 ? ws : out);
  const int8_t* pk = static_cast<const int8_t*>(packed);
  const float* sc = static_cast<const float*>(scales);
  if (dtype == 1 && G % 16 == 0) {
    const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
    const bool vec_x = din % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
    const bool vec_p =
        dout % 16 == 0 && reinterpret_cast<uintptr_t>(packed) % 16 == 0;
    if (N <= 16) {
      dim3 grid(cols, (N + 15) / 16, splits);
      int4_mma_kernel<1><<<grid, kThreads, 0, s>>>(xb, pk, sc, dst, N, din,
                                                   dout, G, per_split, vec_x,
                                                   vec_p);
    } else {
      dim3 grid(cols, (N + 63) / 64, splits);
      int4_mma_kernel<4><<<grid, kThreads, 0, s>>>(xb, pk, sc, dst, N, din,
                                                   dout, G, per_split, vec_x,
                                                   vec_p);
    }
  } else {
    dim3 grid(cols, (N + kSimtRows - 1) / kSimtRows, splits);
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
