// The e4m3 KV cache's conversions, shared by the attention kernels.
//
// Reading: every e4m3 value is an f16, an f32 and a bf16 value, so the
// conversions up are exact (e4m3 -> f16 in hardware, then f32, then bf16).
// Writing: cast_e4m3 is the JAX package's astype(float8_e4m3fn), the cast
// that ops/fp8.py::cast_e4m3 writes with PyTorch: round to nearest even,
// and NaN carrying x's sign where |x| rounds past 448 (|x| > 464), x is
// +-inf, or x is NaN. The hardware's saturating conversion rounds the same
// way inside e4m3's range; the NaN rule is applied after it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <math.h>
#include <stdint.h>

namespace pst_fp8 {

// Two e4m3 values (the low 16 bits, element 0 lowest) -> bf16x2.
__device__ __forceinline__ uint32_t e4m3x2_to_bf16x2(uint32_t two) {
  const float2 f = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(
      (__nv_fp8x2_storage_t)(two & 0xffffu), __NV_E4M3)));
  __nv_bfloat162 h = __floats2bfloat162_rn(f.x, f.y);
  return *reinterpret_cast<uint32_t*>(&h);
}

// 16 e4m3 values -> 16 bf16 values (lo: elements 0..7, hi: 8..15).
__device__ __forceinline__ void e4m3x16_to_bf16(const uint4 v, uint4& lo,
                                                uint4& hi) {
  lo = make_uint4(e4m3x2_to_bf16x2(v.x), e4m3x2_to_bf16x2(v.x >> 16),
                  e4m3x2_to_bf16x2(v.y), e4m3x2_to_bf16x2(v.y >> 16));
  hi = make_uint4(e4m3x2_to_bf16x2(v.z), e4m3x2_to_bf16x2(v.z >> 16),
                  e4m3x2_to_bf16x2(v.w), e4m3x2_to_bf16x2(v.w >> 16));
}

// A fragment register's four e4m3 bytes (element 0 lowest) -> the two
// bf16x2 registers of an mma operand: bytes 0, 1 in lo and 2, 3 in hi.
// Exact, and NaN stays NaN (the hardware conversion keeps e4m3's NaN
// codes 0x7f and 0xff NaN, where a bit-trick conversion would make 480).
__device__ __forceinline__ void e4m3x4_to_bf16x2x2(uint32_t four,
                                                   uint32_t& lo,
                                                   uint32_t& hi) {
  lo = e4m3x2_to_bf16x2(four);
  hi = e4m3x2_to_bf16x2(four >> 16);
}

// Two key rows' words of 4 e4m3 dims (a: the lower key) -> four bf16x2
// key pairs, one a dim: pairs[d] = (a's byte d, b's byte d). One byte
// permute makes two pairs: the byte transpose of the split-KV decode's V
// fragments.
__device__ __forceinline__ void e4m3_key_pairs(uint32_t a, uint32_t b,
                                               uint32_t (&pairs)[4]) {
  const uint32_t d01 = __byte_perm(a, b, 0x5140);  // a0 b0 a1 b1
  const uint32_t d23 = __byte_perm(a, b, 0x7362);  // a2 b2 a3 b3
  e4m3x4_to_bf16x2x2(d01, pairs[0], pairs[1]);
  e4m3x4_to_bf16x2x2(d23, pairs[2], pairs[3]);
}

// Two e4m3 values (the low 16 bits) -> fp32.
__device__ __forceinline__ float2 e4m3x2_to_float2(uint32_t two) {
  return __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(
      (__nv_fp8x2_storage_t)(two & 0xffffu), __NV_E4M3)));
}

// x as an e4m3 byte, bit for bit as the JAX package casts it.
__device__ __forceinline__ uint32_t cast_e4m3(float x) {
  if (!(fabsf(x) <= 464.f)) return signbit(x) ? 0xffu : 0x7fu;
  return __nv_cvt_float_to_fp8(x, __NV_SATFINITE, __NV_E4M3);
}

// Eight bf16 values (16 bytes) -> eight e4m3 bytes (element 0 lowest).
__device__ __forceinline__ uint2 cast_e4m3x8(const uint4 v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t b[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t bits = (w[i / 2] >> (16 * (i % 2))) << 16;
    b[i / 4] |= cast_e4m3(__uint_as_float(bits)) << (8 * (i % 4));
  }
  return make_uint2(b[0], b[1]);
}

}  // namespace pst_fp8
