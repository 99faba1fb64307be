// Packed int4 weights to bf16, a word at a time, in the TPU kernel's
// rounding. Shared by the int4 kernels that run on the tensor cores
// (int4_matmul.cu's wgmma route, int4_decode.cu).
//
// For a packed word w and w4 = w >> 4, prmt puts byte j of w in halves 0
// and 1 of a register and byte j of w4 (whose low nibble is w's high
// nibble) in halves 2 and 3; (x & 0x000F000F) ^ 0x43084308 turns each half
// into the bf16 128 + (q ^ 8) = 136 + q (XOR 8 makes the signed nibble
// offset-binary, 0x4300 is 128.0 and its low mantissa bits take the nibble
// exactly); one bf16x2 subtract of 136 leaves q, exactly. One bf16x2
// multiply by the group's scale, rounded to bf16 first, then gives the
// weight that production_stack_tpu/ops/int4_matmul.py::_kernel feeds its
// MXU (the levels in bf16 times the scale cast to bf16), bit for bit.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace pst_int4 {

// Weights of the k-pair in byte j (0..3) of packed word w (w4 = w >> 4),
// times the bf16 scale s2 (in both halves), as one bf16x2 register: the
// low nibble's weight (row 2i) in the low half.
__device__ __forceinline__ uint32_t weights_bits(uint32_t w, uint32_t w4,
                                                 int j, __nv_bfloat162 s2) {
  const uint32_t sel = j | (j << 4) | ((4 + j) << 8) | ((4 + j) << 12);
  uint32_t x;
  // (p & 0x000F000F) ^ 0x43084308 as one lop3 (ptxas splits the C++ into
  // two): lut = (0xF0 & 0xCC) ^ 0xAA.
  asm("lop3.b32 %0, %1, %2, %3, 0x6A;"
      : "=r"(x)
      : "r"(__byte_perm(w, w4, sel)), "r"(0x000F000Fu), "r"(0x43084308u));
  const uint32_t k136 = 0x43084308u;  // bf16x2 (136, 136)
  __nv_bfloat162 h = __hmul2(
      __hsub2(*reinterpret_cast<__nv_bfloat162*>(&x),
              *reinterpret_cast<const __nv_bfloat162*>(&k136)),
      s2);
  return *reinterpret_cast<uint32_t*>(&h);
}

}  // namespace pst_int4
