// Hopper (sm_90a) building blocks shared by the wgmma kernels: cp.async
// with zero-fill, mbarriers, the 128-byte shared-memory swizzle, wgmma
// operand descriptors, the wgmma shapes the kernels use, and the fast
// exp2 of the softmaxes.
//
// Layout convention (the one TMA's SWIZZLE_128B writes and wgmma's B128
// descriptors read): a tile is a stack of rows of 128 bytes; the 16-byte
// chunk c of row r sits at chunk position c ^ (r % 8). Eight rows make a
// 1024-byte swizzle atom, so every tile starts on a 1024-byte boundary.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace pst_sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 2^x on the special-function unit (flush-to-zero): the softmaxes' exp.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Byte offset of 16-byte chunk `chunk` (0..7) of row `row` in a swizzled tile.
__device__ __forceinline__ uint32_t sw128(int row, int chunk) {
  return (uint32_t)(row * 128 + ((chunk ^ (row & 7)) << 4));
}

// 16 bytes global -> shared, asynchronously; zeros when !valid (no bytes
// are read then, but `src` must still be a valid address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Makes this thread's completed shared-memory writes visible to the async
// proxy (wgmma reads its shared operands through it). Then a barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// mbarriers in shared memory (at shared address `bar`): init with the
// number of arrivals a phase takes; an arrive; an arrive that fires once
// every cp.async this thread started so far has landed (and counts as one of
// the phase's arrivals); a wait for the phase of parity `parity` to end.
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n"
      ".reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n"
      "}\n" ::"r"(bar)
      : "memory");
}
__device__ __forceinline__ void cp_async_mbar_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}
// An arrive that also expects `bytes` more of the phase's transactions
// (cp.async.bulk completions); once after mbar_init, the fence that makes
// the barriers visible to the async proxy.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile(
      "{\n"
      ".reg .b64 state;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n"
      "}\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void fence_mbarrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// `bytes` (a multiple of 16) global -> shared by the bulk copy engine,
// both 16-byte aligned; completes its bytes on the mbarrier `bar`.
__device__ __forceinline__ void bulk_copy_g2s(uint32_t dst, const void* src,
                                              uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins accumulator registers in place around asynchronous wgmma: without
// it the compiler may move a read of the accumulator above the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Descriptor of a 128-byte-swizzled operand tile at shared address `addr`.
// K-major operands: sbo = bytes between 8-row groups (1024), lbo unused.
// MN-major operands: lbo = bytes between 64-element column blocks, sbo =
// bytes between groups of 8 contraction rows.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  uint64_t d = (uint64_t)((addr & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
  d |= (uint64_t)1 << 62;  // SWIZZLE_128B
  return d;
}

#define PST_D8(b)                                                     \
  "+f"(d[(b) + 0]), "+f"(d[(b) + 1]), "+f"(d[(b) + 2]),               \
      "+f"(d[(b) + 3]), "+f"(d[(b) + 4]), "+f"(d[(b) + 5]),           \
      "+f"(d[(b) + 6]), "+f"(d[(b) + 7])

// D[64x64] (+)= A[64x16] B[16x64]; A and B from shared memory, K-major.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32],
                                                   uint64_t da, uint64_t db,
                                                   int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : PST_D8(0), PST_D8(8), PST_D8(16), PST_D8(24)
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64x128] (+)= A[64x16] B[16x128]; A from registers (bf16x2 fragments
// as mma.m16n8k16's A, warp w of the warpgroup holding rows 16w..16w+15),
// B from shared memory: K-major (kTransB = 0) or MN-major (kTransB = 1,
// transposed: the 128 columns are contiguous).
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                    const uint32_t (&a)[4],
                                                    uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, "
      "1, %70;\n"
      "}\n"
      : PST_D8(0), PST_D8(8), PST_D8(16), PST_D8(24), PST_D8(32), PST_D8(40),
        PST_D8(48), PST_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(kTransB));
}

#undef PST_D8

// Start of dynamic shared memory rounded up to the 1024-byte swizzle atom
// (the launch asks for 1024 bytes more than the tiles need).
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  const uint32_t a = smem_u32(p);
  return p + ((1024 - (a & 1023)) & 1023);
}

}  // namespace pst_sm90
