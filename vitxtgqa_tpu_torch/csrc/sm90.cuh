// Hopper (sm_90a) building blocks for the port's hand-written kernels:
// shared-memory addresses and the 128-byte swizzle, wgmma matrix
// descriptors, the wgmma fence / commit / wait and the products themselves
// (bf16 in, f32 accumulated in registers), cp.async copies with zero fill,
// the async-proxy fence, and ex2.approx.
//
// The shared-memory tiles these kernels feed to wgmma are rows of 64 bf16
// (128 bytes: one head row, or one 64-wide slice of a K dimension) in the
// 128-byte-swizzle layout: 16-byte chunk c of row r sits at byte r * 128 +
// ((c ^ (r % 8)) * 16) of a 1024-byte aligned tile, so eight rows make one
// swizzle atom.  The same tile serves as
//  - a K-major operand (A, or B of an A B^T product: the 64 elements of a
//    row are the reduction dimension), one k16 step 32 bytes further along
//    the row (the hardware applies the XOR to the address it computes), the
//    8-row groups 1024 bytes apart (SBO);
//  - an MN-major B operand (B of an A B product, the row index being the
//    reduction dimension: V in P V), transposed by the instruction's
//    trans-b bit, one k16 step 16 rows = 2048 bytes further, the 8-row
//    groups 1024 bytes apart (SBO); one 64-wide N block, so LBO is unused;
//  - an MN-major A operand in the same way (tnsp-a: dS^T in the flash
//    backward's dQ = dS K, the row index its reduction dimension).
#pragma once

#include <stdint.h>

namespace vt {
namespace sm90 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// byte offset of 16-byte chunk c (0..7) of row r in a 128-byte-swizzled tile
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return (uint32_t)(r * 128 + ((c ^ (r & 7)) << 4));
}

// wgmma matrix descriptor of a 128-byte-swizzled tile at shared address
// `addr`: start address (>> 4, 14 bits), LBO 16 bytes (unused by the
// swizzled layouts used here), SBO 1024 bytes, layout type 1 (128B swizzle)
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
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

// Tell the compiler that an accumulator register may change here: placed
// around the asynchronous products, so that no read or write of the
// register moves across the wgmma that owns it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define VT_R8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), \
                 "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B K-major from shared memory
// (descriptors); scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : VT_R8(0), VT_R8(8), VT_R8(16), VT_R8(24)
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 64] += A[64 x 16] B[16 x 64], A from registers (four bf16x2 per
// thread, the accumulator layout of a 64 x 16 slice), B MN-major from
// shared memory (transposed by the instruction)
__device__ __forceinline__ void wgmma_rs_n64_tb(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : VT_R8(0), VT_R8(8), VT_R8(16), VT_R8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], both MN-major from shared memory
// (transposed by the instruction's tnsp-a and tnsp-b bits): A stored as 16
// rows of its K dimension, each row the 64 M elements (128 bytes), B as
// rows of its K dimension holding the 64 N elements; one k16 step 16 rows
// = 2048 bytes further (the flash backward's dQ = dS K from dS^T and K)
__device__ __forceinline__ void wgmma_ss_n64_tatb(float (&d)[32], uint64_t da, uint64_t db,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 1, 1;\n}\n"
      : VT_R8(0), VT_R8(8), VT_R8(16), VT_R8(24)
      : "l"(da), "l"(db), "r"(scale_d));
}

#undef VT_R8

// 16-byte global -> shared copy, cache-global; zero-filled when !valid
// (then src must still be a mapped address)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// 4-byte copy (operands whose rows need not be 16-byte aligned)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// make this thread's completed generic-proxy shared-memory writes (the
// cp.async copies) visible to the async proxy that wgmma reads through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 2^x (ex2.approx.ftz: -inf -> +0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats -> one bf16x2 register, lo in the low half (round to nearest)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

}  // namespace sm90
}  // namespace vt
