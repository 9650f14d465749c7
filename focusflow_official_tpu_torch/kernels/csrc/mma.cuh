// Warp-level tensor-core pieces shared by `attention.cu` (kernel E),
// `fold.cu` (kernel B), `lookup_fold.cu` and `local_corr.cu` (kernel D):
// `mma.sync.m16n8k16` on bf16 with f32 accumulators,
// `ldmatrix` to bring its operands out of shared memory, and `cp.async` to
// stage shared memory without passing through registers.
//
// Fragment layouts of m16n8k16 (PTX ISA, "Matrix fragments for mma.m16n8k16"),
// with g = lane / 4 and t = lane % 4, each register two bf16 (low half first):
//   A (16 x 16, row):  a0 (row g,     k 2t, 2t+1)   a1 (row g + 8, k 2t, 2t+1)
//                      a2 (row g,     k 2t+8, +9)   a3 (row g + 8, k 2t+8, +9)
//   B (16 x 8, col):   b0 (k 2t, 2t+1,   col g)     b1 (k 2t+8, 2t+9, col g)
//   C (16 x 8, f32):   c0, c1 (row g, col 2t, 2t+1) c2, c3 (row g + 8, same cols)
// `ldmatrix` hands lane l of 8x8 matrix i the values (row g, cols 2t, 2t+1)
// of the matrix whose eight 16-byte rows lanes 8i..8i+7 point at; `.trans`
// hands it (rows 2t, 2t+1, col g) instead. A matrix stored (n, k) row-major
// is therefore the B operand as it lies, and one stored (k, n) row-major is
// the B operand through `.trans`.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ffmma {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared past L1. `bytes` (16 or 0) of them are read from
// `src`, the rest of the 16 are written as zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(__cvta_generic_to_global(src)), "r"(bytes)
               : "memory");
}

// 8 bytes global -> shared through L1 (both 8-byte aligned)
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_u32(dst)),
               "l"(__cvta_generic_to_global(src))
               : "memory");
}

// 8 bytes global -> shared through L1 (both 8-byte aligned). `bytes` (8 or
// 0) of them are read from `src`, the rest of the 8 are written as zeros.
__device__ __forceinline__ void cp_async8(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_u32(dst)),
               "l"(__cvta_generic_to_global(src)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix l / 8
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// two 8x8 b16 matrices; lane l < 16 gives the address of row l % 8 of matrix l / 8
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// c += a (16 x 16) . b (16 x 8), bf16 in, f32 out
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 -> one register of two bf16, `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16(hi)) << 16);
}

// 2^x on the special-function unit; 2^-inf = 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace ffmma
