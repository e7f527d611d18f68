// Tensor-core and asynchronous-copy building blocks of the port's bf16
// kernels: 16-byte cp.async into shared memory (zero-filling what lies
// outside the tensor), ldmatrix fragments, mma.sync m16n8k16 with bf16
// operands and f32 accumulators, and the split of an f32 value into two
// bf16 terms.
//
// Fragment layout of mma.sync.m16n8k16 (lane l, g = l / 4, c = 2 * (l % 4)):
//   A (16 x 16, row-major):  a0 = A[g][c..c+1],   a1 = A[g+8][c..c+1],
//                            a2 = A[g][c+8..c+9], a3 = A[g+8][c+8..c+9]
//   B (16 x 8, "col"):       b0 = B[c..c+1][g],   b1 = B[c+8..c+9][g]
//   C/D (16 x 8, f32):       d0, d1 = D[g][c..c+1], d2, d3 = D[g+8][c..c+1]
// Two bf16 values share one 32-bit register, the lower column in the low
// half.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global `src` to shared `dst`, asynchronously; `src_bytes`
// below 16 zero-fills the rest (0: all zeros, nothing is read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// the same, each matrix transposed
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// d += A (16 x 16 bf16) * B (16 x 8 bf16), f32 accumulation
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x by the special-function unit (relative error ~2^-22; subnormal results
// flush to 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// x = hi + lo + e with hi = bf16(x), lo = bf16(x - hi): |e| <= 2^-9 |x - hi|
// <= 2^-17 |x| (x - hi is exact in f32).  A product of bf16 operands is
// exact in f32, so hi * b + lo * b on the tensor cores carries x * b to
// ~2^-17 relative.  Two values at a time, each result packed as one mma
// operand register.
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// the hi and lo A fragments of f32 values laid out as two adjacent C
// fragments (c0: columns 0-7, c1: columns 8-15 of a 16 x 16 tile)
__device__ __forceinline__ void split_a_frag(const float (&c0)[4], const float (&c1)[4],
                                             uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split_pair(c0[0], c0[1], hi[0], lo[0]);
  split_pair(c0[2], c0[3], hi[1], lo[1]);
  split_pair(c1[0], c1[1], hi[2], lo[2]);
  split_pair(c1[2], c1[3], hi[3], lo[3]);
}
