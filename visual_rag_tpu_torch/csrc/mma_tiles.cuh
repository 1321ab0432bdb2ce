// Warp-level tensor-core building blocks for the bf16 instances of K10's forward
// (flash_attention.cu), of B4 and B5 (flash_attention_bwd.cu) and for the pooled
// stage-1 (pooled_stage1.cu): mma.sync m16n8k16 in bf16 and in f16 with f32
// accumulation, ldmatrix (plain and .trans), cp.async with zero-fill, and the
// MUFU's 2^x. Each is one small device function over fragment
// registers, so that tools/cuda_emu.h can model it on the CPU:
// tools/emulate_kernels.py builds the kernels against that model in place of
// this header.
//
// Fragment layout of mma.m16n8k16 with bf16 operands (PTX ISA, "Matrix
// fragments for mma.m16n8k16", floating-point types). g = lane >> 2, t = lane &
// 3; a 32-bit register holds two bf16, the lower column (or row) in its low half.
//   A 16 x 16, row-major: a0 (row g, cols 2t, 2t+1), a1 (row g+8, cols 2t,
//     2t+1), a2 (row g, cols 2t+8, 2t+9), a3 (row g+8, cols 2t+8, 2t+9).
//   B 16 x 8, col-major: b0 (rows 2t, 2t+1, col g), b1 (rows 2t+8, 2t+9, col g).
//   C, D 16 x 8, f32: c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8, cols 2t,
//     2t+1).
// ldmatrix m8n8 (b16): lanes 8i..8i+7 give the row addresses of matrix i (16
// contiguous bytes each; .x2 reads lanes 0-15 only). Register i of lane (g, t)
// receives row g, columns 2t and 2t+1 of matrix i; with .trans, rows 2t and
// 2t+1 of column g.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

// d += a b on the tensor cores: one warp, A 16 x 16 and B 16 x 8 in bf16, D f32.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The same with f16 operands (the same fragment layout).
__device__ __forceinline__ void mma_f16_16816(float (&d)[4], const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 bf16 matrices from shared memory (row addresses as above).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// The same, each matrix transposed.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// Two 8 x 8 bf16 matrices, transposed (lanes 0-15 give the addresses).
__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// 16 bytes from global to shared memory, asynchronously; zeros where !full
// (src-size 0: nothing is read, but src must still be a valid address).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

// 4 bytes, the same way.
__device__ __forceinline__ void cp_async_4(void* dst, const void* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(full ? 4 : 0)
               : "memory");
}

// 4 bytes, of which the first `bytes` (0 to 4) are read and the rest zero-filled.
__device__ __forceinline__ void cp_async_4_partial(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// Closes this thread's group of copies issued since the last commit.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// 2^x on the MUFU unit alone (ex2.approx.ftz: relative error about 2^-22, results
// below 2^-126 flushed to 0, 2^-inf = 0); exp2f adds a range check and two scalings
// to keep such results subnormal.
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
