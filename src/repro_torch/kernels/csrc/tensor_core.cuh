// Tensor-core and asynchronous-copy primitives of the port's bfloat16
// kernels (flash_attention.cu, grouped_matmul.cu), one PTX instruction
// each: 16-byte cp.async copies from device to shared memory (zero-filled
// past the source bytes) and their commit/wait groups, ldmatrix loads of
// 8x8 b16 tiles (plain and transposed), and the warp-wide
// m16n8k16 bfloat16 MMA with float32 accumulation (mma.sync).
//
// Fragment layouts of mma.m16n8k16.row.col (lane = 4 * g + t):
//   A (16x16): a[0] = A[g][2t..2t+1],   a[1] = A[g+8][2t..2t+1],
//              a[2] = A[g][2t+8..2t+9], a[3] = A[g+8][2t+8..2t+9]
//   B (16x8):  b[0] = B[2t..2t+1][g],   b[1] = B[2t+8..2t+9][g]
//   C (16x8):  c[0..1] = C[g][2t..2t+1], c[2..3] = C[g+8][2t..2t+1]
// with the lower column (or row, for B) in the low 16 bits of a register.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace gs {

// Dynamic shared memory of the launch, 128-byte aligned.
template <typename T>
__device__ __forceinline__ T* dynamic_smem() {
  extern __shared__ __align__(128) unsigned char gs_dynamic_smem[];
  return reinterpret_cast<T*>(gs_dynamic_smem);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy 16 bytes device -> shared; only the first `src_bytes` (0 or 16) are
// read, the rest of the 16 are written as zeros.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 tiles; lanes 8i..8i+7 give the row addresses of tile i
// (shared-window addresses, see smem_addr, or generic pointers).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  ldmatrix_x4(r, smem_addr(p));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  ldmatrix_x4_trans(r, smem_addr(p));
}

// Two 8x8 b16 tiles; lanes 0..15 give the row addresses.
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p))
               : "memory");
}

// c += a * b on the tensor cores (bf16 inputs, f32 accumulation).
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4],
                                               const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 2^x by the special-function unit (flushes denormal results to zero).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two floats rounded to nearest-even bfloat16, `lo` in the low 16 bits.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace gs
