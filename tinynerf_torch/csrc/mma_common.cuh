// Tensor-core building blocks for Hopper (sm_90a): bf16 x bf16 products with
// float32 accumulation through mma.sync.m16n8k16, their operands loaded
// from shared memory with ldmatrix, and cp.async copies from global memory.
// Used by the bf16 forms of the field, grid and proposal kernels (field_tc.cuh,
// field_bwd_common.cuh, grid_common.cuh, prop_common.cuh).
//
// Fragments of one m16n8k16 product (PTX ISA, "Matrix Fragments for
// mma.m16n8k16"), g = lane / 4, t = lane % 4:
// - A (16 x 16, row): a[0] = A[g][2t, 2t+1], a[1] = A[g+8][2t, 2t+1],
//   a[2] = A[g][2t+8, 2t+9], a[3] = A[g+8][2t+8, 2t+9];
// - B (16 x 8, col): b[0] = B[2t, 2t+1][g], b[1] = B[2t+8, 2t+9][g];
// - C (16 x 8, f32): c[0], c[1] = C[g][2t, 2t+1], c[2], c[3] = C[g+8][...].
// Each register holds two bf16, the lower index in the low half.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices; lanes 8q .. 8q+7 give the row addresses of matrix
// q, and register q of lane l receives row l / 4, columns 2 (l % 4), +1 of
// matrix q (with .trans: column l / 4, rows 2 (l % 4), +1).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// Two matrices; lanes 0 .. 15 give the addresses.
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// c += A B: one m16n8k16 bf16 product with float32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += A0 B0 + A1 B1, two k16 steps summed on the tensor cores from zero and
// then added to c with a float32 add (rounded to nearest). Accumulating a
// long K in the tensor core (mma_bf16 into c) departs further from a
// float32 sum: each step aligns the products to the running sum and
// truncates their low bits.
__device__ __forceinline__ void mma_bf16_k32(float (&c)[4], const uint32_t (&a0)[4],
                                             uint32_t b00, uint32_t b01,
                                             const uint32_t (&a1)[4], uint32_t b10,
                                             uint32_t b11) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_bf16(t, a0, b00, b01);
  mma_bf16(t, a1, b10, b11);
#pragma unroll
  for (int q = 0; q < 4; ++q) c[q] += t[q];
}

// 16 bytes from global to shared memory, bypassing L1; with valid false
// the 16 bytes are zero-filled and nothing is read.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid = true) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(smem_addr(smem)), "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Two floats rounded to bf16 (round to nearest even), packed low then high.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace
