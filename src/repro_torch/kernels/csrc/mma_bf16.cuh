// bf16 tensor-core building blocks shared by the int8 matmul kernel (K5)
// and the flash attention kernel (K7): mma.sync m16n8k16 (bf16 x bf16 ->
// f32) and its fragment loads from shared memory.
//
// Fragments of one warp (g = lane / 4, t = lane % 4): A (16 x 16, row
// major) a0 = A[g][2t, 2t+1], a1 = A[g+8][2t, 2t+1], a2 = A[g][2t+8, 2t+9],
// a3 = A[g+8][2t+8, 2t+9]; B (16 x 8) b0 = B[2t, 2t+1][g], b1 =
// B[2t+8, 2t+9][g]; C (16 x 8, f32) c0, c1 = C[g][2t, 2t+1], c2, c3 =
// C[g+8][2t, 2t+1]. A C fragment pair of neighbouring 8-column chunks
// packs into an A fragment as it lies.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// the k16 x n8 B fragment from a [k][col] tile: lanes 0-15 name the 16
// rows (k) of the 8 columns starting at `p`'s column; .trans hands each
// thread (k = 2t, 2t + 1; col g) and (k = 2t + 8, 2t + 9; col g)
__device__ __forceinline__ void ldmatrix_b_trans(uint32_t (&b)[2],
                                                 const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(b[0]), "=r"(b[1])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
