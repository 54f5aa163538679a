// bf16 tensor-core building blocks shared by the block attention kernels
// (K1, K4), the flash attention kernel (K7) and the int8 matmul kernel
// (K5, whose wgmma A fragments are mma.sync's): mma.sync m16n8k16 (bf16 x
// bf16 -> f32), its fragment loads from shared memory, and the cp.async
// copies that fill shared memory.
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the B fragments of two k16 steps and 8 columns from a [col][k] tile
// (e.g. a K tile [key][d] for S = Q K^T): lane l passes the address of
// column (l & 7) at k offset 8 (l >> 3) from the first step's start;
// b[0], b[1] are the first step's b0, b1 and b[2], b[3] the second's
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&b)[4],
                                            const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
      : "r"(smem_addr(p)));
}

// the k16 x n8 B fragments of two neighbouring 8-column chunks from a
// [k][col] tile (e.g. a V tile [key][d] for O += P V): lane l passes the
// address of row (l & 7) + 8 ((l >> 3) & 1) at column offset 8 (l >> 4)
// from the first chunk's start; b[0], b[1] serve the first chunk and
// b[2], b[3] the second
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&b)[4],
                                                  const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
      : "r"(smem_addr(p)));
}

// the pair (a, b) as two bf16 pairs, t[0] + t[1]: t[0] = bf16(x) and
// t[1] = bf16(x - bf16(x)) (a difference f32 holds exactly) keep ~16
// significant bits of x where one bf16 rounding keeps 8, so two
// products, one with each term, carry an f32 operand through a bf16 mma
// that far
__device__ __forceinline__ void split_bf16(uint32_t (&t)[2], float a,
                                           float b) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
    t[i] = *reinterpret_cast<const uint32_t*>(&v);
    a -= __low2float(v);
    b -= __high2float(v);
  }
}

// 16 bytes global -> shared, asynchronously; zero-filled (nothing read
// from `src`) when !valid. `src` must be 16-byte aligned.
__device__ __forceinline__ void cp_async_zfill16(void* dst, const void* src,
                                                 bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit_group() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
