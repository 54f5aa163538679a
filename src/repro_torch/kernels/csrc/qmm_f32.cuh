// The float32 int8-weight product kernel shared by the int8 matmul (K5's
// f32 path, the unfused head) and the int8-head fused step (K6), each
// with its own epilogue.
//
// A block of kQThreads threads computes one [kFM rows, kFN columns] tile
// of f32(x) [R, K] @ (f32(q) * scale), q int8 [K, N] with scale [N] (one
// per column) or, with TRANS, q int8 [N, K] with scale [N] (one per row
// of q). Each weight is dequantized once, in shared memory, for all the
// block's rows, as f32(q) * scale in one f32 multiply (never rounded to
// x's dtype); the contraction is CUDA-core f32 FMAs, no TF32. x may be
// float32 or bf16 and is widened to f32 as it is staged. Every offset is
// 64-bit; ragged R, K and N read as zeros.
//
// Thread (tx, ty) = (tid % 16, tid / 16) holds the 8 x 8 outputs at rows
// qmm_row(ty, i) and columns qmm_col(tx, j); its columns increase with j.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "softmax_acc.cuh"

constexpr int kQThreads = 256;
constexpr int kFM = 128;       // rows per block
constexpr int kFN = 128;       // columns per block
constexpr int kFK = 16;        // depth per stage
constexpr int kFLd = kFM + 4;  // smem row stride: staging writes spread
                               // over the banks, rows stay 16-byte aligned

__device__ __forceinline__ int qmm_row(int ty, int i) {
  return i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4;
}

__device__ __forceinline__ int qmm_col(int tx, int j) {
  return j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4;
}

// four int8 weights starting at p, any of them past `n_valid` read as 0;
// one 4-byte load when `vec` (the row is 4-aligned) and all four are valid
__device__ __forceinline__ char4 load_q4(const int8_t* __restrict__ p,
                                         int n_valid, bool vec) {
  if (vec && n_valid >= 4) return *reinterpret_cast<const char4*>(p);
  char4 v = make_char4(0, 0, 0, 0);
  if (n_valid > 0) v.x = p[0];
  if (n_valid > 1) v.y = p[1];
  if (n_valid > 2) v.z = p[2];
  if (n_valid > 3) v.w = p[3];
  return v;
}

// The kernel: one block per (kFM-row tile, kFN-column tile), row tiles
// the fast grid dimension so the blocks that share a weight tile run
// together and read it from L2. `vec`: every row of q starts 4-byte
// aligned (4-byte weight loads). The loop lives in the kernel itself and
// the caller's `Epilogue` (a functor taken by value) consumes the tile:
// an inlined device function holding the loop slowed the float32 head.
template <typename T, bool TRANS, typename Epilogue>
__global__ void __launch_bounds__(kQThreads)
qmm_f32(const T* __restrict__ x, const int8_t* __restrict__ q,
        const float* __restrict__ scale, int R, int K, int N, bool vec,
        Epilogue epilogue) {
  __shared__ __align__(16) float xs[kFK][kFLd];  // [k][row]
  __shared__ __align__(16) float ws[kFK][kFLd];  // [k][col]
  __shared__ float ss[kFN];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int r0 = blockIdx.x * kFM;
  const int n0 = blockIdx.y * kFN;
  if (tid < kFN) ss[tid] = n0 + tid < N ? scale[n0 + tid] : 0.f;
  __syncthreads();

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kFK) {
#pragma unroll
    for (int it = 0; it < kFM * kFK / kQThreads; ++it) {
      const int e = tid + it * kQThreads;
      const int r = e / kFK, k = e % kFK;
      const int gr = r0 + r, gk = k0 + k;
      xs[k][r] = (gr < R && gk < K) ? to_f32(x[(size_t)gr * K + gk]) : 0.f;
    }
    if (TRANS) {
#pragma unroll
      for (int it = 0; it < kFN * kFK / 4 / kQThreads; ++it) {
        const int e = tid + it * kQThreads;
        const int n = e / (kFK / 4), kk = (e % (kFK / 4)) * 4;
        const int gn = n0 + n, gk = k0 + kk;
        char4 v = make_char4(0, 0, 0, 0);
        if (gn < N) v = load_q4(q + (size_t)gn * K + gk, K - gk, vec);
        const float s = ss[n];
        ws[kk][n] = static_cast<float>(v.x) * s;
        ws[kk + 1][n] = static_cast<float>(v.y) * s;
        ws[kk + 2][n] = static_cast<float>(v.z) * s;
        ws[kk + 3][n] = static_cast<float>(v.w) * s;
      }
    } else {
#pragma unroll
      for (int it = 0; it < kFN * kFK / 4 / kQThreads; ++it) {
        const int e = tid + it * kQThreads;
        const int k = e / (kFN / 4), n = (e % (kFN / 4)) * 4;
        const int gn = n0 + n, gk = k0 + k;
        char4 v = make_char4(0, 0, 0, 0);
        if (gk < K) v = load_q4(q + (size_t)gk * N + gn, N - gn, vec);
        float4 w;
        w.x = static_cast<float>(v.x) * ss[n];
        w.y = static_cast<float>(v.y) * ss[n + 1];
        w.z = static_cast<float>(v.z) * ss[n + 2];
        w.w = static_cast<float>(v.w) * ss[n + 3];
        *reinterpret_cast<float4*>(&ws[k][n]) = w;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kFK; ++k) {
      float a[8], b[8];
      const float4 a0 = *reinterpret_cast<const float4*>(&xs[k][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&xs[k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&ws[k][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&ws[k][64 + tx * 4]);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  epilogue(acc, r0, n0, tx, ty, R, N);
}

template <typename T, bool TRANS, typename Epilogue>
void launch_qmm_f32(const T* x, const int8_t* q, const float* scale, int R,
                    int K, int N, Epilogue epilogue, cudaStream_t st) {
  // 4-byte weight loads need every row of q to start 4-aligned
  const bool vec = (TRANS ? K : N) % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(q) % 4 == 0;
  const dim3 grid((R + kFM - 1) / kFM, (N + kFN - 1) / kFN);
  qmm_f32<T, TRANS, Epilogue><<<grid, kQThreads, 0, st>>>(
      x, q, scale, R, K, N, vec, epilogue);
}
