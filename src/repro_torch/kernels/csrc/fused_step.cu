// K3: fused denoising-step epilogue.
//   x [R, M] final-norm'd hidden, w [M, V] (untied head) or [V, M] (tied
//   embed table), tau [R] f32, masked [R] bool
//   -> conf [R] f32, tok [R] i32, above [R] bool
// above = masked & (conf > tau); with quota > 0, above is instead the
// top-`quota` of the masked confidences inside each group of `group`
// consecutive rows (one batch row's block), by stable descending rank.
//
// Replaces: repro/kernels/fused_step.py::fused_step_pallas (TPU), which
// streams lm-head logit tiles through the confidence accumulators so the
// [R, V] logits never reach device memory.
// Bound on the H100: at the main path's R = 256 rows the product is
// 2*R*M*V operations over the head's M*V weights, about 256 operations a
// weight, so bytes (1.04 GB of bf16 head at 3.35 TB/s) and the bf16 tensor
// rate (989 TF/s) give about the same least time, ~0.3 ms.
// Design (first, simple version): a register-tiled FMA product on the CUDA
// cores, no tensor cores yet, so it is bound by the f32 FMA rate (67 TF/s
// at best), not by either figure above. Each block computes a 64-row x
// 128-column logit tile in registers, pushes it straight into the shared
// (max, sum-exp, argmax) accumulator and writes one partial per row and
// tile; the logits never leave registers. Row tiles are the fast grid
// dimension so the blocks that share a head tile run together and read it
// from L2. Pass 2 merges a row's tile partials order-free (smaller column
// wins an equal max) and applies the threshold or quota select.
#include <cuda_runtime.h>

#include "softmax_acc.cuh"

namespace {

constexpr int kRT = 64;       // rows per block
constexpr int kVT = 128;      // vocab columns per block
constexpr int kKT = 32;       // depth per shared-memory stage
constexpr int kThreads = 256; // 16 x 16: 4 rows x 8 columns each

template <typename T, bool TIED>
__global__ void __launch_bounds__(kThreads)
fused_step_partial(const T* __restrict__ x, const T* __restrict__ w,
                   float* __restrict__ part_m, float* __restrict__ part_s,
                   int* __restrict__ part_i, int R, int M, int V) {
  __shared__ __align__(16) float xs[kKT][kRT + 4];
  __shared__ float ws[kKT][kVT + 1];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int r0 = blockIdx.x * kRT;
  const int v0 = blockIdx.y * kVT;

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < M; k0 += kKT) {
#pragma unroll
    for (int it = 0; it < kRT * kKT / kThreads; ++it) {
      const int e = tid + it * kThreads;
      const int r = e / kKT, k = e % kKT;
      const int gr = r0 + r, gk = k0 + k;
      xs[k][r] = (gr < R && gk < M) ? to_f32(x[(size_t)gr * M + gk]) : 0.f;
    }
#pragma unroll
    for (int it = 0; it < kVT * kKT / kThreads; ++it) {
      const int e = tid + it * kThreads;
      int k, v;
      if (TIED) {
        v = e / kKT;
        k = e % kKT;
      } else {
        k = e / kVT;
        v = e % kVT;
      }
      const int gv = v0 + v, gk = k0 + k;
      float val = 0.f;
      if (gv < V && gk < M) {
        val = TIED ? to_f32(w[(size_t)gv * M + gk])
                   : to_f32(w[(size_t)gk * V + gv]);
      }
      ws[k][v] = val;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kKT; ++k) {
      const float4 a4 = *reinterpret_cast<const float4*>(&xs[k][ty * 4]);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      float b[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = ws[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    SoftmaxAcc p = acc_init();
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = v0 + tx + 16 * j;
      if (col < V) acc_push(p, acc[i][j], col);
    }
    p = acc_shfl_reduce(p, 16);
    const int row = r0 + ty * 4 + i;
    if (tx == 0 && row < R) {
      const size_t o = (size_t)blockIdx.y * R + row;
      part_m[o] = p.m;
      part_s[o] = p.s;
      part_i[o] = p.idx;
    }
  }
}

// One block per group of `group` rows; quota ranks inside the group.
__global__ void fused_step_finish(const float* __restrict__ part_m,
                                  const float* __restrict__ part_s,
                                  const int* __restrict__ part_i, int ntiles,
                                  const float* __restrict__ tau,
                                  const unsigned char* __restrict__ masked,
                                  float* __restrict__ conf,
                                  int* __restrict__ tok,
                                  unsigned char* __restrict__ above, int R,
                                  int quota) {
  extern __shared__ float cm[];
  const int i = threadIdx.x;
  const int row = blockIdx.x * blockDim.x + i;
  const bool in_range = row < R;

  float c = 0.f;
  bool msk = false;
  if (in_range) {
    SoftmaxAcc a = acc_init();
    for (int t = 0; t < ntiles; ++t) {
      SoftmaxAcc p;
      p.m = part_m[(size_t)t * R + row];
      p.s = part_s[(size_t)t * R + row];
      p.idx = part_i[(size_t)t * R + row];
      a = acc_merge(a, p);
    }
    c = 1.f / a.s;
    msk = masked[row] != 0;
    conf[row] = c;
    tok[row] = acc_token(a);
  }
  if (quota > 0) {
    cm[i] = msk ? c : -INFINITY;
    __syncthreads();
    int rank = 0;
    for (int j = 0; j < (int)blockDim.x; ++j) {
      rank += (cm[j] > cm[i]) || (cm[j] == cm[i] && j < i);
    }
    if (in_range) above[row] = (rank < quota) && msk;
  } else if (in_range) {
    above[row] = msk && (c > tau[row]);
  }
}

template <typename T>
int launch(const void* x, const void* w, int tied, void* pm, void* ps,
           void* pi, int R, int M, int V, cudaStream_t st) {
  dim3 grid((R + kRT - 1) / kRT, (V + kVT - 1) / kVT);
  if (tied) {
    fused_step_partial<T, true><<<grid, kThreads, 0, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(w),
        static_cast<float*>(pm), static_cast<float*>(ps),
        static_cast<int*>(pi), R, M, V);
  } else {
    fused_step_partial<T, false><<<grid, kThreads, 0, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(w),
        static_cast<float*>(pm), static_cast<float*>(ps),
        static_cast<int*>(pi), R, M, V);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fused_step(const void* x, const void* w, const void* tau,
                          const void* masked, void* part_m, void* part_s,
                          void* part_i, void* conf, void* tok, void* above,
                          int R, int M, int V, int tied, int is_bf16,
                          int quota, int group, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = is_bf16
                ? launch<__nv_bfloat16>(x, w, tied, part_m, part_s, part_i,
                                        R, M, V, st)
                : launch<float>(x, w, tied, part_m, part_s, part_i, R, M, V,
                                st);
  if (err != 0) return err;
  const int ntiles = (V + kVT - 1) / kVT;
  fused_step_finish<<<(R + group - 1) / group, group,
                      group * sizeof(float), st>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_s),
      static_cast<const int*>(part_i), ntiles,
      static_cast<const float*>(tau),
      static_cast<const unsigned char*>(masked), static_cast<float*>(conf),
      static_cast<int*>(tok), static_cast<unsigned char*>(above), R, quota);
  return static_cast<int>(cudaGetLastError());
}
