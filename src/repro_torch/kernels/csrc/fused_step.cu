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
//
// K6: the same epilogue with an int8 head.
//   q int8 [M, V] (untied) or [V, M] (tied), scale f32 [V] (one per vocab
//   channel); x [R, M] bf16 or f32 -> conf, tok, above as K3's.
// Replaces: repro/kernels/fused_step.py::quantized_fused_step_pallas
// (TPU), whose logit tiles stream the head as int8 and dequantize it in
// the epilogue stream.
// Numerics (its oracle, ref.quantized_fused_step_ref): logits = f32(x) .
// (f32(q) * scale[v]), the weight dequantized in f32 with one multiply and
// never rounded to x's dtype, contracted in f32 on CUDA-core FMAs (no
// TF32): the unfused int8 epilogue's arithmetic up to the order of sums.
// Bound on the H100: at R = 256 the product is 2*R*M*V = 2.65e11 f32
// operations over 0.52 GB of int8 head; at the f32 FMA rate (67 TF/s)
// that is 3.96 ms (operations), against 0.155 ms for the bytes alone.
// Design (first, simple version): pass 1 takes the int8 matmul's float32
// tile body (qmm_f32.cuh: 128 x 128 outputs a block, 8 x 8 a thread,
// each weight dequantized once in shared memory) and, instead of storing
// the tile, pushes it into the (max, sum-exp, argmax) accumulator and
// writes K3's per-(row, vocab tile) partials; pass 2 is K3's finish. No
// wgmma or TMA: neither takes an f32 FMA contraction.
#include <cuda_runtime.h>

#include "qmm_f32.cuh"
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

// Pass 2: `lanes` threads merge each row's tile partials (a strided loop,
// then a shuffle reduce), one block per group of `rows` rows; quota ranks
// inside the group. A row's partials are many (988 at LLaDA-8B's vocab),
// so one thread a row would leave the pass latency-bound on two blocks.
__global__ void fused_step_finish(const float* __restrict__ part_m,
                                  const float* __restrict__ part_s,
                                  const int* __restrict__ part_i, int ntiles,
                                  const float* __restrict__ tau,
                                  const unsigned char* __restrict__ masked,
                                  float* __restrict__ conf,
                                  int* __restrict__ tok,
                                  unsigned char* __restrict__ above, int R,
                                  int quota, int rows, int lanes) {
  extern __shared__ float cm[];
  const int lane = threadIdx.x % lanes;
  const int i = threadIdx.x / lanes;  // row in the group (or past it)
  const int row = blockIdx.x * rows + i;
  const bool in_range = i < rows && row < R;

  SoftmaxAcc a = acc_init();
  if (in_range) {
    for (int t = lane; t < ntiles; t += lanes) {
      SoftmaxAcc p;
      p.m = part_m[(size_t)t * R + row];
      p.s = part_s[(size_t)t * R + row];
      p.idx = part_i[(size_t)t * R + row];
      a = acc_merge(a, p);
    }
  }
  a = acc_shfl_reduce(a, lanes);  // every lane of the warp takes part
  const bool lead = in_range && lane == 0;
  const float c = 1.f / a.s;
  const bool msk = lead && masked[row] != 0;
  if (lead) {
    conf[row] = c;
    tok[row] = acc_token(a);
  }
  if (quota > 0) {
    if (lane == 0 && i < rows) cm[i] = msk ? c : -INFINITY;
    __syncthreads();
    if (lead) {
      int rank = 0;
      for (int j = 0; j < rows; ++j) {
        rank += (cm[j] > cm[i]) || (cm[j] == cm[i] && j < i);
      }
      above[row] = (rank < quota) && msk;
    }
  } else if (lead) {
    above[row] = msk && (c > tau[row]);
  }
}

// K6 pass 1: qmm_f32.cuh's kernel, each 128-row x 128-column logit tile
// pushed from registers into the accumulators, one partial per (row,
// vocab tile)
struct FusedStepPartials {
  float* __restrict__ part_m;
  float* __restrict__ part_s;
  int* __restrict__ part_i;

  __device__ __forceinline__ void operator()(const float (&acc)[8][8],
                                             int r0, int v0, int tx, int ty,
                                             int R, int V) const {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      SoftmaxAcc p = acc_init();
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = v0 + qmm_col(tx, j);
        if (col < V) acc_push(p, acc[i][j], col);
      }
      p = acc_shfl_reduce(p, 16);
      const int row = r0 + qmm_row(ty, i);
      if (tx == 0 && row < R) {
        const size_t o = (size_t)blockIdx.y * R + row;
        part_m[o] = p.m;
        part_s[o] = p.s;
        part_i[o] = p.idx;
      }
    }
  }
};

template <typename T>
int launch_quantized(const void* x, const void* q, const void* scale,
                     int tied, void* pm, void* ps, void* pi, int R, int M,
                     int V, cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  const int8_t* qp = static_cast<const int8_t*>(q);
  const float* sp = static_cast<const float*>(scale);
  const FusedStepPartials partials{static_cast<float*>(pm),
                                   static_cast<float*>(ps),
                                   static_cast<int*>(pi)};
  if (tied)
    launch_qmm_f32<T, true>(xp, qp, sp, R, M, V, partials, st);
  else
    launch_qmm_f32<T, false>(xp, qp, sp, R, M, V, partials, st);
  return static_cast<int>(cudaGetLastError());
}

// pass 2 over ntiles partials a row, `group` rows a block: up to 32
// lanes a row, fewer where a large quota group must fit 1024 threads
int launch_finish(const void* part_m, const void* part_s, const void* part_i,
                  int ntiles, const void* tau, const void* masked, void* conf,
                  void* tok, void* above, int R, int quota, int group,
                  cudaStream_t st) {
  int lanes = 32;
  while (lanes > 1 && group * lanes > 1024) lanes /= 2;
  const int threads = (group * lanes + 31) / 32 * 32;
  fused_step_finish<<<(R + group - 1) / group, threads,
                      group * sizeof(float), st>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_s),
      static_cast<const int*>(part_i), ntiles,
      static_cast<const float*>(tau),
      static_cast<const unsigned char*>(masked), static_cast<float*>(conf),
      static_cast<int*>(tok), static_cast<unsigned char*>(above), R, quota,
      group, lanes);
  return static_cast<int>(cudaGetLastError());
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
  return launch_finish(part_m, part_s, part_i, (V + kVT - 1) / kVT, tau,
                       masked, conf, tok, above, R, quota, group, st);
}

extern "C" int quantized_fused_step(const void* x, const void* q,
                                    const void* scale, const void* tau,
                                    const void* masked, void* part_m,
                                    void* part_s, void* part_i, void* conf,
                                    void* tok, void* above, int R, int M,
                                    int V, int tied, int is_bf16, int quota,
                                    int group, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = is_bf16 ? launch_quantized<__nv_bfloat16>(
                          x, q, scale, tied, part_m, part_s, part_i, R, M,
                          V, st)
                    : launch_quantized<float>(x, q, scale, tied, part_m,
                                              part_s, part_i, R, M, V, st);
  if (err != 0) return err;
  return launch_finish(part_m, part_s, part_i, (V + kFN - 1) / kFN, tau,
                       masked, conf, tok, above, R, quota, group, st);
}
