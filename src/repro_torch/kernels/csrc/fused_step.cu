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
// weight, so bytes (1.04 GB of bf16 head at 3.35 TB/s: 0.31 ms) and the
// bf16 tensor rate (989 TF/s: 0.27 ms) give about the same least time.
// Only wgmma reaches that rate.
//
// Numerics: the oracle contracts f32(x) . f32(w). With bf16 x and head
// every product is exact in f32, so a bf16 wgmma accumulating in f32
// computes the same products; only the order of the f32 sums differs.
// The K loop is never split, so a logit's sums do not depend on the block
// shape, and nothing is atomic: the same inputs give the same bits.
//
// bf16 design (pass 1): head_wgmma.cuh's body with the bf16 head loader
// (Bf16Head) and the Partials epilogue, one x term: logits^T = W^T x^T,
// x the shared-memory B operand and the head tile the register A operand,
// both on a TMA/mbarrier ring; one K loop a block; the tile reduced in
// registers to one (max, sum, argmax) partial per (row, 128-column tile).
// The wrapper's plan picks the block's rows: 256, 128 or 64 (the fewest
// that hold R) x 128 columns, TMA where rows are 16-byte aligned.
// x is read again from L2 by each vocab tile's block: R*M*2 bytes a
// block, twice the head's own bytes at R = 256; on the H100 a build that
// skipped x's loads ran only a few percent faster, and one that skipped
// every load kept most of the time, so neither wider tiles nor a cluster
// sharing x by TMA multicast is taken: the products and the epilogue,
// not the loads, bound the block.
// Built for sm_90a (nvcc -Xptxas -v, as chip_smoke.py prints it), with
// TMA: 186 / 122 / 90 registers for the 256 x 128 / 128 x 128 /
// 64 x 128 blocks, tied or untied (plain loads: up to 200), no spill and
// no C751x warning; shared memory 193 / 193 / 97 KiB, so one, one or two
// blocks an SM.
//
// f32 design (fused_step_partial, the reduced models' path): a
// register-tiled FMA product on the CUDA cores, 64 rows x 128 columns a
// block, 4 x 8 a thread, the logit tile pushed from registers into the
// same accumulators, one partial per row and tile. Row tiles are the fast
// grid dimension in both bodies, so blocks that share a head tile run
// together and read it from L2. Pass 2 merges a row's tile partials
// order-free (smaller column wins an equal max) and applies the threshold
// or quota select.
//
// K6: the same epilogue with an int8 head.
//   q int8 [M, V] (untied) or [V, M] (tied), scale f32 [V] (one per vocab
//   channel); x [R, M] bf16 or f32 -> conf, tok, above as K3's.
// Replaces: repro/kernels/fused_step.py::quantized_fused_step_pallas
// (TPU), whose logit tiles stream the head as int8 and dequantize it in
// the epilogue stream.
// Numerics (its oracle, ref.quantized_fused_step_ref): logits = f32(x) .
// (f32(q) * scale[v]), contracted in f32. The port takes head_wgmma.cuh's
// body with the int8 loader (Int8Head): q converted to bf16 exactly in
// registers, x as one bf16 term (bf16 x: every product exact in f32) or
// three (f32 x, split first), the scale applied to each accumulator after
// the K loop; the oracle's function up to the order and rounding of the
// f32 sums. It shares that body and its block plan with K5's float32
// output, so at one R the two compute the same logits, bit for bit.
// Bound on the H100: at R = 256 the product is 2*R*M*V = 2.65e11
// operations over 0.52 GB of int8 head: 0.268 ms at the bf16 tensor rate
// (989 TF/s) for one term, 0.805 ms for three, against 0.155 ms for the
// bytes alone.
// Design: pass 1 is the body with the Partials epilogue (K3's), pass 2 is
// K3's finish.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "head_wgmma.cuh"
#include "softmax_acc.cuh"

namespace {

// ---------------------------------------------------------------------------
// f32 pass 1: CUDA-core FMAs
// ---------------------------------------------------------------------------

constexpr int kRT = 64;       // rows per block
constexpr int kVT = 128;      // vocab columns per block
constexpr int kKT = 32;       // depth per shared-memory stage
constexpr int kThreads = 256; // 16 x 16: 4 rows x 8 columns each

template <bool TIED>
__global__ void __launch_bounds__(kThreads)
fused_step_partial(const float* __restrict__ x, const float* __restrict__ w,
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
      xs[k][r] = (gr < R && gk < M) ? x[(size_t)gr * M + gk] : 0.f;
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
        val = TIED ? w[(size_t)gv * M + gk] : w[(size_t)gk * V + gv];
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

int launch_f32(const float* x, const float* w, int tied, void* pm,
               void* ps, void* pi, int R, int M, int V, cudaStream_t st) {
  dim3 grid((R + kRT - 1) / kRT, (V + kVT - 1) / kVT);
  if (tied) {
    fused_step_partial<true><<<grid, kThreads, 0, st>>>(
        x, w, static_cast<float*>(pm), static_cast<float*>(ps),
        static_cast<int*>(pi), R, M, V);
  } else {
    fused_step_partial<false><<<grid, kThreads, 0, st>>>(
        x, w, static_cast<float*>(pm), static_cast<float*>(ps),
        static_cast<int*>(pi), R, M, V);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16: `tile` and `tma` are the wrapper's plan; `ntiles` partials a row
// must be the vocab tiles of the body (V / head::kCols bf16, V / kVT f32,
// rounded up)
extern "C" int fused_step(const void* x, const void* w, const void* tau,
                          const void* masked, void* part_m, void* part_s,
                          void* part_i, void* conf, void* tok, void* above,
                          int R, int M, int V, int tied, int is_bf16,
                          int quota, int group, int tile, int tma,
                          int ntiles, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int cols = is_bf16 ? head::kCols : kVT;
  if (ntiles != (V + cols - 1) / cols)
    return static_cast<int>(cudaErrorInvalidValue);
  int err;
  if (is_bf16) {
    const head::bf16* xp = static_cast<const head::bf16*>(x);
    const head::Partials parts{static_cast<float*>(part_m),
                               static_cast<float*>(part_s),
                               static_cast<int*>(part_i)};
    err = static_cast<int>(
        tied ? head::launch<head::Bf16Head<true>, 1>(
                   tile, xp, w, nullptr, R, M, V, tma != 0, parts, st)
             : head::launch<head::Bf16Head<false>, 1>(
                   tile, xp, w, nullptr, R, M, V, tma != 0, parts, st));
  } else {
    err = launch_f32(static_cast<const float*>(x),
                     static_cast<const float*>(w), tied, part_m, part_s,
                     part_i, R, M, V, st);
  }
  if (err != 0) return err;
  return launch_finish(part_m, part_s, part_i, ntiles, tau, masked, conf,
                       tok, above, R, quota, group, st);
}

// K6: `tile` and `tma` are the wrapper's plan (three terms: 128 rows at
// most); f32 x needs `terms`, [3, R, M] bf16 of scratch
extern "C" int quantized_fused_step(const void* x, const void* q,
                                    const void* scale, void* terms,
                                    const void* tau, const void* masked,
                                    void* part_m, void* part_s, void* part_i,
                                    void* conf, void* tok, void* above,
                                    int R, int M, int V, int tied,
                                    int is_bf16, int quota, int group,
                                    int tile, int tma, int ntiles,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ntiles != (V + head::kCols - 1) / head::kCols)
    return static_cast<int>(cudaErrorInvalidValue);
  const head::Partials parts{static_cast<float*>(part_m),
                             static_cast<float*>(part_s),
                             static_cast<int*>(part_i)};
  const float* sp = static_cast<const float*>(scale);
  const int err = static_cast<int>(
      tied ? head::launch_x<head::Int8Head<true>>(tile, x, is_bf16 != 0,
                                                   terms, q, sp, R, M, V,
                                                   tma != 0, parts, st)
           : head::launch_x<head::Int8Head<false>>(tile, x, is_bf16 != 0,
                                                    terms, q, sp, R, M, V,
                                                    tma != 0, parts, st));
  if (err != 0) return err;
  return launch_finish(part_m, part_s, part_i, ntiles, tau, masked, conf,
                       tok, above, R, quota, group, st);
}
