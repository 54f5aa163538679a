// K2: fused confidence, logits [R, V] f32 -> conf [R] f32, tok [R] i32:
// conf = 1 / sum_c exp(x[c] - max x), tok = the first column of the max.
//
// Replaces: repro/kernels/confidence.py::fused_confidence_pallas (TPU).
// Bound on the H100: bytes. It reads R*V*4 bytes once and does a few
// operations per element, so the least time is the logits over 3.35 TB/s:
// 0.0387 ms at the unfused Phase 2's [256, 126464], 0.0048 ms at Phase
// 1's [32, 126464].
// Design: one launch, no scratch in device memory.
// - The C CTAs that share a row form one thread-block cluster (C from
//   `plan` in kernels/confidence.py: 8 at R = 32, 2 at R = 256, so that
//   both fill the 132 SMs in one wave). Rank k streams the k-th of C
//   contiguous shares of the row's 16-byte vectors.
// - HBM rate needs bytes in flight: each thread issues kUnroll 16-byte
//   read-once loads (ld.global.nc.L1::no_allocate.v4) before it uses any,
//   64 KB a SM at four CTAs of 256 threads.
// - Few operations per element: a vector's max first, then one rescale
//   of the running sum per vector and the four exps with no branch (exp2
//   of the difference times log2 e). The argmax is the first column of
//   the max: a strict compare in column order inside a thread, the
//   smaller column on an equal max at every merge (`acc_merge`).
// - A row that does not start on 16 bytes (V % 4 != 0, or an unaligned
//   base) has up to three head columns, which rank 0 reads as scalars
//   before its vectors, and up to three tail columns after the last whole
//   vector, which rank C - 1 reads after its vectors.
// - Each CTA merges its threads' accumulators in two shuffle butterflies
//   (`acc_shfl_reduce`: lanes, then its warps' partials). After a
//   cluster barrier rank 0 reads the C partials from the cluster's shared
//   memory (distributed shared memory): their max and its first column
//   by shuffles, then the partial sums, each rescaled to that max, added
//   in rank order; it writes conf and tok. A second barrier keeps every
//   CTA's shared memory alive until rank 0 has read it. Every sum runs in
//   a fixed order, so every run gives the same bits.
#include <climits>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "softmax_acc.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kMaxCluster = 16;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float4 load_once(const float4* p) {
  float4 v;
  asm("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];\n"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p));
  return v;
}

// exp(x - m) as exp2 of the difference scaled by log2 e
__device__ __forceinline__ float exp_diff(float x, float m) {
  return exp2f((x - m) * kLog2e);
}

// Fold columns col .. col + 3 (in order) into the thread's accumulator:
// the vector's max, one rescale of the running sum, four exps, no branch.
// A max that stays -inf (every column so far -inf) leaves the sum at 0.
__device__ __forceinline__ void push4(SoftmaxAcc& a, float4 v, int col) {
  const float vm = fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w));
  const float m = fmaxf(a.m, vm);
  const float e = (exp_diff(v.x, m) + exp_diff(v.y, m)) +
                  (exp_diff(v.z, m) + exp_diff(v.w, m));
  const float s = fmaf(a.s, exp_diff(a.m, m), e);
  const int first = v.x == vm ? 0 : v.y == vm ? 1 : v.z == vm ? 2 : 3;
  a.idx = vm > a.m ? col + first : a.idx;
  a.s = m == -INFINITY ? a.s : s;
  a.m = m;
}

// the same for one column
__device__ __forceinline__ void push1(SoftmaxAcc& a, float x, int col) {
  const float m = fmaxf(a.m, x);
  const float s = fmaf(a.s, exp_diff(a.m, m), exp_diff(x, m));
  a.idx = x > a.m ? col : a.idx;
  a.s = m == -INFINITY ? a.s : s;
  a.m = m;
}

// grid: R * C CTAs in clusters of C (1-D); CTA (row, rank) at
// blockIdx.x = row * C + rank; at most 64 registers a thread, so that
// four CTAs fit on a SM (the plan's one wave)
__global__ void __launch_bounds__(kThreads, 4)
    confidence_cluster(const float* __restrict__ logits,
                       float* __restrict__ conf, int* __restrict__ tok,
                       int V) {
  const int C = static_cast<int>(cluster_ctas());
  const int rank = static_cast<int>(cluster_rank());
  const int row = blockIdx.x / C;
  const int t = threadIdx.x;
  const float* x = logits + (size_t)row * V;

  // columns before the first 16-byte boundary, whole vectors, the rest
  const int head = min(
      V, static_cast<int>((16 - (reinterpret_cast<uintptr_t>(x) & 15)) & 15) /
             4);
  const int nvec = (V - head) / 4;
  const int tail0 = head + 4 * nvec;
  const int share = (nvec + C - 1) / C;
  const int v0 = min(nvec, rank * share);
  const int v1 = min(nvec, v0 + share);
  const float4* xv = reinterpret_cast<const float4*>(x + head);

  SoftmaxAcc a = acc_init();
  if (rank == 0 && t < head) push1(a, x[t], t);
  for (int v = v0 + t; v < v1; v += kThreads * kUnroll) {
    float4 buf[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int vj = v + j * kThreads;
      buf[j] = vj < v1 ? load_once(xv + vj)
                       : make_float4(-INFINITY, -INFINITY, -INFINITY,
                                     -INFINITY);
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j)
      push4(a, buf[j], head + 4 * (v + j * kThreads));
  }
  if (rank == C - 1 && t < V - tail0) push1(a, x[tail0 + t], tail0 + t);

  // lanes, then warps, into this CTA's partial (butterflies)
  a = acc_shfl_reduce(a, 32);
  __shared__ SoftmaxAcc warp_acc[kThreads / 32];
  __shared__ SoftmaxAcc part;
  const int warp = t / 32, lane = t % 32;
  if (lane == 0) warp_acc[warp] = a;
  __syncthreads();
  if (warp == 0) {
    a = acc_shfl_reduce(lane < kThreads / 32 ? warp_acc[lane] : acc_init(),
                        kThreads / 32);
    if (lane == 0) part = a;
  }
  cluster_sync();

  // rank 0: lane k reads rank k's partial; the row's max and its first
  // column come from every lane, then lane 0 adds the partial sums, each
  // rescaled to that max, in rank order
  if (rank == 0 && warp == 0) {
    SoftmaxAcc p = acc_init();
    if (lane < C) {
      p.m = ld_cluster_f32(mapa_shared(smem_addr(&part.m), lane));
      p.s = ld_cluster_f32(mapa_shared(smem_addr(&part.s), lane));
      p.idx = ld_cluster_s32(mapa_shared(smem_addr(&part.idx), lane));
    }
    float m = p.m;
#pragma unroll
    for (int off = kMaxCluster / 2; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    int idx = p.m == m ? p.idx : INT_MAX;
#pragma unroll
    for (int off = kMaxCluster / 2; off > 0; off >>= 1)
      idx = min(idx, __shfl_xor_sync(0xffffffffu, idx, off));
    const float e = m == -INFINITY ? 0.f : p.s * exp_diff(p.m, m);
    float sum = e;
#pragma unroll
    for (int k = 1; k < kMaxCluster; ++k)
      sum += __shfl_sync(0xffffffffu, e, k);  // 0 past rank C - 1
    if (lane == 0) {
      conf[row] = 1.f / sum;
      tok[row] = idx == INT_MAX ? 0 : idx;
    }
  }
  __syncwarp();
  cluster_sync();
}

}  // namespace

// one launch of R clusters of `cluster` CTAs; conf and tok are the only
// memory it writes
extern "C" int fused_confidence(const void* logits, void* conf, void* tok,
                                int R, int V, int cluster, void* stream) {
  if (cluster < 1 || cluster > kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  // more than 8 CTAs a cluster is not portable: allow it once
  static bool large = false;
  cudaError_t err = cudaSuccess;
  if (!large) {
    err = cudaFuncSetAttribute(confidence_cluster,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    if (err != cudaSuccess) return static_cast<int>(err);
    large = true;
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(R * cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, confidence_cluster,
                           static_cast<const float*>(logits),
                           static_cast<float*>(conf), static_cast<int*>(tok),
                           V);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

