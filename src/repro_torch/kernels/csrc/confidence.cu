// K2: fused confidence, logits [R, V] f32 -> conf [R] f32, tok [R] i32.
//
// Replaces: repro/kernels/confidence.py::fused_confidence_pallas (TPU).
// Bound on the H100: bytes. It reads R*V*4 bytes once and does a few
// operations per byte, so the least time is the logits over 3.35 TB/s.
// Design: one streaming pass. Pass 1 splits every row's vocab into
// `nsplit` contiguous chunks, one block each, so that a small R still
// fills the 132 SMs; each thread pushes its columns through the running
// (max, sum-exp, argmax) accumulator, coalesced across the block, and the
// block merges its threads' partials. Pass 2 merges a row's chunk partials
// (order-free: the smaller column wins an equal max) and writes
// conf = 1 / sum-exp and the first-occurrence argmax.
#include <cuda_runtime.h>

#include "softmax_acc.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void confidence_partial(const float* __restrict__ logits,
                                   float* __restrict__ part_m,
                                   float* __restrict__ part_s,
                                   int* __restrict__ part_i, int R, int V,
                                   int nsplit) {
  const int row = blockIdx.x / nsplit;
  const int split = blockIdx.x % nsplit;
  const int chunk = (V + nsplit - 1) / nsplit;
  const int c0 = split * chunk;
  const int c1 = min(V, c0 + chunk);
  const float* x = logits + (size_t)row * V;

  SoftmaxAcc a = acc_init();
  for (int c = c0 + threadIdx.x; c < c1; c += kThreads) {
    acc_push(a, x[c], c);
  }
  a = acc_shfl_reduce(a, 32);

  __shared__ SoftmaxAcc warp_acc[kThreads / 32];
  const int warp = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0) warp_acc[warp] = a;
  __syncthreads();
  if (threadIdx.x == 0) {
    SoftmaxAcc r = warp_acc[0];
    for (int w = 1; w < kThreads / 32; ++w) r = acc_merge(r, warp_acc[w]);
    const size_t o = (size_t)split * R + row;
    part_m[o] = r.m;
    part_s[o] = r.s;
    part_i[o] = r.idx;
  }
}

__global__ void confidence_finish(const float* __restrict__ part_m,
                                  const float* __restrict__ part_s,
                                  const int* __restrict__ part_i,
                                  float* __restrict__ conf,
                                  int* __restrict__ tok, int R, int nsplit) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= R) return;
  SoftmaxAcc a = acc_init();
  for (int s = 0; s < nsplit; ++s) {
    SoftmaxAcc p;
    p.m = part_m[(size_t)s * R + row];
    p.s = part_s[(size_t)s * R + row];
    p.idx = part_i[(size_t)s * R + row];
    a = acc_merge(a, p);
  }
  conf[row] = 1.f / a.s;
  tok[row] = acc_token(a);
}

}  // namespace

extern "C" int fused_confidence(const void* logits, void* part_m,
                                void* part_s, void* part_i, void* conf,
                                void* tok, int R, int V, int nsplit,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  confidence_partial<<<R * nsplit, kThreads, 0, st>>>(
      static_cast<const float*>(logits), static_cast<float*>(part_m),
      static_cast<float*>(part_s), static_cast<int*>(part_i), R, V, nsplit);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  confidence_finish<<<(R + 127) / 128, 128, 0, st>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_s),
      static_cast<const int*>(part_i), static_cast<float*>(conf),
      static_cast<int*>(tok), R, nsplit);
  return static_cast<int>(cudaGetLastError());
}
