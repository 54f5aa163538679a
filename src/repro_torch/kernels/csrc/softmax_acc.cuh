// Running (max, sum-exp, argmax) accumulator shared by the confidence
// kernel and the fused-step kernel.
//
// Counterpart of softmax_acc_reset / softmax_acc_update in the reference's
// kernels/confidence.py. There the grid walks the vocab tiles in order on
// one core and the accumulator carries across them. Here blocks finish in
// no order, so every merge is order-free: the larger max wins, and on an
// equal max the SMALLER column wins, which is the first-occurrence argmax
// whatever order the partials arrive in.
#pragma once

#include <climits>
#include <cuda_bf16.h>
#include <math.h>

struct SoftmaxAcc {
  float m;  // running max
  float s;  // sum of exp(x - m)
  int idx;  // column of the first maximum
};

__device__ __forceinline__ SoftmaxAcc acc_init() {
  SoftmaxAcc a;
  a.m = -INFINITY;
  a.s = 0.f;
  a.idx = INT_MAX;
  return a;
}

// Push one element. A thread pushes its columns in increasing order, so a
// strict compare keeps the earlier column on a tie.
__device__ __forceinline__ void acc_push(SoftmaxAcc& a, float x, int col) {
  if (x > a.m) {
    a.s = a.s * expf(a.m - x) + 1.f;
    a.m = x;
    a.idx = col;
  } else if (x != -INFINITY) {
    a.s += expf(x - a.m);
  }
}

// Order-free merge of two partial accumulators.
__device__ __forceinline__ SoftmaxAcc acc_merge(SoftmaxAcc a, SoftmaxAcc b) {
  SoftmaxAcc r;
  r.m = fmaxf(a.m, b.m);
  if (r.m == -INFINITY) {
    r.s = 0.f;
  } else {
    r.s = a.s * expf(a.m - r.m) + b.s * expf(b.m - r.m);
  }
  if (a.m > b.m) {
    r.idx = a.idx;
  } else if (b.m > a.m) {
    r.idx = b.idx;
  } else {
    r.idx = min(a.idx, b.idx);
  }
  return r;
}

// Merge across `width` consecutive lanes (a power of two <= 32); every
// lane of the group ends with the group's result.
__device__ __forceinline__ SoftmaxAcc acc_shfl_reduce(SoftmaxAcc a,
                                                     int width) {
  for (int off = width / 2; off > 0; off >>= 1) {
    SoftmaxAcc o;
    o.m = __shfl_xor_sync(0xffffffffu, a.m, off, width);
    o.s = __shfl_xor_sync(0xffffffffu, a.s, off, width);
    o.idx = __shfl_xor_sync(0xffffffffu, a.idx, off, width);
    a = acc_merge(a, o);
  }
  return a;
}

// Final token of a merged accumulator: an all -inf row has no maximum and
// takes column 0, as argmax does.
__device__ __forceinline__ int acc_token(const SoftmaxAcc& a) {
  return a.idx == INT_MAX ? 0 : a.idx;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* out) {
  *out = __float2bfloat16(x);
}
