// K1: cached block attention. The active block's queries attend the dense
// KV cache (NOT pre-written) plus the block's own fresh K/V,
// bidirectionally, with the block step's masks:
//   q [B, bs, H, D], cache k/v [B, T, Kh, D], block k/v [B, bs, Kh, D],
//   kv_pos [T] i32, scalars [5, B] i32 (slot, block_start, exc0, exc1,
//   kv_limit per row) -> out [B, bs, H, D]
// K4: the same over a paged cache: pool k/v [P, ps, Kh, D] and
//   page_table [B, n_log] i32 (-1 = unmapped) take the dense cache's place.
//
// Replaces: repro/kernels/block_attention.py::cached_block_attention_pallas
// (K1) and ::paged_block_attention_pallas (K4) (TPU; one body,
// _attn_kernel, with paged=True for K4; geometry _row_scalars).
// Bound on the H100: bytes. A block step reads each live cache row once
// (at the main path <= 33.5 MB of K/V per layer) and does 4*D operations
// per (query, key) pair, far below the 295 operations a byte where the
// tensor cores would become the limit.
// Design: one block per (row tile of 32 folded query rows, kv head, batch
// row). GQA folds the query group into rows (row r -> head kh*G + r/bs,
// position r%bs), so one kv head's tiles serve the whole group and K/V are
// read once per row tile. Cache tiles past the row's kv_limit are never
// loaded. Each 32-slot tile is staged in shared memory as f32; a warp owns
// 4 query rows and a lane one kv column, so the score, the online-softmax
// update (f32, finite -1e30 sentinel so a fully masked row ends with l > 0
// and output 0) and the P.V product need only warp shuffles. The fresh
// block enters as extra tiles after the cache; a sentinel slot + bs > T
// hides it. No tensor cores yet: that is for a later version.
// The two layouts share the body through the template parameter kPaged,
// which changes only where slot `id` of row b is read: dense at
// ((b*T + id)*Kh + kh)*D; paged through pp = page_table[b*n_log + id/ps]
// at ((pp*ps + id%ps)*Kh + kh)*D, an unmapped slot (pp < 0) loading zero
// and counting as invalid. A tile is not one page: a page may be any
// size, and n_log*ps >= T. With every page mapped, K4 gives K1's result
// on the gathered view bit for bit.
#include <cuda_runtime.h>

#include "softmax_acc.cuh"

namespace {

constexpr int kRows = 32;     // folded query rows per block
constexpr int kKT = 32;       // kv slots per tile (one per lane)
constexpr int kThreads = 256; // 8 warps x 4 rows
constexpr int kMaxND = 8;     // D <= 256
constexpr float kNegInf = -1.0e30f;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Offset of cache slot `id` of row b, kv head kh, or -1 when its page is
// unmapped. Dense: ck/cv are [B, T, Kh, D]; paged: pools [P, ps, Kh, D].
template <bool kPaged>
__device__ __forceinline__ long long slot_offset(
    const int* __restrict__ pt, int b, int id, int kh, int Kh, int D,
    int T_, int n_log, int ps) {
  if (kPaged) {
    const int pp = pt[b * n_log + id / ps];
    if (pp < 0) return -1;
    return (((long long)pp * ps + id % ps) * Kh + kh) * D;
  }
  return (((long long)b * T_ + id) * Kh + kh) * D;
}

template <typename T, bool kPaged>
__global__ void __launch_bounds__(kThreads)
block_attn(const T* __restrict__ q, const T* __restrict__ ck,
           const T* __restrict__ cv, const T* __restrict__ bk,
           const T* __restrict__ bv, const int* __restrict__ kv_pos,
           const int* __restrict__ pt, const int* __restrict__ sc,
           T* __restrict__ out, int B, int bs, int H, int Kh, int D, int T_,
           int n_log, int ps, int exclude, int window, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                    // [kRows][D]
  float* ks = qs + kRows * D;          // [kKT][D + 1]
  float* vs = ks + kKT * (D + 1);      // [kKT][D]

  const int b = blockIdx.z, kh = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  const int G = H / Kh, R = G * bs, ND = D / 32;
  const int slot = sc[0 * B + b], bstart = sc[1 * B + b];
  const int exc0 = sc[2 * B + b], exc1 = sc[3 * B + b];
  const int kvlim = sc[4 * B + b];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  for (int e = tid; e < kRows * D; e += kThreads) {
    const int r = e / D, d = e % D, gr = row0 + r;
    float val = 0.f;
    if (gr < R) {
      const int h = kh * G + gr / bs, s = gr % bs;
      val = to_f32(q[(((size_t)b * bs + s) * H + h) * D + d]);
    }
    qs[e] = val;
  }

  float m[4], l[4], acc[4][kMaxND];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int t = 0; t < kMaxND; ++t) acc[i][t] = 0.f;
  }

  // One online-softmax update over the staged tile; `valid` is this
  // lane's column (full mode: the mask depends on the kv side only).
  auto accumulate = [&](bool valid) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = warp * 4 + i;
      if (row0 + r >= R) continue;  // warp-uniform
      const float* qr = qs + r * D;
      const float* kc = ks + lane * (D + 1);
      float dot = 0.f;
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kc[d], dot);
      const float s = valid ? dot * scale : kNegInf;
      const float m_new = fmaxf(m[i], warp_max(s));
      const float p = expf(s - m_new);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + warp_sum(p);
      const float pv = valid ? p : 0.f;  // masked slots add nothing to acc
#pragma unroll
      for (int t = 0; t < kMaxND; ++t) acc[i][t] *= corr;
      for (int c = 0; c < kKT; ++c) {
        const float pc = __shfl_sync(0xffffffffu, pv, c);
        const float* vr = vs + c * D;
#pragma unroll
        for (int t = 0; t < kMaxND; ++t)
          if (t < ND) acc[i][t] = fmaf(pc, vr[lane + 32 * t], acc[i][t]);
      }
      m[i] = m_new;
    }
  };

  // cache tiles up to the row's kv_limit (dead tiles are never loaded)
  const int live = min(kvlim, T_);
  for (int t0 = 0; t0 < live; t0 += kKT) {
    __syncthreads();
    for (int e = tid; e < kKT * D; e += kThreads) {
      const int c = e / D, d = e % D, id = t0 + c;
      float kx = 0.f, vx = 0.f;
      if (id < T_) {
        const long long o = slot_offset<kPaged>(pt, b, id, kh, Kh, D, T_,
                                                n_log, ps);
        if (o >= 0) {
          kx = to_f32(ck[o + d]);
          vx = to_f32(cv[o + d]);
        }
      }
      ks[c * (D + 1) + d] = kx;
      vs[c * D + d] = vx;
    }
    __syncthreads();
    const int id = t0 + lane;
    bool valid = id < T_ && id < kvlim;
    const int pos = valid ? kv_pos[id] : -1;
    valid = valid && pos >= 0;
    if (kPaged) valid = valid && pt[b * n_log + id / ps] >= 0;
    // the slots the block virtually overwrites are stale: the block
    // operand serves them instead
    valid = valid && !(id >= slot && id < slot + bs);
    if (exclude) valid = valid && !(id >= exc0 && id < exc1);
    if (window) valid = valid && (bstart + bs - 1 - pos) < window;
    accumulate(valid);
  }

  // the fresh block's tiles; a sentinel slot (slot + bs > T) hides them
  const bool block_visible = slot + bs <= T_;
  for (int t0 = 0; t0 < bs; t0 += kKT) {
    __syncthreads();
    for (int e = tid; e < kKT * D; e += kThreads) {
      const int c = e / D, d = e % D, r = t0 + c;
      float kx = 0.f, vx = 0.f;
      if (r < bs) {
        const size_t o = (((size_t)b * bs + r) * Kh + kh) * D + d;
        kx = to_f32(bk[o]);
        vx = to_f32(bv[o]);
      }
      ks[c * (D + 1) + d] = kx;
      vs[c * D + d] = vx;
    }
    __syncthreads();
    const int r = t0 + lane;
    bool valid = r < bs && block_visible;
    if (exclude) valid = valid && !(slot + r >= exc0 && slot + r < exc1);
    if (window) valid = valid && (bs - 1 - r) < window;
    accumulate(valid);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = row0 + warp * 4 + i;
    if (gr >= R) continue;
    const int h = kh * G + gr / bs, s = gr % bs;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* o = out + (((size_t)b * bs + s) * H + h) * D;
#pragma unroll
    for (int t = 0; t < kMaxND; ++t)
      if (t < ND) from_f32(acc[i][t] * inv, o + lane + 32 * t);
  }
}

template <typename T, bool kPaged>
int launch(const void* q, const void* ck, const void* cv, const void* bk,
           const void* bv, const void* kv_pos, const void* pt,
           const void* sc, void* out, int B, int bs, int H, int Kh, int D,
           int T_, int n_log, int ps, int exclude, int window, float scale,
           cudaStream_t st) {
  const int R = (H / Kh) * bs;
  const size_t smem = sizeof(float) * (kRows * D + kKT * (D + 1) + kKT * D);
  cudaError_t err = cudaFuncSetAttribute(
      block_attn<T, kPaged>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((R + kRows - 1) / kRows, Kh, B);
  block_attn<T, kPaged><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(ck),
      static_cast<const T*>(cv), static_cast<const T*>(bk),
      static_cast<const T*>(bv), static_cast<const int*>(kv_pos),
      static_cast<const int*>(pt), static_cast<const int*>(sc),
      static_cast<T*>(out), B, bs, H, Kh, D, T_, n_log, ps, exclude, window,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int cached_block_attention(const void* q, const void* ck,
                                      const void* cv, const void* bk,
                                      const void* bv, const void* kv_pos,
                                      const void* scalars, void* out, int B,
                                      int bs, int H, int Kh, int D, int T,
                                      int exclude, int window, float scale,
                                      int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16, false>(q, ck, cv, bk, bv, kv_pos, nullptr,
                                        scalars, out, B, bs, H, Kh, D, T, 1,
                                        1, exclude, window, scale, st);
  return launch<float, false>(q, ck, cv, bk, bv, kv_pos, nullptr, scalars,
                              out, B, bs, H, Kh, D, T, 1, 1, exclude, window,
                              scale, st);
}

extern "C" int paged_block_attention(const void* q, const void* pool_k,
                                     const void* pool_v, const void* bk,
                                     const void* bv, const void* kv_pos,
                                     const void* page_table,
                                     const void* scalars, void* out, int B,
                                     int bs, int H, int Kh, int D, int T,
                                     int n_log, int ps, int exclude,
                                     int window, float scale, int is_bf16,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16, true>(q, pool_k, pool_v, bk, bv, kv_pos,
                                       page_table, scalars, out, B, bs, H,
                                       Kh, D, T, n_log, ps, exclude, window,
                                       scale, st);
  return launch<float, true>(q, pool_k, pool_v, bk, bv, kv_pos, page_table,
                             scalars, out, B, bs, H, Kh, D, T, n_log, ps,
                             exclude, window, scale, st);
}
