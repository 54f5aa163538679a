// K7: flash attention, forward.
//   q [BH, S, D], k/v [BH, T, D] (B*H flattened, equal heads), bf16 or f32
//   -> o [BH, S, D] in the same dtype.
// Scores are (q . k) * (1 / sqrt(D)) in f32. With `causal`, key t is kept
// for query s where t <= s + q_offset and the others score -1e30, as the
// oracle fills them (a query that sees no key averages them all); keys
// t >= T do not exist and weigh 0. f32 softmax and output accumulation.
//
// Replaces: repro/kernels/flash_attention.py::flash_attention_pallas
// (TPU): the online-softmax forward, a grid of (batch*heads, query tiles,
// key tiles) with the running (max, sum, acc) carried in VMEM across the
// key tiles, every length padded to the 128-aligned tiles.
// Bound on the H100, at the timed shape [8, 32, 256, 128] bf16
// (LLaDA-8B's full forward at batch 8, prompt 128 + 128 new tokens): the
// kernel must read q, k, v and write o, 4 x 16.8 MB = 67.1 MB, 0.020 ms at
// 3.35 TB/s; its 4*B*H*S*T*D = 8.6e9 operations take 0.0087 ms at the
// bf16 tensor rate (989 TF/s). So bytes bound it; a causal mask halves
// the operations and not the bytes.
// bf16 design (flash_bf16): one block of 8 warps per (b*h, 128-query
// tile), each warp 16 query rows whose Q fragments stay in registers,
// the two query tiles of a head next to each other so the second reads
// the head's K/V from L2; each 64-key tile of K and V therefore serves
// 128 rows. K/V tiles come through a 3-stage cp.async ring (zero-filled
// past T), so the next two tiles load while this one is multiplied, with
// one barrier a tile. S = Q K^T and O += P V run on mma.sync m16n8k16
// (bf16 x bf16 -> f32; K fragments by ldmatrix, V by ldmatrix.trans); the
// online softmax runs in f32 in log2 units (exp2 of the scores scaled by
// log2(e) / sqrt(D)), P rounded to bf16 once as it is repacked from the
// S accumulators. A causal block stops at the last key its rows see,
// and a warp whose rows all see keys skips a tile that holds none of
// theirs. Ragged S and T are masked, never padded.
// Built for sm_90a (nvcc -Xptxas -v, as chip_smoke.py prints it): 220
// registers at D = 128, no spill, one block (8 warps) an SM, its ring
// 102 KiB. Stating the block's minimum of one an SM matters: without it
// ptxas held 196 registers and the kernel ran ~10% slower on the H100.
// What bounds it as built is its instruction stream, not its bytes: a
// variant that skipped the products and softmax ran well under one that
// skipped the K/V loads. Moving S = Q K^T onto wgmma (as FlashAttention-3
// does) is the next step; this body keeps mma.sync, whose fragments the
// online softmax and the P V product read in place.
// f32 operands take a CUDA-core FMA kernel (flash_f32: 16 query rows a
// block, 32 keys a tile, one key a lane), unchanged.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr float kMaskedScore = -1.0e30f;  // the oracle's fill for a masked
                                          // (existing) key
constexpr unsigned kFull = 0xffffffffu;

// first key past every key a block's query rows [q0, q0 + rows) see; a
// block whose first row sees no key attends all T keys (their scores tie
// at -1e30), so it must visit them all
__device__ __forceinline__ int key_end(int T, bool causal, int q0, int rows,
                                       int q_offset) {
  if (!causal || q0 + q_offset < 0) return T;
  return min(T, q0 + rows + q_offset);
}

// the score of key `key` for query `row`
__device__ __forceinline__ float masked_score(float s, int key, int row,
                                              int T, bool causal,
                                              int q_offset) {
  if (key >= T) return -INFINITY;
  if (causal && key > row + q_offset) return kMaskedScore;
  return s;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kWarps = 8;
constexpr int kQT = 16 * kWarps;  // query rows per block, 16 a warp
constexpr int kKT = 64;           // keys per tile
constexpr int kStages = 3;        // K/V tiles in the cp.async ring
constexpr int kBfThreads = 32 * kWarps;

template <int D>
struct FlashGeom {
  // row stride D + 8 bf16: rows stay 16-byte aligned, and the 8 rows an
  // ldmatrix phase reads hit distinct banks
  static constexpr int kLd = D + 8;
  static constexpr int kTile = kKT * kLd;  // bf16 elements of a K or V tile
  static constexpr size_t kSmem = sizeof(__nv_bfloat16) * kStages * 2 * kTile;
};

template <int D>
__global__ void __launch_bounds__(kBfThreads, 1)
flash_bf16(const __nv_bfloat16* __restrict__ q,
           const __nv_bfloat16* __restrict__ k,
           const __nv_bfloat16* __restrict__ v,
           __nv_bfloat16* __restrict__ o, int S, int T, int nq, bool causal,
           int q_offset, float scale_log2) {
  using Geo = FlashGeom<D>;
  constexpr int kLd = Geo::kLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x / nq;
  const int q0 = (blockIdx.x % nq) * kQT;
  const __nv_bfloat16* qb = q + (size_t)bh * S * D;
  const __nv_bfloat16* kb = k + (size_t)bh * T * D;
  const __nv_bfloat16* vb = v + (size_t)bh * T * D;
  const int w0 = q0 + warp * 16;  // this warp's first row
  const int r_lo = w0 + g, r_hi = r_lo + 8;

  const int kend = key_end(T, causal, q0, kQT, q_offset);
  const int ntiles = (kend + kKT - 1) / kKT;
  // tile `it` of K and V into its ring stage; keys past T are zero
  auto load_tile = [&](int it) {
    __nv_bfloat16* ks = ring + (it % kStages) * 2 * Geo::kTile;
    __nv_bfloat16* vs = ks + Geo::kTile;
    const int k0 = it * kKT;
    for (int e = tid; e < kKT * D / 8; e += kBfThreads) {
      const int r = e / (D / 8), c = (e % (D / 8)) * 8;
      const bool ok = k0 + r < T;
      const size_t off = (size_t)(ok ? k0 + r : 0) * D + c;
      cp_async_zfill16(&ks[r * kLd + c], kb + off, ok);
      cp_async_zfill16(&vs[r * kLd + c], vb + off, ok);
    }
  };
  // the first tiles go out before the Q fragments are read
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ntiles) load_tile(s);
    cp_async_commit_group();
  }

  // this warp's Q rows as A fragments, zero past S
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    qa[kk][0] = r_lo < S ? ld_pair(qb + (size_t)r_lo * D + c) : 0u;
    qa[kk][1] = r_hi < S ? ld_pair(qb + (size_t)r_hi * D + c) : 0u;
    qa[kk][2] = r_lo < S ? ld_pair(qb + (size_t)r_lo * D + c + 8) : 0u;
    qa[kk][3] = r_hi < S ? ld_pair(qb + (size_t)r_hi * D + c + 8) : 0u;
  }

  // scores in log2 units: s * scale * log2(e), so p = exp2(s - m)
  float m_lo = -INFINITY, m_hi = -INFINITY;  // running max of rows g, g+8
  float l_lo = 0.f, l_hi = 0.f;  // this thread's share of the running sum
  float oacc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait_group<kStages - 2>();  // tile `it` landed (own copies)
    __syncthreads();  // ... everyone's; tile it - 1 is read by all warps
    if (it + kStages - 1 < ntiles) load_tile(it + kStages - 1);
    cp_async_commit_group();
    const int k0 = it * kKT;
    // causal: a warp whose rows all see keys, none of them in this tile,
    // gains nothing from it (its scores would be -1e30 below a real max)
    if (causal && w0 + q_offset >= 0 && k0 > w0 + 15 + q_offset) continue;
    const __nv_bfloat16* ks = ring + (it % kStages) * 2 * Geo::kTile;
    const __nv_bfloat16* vs = ks + Geo::kTile;

    // S = Q K^T: 16 rows x 32 keys a warp, 4 chunks of 8 keys
    float sacc[kKT / 8][4];
#pragma unroll
    for (int j = 0; j < kKT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[j][e] = 0.f;
      if constexpr (D % 32 == 0) {
#pragma unroll
        for (int kk = 0; kk < D / 32; ++kk) {
          uint32_t kf[4];
          ldmatrix_x4(kf, &ks[(j * 8 + (lane & 7)) * kLd + kk * 32 +
                              (lane >> 3) * 8]);
          const uint32_t b0[2] = {kf[0], kf[1]}, b1[2] = {kf[2], kf[3]};
          mma_bf16(sacc[j], qa[2 * kk], b0);
          mma_bf16(sacc[j], qa[2 * kk + 1], b1);
        }
      } else {
        const __nv_bfloat16* p = &ks[(j * 8 + g) * kLd + 2 * t];
        const uint32_t b[2] = {ld_pair(p), ld_pair(p + 8)};
        mma_bf16(sacc[j], qa[0], b);
      }
    }

    // scale and mask; the tile's row max over the quad that holds a row
    float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
    for (int j = 0; j < kKT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + 2 * t + (e & 1);
        const float s = masked_score(sacc[j][e] * scale_log2, key,
                                     e < 2 ? r_lo : r_hi, T, causal,
                                     q_offset);
        sacc[j][e] = s;
        if (e < 2)
          mx_lo = fmaxf(mx_lo, s);
        else
          mx_hi = fmaxf(mx_hi, s);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(kFull, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(kFull, mx_hi, off));
    }
    // every tile holds a key < T, so the new max is finite
    const float c_lo = exp2f(m_lo - mx_lo), c_hi = exp2f(m_hi - mx_hi);
    m_lo = mx_lo;
    m_hi = mx_hi;
    l_lo *= c_lo;
    l_hi *= c_hi;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      oacc[n][0] *= c_lo;
      oacc[n][1] *= c_lo;
      oacc[n][2] *= c_hi;
      oacc[n][3] *= c_hi;
    }
#pragma unroll
    for (int j = 0; j < kKT / 8; ++j) {
      sacc[j][0] = exp2f(sacc[j][0] - m_lo);
      sacc[j][1] = exp2f(sacc[j][1] - m_lo);
      sacc[j][2] = exp2f(sacc[j][2] - m_hi);
      sacc[j][3] = exp2f(sacc[j][3] - m_hi);
      l_lo += sacc[j][0] + sacc[j][1];
      l_hi += sacc[j][2] + sacc[j][3];
    }

    // O += P V, 16 keys a step: P's accumulators repack into A fragments,
    // each probability rounded to bf16 once
#pragma unroll
    for (int kk = 0; kk < kKT / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(sacc[2 * kk][0], sacc[2 * kk][1]),
          pack_bf16(sacc[2 * kk][2], sacc[2 * kk][3]),
          pack_bf16(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1]),
          pack_bf16(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, &vs[(kk * 16 + (lane & 7) +
                                   ((lane >> 3) & 1) * 8) * kLd +
                                  (2 * n + (lane >> 4)) * 8]);
        const uint32_t b0[2] = {vf[0], vf[1]}, b1[2] = {vf[2], vf[3]};
        mma_bf16(oacc[2 * n], pa, b0);
        mma_bf16(oacc[2 * n + 1], pa, b1);
      }
    }
  }
  cp_async_wait_group<0>();

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_lo += __shfl_xor_sync(kFull, l_lo, off);
    l_hi += __shfl_xor_sync(kFull, l_hi, off);
  }
  const float inv_lo = 1.f / fmaxf(l_lo, 1e-30f);
  const float inv_hi = 1.f / fmaxf(l_hi, 1e-30f);
  __nv_bfloat16* ob = o + (size_t)bh * S * D;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + 2 * t;
    if (r_lo < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)r_lo * D + c) =
          __floats2bfloat162_rn(oacc[n][0] * inv_lo, oacc[n][1] * inv_lo);
    if (r_hi < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)r_hi * D + c) =
          __floats2bfloat162_rn(oacc[n][2] * inv_hi, oacc[n][3] * inv_hi);
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA-core FMAs
// ---------------------------------------------------------------------------

constexpr int kThreads = 128;
constexpr int kFQ = 16;      // query rows per block (4 warps x 4)
constexpr int kFK = 32;      // keys per tile: one a lane
constexpr int kFMaxD = 128;  // head dims: up to 4 a lane

__global__ void __launch_bounds__(kThreads)
flash_f32(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ o, int S, int T,
          int D, int nq, bool causal, int q_offset, float scale) {
  __shared__ float qs[kFQ][kFMaxD];
  __shared__ float ks[kFK][kFMaxD + 1];  // lane = key reads a column
  __shared__ float vs[kFK][kFMaxD];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x / nq;
  const int q0 = (blockIdx.x % nq) * kFQ;
  const float* qb = q + (size_t)bh * S * D;
  const float* kb = k + (size_t)bh * T * D;
  const float* vb = v + (size_t)bh * T * D;
  for (int e = tid; e < kFQ * D; e += kThreads) {
    const int r = e / D, d = e % D;
    qs[r][d] = q0 + r < S ? qb[(size_t)(q0 + r) * D + d] : 0.f;
  }

  float m[4], l[4], acc[4][4];  // rows warp*4 + i; dims lane + 32*jj
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) acc[i][jj] = 0.f;
  }

  const int kend = key_end(T, causal, q0, kFQ, q_offset);
  for (int k0 = 0; k0 < kend; k0 += kFK) {
    __syncthreads();  // the previous tile is read (and qs is staged)
    for (int e = tid; e < kFK * D; e += kThreads) {
      const int r = e / D, d = e % D;
      const bool ok = k0 + r < T;
      ks[r][d] = ok ? kb[(size_t)(k0 + r) * D + d] : 0.f;
      vs[r][d] = ok ? vb[(size_t)(k0 + r) * D + d] : 0.f;
    }
    __syncthreads();

    float p[4] = {0.f, 0.f, 0.f, 0.f};
    for (int d = 0; d < D; ++d) {
      const float kd = ks[lane][d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p[i] = fmaf(qs[warp * 4 + i][d], kd, p[i]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float s = masked_score(p[i] * scale, k0 + lane, q0 + warp * 4 + i,
                                   T, causal, q_offset);
      float mx = s, sum;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_new = fmaxf(m[i], mx);  // finite: the tile has a key
      const float corr = expf(m[i] - m_new);
      p[i] = expf(s - m_new);
      sum = p[i];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(kFull, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) acc[i][jj] *= corr;
    }
    for (int kk = 0; kk < kFK; ++kk) {
      float pk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pk[i] = __shfl_sync(kFull, p[i], kk);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int d = lane + 32 * jj;
        if (d < D) {
          const float vv = vs[kk][d];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[i][jj] = fmaf(pk[i], vv, acc[i][jj]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + warp * 4 + i;
    if (row >= S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int d = lane + 32 * jj;
      if (d < D)
        o[(size_t)bh * S * D + (size_t)row * D + d] = acc[i][jj] * inv;
    }
  }
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        int BH, int S, int T, bool causal, int q_offset,
                        float scale, cudaStream_t st) {
  constexpr size_t kSmem = FlashGeom<D>::kSmem;
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kSmem);
    if (e != cudaSuccess) return e;
    attr = true;
  }
  const int nq = (S + kQT - 1) / kQT;
  flash_bf16<D><<<BH * nq, kBfThreads, kSmem, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      S, T, nq, causal, q_offset, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

}  // namespace

// bf16 takes D in {16, 32, 64, 128}, f32 any D <= 128 (the wrapper checks)
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int BH, int S, int T, int D,
                               int causal, int q_offset, int is_bf16,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float scale = 1.f / sqrtf(static_cast<float>(D));
  if (is_bf16) {
    if (D == 16)
      return launch_bf16<16>(q, k, v, o, BH, S, T, causal, q_offset, scale,
                             st);
    if (D == 32)
      return launch_bf16<32>(q, k, v, o, BH, S, T, causal, q_offset, scale,
                             st);
    if (D == 64)
      return launch_bf16<64>(q, k, v, o, BH, S, T, causal, q_offset, scale,
                             st);
    if (D == 128)
      return launch_bf16<128>(q, k, v, o, BH, S, T, causal, q_offset, scale,
                              st);
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (D > kFMaxD) return static_cast<int>(cudaErrorInvalidValue);
    const int nq = (S + kFQ - 1) / kFQ;
    flash_f32<<<BH * nq, kThreads, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), S, T, D, nq,
        causal, q_offset, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
