// The lm-head product body shared by the fused step (K3 on a bf16 head,
// K6 on an int8 head) and the int8 matmul's float32 output (K5's head):
// one TMA/mbarrier wgmma K loop, a head loader (bf16 or int8) and an
// epilogue (per-tile softmax partials, or the f32 logits stored).
//
// Orientation (K5's): the block computes logits^T = W^T x^T. Its ROWS
// rows of x are one wgmma's N (m64nROWSk16) and each warpgroup's 64 vocab
// columns its M. x is the shared-memory B operand, K-major as it lies; the
// head tile is the register A operand, so a tied head [V, M] (K-major) and
// an untied one [M, V] (V-major) differ only in how their tiles reach the
// A fragments, which is the loader's part:
//   - Bf16Head (K3): ldmatrix on the tied tile, ldmatrix.trans on the
//     untied one.
//   - Int8Head: the raw int8 tile; ldmatrix.trans hands an untied tile's
//     thread the bytes of columns 2g, 2g + 1 at k, k + 1 (A row g is
//     column 2g, row g + 8 column 2g + 1); a tied tile's rows are read as
//     16-bit k pairs (A row g is column g). Each byte becomes f32(q)
//     exactly by a byte permute and a subtract, then bf16(f32(q)), exact
//     since |q| <= 128. No scale is folded in: the per-channel scale
//     multiplies each accumulator once, after the K loop, in f32.
// So with bf16 x every product x . q is exact in f32, and the logits are
// the oracle's f32(x) . (f32(q) * scale) up to the order and rounding of
// the f32 sums (the scale after the sum instead of on each weight).
//
// x's terms: bf16 x is one term. f32 x is three bf16 terms [3][R][M],
// hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid), written by
// split_terms; each difference is exact in f32 and the three rebuild x.
// Each stage issues the lo and mid products (in that order) into a second
// accumulator and the hi products into the first; the two are added once
// after the K loop. With one accumulator for all three, a tensor-core
// adder that truncates would round the large running sum three times a
// step, which emulated at K = 12288 misses the float32 bound (1e-4 rms;
// tests/test_torch_head_numerics.py); the small terms' own accumulator
// keeps the three-term body at the one-term body's error.
//
// The K loop: thread 0 keeps kStages - 2 64-deep stages in flight on a
// kStages ring: TMA copies the x terms (ROWS x 64 bf16 each, 128-byte
// swizzle) and the head tile onto one mbarrier; each warp frees a stage on
// a second one. A warpgroup queues a stage's wgmma behind the previous
// stage's group and waits for that group only, whose A registers it then
// refills from the next stage (A registers an unfinished wgmma may read
// are never written). Where x's or the head's rows are not 16-byte
// aligned the warps fill one stage at a time by plain loads into the same
// layouts (template parameter TMA). The K loop is never split, so a
// logit's sums do not depend on the block shape, and nothing is atomic:
// the same inputs give the same bits.
//
// Blocks: ROWS rows of x (256, 128 or 64: the wrapper's plan, by R; three
// terms take at most 128, whose stage of 56 KiB fits four in shared
// memory) x kCols = 128 vocab columns (2 warpgroups); row tiles are the
// fast grid dimension, so blocks that share a head tile run together and
// read it from L2. Ragged R, M and V read as zeros (TMA fills outside the
// tensor), and every offset is 64-bit.
//
// Epilogues (after the K loop, on the ring's shared memory):
//   - Partials (K3, K6): each row's (max, first column, sum of exp(x -
//     max)) over the tile, by xor-shuffles over a warp's 8 lanes g, then
//     across the warps through shared memory (acc_merge); columns >= V
//     count as -inf, rows >= R are never written. One partial per (row,
//     vocab tile) goes to fused_step_finish, so the logits never reach
//     device memory.
//   - StoreF32 (K5's head): the tile staged in shared memory as [ROWS]
//     [kCols + 4] f32, then stored as whole rows of x, 16 bytes a lane.
//
// Bound on the H100 (K6 and K5's head at the main path's R = 256 on
// LLaDA-8B's [4096, 126464] head): 2*R*M*V = 2.65e11 products, one bf16
// tensor-core operation each per term: 0.268 ms at 989 TF/s with one
// term, 0.805 ms with three, against 0.155 ms to stream the 0.52 GB int8
// head. Only wgmma reaches the rate.
// Built for sm_90a (nvcc -Xptxas -v, as chip_smoke.py prints it), with
// TMA, untied or tied: one term 186-204 / 122-124 / 90-92 registers for
// the 256 / 128 / 64-row blocks (K3 186, K6 192, K5's store 204 at 256 x
// 128), three terms 191-193 / 122-124 for 128 / 64 rows; plain loads up
// to 226; no C751x line; no spill but 4 bytes in one plain-load variant
// (the untied 64-row one-term store).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"
#include "mma_bf16.cuh"
#include "softmax_acc.cuh"

namespace head {

using bf16 = __nv_bfloat16;

constexpr int kBK = 64;             // depth per stage: one 128-byte bf16 row
constexpr int kWG = 2;              // warpgroups a block, 64 columns each
constexpr int kCols = 64 * kWG;     // vocab columns a block
constexpr int kThreads = 128 * kWG;
constexpr int kSmemMax = 232448;    // dynamic shared memory of one block

// the byte offset of element c of row r in a tile of 128-byte bf16 rows
// with TMA's 128-byte swizzle: 16-byte chunk c / 8 of row r lies at chunk
// (c / 8) ^ (r % 8)
__device__ __forceinline__ int swz(int r, int c) {
  return r * 128 + ((((c >> 3) ^ (r & 7))) << 4) + (c & 7) * 2;
}

// byte i of u (whose bytes hold q + 128, i.e. q ^ 0x80) as f32(q):
// 0x4B0000xx is the float 2^23 + xx, exactly
__device__ __forceinline__ float q_byte(uint32_t u, int i) {
  return __int_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | i)) -
         8388736.f;
}

// bf16(f32(q)) of bytes lo | hi << 16 of u: exact, |q| <= 128
__device__ __forceinline__ uint32_t q_pair(uint32_t u, int lo, int hi) {
  return pack_bf16(q_byte(u, lo), q_byte(u, hi));
}

// ---------------------------------------------------------------------------
// head loaders: one stage's head tile (64 k x kCols vocab columns)
// ---------------------------------------------------------------------------

// bf16 head: untied [M, V] as kWG sub-tiles [64 k][64 columns], tied
// [V, M] as one [kCols columns][64 k]; 128-byte swizzle
template <bool TIED>
struct Bf16Head {
  using W = bf16;
  static constexpr int kBytes = kCols * kBK * 2;
  static constexpr bool kScaled = false;

  // the vocab column, within its warp's 16, of A row g + 8 h
  __device__ static __forceinline__ int col(int g, int h) { return g + 8 * h; }

  __device__ static __forceinline__ void tma(uint8_t* wt, const void* map,
                                             uint64_t* bar, int v0, int k0) {
    if (TIED) {
      tma_load_2d(wt, map, bar, k0, v0);
    } else {
#pragma unroll
      for (int c = 0; c < kWG; ++c)
        tma_load_2d(wt + c * 8192, map, bar, v0 + 64 * c, k0);
    }
  }

  __device__ static __forceinline__ void plain(uint8_t* wt,
                                               const W* __restrict__ w,
                                               int M, int V, int v0, int k0,
                                               int tid) {
    const bf16 zero = __float2bfloat16_rn(0.f);
    for (int e = tid; e < kCols * kBK; e += kThreads) {
      if (TIED) {
        const int v = e >> 6, k = e & 63;
        const int gv = v0 + v, gk = k0 + k;
        *reinterpret_cast<bf16*>(wt + swz(v, k)) =
            gv < V && gk < M ? w[(size_t)gv * M + gk] : zero;
      } else {
        const int k = e / kCols, v = e % kCols;
        const int gk = k0 + k, gv = v0 + v;
        *reinterpret_cast<bf16*>(wt + (v >> 6) * 8192 + swz(k, v & 63)) =
            gk < M && gv < V ? w[(size_t)gk * V + gv] : zero;
      }
    }
  }

  // The A operand (warp w's 16 columns x 16 k) of the four 16-deep steps
  // of a stage. Lane l addresses row l % 8 of 8 x 8 matrix i = l / 8: a0
  // (columns 0-7, k 0-7), a1 (columns 8-15, k 0-7), a2 (columns 0-7, k
  // 8-15), a3 (columns 8-15, k 8-15). Tied: the tile is [column][k], so
  // A's rows are its rows (ldmatrix); untied: [k][column], so
  // ldmatrix.trans hands thread (g, t) column g at k 2t, 2t + 1.
  __device__ static __forceinline__ void load_a(uint32_t (&a)[4][4],
                                                const uint8_t* wt, int cw,
                                                int w, int lane) {
    const int i = lane >> 3, r = lane & 7;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (TIED) {
        const int v = 64 * cw + 16 * w + r + 8 * (i & 1);
        ldmatrix_x4(a[kk], reinterpret_cast<const bf16*>(
                               wt + swz(v, 16 * kk + 8 * (i >> 1))));
      } else {
        const int k = 16 * kk + r + 8 * (i >> 1);
        const uint8_t* sub = wt + cw * 8192;  // the warpgroup's columns
        ldmatrix_x4_trans(a[kk], reinterpret_cast<const bf16*>(
                                     sub + swz(k, 16 * w + 8 * (i & 1))));
      }
    }
  }

  // boxes of 64 k x kCols columns (tied) or 64 columns x 64 k (untied)
  static CUresult encode(EncodeTiled enc, CUtensorMap* map, const void* w,
                         int M, int V) {
    const cuuint32_t estr[2] = {1, 1};
    const cuuint64_t dim[2] = {(cuuint64_t)(TIED ? M : V),
                               (cuuint64_t)(TIED ? V : M)};
    const cuuint64_t str[1] = {(cuuint64_t)(TIED ? M : V) * 2};
    const cuuint32_t box[2] = {64, TIED ? (cuuint32_t)kCols : kBK};
    return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w),
               dim, str, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
               CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  }
};

// int8 head, the weight alone (its scale comes after the K loop): untied
// q [M, V] as one [64 k][kCols columns] tile of 128-byte rows, 128-byte
// swizzle (16-byte chunk c of row k at c ^ (k % 8)); tied q [V, M] as
// [kCols columns][64 k], unswizzled
template <bool TIED>
struct Int8Head {
  using W = int8_t;
  static constexpr int kBytes = kCols * kBK;
  static constexpr bool kScaled = true;

  __device__ static __forceinline__ int col(int g, int h) {
    return TIED ? g + 8 * h : 2 * g + h;
  }

  __device__ static __forceinline__ void tma(uint8_t* wt, const void* map,
                                             uint64_t* bar, int v0, int k0) {
    if (TIED)
      tma_load_2d(wt, map, bar, k0, v0);
    else
      tma_load_2d(wt, map, bar, v0, k0);
  }

  __device__ static __forceinline__ void plain(uint8_t* wt,
                                               const W* __restrict__ q,
                                               int M, int V, int v0, int k0,
                                               int tid) {
    for (int e = tid; e < kCols * kBK; e += kThreads) {
      if (TIED) {
        const int v = e >> 6, k = e & 63;
        const int gv = v0 + v, gk = k0 + k;
        wt[v * 64 + k] = gv < V && gk < M ? q[(size_t)gv * M + gk] : 0;
      } else {
        const int k = e / kCols, v = e % kCols;
        const int gk = k0 + k, gv = v0 + v;
        wt[k * 128 + (((v >> 4) ^ (k & 7)) << 4) + (v & 15)] =
            gk < M && gv < V ? q[(size_t)gk * V + gv] : 0;
      }
    }
  }

  // The A operand (warp w's 16 columns x 16 k) of the four 16-deep steps
  // of a stage, converted to bf16 in registers. Untied: ldmatrix.trans
  // reads the tile as 16-bit pairs, handing thread (g, t) the bytes of
  // columns 2g, 2g + 1 at rows k, k + 1 (k = 2t, or 2t + 8). Tied: A row g
  // is column g, and its k pairs are 16-bit loads.
  __device__ static __forceinline__ void load_a(uint32_t (&a)[4][4],
                                                const uint8_t* wt, int cw,
                                                int w, int lane) {
    const int g = lane >> 2, t = lane & 3;
    if (TIED) {
      const uint8_t* row = wt + (64 * cw + 16 * w + g) * 64 + 2 * t;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint8_t* p = row + 16 * kk;
        const uint32_t lo = *reinterpret_cast<const uint16_t*>(p) |
                            (uint32_t(*reinterpret_cast<const uint16_t*>(
                                 p + 8)) << 16),
                       hi = *reinterpret_cast<const uint16_t*>(p + 8 * 64) |
                            (uint32_t(*reinterpret_cast<const uint16_t*>(
                                 p + 8 * 64 + 8)) << 16);
        const uint32_t ul = lo ^ 0x80808080u, uh = hi ^ 0x80808080u;
        a[kk][0] = q_pair(ul, 0, 1);
        a[kk][1] = q_pair(uh, 0, 1);
        a[kk][2] = q_pair(ul, 2, 3);
        a[kk][3] = q_pair(uh, 2, 3);
      }
      return;
    }
    const int c = 4 * cw + w;  // the warp's 16-byte column chunk
#pragma unroll
    for (int kp = 0; kp < 2; ++kp) {
      // matrix i = lane / 8 holds rows 32 kp + 8 i .. + 7
      const int k = 32 * kp + 8 * (lane >> 3) + (lane & 7);
      uint32_t r[4];
      ldmatrix_x4_trans(r, reinterpret_cast<const bf16*>(
                               wt + k * 128 + ((c ^ (k & 7)) << 4)));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t u0 = r[2 * h] ^ 0x80808080u;
        const uint32_t u1 = r[2 * h + 1] ^ 0x80808080u;
        a[2 * kp + h][0] = q_pair(u0, 0, 2);
        a[2 * kp + h][1] = q_pair(u0, 1, 3);
        a[2 * kp + h][2] = q_pair(u1, 0, 2);
        a[2 * kp + h][3] = q_pair(u1, 1, 3);
      }
    }
  }

  // boxes of 64 k x kCols columns, unswizzled (tied) or kCols columns x
  // 64 k, 128-byte swizzle (untied)
  static CUresult encode(EncodeTiled enc, CUtensorMap* map, const void* q,
                         int M, int V) {
    const cuuint32_t estr[2] = {1, 1};
    const cuuint64_t dim[2] = {(cuuint64_t)(TIED ? M : V),
                               (cuuint64_t)(TIED ? V : M)};
    const cuuint64_t str[1] = {(cuuint64_t)(TIED ? M : V)};
    const cuuint32_t box[2] = {TIED ? (cuuint32_t)kBK : (cuuint32_t)kCols,
                               TIED ? (cuuint32_t)kCols : (cuuint32_t)kBK};
    return enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(q),
               dim, str, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
               TIED ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  }
};

// ---------------------------------------------------------------------------
// epilogues: acc[4j + e] is vocab column v0 + ca (e < 2) or v0 + cb, x row
// r0 + 8j + 2t + (e & 1); the scale, if any, is already applied
// ---------------------------------------------------------------------------

// one (max, sum of exp(x - max), first argmax) partial per (row, tile)
struct Partials {
  float* __restrict__ part_m;
  float* __restrict__ part_s;
  int* __restrict__ part_i;

  template <int ROWS>
  __host__ __device__ static constexpr size_t smem() {
    return size_t(3) * 4 * kWG * ROWS * 4;
  }

  template <int ROWS>
  __device__ __forceinline__ void run(const float (&acc)[ROWS / 2],
                                      uint8_t* smem, int r0, int v0, int ca,
                                      int cb, int R, int V, int tid) const {
    // each row's (max, first column, sum of exp(x - max)) over the warp's
    // 16 columns by xor-shuffles over g, then over the warps in shared
    // memory, in warp order
    constexpr int NW = 4 * kWG;
    float* red_m = reinterpret_cast<float*>(smem);
    float* red_s = red_m + NW * ROWS;
    int* red_i = reinterpret_cast<int*>(red_s + NW * ROWS);
    const int lane = tid & 31, warp = tid >> 5, t = lane & 3;
    const int va = v0 + ca, vb = v0 + cb;
#pragma unroll
    for (int j = 0; j < ROWS / 8; ++j) {
      if (r0 + 8 * j < R) {  // warp-uniform: rows past R are not reduced
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float a = va < V ? acc[4 * j + h] : -INFINITY;
          const float b = vb < V ? acc[4 * j + 2 + h] : -INFINITY;
          float m = fmaxf(a, b);
          int idx = m == -INFINITY ? INT_MAX : (a >= b ? va : vb);
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) {
            const float om = __shfl_xor_sync(0xffffffffu, m, off);
            const int oi = __shfl_xor_sync(0xffffffffu, idx, off);
            if (om > m || (om == m && oi < idx)) {
              m = om;
              idx = oi;
            }
          }
          float s = m == -INFINITY ? 0.f : expf(a - m) + expf(b - m);
#pragma unroll
          for (int off = 4; off < 32; off <<= 1)
            s += __shfl_xor_sync(0xffffffffu, s, off);
          if ((lane >> 2) == 0) {
            const int o = warp * ROWS + 8 * j + 2 * t + h;
            red_m[o] = m;
            red_s[o] = s;
            red_i[o] = idx;
          }
        }
      }
    }
    __syncthreads();
    for (int rl = tid; rl < ROWS; rl += kThreads) {
      const int row = r0 + rl;
      if (row >= R) continue;
      SoftmaxAcc p = acc_init();
      for (int wi = 0; wi < NW; ++wi) {
        SoftmaxAcc q;
        q.m = red_m[wi * ROWS + rl];
        q.s = red_s[wi * ROWS + rl];
        q.idx = red_i[wi * ROWS + rl];
        p = acc_merge(p, q);
      }
      const size_t o = (size_t)blockIdx.y * R + row;
      part_m[o] = p.m;
      part_s[o] = p.s;
      part_i[o] = p.idx;
    }
  }
};

// the f32 logits [R, V]
struct StoreF32 {
  float* __restrict__ out;

  static constexpr int kLd = kCols + 4;  // staged row: 16-byte aligned

  template <int ROWS>
  __host__ __device__ static constexpr size_t smem() {
    return size_t(ROWS) * kLd * 4;
  }

  template <int ROWS>
  __device__ __forceinline__ void run(const float (&acc)[ROWS / 2],
                                      uint8_t* smem, int r0, int v0, int ca,
                                      int cb, int R, int V, int tid) const {
    float* tile = reinterpret_cast<float*>(smem);
    const int lane = tid & 31, warp = tid >> 5, t = lane & 3;
#pragma unroll
    for (int j = 0; j < ROWS / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* r = tile + (8 * j + 2 * t + h) * kLd;
        r[ca] = acc[4 * j + h];
        r[cb] = acc[4 * j + 2 + h];
      }
    }
    __syncthreads();
    const int nc = V - v0 < kCols ? V - v0 : kCols;
    const bool vec =
        (V & 3) == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
    for (int rl = warp; rl < ROWS && r0 + rl < R; rl += kThreads / 32) {
      float* o = out + (size_t)(r0 + rl) * V + v0;
      const float* src = tile + rl * kLd;
      if (vec) {
        if (4 * lane < nc)
          *reinterpret_cast<float4*>(o + 4 * lane) =
              *reinterpret_cast<const float4*>(src + 4 * lane);
      } else {
        for (int c = lane; c < nc; c += 32) o[c] = src[c];
      }
    }
  }
};

// ---------------------------------------------------------------------------
// the body
// ---------------------------------------------------------------------------

// A stage holds NT x terms [ROWS][64 k] and the head tile; the ring takes
// as many stages (up to 6) as fit a block's shared memory, half of it
// where two blocks share an SM (64 rows, one term).
template <class Head, int ROWS, int NT>
struct Tile {
  static constexpr int kXBytes = ROWS * kBK * 2;  // one term
  static constexpr int kStageBytes = NT * kXBytes + Head::kBytes;
  static constexpr int kMinBlocks = ROWS == 64 && NT == 1 ? 2 : 1;
  static constexpr int kFit =
      (kSmemMax / kMinBlocks - 1024 - 128) / kStageBytes;
  static constexpr int kStages = kFit < 6 ? kFit : 6;
  static constexpr int kAhead = kStages - 2;
  static constexpr size_t kSmem =
      size_t(kStages) * kStageBytes + 2 * kStages * 8 + 1024;
  static_assert(kStages >= 3, "a stage of this block does not fit 3 times");
};

// grid (row tiles, vocab tiles): each block runs the whole K loop in order
// and hands its [ROWS x kCols] tile to `epi`. x: NT terms [NT][R][M] bf16
// (xmap: boxes of 64 k x ROWS x 1 term); the head through wmap (Head's
// boxes); scale: V f32 (Head::kScaled) or unused.
template <class Head, int ROWS, int NT, bool TMA, class Epi>
__global__ void __launch_bounds__(kThreads,
                                  Tile<Head, ROWS, NT>::kMinBlocks)
head_wgmma(const __grid_constant__ CUtensorMap xmap,
           const __grid_constant__ CUtensorMap wmap,
           const bf16* __restrict__ x,
           const typename Head::W* __restrict__ w,
           const float* __restrict__ scale, int R, int M, int V, Epi epi) {
  using T = Tile<Head, ROWS, NT>;
  constexpr int S = T::kStages;
  static_assert(Epi::template smem<ROWS>() <= size_t(S) * T::kStageBytes,
                "the epilogue's shared memory exceeds the ring");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* xring = smem;
  uint8_t* wring = smem + S * NT * T::kXBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(wring + S * Head::kBytes);
  uint64_t* empty = full + S;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.x * ROWS, v0 = blockIdx.y * kCols;
  const int nk = (M + kBK - 1) / kBK;

  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4 * kWG);
    }
  }
  __syncthreads();

  // thread 0 keeps kAhead stages in flight: stage t goes into the slot of
  // stage t - S once every warp is done with it
  auto issue = [&](int t) {
    const int slot = t % S;
    if (t >= S) mbar_wait(&empty[slot], ((t / S) - 1) & 1);
    mbar_arrive_expect_tx(&full[slot], T::kStageBytes);
    const int k0 = t * kBK;
#pragma unroll
    for (int i = 0; i < NT; ++i)
      tma_load_3d(xring + (slot * NT + i) * T::kXBytes, &xmap, &full[slot],
                  k0, r0, i);
    Head::tma(wring + slot * Head::kBytes, &wmap, &full[slot], v0, k0);
  };
  if (TMA && tid == 0)
    for (int t = 0; t < T::kAhead && t < nk; ++t) issue(t);
  __syncwarp();  // warp 0 reconverges before its aligned instructions

  const int cw = warp >> 2, w4 = warp & 3;
  float acc[ROWS / 2];
  float acc2[NT > 1 ? ROWS / 2 : 1];  // the small terms' products
#pragma unroll
  for (int i = 0; i < ROWS / 2; ++i) acc[i] = 0.f;
  wgmma_fence_operands(acc);
  if constexpr (NT > 1) {
#pragma unroll
    for (int i = 0; i < ROWS / 2; ++i) acc2[i] = 0.f;
    wgmma_fence_operands(acc2);
  }
  auto stage_in = [&](int s) {  // stage s is in shared memory
    if constexpr (TMA) {
      mbar_wait(&full[s % S], (s / S) & 1);
    } else {
      named_barrier(1, kThreads);  // the previous stage is read
      const bf16 zero = __float2bfloat16_rn(0.f);
      const int k0 = s * kBK;
      for (int e = tid; e < NT * ROWS * kBK; e += kThreads) {
        const int i = e / (ROWS * kBK), r = (e >> 6) % ROWS, k = e & 63;
        const int gr = r0 + r, gk = k0 + k;
        *reinterpret_cast<bf16*>(xring + i * T::kXBytes + swz(r, k)) =
            gr < R && gk < M ? x[((size_t)i * R + gr) * M + gk] : zero;
      }
      Head::plain(wring, w, M, V, v0, k0, tid);
      fence_proxy_async();
      named_barrier(1, kThreads);
    }
  };
  // Stage s: its wgmma on A fragments `cur` (the small terms first, into
  // acc2), then, while they run, the next stage's A into `nxt`, which held
  // stage s - 1's: with TMA the wait for stage s - 1's group (one group
  // left in flight, stage s's) comes first, and frees its slot; plain
  // loads wait for stage s itself before refilling the one stage.
  auto step = [&](int s, uint32_t(&cur)[4][4], uint32_t(&nxt)[4][4]) {
    if (TMA && tid == 0 && s + T::kAhead < nk) issue(s + T::kAhead);
    __syncwarp();
    const uint8_t* xt = xring + (TMA ? s % S : 0) * NT * T::kXBytes;
    wgmma_fence();
    if constexpr (NT > 1) {
#pragma unroll
      for (int i = NT - 1; i > 0; --i)
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          wgmma_rs<ROWS>(acc2, cur[kk],
                         wgmma_desc(xt + i * T::kXBytes + kk * 32));
    }
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_rs<ROWS>(acc, cur[kk], wgmma_desc(xt + kk * 32));
    wgmma_commit();
    if constexpr (TMA) {
      wgmma_wait<1>();
      if (s > 0 && lane == 0) mbar_arrive(&empty[(s - 1) % S]);
    } else {
      wgmma_wait<0>();
    }
    if (s + 1 < nk) {
      stage_in(s + 1);
      Head::load_a(nxt, wring + (TMA ? (s + 1) % S : 0) * Head::kBytes, cw,
                   w4, lane);
    }
  };
  uint32_t a0[4][4], a1[4][4];
  if (nk > 0) {
    stage_in(0);
    Head::load_a(a0, wring, cw, w4, lane);
  }
  for (int s = 0; s < nk; s += 2) {
    step(s, a0, a1);
    if (s + 1 < nk) step(s + 1, a1, a0);
  }
  wgmma_wait<0>();
  wgmma_fence_operands(acc);
  if constexpr (NT > 1) {
    wgmma_fence_operands(acc2);
#pragma unroll
    for (int i = 0; i < ROWS / 2; ++i) acc[i] += acc2[i];
  }

  // this thread's two vocab columns: A rows g and g + 8 of warp w4
  const int g = lane >> 2;
  const int ca = 64 * cw + 16 * w4 + Head::col(g, 0);
  const int cb = 64 * cw + 16 * w4 + Head::col(g, 1);
  if constexpr (Head::kScaled) {
    const float sa = v0 + ca < V ? scale[v0 + ca] : 0.f;
    const float sb = v0 + cb < V ? scale[v0 + cb] : 0.f;
#pragma unroll
    for (int j = 0; j < ROWS / 8; ++j) {
      acc[4 * j] *= sa;
      acc[4 * j + 1] *= sa;
      acc[4 * j + 2] *= sb;
      acc[4 * j + 3] *= sb;
    }
  }
  __syncthreads();  // every warpgroup's products are done: the ring is free
  epi.template run<ROWS>(acc, smem, r0, v0, ca, cb, R, V, tid);
}

// x [n] f32 -> its three bf16 terms t[0..2][n]
__global__ void split_terms(const float* __restrict__ x,
                            bf16* __restrict__ t, size_t n) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const float v = x[i];
    const bf16 hi = __float2bfloat16_rn(v);
    const float r = v - __bfloat162float(hi);
    const bf16 mid = __float2bfloat16_rn(r);
    t[i] = hi;
    t[n + i] = mid;
    t[2 * n + i] = __float2bfloat16_rn(r - __bfloat162float(mid));
  }
}

inline cudaError_t split(const float* x, bf16* t, size_t n,
                         cudaStream_t st) {
  if (n == 0) return cudaSuccess;
  const size_t blocks = (n + 1023) / 1024;
  split_terms<<<blocks < 4096 ? (unsigned)blocks : 4096u, 256, 0, st>>>(
      x, t, n);
  return cudaGetLastError();
}

template <class Head, int ROWS, int NT, bool TMA, class Epi>
cudaError_t launch_kernel(const CUtensorMap& xmap, const CUtensorMap& wmap,
                          const bf16* x, const void* w, const float* scale,
                          int R, int M, int V, const Epi& epi,
                          cudaStream_t st) {
  using T = Tile<Head, ROWS, NT>;
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        head_wgmma<Head, ROWS, NT, TMA, Epi>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::kSmem);
    if (e != cudaSuccess) return e;
    attr = true;
  }
  const dim3 grid((R + ROWS - 1) / ROWS, (V + kCols - 1) / kCols);
  head_wgmma<Head, ROWS, NT, TMA, Epi><<<grid, kThreads, T::kSmem, st>>>(
      xmap, wmap, x, static_cast<const typename Head::W*>(w), scale, R, M,
      V, epi);
  return cudaGetLastError();
}

// the tensor maps of x's terms [NT, R, M] and of the head (128-byte
// swizzle where the loader takes it, zeros outside), when `tma`
template <class Head, int ROWS, int NT, class Epi>
cudaError_t launch_rows(const bf16* x, const void* w, const float* scale,
                        int R, int M, int V, bool tma, const Epi& epi,
                        cudaStream_t st) {
  CUtensorMap xmap, wmap;
  memset(&xmap, 0, sizeof(xmap));
  memset(&wmap, 0, sizeof(wmap));
  if (tma) {
    EncodeTiled enc = encode_tiled();
    if (!enc) return cudaErrorNotSupported;
    const cuuint32_t estr[3] = {1, 1, 1};
    const cuuint64_t xd[3] = {(cuuint64_t)M, (cuuint64_t)R, (cuuint64_t)NT};
    const cuuint64_t xs[2] = {(cuuint64_t)M * 2, (cuuint64_t)R * M * 2};
    const cuuint32_t xb[3] = {kBK, ROWS, 1};
    if (enc(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<bf16*>(x),
            xd, xs, xb, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS ||
        Head::encode(enc, &wmap, w, M, V) != CUDA_SUCCESS)
      return cudaErrorInvalidValue;
  }
  return tma ? launch_kernel<Head, ROWS, NT, true>(xmap, wmap, x, w, scale,
                                                   R, M, V, epi, st)
             : launch_kernel<Head, ROWS, NT, false>(xmap, wmap, x, w, scale,
                                                    R, M, V, epi, st);
}

// `tile` is the wrapper's plan (head.plan): 0 = 256 rows, 1 = 128,
// 2 = 64, each x kCols columns; three terms take at most 128 rows
template <class Head, int NT, class Epi>
cudaError_t launch(int tile, const bf16* x, const void* w,
                   const float* scale, int R, int M, int V, bool tma,
                   const Epi& epi, cudaStream_t st) {
  switch (tile) {
    case 0:
      if constexpr (NT == 1)
        return launch_rows<Head, 256, NT>(x, w, scale, R, M, V, tma, epi,
                                          st);
      break;
    case 1:
      return launch_rows<Head, 128, NT>(x, w, scale, R, M, V, tma, epi, st);
    case 2:
      return launch_rows<Head, 64, NT>(x, w, scale, R, M, V, tma, epi, st);
  }
  return cudaErrorInvalidValue;
}

// x bf16 (`x_bf16`, one term) or f32, split into `terms` ([3, R, M] bf16
// of scratch) first and run as three
template <class Head, class Epi>
cudaError_t launch_x(int tile, const void* x, bool x_bf16, void* terms,
                     const void* w, const float* scale, int R, int M, int V,
                     bool tma, const Epi& epi, cudaStream_t st) {
  if (x_bf16)
    return launch<Head, 1>(tile, static_cast<const bf16*>(x), w, scale, R,
                           M, V, tma, epi, st);
  if (terms == nullptr) return cudaErrorInvalidValue;
  bf16* t = static_cast<bf16*>(terms);
  const cudaError_t e =
      split(static_cast<const float*>(x), t, (size_t)R * M, st);
  if (e != cudaSuccess) return e;
  return launch<Head, 3>(tile, t, w, scale, R, M, V, tma, epi, st);
}

}  // namespace head
