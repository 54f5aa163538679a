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
// bf16 design (fused_step_wgmma, pass 1), in the int8 matmul's (K5's)
// orientation: the block computes logits^T = W^T x^T, its ROWS rows of x
// are one wgmma's N (m64nROWSk16) and each warpgroup's 64 vocab columns
// its M. x is the shared-memory B operand, K-major as it lies; the head
// tile is the register A operand, so no MN-major descriptor is needed
// and a tied head [V, M] (K-major) and an untied one [M, V] (V-major)
// differ only in how their tiles reach the A fragments: ldmatrix on the
// tied tile, ldmatrix.trans on the untied one. Thread 0 keeps
// kStages - 2 64-deep stages in flight on a kStages ring: TMA copies the
// x tile (ROWS x 64, 128-byte swizzle) and the head tile (64 k x 64
// columns a warpgroup, or, tied, 128 columns x 64 k; 128-byte swizzle)
// onto one mbarrier; each warp frees a stage on a second one. A warpgroup
// queues a stage's four wgmma behind the previous stage's group and waits
// for that group only, whose A registers it then refills from the next
// stage (A registers an unfinished wgmma may read are never written).
// Epilogue in registers: a thread's accumulators are vocab columns
// 16w + g + 8(e >> 1) of its warp and x rows 8j + 2t + (e & 1), so a
// row's reduction over the tile runs across the 8 lanes g (xor-shuffles
// 4, 8, 16: max and first column, then the sum of exp(x - max)), then
// across the warps through shared memory (acc_merge: the larger max wins,
// an equal max keeps the smaller column); columns >= V count as -inf and
// rows >= R are zero-filled and never written. One (max, sum, argmax)
// partial per (row, vocab tile) goes to pass 2, so the logits never reach
// device memory. The wrapper's plan picks the block's rows: 256, 128 or
// 64 (the fewest that hold R) x 128 columns (2 warpgroups). Where x's or
// the head's rows
// are not 16-byte aligned (an untied V % 8 != 0) the warps fill one stage
// at a time by plain loads into the same layouts (template parameter TMA).
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
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"
#include "mma_bf16.cuh"
#include "qmm_f32.cuh"
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

// ---------------------------------------------------------------------------
// bf16 pass 1: TMA and wgmma, the logit tile reduced in registers
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kBK = 64;  // depth per stage: one 128-byte bf16 row
constexpr int kWG = 2;   // warpgroups a block, 64 vocab columns each

// A block owns ROWS rows of x (the wgmma's N) x 64 kWG vocab columns: its
// x tile is [ROWS][64 k], its head tile kWG sub-tiles [64 k][64 columns]
// (untied) or one [64 kWG columns][64 k] (tied), all bf16 rows of 128
// bytes with TMA's 128-byte swizzle. The ring holds kStages stages,
// kStages - 2 of them in flight; 64-row blocks fit two to an SM.
template <int ROWS>
struct StepTile {
  static constexpr int kCols = 64 * kWG;
  static constexpr int kThreads = 128 * kWG;
  static constexpr int kXBytes = ROWS * kBK * 2;
  static constexpr int kWBytes = kCols * kBK * 2;
  static constexpr int kStages = ROWS == 128 ? 6 : 4;
  static constexpr int kAhead = kStages - 2;
  static constexpr int kMinBlocks = ROWS == 64 ? 2 : 1;
  static constexpr size_t kSmem =
      size_t(kStages) * (kXBytes + kWBytes) + 2 * kStages * 8 + 1024;
};

// the byte offset of element c of row r in a tile of 128-byte rows with
// TMA's 128-byte swizzle: 16-byte chunk c / 8 of row r lies at chunk
// (c / 8) ^ (r % 8)
__device__ __forceinline__ int swz(int r, int c) {
  return r * 128 + ((((c >> 3) ^ (r & 7))) << 4) + (c & 7) * 2;
}

// The stage's tiles by plain loads, in the layouts TMA writes; zeros
// outside x and the head
template <bool TIED, int ROWS>
__device__ __forceinline__ void stage_plain(uint8_t* xs, uint8_t* ws,
                                            const bf16* __restrict__ x,
                                            const bf16* __restrict__ w,
                                            int R, int M, int V, int r0,
                                            int v0, int k0, int tid) {
  using Tile = StepTile<ROWS>;
  const bf16 zero = __float2bfloat16_rn(0.f);
  for (int e = tid; e < ROWS * kBK; e += Tile::kThreads) {
    const int r = e >> 6, k = e & 63;
    const int gr = r0 + r, gk = k0 + k;
    *reinterpret_cast<bf16*>(xs + swz(r, k)) =
        gr < R && gk < M ? x[(size_t)gr * M + gk] : zero;
  }
  for (int e = tid; e < Tile::kCols * kBK; e += Tile::kThreads) {
    if (TIED) {
      const int v = e >> 6, k = e & 63;
      const int gv = v0 + v, gk = k0 + k;
      *reinterpret_cast<bf16*>(ws + swz(v, k)) =
          gv < V && gk < M ? w[(size_t)gv * M + gk] : zero;
    } else {
      const int k = e / Tile::kCols, v = e % Tile::kCols;
      const int gk = k0 + k, gv = v0 + v;
      *reinterpret_cast<bf16*>(ws + (v >> 6) * 8192 + swz(k, v & 63)) =
          gk < M && gv < V ? w[(size_t)gk * V + gv] : zero;
    }
  }
}

// The A operand (the head transposed: warp w's 16 columns x 16 k) of the
// four 16-deep steps of a stage. Lane l addresses row l % 8 of 8 x 8
// matrix i = l / 8: a0 (columns 0-7, k 0-7), a1 (columns 8-15, k 0-7),
// a2 (columns 0-7, k 8-15), a3 (columns 8-15, k 8-15). Tied: the tile is
// [column][k], so A's rows are its rows (ldmatrix); untied: [k][column],
// so ldmatrix.trans hands thread (g, t) column g at k 2t, 2t + 1.
template <bool TIED>
__device__ __forceinline__ void load_a(uint32_t (&a)[4][4],
                                       const uint8_t* wt, int cw, int w,
                                       int lane) {
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

// grid (row tiles, vocab tiles): each block runs the whole K loop in
// order and writes one partial per (row, vocab tile). TMA: thread 0 fills
// the ring through xmap (x, boxes of 64 k x ROWS) and wmap (untied:
// boxes of 64 columns x 64 k; tied: 64 k x 64 kWG columns); otherwise the
// warps fill one stage at a time by plain loads.
template <bool TIED, int ROWS, bool TMA>
__global__ void __launch_bounds__(StepTile<ROWS>::kThreads,
                                  StepTile<ROWS>::kMinBlocks)
fused_step_wgmma(const __grid_constant__ CUtensorMap xmap,
                 const __grid_constant__ CUtensorMap wmap,
                 const bf16* __restrict__ x, const bf16* __restrict__ w,
                 float* __restrict__ part_m, float* __restrict__ part_s,
                 int* __restrict__ part_i, int R, int M, int V) {
  using Tile = StepTile<ROWS>;
  constexpr int S = Tile::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* xring = smem;
  uint8_t* wring = smem + S * Tile::kXBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(wring + S * Tile::kWBytes);
  uint64_t* empty = full + S;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.x * ROWS, v0 = blockIdx.y * Tile::kCols;
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
    mbar_arrive_expect_tx(&full[slot], Tile::kXBytes + Tile::kWBytes);
    const int k0 = t * kBK;
    uint8_t* wt = wring + slot * Tile::kWBytes;
    tma_load_2d(xring + slot * Tile::kXBytes, &xmap, &full[slot], k0, r0);
    if (TIED) {
      tma_load_2d(wt, &wmap, &full[slot], k0, v0);
    } else {
#pragma unroll
      for (int c = 0; c < kWG; ++c)
        tma_load_2d(wt + c * 8192, &wmap, &full[slot], v0 + 64 * c, k0);
    }
  };
  if (TMA && tid == 0)
    for (int t = 0; t < Tile::kAhead && t < nk; ++t) issue(t);
  __syncwarp();  // warp 0 reconverges before its aligned instructions

  const int cw = warp >> 2, w4 = warp & 3;
  float acc[ROWS / 2];
#pragma unroll
  for (int i = 0; i < ROWS / 2; ++i) acc[i] = 0.f;
  wgmma_fence_operands(acc);
  auto stage_in = [&](int s) {  // stage s is in shared memory
    if constexpr (TMA) {
      mbar_wait(&full[s % S], (s / S) & 1);
    } else {
      named_barrier(1, Tile::kThreads);  // the previous stage is read
      stage_plain<TIED, ROWS>(xring, wring, x, w, R, M, V, r0, v0, s * kBK,
                              tid);
      fence_proxy_async();
      named_barrier(1, Tile::kThreads);
    }
  };
  // Stage s: its four wgmma on A fragments `cur`, then, while they run,
  // the next stage's A into `nxt`, which held stage s - 1's: with TMA the
  // wait for stage s - 1's group (one group left in flight, stage s's)
  // comes first, and frees its slot; plain loads wait for stage s itself
  // before refilling the one stage.
  auto step = [&](int s, uint32_t(&cur)[4][4], uint32_t(&nxt)[4][4]) {
    if (TMA && tid == 0 && s + Tile::kAhead < nk) issue(s + Tile::kAhead);
    __syncwarp();
    const uint8_t* xt = xring + (TMA ? s % S : 0) * Tile::kXBytes;
    wgmma_fence();
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
      load_a<TIED>(nxt, wring + (TMA ? (s + 1) % S : 0) * Tile::kWBytes, cw,
                   w4, lane);
    }
  };
  uint32_t a0[4][4], a1[4][4];
  if (nk > 0) {
    stage_in(0);
    load_a<TIED>(a0, wring, cw, w4, lane);
  }
  for (int s = 0; s < nk; s += 2) {
    step(s, a0, a1);
    if (s + 1 < nk) step(s + 1, a1, a0);
  }
  wgmma_wait<0>();
  wgmma_fence_operands(acc);
  __syncthreads();  // every warpgroup's products are done: the ring is free

  // acc[4j + e]: vocab column va + 8 (e >> 1), x row 8j + 2t + (e & 1).
  // Each row's (max, first column, sum of exp(x - max)) over the warp's
  // 16 columns by xor-shuffles over g, then over the warps in shared
  // memory, in warp order.
  constexpr int NW = 4 * kWG;
  float* red_m = reinterpret_cast<float*>(smem);
  float* red_s = red_m + NW * ROWS;
  int* red_i = reinterpret_cast<int*>(red_s + NW * ROWS);
  const int g = lane >> 2, t = lane & 3;
  const int va = v0 + 64 * cw + 16 * w4 + g, vb = va + 8;
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
        if (g == 0) {
          const int o = warp * ROWS + 8 * j + 2 * t + h;
          red_m[o] = m;
          red_s[o] = s;
          red_i[o] = idx;
        }
      }
    }
  }
  __syncthreads();
  for (int rl = tid; rl < ROWS; rl += Tile::kThreads) {
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

template <bool TIED, int ROWS, bool TMA>
cudaError_t launch_kernel(const CUtensorMap& xmap, const CUtensorMap& wmap,
                          const bf16* x, const bf16* w, void* pm, void* ps,
                          void* pi, int R, int M, int V, cudaStream_t st) {
  using Tile = StepTile<ROWS>;
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_step_wgmma<TIED, ROWS, TMA>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Tile::kSmem);
    if (e != cudaSuccess) return e;
    attr = true;
  }
  const dim3 grid((R + ROWS - 1) / ROWS, (V + Tile::kCols - 1) / Tile::kCols);
  fused_step_wgmma<TIED, ROWS, TMA><<<grid, Tile::kThreads, Tile::kSmem,
                                      st>>>(
      xmap, wmap, x, w, static_cast<float*>(pm), static_cast<float*>(ps),
      static_cast<int*>(pi), R, M, V);
  return cudaGetLastError();
}

// the tensor maps of x [R, M] and the head ([V, M] tied, [M, V] untied),
// bf16 with the 128-byte swizzle and zeros outside, when `tma`
template <bool TIED, int ROWS>
cudaError_t launch_wgmma(const bf16* x, const bf16* w, void* pm, void* ps,
                         void* pi, int R, int M, int V, bool tma,
                         cudaStream_t st) {
  using Tile = StepTile<ROWS>;
  CUtensorMap xmap, wmap;
  memset(&xmap, 0, sizeof(xmap));
  memset(&wmap, 0, sizeof(wmap));
  if (tma) {
    EncodeTiled enc = encode_tiled();
    if (!enc) return cudaErrorNotSupported;
    const cuuint32_t estr[2] = {1, 1};
    const cuuint64_t xd[2] = {(cuuint64_t)M, (cuuint64_t)R};
    const cuuint64_t xs[1] = {(cuuint64_t)M * 2};
    const cuuint32_t xb[2] = {kBK, ROWS};
    const cuuint64_t wd[2] = {(cuuint64_t)(TIED ? M : V),
                              (cuuint64_t)(TIED ? V : M)};
    const cuuint64_t ws[1] = {(cuuint64_t)(TIED ? M : V) * 2};
    const cuuint32_t wb[2] = {64, TIED ? (cuuint32_t)Tile::kCols : kBK};
    if (enc(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
            const_cast<bf16*>(x), xd, xs, xb, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS ||
        enc(&wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
            const_cast<bf16*>(w), wd, ws, wb, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return cudaErrorInvalidValue;
  }
  return tma ? launch_kernel<TIED, ROWS, true>(xmap, wmap, x, w, pm, ps, pi,
                                              R, M, V, st)
             : launch_kernel<TIED, ROWS, false>(xmap, wmap, x, w, pm, ps, pi,
                                               R, M, V, st);
}

// `tile` is the wrapper's plan: 0 = 256 rows, 1 = 128, 2 = 64 (x 128
// columns)
template <bool TIED>
cudaError_t launch_bf16(int tile, const bf16* x, const bf16* w, void* pm,
                        void* ps, void* pi, int R, int M, int V, bool tma,
                        cudaStream_t st) {
  switch (tile) {
    case 0:
      return launch_wgmma<TIED, 256>(x, w, pm, ps, pi, R, M, V, tma, st);
    case 1:
      return launch_wgmma<TIED, 128>(x, w, pm, ps, pi, R, M, V, tma, st);
    case 2:
      return launch_wgmma<TIED, 64>(x, w, pm, ps, pi, R, M, V, tma, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// bf16: `tile` and `tma` are the wrapper's plan; `ntiles` partials a row
// must be the vocab tiles of the body (V / 64 kWG bf16, V / kVT f32,
// rounded up)
extern "C" int fused_step(const void* x, const void* w, const void* tau,
                          const void* masked, void* part_m, void* part_s,
                          void* part_i, void* conf, void* tok, void* above,
                          int R, int M, int V, int tied, int is_bf16,
                          int quota, int group, int tile, int tma,
                          int ntiles, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int cols = is_bf16 ? 64 * kWG : kVT;
  if (ntiles != (V + cols - 1) / cols)
    return static_cast<int>(cudaErrorInvalidValue);
  int err;
  if (is_bf16) {
    const bf16* xp = static_cast<const bf16*>(x);
    const bf16* wp = static_cast<const bf16*>(w);
    err = static_cast<int>(
        tied ? launch_bf16<true>(tile, xp, wp, part_m, part_s, part_i, R, M,
                                 V, tma != 0, st)
             : launch_bf16<false>(tile, xp, wp, part_m, part_s, part_i, R,
                                  M, V, tma != 0, st));
  } else {
    err = launch_f32(static_cast<const float*>(x),
                     static_cast<const float*>(w), tied, part_m, part_s,
                     part_i, R, M, V, st);
  }
  if (err != 0) return err;
  return launch_finish(part_m, part_s, part_i, ntiles, tau, masked, conf,
                       tok, above, R, quota, group, st);
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
