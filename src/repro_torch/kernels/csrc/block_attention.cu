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
// Masks (both bodies): a cache slot is valid when it lies below the row's
// kv_limit, its kv_pos is >= 0, it is outside the block's own slots
// [slot, slot + bs) (stale: the fresh block serves them), outside
// [exc0, exc1) with `exclude`, inside the window, and, paged, its page is
// mapped. Cache tiles past kv_limit are never loaded. The fresh block
// enters as extra tiles after the cache; a sentinel slot + bs > T hides
// it. Scores are f32; a masked one is the finite -1e30, so a fully masked
// row ends with l > 0 and output 0.
// GQA folds the query group into rows (row r -> head kh*G + r/bs,
// position r%bs), so one kv head's tiles serve the whole group and K/V
// are read once per row tile.
// The two layouts share each body through the template parameter kPaged,
// which changes only where slot `id` of row b is read: dense at
// ((b*T + id)*Kh + kh)*D; paged through pp = page_table[b*n_log + id/ps]
// at ((pp*ps + id%ps)*Kh + kh)*D, an unmapped slot (pp < 0) loading zero
// and counting as invalid. A tile is not one page: a page may be any
// size, and n_log*ps >= T. With every page mapped, K4 gives K1's result
// on the gathered view bit for bit.
//
// bf16 body (block_attn_bf16, the main path's): tensor cores. One block
// of 4 warps per (row tile of 32 folded query rows, kv head, batch row):
// warp w owns rows 16 (w & 1) .. +16 and, of each 64-slot tile, the 32
// slots from 32 (w >> 1). Q's fragments stay in registers for the whole
// loop. K and V tiles are copied bf16 to shared memory by a cp.async ring
// (3 stages for D <= 128, 2 above), so the next tiles load while this one
// is multiplied; unloaded slots (past kv_limit, past bs, unmapped pages)
// are zero-filled. Each slot's source row (K4: its page-table lookup and
// the division by the page size) and its validity are worked out once,
// by one thread, into a small shared ring an iteration before the tile's
// copy goes out, so no copy and no mask waits on a page-table or kv_pos
// load. S = Q K^T and O += P V run on mma.sync m16n8k16 (bf16
// x bf16 -> f32). The online softmax (max, sum, rescale) runs in f32 on
// the accumulator fragments. P is not rounded to bf16 once, as in K7:
// the oracle keeps P in f32, and one rounding (8 bits) moves an output by
// up to 2^-8 P|V|, beyond the 2^-7 |want| + 1e-4 the kernel is held to
// wherever an output is near 0. P enters the product as two bf16 terms,
// bf16(p) + bf16(p - bf16(p)) (~16 significant bits), each multiplied by
// the same V; the second product adds tensor-core work, not bytes, and
// the body waits on bytes.
// The two slot halves of a row tile merge their (max, sum, acc) through
// shared memory at the end.
// Why mma.sync and not wgmma: with MHA at bs 32 a (kv head, batch row)
// has 32 query rows, and wgmma's 64-row tile would idle half its rows.
// Why no split of the KV range over blocks (flash-decoding): the main
// shape gives 256 blocks, and at ~104 KB of ring two blocks fit an SM, so
// all 256 are resident in one wave on 132 SMs, each with up to two tiles
// in flight; the split inside the block over its 4 warps needs no second
// pass.
// f32 body (block_attn, kept for f32 operands): CUDA cores. Each 32-slot
// tile is staged in shared memory as f32; a warp owns 4 query rows and a
// lane one kv column, so the score, the online-softmax update and the
// P.V product need only warp shuffles.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"
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

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kTcRows = 32;      // folded query rows per block (2 x m16)
constexpr int kTcKT = 64;        // kv slots per tile, 32 per warp
constexpr int kTcThreads = 128;  // 4 warps: 2 row halves x 2 slot halves

template <int D>
struct TcGeom {
  // row stride D + 8 bf16: rows stay 16-byte aligned, and the 8 rows an
  // ldmatrix phase reads hit distinct banks
  static constexpr int kLd = D + 8;
  static constexpr int kStages = D <= 128 ? 3 : 2;
  static constexpr int kStage = 2 * kTcKT * kLd;  // K tile, then V tile
  // the end-of-loop merge reuses the ring: per row half, each lane's
  // accumulator fragments and its (m_lo, m_hi, l_lo, l_hi)
  static constexpr int kMergeFloats = D / 2 + 4;  // per lane
  static constexpr size_t kRing = sizeof(__nv_bfloat16) * kStages * kStage;
  static constexpr size_t kMerge = sizeof(float) * 2 * kMergeFloats * 32;
  static constexpr size_t kSmem = kRing > kMerge ? kRing : kMerge;
};

// element offset of folded row r of q or out
__device__ __forceinline__ size_t row_offset(int b, int r, int kh, int G,
                                             int bs, int H, int D) {
  return (((size_t)b * bs + r % bs) * H + kh * G + r / bs) * D;
}

template <int D, bool kPaged>
__global__ void __launch_bounds__(kTcThreads)
block_attn_bf16(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ ck,
                const __nv_bfloat16* __restrict__ cv,
                const __nv_bfloat16* __restrict__ bk,
                const __nv_bfloat16* __restrict__ bv,
                const int* __restrict__ kv_pos, const int* __restrict__ pt,
                const int* __restrict__ sc, __nv_bfloat16* __restrict__ out,
                int B, int bs, int H, int Kh, int T_, int n_log, int ps,
                int exclude, int window, float scale) {
  using Geo = TcGeom<D>;
  constexpr int kLd = Geo::kLd, kStages = Geo::kStages;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int b = blockIdx.z, kh = blockIdx.y;
  const int row0 = blockIdx.x * kTcRows;
  const int G = H / Kh, R = G * bs;
  const int slot = sc[0 * B + b], bstart = sc[1 * B + b];
  const int exc0 = sc[2 * B + b], exc1 = sc[3 * B + b];
  const int kvlim = sc[4 * B + b];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int half = warp >> 1;  // which 32 slots of each tile
  const int r_lo = row0 + (warp & 1) * 16 + g, r_hi = r_lo + 8;

  // this warp's Q rows as A fragments, zero past R
  uint32_t qa[D / 16][4];
  {
    const __nv_bfloat16* qlo = q + row_offset(b, r_lo, kh, G, bs, H, D);
    const __nv_bfloat16* qhi = q + row_offset(b, r_hi, kh, G, bs, H, D);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk * 16 + 2 * t;
      qa[kk][0] = r_lo < R ? ld_pair(qlo + c) : 0u;
      qa[kk][1] = r_hi < R ? ld_pair(qhi + c) : 0u;
      qa[kk][2] = r_lo < R ? ld_pair(qlo + c + 8) : 0u;
      qa[kk][3] = r_hi < R ? ld_pair(qhi + c + 8) : 0u;
    }
  }

  // tiles [0, nc) cover the live cache, [nc, nc + nb) the fresh block
  const int live = max(0, min(kvlim, T_));
  const int nc = (live + kTcKT - 1) / kTcKT;
  const int nb = slot + bs <= T_ ? (bs + kTcKT - 1) / kTcKT : 0;
  const int ntiles = nc + nb;

  // Per-slot info of tile `it`, one thread a slot, in a ring of
  // kStages + 1 entries: the source row (the pool row pp*ps + id%ps,
  // paged only; -1 = not read) and the validity. It is written one
  // iteration before the tile's copy is issued, so neither the copy nor
  // the masks wait on a page-table or kv_pos load.
  constexpr int kInfo = kStages + 1;
  __shared__ int s_row[kInfo][kTcKT];
  __shared__ bool s_ok[kInfo][kTcKT];
  auto tile_info = [&](int it) {
    if (tid >= kTcKT || it >= ntiles) return;
    int row = -1;
    bool v;
    if (it < nc) {
      const int id = it * kTcKT + tid;
      v = id < live;
      if (v) {
        const int pos = kv_pos[id];
        v = pos >= 0 && !(id >= slot && id < slot + bs);
        if (kPaged) {
          const int pp = pt[b * n_log + id / ps];
          if (pp >= 0) row = pp * ps + id % ps;
          v = v && pp >= 0;
        }
        if (exclude) v = v && !(id >= exc0 && id < exc1);
        if (window) v = v && (bstart + bs - 1 - pos) < window;
      }
    } else {
      const int r = (it - nc) * kTcKT + tid;
      v = r < bs;
      if (exclude) v = v && !(slot + r >= exc0 && slot + r < exc1);
      if (window) v = v && (bs - 1 - r) < window;
    }
    s_row[it % kInfo][tid] = row;
    s_ok[it % kInfo][tid] = v;
  };

  // tile `it` into its ring stage; a slot that is not read is zero
  auto load_tile = [&](int it) {
    __nv_bfloat16* ks = ring + (it % kStages) * Geo::kStage;
    __nv_bfloat16* vs = ks + kTcKT * kLd;
    const bool cache = it < nc;
    const __nv_bfloat16* kb = cache ? ck : bk;
    const __nv_bfloat16* vb = cache ? cv : bv;
    for (int e = tid; e < kTcKT * D / 8; e += kTcThreads) {
      const int c = e / (D / 8), d = (e % (D / 8)) * 8;
      // the source row in [rows, Kh, D]: dense cache b*T + id, pool row,
      // fresh block b*bs + r
      int row;
      if (!cache) {
        const int r = (it - nc) * kTcKT + c;
        row = r < bs ? b * bs + r : -1;
      } else if (kPaged) {
        row = s_row[it % kInfo][c];
      } else {
        const int id = it * kTcKT + c;
        row = id < live ? b * T_ + id : -1;
      }
      const bool ok = row >= 0;
      const size_t o = ((size_t)(ok ? row : 0) * Kh + kh) * D + d;
      cp_async_zfill16(&ks[c * kLd + d], kb + o, ok);
      cp_async_zfill16(&vs[c * kLd + d], vb + o, ok);
    }
  };

  float m_lo = kNegInf, m_hi = kNegInf;  // running max of rows g, g + 8
  float l_lo = 0.f, l_hi = 0.f;  // this thread's share of the running sum
  float oacc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;

  // prologue: the info of tiles [0, kStages) and the copies of tiles
  // [0, kStages - 1); a dense copy needs no info and goes out first
  if (kPaged) {
    for (int s = 0; s < kStages; ++s) tile_info(s);
    __syncthreads();
  }
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ntiles) load_tile(s);
    cp_async_commit_group();
  }
  if (!kPaged)
    for (int s = 0; s < kStages; ++s) tile_info(s);
  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait_group<kStages - 2>();  // tile `it` landed (own copies)
    __syncthreads();  // ... everyone's; tile it - 1 is read; info is out
    if (it + kStages - 1 < ntiles) load_tile(it + kStages - 1);
    cp_async_commit_group();
    tile_info(it + kStages);  // into tile it - 1's entry
    // a warp whose 32 slots all lie past the tile's extent skips it
    const int first = (it < nc ? it : it - nc) * kTcKT + half * 32;
    if (first >= (it < nc ? live : bs)) continue;
    const __nv_bfloat16* ks =
        ring + (it % kStages) * Geo::kStage + half * 32 * kLd;
    const __nv_bfloat16* vs = ks + kTcKT * kLd;

    // S = Q K^T: 16 rows x 32 slots a warp, 4 chunks of 8 slots
    float sacc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 32; ++kk) {
        uint32_t kf[4];
        ldmatrix_x4(kf, &ks[(j * 8 + (lane & 7)) * kLd + kk * 32 +
                            (lane >> 3) * 8]);
        const uint32_t b0[2] = {kf[0], kf[1]}, b1[2] = {kf[2], kf[3]};
        mma_bf16(sacc[j], qa[2 * kk], b0);
        mma_bf16(sacc[j], qa[2 * kk + 1], b1);
      }
    }

    // scale and mask (the masks depend on the slot only); the tile's row
    // max over the quad that holds a row
    bool ok[4][2];
    float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e)
        ok[j][e] = s_ok[it % kInfo][half * 32 + j * 8 + 2 * t + e];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float s = ok[j][e & 1] ? sacc[j][e] * scale : kNegInf;
        sacc[j][e] = s;
        if (e < 2)
          mx_lo = fmaxf(mx_lo, s);
        else
          mx_hi = fmaxf(mx_hi, s);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
    }
    const float c_lo = expf(m_lo - mx_lo), c_hi = expf(m_hi - mx_hi);
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
    // p = exp(s - m) counts in l; a masked slot adds nothing to acc
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(sacc[j][e] - (e < 2 ? m_lo : m_hi));
        if (e < 2)
          l_lo += p;
        else
          l_hi += p;
        sacc[j][e] = ok[j][e & 1] ? p : 0.f;
      }
    }

    // O += P V, 16 slots a step: P's accumulators repack into A
    // fragments as two bf16 terms, each multiplied by the same V
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t pa[4][2];  // [A register][term]
#pragma unroll
      for (int i = 0; i < 4; ++i)  // a_i: row g + 8 (i & 1), chunk i / 2
        split_bf16(pa[i], sacc[2 * kk + i / 2][2 * (i & 1)],
                   sacc[2 * kk + i / 2][2 * (i & 1) + 1]);
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, &vs[(kk * 16 + (lane & 7) +
                                   ((lane >> 3) & 1) * 8) * kLd +
                                  (2 * n + (lane >> 4)) * 8]);
        const uint32_t b0[2] = {vf[0], vf[1]}, b1[2] = {vf[2], vf[3]};
#pragma unroll
        for (int term = 0; term < 2; ++term) {
          const uint32_t a[4] = {pa[0][term], pa[1][term], pa[2][term],
                                 pa[3][term]};
          mma_bf16(oacc[2 * n], a, b0);
          mma_bf16(oacc[2 * n + 1], a, b1);
        }
      }
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  // merge the two slot halves of each row half: warps w and w + 2 hold
  // the same rows and columns in the same fragment places, so the upper
  // one parks its state lane by lane and the lower one reads it back
  cp_async_wait_group<0>();
  __syncthreads();  // the ring is free
  float* mrg = reinterpret_cast<float*>(smem_raw) +
               (warp & 1) * Geo::kMergeFloats * 32;
  if (half) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) mrg[(n * 4 + e) * 32 + lane] = oacc[n][e];
    mrg[(D / 2 + 0) * 32 + lane] = m_lo;
    mrg[(D / 2 + 1) * 32 + lane] = m_hi;
    mrg[(D / 2 + 2) * 32 + lane] = l_lo;
    mrg[(D / 2 + 3) * 32 + lane] = l_hi;
  }
  __syncthreads();
  if (half) return;
  const float m2_lo = mrg[(D / 2 + 0) * 32 + lane];
  const float m2_hi = mrg[(D / 2 + 1) * 32 + lane];
  const float mm_lo = fmaxf(m_lo, m2_lo), mm_hi = fmaxf(m_hi, m2_hi);
  const float a_lo = expf(m_lo - mm_lo), b_lo = expf(m2_lo - mm_lo);
  const float a_hi = expf(m_hi - mm_hi), b_hi = expf(m2_hi - mm_hi);
  const float inv_lo = 1.f / fmaxf(
      l_lo * a_lo + mrg[(D / 2 + 2) * 32 + lane] * b_lo, 1e-30f);
  const float inv_hi = 1.f / fmaxf(
      l_hi * a_hi + mrg[(D / 2 + 3) * 32 + lane] * b_hi, 1e-30f);
  __nv_bfloat16* olo = out + row_offset(b, r_lo, kh, G, bs, H, D);
  __nv_bfloat16* ohi = out + row_offset(b, r_hi, kh, G, bs, H, D);
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    float o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      o[e] = oacc[n][e] * (e < 2 ? a_lo : a_hi) +
             mrg[(n * 4 + e) * 32 + lane] * (e < 2 ? b_lo : b_hi);
    const int c = n * 8 + 2 * t;
    if (r_lo < R)
      *reinterpret_cast<__nv_bfloat162*>(olo + c) =
          __floats2bfloat162_rn(o[0] * inv_lo, o[1] * inv_lo);
    if (r_hi < R)
      *reinterpret_cast<__nv_bfloat162*>(ohi + c) =
          __floats2bfloat162_rn(o[2] * inv_hi, o[3] * inv_hi);
  }
}

// the bf16 launch for head width `d` (a multiple of 32 up to 256):
// D walks 32, 64, .. until it equals d
template <bool kPaged, int D = 32>
int launch_bf16(int d, const void* q, const void* ck, const void* cv,
                const void* bk, const void* bv, const void* kv_pos,
                const void* pt, const void* sc, void* out, int B, int bs,
                int H, int Kh, int T_, int n_log, int ps, int exclude,
                int window, float scale, cudaStream_t st) {
  if constexpr (D > 256) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (d != D)
      return launch_bf16<kPaged, D + 32>(d, q, ck, cv, bk, bv, kv_pos, pt,
                                         sc, out, B, bs, H, Kh, T_, n_log,
                                         ps, exclude, window, scale, st);
    // cp.async copies 16-byte pieces of K and V
    if ((reinterpret_cast<uintptr_t>(ck) | reinterpret_cast<uintptr_t>(cv) |
         reinterpret_cast<uintptr_t>(bk) | reinterpret_cast<uintptr_t>(bv)) &
        15)
      return static_cast<int>(cudaErrorMisalignedAddress);
    const size_t smem = TcGeom<D>::kSmem;
    cudaError_t err = cudaFuncSetAttribute(
        block_attn_bf16<D, kPaged>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const int R = (H / Kh) * bs;
    dim3 grid((R + kTcRows - 1) / kTcRows, Kh, B);
    using bf = __nv_bfloat16;
    block_attn_bf16<D, kPaged><<<grid, kTcThreads, smem, st>>>(
        static_cast<const bf*>(q), static_cast<const bf*>(ck),
        static_cast<const bf*>(cv), static_cast<const bf*>(bk),
        static_cast<const bf*>(bv), static_cast<const int*>(kv_pos),
        static_cast<const int*>(pt), static_cast<const int*>(sc),
        static_cast<bf*>(out), B, bs, H, Kh, T_, n_log, ps, exclude, window,
        scale);
    return static_cast<int>(cudaGetLastError());
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
    return launch_bf16<false>(D, q, ck, cv, bk, bv, kv_pos, nullptr, scalars,
                              out, B, bs, H, Kh, T, 1, 1, exclude, window,
                              scale, st);
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
    return launch_bf16<true>(D, q, pool_k, pool_v, bk, bv, kv_pos,
                             page_table, scalars, out, B, bs, H, Kh, T, n_log,
                             ps, exclude, window, scale, st);
  return launch<float, true>(q, pool_k, pool_v, bk, bv, kv_pos, page_table,
                             scalars, out, B, bs, H, Kh, D, T, n_log, ps,
                             exclude, window, scale, st);
}
