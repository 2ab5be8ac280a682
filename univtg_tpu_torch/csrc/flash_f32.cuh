// f32 attention on Hopper's CUDA cores: the building blocks of the f32
// kernels of flash_bwd.cu (flash_bwd_dq_kernel, flash_bwd_dkv_kernel) and
// the one online-softmax loop (attend) that flash_fwd.cu's forward
// (flash_fwd_kernel) and ring_attention.cu's block update
// (ring_block_kernel) instantiate.
//
// The SGEMM recipe, in plain f32 FFMA: a block of 256 threads, one block per
// SM (the tiles fill up to 225 KB of shared memory at DH 128); each thread
// computes an outer-product tile in registers from float4 reads along the
// product's depth, so a warp's 32 threads read a few distinct 16-byte
// chunks per 128 FFMA. Every tile is row-major, a row's 16-byte chunk c
// stored at chunk c ^ (row % 8): the threads of a warp that read one chunk
// of 8 rows with distinct row % 8, or 4 chunks of one row, hit distinct
// banks, with no padding. The head dim is padded to DH = 64 or 128 and
// zero-filled. Streamed tiles are filled by cp.async, 16 bytes a thread
// (zero-filled past L and dh), into two stages: tile t + 1's copies run
// under tile t's arithmetic.
//
// Shared memory caps these loops before the FMA pipes do: an LDS.128 costs
// a warp four wavefronts, broadcast or not, so an SM reads 32 thread-words a
// cycle against 128 FFMA. A 4 x 8 register tile (12 float4 reads per 128
// FFMA, 2.7 FFMA a word) caps its loop at 67 % of the FFMA rate; 8 x 8 (16
// per 256, 4 a word) just balances the pipes.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "flash_sm90.cuh"

namespace f32 {

using flash::Dropout;
using flash::Layout;

constexpr int TILE = 64;      // rows of a streamed tile; keys of a P tile
constexpr int THREADS = 256;  // every f32 block
constexpr int MAX_DH = 128;

// Float offset of chunk c (floats 4c .. 4c + 3) of row r in a swizzled tile
// W floats wide, and of element col.
template <int W>
__device__ __forceinline__ int chunk_at(int r, int c) {
  return r * W + ((c ^ (r & 7)) << 2);
}
template <int W>
__device__ __forceinline__ int elem_at(int r, int col) {
  return chunk_at<W>(r, col >> 2) + (col & 3);
}

__device__ __forceinline__ void ld4(float (&v)[4], const float* p) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

__device__ __forceinline__ void st4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows [r0, r0 + R) of one head into a swizzled tile DH floats wide, by
// cp.async 16 bytes at a time; rows >= L and head-dim columns >= dh are
// zero-filled (no global read).
template <int DH, int R = TILE>
__device__ __forceinline__ void copy_rows(float* dst,
                                          const float* __restrict__ src,
                                          long long sl, int r0, int L, int dh) {
  constexpr int CH = DH / 4;        // chunks per row
  constexpr int RS = THREADS / CH;  // rows per round, a multiple of 8: a
                                    // thread's rows share their swizzle
  static_assert(R % RS == 0 && RS % 8 == 0, "whole rounds of copies");
  const int c = threadIdx.x % CH, r = threadIdx.x / CH;
  const bool col_ok = 4 * c < dh;
  float* d = dst + chunk_at<DH>(r, c);
  const float* s = src + (long long)(r0 + r) * sl + 4 * c;
#pragma unroll
  for (int it = 0; it < R / RS; ++it) {
    const bool ok = col_ok && r0 + r + it * RS < L;
    cp_async16(d + it * RS * DH, ok ? s + it * RS * sl : src, ok);
  }
}

// The chunks that copy_rows<DH, R> gave this thread, times x, once its
// copies have landed (cp_wait_all): no other thread reads them before a
// barrier.
template <int DH, int R>
__device__ __forceinline__ void scale_rows(float* dst, float x) {
  constexpr int CH = DH / 4, RS = THREADS / CH;
  float* d = dst + chunk_at<DH>(threadIdx.x / CH, threadIdx.x % CH);
#pragma unroll
  for (int it = 0; it < R / RS; ++it) {
    float v[4];
    ld4(v, d + it * RS * DH);
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] *= x;
    st4(d + it * RS * DH, v);
  }
}

// s[i][j] += A row (ra + SA i) . B row (rb + 8 j) over the head dim, both
// tiles DH wide: a float4 of each row per 4 columns, 32 NI FFMA per NI + 8
// reads.
template <int DH, int U, int SA = 16, int NI = 4>
__device__ __forceinline__ void scores(float (&s)[NI][8], const float* A,
                                       int ra, const float* B, int rb) {
  static_assert(SA % 8 == 0, "rows ra + SA i share ra's swizzle");
  const float* a0 = A + ra * DH;
  const float* b0 = B + rb * DH;
#pragma unroll(U)
  for (int c = 0; c < DH / 4; ++c) {
    // rows ra + SA i share ra's swizzle, rows rb + 8 j rb's
    const int oa = (c ^ (ra & 7)) << 2, ob = (c ^ (rb & 7)) << 2;
    float a[NI][4], b[8][4];
#pragma unroll
    for (int i = 0; i < NI; ++i) ld4(a[i], a0 + SA * i * DH + oa);
#pragma unroll
    for (int j = 0; j < 8; ++j) ld4(b[j], b0 + 8 * j * DH + ob);
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(a[i][e], b[j][e], s[i][j]);
  }
}

// acc[i][4 h + e] += sum over n < TILE of P[ra + (R / NI) i][n] *
// B[n][4 (cx + 16 h) + e]: P an R x TILE tile, B a tile DH wide, a float4
// of each of the thread's NI rows of P per 4 rows of B.
template <int DH, int NI, int U, int R = TILE>
__device__ __forceinline__ void accumulate(float (&acc)[NI][DH / 16],
                                           const float* P, int ra,
                                           const float* B, int cx) {
  constexpr int RS = R / NI, NH = DH / 64;
  static_assert(RS % 8 == 0, "rows ra + RS i share ra's swizzle");
  const float* p0 = P + ra * TILE;
#pragma unroll(U)
  for (int c = 0; c < TILE / 4; ++c) {
    const int oa = (c ^ (ra & 7)) << 2;
    float a[NI][4];
#pragma unroll
    for (int i = 0; i < NI; ++i) ld4(a[i], p0 + RS * i * TILE + oa);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int n = 4 * c + u;
      float b[NH][4];
#pragma unroll
      for (int h = 0; h < NH; ++h)
        ld4(b[h], B + chunk_at<DH>(n, cx + 16 * h));
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int h = 0; h < NH; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[i][4 * h + e] = fmaf(a[i][u], b[h][e], acc[i][4 * h + e]);
    }
  }
}

// The f32 kernels copy 16 bytes (4 floats) at a time: every operand starts
// on 16 bytes and every stride is a multiple of 4 elements.
inline bool misaligned(const void* const* ptrs, int n, Layout ql, Layout kl) {
  for (int i = 0; i < n; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16) return true;
  return (ql.sb | ql.sh | ql.sl | kl.sb | kl.sh | kl.sl) % 4 != 0;
}

// ---------------------------------------------------------------------------
// The f32 online-softmax loop of the forward and the ring block
//
// One block of 256 threads per (batch*head, ROWS = 128 query rows). Q stays
// in shared memory; K, V and the key bias stream in tiles of 64 keys through
// two cp.async stages. Per tile t, on stage t % 2:
//   wait for tile t's copies; barrier (tile t is in shared memory, every
//   thread is done with tile t - 1, so the other stage and P are free);
//   start the copies of tile t + 1 into the other stage;
//   S = Q.K^T on all 256 threads, 4 rows x 8 keys each (rows rq + 32 i,
//   keys rk + 8 j: the 8 threads of a row are 8 lanes of one warp, so its
//   max and sum reduce over shuffles 1, 2 and 4); the online softmax on the
//   same threads, in registers; p (* keep) to shared memory, alpha (the
//   row's rescale) too; barrier;
//   acc = acc * alpha + P.V on all 256 threads, 8 rows x 8 columns each
//   (rows ra + 16 i, columns 4 (cx + 16 h) + e): S and O tile the rows
//   differently, so alpha reaches acc through shared memory.
// A ragged last query tile of at most NR = 32 rows computes only those (S
// 1 row x 8 keys a thread, acc 2 rows x 8), and the grid launches every
// full tile first: at 8 x 2080 the 64 tiles of 32 rows fill the ninth
// wave's gaps instead of being a ninth wave of full tiles (attend_block,
// attend_grid). Only a grid that holds both full and ragged tiles takes
// that path (attend_tails): a kernel that compiles the 128-row loop alone
// starts faster (32 x 107: 0.080 against 0.117 ms on an H100), which is
// all a grid of one tile per batch*head needs.
// Keys past Lk are excluded (s = -inf, p = 0: they enter neither the max,
// the sum nor the product); every tile holds key k0 < Lk, so the running max
// is finite after the first tile. Summation order: the tiles' (the f32
// limit of the forward, 1e-4 absolute, leaves it free).
//
// The forward and the ring block differ only in compile-time choices:
//             forward (RING false)             ring block (RING true)
//   scale     after the dot                    q * scale in f32, before it
//   state     starts at (-inf, 0, 0)           (m, l, acc) read from global
//                                              memory unless `first`, always
//                                              written back
//   dropout   the reference hash, taken once   none
//             per row and tile
//   end       out = acc / max(l, 1e-30),       nothing more (ring_finish)
//             lse = m + log(max(l, 1e-30))

constexpr int ROWS = 128;  // query rows per block
// How deep the products' chunk loops unroll (chunks of 4 of the depth: 32
// in S at DH 128, 16 in P.V), chosen on the card with
// scripts/bench_flash_fwd_ring.py (PERF.md §6): 2 deep is 3-6 % slower at
// 8 x 2080, 8 deep 17 % slower at 32 x 160 (a kernel this short pays for
// fetching its code).
constexpr int ATTEND_UNROLL_S = 4, ATTEND_UNROLL_O = 4;

struct AttendArgs {
  const float *q, *k, *v;
  const float* mask;   // (B, Lk) key mask, 1 = valid; batch stride mask_sb
  float *out, *lse;    // forward: (B, Lq, D) as q, (BH, Lq)
  float *m, *l, *acc;  // ring: the state, (BH, Lq) and (BH, Lq, dh), dense
  int H, Lq, Lk, dh;
  Layout ql, kl;
  long long mask_sb;
  float scale;
  Dropout drop;  // forward only; off when drop.seed is null
  int first;     // ring only: the state is not read
};

template <int DH>
constexpr size_t attend_smem() {  // Q; K, V x 2; P; key bias x 2; alpha, l
  return sizeof(float) *
         (ROWS * DH + 4 * TILE * DH + ROWS * TILE + 2 * TILE + 2 * ROWS);
}

// One block per (batch*head, query tile), full tiles first (attend_block).
inline dim3 attend_grid(int BH, int Lq) {
  return dim3((unsigned)BH * ((Lq + ROWS - 1) / ROWS));
}

// Whether a grid over Lq query rows holds full tiles and a ragged last one,
// so that its kernel takes attend_block's tail path.
inline bool attend_tails(int Lq) { return Lq > ROWS && Lq % ROWS != 0; }

// The loop on the block of (bh, rows [q0, q0 + NR)).
template <int DH, bool RING, int NR>
__device__ __forceinline__ void attend(const AttendArgs& a, int bh, int q0) {
  constexpr int TF = TILE * DH;
  constexpr int NH = DH / 64;  // float4 columns of acc per row: cx + 16 h
  constexpr int NS = NR / 32;  // S rows of a thread: rq + 32 i
  constexpr int NO = NR / 16;  // acc rows of a thread: ra + 16 i
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  float* const Qs = smem;                  // NR x DH
  float* const Ks = Qs + ROWS * DH;        // stage st at Ks + st * TF
  float* const Vs = Ks + 2 * TF;
  float* const Ps = Vs + 2 * TF;           // NR x TILE: p (* keep)
  float* const Bs = Ps + ROWS * TILE;      // 2 x TILE key bias
  float* const As = Bs + 2 * TILE;         // NR: alpha of the tile
  float* const Ls = As + ROWS;             // NR: max(l, 1e-30) at the end

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int Lq = a.Lq, Lk = a.Lk, dh = a.dh;
  const float* qp = a.q + b * a.ql.sb + h * a.ql.sh;
  const float* kp = a.k + b * a.kl.sb + h * a.kl.sh;
  const float* vp = a.v + b * a.kl.sb + h * a.kl.sh;
  const float* mp = a.mask + b * a.mask_sb;
  const bool drop = !RING && a.drop.seed;
  const unsigned int seed_bh = drop ? flash::dropout_seed_bh(a.drop, bh, a.H) : 0u;

  copy_rows<DH, NR>(Qs, qp, a.ql.sl, q0, Lq, dh);
  copy_rows<DH>(Ks, kp, a.kl.sl, 0, Lk, dh);
  copy_rows<DH>(Vs, vp, a.kl.sl, 0, Lk, dh);
  sm90::cp_commit();
  if (tid < TILE) Bs[tid] = sm90::key_bias(mp, tid, Lk);
  if (RING) {  // q * scale
    cp_wait_all();
    scale_rows<DH, NR>(Qs, a.scale);
  }

  // S and the softmax: rows rq + 32 i, keys rk + 8 j of the tile
  const int rk = lane & 7, rq = 4 * warp + (lane >> 3);
  // acc: rows ra + 16 i, columns 4 (cx + 16 hh) + e
  const int ra = (warp & 1) * 8 + (lane & 7), cx = (warp >> 1) * 4 + (lane >> 3);
  const long long srow = (long long)bh * Lq + q0;  // state row of tile row 0
  const bool resume = RING && !a.first;
  float m[NS], l[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const bool in = resume && q0 + rq + 32 * i < Lq;
    m[i] = in ? a.m[srow + rq + 32 * i] : -INFINITY;
    l[i] = in ? a.l[srow + rq + 32 * i] : 0.f;
  }
  float acc[NO][DH / 16];
#pragma unroll
  for (int i = 0; i < NO; ++i)
#pragma unroll
    for (int hh = 0; hh < NH; ++hh) {
      const int row = ra + 16 * i, col = 4 * (cx + 16 * hh);
      float x[4] = {0.f, 0.f, 0.f, 0.f};
      if (resume && q0 + row < Lq && col < dh)
        ld4(x, a.acc + (srow + row) * dh + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][4 * hh + e] = x[e];
    }

  const int n_tiles = (Lk + TILE - 1) / TILE;
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    const int k0 = t * TILE;
    cp_wait_all();
    __syncthreads();  // tile t is in; every thread is done with tile t - 1
    float next_bias = 0.f;
    if (t + 1 < n_tiles) {
      copy_rows<DH>(Ks + (st ^ 1) * TF, kp, a.kl.sl, k0 + TILE, Lk, dh);
      copy_rows<DH>(Vs + (st ^ 1) * TF, vp, a.kl.sl, k0 + TILE, Lk, dh);
      sm90::cp_commit();
      if (tid < TILE) next_bias = sm90::key_bias(mp, k0 + TILE + tid, Lk);
    }

    float s[NS][8];
#pragma unroll
    for (int i = 0; i < NS; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
    scores<DH, ATTEND_UNROLL_S, 32>(s, Qs, rq, Ks + st * TF, rk);

    const float* bt = Bs + st * TILE;
    float bias[8];  // -inf past Lk: the key is left out
#pragma unroll
    for (int j = 0; j < 8; ++j)
      bias[j] = k0 + rk + 8 * j < Lk ? bt[rk + 8 * j] : -INFINITY;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = (RING ? s[i][j] : s[i][j] * a.scale) + bias[j];
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);  // 0 on a row's first tile
      const unsigned int hx =  // dropout hash input at (row, k0)
          drop ? flash::dropout_hash_input(a.drop, seed_bh, q0 + rq + 32 * i, k0)
               : 0u;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float p = expf(s[i][j] - m_new);
        rs += p;  // the denominator takes p before dropout
        if (drop) p *= flash::dropout_keep(a.drop, hx + rk + 8 * j);
        Ps[elem_at<TILE>(rq + 32 * i, rk + 8 * j)] = p;
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
      if (rk == 0) As[rq + 32 * i] = alpha;
    }
    __syncthreads();  // p and alpha are complete

#pragma unroll
    for (int i = 0; i < NO; ++i) {
      const float alpha = As[ra + 16 * i];
#pragma unroll
      for (int c = 0; c < DH / 16; ++c) acc[i][c] *= alpha;
    }
    accumulate<DH, NO, ATTEND_UNROLL_O, NR>(acc, Ps, ra, Vs + st * TF, cx);
    if (tid < TILE && t + 1 < n_tiles) Bs[(st ^ 1) * TILE + tid] = next_bias;
  }

  if (RING) {
    if (rk == 0)
#pragma unroll
      for (int i = 0; i < NS; ++i)
        if (q0 + rq + 32 * i < Lq) {
          a.m[srow + rq + 32 * i] = m[i];
          a.l[srow + rq + 32 * i] = l[i];
        }
#pragma unroll
    for (int i = 0; i < NO; ++i)
#pragma unroll
      for (int hh = 0; hh < NH; ++hh) {
        const int row = ra + 16 * i, col = 4 * (cx + 16 * hh);
        if (q0 + row < Lq && col < dh) {
          float x[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) x[e] = acc[i][4 * hh + e];
          st4(a.acc + (srow + row) * dh + col, x);
        }
      }
    return;
  }

  if (rk == 0)
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int row = rq + 32 * i;
      const float l_safe = fmaxf(l[i], 1e-30f);
      Ls[row] = l_safe;
      if (q0 + row < Lq) a.lse[srow + row] = m[i] + logf(l_safe);
    }
  __syncthreads();  // every row's l is in Ls
  float* op = a.out + b * a.ql.sb + h * a.ql.sh;
#pragma unroll
  for (int i = 0; i < NO; ++i) {
    const int row = ra + 16 * i;
    const float l_safe = Ls[row];
#pragma unroll
    for (int hh = 0; hh < NH; ++hh) {
      const int col = 4 * (cx + 16 * hh);
      if (q0 + row < Lq && col < dh) {
        float x[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) x[e] = acc[i][4 * hh + e] / l_safe;
        st4(op + (long long)(q0 + row) * a.ql.sl + col, x);
      }
    }
  }
}

// The block's (bh, query tile) from attend_grid's one dimension: every
// (bh, full tile) first, bh-major (the blocks in flight share K and V in
// L2), then each bh's ragged last tile; with TAILS (attend_tails) a tile of
// at most 32 rows takes the 32-row loop, every other tile the 128-row one.
template <int DH, bool RING, bool TAILS>
__device__ __forceinline__ void attend_block(const AttendArgs& a) {
  const int n_full = a.Lq / ROWS;
  const int BH = (int)(gridDim.x / ((a.Lq + ROWS - 1) / ROWS));
  const int i = blockIdx.x;
  const int bh = i < BH * n_full ? i / n_full : i - BH * n_full;
  const int q0 = (i < BH * n_full ? i % n_full : n_full) * ROWS;
  const int nr = min(ROWS, a.Lq - q0);
  if (TAILS && nr <= 32)
    attend<DH, RING, 32>(a, bh, q0);
  else
    attend<DH, RING, 128>(a, bh, q0);
}

}  // namespace f32
