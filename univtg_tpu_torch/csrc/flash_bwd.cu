// Flash-attention backward for Hopper (sm_90a), f32 and bf16 inputs: the dQ
// kernel and the dK/dV kernel of FlashAttention-2, with in-kernel dropout.
//
// Replaces univtg_tpu/ops/pallas_attention.py:_bwd_dq_kernel and
// _bwd_dkv_kernel (launched from _bwd_impl). Both recompute the probabilities
// from the forward's per-row logsumexp instead of reading a stored L x L
// matrix:
//
//   s  = (q . k^T) * sm_scale + (1 - mask) * (-1e30)      as in flash_fwd.cu
//   p  = exp(s - lse)                                     f32
//   dp = (dO . v^T) * keep        keep = 0 or 1/(1-rate), the forward's mask
//   ds = p * (dp - delta)         delta = rowsum(dO * out), f32, computed by
//                                 the wrapper (the reference computes it
//                                 outside Pallas too)
//   dQ = sm_scale * cast(ds, T) . k                   accumulated in f32
//   dV = cast(p * keep, T)^T . dO                     accumulated in f32
//   dK = sm_scale * cast(ds, T)^T . q                 accumulated in f32
//
// The casts to the input dtype T sit where the reference's dots cast their
// operands (:244-247, :286-289, :296-299); dQ and dK carry sm_scale at the
// end (:251, :303). Keys past Lk and query rows past Lq are absent: p = 0
// there, so they add nothing to any sum. The dropout mask is the reference's
// hash (flash_common.cuh), taken at each element's global (query, key).
// One kernel per output, as in the reference, so nothing is carried across
// blocks, no atomics are needed and the same input gives the same bits.
//
// The dtype picks the design; this is a dispatch, not a fallback:
//
// bf16 -- tensor cores (flash_bwd_dq_kernel_sm90, flash_bwd_dkv_kernel_sm90,
// templated on the head dim padded to DH = 64 or 128, the padding zero-filled
// in shared memory). Every product is a wgmma m64n64k16 (bf16 in, f32
// accumulate), issued by one warpgroup: a block is one warpgroup of 128
// threads and 64 resident rows, and two blocks share an SM, so one block's
// exp and casts overlap the other's products.
//   dQ:    one block per (batch*head, 64 queries). Q and dO are resident;
//          K, V and the key mask stream in tiles of 64 keys. S = Q.K^T and
//          dP = dO.V^T read both operands from shared memory (K-major);
//          cast(ds) stays in registers, where the accumulator's layout is
//          already wgmma's register-A layout, and dQ += dS.K reads K as the
//          MN-major B operand.
//   dK/dV: one block per (batch*head, 64 keys). K and V are resident; Q,
//          dO, lse and delta stream in tiles of 64 queries. The products are
//          taken transposed, S^T = K.Q^T and dP^T = V.dO^T, so cast(p * keep)^T
//          and cast(ds)^T land in registers with keys as rows and feed
//          dV += P^T.dO and dK += dS^T.Q as register-A operands, dO and Q as
//          MN-major B operands. p and ds never go through shared memory.
//   The building blocks (tiles, copies, descriptors, products, fragment
//   positions) are flash_sm90.cuh's, shared with the bf16 forward and
//   ring kernels.
//   Tiles are stored in 64-column atoms with the 128-byte swizzle that the
//   wgmma descriptors name; the streamed tiles sit in a ring of two stages
//   filled by cp.async (16 bytes a thread, zero-filled past L and dh). The
//   copies of tile t + 1 run under tile t's arithmetic (the loop is spelled
//   out above the dQ kernel). cp.async and not TMA: the zero fill of a padded head dim and of
//   ragged rows comes with the copy, and no tensor map has to be encoded on
//   the host per call.
//   Registers bound the design: at DH 128 a thread of the dK/dV kernel holds
//   dK and dV (128 f32) plus S^T and dP^T (64 f32) and the bf16 fragments
//   of the products in flight; 64-row tiles keep that under 255 and two
//   blocks' worth of registers within an SM (chip_smoke.py phase 2 prints
//   ptxas's registers and spills beside the HGMMA count).
//   Bound on the card: compute at the long training shape. dQ does 3 products
//   (s, dp, ds.k): 6 * BH * Lq * Lk * dh FLOP; dK/dV does 4 (s, dp, p^T.dO,
//   ds^T.q): 8 * BH * Lq * Lk * dh FLOP; at B=8 L=2080 H=8 dh=128, 2.13e11 and
//   2.84e11 FLOP, 0.215 and 0.287 ms at the bf16 peak (989 TFLOP/s). At
//   B=32 L=107 the byte bound and, in practice, the launch set the floor.
//   Dropout: a 64-aligned tile lies inside one block of the dropout grid,
//   so each thread takes the hash input once per row (or key) and tile
//   (flash::dropout_hash_input) and per element only adds its offset and
//   runs the finalizer (flash::dropout_keep).
//   What it leaves: within a block every product is waited for before the
//   next step (only the other block on the SM fills the gaps); no producer
//   warp or TMA multicast; every dK/dV
//   block re-reads all of Q and dO; the exp, in f32 as the reference takes
//   it, and the dropout finalizer (~8 integer operations) run per element
//   in both kernels.
//
// f32 -- CUDA cores (flash_bwd_dq_kernel, flash_bwd_dkv_kernel, templated on
// the head dim padded to DH = 64 or 128, zero-filled): TF32 tensor cores
// would miss the f32 limit (rel 2e-6), and f32 is the correctness path
// (chip_smoke.py holds f32 "pallas" train steps against "xla"). Plain f32
// FFMA, expf as the reference. The SGEMM recipe: one block of 256 threads
// per (batch*head, 64 rows), one block per SM (the f32 tiles take 224.5 and
// 225 KB of shared memory at DH 128); each thread computes an outer-product
// tile
// in registers from float4 reads along the product's depth, so a warp's 32
// threads read a few distinct 16-byte chunks per 128 FFMA (every tile
// row-major with an XOR swizzle of its 16-byte chunks, conflict-free).
//   Score products: threads [0, 128) compute S (4 rows x 8 keys each),
//          threads [128, 256) dP, 12 float4 reads per 128 FFMA; both go to
//          shared memory, where all 256 threads turn them into ds (and
//          p * keep).
//   dQ:    dQ += dS.K on all 256 threads, 4 rows x 8 columns each.
//   dK/dV: dV += (P*keep)^T.dO on threads [0, 128) and dK += dS^T.Q on
//          [128, 256), 8 keys x 8 columns each: 16 float4 reads per 256
//          FFMA.
//   The streamed tiles (K, V and the key bias in dQ; Q, dO, lse and delta
//   in dK/dV) sit in two stages filled by cp.async (16 bytes a thread,
//   zero-filled past L and dh): tile t + 1's copies run under tile t's
//   arithmetic (the loop is spelled out at the head of the f32 kernels).
//   Bound on the card: the f32 FMA rate (67 TFLOP/s), 3.17 and 4.23 ms at
//   the long training shape. What it leaves: one block per SM, so the
//   barriers (three per tile) stall all 8 warps; S, dP and dQ tiles of
//   4 x 8 (2.7 FFMA per word a thread reads): 8 x 8 needs 128-key tiles,
//   which fit in one stage only and ran slower at 254 registers, and a dQ
//   split over two halves of the keys sums in another order than the twin
//   (~2e-6 apart at 2080 keys, the f32 limit); exp and the dropout
//   finalizer per element, between two barriers, with no product under
//   them.
//
// Built by univtg_tpu_torch/ops/cuda_build.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and called through ctypes by univtg_tpu_torch/ops/flash_attention.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "flash_f32.cuh"
#include "flash_sm90.cuh"

namespace {

using flash::Dropout;
using flash::Layout;
using flash::NEG_INF;

typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------------------
// f32: CUDA cores
//
// Both kernels run one loop per streamed tile t, on stage t % 2:
//   wait for tile t's copies; barrier (tile t is in shared memory, every
//   thread is done with tile t - 1, so the other stage is free);
//   start the copies of tile t + 1 into the other stage;
//   the score products: threads [0, 128) take S, threads [128, 256) dP, each
//   an outer-product tile of 4 x 8 from float4 reads along the head dim;
//   S's half writes p's exponent (-inf outside [0, Lq) x [0, Lk)) to shared
//   memory, dP's half dp; barrier;
//   the element-wise step on all 256 threads, one row and 16 columns each:
//   the dropout keep, p = exp, ds (and, in dK/dV, p * keep) over the same
//   elements; barrier;
//   the last products from shared memory: dQ += dS.K on all 256 threads
//   (4 x 8 a thread), or dV += (P*keep)^T.dO on threads [0, 128) and
//   dK += dS^T.Q on [128, 256) (8 x 8 a thread).
// The tiles, copies and products are flash_f32.cuh's, shared with the f32
// forward and ring block; dK/dV's tiles fill 230,400 of the 232,448 bytes a
// block may use.

using f32::accumulate;
using f32::chunk_at;
using f32::copy_rows;
using f32::cp_wait_all;
using f32::elem_at;
using f32::ld4;
using f32::MAX_DH;
using f32::scores;
using f32::st4;
using f32::THREADS;
using f32::TILE;

// How deep the products' chunk loops unroll (chunks of 4 of the depth: 32
// in the score products at DH 128, 16 in the last ones), chosen on the card
// with scripts/bench_flash_bwd_tiles.py (PERF.md §6): dQ's score loop in
// full and its last 8 deep, dK/dV's score loop 8 deep and its last in full
// (both in full: 2.2x slower).
constexpr int DQ_UNROLL_S = 32, DQ_UNROLL_A = 8;
constexpr int DKV_UNROLL_S = 8, DKV_UNROLL_A = 16;

template <int DH>
constexpr size_t dq_smem_f32() {  // Q, dO; K, V x 2; p, ds; dp; key bias x 2
  return sizeof(float) * (6 * TILE * DH + 2 * TILE * TILE + 2 * TILE);
}
template <int DH>
constexpr size_t dkv_smem_f32() {  // K, V; Q, dO x 2; p*keep; ds; lse, delta
  return sizeof(float) * (6 * TILE * DH + 2 * TILE * TILE + 4 * TILE);
}

// One block per (batch*head, 64 queries). Q and dO are resident; K, V and
// the key bias stream in tiles of 64 keys.
template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ mask,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int H, int Lq, int Lk, int dh, Layout ql, Layout kl,
                    float sm_scale, Dropout drop) {
  constexpr int TF = TILE * DH;
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  float* const Qs = smem;
  float* const dOs = smem + TF;
  float* const Ks = smem + 2 * TF;  // stage st at Ks + st * TF
  float* const Vs = smem + 4 * TF;
  float* const Ps = smem + 6 * TF;     // TILE x TILE, query-major: the
                                       // exponent of p, then ds
  float* const Gs = Ps + TILE * TILE;  // TILE x TILE, query-major: dp
  float* const Bs = Gs + TILE * TILE;  // 2 x TILE key bias

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * TILE;
  const float* kp = k + b * kl.sb + h * kl.sh;
  const float* vp = v + b * kl.sb + h * kl.sh;
  const float* mp = mask + (long long)b * Lk;
  const unsigned int seed_bh =
      drop.seed ? flash::dropout_seed_bh(drop, bh, H) : 0u;

  copy_rows<DH>(Qs, q + b * ql.sb + h * ql.sh, ql.sl, q0, Lq, dh);
  copy_rows<DH>(dOs, dout + b * ql.sb + h * ql.sh, ql.sl, q0, Lq, dh);
  copy_rows<DH>(Ks, kp, kl.sl, 0, Lk, dh);
  copy_rows<DH>(Vs, vp, kl.sl, 0, Lk, dh);
  sm90::cp_commit();
  if (tid < TILE) Bs[tid] = sm90::key_bias(mp, tid, Lk);

  // S (threads [0, 128)) or dP ([128, 256)): query rows rq + 16 i, keys
  // rk + 8 j of the tile; a warp holds 32 rows x 32 keys
  const bool is_dp = tid >= THREADS / 2;
  const int rq = (warp & 1) * 8 + (lane & 7);
  const int rk = ((warp >> 1) & 1) * 4 + (lane >> 3);
  float rowv[4];  // lse of rows rq + 16 i (S's half)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rq + 16 * i;
    rowv[i] = row < Lq && !is_dp ? lse[(long long)bh * Lq + row] : 0.f;
  }
  // the element-wise step: row er of the tile on every thread
  const int er = tid & (TILE - 1);
  const float delta_r =
      q0 + er < Lq ? delta[(long long)bh * Lq + q0 + er] : 0.f;
  // dQ: rows ry + 16 i, columns 4 (cx + 16 h) + e
  const int ry = rq, cx = (warp >> 1) * 4 + (lane >> 3);
  float acc[4][DH / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DH / 16; ++c) acc[i][c] = 0.f;

  const int n_tiles = (Lk + TILE - 1) / TILE;  // key tiles
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    const int k0 = t * TILE;
    cp_wait_all();
    __syncthreads();  // tile t is in; every thread is done with tile t - 1
    float next_bias = 0.f;
    if (t + 1 < n_tiles) {
      copy_rows<DH>(Ks + (st ^ 1) * TF, kp, kl.sl, k0 + TILE, Lk, dh);
      copy_rows<DH>(Vs + (st ^ 1) * TF, vp, kl.sl, k0 + TILE, Lk, dh);
      sm90::cp_commit();
      if (tid < TILE) next_bias = sm90::key_bias(mp, k0 + TILE + tid, Lk);
    }

    float s[4][8];  // s, or dp
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
    scores<DH, DQ_UNROLL_S>(s, is_dp ? dOs : Qs, rq,
                            (is_dp ? Vs : Ks) + st * TF, rk);

    if (!is_dp) {  // the exponent of p, -inf outside [0, Lq) x [0, Lk)
      const float* bt = Bs + st * TILE;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + rq + 16 * i;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int key = rk + 8 * j;
          Ps[elem_at<TILE>(rq + 16 * i, key)] =
              row < Lq && k0 + key < Lk
                  ? s[i][j] * sm_scale + bt[key] - rowv[i]
                  : -INFINITY;
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          Gs[elem_at<TILE>(rq + 16 * i, rk + 8 * j)] = s[i][j];
    }
    __syncthreads();
    {  // row er of the tile, keys 4 c .. 4 c + 3 for c = (tid >> 6) + 4 u
      const unsigned int hx =  // dropout hash input at (row, k0)
          drop.seed ? flash::dropout_hash_input(drop, seed_bh, q0 + er, k0)
                    : 0u;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int c = (tid >> 6) + 4 * u;
        const int off = chunk_at<TILE>(er, c);
        float z[4], dp[4], ds[4];
        ld4(z, Ps + off);
        ld4(dp, Gs + off);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (drop.seed) dp[e] *= flash::dropout_keep(drop, hx + 4 * c + e);
          ds[e] = expf(z[e]) * (dp[e] - delta_r);  // ds = p * (dp - delta)
        }
        st4(Ps + off, ds);
      }
    }
    __syncthreads();  // ds is complete

    accumulate<DH, 4, DQ_UNROLL_A>(acc, Ps, ry, Ks + st * TF, cx);
    if (tid < TILE && t + 1 < n_tiles) Bs[(st ^ 1) * TILE + tid] = next_bias;
  }

  float* dqp = dq + b * ql.sb + h * ql.sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ry + 16 * i;
    if (row >= Lq) continue;
#pragma unroll
    for (int hh = 0; hh < DH / 64; ++hh) {
      const int col = 4 * (cx + 16 * hh);
      if (col < dh)
        *reinterpret_cast<float4*>(dqp + row * ql.sl + col) = make_float4(
            acc[i][4 * hh] * sm_scale, acc[i][4 * hh + 1] * sm_scale,
            acc[i][4 * hh + 2] * sm_scale, acc[i][4 * hh + 3] * sm_scale);
    }
  }
}

// One block per (batch*head, 64 keys). K and V are resident; Q, dO, lse and
// delta stream in tiles of 64 queries. The score products are taken
// transposed (S^T = K.Q^T, dP^T = V.dO^T), so p * keep and ds land key-major,
// as the A operands of dV and dK.
template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ mask,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int H, int Lq, int Lk, int dh,
                     Layout ql, Layout kl, float sm_scale, Dropout drop) {
  constexpr int TF = TILE * DH;
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  float* const Ks = smem;
  float* const Vs = smem + TF;
  float* const Qs = smem + 2 * TF;  // stage st at Qs + st * TF
  float* const dOs = smem + 4 * TF;
  float* const Pt = smem + 6 * TF;     // TILE x TILE, key-major: dp, then
                                       // p * keep
  float* const Dt = Pt + TILE * TILE;  // key-major: the exponent of p, then
                                       // ds
  float* const Ls = Dt + TILE * TILE;  // 2 x TILE lse
  float* const Ds = Ls + 2 * TILE;     // 2 x TILE delta

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.x * TILE;
  const float* qp = q + b * ql.sb + h * ql.sh;
  const float* op = dout + b * ql.sb + h * ql.sh;
  const float* mp = mask + (long long)b * Lk;
  const float* lp = lse + (long long)bh * Lq;
  const float* dlp = delta + (long long)bh * Lq;
  const unsigned int seed_bh =
      drop.seed ? flash::dropout_seed_bh(drop, bh, H) : 0u;

  copy_rows<DH>(Ks, k + b * kl.sb + h * kl.sh, kl.sl, k0, Lk, dh);
  copy_rows<DH>(Vs, v + b * kl.sb + h * kl.sh, kl.sl, k0, Lk, dh);
  copy_rows<DH>(Qs, qp, ql.sl, 0, Lq, dh);
  copy_rows<DH>(dOs, op, ql.sl, 0, Lq, dh);
  sm90::cp_commit();
  if (tid < TILE) {
    Ls[tid] = tid < Lq ? lp[tid] : 0.f;
    Ds[tid] = tid < Lq ? dlp[tid] : 0.f;
  }

  // S^T (threads [0, 128)) or dP^T ([128, 256)): keys rk + 16 i, query rows
  // rq + 8 j of the tile
  const bool is_dp = tid >= THREADS / 2;
  const int rk = (warp & 1) * 8 + (lane & 7);
  const int rq = ((warp >> 1) & 1) * 4 + (lane >> 3);
  float bias[4];  // of keys rk + 16 i
#pragma unroll
  for (int i = 0; i < 4; ++i)
    bias[i] = sm90::key_bias(mp, k0 + rk + 16 * i, Lk);
  // dV (threads [0, 128)) or dK: keys kx + 8 i, columns 4 (cx + 16 h) + e
  const int kx = lane & 7, cx = (warp & 3) * 4 + (lane >> 3);
  const int er = tid & (TILE - 1);  // the element-wise step's key
  float acc[8][DH / 16];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < DH / 16; ++c) acc[i][c] = 0.f;

  const int n_tiles = (Lq + TILE - 1) / TILE;
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    const int q0 = t * TILE;
    cp_wait_all();
    __syncthreads();
    float next_l = 0.f, next_d = 0.f;
    if (t + 1 < n_tiles) {
      copy_rows<DH>(Qs + (st ^ 1) * TF, qp, ql.sl, q0 + TILE, Lq, dh);
      copy_rows<DH>(dOs + (st ^ 1) * TF, op, ql.sl, q0 + TILE, Lq, dh);
      sm90::cp_commit();
      const int row = q0 + TILE + tid;
      if (tid < TILE && row < Lq) {
        next_l = lp[row];
        next_d = dlp[row];
      }
    }

    float s[4][8];  // s^T, or dp^T
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
    scores<DH, DKV_UNROLL_S>(s, is_dp ? Vs : Ks, rk,
                             (is_dp ? dOs : Qs) + st * TF, rq);

    if (!is_dp) {  // the exponent of p, -inf outside [0, Lk) x [0, Lq)
      const float* lt = Ls + st * TILE;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + rk + 16 * i;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = rq + 8 * j;
          Dt[elem_at<TILE>(rk + 16 * i, col)] =
              q0 + col < Lq && key < Lk
                  ? s[i][j] * sm_scale + bias[i] - lt[col]
                  : -INFINITY;
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          Pt[elem_at<TILE>(rk + 16 * i, rq + 8 * j)] = s[i][j];
    }
    __syncthreads();
    {  // key er of the tile, queries 4 c .. 4 c + 3 for c = (tid >> 6) + 4 u
      const float* dt = Ds + st * TILE;
      const unsigned int hx =  // dropout hash input at (q0, key)
          drop.seed ? flash::dropout_hash_input(drop, seed_bh, q0, k0 + er)
                    : 0u;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int c = (tid >> 6) + 4 * u;
        const int off = chunk_at<TILE>(er, c);
        float z[4], dp[4], ds[4], pk[4];
        ld4(z, Dt + off);
        ld4(dp, Pt + off);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float keep =
              drop.seed ? flash::dropout_keep(drop, hx + 65599u * (4 * c + e))
                        : 1.f;
          const float p = expf(z[e]);
          ds[e] = p * (dp[e] * keep - dt[4 * c + e]);  // ds = p * (dp - delta)
          pk[e] = p * keep;
        }
        st4(Dt + off, ds);
        st4(Pt + off, pk);
      }
    }
    __syncthreads();  // p * keep and ds are complete

    accumulate<DH, 8, DKV_UNROLL_A>(acc, is_dp ? Dt : Pt, kx,
                                    (is_dp ? Qs : dOs) + st * TF, cx);
    if (tid < TILE && t + 1 < n_tiles) {
      Ls[(st ^ 1) * TILE + tid] = next_l;
      Ds[(st ^ 1) * TILE + tid] = next_d;
    }
  }

  float* out = (is_dp ? dk : dv) + b * kl.sb + h * kl.sh;
  const float scale = is_dp ? sm_scale : 1.f;  // dK carries sm_scale
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int key = k0 + kx + 8 * i;
    if (key >= Lk) continue;
#pragma unroll
    for (int hh = 0; hh < DH / 64; ++hh) {
      const int col = 4 * (cx + 16 * hh);
      if (col < dh)
        *reinterpret_cast<float4*>(out + key * kl.sl + col) = make_float4(
            acc[i][4 * hh] * scale, acc[i][4 * hh + 1] * scale,
            acc[i][4 * hh + 2] * scale, acc[i][4 * hh + 3] * scale);
    }
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma; the building blocks are flash_sm90.cuh's)

namespace sm90 {

template <int DH>
constexpr size_t dq_smem() {  // Q, dO; K, V x 2 stages; key bias x 2
  return 6 * tile_bytes<DH>() + 2 * TILE_ROWS * 4 + 1024;
}
template <int DH>
constexpr size_t dkv_smem() {  // K, V; Q, dO x 2 stages; lse, delta x 2
  return 6 * tile_bytes<DH>() + 4 * TILE_ROWS * 4 + 1024;
}

// Both kernels run one loop per streamed tile t, on stage t % 2:
//   start the copies of tile t + 1 into the other stage (a group that may
//   be empty, so that one group is committed per tile);
//   wait for tile t's copies; barrier;
//   the first two products (S, dP), waited for;
//   p, ds and their bf16 casts in registers;
//   the last products (dQ, or dV and dK), waited for; barrier: every warp
//   is done with stage t % 2.
// Keeping the last products in flight under the next tile's first ones
// would need their bf16 fragments live across the loop: at DH 128 ptxas
// then spills and serializes the products (C7515), which measured slower.

template <int DH>
__global__ void __launch_bounds__(WG_THREADS, 2)
flash_bwd_dq_kernel_sm90(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ mask,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, bf16* __restrict__ dq,
                         int H, int Lq, int Lk, int dh, Layout ql, Layout kl,
                         float sm_scale, Dropout drop) {
  constexpr int NT = DH / 64;  // 64-column slices of dQ
  constexpr uint32_t TB = tile_bytes<DH>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t Qs = (raw + 1023) & ~1023u;
  const uint32_t dOs = Qs + TB, Ks = Qs + 2 * TB, Vs = Ks + 2 * TB;
  float* const Bs = reinterpret_cast<float*>(smem_raw + (Vs + 2 * TB - raw));

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * TILE_ROWS;
  const bf16* kp = k + b * kl.sb + h * kl.sh;
  const bf16* vp = v + b * kl.sb + h * kl.sh;
  const float* mp = mask + (long long)b * Lk;
  const unsigned int seed_bh =
      drop.seed ? flash::dropout_seed_bh(drop, bh, H) : 0u;

  load_tile<DH>(Qs, q + b * ql.sb + h * ql.sh, ql.sl, q0, Lq, dh);
  load_tile<DH>(dOs, dout + b * ql.sb + h * ql.sh, ql.sl, q0, Lq, dh);
  load_tile<DH>(Ks, kp, kl.sl, 0, Lk, dh);
  load_tile<DH>(Vs, vp, kl.sl, 0, Lk, dh);
  if (tid < TILE_ROWS) Bs[tid] = key_bias(mp, tid, Lk);
  cp_commit();

  float lse_r[2], delta_r[2];  // this thread's two query rows
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int row = q0 + frag_row(2 * j);
    lse_r[j] = row < Lq ? lse[(long long)bh * Lq + row] : 0.f;
    delta_r[j] = row < Lq ? delta[(long long)bh * Lq + row] : 0.f;
  }
  float acc[NT][32];
  zero(acc);

  const int n_tiles = (Lk + TILE_ROWS - 1) / TILE_ROWS;
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    const int k0 = t * TILE_ROWS;
    if (t + 1 < n_tiles) {  // the next tile into the other stage
      const int k1 = k0 + TILE_ROWS;
      load_tile<DH>(Ks + (st ^ 1) * TB, kp, kl.sl, k1, Lk, dh);
      load_tile<DH>(Vs + (st ^ 1) * TB, vp, kl.sl, k1, Lk, dh);
      if (tid < TILE_ROWS)
        Bs[(st ^ 1) * TILE_ROWS + tid] = key_bias(mp, k1 + tid, Lk);
    }
    cp_commit();
    cp_wait_prev();
    __syncthreads();  // tile t is in shared memory for every warp

    const uint32_t Kt = Ks + st * TB, Vt = Vs + st * TB;
    const float* bt = Bs + st * TILE_ROWS;
    float sd[2][32];  // s, then ds; dp
    zero(sd);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks)
      mma_ss(sd[0], desc_k(Qs, ks), desc_k(Kt, ks));
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks)
      mma_ss(sd[1], desc_k(dOs, ks), desc_k(Vt, ks));
    wg_commit();
    wg_wait(sd);

    unsigned int hx[2] = {0u, 0u};  // dropout hash input at (row, k0)
    if (drop.seed)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        hx[j] = flash::dropout_hash_input(drop, seed_bh, q0 + frag_row(2 * j),
                                          k0);
    float(&s)[32] = sd[0];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int j = (i >> 1) & 1;
      const int row = q0 + frag_row(i);
      const int col = frag_col(i);
      float ds = 0.f;
      if (row < Lq && k0 + col < Lk) {
        const float p = expf(s[i] * sm_scale + bt[col] - lse_r[j]);
        float dpv = sd[1][i];
        if (drop.seed) dpv *= flash::dropout_keep(drop, hx[j] + col);
        ds = p * (dpv - delta_r[j]);
      }
      s[i] = ds;
    }
    uint32_t dsf[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) dsf[i] = pack_bf16(s[2 * i], s[2 * i + 1]);

    wg_fence();
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int ks = 0; ks < TILE_ROWS / 16; ++ks)
        mma_rs(acc[n], dsf[4 * ks], dsf[4 * ks + 1], dsf[4 * ks + 2],
               dsf[4 * ks + 3], desc_mn(Kt, ks, n));
    wg_commit();
    wg_wait(acc);
    __syncthreads();  // every warp is done with this stage
  }

  bf16* dqp = dq + b * ql.sb + h * ql.sh;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int row = q0 + frag_row(i);
      const int col = 64 * n + frag_col(i);
      if (row < Lq && col < dh)
        *reinterpret_cast<__nv_bfloat162*>(dqp + row * ql.sl + col) =
            __floats2bfloat162_rn(acc[n][i] * sm_scale,
                                  acc[n][i + 1] * sm_scale);
    }
}

template <int DH>
__global__ void __launch_bounds__(WG_THREADS, 2)
flash_bwd_dkv_kernel_sm90(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const bf16* __restrict__ dout,
                          const float* __restrict__ mask,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv, int H,
                          int Lq, int Lk, int dh, Layout ql, Layout kl,
                          float sm_scale, Dropout drop) {
  constexpr int NT = DH / 64;
  constexpr uint32_t TB = tile_bytes<DH>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t Ks = (raw + 1023) & ~1023u;
  const uint32_t Vs = Ks + TB, Qs = Ks + 2 * TB, dOs = Qs + 2 * TB;
  float* const Ls = reinterpret_cast<float*>(smem_raw + (dOs + 2 * TB - raw));
  float* const Ds = Ls + 2 * TILE_ROWS;

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.x * TILE_ROWS;
  const bf16* qp = q + b * ql.sb + h * ql.sh;
  const bf16* op = dout + b * ql.sb + h * ql.sh;
  const float* mp = mask + (long long)b * Lk;
  const float* lp = lse + (long long)bh * Lq;
  const float* dlp = delta + (long long)bh * Lq;
  const unsigned int seed_bh =
      drop.seed ? flash::dropout_seed_bh(drop, bh, H) : 0u;

  load_tile<DH>(Ks, k + b * kl.sb + h * kl.sh, kl.sl, k0, Lk, dh);
  load_tile<DH>(Vs, v + b * kl.sb + h * kl.sh, kl.sl, k0, Lk, dh);
  load_tile<DH>(Qs, qp, ql.sl, 0, Lq, dh);
  load_tile<DH>(dOs, op, ql.sl, 0, Lq, dh);
  if (tid < TILE_ROWS) {
    Ls[tid] = tid < Lq ? lp[tid] : 0.f;
    Ds[tid] = tid < Lq ? dlp[tid] : 0.f;
  }
  cp_commit();

  float bias[2];  // this thread's two keys
#pragma unroll
  for (int j = 0; j < 2; ++j) bias[j] = key_bias(mp, k0 + frag_row(2 * j), Lk);
  float dkv[2 * NT][32];  // dK slices, then dV slices
  zero(dkv);

  const int n_tiles = (Lq + TILE_ROWS - 1) / TILE_ROWS;
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    const int q0 = t * TILE_ROWS;
    if (t + 1 < n_tiles) {
      const int q1 = q0 + TILE_ROWS;
      load_tile<DH>(Qs + (st ^ 1) * TB, qp, ql.sl, q1, Lq, dh);
      load_tile<DH>(dOs + (st ^ 1) * TB, op, ql.sl, q1, Lq, dh);
      if (tid < TILE_ROWS) {
        const int row = q1 + tid;
        Ls[(st ^ 1) * TILE_ROWS + tid] = row < Lq ? lp[row] : 0.f;
        Ds[(st ^ 1) * TILE_ROWS + tid] = row < Lq ? dlp[row] : 0.f;
      }
    }
    cp_commit();
    cp_wait_prev();
    __syncthreads();

    const uint32_t Qt = Qs + st * TB, dOt = dOs + st * TB;
    const float* lt = Ls + st * TILE_ROWS;
    const float* dt = Ds + st * TILE_ROWS;
    float sd[2][32];  // s^T, then cast(p * keep)^T; dp^T, then ds^T
    zero(sd);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks)
      mma_ss(sd[0], desc_k(Ks, ks), desc_k(Qt, ks));
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks)
      mma_ss(sd[1], desc_k(Vs, ks), desc_k(dOt, ks));
    wg_commit();
    wg_wait(sd);

    unsigned int hx[2] = {0u, 0u};  // dropout hash input at (q0, key)
    if (drop.seed)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        hx[j] = flash::dropout_hash_input(drop, seed_bh, q0,
                                          k0 + frag_row(2 * j));
    float(&s)[32] = sd[0];
    float(&dp)[32] = sd[1];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int j = (i >> 1) & 1;
      const int key = k0 + frag_row(i);
      const int col = frag_col(i);
      const int row = q0 + col;
      float p_keep = 0.f, ds = 0.f;
      if (row < Lq && key < Lk) {
        const float p = expf(s[i] * sm_scale + bias[j] - lt[col]);
        float dpv = dp[i];
        p_keep = p;
        if (drop.seed) {
          const float keep = flash::dropout_keep(drop, hx[j] + 65599u * col);
          p_keep = p * keep;
          dpv *= keep;
        }
        ds = p * (dpv - dt[col]);
      }
      s[i] = p_keep;
      dp[i] = ds;
    }
    uint32_t ptf[16], dstf[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) ptf[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
#pragma unroll
    for (int i = 0; i < 16; ++i) dstf[i] = pack_bf16(dp[2 * i], dp[2 * i + 1]);

    wg_fence();
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int ks = 0; ks < TILE_ROWS / 16; ++ks) {
        mma_rs(dkv[NT + n], ptf[4 * ks], ptf[4 * ks + 1], ptf[4 * ks + 2],
               ptf[4 * ks + 3], desc_mn(dOt, ks, n));
        mma_rs(dkv[n], dstf[4 * ks], dstf[4 * ks + 1], dstf[4 * ks + 2],
               dstf[4 * ks + 3], desc_mn(Qt, ks, n));
      }
    wg_commit();
    wg_wait(dkv);
    __syncthreads();
  }

  bf16* dkp = dk + b * kl.sb + h * kl.sh;
  bf16* dvp = dv + b * kl.sb + h * kl.sh;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int key = k0 + frag_row(i);
      const int col = 64 * n + frag_col(i);
      if (key < Lk && col < dh) {
        *reinterpret_cast<__nv_bfloat162*>(dkp + key * kl.sl + col) =
            __floats2bfloat162_rn(dkv[n][i] * sm_scale,
                                  dkv[n][i + 1] * sm_scale);
        *reinterpret_cast<__nv_bfloat162*>(dvp + key * kl.sl + col) =
            __floats2bfloat162_rn(dkv[NT + n][i], dkv[NT + n][i + 1]);
      }
    }
}

}  // namespace sm90

namespace {

using sm90::allow_smem;
using sm90::bad_bf16_grid;
using sm90::misaligned;

struct Args {
  const void *q, *k, *v, *dout;
  const float *mask, *lse, *delta;
  int BH, H, Lq, Lk, dh;
  Layout ql, kl;
  float sm_scale;
  Dropout drop;
  cudaStream_t stream;
};

template <int DH>
cudaError_t launch_dq_f32(const Args& a, void* dq) {
  constexpr size_t smem = dq_smem_f32<DH>();
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<DH>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Lq + TILE - 1) / TILE, a.BH);
  flash_bwd_dq_kernel<DH><<<grid, THREADS, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.mask, a.lse, a.delta, static_cast<float*>(dq), a.H, a.Lq, a.Lk, a.dh,
      a.ql, a.kl, a.sm_scale, a.drop);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_dkv_f32(const Args& a, void* dk, void* dv) {
  constexpr size_t smem = dkv_smem_f32<DH>();
  cudaError_t err = allow_smem(flash_bwd_dkv_kernel<DH>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Lk + TILE - 1) / TILE, a.BH);
  flash_bwd_dkv_kernel<DH><<<grid, THREADS, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.mask, a.lse, a.delta, static_cast<float*>(dk),
      static_cast<float*>(dv), a.H, a.Lq, a.Lk, a.dh, a.ql, a.kl, a.sm_scale,
      a.drop);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_dq_bf16(const Args& a, void* dq) {
  constexpr size_t smem = sm90::dq_smem<DH>();
  cudaError_t err = allow_smem(sm90::flash_bwd_dq_kernel_sm90<DH>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Lq + sm90::TILE_ROWS - 1) / sm90::TILE_ROWS, a.BH);
  sm90::flash_bwd_dq_kernel_sm90<DH><<<grid, sm90::WG_THREADS, smem,
                                       a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.mask,
      a.lse, a.delta, static_cast<bf16*>(dq), a.H, a.Lq, a.Lk, a.dh, a.ql,
      a.kl, a.sm_scale, a.drop);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_dkv_bf16(const Args& a, void* dk, void* dv) {
  constexpr size_t smem = sm90::dkv_smem<DH>();
  cudaError_t err = allow_smem(sm90::flash_bwd_dkv_kernel_sm90<DH>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Lk + sm90::TILE_ROWS - 1) / sm90::TILE_ROWS, a.BH);
  sm90::flash_bwd_dkv_kernel_sm90<DH><<<grid, sm90::WG_THREADS, smem,
                                        a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.mask,
      a.lse, a.delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), a.H,
      a.Lq, a.Lk, a.dh, a.ql, a.kl, a.sm_scale, a.drop);
  return cudaGetLastError();
}

bool bad_shape(int BH, int H, int Lq, int Lk, int dh, const void* seed,
               int drop_bq, int drop_bk) {
  return dh <= 0 || dh > MAX_DH || dh % 8 != 0 || Lq <= 0 || Lk <= 0 ||
         BH <= 0 || H <= 0 || BH % H != 0 || BH > 65535 ||
         (seed && (drop_bq <= 0 || drop_bk <= 0));
}

}  // namespace

extern "C" {

// q, dout and dq share one layout, k, v, dk and dv another (element strides
// of batch, head and row; the head dim is dense). mask is (BH / H, Lk) f32,
// lse and delta are (BH, Lq) f32, all dense. dtype: 0 = float32 (CUDA-core
// kernels), 1 = bfloat16 (wgmma kernels); either way q, k, v, dout and the
// outputs start on 16 bytes with strides of whole 16-byte chunks, or the
// call returns cudaErrorMisalignedAddress, and the dropout grid is in
// multiples of 64. seed: null for no
// dropout, else one int32 on the device; thresh, drop_scale and the dropout
// grid (drop_bq, drop_bk) and the hash's global heads (drop_heads,
// drop_head_off) as flash_common.cuh says, the same values the forward was
// given.
// Each returns a cudaError_t; 0 on success. Launches on `stream`, allocates
// nothing and does not synchronise.
int univtg_flash_bwd_dq(const void* q, const void* k, const void* v,
                        const void* dout, const void* mask, const void* lse,
                        const void* delta, void* dq, int dtype, int BH, int H,
                        int Lq, int Lk, int dh, long long q_sb, long long q_sh,
                        long long q_sl, long long k_sb, long long k_sh,
                        long long k_sl, float sm_scale, const void* seed,
                        unsigned int thresh, float drop_scale, int drop_bq,
                        int drop_bk, int drop_heads,
                        int drop_head_off, void* stream) {
  if (bad_shape(BH, H, Lq, Lk, dh, seed, drop_bq, drop_bk))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, dout, static_cast<const float*>(mask),
               static_cast<const float*>(lse), static_cast<const float*>(delta),
               BH, H, Lq, Lk, dh, Layout{q_sb, q_sh, q_sl},
               Layout{k_sb, k_sh, k_sl}, sm_scale,
               Dropout{static_cast<const int*>(seed), thresh, drop_scale,
                       drop_bq, drop_bk, drop_heads, drop_head_off},
               static_cast<cudaStream_t>(stream)};
  const void* ptrs[] = {q, k, v, dout, dq};
  // the f32 kernels, too, take a 64-row tile's dropout hash input from one
  // block of the grid
  if (bad_bf16_grid(a.drop)) return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    if (f32::misaligned(ptrs, 5, a.ql, a.kl))
      return (int)cudaErrorMisalignedAddress;
    return (int)(dh <= 64 ? launch_dq_f32<64>(a, dq)
                          : launch_dq_f32<128>(a, dq));
  }
  if (dtype == 1) {
    if (misaligned(ptrs, 5, a.ql, a.kl)) return (int)cudaErrorMisalignedAddress;
    return (int)(dh <= 64 ? launch_dq_bf16<64>(a, dq)
                          : launch_dq_bf16<128>(a, dq));
  }
  return (int)cudaErrorInvalidValue;
}

int univtg_flash_bwd_dkv(const void* q, const void* k, const void* v,
                         const void* dout, const void* mask, const void* lse,
                         const void* delta, void* dk, void* dv, int dtype,
                         int BH, int H, int Lq, int Lk, int dh, long long q_sb,
                         long long q_sh, long long q_sl, long long k_sb,
                         long long k_sh, long long k_sl, float sm_scale,
                         const void* seed, unsigned int thresh,
                         float drop_scale, int drop_bq, int drop_bk,
                         int drop_heads, int drop_head_off,
                         void* stream) {
  if (bad_shape(BH, H, Lq, Lk, dh, seed, drop_bq, drop_bk))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, dout, static_cast<const float*>(mask),
               static_cast<const float*>(lse), static_cast<const float*>(delta),
               BH, H, Lq, Lk, dh, Layout{q_sb, q_sh, q_sl},
               Layout{k_sb, k_sh, k_sl}, sm_scale,
               Dropout{static_cast<const int*>(seed), thresh, drop_scale,
                       drop_bq, drop_bk, drop_heads, drop_head_off},
               static_cast<cudaStream_t>(stream)};
  const void* ptrs[] = {q, k, v, dout, dk, dv};
  // the f32 kernels, too, take a 64-row tile's dropout hash input from one
  // block of the grid
  if (bad_bf16_grid(a.drop)) return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    if (f32::misaligned(ptrs, 6, a.ql, a.kl))
      return (int)cudaErrorMisalignedAddress;
    return (int)(dh <= 64 ? launch_dkv_f32<64>(a, dk, dv)
                          : launch_dkv_f32<128>(a, dk, dv));
  }
  if (dtype == 1) {
    if (misaligned(ptrs, 6, a.ql, a.kl)) return (int)cudaErrorMisalignedAddress;
    return (int)(dh <= 64 ? launch_dkv_bf16<64>(a, dk, dv)
                          : launch_dkv_bf16<128>(a, dk, dv));
  }
  return (int)cudaErrorInvalidValue;
}

const char* univtg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
