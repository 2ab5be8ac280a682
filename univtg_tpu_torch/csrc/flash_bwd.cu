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
// f32 -- CUDA cores (flash_bwd_dq_kernel, flash_bwd_dkv_kernel): TF32 tensor
// cores would miss the f32 limit (rel 2e-6), and f32 is the correctness path
// (chip_smoke.py holds f32 "pallas" train steps against "xla"). One block of
// 256 threads per (batch*head, 64-row tile), operands staged in shared memory
// as f32 with an odd row stride; bound by the f32 FMA rate (67 TFLOP/s):
// 3.17 and 4.23 ms at the long training shape.
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
#include "flash_sm90.cuh"

namespace {

using flash::Dropout;
using flash::Layout;
using flash::NEG_INF;

typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------------------
// f32: CUDA cores

constexpr int TILE = 64;      // query rows and keys per tile
constexpr int THREADS = 256;  // 16 row groups x 16 threads
constexpr int ROWS = 4;       // rows per thread (16 groups x 4 = 64)
constexpr int SCOLS = TILE / 16;     // score columns per thread
constexpr int MAX_DH = 128;
constexpr int OCOLS = MAX_DH / 16;   // output columns per thread, at most
constexpr int LDP = TILE + 1;        // p / ds tile row stride

// Stage rows [r0, r0 + TILE) of one head; rows past L are zero.
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src,
                                      long long sl, int r0, int L, int dh,
                                      int ld) {
  for (int e = threadIdx.x; e < TILE * dh; e += THREADS) {
    const int r = e / dh, c = e - r * dh;
    const int row = r0 + r;
    dst[r * ld + c] = row < L ? src[row * sl + c] : 0.f;
  }
}

__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ mask,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int H, int Lq, int Lk, int dh, Layout ql, Layout kl,
                    float sm_scale, Dropout drop) {
  extern __shared__ float smem[];
  const int ld = dh + 1;  // odd stride: column reads across rows hit distinct banks
  float* Qs = smem;               // TILE x ld
  float* dOs = Qs + TILE * ld;    // TILE x ld
  float* Ks = dOs + TILE * ld;    // TILE x ld
  float* Vs = Ks + TILE * ld;     // TILE x ld
  float* dSs = Vs + TILE * ld;    // TILE x LDP, query-major
  float* Ms = dSs + TILE * LDP;   // TILE key-mask values

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // key slot: keys tx + 16 j
  const int ty = tid >> 4;  // row group: query rows ty*ROWS .. ty*ROWS+3
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * TILE;

  const float* kp = k + b * kl.sb + h * kl.sh;
  const float* vp = v + b * kl.sb + h * kl.sh;
  const float* mp = mask + (long long)b * Lk;
  const unsigned int seed_bh =
      drop.seed ? flash::dropout_seed_bh(drop, bh) : 0u;

  stage(Qs, q + b * ql.sb + h * ql.sh, ql.sl, q0, Lq, dh, ld);
  stage(dOs, dout + b * ql.sb + h * ql.sh, ql.sl, q0, Lq, dh, ld);
  float lse_r[ROWS], delta_r[ROWS], acc[ROWS][OCOLS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int row = q0 + ty * ROWS + i;
    lse_r[i] = row < Lq ? lse[(long long)bh * Lq + row] : 0.f;
    delta_r[i] = row < Lq ? delta[(long long)bh * Lq + row] : 0.f;
#pragma unroll
    for (int c = 0; c < OCOLS; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < Lk; k0 += TILE) {
    __syncthreads();  // the previous tile's reads of Ks, Vs and dSs are done
    stage(Ks, kp, kl.sl, k0, Lk, dh, ld);
    stage(Vs, vp, kl.sl, k0, Lk, dh, ld);
    if (tid < TILE) Ms[tid] = k0 + tid < Lk ? mp[k0 + tid] : 0.f;
    __syncthreads();

    float s[ROWS][SCOLS], dp[ROWS][SCOLS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < SCOLS; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < dh; ++d) {
      float qv[ROWS], ov[ROWS], kv[SCOLS], vv[SCOLS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        qv[i] = Qs[(ty * ROWS + i) * ld + d];
        ov[i] = dOs[(ty * ROWS + i) * ld + d];
      }
#pragma unroll
      for (int j = 0; j < SCOLS; ++j) {
        kv[j] = Ks[(tx + 16 * j) * ld + d];
        vv[j] = Vs[(tx + 16 * j) * ld + d];
      }
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int j = 0; j < SCOLS; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int row = q0 + ty * ROWS + i;
#pragma unroll
      for (int j = 0; j < SCOLS; ++j) {
        const int key = k0 + tx + 16 * j;
        float ds = 0.f;
        if (row < Lq && key < Lk) {
          const float sv = s[i][j] * sm_scale + (1.f - Ms[tx + 16 * j]) * NEG_INF;
          const float p = expf(sv - lse_r[i]);
          float dpv = dp[i][j];
          if (drop.seed) dpv *= flash::dropout_multiplier(drop, seed_bh, row, key);
          ds = p * (dpv - delta_r[i]);
        }
        dSs[(ty * ROWS + i) * LDP + tx + 16 * j] = ds;
      }
    }
    __syncthreads();

    const int n_keys = min(TILE, Lk - k0);
    for (int n = 0; n < n_keys; ++n) {
      float dsv[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) dsv[i] = dSs[(ty * ROWS + i) * LDP + n];
#pragma unroll
      for (int c = 0; c < OCOLS; ++c) {
        const int col = tx + 16 * c;
        if (col < dh) {
          const float kv = Ks[n * ld + col];
#pragma unroll
          for (int i = 0; i < ROWS; ++i) acc[i][c] = fmaf(dsv[i], kv, acc[i][c]);
        }
      }
    }
  }

  float* dqp = dq + b * ql.sb + h * ql.sh;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int row = q0 + ty * ROWS + i;
    if (row >= Lq) continue;
#pragma unroll
    for (int c = 0; c < OCOLS; ++c) {
      const int col = tx + 16 * c;
      if (col < dh) dqp[row * ql.sl + col] = acc[i][c] * sm_scale;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ mask,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int H, int Lq, int Lk, int dh,
                     Layout ql, Layout kl, float sm_scale, Dropout drop) {
  extern __shared__ float smem[];
  const int ld = dh + 1;
  float* Ks = smem;               // TILE x ld
  float* Vs = Ks + TILE * ld;     // TILE x ld
  float* Qs = Vs + TILE * ld;     // TILE x ld
  float* dOs = Qs + TILE * ld;    // TILE x ld
  float* Ps = dOs + TILE * ld;    // TILE x LDP, key-major: (p * keep)^T
  float* dSs = Ps + TILE * LDP;   // TILE x LDP, key-major: ds^T
  float* Ls = dSs + TILE * LDP;   // TILE lse values of the query tile
  float* Ds = Ls + TILE;          // TILE delta values of the query tile

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // query slot: query rows tx + 16 j
  const int ty = tid >> 4;  // key group: keys ty*ROWS .. ty*ROWS+3
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.x * TILE;

  const float* qp = q + b * ql.sb + h * ql.sh;
  const float* op = dout + b * ql.sb + h * ql.sh;
  const float* mp = mask + (long long)b * Lk;
  const unsigned int seed_bh =
      drop.seed ? flash::dropout_seed_bh(drop, bh) : 0u;

  stage(Ks, k + b * kl.sb + h * kl.sh, kl.sl, k0, Lk, dh, ld);
  stage(Vs, v + b * kl.sb + h * kl.sh, kl.sl, k0, Lk, dh, ld);
  float bias[ROWS], dk_acc[ROWS][OCOLS], dv_acc[ROWS][OCOLS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int key = k0 + ty * ROWS + i;
    bias[i] = key < Lk ? (1.f - mp[key]) * NEG_INF : 0.f;
#pragma unroll
    for (int c = 0; c < OCOLS; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;
  }

  for (int q0 = 0; q0 < Lq; q0 += TILE) {
    __syncthreads();  // the previous tile's reads of Qs, dOs, Ps, dSs are done
    stage(Qs, qp, ql.sl, q0, Lq, dh, ld);
    stage(dOs, op, ql.sl, q0, Lq, dh, ld);
    if (tid < TILE) {
      const int row = q0 + tid;
      Ls[tid] = row < Lq ? lse[(long long)bh * Lq + row] : 0.f;
      Ds[tid] = row < Lq ? delta[(long long)bh * Lq + row] : 0.f;
    }
    __syncthreads();

    float s[ROWS][SCOLS], dp[ROWS][SCOLS];  // [key][query]
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < SCOLS; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < dh; ++d) {
      float kv[ROWS], vv[ROWS], qv[SCOLS], ov[SCOLS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        kv[i] = Ks[(ty * ROWS + i) * ld + d];
        vv[i] = Vs[(ty * ROWS + i) * ld + d];
      }
#pragma unroll
      for (int j = 0; j < SCOLS; ++j) {
        qv[j] = Qs[(tx + 16 * j) * ld + d];
        ov[j] = dOs[(tx + 16 * j) * ld + d];
      }
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int j = 0; j < SCOLS; ++j) {
          s[i][j] = fmaf(qv[j], kv[i], s[i][j]);
          dp[i][j] = fmaf(ov[j], vv[i], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int key = k0 + ty * ROWS + i;
#pragma unroll
      for (int j = 0; j < SCOLS; ++j) {
        const int slot = tx + 16 * j;
        const int row = q0 + slot;
        float p_drop = 0.f, ds = 0.f;
        if (row < Lq && key < Lk) {
          const float p = expf(s[i][j] * sm_scale + bias[i] - Ls[slot]);
          float dpv = dp[i][j];
          p_drop = p;
          if (drop.seed) {
            const float keep = flash::dropout_multiplier(drop, seed_bh, row, key);
            p_drop = p * keep;
            dpv *= keep;
          }
          ds = p * (dpv - Ds[slot]);
        }
        Ps[(ty * ROWS + i) * LDP + slot] = p_drop;
        dSs[(ty * ROWS + i) * LDP + slot] = ds;
      }
    }
    __syncthreads();

    const int n_rows = min(TILE, Lq - q0);
    for (int n = 0; n < n_rows; ++n) {
      float pv[ROWS], dsv[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        pv[i] = Ps[(ty * ROWS + i) * LDP + n];
        dsv[i] = dSs[(ty * ROWS + i) * LDP + n];
      }
#pragma unroll
      for (int c = 0; c < OCOLS; ++c) {
        const int col = tx + 16 * c;
        if (col < dh) {
          const float ov = dOs[n * ld + col];
          const float qv = Qs[n * ld + col];
#pragma unroll
          for (int i = 0; i < ROWS; ++i) {
            dv_acc[i][c] = fmaf(pv[i], ov, dv_acc[i][c]);
            dk_acc[i][c] = fmaf(dsv[i], qv, dk_acc[i][c]);
          }
        }
      }
    }
  }

  float* dkp = dk + b * kl.sb + h * kl.sh;
  float* dvp = dv + b * kl.sb + h * kl.sh;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int key = k0 + ty * ROWS + i;
    if (key >= Lk) continue;
#pragma unroll
    for (int c = 0; c < OCOLS; ++c) {
      const int col = tx + 16 * c;
      if (col < dh) {
        dkp[key * kl.sl + col] = dk_acc[i][c] * sm_scale;
        dvp[key * kl.sl + col] = dv_acc[i][c];
      }
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
      drop.seed ? flash::dropout_seed_bh(drop, bh) : 0u;

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
      drop.seed ? flash::dropout_seed_bh(drop, bh) : 0u;

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

cudaError_t launch_dq_f32(const Args& a, void* dq) {
  const int ld = a.dh + 1;
  const size_t smem =
      sizeof(float) * ((size_t)4 * TILE * ld + (size_t)TILE * LDP + TILE);
  cudaError_t err = allow_smem(flash_bwd_dq_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Lq + TILE - 1) / TILE, a.BH);
  flash_bwd_dq_kernel<<<grid, THREADS, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.mask, a.lse, a.delta, static_cast<float*>(dq), a.H, a.Lq, a.Lk, a.dh,
      a.ql, a.kl, a.sm_scale, a.drop);
  return cudaGetLastError();
}

cudaError_t launch_dkv_f32(const Args& a, void* dk, void* dv) {
  const int ld = a.dh + 1;
  const size_t smem = sizeof(float) * ((size_t)4 * TILE * ld +
                                       (size_t)2 * TILE * LDP + 2 * TILE);
  cudaError_t err = allow_smem(flash_bwd_dkv_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Lk + TILE - 1) / TILE, a.BH);
  flash_bwd_dkv_kernel<<<grid, THREADS, smem, a.stream>>>(
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
// kernels), 1 = bfloat16 (wgmma kernels; q, k, v, dout and the outputs
// 16-byte aligned, the dropout grid in multiples of 64). seed: null for no
// dropout, else one int32 on the device; thresh, drop_scale and the dropout
// grid (drop_bq, drop_bk) as flash_common.cuh says, the same values the
// forward was given.
// Each returns a cudaError_t; 0 on success. Launches on `stream`, allocates
// nothing and does not synchronise.
int univtg_flash_bwd_dq(const void* q, const void* k, const void* v,
                        const void* dout, const void* mask, const void* lse,
                        const void* delta, void* dq, int dtype, int BH, int H,
                        int Lq, int Lk, int dh, long long q_sb, long long q_sh,
                        long long q_sl, long long k_sb, long long k_sh,
                        long long k_sl, float sm_scale, const void* seed,
                        unsigned int thresh, float drop_scale, int drop_bq,
                        int drop_bk, void* stream) {
  if (bad_shape(BH, H, Lq, Lk, dh, seed, drop_bq, drop_bk))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, dout, static_cast<const float*>(mask),
               static_cast<const float*>(lse), static_cast<const float*>(delta),
               BH, H, Lq, Lk, dh, Layout{q_sb, q_sh, q_sl},
               Layout{k_sb, k_sh, k_sl}, sm_scale,
               Dropout{static_cast<const int*>(seed), thresh, drop_scale,
                       drop_bq, drop_bk},
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return (int)launch_dq_f32(a, dq);
  if (dtype == 1) {
    const void* ptrs[] = {q, k, v, dout, dq};
    if (misaligned(ptrs, 5, a.ql, a.kl)) return (int)cudaErrorMisalignedAddress;
    if (bad_bf16_grid(a.drop)) return (int)cudaErrorInvalidValue;
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
                         void* stream) {
  if (bad_shape(BH, H, Lq, Lk, dh, seed, drop_bq, drop_bk))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, dout, static_cast<const float*>(mask),
               static_cast<const float*>(lse), static_cast<const float*>(delta),
               BH, H, Lq, Lk, dh, Layout{q_sb, q_sh, q_sl},
               Layout{k_sb, k_sh, k_sl}, sm_scale,
               Dropout{static_cast<const int*>(seed), thresh, drop_scale,
                       drop_bq, drop_bk},
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return (int)launch_dkv_f32(a, dk, dv);
  if (dtype == 1) {
    const void* ptrs[] = {q, k, v, dout, dk, dv};
    if (misaligned(ptrs, 6, a.ql, a.kl)) return (int)cudaErrorMisalignedAddress;
    if (bad_bf16_grid(a.drop)) return (int)cudaErrorInvalidValue;
    return (int)(dh <= 64 ? launch_dkv_bf16<64>(a, dk, dv)
                          : launch_dkv_bf16<128>(a, dk, dv));
  }
  return (int)cudaErrorInvalidValue;
}

const char* univtg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
