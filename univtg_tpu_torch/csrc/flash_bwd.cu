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
// there, so they add nothing to any sum (the dK/dV kernel never reads dO or
// lse past Lq). The dropout mask is the reference's hash (flash_common.cuh).
//
// Design (simple and right first), one kernel per output so that nothing is
// carried across blocks and no atomics are needed:
//   dQ:   one block of 256 threads per (batch*head, 64-query tile), looping
//         over 64-key tiles of K and V; each thread owns 4 query rows, a 4x4
//         patch of s/dp and a 4 x (dh/16) patch of dQ.
//   dK/dV: one block per (batch*head, 64-key tile), looping over 64-query
//         tiles of Q, dO, lse and delta; each thread owns 4 keys, a 4x4 patch
//         of s/dp and 4 x (dh/16) patches of dK and dV.
// Operands are staged in shared memory as f32 with an odd row stride (dQ:
// Q, dO, K, V and the ds tile, ~149 KB at dh 128; dK/dV: K, V, Q, dO and the
// p and ds tiles, ~166 KB), past the 48 KB default, hence the opt-in.
// Q, K, V, dO and the outputs are read and written in the projections'
// (B, L, D) layout through (batch, head, row) strides: no head-split copies.
//
// Bound on the card: compute at both training shapes. dQ does 3 products
// (s, dp, ds.k): 6 * BH * Lq * Lk * dh FLOP; dK/dV does 4 (s, dp, p^T.dO,
// ds^T.q): 8 * BH * Lq * Lk * dh FLOP. At B=8 L=2080 H=8 dh=128 that is
// 2.13e11 and 2.84e11 FLOP, 0.215 and 0.287 ms at the bf16 tensor-core peak
// (989 TFLOP/s), 3.17 and 4.23 ms at the f32 CUDA-core peak (67 TFLOP/s).
// At B=32 L=107 the same formulas give 0.0074 / 0.0099 ms in bf16, below the
// time to move q, k, v, dO and the outputs (7.0 MB each in bf16): there the
// byte bound and, in practice, the launch itself set the floor.
// What the simple design leaves on the table: no tensor cores (wgmma or
// mma.sync), so bf16 runs at the f32 FMA rate; no TMA or cp.async double
// buffering; f32 staging of bf16 operands (one block per SM); every block of
// the dK/dV kernel re-reads all of Q and dO; the dropout hash is recomputed
// per element in both kernels. Those belong to the PR that makes it fast.
//
// Built by univtg_tpu_torch/ops/cuda_build.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and called through ctypes by univtg_tpu_torch/ops/flash_attention.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "flash_common.cuh"

namespace {

using flash::Dropout;
using flash::from_f32;
using flash::Layout;
using flash::NEG_INF;
using flash::to_f32;

constexpr int TILE = 64;      // query rows and keys per tile
constexpr int THREADS = 256;  // 16 row groups x 16 threads
constexpr int ROWS = 4;       // rows per thread (16 groups x 4 = 64)
constexpr int SCOLS = TILE / 16;     // score columns per thread
constexpr int MAX_DH = 128;
constexpr int OCOLS = MAX_DH / 16;   // output columns per thread, at most
constexpr int LDP = TILE + 1;        // p / ds tile row stride

// Stage rows [r0, r0 + TILE) of one head of x as f32; rows past L are zero.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      long long sl, int r0, int L, int dh,
                                      int ld) {
  for (int e = threadIdx.x; e < TILE * dh; e += THREADS) {
    const int r = e / dh, c = e - r * dh;
    const int row = r0 + r;
    dst[r * ld + c] = row < L ? to_f32(src[row * sl + c]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ mask,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int H,
                    int Lq, int Lk, int dh, Layout ql, Layout kl,
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

  const T* kp = k + b * kl.sb + h * kl.sh;
  const T* vp = v + b * kl.sb + h * kl.sh;
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
        dSs[(ty * ROWS + i) * LDP + tx + 16 * j] = to_f32(from_f32<T>(ds));
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

  T* dqp = dq + b * ql.sb + h * ql.sh;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int row = q0 + ty * ROWS + i;
    if (row >= Lq) continue;
#pragma unroll
    for (int c = 0; c < OCOLS; ++c) {
      const int col = tx + 16 * c;
      if (col < dh) dqp[row * ql.sl + col] = from_f32<T>(acc[i][c] * sm_scale);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ mask,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int Lq, int Lk, int dh,
                     Layout ql, Layout kl, float sm_scale, Dropout drop) {
  extern __shared__ float smem[];
  const int ld = dh + 1;
  float* Ks = smem;               // TILE x ld
  float* Vs = Ks + TILE * ld;     // TILE x ld
  float* Qs = Vs + TILE * ld;     // TILE x ld
  float* dOs = Qs + TILE * ld;    // TILE x ld
  float* Ps = dOs + TILE * ld;    // TILE x LDP, key-major: cast(p * keep)^T
  float* dSs = Ps + TILE * LDP;   // TILE x LDP, key-major: cast(ds)^T
  float* Ls = dSs + TILE * LDP;   // TILE lse values of the query tile
  float* Ds = Ls + TILE;          // TILE delta values of the query tile

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // query slot: query rows tx + 16 j
  const int ty = tid >> 4;  // key group: keys ty*ROWS .. ty*ROWS+3
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.x * TILE;

  const T* qp = q + b * ql.sb + h * ql.sh;
  const T* op = dout + b * ql.sb + h * ql.sh;
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
        Ps[(ty * ROWS + i) * LDP + slot] = to_f32(from_f32<T>(p_drop));
        dSs[(ty * ROWS + i) * LDP + slot] = to_f32(from_f32<T>(ds));
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

  T* dkp = dk + b * kl.sb + h * kl.sh;
  T* dvp = dv + b * kl.sb + h * kl.sh;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int key = k0 + ty * ROWS + i;
    if (key >= Lk) continue;
#pragma unroll
    for (int c = 0; c < OCOLS; ++c) {
      const int col = tx + 16 * c;
      if (col < dh) {
        dkp[key * kl.sl + col] = from_f32<T>(dk_acc[i][c] * sm_scale);
        dvp[key * kl.sl + col] = from_f32<T>(dv_acc[i][c]);
      }
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* mask, const float* lse,
                      const float* delta, void* dq, int BH, int H, int Lq,
                      int Lk, int dh, Layout ql, Layout kl, float sm_scale,
                      Dropout drop, cudaStream_t stream) {
  const int ld = dh + 1;
  const size_t smem =
      sizeof(float) * ((size_t)4 * TILE * ld + (size_t)TILE * LDP + TILE);
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Lq + TILE - 1) / TILE, BH);
  flash_bwd_dq_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), mask, lse, delta,
      static_cast<T*>(dq), H, Lq, Lk, dh, ql, kl, sm_scale, drop);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* mask, const float* lse,
                       const float* delta, void* dk, void* dv, int BH, int H,
                       int Lq, int Lk, int dh, Layout ql, Layout kl,
                       float sm_scale, Dropout drop, cudaStream_t stream) {
  const int ld = dh + 1;
  const size_t smem = sizeof(float) * ((size_t)4 * TILE * ld +
                                       (size_t)2 * TILE * LDP + 2 * TILE);
  cudaError_t err = allow_smem(flash_bwd_dkv_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Lk + TILE - 1) / TILE, BH);
  flash_bwd_dkv_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), mask, lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), H, Lq, Lk, dh, ql, kl,
      sm_scale, drop);
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
// lse and delta are (BH, Lq) f32, all dense. dtype: 0 = float32,
// 1 = bfloat16. seed: null for no dropout, else one int32 on the device;
// thresh, drop_scale and the dropout grid (drop_bq, drop_bk) as
// flash_common.cuh says, the same values the forward was given.
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
  const Layout ql{q_sb, q_sh, q_sl};
  const Layout kl{k_sb, k_sh, k_sl};
  const Dropout drop{static_cast<const int*>(seed), thresh, drop_scale,
                     drop_bq, drop_bk};
  const float* m = static_cast<const float*>(mask);
  const float* ls = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_dq<float>(q, k, v, dout, m, ls, dl, dq, BH, H, Lq, Lk,
                                 dh, ql, kl, sm_scale, drop, s);
  if (dtype == 1)
    return (int)launch_dq<__nv_bfloat16>(q, k, v, dout, m, ls, dl, dq, BH, H,
                                         Lq, Lk, dh, ql, kl, sm_scale, drop,
                                         s);
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
  const Layout ql{q_sb, q_sh, q_sl};
  const Layout kl{k_sb, k_sh, k_sl};
  const Dropout drop{static_cast<const int*>(seed), thresh, drop_scale,
                     drop_bq, drop_bk};
  const float* m = static_cast<const float*>(mask);
  const float* ls = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_dkv<float>(q, k, v, dout, m, ls, dl, dk, dv, BH, H, Lq,
                                  Lk, dh, ql, kl, sm_scale, drop, s);
  if (dtype == 1)
    return (int)launch_dkv<__nv_bfloat16>(q, k, v, dout, m, ls, dl, dk, dv, BH,
                                          H, Lq, Lk, dh, ql, kl, sm_scale,
                                          drop, s);
  return (int)cudaErrorInvalidValue;
}

const char* univtg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
