// Flash-attention forward for Hopper (sm_90a), f32 and bf16 inputs.
//
// Replaces univtg_tpu/ops/pallas_attention.py:_fwd_kernel (launched from
// _fwd_impl, wrapped by flash_attention): online-softmax attention with an
// additive key-padding mask and in-kernel attention dropout, returning the
// output and the per-row logsumexp (which the backward kernels recompute P
// from, flash_bwd.cu).
//
//   s   = (q . k^T) * sm_scale + (1 - mask) * (-1e30)    scale AFTER the dot
//   m   = running row max, l = running row sum of exp(s - m), both f32
//   acc = acc * exp(m_prev - m_new) + cast(p * keep, T) . v
//                                        p rounded to the input dtype first
//   out = acc / max(l, 1e-30) in T,  lse = m + log(max(l, 1e-30)) in f32
//
// Dropout follows torch MHA: it drops AFTER normalisation, so the
// denominator l sums the undropped p, and keep is 0 or 1/(1-rate) from the
// reference's hash (flash_common.cuh), identical in the backward kernels.
//
// Keys past Lk (the ragged edge of the last tile) are excluded, not masked:
// they add nothing to m, l or acc. So a row whose real keys are all masked
// gets the mean of V over its Lk real keys, as a plain masked softmax gives.
//
// Bound on the card: compute. The work is 4 * BH * Lq * Lk * dh FLOP (two
// products) against (BH * (Lq + 2 * Lk) * dh) elements moved, far above the
// H100's ~295 FLOP/byte ridge at the serving shapes (L = 160 ... 2080).
//
// Design (simple and right first): one block of 256 threads per
// (batch*head, 64-row query tile); a loop over 64-key tiles of K and V staged
// in shared memory as f32; each thread owns 4 query rows and computes a 4x4
// patch of the score tile and a 4 x (dh/16) patch of the output with scalar
// FMAs; the row max and sum reduce across the 16 threads of a row group by
// warp shuffles. What it leaves on the table: no tensor cores (wgmma or
// mma.sync), no TMA or cp.async double buffering of the next K/V tile, f32
// staging of bf16 inputs (twice the shared memory, one block per SM), and
// scalar shared-memory loads that bound the inner loops. Those belong to the
// PR that makes it fast.
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
using flash::group_max;
using flash::group_sum;
using flash::Layout;
using flash::NEG_INF;
using flash::to_f32;

constexpr int BLOCK_M = 64;   // query rows per block
constexpr int BLOCK_N = 64;   // keys per streamed tile
constexpr int THREADS = 256;  // 16 row groups x 16 threads
constexpr int ROWS = 4;       // query rows per thread (16 groups x 4 = 64)
constexpr int SCOLS = BLOCK_N / 16;  // score columns per thread
constexpr int MAX_DH = 128;
constexpr int OCOLS = MAX_DH / 16;   // output columns per thread, at most
constexpr int LDP = BLOCK_N + 1;     // P tile row stride

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ mask,
                 T* __restrict__ out, float* __restrict__ lse, int H, int Lq,
                 int Lk, int dh, Layout ql, Layout kl, float sm_scale,
                 Dropout drop) {
  extern __shared__ float smem[];
  const int ld = dh + 1;  // odd stride: column reads across rows hit distinct banks
  float* Qs = smem;                        // BLOCK_M x ld
  float* Ks = Qs + BLOCK_M * ld;           // BLOCK_N x ld
  float* Vs = Ks + BLOCK_N * ld;           // BLOCK_N x ld
  float* Ps = Vs + BLOCK_N * ld;           // BLOCK_M x LDP
  float* Ms = Ps + BLOCK_M * LDP;          // BLOCK_N key-mask values

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // column slot within the row group
  const int ty = tid >> 4;  // row group: rows ty*ROWS .. ty*ROWS+3
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * BLOCK_M;

  const T* qp = q + b * ql.sb + h * ql.sh;
  const T* kp = k + b * kl.sb + h * kl.sh;
  const T* vp = v + b * kl.sb + h * kl.sh;
  T* op = out + b * ql.sb + h * ql.sh;
  const float* mp = mask + (long long)b * Lk;
  const unsigned int seed_bh = drop.seed ? flash::dropout_seed_bh(drop, bh) : 0u;

  for (int e = tid; e < BLOCK_M * dh; e += THREADS) {
    const int r = e / dh, c = e - r * dh;
    const int row = q0 + r;
    Qs[r * ld + c] = row < Lq ? to_f32(qp[row * ql.sl + c]) : 0.f;
  }

  float m[ROWS], l[ROWS], acc[ROWS][OCOLS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < OCOLS; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < Lk; k0 += BLOCK_N) {
    __syncthreads();  // the previous tile's reads of Ks, Vs and Ps are done
    for (int e = tid; e < BLOCK_N * dh; e += THREADS) {
      const int r = e / dh, c = e - r * dh;
      const int key = k0 + r;
      const bool in = key < Lk;
      Ks[r * ld + c] = in ? to_f32(kp[key * kl.sl + c]) : 0.f;
      Vs[r * ld + c] = in ? to_f32(vp[key * kl.sl + c]) : 0.f;
    }
    if (tid < BLOCK_N) Ms[tid] = k0 + tid < Lk ? mp[k0 + tid] : 0.f;
    __syncthreads();

    float s[ROWS][SCOLS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < SCOLS; ++j) s[i][j] = 0.f;
    for (int d = 0; d < dh; ++d) {
      float qv[ROWS], kv[SCOLS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) qv[i] = Qs[(ty * ROWS + i) * ld + d];
#pragma unroll
      for (int j = 0; j < SCOLS; ++j) kv[j] = Ks[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int j = 0; j < SCOLS; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    bool valid[SCOLS];
    float bias[SCOLS];
#pragma unroll
    for (int j = 0; j < SCOLS; ++j) {
      valid[j] = k0 + tx + 16 * j < Lk;
      bias[j] = (1.f - Ms[tx + 16 * j]) * NEG_INF;
    }

#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < SCOLS; ++j) {
        s[i][j] = valid[j] ? s[i][j] * sm_scale + bias[j] : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      // every tile holds at least one real key, so m_new is finite
      const float m_new = fmaxf(m[i], group_max(mx));
      const float alpha = expf(m[i] - m_new);  // 0 on the first tile
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < SCOLS; ++j) {
        const float p = valid[j] ? expf(s[i][j] - m_new) : 0.f;
        rs += p;  // the denominator takes p before dropout and the cast
        float p_acc = p;
        if (drop.seed && valid[j])
          p_acc = p * flash::dropout_multiplier(drop, seed_bh,
                                                q0 + ty * ROWS + i,
                                                k0 + tx + 16 * j);
        Ps[(ty * ROWS + i) * LDP + tx + 16 * j] = to_f32(from_f32<T>(p_acc));
      }
      l[i] = l[i] * alpha + group_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < OCOLS; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    const int n_keys = min(BLOCK_N, Lk - k0);
    for (int n = 0; n < n_keys; ++n) {
      float pv[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) pv[i] = Ps[(ty * ROWS + i) * LDP + n];
#pragma unroll
      for (int c = 0; c < OCOLS; ++c) {
        const int col = tx + 16 * c;
        if (col < dh) {
          const float vv = Vs[n * ld + col];
#pragma unroll
          for (int i = 0; i < ROWS; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int row = q0 + ty * ROWS + i;
    if (row >= Lq) continue;
    const float l_safe = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < OCOLS; ++c) {
      const int col = tx + 16 * c;
      if (col < dh) op[row * ql.sl + col] = from_f32<T>(acc[i][c] / l_safe);
    }
    if (tx == 0) lse[(long long)bh * Lq + row] = m[i] + logf(l_safe);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* mask, void* out, float* lse, int BH, int H,
                   int Lq, int Lk, int dh, Layout ql, Layout kl,
                   float sm_scale, Dropout drop, cudaStream_t stream) {
  const int ld = dh + 1;
  const size_t smem =
      sizeof(float) * ((size_t)(BLOCK_M + 2 * BLOCK_N) * ld +
                       (size_t)BLOCK_M * LDP + BLOCK_N);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((Lq + BLOCK_M - 1) / BLOCK_M, BH);
  flash_fwd_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<T*>(out), lse, H, Lq, Lk,
      dh, ql, kl, sm_scale, drop);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q and out share one layout, k and v another; mask is (BH / H, Lk) f32 and
// lse is (BH, Lq) f32, both dense. dtype: 0 = float32, 1 = bfloat16.
// seed: null for no dropout, else one int32 on the device (read by the
// kernel, so the wrapper never waits for it); thresh, drop_scale and the
// dropout grid (drop_bq, drop_bk) as flash_common.cuh says.
// Returns a cudaError_t; 0 on success. Launches on `stream`, allocates
// nothing and does not synchronise.
int univtg_flash_fwd(const void* q, const void* k, const void* v,
                     const void* mask, void* out, void* lse, int dtype, int BH,
                     int H, int Lq, int Lk, int dh, long long q_sb,
                     long long q_sh, long long q_sl, long long k_sb,
                     long long k_sh, long long k_sl, float sm_scale,
                     const void* seed, unsigned int thresh, float drop_scale,
                     int drop_bq, int drop_bk, void* stream) {
  if (dh <= 0 || dh > MAX_DH || dh % 8 != 0 || Lq <= 0 || Lk <= 0 ||
      BH <= 0 || H <= 0 || BH % H != 0 || BH > 65535 ||
      (seed && (drop_bq <= 0 || drop_bk <= 0)))
    return (int)cudaErrorInvalidValue;
  const Layout ql{q_sb, q_sh, q_sl};
  const Layout kl{k_sb, k_sh, k_sl};
  const Dropout drop{static_cast<const int*>(seed), thresh, drop_scale,
                     drop_bq, drop_bk};
  const float* m = static_cast<const float*>(mask);
  float* ls = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch<float>(q, k, v, m, out, ls, BH, H, Lq, Lk, dh, ql, kl,
                        sm_scale, drop, s);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(q, k, v, m, out, ls, BH, H, Lq, Lk, dh, ql,
                                kl, sm_scale, drop, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

const char* univtg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
