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
// H100's ~295 FLOP/byte ridge at the serving shapes (L = 160 ... 2080): at
// B=8 L=2080 H=8 dh=128, 1.42e11 FLOP, 0.143 ms at the bf16 peak.
//
// The dtype picks the design; this is a dispatch, not a fallback:
//
// bf16 -- tensor cores (flash_fwd_kernel_sm90<DH>, DH = 64 or 128, the head
// dim zero-filled up to DH; the building blocks are flash_sm90.cuh's, the
// loop is the dQ kernel's of flash_bwd.cu with an online softmax in place
// of the recompute from lse). One block is one warpgroup of 128 threads and
// 64 resident query rows, two blocks per SM. Q stays in shared memory; K,
// V and the key bias stream in tiles of 64 keys, in two cp.async stages
// (tile t + 1 lands under tile t's arithmetic). Per tile:
//   S = Q.K^T                     wgmma, both operands K-major in smem
//   online softmax in registers   a row's 64 columns sit on the 4 threads of
//                                 a quad: max and sum over shuffles 1 and 2
//   p * keep, cast to bf16 (RNE)  the dropout hash input taken once per row
//                                 and tile (flash::dropout_hash_input)
//   acc = acc * alpha + P.V       wgmma, P from registers (the accumulator's
//                                 layout is the register-A layout), V as the
//                                 MN-major B operand
// Each product is waited for before the next step; only the other block on
// the SM fills the gaps. The exp, in f32 as the reference takes it, and the
// dropout finalizer run per element.
//
// f32 -- CUDA cores (flash_fwd_kernel): TF32 tensor cores have not been
// measured against the f32 limit (1e-4), and f32 is the correctness path.
// One block of 256 threads per (batch*head, 64-row query tile); a loop over
// 64-key tiles of K and V staged in shared memory; each thread owns 4 query
// rows and computes a 4x4 patch of the score tile and a 4 x (dh/16) patch of
// the output with scalar FMAs; the row max and sum reduce across the 16
// threads of a row group by warp shuffles. Bound by the f32 FMA rate
// (67 TFLOP/s): 2.12 ms at the long shape.
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
using flash::group_max;
using flash::group_sum;
using flash::Layout;
using flash::NEG_INF;

// ---------------------------------------------------------------------------
// f32: CUDA cores

constexpr int BLOCK_M = 64;   // query rows per block
constexpr int BLOCK_N = 64;   // keys per streamed tile
constexpr int THREADS = 256;  // 16 row groups x 16 threads
constexpr int ROWS = 4;       // query rows per thread (16 groups x 4 = 64)
constexpr int SCOLS = BLOCK_N / 16;  // score columns per thread
constexpr int MAX_DH = 128;
constexpr int OCOLS = MAX_DH / 16;   // output columns per thread, at most
constexpr int LDP = BLOCK_N + 1;     // P tile row stride

__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ mask,
                 float* __restrict__ out, float* __restrict__ lse, int H,
                 int Lq, int Lk, int dh, Layout ql, Layout kl, float sm_scale,
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

  const float* qp = q + b * ql.sb + h * ql.sh;
  const float* kp = k + b * kl.sb + h * kl.sh;
  const float* vp = v + b * kl.sb + h * kl.sh;
  float* op = out + b * ql.sb + h * ql.sh;
  const float* mp = mask + (long long)b * Lk;
  const unsigned int seed_bh = drop.seed ? flash::dropout_seed_bh(drop, bh) : 0u;

  for (int e = tid; e < BLOCK_M * dh; e += THREADS) {
    const int r = e / dh, c = e - r * dh;
    const int row = q0 + r;
    Qs[r * ld + c] = row < Lq ? qp[row * ql.sl + c] : 0.f;
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
      Ks[r * ld + c] = in ? kp[key * kl.sl + c] : 0.f;
      Vs[r * ld + c] = in ? vp[key * kl.sl + c] : 0.f;
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
        rs += p;  // the denominator takes p before dropout
        float p_acc = p;
        if (drop.seed && valid[j])
          p_acc = p * flash::dropout_multiplier(drop, seed_bh,
                                                q0 + ty * ROWS + i,
                                                k0 + tx + 16 * j);
        Ps[(ty * ROWS + i) * LDP + tx + 16 * j] = p_acc;
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
      if (col < dh) op[row * ql.sl + col] = acc[i][c] / l_safe;
    }
    if (tx == 0) lse[(long long)bh * Lq + row] = m[i] + logf(l_safe);
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma)

namespace sm90 {

template <int DH>
constexpr size_t fwd_smem() {  // Q; K, V x 2 stages; key bias x 2
  return 5 * tile_bytes<DH>() + 2 * TILE_ROWS * 4 + 1024;
}

// One loop per streamed key tile t, on stage t % 2: start the copies of
// tile t + 1 into the other stage (a group that may be empty, so that one
// group is committed per tile); wait for tile t's; barrier; S, waited for;
// the online softmax, dropout and the cast in registers; P.V, waited for;
// barrier: every warp is done with stage t % 2.
template <int DH>
__global__ void __launch_bounds__(WG_THREADS, 2)
flash_fwd_kernel_sm90(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const float* __restrict__ mask, bf16* __restrict__ out,
                      float* __restrict__ lse, int H, int Lq, int Lk, int dh,
                      Layout ql, Layout kl, float sm_scale, Dropout drop) {
  constexpr int NT = DH / 64;  // 64-column slices of the output
  constexpr uint32_t TB = tile_bytes<DH>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t Qs = (raw + 1023) & ~1023u;
  const uint32_t Ks = Qs + TB, Vs = Ks + 2 * TB;
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
  load_tile<DH>(Ks, kp, kl.sl, 0, Lk, dh);
  load_tile<DH>(Vs, vp, kl.sl, 0, Lk, dh);
  if (tid < TILE_ROWS) Bs[tid] = key_bias(mp, tid, Lk);
  cp_commit();

  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};
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
    float s[1][32];
    zero(s);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks)
      mma_ss(s[0], desc_k(Qs, ks), desc_k(Kt, ks));
    wg_commit();
    wg_wait(s);

    float alpha[2];
    float(&p)[32] = s[0];
    online_softmax(p, Bs + st * TILE_ROWS, k0, Lk, sm_scale, m_r, l_r, alpha);
    if (drop.seed) {  // the hash input at (row, k0), then per column
      unsigned int hx[2];
#pragma unroll
      for (int j = 0; j < 2; ++j)
        hx[j] = flash::dropout_hash_input(drop, seed_bh, q0 + frag_row(2 * j),
                                          k0);
#pragma unroll
      for (int i = 0; i < 32; ++i)
        p[i] *= flash::dropout_keep(drop, hx[(i >> 1) & 1] + frag_col(i));
    }
    uint32_t pf[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) pf[i] = pack_bf16(p[2 * i], p[2 * i + 1]);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[n][i] *= alpha[(i >> 1) & 1];

    wg_fence();
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int ks = 0; ks < TILE_ROWS / 16; ++ks)
        mma_rs(acc[n], pf[4 * ks], pf[4 * ks + 1], pf[4 * ks + 2],
               pf[4 * ks + 3], desc_mn(Vt, ks, n));
    wg_commit();
    wg_wait(acc);
    __syncthreads();  // every warp is done with this stage
  }

  float l_safe[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) l_safe[j] = fmaxf(l_r[j], 1e-30f);
  bf16* op = out + b * ql.sb + h * ql.sh;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int row = q0 + frag_row(i);
      const int col = 64 * n + frag_col(i);
      const float ls = l_safe[(i >> 1) & 1];
      if (row < Lq && col < dh)
        *reinterpret_cast<__nv_bfloat162*>(op + row * ql.sl + col) =
            __floats2bfloat162_rn(acc[n][i] / ls, acc[n][i + 1] / ls);
    }
  if ((tid & 3) == 0)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int row = q0 + frag_row(2 * j);
      if (row < Lq) lse[(long long)bh * Lq + row] = m_r[j] + logf(l_safe[j]);
    }
}

}  // namespace sm90

namespace {

struct Args {
  const void *q, *k, *v;
  const float* mask;
  void* out;
  float* lse;
  int BH, H, Lq, Lk, dh;
  Layout ql, kl;
  float sm_scale;
  Dropout drop;
  cudaStream_t stream;
};

cudaError_t launch_f32(const Args& a) {
  const int ld = a.dh + 1;
  const size_t smem =
      sizeof(float) * ((size_t)(BLOCK_M + 2 * BLOCK_N) * ld +
                       (size_t)BLOCK_M * LDP + BLOCK_N);
  const cudaError_t err = sm90::allow_smem(flash_fwd_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Lq + BLOCK_M - 1) / BLOCK_M, a.BH);
  flash_fwd_kernel<<<grid, THREADS, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), a.mask, static_cast<float*>(a.out),
      a.lse, a.H, a.Lq, a.Lk, a.dh, a.ql, a.kl, a.sm_scale, a.drop);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_bf16(const Args& a) {
  using sm90::bf16;
  constexpr size_t smem = sm90::fwd_smem<DH>();
  const cudaError_t err =
      sm90::allow_smem(sm90::flash_fwd_kernel_sm90<DH>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Lq + sm90::TILE_ROWS - 1) / sm90::TILE_ROWS, a.BH);
  sm90::flash_fwd_kernel_sm90<DH><<<grid, sm90::WG_THREADS, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), a.mask, static_cast<bf16*>(a.out), a.lse,
      a.H, a.Lq, a.Lk, a.dh, a.ql, a.kl, a.sm_scale, a.drop);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q and out share one layout, k and v another; mask is (BH / H, Lk) f32 and
// lse is (BH, Lq) f32, both dense. dtype: 0 = float32 (CUDA-core kernel),
// 1 = bfloat16 (wgmma kernel; q, k, v and out 16-byte aligned, every stride
// a multiple of 8 elements, the dropout grid in multiples of 64).
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
  const Args a{q, k, v, static_cast<const float*>(mask), out,
               static_cast<float*>(lse), BH, H, Lq, Lk, dh,
               Layout{q_sb, q_sh, q_sl}, Layout{k_sb, k_sh, k_sl}, sm_scale,
               Dropout{static_cast<const int*>(seed), thresh, drop_scale,
                       drop_bq, drop_bk},
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return (int)launch_f32(a);
  if (dtype == 1) {
    const void* ptrs[] = {q, k, v, out};
    if (sm90::misaligned(ptrs, 4, a.ql, a.kl))
      return (int)cudaErrorMisalignedAddress;
    if (sm90::bad_bf16_grid(a.drop)) return (int)cudaErrorInvalidValue;
    return (int)(dh <= 64 ? launch_bf16<64>(a) : launch_bf16<128>(a));
  }
  return (int)cudaErrorInvalidValue;
}

const char* univtg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
