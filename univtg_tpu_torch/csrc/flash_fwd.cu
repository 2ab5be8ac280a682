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
// f32 -- CUDA cores (flash_fwd_kernel<DH, TAILS>, DH = 64 or 128, the head
// dim zero-filled up to DH): the online-softmax loop of flash_f32.cuh
// (attend, whose note spells it out), shared with ring_attention.cu's f32
// block. One block of 256 threads per (batch*head, 128 query rows), one
// block per SM (225.5 KB of shared memory at DH 128). Q stays in shared
// memory; K, V and the key bias stream in 64-key tiles through two cp.async
// stages. S is 4 rows x 8 keys a thread and acc 8 rows x 8 columns, both
// outer products from float4 reads of row-major tiles with an XOR swizzle
// of their 16-byte chunks; the scale comes after the dot, the dropout hash
// input is taken once per row and tile. A ragged last query tile of at
// most 32 rows computes only those and runs after every full tile;
// TAILS picks that path on the host, only for grids that need it. Plain f32
// FFMA and expf, as the reference: TF32 tensor cores would sum in their own
// rounding, and f32 is the correctness path. Bound by the f32 FMA rate (67
// TFLOP/s): 2.12 ms at the long shape, where it runs at 54-56 % of that.
// What it leaves (ablations on an H100, scripts/bench_flash_fwd_ring.py):
// the two products take about 1.6 ms each, 65-70 % of the FMA rate, which
// the shared-memory reads of their register tiles cap; the rest is the
// softmax between two barriers a tile at one block per SM, with no product
// under it, and the copies (~0.2 ms).
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

// ---------------------------------------------------------------------------
// f32: CUDA cores (flash_f32.cuh's loop)

template <int DH, bool TAILS>
__global__ void __launch_bounds__(f32::THREADS, 1)
flash_fwd_kernel(const __grid_constant__ f32::AttendArgs a) {
  f32::attend_block<DH, false, TAILS>(a);
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
      drop.seed ? flash::dropout_seed_bh(drop, bh, H) : 0u;

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

template <int DH, bool TAILS>
cudaError_t launch_f32_tiles(const Args& a) {
  constexpr size_t smem = f32::attend_smem<DH>();
  const cudaError_t err = sm90::allow_smem(flash_fwd_kernel<DH, TAILS>, smem);
  if (err != cudaSuccess) return err;
  const f32::AttendArgs args{
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), a.mask, static_cast<float*>(a.out),
      a.lse, nullptr, nullptr, nullptr, a.H, a.Lq, a.Lk, a.dh, a.ql, a.kl,
      (long long)a.Lk, a.sm_scale, a.drop, 0};
  const dim3 grid = f32::attend_grid(a.BH, a.Lq);
  flash_fwd_kernel<DH, TAILS><<<grid, f32::THREADS, smem, a.stream>>>(args);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_f32(const Args& a) {
  return f32::attend_tails(a.Lq) ? launch_f32_tiles<DH, true>(a)
                                 : launch_f32_tiles<DH, false>(a);
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
// lse is (BH, Lq) f32, both dense. dtype: 0 = float32 (CUDA-core kernel;
// q, k, v and out 16-byte aligned, every stride a multiple of 4 elements),
// 1 = bfloat16 (wgmma kernel; q, k, v and out 16-byte aligned, every stride
// a multiple of 8 elements); either way the dropout grid in multiples of 64,
// or the call returns cudaErrorMisalignedAddress or cudaErrorInvalidValue.
// seed: null for no dropout, else one int32 on the device (read by the
// kernel, so the wrapper never waits for it); thresh, drop_scale and the
// dropout grid (drop_bq, drop_bk) and the hash's global heads (drop_heads,
// drop_head_off; 0, 0: the launch's own) as flash_common.cuh says.
// Returns a cudaError_t; 0 on success. Launches on `stream`, allocates
// nothing and does not synchronise.
int univtg_flash_fwd(const void* q, const void* k, const void* v,
                     const void* mask, void* out, void* lse, int dtype, int BH,
                     int H, int Lq, int Lk, int dh, long long q_sb,
                     long long q_sh, long long q_sl, long long k_sb,
                     long long k_sh, long long k_sl, float sm_scale,
                     const void* seed, unsigned int thresh, float drop_scale,
                     int drop_bq, int drop_bk, int drop_heads,
                     int drop_head_off, void* stream) {
  if (dh <= 0 || dh > f32::MAX_DH || dh % 8 != 0 || Lq <= 0 || Lk <= 0 ||
      BH <= 0 || H <= 0 || BH % H != 0 || BH > 65535 ||
      (seed && (drop_bq <= 0 || drop_bk <= 0)))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, static_cast<const float*>(mask), out,
               static_cast<float*>(lse), BH, H, Lq, Lk, dh,
               Layout{q_sb, q_sh, q_sl}, Layout{k_sb, k_sh, k_sl}, sm_scale,
               Dropout{static_cast<const int*>(seed), thresh, drop_scale,
                       drop_bq, drop_bk, drop_heads, drop_head_off},
               static_cast<cudaStream_t>(stream)};
  const void* ptrs[] = {q, k, v, out};
  // both kernels take a 64-key tile's dropout hash input from one block of
  // the grid
  if (sm90::bad_bf16_grid(a.drop)) return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    if (f32::misaligned(ptrs, 4, a.ql, a.kl))
      return (int)cudaErrorMisalignedAddress;
    return (int)(dh <= 64 ? launch_f32<64>(a) : launch_f32<128>(a));
  }
  if (dtype == 1) {
    if (sm90::misaligned(ptrs, 4, a.ql, a.kl))
      return (int)cudaErrorMisalignedAddress;
    return (int)(dh <= 64 ? launch_bf16<64>(a) : launch_bf16<128>(a));
  }
  return (int)cudaErrorInvalidValue;
}

const char* univtg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
