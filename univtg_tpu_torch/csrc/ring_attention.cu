// Ring attention for Hopper (sm_90a), f32 and bf16 inputs: the per-rank,
// per-step block update, the finish, and the K/V/mask hop to the right
// neighbour.
//
// Replaces univtg_tpu/ops/ring_attention_pallas.py:_ring_kernel (launched
// from ring_attention_pallas). The TPU kernel is one program per device that
// loops over the ring's steps, moves each K/V/mask block to its right
// neighbour by async remote copy into a double-buffered VMEM ring guarded by
// a credit semaphore, and keeps the online-softmax state in registers. Here
// the loop over steps, the slots and the handshake live on the host
// (ops/ring_attention_pallas.py): each rank has a compute stream and a copy
// stream, and CUDA events stand for the semaphores. This file holds what
// runs on the card:
//
//   ring_block   one launch per (rank, step): fold the resident K/V block
//                into the rank's state, kept in global memory between
//                launches (m, l: (BH, Lq) f32; acc: (BH, Lq, dh) f32)
//       s     = scale * q . k^T + (1 - mask) * (-1e30)    (f32: q * scale
//               before the dot, as the twin; bf16: the f32 product scaled)
//       m_new = max(m, rowmax s);  p = exp(s - m_new);  alpha = exp(m - m_new)
//       l     = l * alpha + rowsum p;  acc = acc * alpha + p . v   p stays f32
//   ring_finish  one launch per rank: out = acc / max(l, 1e-30) in q's dtype
//   ring_send    one hop: cudaMemcpyAsync (peer to peer across cards) of the
//                K, V and mask slots on the sender's copy stream
//
// The block update tiles the keys by 64 and runs the online softmax across
// the tiles, which equals the TPU kernel's one max per block in exact
// arithmetic; only the rounding differs. Keys past Lk in the last tile are
// left out, not masked: a row whose keys are all masked gets the mean of V
// over the real keys, as plain masked attention gives, whatever the tiling.
// There is no dropout: the model takes the plain ring for attention dropout,
// as the JAX package does.
//
// Bound on the card: a ring of P ranks does 4 * BH * L^2 * dh FLOP (all of
// it in the block launches) and moves q, k, v and out once plus P (P - 1)
// K/V/mask block hops, each read and written. In f32, and in bf16 at P = 1,
// the FLOP bound the time; in bf16 at P >= 4 the hops' bytes do (8 x 2080:
// 0.16 ms against 0.14 ms of tensor-core FLOP).
//
// The dtype picks the block kernel's design; this is a dispatch, not a
// fallback:
//
// bf16 -- tensor cores (ring_block_kernel_sm90<DH>, DH = 64 or 128, the head
// dim zero-filled up to DH): the loop of flash_fwd.cu's bf16 kernel, on
// flash_sm90.cuh's building blocks. One warpgroup of 128 threads and 64
// resident query rows per block, two blocks per SM; the block's K/V streams
// in 64-key tiles through two cp.async stages; S = q . k^T on wgmma (bf16
// operands, f32 sums), then * scale (after the dot: q * scale in bf16 would
// round, since dh^-0.5 is no power of two; the twin scales the f32 q, so the
// two differ by f32 rounding only). The state (m, l, acc) is read into the
// accumulator fragment unless `first` and written back at the end. p stays
// f32, as in the JAX ring: P . V is two register-A products into one
// accumulator, p_hi = bf16(p) and p_lo = bf16(p - p_hi), both exact bf16
// inputs against bf16 V; what p_hi + p_lo leaves of p is about 2^-17 of it.
//
// f32 -- CUDA cores (ring_block_kernel<DH, TAILS>, DH = 64 or 128, the head
// dim zero-filled up to DH): flash_f32.cuh's online-softmax loop (attend),
// the one flash_fwd.cu's f32 forward runs, with q * scale in f32 before the
// dot (as the twin), the state read unless `first` and written back, and no
// dropout. One block of 256 threads per (batch*head, 128 query rows), one
// block per SM; K, V and the key bias stream in 64-key tiles through two
// cp.async stages; S is 4 rows x 8 keys a thread and acc 8 x 8; a rank's
// ragged last query tile (8 rows of 520 at 8 x 2080, P = 4) computes only
// its rows and runs last.
//
// Both leave the state's round trip through global memory at every step (a
// kernel that loops over the steps itself would keep it in registers, but
// would have to wait on the copies inside the kernel: P blocks that spin on
// each other's flags deadlock when they are not all resident, so every wait
// stays in the stream and event graph), and the partial last tile when Lq
// or Lk is not a multiple of 64.
//
// Built by univtg_tpu_torch/ops/cuda_build.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and called through ctypes by univtg_tpu_torch/ops/ring_attention_pallas.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "flash_f32.cuh"
#include "flash_sm90.cuh"

namespace {

using flash::from_f32;
using flash::Layout;

constexpr int FINISH_THREADS = 256;

template <int DH, bool TAILS>
__global__ void __launch_bounds__(f32::THREADS, 1)
ring_block_kernel(const __grid_constant__ f32::AttendArgs a) {
  f32::attend_block<DH, true, TAILS>(a);
}

template <typename T>
__global__ void __launch_bounds__(FINISH_THREADS)
ring_finish_kernel(const float* __restrict__ l_state,
                   const float* __restrict__ acc_state, T* __restrict__ out,
                   int H, int Lq, int dh, Layout ol, long long total) {
  for (long long e = blockIdx.x * (long long)FINISH_THREADS + threadIdx.x;
       e < total; e += (long long)gridDim.x * FINISH_THREADS) {
    const long long sr = e / dh;  // bh * Lq + row
    const int c = (int)(e - sr * dh);
    const int bh = (int)(sr / Lq);
    const int row = (int)(sr - (long long)bh * Lq);
    const int b = bh / H;
    const int h = bh - b * H;
    out[b * ol.sb + h * ol.sh + row * ol.sl + c] =
        from_f32<T>(acc_state[e] / fmaxf(l_state[sr], 1e-30f));
  }
}

}  // namespace

namespace sm90 {

template <int DH>
constexpr size_t ring_smem() {  // Q; K, V x 2 stages; key bias x 2
  return 5 * tile_bytes<DH>() + 2 * TILE_ROWS * 4 + 1024;
}

// flash_fwd_kernel_sm90's loop, one launch per (rank, step): the state comes
// from and goes back to global memory, there is no dropout, and p stays f32
// through P . V (p_hi and p_lo, two register-A products).
template <int DH>
__global__ void __launch_bounds__(WG_THREADS, 2)
ring_block_kernel_sm90(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const float* __restrict__ mask,
                       float* __restrict__ m_state,
                       float* __restrict__ l_state,
                       float* __restrict__ acc_state, int H, int Lq, int Lk,
                       int dh, Layout ql, Layout kl, long long mask_sb,
                       float scale, int first) {
  constexpr int NT = DH / 64;  // 64-column slices of the accumulator
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
  const float* mp = mask + b * mask_sb;
  const long long state_row = (long long)bh * Lq + q0;

  load_tile<DH>(Qs, q + b * ql.sb + h * ql.sh, ql.sl, q0, Lq, dh);
  load_tile<DH>(Ks, kp, kl.sl, 0, Lk, dh);
  load_tile<DH>(Vs, vp, kl.sl, 0, Lk, dh);
  if (tid < TILE_ROWS) Bs[tid] = key_bias(mp, tid, Lk);
  cp_commit();

  float m_r[2], l_r[2], acc[NT][32];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int row = frag_row(2 * j);
    const bool load = !first && q0 + row < Lq;
    m_r[j] = load ? m_state[state_row + row] : -INFINITY;
    l_r[j] = load ? l_state[state_row + row] : 0.f;
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int row = frag_row(i);
      const int col = 64 * n + frag_col(i);
      float2 a = make_float2(0.f, 0.f);
      if (!first && q0 + row < Lq && col < dh)
        a = *reinterpret_cast<const float2*>(acc_state +
                                             (state_row + row) * dh + col);
      acc[n][i] = a.x;
      acc[n][i + 1] = a.y;
    }

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
    online_softmax(p, Bs + st * TILE_ROWS, k0, Lk, scale, m_r, l_r, alpha);
    uint32_t phi[16], plo[16];  // p = p_hi + p_lo + O(2^-17 p)
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      phi[i] = pack_bf16(p[2 * i], p[2 * i + 1]);
      plo[i] = pack_bf16(p[2 * i] - bf16_lo(phi[i]), p[2 * i + 1] - bf16_hi(phi[i]));
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[n][i] *= alpha[(i >> 1) & 1];

    wg_fence();
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int ks = 0; ks < TILE_ROWS / 16; ++ks) {
        const uint64_t vd = desc_mn(Vt, ks, n);
        mma_rs(acc[n], phi[4 * ks], phi[4 * ks + 1], phi[4 * ks + 2],
               phi[4 * ks + 3], vd);
        mma_rs(acc[n], plo[4 * ks], plo[4 * ks + 1], plo[4 * ks + 2],
               plo[4 * ks + 3], vd);
      }
    wg_commit();
    wg_wait(acc);
    __syncthreads();  // every warp is done with this stage
  }

  if ((tid & 3) == 0)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int row = frag_row(2 * j);
      if (q0 + row < Lq) {
        m_state[state_row + row] = m_r[j];
        l_state[state_row + row] = l_r[j];
      }
    }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int row = frag_row(i);
      const int col = 64 * n + frag_col(i);
      if (q0 + row < Lq && col < dh)
        *reinterpret_cast<float2*>(acc_state + (state_row + row) * dh + col) =
            make_float2(acc[n][i], acc[n][i + 1]);
    }
}

}  // namespace sm90

namespace {

struct BlockArgs {
  const void *q, *k, *v;
  const float* mask;
  float *m, *l, *acc;
  int BH, H, Lq, Lk, dh;
  Layout ql, kl;
  long long mask_sb;
  float scale;
  int first;
  cudaStream_t stream;
};

template <int DH, bool TAILS>
cudaError_t launch_block_f32_tiles(const BlockArgs& a) {
  constexpr size_t smem = f32::attend_smem<DH>();
  const cudaError_t err = sm90::allow_smem(ring_block_kernel<DH, TAILS>, smem);
  if (err != cudaSuccess) return err;
  const f32::AttendArgs args{
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), a.mask, nullptr, nullptr, a.m, a.l,
      a.acc, a.H, a.Lq, a.Lk, a.dh, a.ql, a.kl, a.mask_sb, a.scale,
      flash::Dropout{nullptr, 0u, 1.f, 0, 0, 0, 0}, a.first};
  const dim3 grid = f32::attend_grid(a.BH, a.Lq);
  ring_block_kernel<DH, TAILS><<<grid, f32::THREADS, smem, a.stream>>>(args);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_block_f32(const BlockArgs& a) {
  return f32::attend_tails(a.Lq) ? launch_block_f32_tiles<DH, true>(a)
                                 : launch_block_f32_tiles<DH, false>(a);
}

template <int DH>
cudaError_t launch_block_bf16(const BlockArgs& a) {
  using sm90::bf16;
  constexpr size_t smem = sm90::ring_smem<DH>();
  const cudaError_t err =
      sm90::allow_smem(sm90::ring_block_kernel_sm90<DH>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Lq + sm90::TILE_ROWS - 1) / sm90::TILE_ROWS, a.BH);
  sm90::ring_block_kernel_sm90<DH><<<grid, sm90::WG_THREADS, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), a.mask, a.m, a.l, a.acc, a.H, a.Lq, a.Lk,
      a.dh, a.ql, a.kl, a.mask_sb, a.scale, a.first);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_finish(const float* l, const float* acc, void* out, int BH,
                          int H, int Lq, int dh, Layout ol,
                          cudaStream_t stream) {
  const long long total = (long long)BH * Lq * dh;
  const long long blocks = (total + FINISH_THREADS - 1) / FINISH_THREADS;
  const int grid = (int)(blocks < 65536 ? blocks : 65536);
  ring_finish_kernel<T><<<grid, FINISH_THREADS, 0, stream>>>(
      l, acc, static_cast<T*>(out), H, Lq, dh, ol, total);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One ring step of one rank. q is the rank's (B, Lq, D) queries and k, v
// the resident (B, Lk, D) block, each with (batch, head, row) element
// strides and a dense head dim; mask is the block's (B, Lk) f32 key mask
// (1 = valid) with batch stride mask_sb. m, l (BH, Lq) and acc (BH, Lq, dh)
// are the rank's f32 state, dense: read unless `first`, always written.
// scale multiplies q . k^T (the f32 kernel scales q before the dot, the
// bf16 kernel the f32 product after it). dtype: 0 = float32 (CUDA-core
// kernel; q, k, v and acc 16-byte aligned, every stride a multiple of 4
// elements), 1 = bfloat16 (wgmma kernel; q, k and v 16-byte aligned, every
// stride a multiple of 8 elements), or the call returns
// cudaErrorMisalignedAddress.
// Returns a cudaError_t; 0 on success. Launches on `stream`, allocates
// nothing and does not synchronise.
int univtg_ring_block(const void* q, const void* k, const void* v,
                      const void* mask, void* m, void* l, void* acc, int dtype,
                      int BH, int H, int Lq, int Lk, int dh, long long q_sb,
                      long long q_sh, long long q_sl, long long k_sb,
                      long long k_sh, long long k_sl, long long mask_sb,
                      float scale, int first, void* stream) {
  if (dh <= 0 || dh > f32::MAX_DH || dh % 8 != 0 || Lq <= 0 || Lk <= 0 ||
      BH <= 0 || H <= 0 || BH % H != 0 || BH > 65535)
    return (int)cudaErrorInvalidValue;
  const BlockArgs a{q, k, v, static_cast<const float*>(mask),
                    static_cast<float*>(m), static_cast<float*>(l),
                    static_cast<float*>(acc), BH, H, Lq, Lk, dh,
                    Layout{q_sb, q_sh, q_sl}, Layout{k_sb, k_sh, k_sl},
                    mask_sb, scale, first, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) {
    const void* ptrs[] = {q, k, v, acc};
    if (f32::misaligned(ptrs, 4, a.ql, a.kl))
      return (int)cudaErrorMisalignedAddress;
    return (int)(dh <= 64 ? launch_block_f32<64>(a)
                          : launch_block_f32<128>(a));
  }
  if (dtype == 1) {
    const void* ptrs[] = {q, k, v};
    if (sm90::misaligned(ptrs, 3, a.ql, a.kl))
      return (int)cudaErrorMisalignedAddress;
    return (int)(dh <= 64 ? launch_block_bf16<64>(a)
                          : launch_block_bf16<128>(a));
  }
  return (int)cudaErrorInvalidValue;
}

// The finish of one rank: out (B, Lq, D) with (batch, head, row) element
// strides gets acc / max(l, 1e-30) in `dtype`.
int univtg_ring_finish(const void* l, const void* acc, void* out, int dtype,
                       int BH, int H, int Lq, int dh, long long o_sb,
                       long long o_sh, long long o_sl, void* stream) {
  if (dh <= 0 || Lq <= 0 || BH <= 0 || H <= 0 || BH % H != 0)
    return (int)cudaErrorInvalidValue;
  const Layout ol{o_sb, o_sh, o_sl};
  const float* ls = static_cast<const float*>(l);
  const float* as = static_cast<const float*>(acc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_finish<float>(ls, as, out, BH, H, Lq, dh, ol, s);
  if (dtype == 1)
    return (int)launch_finish<__nv_bfloat16>(ls, as, out, BH, H, Lq, dh, ol,
                                             s);
  return (int)cudaErrorInvalidValue;
}

// One hop of the ring: the sender's K, V (kv_bytes each) and mask
// (mask_bytes) slots into the receiver's, on `stream` (the sender's copy
// stream, on the sender's card). Cards differ: peer to peer.
int univtg_ring_send(const void* k_src, const void* v_src, const void* m_src,
                     void* k_dst, void* v_dst, void* m_dst, long long kv_bytes,
                     long long mask_bytes, int src_device, int dst_device,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* src[3] = {k_src, v_src, m_src};
  void* dst[3] = {k_dst, v_dst, m_dst};
  const long long bytes[3] = {kv_bytes, kv_bytes, mask_bytes};
  for (int i = 0; i < 3; ++i) {
    const cudaError_t err =
        src_device == dst_device
            ? cudaMemcpyAsync(dst[i], src[i], (size_t)bytes[i],
                              cudaMemcpyDeviceToDevice, s)
            : cudaMemcpyPeerAsync(dst[i], dst_device, src[i], src_device,
                                  (size_t)bytes[i], s);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

const char* univtg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
