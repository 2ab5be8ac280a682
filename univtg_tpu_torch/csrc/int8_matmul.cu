// Int8 weight-only dequant-matmul for Hopper (sm_90a), f32 and bf16 inputs.
//
// Replaces univtg_tpu/ops/pallas_int8.py:_kernel (launched by int8_matmul):
//
//   out = (x.f32 @ (w_q.f32 * scale.f32)).astype(x.dtype)
//
// x is (M, K) in f32 or bf16, w_q is (K, N) int8, scale is (N,) f32, one per
// output column (the serving tier quantizes per output channel,
// serve/quantize.py). The sum runs in f32 and the result is rounded to x's
// dtype once, at the store.
//
// Bound on the card: at serving batches (M = 128) the bytes, and of those the
// int8 weight (K * N) dominates, which is the whole point of storing it in
// int8; from M ~ 4096 up the operations (2 * M * K * N). So no kernel writes
// a dequantized copy of the weight to device memory.
//
// The dtype picks the design; this is a dispatch, not a fallback:
//
// bf16 -- tensor cores (int8_matmul_kernel_sm90<BN, XA, WA>). Exact
// dequantization, scale last: every int8 value is exact in bf16 and a
// bf16 x bf16 product is exact in f32, so w_q goes to bf16 WITHOUT its
// scale, wgmma sums x . w_q in f32, and the epilogue multiplies column n of
// the f32 sum by scale[n] before the one rounding to bf16. Against the twin,
// which scales each weight before its product, only the f32 summation order
// differs (the scale's rounding moves from each term to the sum, a relative
// 2^-24 either way), so the bf16 outputs differ only where an f32 sum falls
// on the far side of a rounding boundary: one bf16 step on a rare element,
// as the limits of chip_smoke.INT8_TOL allow.
//   A block owns a 128 x BN tile of out (BN = 64, 128 or 256) and runs one
//   per SM: a producer warpgroup and two consumer warpgroups of 64 rows
//   each, handing 64-deep stages over named barriers (FULL, EMPTY). The
//   producer copies each stage's raw bytes by cp.async, three stages deep:
//   for every row of x and of w_q the aligned 16-byte blocks that cover it,
//   so no row needs an aligned start (x's rows are 2K bytes apart, 5636 at
//   the flagship's K = 2818: 4-byte aligned; w_q's N). It then shifts x's
//   row into a 128-byte-swizzled K-major tile (wgmma's A, sm90::desc_k) and
//   converts w_q's int8 to bf16 (a byte into the mantissa of 2^23 + 128, one
//   subtraction, the top half of the exact f32) into a swizzled MN-major
//   tile (wgmma's B, sm90::desc_mn_atoms), into a ring of two stages. The
//   consumers only issue m64nBNk16 products, keeping the previous stage's in
//   flight. XA / WA: every row of x / w_q 16-byte aligned, so no shift. The
//   producer's copying and converting bound the kernel: a 128 x 128 variant
//   ran 2.5x as fast with its products alone (PERF.md section 6).
//   Ragged edges need no copy either: blocks past M, N or K land as zeros,
//   x's elements past K are zeroed in the shift, and w_q's bytes past N
//   reach only columns that are not stored.
//   Where the tiles alone leave SMs idle (serving batches) the wrapper's plan
//   (ops/int8_matmul.py:_plan) splits K: split s takes k_tiles stages from
//   64 * k_tiles * s and writes its f32 partial sums to a workspace, and
//   int8_matmul_split_sum adds the splits in their order, scales and rounds.
//   No atomics: the same input gives the same bits on every run.
//
// f32 -- CUDA cores (int8_matmul_kernel<float>): TF32 would miss the f32
// limit (rel 1e-5), as for the f32 flash kernels. One block of 256 threads
// per 64 x 64 output tile; a loop over K in chunks of 32, each chunk of x
// and of w_q staged through shared memory as f32 (the int8 weight converted
// and scaled as it is staged, w * scale[n] as the reference multiplies);
// each thread owns a 4 x 4 patch of outputs, rows ty + 16 i and columns
// tx + 16 j, and accumulates it with scalar FMAs. Ragged edges are masked in
// the kernel, so the wrapper pads nothing.
//
// Built by univtg_tpu_torch/ops/cuda_build.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and called through ctypes by univtg_tpu_torch/ops/int8_matmul.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_sm90.cuh"

namespace {

// ---------------------------------------------------------------------------
// f32: CUDA cores

constexpr int BLOCK_M = 64;   // output rows per block
constexpr int BLOCK_N = 64;   // output columns per block
constexpr int BLOCK_K = 32;   // depth of one staged chunk
constexpr int THREADS = 256;  // 16 x 16 threads, a 4 x 4 patch each
constexpr int PATCH = 4;
constexpr int LDX = BLOCK_M + 1;  // x chunk stored k-major, padded

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
int8_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ scale, T* __restrict__ out,
                   int M, int N, int K) {
  __shared__ float Xs[BLOCK_K * LDX];      // Xs[k][m]
  __shared__ float Ws[BLOCK_K * BLOCK_N];  // Ws[k][n], dequantized

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * BLOCK_M;
  const int n0 = blockIdx.x * BLOCK_N;

  // the weight column this thread stages is the same in every chunk
  const int wn = tid % BLOCK_N;
  const float s = n0 + wn < N ? scale[n0 + wn] : 0.f;

  float acc[PATCH][PATCH];
#pragma unroll
  for (int i = 0; i < PATCH; ++i)
#pragma unroll
    for (int j = 0; j < PATCH; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BLOCK_K) {
    // x chunk: 64 rows x 32 k, consecutive threads on consecutive k
#pragma unroll
    for (int e = 0; e < BLOCK_M * BLOCK_K / THREADS; ++e) {
      const int idx = tid + e * THREADS;
      const int r = idx / BLOCK_K, c = idx % BLOCK_K;
      const int m = m0 + r, k = k0 + c;
      Xs[c * LDX + r] = (m < M && k < K) ? to_f32(x[(size_t)m * K + k]) : 0.f;
    }
    // w chunk: 32 k x 64 n, consecutive threads on consecutive n
#pragma unroll
    for (int e = 0; e < BLOCK_K * BLOCK_N / THREADS; ++e) {
      const int idx = tid + e * THREADS;
      const int r = idx / BLOCK_N;
      const int n = n0 + wn, k = k0 + r;
      Ws[r * BLOCK_N + wn] =
          (n < N && k < K) ? (float)w[(size_t)k * N + n] * s : 0.f;
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < BLOCK_K; ++kk) {
      float a[PATCH], b[PATCH];
#pragma unroll
      for (int i = 0; i < PATCH; ++i) a[i] = Xs[kk * LDX + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < PATCH; ++j) b[j] = Ws[kk * BLOCK_N + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < PATCH; ++i)
#pragma unroll
        for (int j = 0; j < PATCH; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < PATCH; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < PATCH; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) out[(size_t)m * N + n] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const float* scale,
                   void* out, int M, int N, int K, cudaStream_t stream) {
  const dim3 grid((N + BLOCK_N - 1) / BLOCK_N, (M + BLOCK_M - 1) / BLOCK_M);
  int8_matmul_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(w), scale,
      static_cast<T*>(out), M, N, K);
  return cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// bf16: tensor cores

namespace sm90 {

// One block: a producer warpgroup (warps 0-3) and two consumer warpgroups,
// each consumer with 64 of the tile's 128 rows.
constexpr int I8_THREADS = 3 * WG_THREADS;
constexpr int I8_BM = 2 * TILE_ROWS;  // 128 rows of x and out
constexpr int I8_BK = 64;             // depth of one stage
constexpr int RAW = 3;                // stages of raw bytes in flight
constexpr int RING = 2;               // stages of bf16 tiles for wgmma
constexpr uint32_t X_TILE = I8_BM * I8_BK * 2;  // one bf16 x stage, 16 KB
constexpr uint32_t X_RAW = I8_BM * 144;  // 9 aligned 16-byte blocks a row
// named barriers (0 is __syncthreads): the producer's own; FULL + s: slot
// s of the ring holds a converted stage; EMPTY + s: its products are done
constexpr int BAR_PRODUCER = 1, BAR_FULL = 2, BAR_EMPTY = 2 + RING;

template <int BN>
__host__ __device__ constexpr uint32_t w_raw_bytes() {  // 64 rows of BN + 16
  return I8_BK * (BN + 16);
}
template <int BN>
__host__ __device__ constexpr uint32_t b_bytes() {  // one bf16 w_q stage
  return I8_BK * BN * 2;
}
template <int BN>
__host__ __device__ constexpr size_t i8_smem() {  // + 1024 to align
  return 1024 + RING * (X_TILE + b_bytes<BN>()) +
         RAW * (X_RAW + w_raw_bytes<BN>());
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The aligned 16-byte block at src by cp.async, or zeros where `ok` is
// false (no global read; `base`, the operand's start, stands in for src).
__device__ __forceinline__ void copy_block(uint32_t dst, uintptr_t src,
                                           const void* base, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(ok ? reinterpret_cast<const void*>(src) : base),
               "r"(ok ? 16 : 0)
               : "memory");
}

// Raw bytes of one stage, as aligned 16-byte blocks, by the producer's
// threads (p = its thread index). x: for each of the 128 rows, the 9 blocks
// that cover its 128 bytes [k0, k0 + 64) (8 where XA: every row 16-byte
// aligned), row r at 144 r; a block is read only where it holds bytes of
// the row inside K (an aligned block never crosses a page), else zeros, and
// rows past M are zeros. w_q: the same for its 64 rows of BN bytes [n0,
// n0 + BN) (BN / 16 + 1 blocks, BN / 16 where WA), row k at (BN + 16) k;
// rows past K are zeros. Bytes past N are not masked: they reach only
// columns of out that are not stored.
template <int BN, bool XA, bool WA>
__device__ __forceinline__ void load_raw(uint32_t xr, uint32_t wr,
                                         const bf16* x, const int8_t* w,
                                         int M, int N, int K, int m0, int n0,
                                         int k0, int p) {
  constexpr int XB = XA ? 8 : 9;  // blocks a row
  const int kn = min(I8_BK, K - k0);
#pragma unroll
  for (int it = 0; it < XB; ++it) {
    const int e = p + it * WG_THREADS;
    const int r = e / XB, i = e % XB;
    const int m = m0 + r;
    const uintptr_t a =
        reinterpret_cast<uintptr_t>(x + (size_t)(m < M ? m : 0) * K + k0);
    const uintptr_t b = (a & ~(uintptr_t)15) + 16 * i;
    copy_block(xr + r * 144 + 16 * i, b, x, m < M && b < a + 2 * kn);
  }
  constexpr int WB = BN / 16 + (WA ? 0 : 1);
#pragma unroll
  for (int it = 0; it < (I8_BK * WB + WG_THREADS - 1) / WG_THREADS; ++it) {
    const int e = p + it * WG_THREADS;
    if (e >= I8_BK * WB) break;
    const int r = e / WB, i = e % WB;
    const int k = k0 + r;
    const uintptr_t a =
        reinterpret_cast<uintptr_t>(w + (size_t)(k < K ? k : 0) * N + n0);
    const uintptr_t b = (a & ~(uintptr_t)15) + 16 * i;
    copy_block(wr + r * (BN + 16) + 16 * i, b, w, k < K && b < a + (N - n0));
  }
}

// Words [s, s + n) of v, for a runtime s in 0..3, without indexing v at run
// time (two rounds of selects).
template <int N, int V>
__device__ __forceinline__ void shift_words(const uint32_t (&v)[V], int s,
                                            uint32_t (&o)[N]) {
  static_assert(V >= N + 3, "room to shift");
  uint32_t t[N + 2];
#pragma unroll
  for (int i = 0; i < N + 2; ++i) t[i] = s & 1 ? v[i + 1] : v[i];
#pragma unroll
  for (int i = 0; i < N; ++i) o[i] = s & 2 ? t[i + 2] : t[i];
}

// Four int8 values (one word) to two bf16 pairs, exactly: byte b ^ 0x80 is
// v + 128, put in the low mantissa of 2^23 it reads 2^23 + 128 + v, and the
// subtraction leaves v in f32, whose top half is v in bf16 (8 significant
// bits suffice). lo gets bytes 0, 1, hi bytes 2, 3, the lower in the low half.
__device__ __forceinline__ void int8x4_to_bf16(uint32_t word, uint32_t& lo,
                                               uint32_t& hi) {
  const uint32_t u = word ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    f[q] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | q)) -
           8388736.f;  // 2^23 + 128
  lo = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
  hi = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
}

__device__ __forceinline__ void sts128(uint32_t dst, const uint32_t* v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
               "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3])
               : "memory");
}
__device__ __forceinline__ void lds128(uint32_t src, uint32_t* v) {
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
               : "r"(src));
}

// The producer's thread p turns one raw stage into the bf16 tiles wgmma
// reads. x: row p of the stage, shifted from its raw blocks into the
// 128-byte-swizzled K-major tile at xt (row r at 128 r bytes, 16-byte chunk
// c at position c ^ (r % 8): wgmma's A, sm90::desc_k), elements past K as
// zeros. w_q: 16-byte int8 chunks of row p / 2, shifted likewise, converted
// into the swizzled MN-major tile at bt (sm90::swz: wgmma's B,
// sm90::desc_mn_atoms). A fence.proxy.async must follow before wgmma reads
// them.
template <int BN, bool XA, bool WA>
__device__ __forceinline__ void convert(uint32_t xt, uint32_t bt, uint32_t xr,
                                        uint32_t wr, const bf16* x,
                                        const int8_t* w, int N, int K, int m0,
                                        int n0, int k0, int p) {
  {  // x row p: 32 words from 9 blocks at byte offset a % 16 (even)
    const uintptr_t a =
        reinterpret_cast<uintptr_t>(x + (size_t)(m0 + p) * K + k0);
    const int off = XA ? 0 : (int)(a & 15);
    uint32_t v[36], o[32];
#pragma unroll
    for (int i = 0; i < (XA ? 8 : 9); ++i) lds128(xr + p * 144 + 16 * i, v + 4 * i);
    if constexpr (XA) {
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] = v[i];
    } else {
      uint32_t s[33];
      shift_words<33>(v, off >> 2, s);
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] = __funnelshift_r(s[i], s[i + 1], 8 * (off & 3));
    }
    const int kn = K - k0;  // elements of the row inside K
    if (kn < I8_BK) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        o[i] = 2 * i + 1 < kn ? o[i] : 2 * i < kn ? o[i] & 0xFFFFu : 0u;
    }
#pragma unroll
    for (int c = 0; c < 8; ++c) sts128(xt + p * 128 + (((c ^ p) & 7) << 4), o + 4 * c);
  }
  {  // w_q row p / 2, columns [BN / 2 * (p % 2), BN / 2 * (p % 2 + 1))
    constexpr int CH = BN / 32;  // 16-byte int8 chunks per thread
    const int r = p >> 1, j0 = (p & 1) * CH;
    const uintptr_t a =
        reinterpret_cast<uintptr_t>(w + (size_t)(k0 + r) * N + n0);
    const int off = WA ? 0 : (int)(a & 15);
    uint32_t v[4 * CH + 4], o[4 * CH];
#pragma unroll
    for (int i = 0; i < CH + (WA ? 0 : 1); ++i)
      lds128(wr + r * (BN + 16) + 16 * (j0 + i), v + 4 * i);
    if constexpr (WA) {
#pragma unroll
      for (int i = 0; i < 4 * CH; ++i) o[i] = v[i];
    } else {
      uint32_t s[4 * CH + 1];
      shift_words<4 * CH + 1>(v, off >> 2, s);
#pragma unroll
      for (int i = 0; i < 4 * CH; ++i)
        o[i] = __funnelshift_r(s[i], s[i + 1], 8 * (off & 3));
    }
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      uint32_t b[8];
#pragma unroll
      for (int q = 0; q < 4; ++q) int8x4_to_bf16(o[4 * c + q], b[2 * q], b[2 * q + 1]);
      sts128(bt + swz(r, 2 * (j0 + c)), b);
      sts128(bt + swz(r, 2 * (j0 + c) + 1), b + 4);
    }
  }
}

// One 128 x BN tile of out (blockIdx.x: the tile, N tiles fastest, so the
// blocks that share x's rows run together) over the 64-deep stages
// [k_tiles * blockIdx.y, k_tiles * (blockIdx.y + 1)) of K. partial null:
// out = bf16(sum * scale); else the f32 sum goes to partial[blockIdx.y].
template <int BN, bool XA, bool WA>
__global__ void __launch_bounds__(I8_THREADS, 1)
int8_matmul_kernel_sm90(const bf16* __restrict__ x,
                        const int8_t* __restrict__ w,
                        const float* __restrict__ scale,
                        bf16* __restrict__ out, float* __restrict__ partial,
                        int M, int N, int K, int k_tiles) {
  constexpr int NA = BN / 64;  // 64-column atoms of the tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t Xt = (smem_u32(smem_raw) + 1023) & ~1023u;  // RING x tiles
  const uint32_t Bt = Xt + RING * X_TILE;                      // RING w tiles
  const uint32_t Xr = Bt + RING * b_bytes<BN>();               // RAW x bytes
  const uint32_t Wr = Xr + RAW * X_RAW;                        // RAW w bytes

  const int n_tiles = (N + BN - 1) / BN;
  const int n0 = (blockIdx.x % n_tiles) * BN;
  const int m0 = (blockIdx.x / n_tiles) * I8_BM;
  const int kt0 = blockIdx.y * k_tiles;
  const int nk = min(k_tiles, (K + I8_BK - 1) / I8_BK - kt0);  // >= 1
  const int wg = threadIdx.x / WG_THREADS;

  if (wg == 0) {  // producer: raw stages RAW - 1 ahead, then convert
    const int p = threadIdx.x;
    auto load = [&](int t) {
      if (t < nk)
        load_raw<BN, XA, WA>(Xr + (t % RAW) * X_RAW,
                             Wr + (t % RAW) * w_raw_bytes<BN>(), x, w, M, N,
                             K, m0, n0, (kt0 + t) * I8_BK, p);
      cp_commit();
    };
#pragma unroll
    for (int t = 0; t < RAW - 1; ++t) load(t);
    for (int t = 0; t < nk; ++t) {
      asm volatile("cp.async.wait_group %0;\n" ::"n"(RAW - 2) : "memory");
      // every producer thread's copies of stage t have landed, and every
      // one is done with stage t - 1's raw slot
      bar_sync(BAR_PRODUCER, WG_THREADS);
      load(t + RAW - 1);
      const int s = t % RING;
      if (t >= RING) bar_sync(BAR_EMPTY + s, I8_THREADS);  // stage t - RING
      convert<BN, XA, WA>(Xt + s * X_TILE, Bt + s * b_bytes<BN>(),
                          Xr + (t % RAW) * X_RAW,
                          Wr + (t % RAW) * w_raw_bytes<BN>(), x, w, N, K, m0,
                          n0, (kt0 + t) * I8_BK, p);
      fence_async();
      bar_arrive(BAR_FULL + s, I8_THREADS);
    }
    return;
  }

  // consumers: warpgroup wg - 1 owns rows [64 (wg - 1), 64 wg) of the tile
  float acc[NA][32];
  zero(acc);
  const uint32_t Xw = Xt + (wg - 1) * TILE_ATOM;
  for (int t = 0; t < nk; ++t) {
    const int s = t % RING;
    bar_sync(BAR_FULL + s, I8_THREADS);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < I8_BK / 16; ++ks)
      mma_ss_mn(acc, desc_k(Xw + s * X_TILE, ks),
                desc_mn_atoms(Bt + s * b_bytes<BN>(), ks));
    wg_commit();
    wg_wait_prev();  // stage t - 1's products are done: release its slot
    if (t >= 1 && t - 1 + RING < nk)
      bar_arrive(BAR_EMPTY + (t - 1) % RING, I8_THREADS);
  }
  wg_wait(acc);

  const int ct = threadIdx.x - WG_THREADS;  // 0..255 over the two consumers
  const int row = 16 * (ct >> 5) + ((ct & 31) >> 2);
  const bool pairs = (N & 1) == 0;  // column pairs 4- (8-) byte aligned
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int m = m0 + row + 8 * ((i >> 1) & 1);
      const int n = n0 + 64 * a + frag_col(i);
      if (m >= M || n >= N) continue;
      const size_t o = (size_t)m * N + n;
      if (partial) {
        float* q = partial + (size_t)blockIdx.y * M * N + o;
        if (pairs)
          *reinterpret_cast<float2*>(q) = make_float2(acc[a][i], acc[a][i + 1]);
        else {
          q[0] = acc[a][i];
          if (n + 1 < N) q[1] = acc[a][i + 1];
        }
      } else if (pairs) {
        *reinterpret_cast<__nv_bfloat162*>(out + o) = __floats2bfloat162_rn(
            acc[a][i] * __ldg(scale + n), acc[a][i + 1] * __ldg(scale + n + 1));
      } else {
        out[o] = __float2bfloat16(acc[a][i] * __ldg(scale + n));
        if (n + 1 < N)
          out[o + 1] = __float2bfloat16(acc[a][i + 1] * __ldg(scale + n + 1));
      }
    }
}

// out = bf16((partial[0] + partial[1] + ... + partial[splits - 1]) * scale),
// the splits added in their order.
__global__ void int8_matmul_split_sum(const float* __restrict__ partial,
                                      const float* __restrict__ scale,
                                      bf16* __restrict__ out, int M, int N,
                                      int splits) {
  const size_t MN = (size_t)M * N;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < MN;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < splits; ++p) s += partial[p * MN + i];
    out[i] = __float2bfloat16(s * __ldg(scale + i % N));
  }
}

struct Plan {
  int block_n, splits, k_tiles;
};

template <int BN, bool XA, bool WA>
cudaError_t launch_tile(const void* x, const void* w, const float* scale,
                        void* out, float* partial, int M, int N, int K, Plan p,
                        cudaStream_t stream) {
  constexpr size_t smem = i8_smem<BN>();
  cudaError_t err = allow_smem(int8_matmul_kernel_sm90<BN, XA, WA>, smem);
  if (err != cudaSuccess) return err;
  const long long tiles =
      (long long)((M + I8_BM - 1) / I8_BM) * ((N + BN - 1) / BN);
  if (tiles > 0x7fffffff || p.splits > 65535) return cudaErrorInvalidValue;
  int8_matmul_kernel_sm90<BN, XA, WA>
      <<<dim3((unsigned)tiles, p.splits), I8_THREADS, smem, stream>>>(
          static_cast<const bf16*>(x), static_cast<const int8_t*>(w), scale,
          static_cast<bf16*>(out), p.splits > 1 ? partial : nullptr, M, N, K,
          p.k_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return err;
  const long long blocks = ((long long)M * N + 255) / 256;  // grid-stride
  int8_matmul_split_sum<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0,
                          stream>>>(partial, scale, static_cast<bf16*>(out),
                                    M, N, p.splits);
  return cudaGetLastError();
}

template <int BN>
cudaError_t launch_bn(bool xa, bool wa, const void* x, const void* w,
                      const float* scale, void* out, float* partial, int M,
                      int N, int K, Plan p, cudaStream_t stream) {
  if (xa && wa)
    return launch_tile<BN, true, true>(x, w, scale, out, partial, M, N, K, p,
                                       stream);
  if (xa)
    return launch_tile<BN, true, false>(x, w, scale, out, partial, M, N, K, p,
                                        stream);
  if (wa)
    return launch_tile<BN, false, true>(x, w, scale, out, partial, M, N, K, p,
                                        stream);
  return launch_tile<BN, false, false>(x, w, scale, out, partial, M, N, K, p,
                                       stream);
}

// Every row of a (rows, stride) matrix of `size`-byte elements at ptr starts
// on a 16-byte boundary.
bool rows_aligned(const void* ptr, int stride, int size) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 &&
         (size_t)stride * size % 16 == 0;
}

cudaError_t launch_bf16(const void* x, const void* w, const float* scale,
                        void* out, float* partial, int M, int N, int K, Plan p,
                        cudaStream_t stream) {
  const int kt = (K + I8_BK - 1) / I8_BK;
  // every split holds at least one stage, and together they hold all
  if (p.splits < 1 || p.k_tiles < 1 || (long long)p.splits * p.k_tiles < kt ||
      (long long)(p.splits - 1) * p.k_tiles >= kt ||
      (p.splits > 1 && !partial))
    return cudaErrorInvalidValue;
  const bool xa = rows_aligned(x, K, 2), wa = rows_aligned(w, N, 1);
  if (p.block_n == 256)
    return launch_bn<256>(xa, wa, x, w, scale, out, partial, M, N, K, p,
                          stream);
  if (p.block_n == 128)
    return launch_bn<128>(xa, wa, x, w, scale, out, partial, M, N, K, p,
                          stream);
  if (p.block_n == 64)
    return launch_bn<64>(xa, wa, x, w, scale, out, partial, M, N, K, p,
                         stream);
  return cudaErrorInvalidValue;
}

}  // namespace sm90

extern "C" {

// x (M, K), w (K, N) int8, scale (N,) f32 and out (M, N), all dense and
// row-major; x and out share the dtype: 0 = float32 (CUDA cores), 1 =
// bfloat16 (wgmma, after the plan: block_n 64, 128 or 256 columns a block, K in
// `splits` runs of k_tiles 64-deep stages, each split non-empty; with
// splits > 1, partial is an f32 workspace of splits * M * N). Returns a
// cudaError_t; 0 on success. Launches on `stream`, allocates nothing and
// does not synchronise.
int univtg_int8_matmul(const void* x, const void* w, const void* scale,
                       void* out, int dtype, int M, int N, int K, int block_n,
                       int splits, int k_tiles, void* partial, void* stream) {
  const float* s = static_cast<const float*>(scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    if ((M + BLOCK_M - 1) / BLOCK_M > 65535) return (int)cudaErrorInvalidValue;
    return (int)launch<float>(x, w, s, out, M, N, K, st);
  }
  if (dtype == 1)
    return (int)sm90::launch_bf16(x, w, s, out, static_cast<float*>(partial),
                                  M, N, K, {block_n, splits, k_tiles}, st);
  return (int)cudaErrorInvalidValue;
}

const char* univtg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
