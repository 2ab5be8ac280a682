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
// Bound on the card: in bf16, at serving batches (M = 128) the bytes, and of
// those the int8 weight (K * N) dominates, which is the whole point of
// storing it in int8; from M ~ 4096 up the operations (2 * M * K * N). In
// f32 the operations at every M (67 TFLOP/s of FFMA against 989 of bf16
// wgmma). So no kernel writes a dequantized copy of the weight to device
// memory.
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
//   int8_matmul_split_sum<bf16> adds the splits in their order, scales and
//   rounds.
//   No atomics: the same input gives the same bits on every run.
//
// f32 -- CUDA cores (int8_matmul_f32_kernel<VEC, WA>), in plain f32 FFMA:
// TF32 would miss the f32 limit (rel 1e-5), as for the f32 flash kernels.
// The SGEMM recipe of csrc/flash_f32.cuh. A block of 256 threads owns a
// 128 x 128 tile of out and runs one per SM; each thread keeps an 8 x 8
// register tile, rows ty + 16 i and columns tx + 16 j, fed by float4 reads
// along K: per 4 of K, 8 rows of the x tile and 8 of the w_q^T tile, 256
// FFMA per 16 LDS.128, which balances shared memory against the FMA pipes
// (flash_f32.cuh's reckoning). Both tiles are K-major rows of 32 floats,
// chunk c of row r at chunk c ^ (r % 8) (f32::chunk_at); a warp is 4 x 8
// threads, so a quarter warp reads one x row (a broadcast) and 8 w_q^T rows
// of distinct r % 8.
//   K runs in 32-deep chunks through three stages filled by cp.async, one
//   barrier a chunk: chunk t + 2 copies while chunk t is computed, x
//   straight into its f32 tile, VEC floats a copy (2 where every row of x
//   starts on 8 bytes, as at the flagship's K = 2818 whose rows are 11272
//   bytes apart, else 1); w_q as raw bytes, the aligned
//   16-byte blocks that cover each row's 128 columns (8 where every row is
//   16-byte aligned, WA, then XOR-placed by k / 4 so that the convert's
//   reads hit distinct banks; else 9, shifted as they are read). Before
//   chunk t's product each thread converts 16 bytes of chunk t + 1's raw
//   stage into the second w_q^T tile: a word of each of 4 rows of K, each
//   byte v put into the mantissa of 2^23 + 128 and 2^23 + 128 subtracted
//   (v exactly), times scale[n], 4 float4 stores. ptxas must report no
//   spill for any instantiation (chip_smoke.py, phase 2).
//   Scale per weight, as the twin: v * scale[n] is the twin's own f32
//   rounding, so the kernel sums the twin's terms and only the order of the
//   sum differs. Where K is not split the order is the twin's too (one FMA
//   chain over k), and the f32 outputs read bit-equal to the twin's on the
//   H100 at M = 4096 and 16384 (PERF.md section 6); the scale applied to the
//   sum instead read rel 3.5e-6 there, a third of the limit.
//   Where the tiles alone leave SMs idle (M = 128: 8 tiles; M = 2400: 152
//   for 132 SMs) the plan (ops/int8_matmul.py:_plan) splits K into runs of
//   whole chunks, each split's f32 sums go to the workspace, and
//   int8_matmul_split_sum<float> adds them in their order (with no scale:
//   the terms hold it). No atomics: the same input gives the same bits on
//   every run.
//   Ragged edges need no copy: rows past M and elements past K are zeros,
//   and w_q's bytes past N reach only columns of out that are not stored.
//
// Built by univtg_tpu_torch/ops/cuda_build.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and called through ctypes by univtg_tpu_torch/ops/int8_matmul.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_f32.cuh"

namespace {

// Both kernels' tiling from the wrapper's plan: block_n columns a block (f32:
// 128; bf16: 64, 128 or 256), K in `splits` runs of k_tiles chunks (f32: 32
// deep; bf16: 64-deep stages).
struct Plan {
  int block_n, splits, k_tiles;
};

// Whether the plan's splits of a K of kt chunks each hold at least one chunk
// and together hold all, with a workspace where they are more than one.
bool plan_ok(Plan p, int kt, const float* partial) {
  return p.splits >= 1 && p.k_tiles >= 1 && (long long)p.splits * p.k_tiles >= kt &&
         (long long)(p.splits - 1) * p.k_tiles < kt && (p.splits == 1 || partial);
}

// Every row of a (rows, stride) matrix of `size`-byte elements at ptr starts
// on a 16-byte boundary.
bool rows_aligned(const void* ptr, int stride, int size) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 &&
         (size_t)stride * size % 16 == 0;
}

// out = T((partial[0] + partial[1] + ... + partial[splits - 1]) * scale),
// the splits added in their order; scale null: the partial sums hold it.
template <typename T>
__global__ void int8_matmul_split_sum(const float* __restrict__ partial,
                                      const float* __restrict__ scale,
                                      T* __restrict__ out, int M, int N,
                                      int splits) {
  const size_t MN = (size_t)M * N;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < MN;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < splits; ++p) s += partial[p * MN + i];
    out[i] = flash::from_f32<T>(scale ? s * __ldg(scale + i % N) : s);
  }
}

template <typename T>
cudaError_t launch_split_sum(const float* partial, const float* scale, T* out,
                             int M, int N, int splits, cudaStream_t stream) {
  const long long blocks = ((long long)M * N + 255) / 256;  // grid-stride
  int8_matmul_split_sum<T><<<(unsigned)(blocks < 4096 ? blocks : 4096), 256,
                             0, stream>>>(partial, scale, out, M, N, splits);
  return cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// f32: CUDA cores

namespace i8f32 {

using f32::chunk_at;
using f32::ld4;
using f32::st4;

constexpr int THREADS = 256;       // 8 warps of 4 x 8 threads
constexpr int RS = THREADS / 16;   // a thread's 8 x 8 tile: rows ty + RS i
                                   // (ty < RS), columns tx + 16 j (tx < 16)
constexpr int BM = 8 * RS, BN = 128;  // the block's tile of out
constexpr int BK = 32;             // depth of one chunk
constexpr int STAGES = 3;          // x and raw w_q stages: chunks t .. t + 2
constexpr int X_TILE = BM * BK;    // floats of one x stage
constexpr int W_TILE = BN * BK;    // floats of one w_q^T tile
constexpr int W_ROW = BN + 16;     // bytes of a raw w_q row: 8 blocks, or 9
constexpr int W_RAW = BK * W_ROW;  // bytes of one raw w_q stage
// the x stages, two w_q^T tiles, the raw w_q stages: 95744 bytes
constexpr size_t SMEM =
    sizeof(float) * (STAGES * X_TILE + 2 * W_TILE) + STAGES * W_RAW;

// cp.async of BYTES (4, 8 or 16) from src to the shared address dst, or
// zeros where `ok` is false (no global read).
template <int BYTES>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         bool ok) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
                 "l"(src), "n"(BYTES), "r"(ok ? BYTES : 0)
                 : "memory");
}

// Elements [k0, k0 + BK) of x's rows [m0, m0 + BM) into the x tile at xs
// (row r's elements 4c .. 4c + 3 at chunk_at<BK>(r, c)), VEC floats a copy:
// every row of x starts on a 4 VEC-byte boundary and K % VEC == 0, so a
// copy holds elements all inside K or all past it. Rows past M and elements
// past K are zeros. Consecutive threads copy consecutive elements of a row.
template <int VEC>
__device__ __forceinline__ void copy_x(float* xs, const float* x, int M,
                                       int K, int m0, int k0) {
  constexpr int PER_ROW = BK / VEC, ROWS = THREADS / PER_ROW;
  static_assert(ROWS % 8 == 0, "a thread's rows share their swizzle");
  const int col = threadIdx.x % PER_ROW * VEC, r = threadIdx.x / PER_ROW;
  const int k = k0 + col;
  const uint32_t d =
      sm90::smem_u32(xs + chunk_at<BK>(r, col >> 2) + (col & 3));
#pragma unroll
  for (int it = 0; it < BM / ROWS; ++it) {
    const int m = m0 + r + it * ROWS;
    const bool ok = m < M && k < K;
    cp_async<4 * VEC>(d + 4 * it * ROWS * BK, ok ? x + (size_t)m * K + k : x,
                      ok);
  }
}

// Rows [k0, k0 + BK) of w_q, bytes [n0, n0 + BN) of each, into the raw stage
// at wr: row r at W_ROW r, as the aligned 16-byte blocks that cover the row
// (no row needs an aligned start). WA (every row 16-byte aligned): its 8
// blocks, block i at position i ^ (r / 4 % 8), so that convert's 32 lanes
// read 32 distinct banks; else its 9 blocks in order. A block is read only
// where it holds bytes of the row inside N (an aligned block never crosses
// a page), else zeros, and rows past K are zeros. Bytes past N are not
// masked: they reach only columns of out that are not stored.
template <bool WA>
__device__ __forceinline__ void copy_w(uint32_t wr, const int8_t* w, int N,
                                       int K, int n0, int k0) {
  constexpr int WB = WA ? 8 : 9;  // blocks a row
#pragma unroll
  for (int it = 0; it < (BK * WB + THREADS - 1) / THREADS; ++it) {
    const int e = threadIdx.x + it * THREADS;
    if (e >= BK * WB) break;
    const int r = e / WB, i = e % WB;
    const int k = k0 + r;
    const uintptr_t a =
        reinterpret_cast<uintptr_t>(w + (size_t)(k < K ? k : 0) * N + n0);
    const uintptr_t b = (a & ~(uintptr_t)15) + 16 * i;
    const bool ok = k < K && b < a + (N - n0);
    cp_async<16>(wr + r * W_ROW + 16 * (WA ? i ^ ((r >> 2) & 7) : i),
                 ok ? reinterpret_cast<const void*>(b) : w, ok);
  }
}

// The raw stage at wr (chunk k0) into the w_q^T tile at ws: row n holds
// w_q[k0 + k][n0 + n] * scale[n0 + n] for k in [0, BK), elements 4c ..
// 4c + 3 at chunk_at<BK>(n, c) (columns past N hold garbage, never stored).
// Thread p takes rows 4c .. 4c + 3 of K (c = p % 8) and columns 4g .. 4g + 3
// (g = p / 8): one word of each row, 16 conversions, 4 float4 stores; a
// quarter warp stores chunks c = 0..7 of one row, at distinct positions.
template <bool WA>
__device__ __forceinline__ void convert(float* ws, const uint8_t* wr,
                                        const int8_t* w,
                                        const float* __restrict__ scale, int N,
                                        int n0, int k0) {
  static_assert(THREADS == 8 * (BN / 4), "one word of 4 rows a thread");
  const int c = threadIdx.x & 7, g = threadIdx.x >> 3;
  uint32_t word[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const uint8_t* row = wr + (4 * c + e) * W_ROW;
    if constexpr (WA) {
      word[e] = *reinterpret_cast<const uint32_t*>(row + 16 * ((g >> 2) ^ c) +
                                                   4 * (g & 3));
    } else {  // bytes 4g .. 4g + 3 of the row start `off` bytes into it
      const int off = (int)(reinterpret_cast<uintptr_t>(
                                w + (size_t)(k0 + 4 * c + e) * N + n0) & 15);
      const uint32_t* q = reinterpret_cast<const uint32_t*>(row) + (off >> 2) + g;
      word[e] = __funnelshift_r(q[0], q[1], 8 * (off & 3));
    }
    word[e] ^= 0x80808080u;  // each byte v + 128
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int n = n0 + 4 * g + q;
    const float sc = n < N ? __ldg(scale + n) : 0.f;
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)  // 2^23 + 128 + v, less 2^23 + 128
      v[e] = (__uint_as_float(__byte_perm(word[e], 0x4B000000u, 0x7540 | q)) -
              8388736.f) * sc;
    st4(ws + chunk_at<BK>(4 * g + q, c), v);
  }
}

// acc[i][j] += the chunk's x tile row ty + RS i . w_q^T tile row tx + 16 j.
__device__ __forceinline__ void product(float (&acc)[8][8], const float* xs,
                                        const float* ws, int ty, int tx) {
  static_assert(RS % 8 == 0, "rows ty + RS i share ty's swizzle");
  const float* a0 = xs + ty * BK;
  const float* b0 = ws + tx * BK;
#pragma unroll
  for (int c = 0; c < BK / 4; ++c) {
    const int oa = (c ^ (ty & 7)) << 2, ob = (c ^ (tx & 7)) << 2;
    float a[8][4], b[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) ld4(a[i], a0 + RS * i * BK + oa);
#pragma unroll
    for (int j = 0; j < 8; ++j) ld4(b[j], b0 + 16 * j * BK + ob);
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i][e], b[j][e], acc[i][j]);
  }
}

// One BM x BN tile of out (blockIdx.x: the tile, N tiles fastest, so the
// blocks that share x's rows run together) over the chunks [k_tiles *
// blockIdx.y, k_tiles * (blockIdx.y + 1)) of K. partial null: out = the
// sum; else the sum goes to partial[blockIdx.y]. One barrier a chunk: at
// the top of step t, chunk t's w_q^T tile is complete and chunk t + 1's
// copies have landed; step t starts chunk t + 2's copies into stage
// (t + 2) % 3 (chunk t - 1's, free), converts chunk t + 1's raw w_q into
// w_q^T tile (t + 1) % 2 (chunk t - 1's, free), takes chunk t's product,
// waits for its own copies and meets the others at the barrier. A warp's
// 4 x 8 threads read 4 x rows and 8 w_q^T rows a load.
template <int VEC, bool WA>
__global__ void __launch_bounds__(THREADS, 1)
int8_matmul_f32_kernel(const float* __restrict__ x,
                       const int8_t* __restrict__ w,
                       const float* __restrict__ scale,
                       float* __restrict__ out, float* __restrict__ partial,
                       int M, int N, int K, int k_tiles) {
  extern __shared__ float4 smem4[];
  float* const Xs = reinterpret_cast<float*>(smem4);  // STAGES x stages
  float* const Ws = Xs + STAGES * X_TILE;              // two w_q^T tiles
  const uint8_t* const Wr = reinterpret_cast<uint8_t*>(Ws + 2 * W_TILE);
  const uint32_t wr = sm90::smem_u32(Wr);              // STAGES raw stages

  const int n_tiles = (N + BN - 1) / BN;
  const int n0 = (blockIdx.x % n_tiles) * BN;
  const int m0 = (blockIdx.x / n_tiles) * BM;
  const int kt0 = blockIdx.y * k_tiles;
  const int nk = min(k_tiles, (K + BK - 1) / BK - kt0);  // >= 1
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tx = (lane & 7) + 8 * (warp & 1), ty = (lane >> 3) + 4 * (warp >> 1);

  auto load = [&](int t) {
    if (t < nk) {
      copy_x<VEC>(Xs + (t % STAGES) * X_TILE, x, M, K, m0, (kt0 + t) * BK);
      copy_w<WA>(wr + (t % STAGES) * W_RAW, w, N, K, n0, (kt0 + t) * BK);
    }
    sm90::cp_commit();
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  load(0);
  load(1);
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  __syncthreads();  // chunk 0 is in
  convert<WA>(Ws, Wr, w, scale, N, n0, kt0 * BK);
  f32::cp_wait_all();
  __syncthreads();  // chunk 0's w_q^T tile is complete, chunk 1 is in
  for (int t = 0; t < nk; ++t) {
    load(t + 2);
    if (t + 1 < nk)
      convert<WA>(Ws + ((t + 1) & 1) * W_TILE, Wr + ((t + 1) % STAGES) * W_RAW,
                  w, scale, N, n0, (kt0 + t + 1) * BK);
    product(acc, Xs + (t % STAGES) * X_TILE, Ws + (t & 1) * W_TILE, ty, tx);
    f32::cp_wait_all();
    __syncthreads();
  }

  float* const dst = partial ? partial + (size_t)blockIdx.y * M * N : out;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = n0 + tx + 16 * j;
    if (n >= N) continue;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m0 + ty + RS * i;
      if (m < M) dst[(size_t)m * N + n] = acc[i][j];
    }
  }
}

template <int VEC, bool WA>
cudaError_t launch_tile(const void* x, const void* w, const float* scale,
                        void* out, float* partial, int M, int N, int K, Plan p,
                        cudaStream_t stream) {
  const auto kernel = int8_matmul_f32_kernel<VEC, WA>;
  cudaError_t err = sm90::allow_smem(kernel, SMEM);
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  if (tiles > 0x7fffffff || p.splits > 65535) return cudaErrorInvalidValue;
  kernel<<<dim3((unsigned)tiles, p.splits), THREADS, SMEM, stream>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(w), scale,
      static_cast<float*>(out), p.splits > 1 ? partial : nullptr, M, N, K,
      p.k_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return err;
  return launch_split_sum<float>(partial, nullptr, static_cast<float*>(out),
                                 M, N, p.splits, stream);
}

template <int VEC>
cudaError_t launch_vec(bool wa, const void* x, const void* w,
                       const float* scale, void* out, float* partial, int M,
                       int N, int K, Plan p, cudaStream_t stream) {
  return wa ? launch_tile<VEC, true>(x, w, scale, out, partial, M, N, K, p, stream)
            : launch_tile<VEC, false>(x, w, scale, out, partial, M, N, K, p, stream);
}

cudaError_t launch(const void* x, const void* w, const float* scale,
                   void* out, float* partial, int M, int N, int K, Plan p,
                   cudaStream_t stream) {
  if (p.block_n != BN || !plan_ok(p, (K + BK - 1) / BK, partial))
    return cudaErrorInvalidValue;
  const bool wa = rows_aligned(w, N, 1);
  if (reinterpret_cast<uintptr_t>(x) % 8 == 0 && K % 2 == 0)
    return launch_vec<2>(wa, x, w, scale, out, partial, M, N, K, p, stream);
  return launch_vec<1>(wa, x, w, scale, out, partial, M, N, K, p, stream);
}

}  // namespace i8f32

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
  return launch_split_sum(partial, scale, static_cast<bf16*>(out), M, N,
                          p.splits, stream);
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

cudaError_t launch_bf16(const void* x, const void* w, const float* scale,
                        void* out, float* partial, int M, int N, int K, Plan p,
                        cudaStream_t stream) {
  if (!plan_ok(p, (K + I8_BK - 1) / I8_BK, partial)) return cudaErrorInvalidValue;
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
// row-major; x and out share the dtype: 0 = float32 (CUDA cores; the plan's
// block_n 128, K in `splits` runs of k_tiles 32-deep chunks), 1 = bfloat16
// (wgmma; block_n 64, 128 or 256 columns a block, K in `splits` runs of
// k_tiles 64-deep stages); each split non-empty, and with splits > 1,
// partial is an f32 workspace of splits * M * N. Returns a
// cudaError_t; 0 on success. Launches on `stream`, allocates nothing and
// does not synchronise.
int univtg_int8_matmul(const void* x, const void* w, const void* scale,
                       void* out, int dtype, int M, int N, int K, int block_n,
                       int splits, int k_tiles, void* partial, void* stream) {
  const float* s = static_cast<const float*>(scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  const Plan p{block_n, splits, k_tiles};
  float* ws = static_cast<float*>(partial);
  if (dtype == 0) return (int)i8f32::launch(x, w, s, out, ws, M, N, K, p, st);
  if (dtype == 1) return (int)sm90::launch_bf16(x, w, s, out, ws, M, N, K, p, st);
  return (int)cudaErrorInvalidValue;
}

const char* univtg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
