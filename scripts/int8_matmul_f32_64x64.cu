// The earlier f32 int8 dequant-matmul, kept as a variant source for
// scripts/bench_int8_matmul.py --dtype float32 --variant NAME=this file, so
// that the kernel of csrc/int8_matmul.cu can be timed against it in turns.
// Nothing else builds or calls it.
//
//   out = x.f32 @ (w_q.f32 * scale.f32), x (M, K) f32, w_q (K, N) int8,
//   scale (N,) f32, out (M, N) f32
//
// One block of 256 threads per 64 x 64 output tile; a loop over K in chunks
// of 32, each chunk of x and of w_q staged through shared memory as f32 with
// plain loads (the int8 weight read a byte a thread, converted and scaled as
// it is staged, w * scale[n] as the reference multiplies), then a barrier,
// then the arithmetic: no copy is in flight under it. Each thread owns a
// 4 x 4 patch of outputs, rows ty + 16 i and columns tx + 16 j, and
// accumulates it with scalar FMAs fed by scalar shared loads (8 per 16 FMA).
// Ragged edges are masked in the kernel.
//
// The entry point is csrc/int8_matmul.cu's; it takes dtype 0 (f32) only and
// ignores the plan (no split of K: every block sums all of K).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_M = 64;   // output rows per block
constexpr int BLOCK_N = 64;   // output columns per block
constexpr int BLOCK_K = 32;   // depth of one staged chunk
constexpr int THREADS = 256;  // 16 x 16 threads, a 4 x 4 patch each
constexpr int PATCH = 4;
constexpr int LDX = BLOCK_M + 1;  // x chunk stored k-major, padded

__global__ void __launch_bounds__(THREADS)
int8_matmul_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ scale, float* __restrict__ out,
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
      Xs[c * LDX + r] = (m < M && k < K) ? x[(size_t)m * K + k] : 0.f;
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
      if (n < N) out[(size_t)m * N + n] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

int univtg_int8_matmul(const void* x, const void* w, const void* scale,
                       void* out, int dtype, int M, int N, int K, int block_n,
                       int splits, int k_tiles, void* partial, void* stream) {
  (void)block_n, (void)splits, (void)k_tiles, (void)partial;
  if (dtype != 0 || M <= 0 || N <= 0 || K <= 0 ||
      (M + BLOCK_M - 1) / BLOCK_M > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BLOCK_N - 1) / BLOCK_N, (M + BLOCK_M - 1) / BLOCK_M);
  int8_matmul_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<float*>(out), M, N, K);
  return (int)cudaGetLastError();
}

const char* univtg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
