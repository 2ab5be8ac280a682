// Int8 weight-only dequant-matmul for Hopper (sm_90a), f32 and bf16 inputs.
//
// Replaces univtg_tpu/ops/pallas_int8.py:_kernel (launched by int8_matmul):
//
//   out = (x.f32 @ (w_q.f32 * scale.f32)).astype(x.dtype)
//
// x is (M, K) in f32 or bf16, w_q is (K, N) int8, scale is (N,) f32, one per
// output column (the serving tier quantizes per output channel,
// serve/quantize.py). Each weight is dequantized to f32 as w * scale[n]
// before its product, as the reference multiplies, the sum runs in f32, and
// the result is rounded to x's dtype once, at the store.
//
// Bound on the card: at serving batches (M = 128) the bytes, and of those the
// int8 weight (K * N) dominates, which is the whole point of storing it in
// int8; from M ~ 4096 up the operations (2 * M * K * N). So the kernel reads
// each weight byte once per 64-row tile of x and never writes a dequantized
// copy of the weight to device memory.
//
// Design (simple and right first): one block of 256 threads per 64 x 64
// output tile; a loop over K in chunks of 32, each chunk of x and of w_q
// staged through shared memory as f32 (the int8 weight converted and scaled
// as it is staged); each thread owns a 4 x 4 patch of outputs, rows
// ty + 16 i and columns tx + 16 j, and accumulates it with scalar FMAs on
// the CUDA cores. Ragged edges (K = 2818 is no multiple of any tile) are
// masked in the kernel: elements past M, N or K stage as zeros and are never
// stored, so the wrapper pads nothing. What it leaves on the table: tensor
// cores (dequantize to bf16 in shared memory, then wgmma), TMA or cp.async
// double buffering of the next chunk, and 16-byte loads. Those belong to the
// PR that makes it fast.
//
// Built by univtg_tpu_torch/ops/cuda_build.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and called through ctypes by univtg_tpu_torch/ops/int8_matmul.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_M = 64;   // output rows per block
constexpr int BLOCK_N = 64;   // output columns per block
constexpr int BLOCK_K = 32;   // depth of one staged chunk
constexpr int THREADS = 256;  // 16 x 16 threads, a 4 x 4 patch each
constexpr int PATCH = 4;
constexpr int LDX = BLOCK_M + 1;  // x chunk stored k-major, padded

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
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

extern "C" {

// x (M, K), w (K, N) int8, scale (N,) f32 and out (M, N), all dense and
// row-major; x and out share the dtype: 0 = float32, 1 = bfloat16.
// Returns a cudaError_t; 0 on success. Launches on `stream`, allocates
// nothing and does not synchronise.
int univtg_int8_matmul(const void* x, const void* w, const void* scale,
                       void* out, int dtype, int M, int N, int K,
                       void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || (M + BLOCK_M - 1) / BLOCK_M > 65535)
    return (int)cudaErrorInvalidValue;
  const float* s = static_cast<const float*>(scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch<float>(x, w, s, out, M, N, K, st);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(x, w, s, out, M, N, K, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

const char* univtg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
