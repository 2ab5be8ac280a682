// Hopper (sm_90a) tensor-core building blocks shared by the bf16 attention
// kernels: flash_fwd.cu (flash_fwd_kernel_sm90), flash_bwd.cu
// (flash_bwd_dq_kernel_sm90, flash_bwd_dkv_kernel_sm90) and
// ring_attention.cu (ring_block_kernel_sm90); int8_matmul.cu
// (int8_matmul_kernel_sm90) takes the swizzled tiles, the descriptors and
// the m64n{64,128,256}k16 products with an MN-major B.
//
// Every attention product is a wgmma m64n64k16 (bf16 in, f32 accumulate)
// issued by one warpgroup: a block is one warpgroup of 128 threads that owns
// 64 resident rows, and two blocks share an SM. Tiles are 64 rows of the head dim padded
// to DH = 64 or 128 (zero-filled), stored as 64-column atoms with the
// 128-byte swizzle that the wgmma descriptors name, and filled by cp.async
// (16 bytes a thread, zero-filled past L and dh, so no tensor map has to be
// encoded on the host per call). The accumulator's layout (frag_row,
// frag_col) is already wgmma's register-A layout, so a bf16 cast of it feeds
// the next product from registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace sm90 {

using bf16 = __nv_bfloat16;
using flash::Dropout;
using flash::Layout;
using flash::NEG_INF;

constexpr int WG_THREADS = 128;  // one warpgroup per block, two blocks per SM
constexpr int TILE_ROWS = 64;    // rows of every tile: the block's resident
                                 // rows and each streamed tile
constexpr int TILE_ATOM = TILE_ROWS * 128;  // bytes of one 64-column atom

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of the 16-byte chunk c (head-dim columns 8c .. 8c + 7) of row r
// in a tile kept as 64-column atoms [64][64] (atom c / 8), each row of an
// atom 128 bytes with the 128-byte swizzle: chunk c % 8 of row r sits at
// position (c % 8) ^ (r % 8). Tiles start 1024-byte aligned.
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (c >> 3) * TILE_ATOM + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// Rows [r0, r0 + 64) of one head into a swizzled tile by cp.async; rows >= L
// and head-dim columns >= dh are zero-filled (no global read).
template <int DH>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src,
                                          long long sl, int r0, int L,
                                          int dh) {
  constexpr int CH = DH / 8;
  static_assert(TILE_ROWS * CH % WG_THREADS == 0, "whole rounds of copies");
#pragma unroll
  for (int it = 0; it < TILE_ROWS * CH / WG_THREADS; ++it) {
    const int e = threadIdx.x + it * WG_THREADS;
    const int r = e / CH, c = e % CH;
    const bool ok = r0 + r < L && c * 8 < dh;
    const bf16* g = ok ? src + (long long)(r0 + r) * sl + c * 8 : src;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     dst + swz(r, c)),
                 "l"(g), "r"(ok ? 16 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait for all but this thread's newest cp.async group, then make the copies
// visible to wgmma (the async proxy); a __syncthreads must follow before
// another warp reads them.
__device__ __forceinline__ void cp_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle; offsets in bytes.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// K-major operand: the tile's 64 rows, head-dim columns [16 ks, 16 ks + 16)
// as the product's depth. 8-row groups are 1024 B apart.
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int ks) {
  return desc(tile + (ks >> 2) * TILE_ATOM + (ks & 3) * 32, 16, 1024);
}

// MN-major operand: rows [16 ks, 16 ks + 16) of the tile as the product's
// depth, head-dim columns [64 n, 64 n + 64) as its N (one atom, so the
// atom-to-atom offset is never used). 8-row groups are 1024 B apart.
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int ks, int n) {
  return desc(tile + n * TILE_ATOM + ks * 2048, 1024, 1024);
}

// MN-major operand over consecutive 64-column atoms of a tile: rows
// [16 ks, 16 ks + 16) as the product's depth, columns [0, 64 * atoms) as its
// N, atom to atom TILE_ATOM bytes apart.
__device__ __forceinline__ uint64_t desc_mn_atoms(uint32_t tile, int ks) {
  return desc(tile + ks * 2048, TILE_ATOM, 1024);
}

#define UNIVTG_D32(d)                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),           \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),       \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),       \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),       \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31])
#define UNIVTG_R32                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31}"

// d (64 x 64, f32) += A . B^T, A and B K-major in shared memory.
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t a,
                                       uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " UNIVTG_R32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : UNIVTG_D32(d)
      : "l"(a), "l"(b), "r"(1));
}

// d (64 x 64, f32) += A . B, A from registers (a0..a3, the m64k16 bf16
// fragment), B MN-major in shared memory.
__device__ __forceinline__ void mma_rs(float (&d)[32], uint32_t a0,
                                       uint32_t a1, uint32_t a2, uint32_t a3,
                                       uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " UNIVTG_R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : UNIVTG_D32(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

// d (64 x 64 NA, f32; d[a] holds columns [64 a, 64 a + 64)) += A . B, A
// K-major and B MN-major, both in shared memory (desc_k, desc_mn_atoms).
template <int NA>
__device__ __forceinline__ void mma_ss_mn(float (&d)[NA][32], uint64_t a,
                                          uint64_t b) {
  static_assert(NA == 1 || NA == 2 || NA == 4,
                "m64n64k16, m64n128k16 or m64n256k16");
  if constexpr (NA == 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " UNIVTG_R32
        ", %32, %33, p, 1, 1, 0, 1;\n}\n"
        : UNIVTG_D32(d[0])
        : "l"(a), "l"(b), "r"(1));
  } else if constexpr (NA == 2) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
        ", %64, %65, p, 1, 1, 0, 1;\n}\n"
        : UNIVTG_D32(d[0]), UNIVTG_D32(d[1])
        : "l"(a), "l"(b), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
        "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
        "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
        "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
        "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
        "%127}"
        ", %128, %129, p, 1, 1, 0, 1;\n}\n"
        : UNIVTG_D32(d[0]), UNIVTG_D32(d[1]), UNIVTG_D32(d[2]), UNIVTG_D32(d[3])
        : "l"(a), "l"(b), "r"(1));
  }
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait for all but this warpgroup's newest committed product group.
__device__ __forceinline__ void wg_wait_prev() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// Wait for every committed product of this warpgroup; d is read only after
// (the empty asm keeps the compiler from moving its reads above the wait).
template <int N>
__device__ __forceinline__ void wg_wait(float (&d)[N][32]) {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[n][i])::"memory");
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N][32]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) d[n][i] = 0.f;
}

// Two f32 to one bf16 pair, round to nearest even (the twin's .to(bfloat16));
// lo is the lower column.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The two f32 values of a pack_bf16 pair: the lower column, the upper one.
__device__ __forceinline__ float bf16_lo(uint32_t pair) {
  return __uint_as_float(pair << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t pair) {
  return __uint_as_float(pair & 0xFFFF0000u);
}

// Accumulator element i (0..31) of an m64n64 product sits, for this thread,
// at row frag_row(i) of the tile and column frag_col(i). Pairs (2 j, 2 j + 1)
// packed in order are wgmma's register-A fragment of the same rows, depth
// columns [16 (j / 4), 16 (j / 4) + 16). A thread holds two rows,
// frag_row(0) (elements with (i >> 1) & 1 == 0) and frag_row(2), 16 columns
// of each; the 64 columns of a row sit on the 4 threads of a quad.
__device__ __forceinline__ int frag_row(int i) {
  return 16 * (threadIdx.x >> 5) + ((threadIdx.x & 31) >> 2) +
         8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int frag_col(int i) {
  return 8 * (i >> 2) + 2 * (threadIdx.x & 3) + (i & 1);
}

// Max and sum over the 4 threads of a quad, which hold one accumulator row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The additive key mask of key j: (1 - mask) * -1e30, 0 past Lk.
__device__ __forceinline__ float key_bias(const float* mp, int j, int Lk) {
  return j < Lk ? (1.f - mp[j]) * NEG_INF : 0.f;
}

// One key tile of an online softmax on the score fragment S of 64 rows and
// the 64 keys [k0, k0 + 64): s = S * scale + bias (bt: the tile's key_bias),
// keys past Lk excluded (s = -inf, p = 0: they never enter the max, the sum
// or the product). The rows' running max m and sum l move on (l takes p as
// it is, before any dropout); s becomes p = exp(s - m_new), alpha =
// exp(m_old - m_new), 0 on a row's first tile. Every tile holds key k0 < Lk,
// so m_new is finite.
__device__ __forceinline__ void online_softmax(float (&s)[32], const float* bt,
                                               int k0, int Lk, float scale,
                                               float (&m)[2], float (&l)[2],
                                               float (&alpha)[2]) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int col = frag_col(i);
    s[i] = k0 + col < Lk ? s[i] * scale + bt[col] : -INFINITY;
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  }
  float m_new[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    m_new[j] = fmaxf(m[j], quad_max(mx[j]));
    alpha[j] = expf(m[j] - m_new[j]);
    m[j] = m_new[j];
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    s[i] = expf(s[i] - m_new[(i >> 1) & 1]);
    rs[(i >> 1) & 1] += s[i];
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) l[j] = l[j] * alpha[j] + quad_sum(rs[j]);
}

template <int DH>
__host__ __device__ constexpr size_t tile_bytes() {
  return TILE_ROWS * DH * 2;
}

// Raise a kernel's dynamic shared memory past the 48 KB default.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// The bf16 kernels copy 16 bytes at a time: every operand 16-byte aligned,
// every stride a multiple of 8 elements.
inline bool misaligned(const void* const* ptrs, int n, Layout ql, Layout kl) {
  for (int i = 0; i < n; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16) return true;
  return (ql.sb | ql.sh | ql.sl | kl.sb | kl.sh | kl.sl) % 8 != 0;
}

// The bf16 kernels take each 64-row tile's dropout hash input from one
// block of the dropout grid, so its blocks must be multiples of 64 (the
// reference's, dropout_grid, are multiples of 128).
inline bool bad_bf16_grid(const Dropout& d) {
  return d.seed && (d.bq % 64 != 0 || d.bk % 64 != 0);
}

}  // namespace sm90
