// Helpers shared by the attention kernels (flash_fwd.cu, flash_bwd.cu,
// ring_attention.cu).
//
// The attention-dropout keep mask is the JAX package's, bit for bit:
// univtg_tpu/ops/pallas_attention.py:_dropout_keep hashes
// (seed, bh, q-tile, k-tile, row-in-tile, col-in-tile) with a Murmur3-style
// finalizer in uint32 arithmetic. Its tiles are the reference's blocks
// (bq, bk) = (_auto_block(Lq), _auto_block(Lk)), which the wrapper passes in as
// the "dropout grid", so keep(bh, i, j) does not depend on the CUDA tiling:
//   qb = i / bq, row = i % bq, kb = j / bk, col = j % bk.
// unsigned int wraps modulo 2^32 exactly as jnp.uint32 does.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace flash {

constexpr float NEG_INF = -1e30f;  // the finite mask constant of the spec

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

// Element strides of one operand: batch, head, row. The head dim is dense.
struct Layout {
  long long sb, sh, sl;
};

// Attention dropout: off when seed is null. thresh = min(rate * 2^32,
// 2^32 - 1) and scale = 1 / (1 - rate) in f32, both computed by the wrapper
// as the reference computes them; (bq, bk) is the reference's dropout grid.
// heads and head_off place a launch over some of a layer's heads (a tensor-
// parallel rank's): the hash takes the global (batch * heads + head_off + h)
// row; heads = 0 hashes the launch's own bh.
struct Dropout {
  const int* seed;
  unsigned int thresh;
  float scale;
  int bq, bk;
  int heads, head_off;
};

// The seed mixed with the (batch*head) index of launch row bh of H heads:
// the part of the hash that is constant over one block's (bh).
__device__ __forceinline__ unsigned int dropout_seed_bh(const Dropout& d,
                                                        int bh, int H) {
  if (d.heads > 0) {
    const int b = bh / H;
    bh = b * d.heads + d.head_off + (bh - b * H);
  }
  return static_cast<unsigned int>(d.seed[0]) ^
         (static_cast<unsigned int>(bh) * 0x9E3779B1u);
}

// The hash's input for query row i and key j of this (bh), before the
// finalizer. Inside one (bq, bk) block of the grid it is linear:
// x(i, j + c) = x(i, j) + c and x(i + r, j) = x(i, j) + 65599 r, so a kernel
// whose tile lies in one block computes it once per row and tile.
__device__ __forceinline__ unsigned int dropout_hash_input(
    const Dropout& d, unsigned int seed_bh, int i, int j) {
  const unsigned int qb = static_cast<unsigned int>(i / d.bq);
  const unsigned int kb = static_cast<unsigned int>(j / d.bk);
  const unsigned int row = static_cast<unsigned int>(i) - qb * d.bq;
  const unsigned int col = static_cast<unsigned int>(j) - kb * d.bk;
  const unsigned int s = seed_bh ^ (qb * 0x85EBCA6Bu) ^ (kb * 0xC2B2AE35u);
  return row * 65599u + col + s * 2654435761u;
}

// 0 or 1/(1-rate) from a hash input.
__device__ __forceinline__ float dropout_keep(const Dropout& d,
                                              unsigned int x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x >= d.thresh ? d.scale : 0.f;
}

// 0 or 1/(1-rate) for query row i and key j of this (bh).
__device__ __forceinline__ float dropout_multiplier(const Dropout& d,
                                                    unsigned int seed_bh,
                                                    int i, int j) {
  return dropout_keep(d, dropout_hash_input(d, seed_bh, i, j));
}

}  // namespace flash
