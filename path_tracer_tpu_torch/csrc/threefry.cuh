// Threefry-2x32 (20 rounds), bit-exact with jax.random under
// jax_threefry_partitionable=True — the device copy of utils/rng.py.
//   fold_in(k, d)     = threefry(k, (0, d))                 (both words)
//   uniform(k, ...)[j] = float(threefry(k, (0, j)).x0 ^ .x1)
// Replaces the per-lane vmapped draws of path_tracer_tpu/ops/shade_tiled.py
// wave_rng (:701) and spawn_rng (:730).
#pragma once

#include "common.cuh"

struct Key {
  uint32_t k0, k1;
};

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int d) {
  return (x << d) | (x >> (32 - d));
}

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl32(x1, rot[i & 1][j]);
      x1 ^= x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
}

__device__ __forceinline__ Key fold_in(Key k, uint32_t d) {
  uint32_t x0 = 0u, x1 = d;
  threefry2x32(k.k0, k.k1, x0, x1);
  return Key{x0, x1};
}

// Element j of jax.random.uniform(k, shape) (flat index j, shape < 2^32).
__device__ __forceinline__ float uniform_at(Key k, uint32_t j) {
  uint32_t x0 = 0u, x1 = j;
  threefry2x32(k.k0, k.k1, x0, x1);
  const uint32_t bits = x0 ^ x1;
  const uint32_t fb = (bits >> 9) | 0x3F800000u;
  return bits_as_float(fb) - 1.0f;
}
