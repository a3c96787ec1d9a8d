// threefry2x32, 20 rounds, with JAX's rotation and key schedule (the same
// function as src/repro_torch/kernels/rng.py::threefry2x32 and
// src/repro/kernels/rng.py::threefry2x32), in native uint32.
//
// Included by langevin_update.cu (the Box-Muller noise of the fused SGLD
// commit) and randint.cuh (jax.random.randint's bit streams for the
// per-coordinate delays).  A rotate by a constant is one funnel shift
// (SHF.L.W) on sm_90.

#pragma once

#include <stdint.h>

__device__ __forceinline__ uint32_t tf_rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

#define TF_ROUND(r)      \
  x0 += x1;              \
  x1 = tf_rotl(x1, (r)); \
  x1 ^= x0;

// (x0, x1) <- threefry2x32((k0, k1), (x0, x1))
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t& x0,
                                             uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k1;
  x1 += k2 + 1u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k2;
  x1 += k0 + 2u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k0;
  x1 += k1 + 3u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k1;
  x1 += k2 + 4u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k2;
  x1 += k0 + 5u;
}

#undef TF_ROUND
