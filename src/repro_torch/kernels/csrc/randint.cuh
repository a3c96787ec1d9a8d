// jax.random.randint(key, (n,), 0, span, int32), element by element, as
// src/repro/core/delay.py (sample_coordinate_delays) draws the W-Icon
// delays under jax_threefry_partitionable: two 32-bit streams,
// threefry2x32(k_hi, (i >> 32, i)) and threefry2x32(k_lo, (i >> 32, i))
// with (k_hi, k_lo) = split(key), each folded x0 ^ x1, reduced mod span and
// recombined with mult = 2^32 mod span.  The counter is the element's
// 64-bit flat index, split into a high and a low word, as JAX splits it.  The host computes the subkeys,
// span, mult and the remainder constant (rng.randint_params).
//
// Included by delay_gather.cu, whose two kernels that draw delays (the
// standalone coordinate_delays_kernel and the one-pass W-Icon read) both
// call randint_at, so the two draws cannot drift apart.

#pragma once

#include <stdint.h>

#include "threefry.cuh"

struct RandintKey {
  uint32_t hk0, hk1;         // subkey of the high bit stream
  uint32_t lk0, lk1;         // subkey of the low bit stream
  uint32_t span, mult;       // maxval (1 <= span < 2^16); 2^32 mod span
  unsigned long long magic;  // floor((2^64 - 1) / span) + 1, mod 2^64
};

// x mod d for every uint32 x and 1 <= d < 2^32, by two multiplications
// (Lemire, Kaser and Kurz, "Faster remainder by direct computation", 2019):
// the low 64 bits of magic * x are the fraction x / d in 0.64 fixed point,
// and their product with d, shifted down 64 bits, is the remainder.  A
// divisor fixed for the launch costs no division an element.
__device__ __forceinline__ uint32_t fastmod_u32(uint32_t x, unsigned long long magic,
                                                uint32_t d) {
  const unsigned long long frac = magic * x;
  return (uint32_t)__umul64hi(frac, (unsigned long long)d);
}

// The high word of counter i: 0 for a 32-bit index (a row of at most 2^32
// elements), so that path computes no shift and no extra register.
template <typename I>
__device__ __forceinline__ uint32_t counter_hi(I i) {
  if constexpr (sizeof(I) > 4) {
    return (uint32_t)((unsigned long long)i >> 32);
  } else {
    return 0u;
  }
}

// Element i of the draw: an int32 in [0, span).  Where mult = 0 (span a
// power of two, or 1) the high stream drops out of the sum, and a caller
// takes kBoth = false: the same bits at half the work.  The choice is a
// template argument, made once a launch, so that a loop over elements has
// no branch between their threefry blocks to stop the compiler from
// interleaving them.  I, the index type, is uint32_t for rows of at most
// 2^32 elements and unsigned long long past that, also chosen once a launch.
template <bool kBoth, typename I>
__device__ __forceinline__ uint32_t randint_at(const RandintKey& k, I i) {
  uint32_t l0 = counter_hi(i), l1 = (uint32_t)i;
  threefry2x32(k.lk0, k.lk1, l0, l1);
  const uint32_t lo = fastmod_u32(l0 ^ l1, k.magic, k.span);
  if constexpr (!kBoth) {
    return lo;
  } else {
    uint32_t h0 = counter_hi(i), h1 = (uint32_t)i;
    threefry2x32(k.hk0, k.hk1, h0, h1);
    const uint32_t hi = fastmod_u32(h0 ^ h1, k.magic, k.span);
    // hi * mult + lo < span^2 < 2^32: no overflow
    return fastmod_u32(hi * k.mult + lo, k.magic, k.span);
  }
}
