// jax.random's float32 draws on sm_90a, operation for operation as the
// plain path src/repro_torch/kernels/rng.py computes them on the CPU, and
// as XLA computes them there (jax.random.uniform, normal and gumbel under
// jax_threefry_partitionable, the default since JAX 0.5).
//
// Included by jax_draw.cu (one leaf's draw) and categorical.cu (the Gumbel
// argmax of jax.random.categorical), so the two cannot drift apart.
//
// The bits of element c of a draw under key (k0, k1):
//
//     (x0, x1) = threefry2x32((k0, k1), (c >> 32, c & 0xFFFFFFFF)),  x0 ^ x1
//
// with c the element's 64-bit flat counter (rng._bits32_at).
//
// Rounding.  Every step is spelled out so that nvcc contracts nothing: the
// multiply-adds XLA fuses on the CPU are fmaf (rng._fma, rng._fma_chain),
// every other product, sum and difference is __fmul_rn / __fadd_rn /
// __fsub_rn, the division of log1p's rational is IEEE __fdiv_rn, and the
// square root is the correctly rounded __fsqrt_rn.  Build without
// -use_fast_math, and keep denormals (no -ftz).  Constants are the float32
// roundings of the plain path's Python floats (rng._f32): torch compares a
// float32 tensor with a Python float in float32.
//
// One difference by construction: the plain path takes each fused
// multiply-add in float64 and rounds to float32 (a product of two float32
// values is exact there, the sum is rounded twice), where fmaf rounds once,
// as XLA's contracted multiply-add does.  The two differ only when the
// float64 sum lands exactly on a float32 halfway point (about 2^-29 of the
// multiply-adds whose exact sum needs more than 53 bits).

#pragma once

#include <stdint.h>

#include "threefry.cuh"

namespace jr {

// x0 ^ x1 of threefry2x32(key, (c >> 32, c & 0xFFFFFFFF))
__device__ __forceinline__ uint32_t bits_at(uint32_t k0, uint32_t k1, unsigned long long c) {
  uint32_t x0 = (uint32_t)(c >> 32), x1 = (uint32_t)c;
  threefry2x32(k0, k1, x0, x1);
  return x0 ^ x1;
}

// rng._uniform_values: 23 mantissa bits under exponent 0, minus 1, then
// max(fma(u, span, lo), lo); lo = float32(minval), span = float32(maxval) -
// lo, both rounded on the host as numpy rounds them
__device__ __forceinline__ float uniform(uint32_t bits, float lo, float span) {
  const float u = __fsub_rn(__uint_as_float(((bits >> 9) & 0x7FFFFFu) | 0x3F800000u), 1.0f);
  const float v = fmaf(u, span, lo);
  return v < lo ? lo : v;  // torch.clamp_min (no NaN can reach it)
}

// rng._xla_log: Cephes' logf as XLA expands it, for x > 0
__device__ __forceinline__ float xla_log(float x) {
  const float kMinNormal = 1.17549435e-38f;
  x = x < kMinNormal ? kMinNormal : x;
  const int bits = __float_as_int(x);
  float e = __fadd_rn((float)((bits >> 23) - 0x7F), 1.0f);
  float m = __int_as_float((bits & ~0x7F800000) | 0x3F000000);  // [0.5, 1)
  const bool small = m < 0.707106781186547524f;
  e = __fsub_rn(e, small ? 1.0f : 0.0f);
  m = __fadd_rn(__fsub_rn(m, 1.0f), small ? m : 0.0f);
  const float x2 = __fmul_rn(m, m);
  const float x3 = __fmul_rn(x2, m);
  float y = fmaf(fmaf(7.0376836292e-2f, m, -1.1514610310e-1f), m, 1.1676998740e-1f);
  const float y1 = fmaf(fmaf(-1.2420140846e-1f, m, 1.4249322787e-1f), m, -1.6668057665e-1f);
  const float y2 = fmaf(fmaf(2.0000714765e-1f, m, -2.4999993993e-1f), m, 3.3333331174e-1f);
  y = fmaf(y, x3, y1);
  y = fmaf(y, x3, y2);
  y = fmaf(y, x3, __fmul_rn(e, -2.12194440e-4f));
  m = __fsub_rn(m, __fmul_rn(0.5f, x2));
  return __fadd_rn(__fadd_rn(m, y), __fmul_rn(e, 0.693359375f));
}

// rng._xla_log1p: Cephes' rational below sqrt(2) - 1 in magnitude, log(1 +
// x) above.  Both sides are computed and one is selected: in a normal draw
// nearly every warp has lanes on both sides (the rational's for |u| <
// 0.644, 64% of them), so a branch would run both anyway and add its own
// instructions.
__device__ __forceinline__ float xla_log1p(float x) {
  const float far = xla_log(__fadd_rn(x, 1.0f));
  float near;
  {
    const float x2 = __fmul_rn(x, x);
    float num = 4.5270000862445199635215e-5f;
    num = fmaf(num, x, 4.9854102823193375972212e-1f);
    num = fmaf(num, x, 6.5787325942061044846969e0f);
    num = fmaf(num, x, 2.9911919328553073277375e1f);
    num = fmaf(num, x, 6.0949667980987787057556e1f);
    num = fmaf(num, x, 5.7112963590585538103336e1f);
    num = fmaf(num, x, 2.0039553499201281259648e1f);
    float den = 1.0f;
    den = fmaf(den, x, 1.5062909083469192043167e1f);
    den = fmaf(den, x, 8.3047565967967209469434e1f);
    den = fmaf(den, x, 2.2176239823732856465394e2f);
    den = fmaf(den, x, 3.0909872225312059774938e2f);
    den = fmaf(den, x, 2.1642788614495947685003e2f);
    den = fmaf(den, x, 6.0118660497603843919306e1f);
    const float r = __fdiv_rn(num, den);
    near = __fadd_rn(x, __fadd_rn(__fmul_rn(-0.5f, x2), __fmul_rn(__fmul_rn(x, x2), r)));
  }
  return fabsf(x) < 0.41421356237309504880f ? near : far;
}

// Giles' polynomial for w >= 5 (|x| > 0.9966: a third of a percent of a
// normal draw's elements).  Not inlined, so the compiler keeps it behind a
// branch that most warps skip, where it would otherwise compute it for
// every element and select.
__device__ __noinline__ float erf_inv_tail(float w) {
  w = __fsub_rn(__fsqrt_rn(w), 3.0f);
  float p = -0.000200214257f;
  p = fmaf(p, w, 0.000100950558f);
  p = fmaf(p, w, 0.00134934322f);
  p = fmaf(p, w, -0.00367342844f);
  p = fmaf(p, w, 0.00573950773f);
  p = fmaf(p, w, -0.0076224613f);
  p = fmaf(p, w, 0.00943887047f);
  p = fmaf(p, w, 1.00167406f);
  return fmaf(p, w, 2.83297682f);
}

// rng._xla_erf_inv: Giles' single-precision erfinv in w = -log1p(-x^2),
// split at w = 5, for x in (-1, 1); +-1 map to +-max float
__device__ __forceinline__ float xla_erf_inv(float x) {
  const float w = -xla_log1p(-__fmul_rn(x, x));
  float p;
  if (w < 5.0f) {
    const float v = __fsub_rn(w, 2.5f);
    p = 2.81022636e-08f;
    p = fmaf(p, v, 3.43273939e-07f);
    p = fmaf(p, v, -3.5233877e-06f);
    p = fmaf(p, v, -4.39150654e-06f);
    p = fmaf(p, v, 0.00021858087f);
    p = fmaf(p, v, -0.00125372503f);
    p = fmaf(p, v, -0.00417768164f);
    p = fmaf(p, v, 0.246640727f);
    p = fmaf(p, v, 1.50140941f);
  } else {
    p = erf_inv_tail(w);
  }
  // +-1 (u at either end): x times max float; one product either way
  return __fmul_rn(fabsf(x) == 1.0f ? 3.40282347e+38f : p, x);
}

// The three values of a draw, from an element's bits.
enum Value { kUniform = 0, kNormal = 1, kGumbel = 2 };

// float32(nextafter(-1, 0)) and float32(1) - it: jax.random.normal's interval
constexpr float kNormalLo = -0.99999994f;
constexpr float kNormalSpan = 2.0f;
// float32 tiny and float32(1) - tiny: jax.random.gumbel's [tiny, 1)
constexpr float kTiny = 1.17549435e-38f;
constexpr float kGumbelSpan = 1.0f;

// rng.jax_normal's value: sqrt(2) * erf_inv(u), u uniform in (nextafter(-1,
// 0), 1)
__device__ __forceinline__ float normal(uint32_t bits) {
  return __fmul_rn(1.41421354f, xla_erf_inv(uniform(bits, kNormalLo, kNormalSpan)));
}

// rng._gumbel_values: -log(-log(u)), u uniform in [tiny, 1)
__device__ __forceinline__ float gumbel(uint32_t bits) {
  return -xla_log(-xla_log(uniform(bits, kTiny, kGumbelSpan)));
}

template <int kValue>
__device__ __forceinline__ float value(uint32_t bits, float lo, float span) {
  if constexpr (kValue == kUniform) {
    return uniform(bits, lo, span);
  } else if constexpr (kValue == kNormal) {
    return normal(bits);
  } else {
    return gumbel(bits);
  }
}

}  // namespace jr
