// The fused SGLD commit  x <- x - gamma*g + scale*xi,  in place, for sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/langevin_update.py
// (langevin_update_2d, body _kernel).  xi is a standard normal made inside
// the kernel from the element's flat index i (the counter) under a (2,)
// uint32 seed: threefry2x32(seed, (i, i ^ 0x9E3779B9)) gives two 32-bit
// words, their top 24 bits two uniforms in (0, 1), and Box-Muller one
// normal, sqrt(-2 log u1) * cos(2*pi * u2) (src/repro/kernels/rng.py).
// Because the counter is the flat index, the noise of an element does not
// depend on the launch shape, the chain axis, or padding.
//
// Unlike the TPU path (ops.py casts each leaf to float32, pads it to
// 256 x 1024 tiles, updates and casts back), the kernel reads each leaf in
// its own type (bfloat16 or float32), computes in float32 and writes the
// leaf's type in place: one read of x and g, one write of x, no copies.
// A bounds check takes the place of the padding.
//
// Numerics.  No fast math: logf, cosf and sqrtf are CUDA's precise
// versions.  The update is written as fmaf(scale, xi, fmaf(-gamma, g, x)):
// that is how the JAX reference evaluates x - gamma*g + scale*xi on the CPU
// (XLA contracts both products into fused multiply-adds), and spelling the
// fmas out fixes the rounding instead of leaving it to nvcc's contraction.
// The uniform and Box-Muller products use __fmul_rn/__fadd_rn so that none
// of them is contracted.
//
// What bounds it on an H100: operations, not bytes.  A bfloat16 element
// moves 6 bytes (read x and g, write x) but costs one threefry2x32 (about
// 80 32-bit integer operations) plus a log, a cos and a sqrt, so at
// 4.4e9 elements a commit the integer pipes, not the 3.35 TB/s of memory,
// set the pace.  The design keeps to that: one element per thread per
// iteration of a grid-stride loop, no shared memory, 256 threads a block
// and enough blocks to fill every SM with warps whose integer work hides
// each other's memory latency.
//
// C interface (bound with ctypes): the launcher returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // 16 blocks of 8 warps per SM
constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr float kTwoPi = (float)(2.0 * 3.14159265358979);

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// top 24 bits -> (0, 1): k * 2^-24 + 2^-25
__device__ __forceinline__ float uniform(uint32_t bits) {
  return __fadd_rn(__fmul_rn((float)(bits >> 8), 5.9604644775390625e-08f),
                   2.98023223876953125e-08f);
}

__device__ __forceinline__ float normal(uint32_t s0, uint32_t s1, uint32_t c) {
  uint32_t b0 = c, b1 = c ^ kGolden;
  threefry2x32(s0, s1, b0, b1);
  const float r = sqrtf(__fmul_rn(-2.0f, logf(uniform(b0))));
  return __fmul_rn(r, cosf(__fmul_rn(kTwoPi, uniform(b1))));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    langevin_update_kernel(T* __restrict__ x, const T* __restrict__ g, long long n,
                           uint32_t s0, uint32_t s1, float gamma, float scale) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) {
    const float xi = normal(s0, s1, (uint32_t)i);
    const float t = fmaf(-gamma, to_f(g[i]), to_f(x[i]));
    store_f(x + i, fmaf(scale, xi, t));
  }
}

template <typename T>
void launch(void* x, const void* g, long long n, uint32_t s0, uint32_t s1, float gamma,
            float scale, cudaStream_t stream) {
  const long long want = (n + kThreads - 1) / kThreads;
  const int blocks = (int)(want < kMaxBlocks ? want : kMaxBlocks);
  langevin_update_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<T*>(x), static_cast<const T*>(g), n, s0, s1, gamma, scale);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  n >= 1, n <= 2^32 (the counter).
extern "C" int langevin_update_launch(void* x, const void* g, long long n, unsigned s0,
                                      unsigned s1, float gamma, float scale, int dtype,
                                      void* stream) {
  if (n < 1 || n > (1LL << 32)) return cudaErrorInvalidValue;
  if (dtype == 0) {
    launch<float>(x, g, n, s0, s1, gamma, scale, (cudaStream_t)stream);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(x, g, n, s0, s1, gamma, scale, (cudaStream_t)stream);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
