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
// set the pace.  The design keeps the instructions an element near that
// count: a thread takes a 16-byte vector of x and of g a step (8 bfloat16
// or 4 float32 elements), so one load of each and one store serve 8 (or
// 4) elements and the 8 threefry chains are independent work for the
// schedulers (ILP); indices are 32-bit (n <= 2^32; each element's counter
// is still its flat index, so the noise is the same as one element a
// thread).  The vector path runs when x and g start on 16 bytes; a ragged
// tail of fewer than 8 elements, or a leaf that does not start on 16
// bytes, takes the scalar code (one element a thread, the same
// arithmetic).  No shared memory; 256 threads a block.
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

// An element's raw bits (float, or bfloat16 as uint16_t) and their
// conversions to and from float32: a bfloat16 is the top half of a float.
template <typename T>
struct Elem;
template <>
struct Elem<float> {
  using Raw = float;
  static __device__ __forceinline__ float to_f(float r) { return r; }
  static __device__ __forceinline__ float from_f(float x) { return x; }
};
template <>
struct Elem<__nv_bfloat16> {
  using Raw = uint16_t;
  static __device__ __forceinline__ float to_f(uint16_t r) {
    return __uint_as_float((uint32_t)r << 16);
  }
  static __device__ __forceinline__ uint16_t from_f(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
};

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

// x <- fmaf(scale, xi, fmaf(-gamma, g, x)) for the element of counter c
template <typename T>
__device__ __forceinline__ typename Elem<T>::Raw update(typename Elem<T>::Raw x,
                                                        typename Elem<T>::Raw g, uint32_t c,
                                                        uint32_t s0, uint32_t s1,
                                                        float gamma, float scale) {
  const float xi = normal(s0, s1, c);
  return Elem<T>::from_f(fmaf(scale, xi, fmaf(-gamma, Elem<T>::to_f(g), Elem<T>::to_f(x))));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    langevin_update_kernel(typename Elem<T>::Raw* __restrict__ x,
                           const typename Elem<T>::Raw* __restrict__ g, unsigned long long n,
                           uint32_t s0, uint32_t s1, float gamma, float scale, int vec) {
  using Raw = typename Elem<T>::Raw;
  constexpr int V = 16 / sizeof(Raw);  // lanes of a 16-byte vector
  const uint32_t tid = blockIdx.x * kThreads + threadIdx.x;
  const uint32_t stride = gridDim.x * kThreads;
  uint32_t done = 0;  // elements the vector loop covers
  if (vec) {
    union Lanes {
      uint4 v;
      Raw e[V];
    };
    const uint32_t nv = (uint32_t)(n / V);
    for (uint32_t v = tid; v < nv; v += stride) {
      Lanes xv, gv;
      xv.v = reinterpret_cast<const uint4*>(x)[v];
      gv.v = reinterpret_cast<const uint4*>(g)[v];
      const uint32_t base = v * V;
#pragma unroll
      for (int l = 0; l < V; ++l)
        xv.e[l] = update<T>(xv.e[l], gv.e[l], base + l, s0, s1, gamma, scale);
      reinterpret_cast<uint4*>(x)[v] = xv.v;
    }
    const uint32_t tail = (uint32_t)(n - (unsigned long long)nv * V);  // < V
    if (tid >= tail) return;
    done = (uint32_t)((unsigned long long)nv * V);  // < 2^32 when tail > 0
  }
  const uint32_t last = (uint32_t)(n - 1);
  for (uint32_t i = done + tid; i <= last; i += stride) {
    x[i] = update<T>(x[i], g[i], i, s0, s1, gamma, scale);
    if (last - i < stride) break;  // i + stride would pass last (or wrap)
  }
}

template <typename T>
void launch(void* x, const void* g, unsigned long long n, uint32_t s0, uint32_t s1,
            float gamma, float scale, cudaStream_t stream) {
  using Raw = typename Elem<T>::Raw;
  constexpr int V = 16 / sizeof(Raw);
  const int vec = ((uintptr_t)x & 15u) == 0 && ((uintptr_t)g & 15u) == 0;
  const unsigned long long work = vec ? n / V + 1 : n;
  const unsigned long long want = (work + kThreads - 1) / kThreads;
  const int blocks = (int)(want < kMaxBlocks ? want : kMaxBlocks);
  langevin_update_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<Raw*>(x), static_cast<const Raw*>(g), n, s0, s1, gamma, scale, vec);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  n >= 1, n <= 2^32 (the counter).
extern "C" int langevin_update_launch(void* x, const void* g, unsigned long long n,
                                      unsigned s0, unsigned s1, float gamma, float scale,
                                      int dtype, void* stream) {
  if (n < 1 || n > (1ULL << 32)) return cudaErrorInvalidValue;
  if (dtype == 0) {
    launch<float>(x, g, n, s0, s1, gamma, scale, (cudaStream_t)stream);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(x, g, n, s0, s1, gamma, scale, (cudaStream_t)stream);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
