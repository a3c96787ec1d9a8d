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
// schedulers (ILP); indices within a row are 32-bit (n <= 2^32; each
// element's counter is still its index, so the noise is the same as one
// element a thread).  No shared memory; 256 threads a block.
//
// The chain axis.  x and g are (C, n), one row a chain (C = 1 for a single
// chain), and a device table holds C rows (s0, s1, gamma, scale) that the
// host builds once a commit for every leaf (one copy for all of them), so
// one launch a leaf serves every chain.  Block row blockIdx.y is chain c;
// the counter is the element's index within its own row, so chain c's
// bits do not depend on C.  A row starts at c * n elements, which is off
// 16 bytes whenever n * sizeof(T) is not a multiple of 16, so each row
// peels the elements before its first 16-byte boundary (scalar code, one
// element a thread, the same arithmetic), runs the vector code, and ends
// on a scalar tail; a row whose x and g are off 16 bytes by different
// amounts is all scalar.  Row offsets are 64-bit: C * n passes 2^32 at
// full width.
//
// Masked commits.  A row's fifth word is a skip flag: a chain whose commit
// is lost, or which is quarantined, is neither read nor written (its blocks
// return before the loop), so its iterate stays bitwise whatever its
// gradient row holds, NaN included.  With a non-null flags array (C,) int32
// the kernel also reports, per chain, whether any element it wrote is NaN
// or Inf: each thread ORs a test of its stored values into a register, the
// block reduces it with __syncthreads_or, and one thread of a block that
// saw one writes flags[c] = 1 (a benign race between blocks: they all
// write 1).  The caller zeroes flags once for a commit and passes it to
// every leaf's launch.  The test is a template argument, so the launch
// without flags (the fault-free path) runs the loop without it.
//
// C interface (bound with ctypes): each launcher returns cudaGetLastError().

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

// One row of the chain table: chain c's seed, gamma, scale and skip flag.
struct ChainParams {
  uint32_t s0, s1;
  float gamma, scale;
  uint32_t skip;
};

// NaN or Inf: every exponent bit set (bfloat16 shares float's exponent)
__device__ __forceinline__ bool nonfinite(float v) {
  return (__float_as_uint(v) & 0x7F800000u) == 0x7F800000u;
}
__device__ __forceinline__ bool nonfinite(uint16_t r) { return (r & 0x7F80u) == 0x7F80u; }

template <typename T, bool kFlag>
__global__ void __launch_bounds__(kThreads)
    langevin_update_kernel(typename Elem<T>::Raw* __restrict__ x,
                           const typename Elem<T>::Raw* __restrict__ g, unsigned long long n,
                           const ChainParams* __restrict__ table, int* __restrict__ flags) {
  using Raw = typename Elem<T>::Raw;
  constexpr int V = 16 / sizeof(Raw);
  const ChainParams p = table[blockIdx.y];
  if (p.skip) return;  // the whole block: no thread reaches a barrier
  bool bad = false;
  Raw* __restrict__ xr = x + (unsigned long long)blockIdx.y * n;
  const Raw* __restrict__ gr = g + (unsigned long long)blockIdx.y * n;
  // elements before the row's first 16-byte boundary; all of them when x
  // and g sit at different offsets from it
  const uint32_t ax = (uint32_t)((uintptr_t)xr & 15u), ag = (uint32_t)((uintptr_t)gr & 15u);
  unsigned long long peel = ax == ag ? ((16u - ax) & 15u) / sizeof(Raw) : n;
  if (peel > n) peel = n;
  const unsigned long long nv = (n - peel) / V;
  const uint32_t tid = blockIdx.x * kThreads + threadIdx.x;
  const uint32_t stride = gridDim.x * kThreads;
  union Lanes {
    uint4 v;
    Raw e[V];
  };
  const uint4* xv4 = reinterpret_cast<const uint4*>(xr + peel);
  const uint4* gv4 = reinterpret_cast<const uint4*>(gr + peel);
  for (uint32_t v = tid; v < nv; v += stride) {
    Lanes xv, gv;
    xv.v = xv4[v];
    gv.v = gv4[v];
    const uint32_t base = (uint32_t)(peel + (unsigned long long)v * V);
#pragma unroll
    for (int l = 0; l < V; ++l) {
      xv.e[l] = update<T>(xv.e[l], gv.e[l], base + l, p.s0, p.s1, p.gamma, p.scale);
      if constexpr (kFlag) bad |= nonfinite(xv.e[l]);
    }
    reinterpret_cast<uint4*>(xr + peel)[v] = xv.v;
  }
  // the scalar elements: the peel, then the tail after the vectors
  const unsigned long long nscalar = n - nv * V;
  for (unsigned long long j = tid; j < nscalar; j += stride) {
    const unsigned long long i = j < peel ? j : j + nv * V;
    const Raw r = update<T>(xr[i], gr[i], (uint32_t)i, p.s0, p.s1, p.gamma, p.scale);
    xr[i] = r;
    if constexpr (kFlag) bad |= nonfinite(r);
  }
  if constexpr (kFlag) {
    if (__syncthreads_or(bad) && threadIdx.x == 0) flags[blockIdx.y] = 1;
  }
}

template <typename T>
void launch(void* x, const void* g, unsigned long long n, int chains, const void* table,
            int* flags, cudaStream_t stream) {
  using Raw = typename Elem<T>::Raw;
  constexpr int V = 16 / sizeof(Raw);
  const unsigned long long work = n / V + V;  // vectors, and the peel and tail
  const unsigned long long want = (work + kThreads - 1) / kThreads;
  const unsigned long long cap = kMaxBlocks / chains > 0 ? kMaxBlocks / chains : 1;
  const dim3 grid((unsigned)(want < cap ? want : cap), (unsigned)chains);
  if (flags) {
    langevin_update_kernel<T, true><<<grid, kThreads, 0, stream>>>(
        static_cast<Raw*>(x), static_cast<const Raw*>(g), n,
        static_cast<const ChainParams*>(table), flags);
  } else {
    langevin_update_kernel<T, false><<<grid, kThreads, 0, stream>>>(
        static_cast<Raw*>(x), static_cast<const Raw*>(g), n,
        static_cast<const ChainParams*>(table), nullptr);
  }
}

}  // namespace

// x, g (chains, n), one chain a row; table (chains, 5) 32-bit words on the
// device: s0, s1, gamma and scale as float bits, and skip (nonzero: leave
// the row alone).  flags: null, or (chains,) int32 on the device, set to 1
// for a chain any of whose written elements is NaN or Inf.  dtype:
// 0 = float32, 1 = bfloat16.  1 <= n <= 2^32, 1 <= chains <= 65535.
extern "C" int langevin_update_launch(void* x, const void* g, unsigned long long n,
                                      int chains, const void* table, void* flags, int dtype,
                                      void* stream) {
  if (n < 1 || n > (1ULL << 32) || chains < 1 || chains > 65535)
    return cudaErrorInvalidValue;
  int* f = static_cast<int*>(flags);
  if (dtype == 0) {
    launch<float>(x, g, n, chains, table, f, (cudaStream_t)stream);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(x, g, n, chains, table, f, (cudaStream_t)stream);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
