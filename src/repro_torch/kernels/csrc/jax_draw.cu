// One leaf's jax.random draw in one launch, for sm_90a:
//
//     out[r, e] = cast( op( value( bits(key_r, start + counter(e)) ) ) )
//
// Not a Pallas kernel: it replaces the jax.random.normal / uniform calls of
// the reference (src/repro/models/common.py:69-76, the weights;
// src/repro/samplers/transforms.py, the unfused noise; src/repro/core/
// potentials.py, the paper's problems and minibatches), which XLA runs on
// the TPU.  The plain version is src/repro_torch/kernels/rng.py's
// host-style path (threefry on int32 tensors, then XLA's erf_inv / log1p /
// log emulated in float64 torch ops, in slices of 4 M elements: about 130
// launches a slice).  The device functions are in jax_random.cuh.
//
// - value: uniform(minval, maxval), normal or gumbel (a template argument).
// - op: none, a float32 multiply c * v (std * normal: dense_init,
//   embed_init; the noise's scale * z) or a float32 division v / c
//   (normal / sqrt(K): the reference's conv_w and head matrices), each
//   rounded once.
// - cast: float32, bfloat16 or float16, rounded to nearest even, as XLA's
//   convert rounds (a template argument).
//
// Two modes, one kernel.  Row r (blockIdx.y) draws under its own key: the
// key (k0, k1) passed by value when keys is null (one row), else row r of
// a (R, 2) uint32 table on the device (a key a row: jax.vmap of a draw over
// keys, the layer-stacked and chain-stacked leaves of init_params).  Every
// row draws the same block of the same whole draw: element e of a row (its
// block in row-major order) sits at the counter start + sum_d (i_d +
// first_d) * stride_d of the whole shape, its flat index there, so a block
// of a leaf (a placed leaf's rank block) is bit for bit the whole draw's.
// The host merges the dimensions that the block takes whole into their
// outer neighbour, so a whole draw, or a block of leading rows, is one
// dimension here, and its counters are start + first + e without any
// division.
//
// Counters are 64-bit: past 2^32 they carry into threefry's high word, as
// JAX's do.
//
// What bounds it on an H100: integer and float32 operations, not bytes.  A
// normal costs one threefry2x32 (72 32-bit operations) and about 63 more
// for the counter, the uniform, log1p, log and erf_inv (chip_smoke.py's
// NORMAL_OPS), against 2 to 4 bytes written.
// A simple design: a grid-stride loop over groups of kPer consecutive
// elements a thread (independent threefry chains for the schedulers), a
// vector store of the group when the row is aligned, no shared memory.
//
// C interface (bound with ctypes): the launcher returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "jax_random.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 4;  // consecutive elements a thread a step
constexpr int kMaxDims = 6;
constexpr int kMaxBlocks = 132 * 16;

struct Geometry {
  int ndim;                                  // 1 .. kMaxDims, after merging
  unsigned long long len[kMaxDims];          // the block's lengths
  unsigned long long first[kMaxDims];        // its first index a dimension
  unsigned long long stride[kMaxDims];       // the whole shape's strides
  unsigned long long start;                  // the draw's first counter
};

enum Op { kNone = 0, kMul = 1, kDiv = 2 };

// The stored type of a dtype (0 float32, 1 bfloat16, 2 float16), its
// kPer-element vector, and the cast.
template <int kDtype>
struct Out;
template <>
struct Out<0> {
  using S = float;
  using Vec = float4;
  static __device__ __forceinline__ S cast(float v) { return v; }
};
template <>
struct Out<1> {
  using S = uint16_t;
  using Vec = uint2;
  static __device__ __forceinline__ S cast(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};
template <>
struct Out<2> {
  using S = uint16_t;
  using Vec = uint2;
  static __device__ __forceinline__ S cast(float v) { return __half_as_ushort(__float2half_rn(v)); }
};

// The counter of block element e, and how many elements after it follow at
// consecutive counters (within the innermost dimension).
__device__ __forceinline__ unsigned long long counter_of(const Geometry& g, unsigned long long e,
                                                        unsigned long long& run) {
  const int last = g.ndim - 1;
  if (last == 0) {
    run = g.len[0] - e;
    return g.start + g.first[0] + e;
  }
  const unsigned long long inner = e % g.len[last];
  unsigned long long q = e / g.len[last];
  unsigned long long c = g.start + g.first[last] + inner;
  for (int d = last - 1; d >= 0; --d) {
    const unsigned long long i = q % g.len[d];
    q /= g.len[d];
    c += (i + g.first[d]) * g.stride[d];
  }
  run = g.len[last] - inner;
  return c;
}

template <int kValue, int kDtype>
__device__ __forceinline__ typename Out<kDtype>::S draw_one(uint32_t k0, uint32_t k1,
                                                            unsigned long long c, float lo,
                                                            float span, int op, float k) {
  float v = jr::value<kValue>(jr::bits_at(k0, k1, c), lo, span);
  if (op == kMul) {
    v = __fmul_rn(k, v);
  } else if (op == kDiv) {
    v = __fdiv_rn(v, k);
  }
  return Out<kDtype>::cast(v);
}

template <int kValue, int kDtype>
__global__ void __launch_bounds__(kThreads)
    jax_draw_kernel(typename Out<kDtype>::S* __restrict__ out, unsigned long long n,
                    const uint32_t* __restrict__ keys, uint32_t k0, uint32_t k1, Geometry g,
                    float lo, float span, int op, float k,
                    int vec) {
  const unsigned long long r = blockIdx.y;
  if (keys != nullptr) {
    k0 = keys[2 * r];
    k1 = keys[2 * r + 1];
  }
  using S = typename Out<kDtype>::S;
  S* o = out + r * n;
  const unsigned long long groups = (n + kPer - 1) / kPer;
  const unsigned long long stride = (unsigned long long)gridDim.x * kThreads;
  for (unsigned long long grp = (unsigned long long)blockIdx.x * kThreads + threadIdx.x;
       grp < groups; grp += stride) {
    const unsigned long long e0 = grp * kPer;
    unsigned long long run;
    unsigned long long c = counter_of(g, e0, run);
    union {
      typename Out<kDtype>::Vec v;
      S e[kPer];
    } lanes;
#pragma unroll
    for (int l = 0; l < kPer; ++l) {
      if (e0 + l < n) {
        if (l > 0) {
          if (--run == 0) {
            c = counter_of(g, e0 + l, run);  // the next row of the block
          } else {
            ++c;
          }
        }
        lanes.e[l] = draw_one<kValue, kDtype>(k0, k1, c, lo, span, op, k);
      }
    }
    if (vec && e0 + kPer <= n) {
      *reinterpret_cast<typename Out<kDtype>::Vec*>(o + e0) = lanes.v;
    } else {
#pragma unroll
      for (int l = 0; l < kPer; ++l)
        if (e0 + l < n) o[e0 + l] = lanes.e[l];
    }
  }
}

template <int kValue, int kDtype>
void launch(void* out, unsigned long long n, int rows, const uint32_t* keys, uint32_t k0,
            uint32_t k1, const Geometry& g, float lo, float span, int op, float k,
            cudaStream_t stream) {
  const unsigned long long groups = (n + kPer - 1) / kPer;
  unsigned long long bx = (groups + kThreads - 1) / kThreads;
  const unsigned long long cap = (kMaxBlocks + rows - 1) / rows;
  if (bx > cap) bx = cap;
  // a row is whole vectors when n is a multiple of kPer and the base is
  // aligned to a vector (row offsets r * n keep that)
  const int vec = n % kPer == 0 &&
                  reinterpret_cast<uintptr_t>(out) % sizeof(typename Out<kDtype>::Vec) == 0;
  jax_draw_kernel<kValue, kDtype><<<dim3((unsigned)bx, (unsigned)rows), kThreads, 0, stream>>>(
      static_cast<typename Out<kDtype>::S*>(out), n, keys, k0, k1, g, lo, span, op, k, vec);
}

template <int kValue>
int launch_typed(int dtype, void* out, unsigned long long n, int rows, const uint32_t* keys,
                 uint32_t k0, uint32_t k1, const Geometry& g, float lo, float span, int op,
                 float k, cudaStream_t stream) {
  if (dtype == 0) {
    launch<kValue, 0>(out, n, rows, keys, k0, k1, g, lo, span, op, k, stream);
  } else if (dtype == 1) {
    launch<kValue, 1>(out, n, rows, keys, k0, k1, g, lo, span, op, k, stream);
  } else if (dtype == 2) {
    launch<kValue, 2>(out, n, rows, keys, k0, k1, g, lo, span, op, k, stream);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

}  // namespace

// out: (rows, n) of dtype (0 float32, 1 bfloat16, 2 float16); keys: (rows,
// 2) uint32 on the device, or null for one row under (k0, k1); geom: ndim,
// then ndim (length, first, stride) triples, then start, as 64-bit words;
// value: 0 uniform, 1 normal, 2 gumbel (lo, span: the uniform's float32
// minval and maxval - minval); op: 0 none, 1 c * v, 2 v / c.
extern "C" int jax_draw_launch(void* out, unsigned long long n, int rows, const void* keys,
                               unsigned k0, unsigned k1, const unsigned long long* geom,
                               int value, int op, float c, float lo, float span, int dtype,
                               void* stream) {
  Geometry g{};
  g.ndim = (int)geom[0];
  if (n < 1 || rows < 1 || rows > 65535 || g.ndim < 1 || g.ndim > kMaxDims)
    return cudaErrorInvalidValue;
  for (int d = 0; d < g.ndim; ++d) {
    g.len[d] = geom[1 + 3 * d];
    g.first[d] = geom[2 + 3 * d];
    g.stride[d] = geom[3 + 3 * d];
  }
  g.start = geom[1 + 3 * g.ndim];
  const uint32_t* kt = static_cast<const uint32_t*>(keys);
  cudaStream_t s = (cudaStream_t)stream;
  int err;
  if (value == jr::kUniform) {
    err = launch_typed<jr::kUniform>(dtype, out, n, rows, kt, k0, k1, g, lo, span, op, c, s);
  } else if (value == jr::kNormal) {
    err = launch_typed<jr::kNormal>(dtype, out, n, rows, kt, k0, k1, g, lo, span, op, c, s);
  } else if (value == jr::kGumbel) {
    err = launch_typed<jr::kGumbel>(dtype, out, n, rows, kt, k0, k1, g, lo, span, op, c, s);
  } else {
    return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
