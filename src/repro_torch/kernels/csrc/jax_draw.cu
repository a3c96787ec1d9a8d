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
//   rounded once (a template argument: a division, or a product with c,
//   1 for none, which is exact).
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
// dimension here.
//
// The layout (kernels/jax_draw.py's plan mirrors it, and a CPU test checks
// that it covers every element once).  A row's unit of work is a group of
// kPer elements of one line of the block's innermost dimension (L elements
// at consecutive counters): a line has G = ceil(L / kPer) groups, the last
// one ragged when kPer does not divide L, and a row O x G, O the product
// of the outer dimensions' lengths.  Consecutive threads take consecutive
// groups (a grid-stride loop), so a warp writes 32 x kPer consecutive
// elements of a line, as 16-byte vectors when the row is aligned.  A group
// g sits in line o = g / G and its counter is base + (g - o G) kPer + sum_d
// i_d stride_d over the outer dimensions' indices i_d of o: 32-bit
// multiply-high divisions by magic numbers the host computes (two
// instructions each; one a group, plus one a dimension past the second),
// where the parent kernel ran a 64-bit software division and remainder for
// every dimension of every group of 4.  A whole draw is one dimension: g
// is the counter, no division.

// The counter width is a template argument: when every counter of the
// block lies below 2^32 (the launcher checks the last one), counters, offsets and the loop are 32-bit and threefry's high word
// is a constant 0; past it they are 64-bit, and carry into the high word
// as JAX's do.
//
// What bounds it on an H100: instruction issue and the integer pipe, not
// bytes.  A normal costs one threefry2x32 (20 rounds of add, rotate, xor
// and the key schedule's adds: about 70 integer instructions), the
// uniform, XLA's log1p (both sides: in nearly every warp some lanes take
// the rational's, |u| < 0.644, and some the log's, so jax_random.cuh
// computes both and selects, with no branch), erf_inv (its w >= 5 tail,
// a third of a percent of the elements, behind a branch) and the cast:
// about 184 instructions an element, 94 of them integer, in the SASS,
// against 2 to 4 bytes written.  A warp-wide compaction of log1p's two
// sides (ballot, a scan, shared memory there and back) would save one
// side's ~25 instructions an element at ~17 of its own, most of them on
// the integer pipe that already binds: it is not done.  kPer = 8 (4 ran
// slower: more index work an element); 32 registers, so 2,048 threads an
// SM.
//
// C interface (bound with ctypes): the launcher returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "jax_random.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 8;  // consecutive elements a group (a thread's, each pass)
constexpr int kMaxDims = 6;

enum Op { kNone = 0, kMul = 1, kDiv = 2 };

// n / d for n, d < 2^31: (n * m) >> (32 + shift), m = ceil(2^(31 + ceil(log2
// d)) / d) < 2^32 (d = 1: m = 0, the quotient is n)
struct Magic {
  uint32_t m, shift;
};

__host__ Magic magic_of(uint32_t d) {
  Magic g{0u, 0u};
  if (d > 1) {
    int l = 0;
    while ((1ull << l) < d) ++l;
    g.m = (uint32_t)(((1ull << (31 + l)) + d - 1) / d);
    g.shift = (uint32_t)(l - 1);
  }
  return g;
}

__device__ __forceinline__ uint32_t div_by(uint32_t n, const Magic& g) {
  return g.m == 0u ? n : __umulhi(n, g.m) >> g.shift;
}

// The block's outer dimensions (all but the innermost, outermost first)
// and its groups: I is the counter and offset type.
template <typename I>
struct Plan {
  int outer;              // outer dimensions, 0 .. kMaxDims - 1
  I len[kMaxDims - 1];    // their lengths
  I stride[kMaxDims - 1]; // their strides in the whole shape
  Magic by_len[kMaxDims - 1];
  I L;                    // the innermost dimension's length (a line)
  I G;                    // groups a line, ceil(L / kPer)
  Magic by_G;
  I base;                 // start + sum_d first_d * stride_d (the first counter)
  I groups;               // groups a row, G x the outer lengths' product
  I n;                    // a row's elements
};

// The stored type of a dtype (0 float32, 1 bfloat16, 2 float16) and the
// cast.
template <int kDtype>
struct Out;
template <>
struct Out<0> {
  using S = float;
  static __device__ __forceinline__ S cast(float v) { return v; }
};
template <>
struct Out<1> {
  using S = uint16_t;
  static __device__ __forceinline__ S cast(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};
template <>
struct Out<2> {
  using S = uint16_t;
  static __device__ __forceinline__ S cast(float v) { return __half_as_ushort(__float2half_rn(v)); }
};

template <typename I>
__device__ __forceinline__ uint32_t bits_at(uint32_t k0, uint32_t k1, I c) {
  uint32_t x0 = sizeof(I) == 8 ? (uint32_t)((unsigned long long)c >> 32) : 0u;
  uint32_t x1 = (uint32_t)c;
  threefry2x32(k0, k1, x0, x1);
  return x0 ^ x1;
}

// the op as a template argument: a division by k, else a product with k
// (1 for no op: exact)
template <int kValue, bool kDivide, int kDtype, typename I>
__device__ __forceinline__ typename Out<kDtype>::S draw_one(uint32_t k0, uint32_t k1, I c,
                                                            float lo, float span, float k) {
  const float v = jr::value<kValue>(bits_at<I>(k0, k1, c), lo, span);
  return Out<kDtype>::cast(kDivide ? __fdiv_rn(v, k) : __fmul_rn(k, v));
}

// a group's kPer stored values as vectors: float32 as 16-byte vectors,
// bfloat16 and float16 packed two a word (8 values: one 16-byte vector)
static_assert(kPer == 4 || kPer == 8, "store_vec packs 4 or 8 values");
__device__ __forceinline__ void store_vec(float* dst, const float (&v)[kPer]) {
#pragma unroll
  for (int q = 0; q < kPer / 4; ++q)
    reinterpret_cast<float4*>(dst)[q] =
        make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
}
__device__ __forceinline__ void store_vec(uint16_t* dst, const uint16_t (&v)[kPer]) {
  uint32_t w[kPer / 2];
#pragma unroll
  for (int i = 0; i < kPer / 2; ++i) w[i] = (uint32_t)v[2 * i] | (uint32_t)v[2 * i + 1] << 16;
  if constexpr (kPer == 8) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
  }
}

// n / d: by the magic numbers in the 32-bit path, a division in the 64-bit
// one
template <typename I>
__device__ __forceinline__ I quotient(I n, I d, const Magic& g) {
  if constexpr (sizeof(I) == 4) {
    return div_by(n, g);
  } else {
    return n / d;
  }
}

template <int kValue, bool kDivide, int kDtype, typename I>
__global__ void __launch_bounds__(kThreads)
    jax_draw_kernel(typename Out<kDtype>::S* __restrict__ out,
                    const uint32_t* __restrict__ keys, uint32_t k0, uint32_t k1,
                    const Plan<I> p, float lo, float span, float k, int vec) {
  using S = typename Out<kDtype>::S;
  const unsigned r = blockIdx.y;
  if (keys != nullptr) {
    k0 = keys[2 * r];
    k1 = keys[2 * r + 1];
  }
  S* row = out + (unsigned long long)r * (unsigned long long)p.n;
  const I step = (I)gridDim.x * kThreads;
  for (I g = (I)blockIdx.x * kThreads + threadIdx.x; g < p.groups; g += step) {
    // the group's line o, its first element in the line and its counter
    I o = 0, inner = g * kPer;
    I c = p.base;
    if (p.outer > 0) {
      o = quotient<I>(g, p.G, p.by_G);
      inner = (g - o * p.G) * kPer;
      // the outer dimensions, innermost first (constant indices: the plan
      // stays in the parameter space, where a runtime index would select
      // among all its words)
      I q = o;
#pragma unroll
      for (int d = kMaxDims - 2; d > 0; --d) {
        if (d < p.outer) {
          const I up = quotient<I>(q, p.len[d], p.by_len[d]);
          c += (q - up * p.len[d]) * p.stride[d];
          q = up;
        }
      }
      c += q * p.stride[0];
    }
    c += inner;
    S* dst = row + (o * p.L + inner);
    if (inner + kPer <= p.L) {
      S v[kPer];
#pragma unroll
      for (int l = 0; l < kPer; ++l)
        v[l] = draw_one<kValue, kDivide, kDtype, I>(k0, k1, c + (I)l, lo, span, k);
      if (vec) {
        store_vec(dst, v);
      } else {
#pragma unroll
        for (int l = 0; l < kPer; ++l) dst[l] = v[l];
      }
    } else {
      // the last group of a ragged line, one element at a time (a loop: as
      // a call it cost the full groups' loop 4%)
#pragma unroll 1
      for (int l = 0; inner + (I)l < p.L; ++l)
        dst[l] = draw_one<kValue, kDivide, kDtype, I>(k0, k1, c + (I)l, lo, span, k);
    }
  }
}

template <typename I>
bool make_plan(const unsigned long long* geom, Plan<I>& p) {
  const int ndim = (int)geom[0];
  if (ndim < 1 || ndim > kMaxDims) return false;
  unsigned long long base = geom[1 + 3 * ndim], n = 1;
  p.outer = ndim - 1;
  for (int d = 0; d < ndim; ++d) {
    const unsigned long long len = geom[1 + 3 * d], first = geom[2 + 3 * d],
                             stride = geom[3 + 3 * d];
    if (len < 1) return false;
    base += first * stride;
    n *= len;
    if (d < ndim - 1) {
      p.len[d] = (I)len;
      p.stride[d] = (I)stride;
      p.by_len[d] = magic_of(sizeof(I) == 4 ? (uint32_t)len : 1u);
    } else {
      if (stride != 1) return false;  // a line's counters are consecutive
      p.L = (I)len;
    }
  }
  const unsigned long long G = (geom[1 + 3 * (ndim - 1)] + kPer - 1) / kPer;
  const unsigned long long groups = G * (n / geom[1 + 3 * (ndim - 1)]);
  // the 32-bit path's magic numbers hold below 2^31
  if (sizeof(I) == 4 && groups >= (1ull << 31)) return false;
  p.G = (I)G;
  p.by_G = magic_of(sizeof(I) == 4 ? (uint32_t)G : 1u);
  p.base = (I)base;
  p.groups = (I)groups;
  p.n = (I)n;
  return true;
}

template <int kValue, bool kDivide, int kDtype, typename I>
int launch(void* out, int rows, const uint32_t* keys, uint32_t k0, uint32_t k1,
           const unsigned long long* geom, float lo, float span, float k, int vec,
           cudaStream_t stream) {
  Plan<I> p{};
  if (!make_plan<I>(geom, p)) return cudaErrorInvalidValue;
  // one wave: as many blocks as the card holds at once (each loops), over
  // the rows
  static int wave = 0;
  if (wave == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, jax_draw_kernel<kValue, kDivide, kDtype, I>, kThreads, 0);
    wave = sms * (per_sm > 0 ? per_sm : 1);
  }
  unsigned long long bx = ((unsigned long long)p.groups + kThreads - 1) / kThreads;
  const unsigned long long cap = (wave + rows - 1) / rows;
  if (bx > cap) bx = cap;
  jax_draw_kernel<kValue, kDivide, kDtype, I>
      <<<dim3((unsigned)bx, (unsigned)rows), kThreads, 0, stream>>>(
          static_cast<typename Out<kDtype>::S*>(out), keys, k0, k1, p, lo, span, k, vec);
  return cudaSuccess;
}

// The template arguments from the call's: value, op (a division, or a
// product with c, 1 for none), dtype, then the counters' width.
struct Call {
  void* out;
  int rows;
  const uint32_t* keys;
  uint32_t k0, k1;
  const unsigned long long* geom;
  float lo, span, k;
  int vec;
  cudaStream_t stream;
};

template <int kValue, bool kDivide, typename I>
int by_dtype(int dtype, const Call& a) {
  if (dtype == 0)
    return launch<kValue, kDivide, 0, I>(a.out, a.rows, a.keys, a.k0, a.k1, a.geom, a.lo,
                                         a.span, a.k, a.vec, a.stream);
  if (dtype == 1)
    return launch<kValue, kDivide, 1, I>(a.out, a.rows, a.keys, a.k0, a.k1, a.geom, a.lo,
                                         a.span, a.k, a.vec, a.stream);
  if (dtype == 2)
    return launch<kValue, kDivide, 2, I>(a.out, a.rows, a.keys, a.k0, a.k1, a.geom, a.lo,
                                         a.span, a.k, a.vec, a.stream);
  return cudaErrorInvalidValue;
}

template <int kValue, typename I>
int by_op(bool divide, int dtype, const Call& a) {
  return divide ? by_dtype<kValue, true, I>(dtype, a) : by_dtype<kValue, false, I>(dtype, a);
}

template <typename I>
int by_value(int value, bool divide, int dtype, const Call& a) {
  if (value == jr::kUniform) return by_op<jr::kUniform, I>(divide, dtype, a);
  if (value == jr::kNormal) return by_op<jr::kNormal, I>(divide, dtype, a);
  if (value == jr::kGumbel) return by_op<jr::kGumbel, I>(divide, dtype, a);
  return cudaErrorInvalidValue;
}

}  // namespace

// The threads a block and the elements a group: kernels/jax_draw.py's plan
// checks its own against them.
extern "C" void jax_draw_shape(int* threads, int* per) {
  *threads = kThreads;
  *per = kPer;
}

// out: (rows, n) of dtype (0 float32, 1 bfloat16, 2 float16), n the
// block's elements; keys: (rows, 2) uint32 on the device, or null for one
// row under (k0, k1); geom: ndim, then ndim (length, first, stride)
// triples (the innermost's stride 1), then start, as 64-bit words (the
// counters are 32-bit when the block's last one is below 2^32); value: 0 uniform, 1 normal, 2 gumbel (lo, span: the uniform's
// float32 minval and maxval - minval); op: 0 none, 1 c * v, 2 v / c; vec:
// whether a row's full groups may store 16-byte vectors (the host checks
// the alignment).
extern "C" int jax_draw_launch(void* out, int rows, const void* keys, unsigned k0, unsigned k1,
                               const unsigned long long* geom, int value, int op,
                               float c, float lo, float span, int dtype, int vec,
                               void* stream) {
  const int ndim = (int)geom[0];
  if (rows < 1 || rows > 65535 || ndim < 1 || ndim > kMaxDims) return cudaErrorInvalidValue;
  unsigned long long last = geom[1 + 3 * ndim];  // the block's last counter
  for (int d = 0; d < ndim; ++d) last += (geom[2 + 3 * d] + geom[1 + 3 * d] - 1) * geom[3 + 3 * d];
  const bool wide = last >= (1ull << 32);
  if (op < kNone || op > kDiv) return cudaErrorInvalidValue;
  const Call a{out, rows, static_cast<const uint32_t*>(keys), k0, k1, geom, lo, span,
               op == kNone ? 1.0f : c, vec, (cudaStream_t)stream};
  const int err = wide ? by_value<unsigned long long>(value, op == kDiv, dtype, a)
                       : by_value<uint32_t>(value, op == kDiv, dtype, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
