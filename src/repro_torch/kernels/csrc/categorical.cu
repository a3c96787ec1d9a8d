// jax.random.categorical's draw in one launch, for sm_90a:
//
//     tokens[r] = argmax_v( float32(logp[r, v]) + gumbel(bits(key_r, base_r + v)) )
//
// Not a Pallas kernel: it replaces the reference's jax.random.categorical
// (src/repro/cluster/decode.py:178, src/repro/cluster/paged.py:236,267: the
// sampled tokens), which XLA runs on the TPU.  The plain version is
// src/repro_torch/kernels/rng.py's categorical / categorical_rows (a
// host-style Gumbel draw, about 200 small launches at (4, 151,936), then
// torch.argmax).  The Gumbel values are jax_random.cuh's, the same device
// functions as jax_draw.cu's.
//
// Two modes.  One key (keys null, (k0, k1) by value): row r takes the
// counters [r V, (r + 1) V), since JAX's counters are the flat index of the
// (B, V) draw.  A key a row ((B, 2) uint32 keys on the device:
// jax.vmap(categorical) over keys): row r at [0, V) under keys[r].  The
// counters are 32-bit when the launch's last one is below 2^32 (a template
// argument), else 64-bit.
//
// The argmax is torch.argmax's, which is also jnp.argmax's: the first
// maximal index, NaN above every number (the first NaN wins), -0.0 equal
// to 0.0; a row of -inf gives index 0.  logp is read in its own dtype
// (float32, bfloat16 or float16) and converted exactly.
//
// The layout (kernels/categorical.py's plan mirrors it, and a CPU test
// checks that it covers every column once).  Each row is cut into spans
// of kSpan = kThreads x kCols columns, one block a span (blockIdx.x the
// span, blockIdx.y the row), so a (4, 151,936) draw is 596 blocks of 128
// threads: one wave on 132 SMs.  A thread takes kCols consecutive columns
// (independent threefry chains), read as 16-byte vectors: a row's first
// `peel` columns, up to its first 16-byte boundary, are taken one each by
// block 0's first threads, and the vectors start after them; a ragged end
// is read one column at a time.
//
// The combine, in one pass.  A candidate is one ordered 64-bit key: the
// float's bits mapped to an unsigned word that orders as the floats do
// (-0.0 taken as +0.0, every NaN above +inf, -inf above the empty key 0),
// then 0xFFFFFFFF - index, so the larger key is torch.argmax's choice.  A
// warp takes the largest with two __reduce_max_sync (the high words, then
// the low words of the lanes holding the largest high word), the block
// over its warps, and one atomicMax a block on the row's word.  The row's
// last block to arrive (its arrival counter, an acquire-release add: the
// word is raised before the arrival is counted, and the last block sees
// every raise) takes the word with atomicExch (leaving it zeroed), writes
// the token and zeroes the counter.  Within a thread the kCols columns are
// compared as floats (a later one wins when larger, or a NaN over a
// number), and only the thread's best becomes a key.
// The words and counters are one zeroed buffer a device, left zeroed by
// every launch; the argmax does not depend on the order of the atomics, so
// every call gives the same result.
//
// What bounds it on an H100: the integer pipe and the launch's latency.  A
// column costs one threefry2x32, the uniform and two XLA logs (about 164
// instructions, 103 of them integer, in the SASS), against 2 or 4 bytes
// read; a launch of a handful of columns still takes ~3.4 us in a CUDA
// graph (a row's chain of dependent threefry, logs, reductions and
// atomics).  Blocks of 64 to 256 threads and 4 or 8 columns a thread ran
// within 4% of each other.
//
// C interface (bound with ctypes): the launcher returns cudaGetLastError().

#include <cuda/atomic>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "jax_random.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 8;  // consecutive columns a thread
constexpr int kSpan = kThreads * kCols;

// the ordered key of column v's value x
__device__ __forceinline__ unsigned long long key_of(float x, uint32_t v) {
  uint32_t b = __float_as_uint(x);
  if (x != x) {
    b = 0xFFFFFFFFu;  // every NaN, above +inf
  } else {
    if (b == 0x80000000u) b = 0u;  // -0.0 as +0.0
    b = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  }
  return (unsigned long long)b << 32 | (0xFFFFFFFFu - v);
}

// the stored type of a dtype (0 float32, 1 bfloat16, 2 float16), and a
// 16-bit pattern's value (exact)
template <int kDtype>
struct In;
template <>
struct In<0> {
  using T = float;
  static __device__ __forceinline__ float f(float x) { return x; }
};
template <>
struct In<1> {
  using T = __nv_bfloat16;
  static __device__ __forceinline__ float f(__nv_bfloat16 x) { return __bfloat162float(x); }
  static __device__ __forceinline__ float bits(uint32_t u) {
    return __bfloat162float(__ushort_as_bfloat16((unsigned short)u));
  }
};
template <>
struct In<2> {
  using T = __half;
  static __device__ __forceinline__ float f(__half x) { return __half2float(x); }
  static __device__ __forceinline__ float bits(uint32_t u) {
    return __half2float(__ushort_as_half((unsigned short)u));
  }
};

// kCols values from 16-byte aligned memory, as 16-byte vectors (8 bytes for
// 4 16-bit values)
static_assert(kCols == 4 || kCols == 8, "load_vec reads 4 or 8 values");
template <int kDtype>
__device__ __forceinline__ void load_vec(const typename In<kDtype>::T* p, float (&x)[kCols]) {
  if constexpr (kDtype == 0) {
#pragma unroll
    for (int q = 0; q < kCols / 4; ++q) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(p) + q);
      x[4 * q] = a.x, x[4 * q + 1] = a.y, x[4 * q + 2] = a.z, x[4 * q + 3] = a.w;
    }
  } else {
    uint32_t u[kCols / 2];
    if constexpr (kCols == 8) {
      const uint4 w = __ldg(reinterpret_cast<const uint4*>(p));
      u[0] = w.x, u[1] = w.y, u[2] = w.z, u[3] = w.w;
    } else {
      const uint2 w = __ldg(reinterpret_cast<const uint2*>(p));
      u[0] = w.x, u[1] = w.y;
    }
#pragma unroll
    for (int i = 0; i < kCols / 2; ++i) {
      x[2 * i] = In<kDtype>::bits(u[i] & 0xFFFFu);
      x[2 * i + 1] = In<kDtype>::bits(u[i] >> 16);
    }
  }
}

// column v's value: logp plus its Gumbel draw, added in float32
template <typename I>
__device__ __forceinline__ float value_at(uint32_t k0, uint32_t k1, I base, uint32_t v,
                                          float x) {
  const I c = base + (I)v;
  uint32_t x0 = sizeof(I) == 8 ? (uint32_t)((unsigned long long)c >> 32) : 0u;
  uint32_t x1 = (uint32_t)c;
  threefry2x32(k0, k1, x0, x1);
  return __fadd_rn(x, jr::gumbel(x0 ^ x1));
}

__device__ __forceinline__ unsigned long long umax(unsigned long long a, unsigned long long b) {
  return a > b ? a : b;
}

template <int kDtype, typename I>
__global__ void __launch_bounds__(kThreads)
    categorical_kernel(const typename In<kDtype>::T* __restrict__ logp, uint32_t V,
                       const uint32_t* __restrict__ keys, uint32_t k0, uint32_t k1,
                       long long* __restrict__ tokens, unsigned long long* __restrict__ words,
                       unsigned* __restrict__ counters) {
  using T = typename In<kDtype>::T;
  const unsigned r = blockIdx.y, s = blockIdx.x, t = threadIdx.x;
  const T* row = logp + (unsigned long long)r * V;
  I base = (I)((unsigned long long)r * V);  // one key: the flat counter
  if (keys != nullptr) {
    k0 = keys[2 * r];
    k1 = keys[2 * r + 1];
    base = 0;
  }
  // the columns before the row's first 16-byte boundary
  uint32_t peel = (uint32_t)((16u - (uint32_t)(reinterpret_cast<uintptr_t>(row) & 15u)) & 15u) /
                  (uint32_t)sizeof(T);
  if (peel > V) peel = V;
  unsigned long long best = 0ull;  // the empty key: below every column's
  const uint32_t v0 = peel + (s * kThreads + t) * kCols;
  uint32_t a = v0 < V ? v0 : V;  // this thread's columns read one at a time: [a, V)
  if (v0 + kCols <= V) {
    float x[kCols];
    load_vec<kDtype>(row + v0, x);
    // the columns in order, compared as floats: a later one wins when
    // larger, or a NaN over a number (ties, and -0.0 against 0.0, keep the
    // first); one key for the thread's best
    float bv = value_at<I>(k0, k1, base, v0, x[0]);
    uint32_t bl = 0;
#pragma unroll
    for (int l = 1; l < kCols; ++l) {
      const float y = value_at<I>(k0, k1, base, v0 + l, x[l]);
      if (y > bv || (y != y && bv == bv)) bv = y, bl = l;
    }
    best = key_of(bv, v0 + bl);
    a = V;
  }
  // then the peeled column (block 0's first threads) and a ragged end
  const uint32_t extra = s == 0 && t < peel ? 1u : 0u;
  for (uint32_t i = 0; i < extra + (V - a); ++i) {
    const uint32_t v = i < extra ? t : a + i - extra;
    best = umax(best, key_of(value_at<I>(k0, k1, base, v, In<kDtype>::f(row[v])), v));
  }
  // the warp's largest key, then the block's, then the row's
  const uint32_t hi = __reduce_max_sync(0xFFFFFFFFu, (uint32_t)(best >> 32));
  const uint32_t lo = __reduce_max_sync(0xFFFFFFFFu,
                                        (uint32_t)(best >> 32) == hi ? (uint32_t)best : 0u);
  __shared__ unsigned long long warp_best[kWarps];
  if (t % 32 == 0) warp_best[t / 32] = (unsigned long long)hi << 32 | lo;
  __syncthreads();
  if (t != 0) return;
  best = warp_best[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) best = umax(best, warp_best[w]);
  atomicMax(words + r, best);
  // the arrival releases the raised word, and the last block acquires the
  // others'
  cuda::atomic_ref<unsigned, cuda::thread_scope_device> arrived(counters[r]);
  if (arrived.fetch_add(1u, cuda::memory_order_acq_rel) != gridDim.x - 1) return;
  const unsigned long long w = atomicExch(words + r, 0ull);
  tokens[r] = (long long)(0xFFFFFFFFu - (uint32_t)w);
  counters[r] = 0u;  // every block of the row has arrived
}

template <int kDtype, typename I>
void launch(const void* logp, uint32_t V, int rows, const uint32_t* keys, uint32_t k0,
            uint32_t k1, long long* tokens, unsigned long long* words, unsigned* counters,
            cudaStream_t s) {
  const dim3 grid((V + kSpan - 1) / kSpan, (unsigned)rows);
  categorical_kernel<kDtype, I><<<grid, kThreads, 0, s>>>(
      static_cast<const typename In<kDtype>::T*>(logp), V, keys, k0, k1, tokens, words,
      counters);
}

template <typename I>
int launch_typed(int dtype, const void* logp, uint32_t V, int rows, const uint32_t* keys,
                 uint32_t k0, uint32_t k1, long long* tokens, unsigned long long* words,
                 unsigned* counters, cudaStream_t s) {
  if (dtype == 0) {
    launch<0, I>(logp, V, rows, keys, k0, k1, tokens, words, counters, s);
  } else if (dtype == 1) {
    launch<1, I>(logp, V, rows, keys, k0, k1, tokens, words, counters, s);
  } else if (dtype == 2) {
    launch<2, I>(logp, V, rows, keys, k0, k1, tokens, words, counters, s);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

}  // namespace

// The threads a block and the columns a thread: kernels/categorical.py's
// plan checks its own against them.
extern "C" void categorical_shape(int* threads, int* cols) {
  *threads = kThreads;
  *cols = kCols;
}

// logp: (rows, V) of dtype (0 float32, 1 bfloat16, 2 float16), V <= 2^31;
// keys: (rows, 2) uint32 on the device, or null for one key (k0, k1) over
// the flat counters; tokens: (rows,) int64; words: rows zeroed 64-bit
// words, counters: rows zeroed arrival counters (both left zeroed).
extern "C" int categorical_launch(const void* logp, long long V, int rows, const void* keys,
                                  unsigned k0, unsigned k1, void* tokens, void* words,
                                  void* counters, int dtype, void* stream) {
  if (V < 1 || V > (1ll << 31) || rows < 1 || rows > 65535) return cudaErrorInvalidValue;
  // the launch's last counter: one key, the flat (rows, V) draw's
  const unsigned long long last = keys ? (unsigned long long)V - 1
                                       : (unsigned long long)rows * (unsigned long long)V - 1;
  const uint32_t* kt = static_cast<const uint32_t*>(keys);
  long long* t = static_cast<long long*>(tokens);
  unsigned long long* w = static_cast<unsigned long long*>(words);
  unsigned* c = static_cast<unsigned*>(counters);
  cudaStream_t s = (cudaStream_t)stream;
  const int err = last >= (1ull << 32)
                      ? launch_typed<unsigned long long>(dtype, logp, (uint32_t)V, rows, kt, k0,
                                                         k1, t, w, c, s)
                      : launch_typed<uint32_t>(dtype, logp, (uint32_t)V, rows, kt, k0, k1, t, w,
                                               c, s);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
