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
// jax.vmap(categorical) over keys): row r at [0, V) under keys[r].
//
// The argmax is torch.argmax's, which is also jnp.argmax's: the first
// maximal index, NaN above every number (the first NaN wins), -0.0 equal
// to 0.0; a row of -inf gives index 0.  logp is read in its own dtype
// (float32, bfloat16 or float16) and converted exactly.
//
// The split.  A row of 151,936 on one block would leave most of the 132 SMs
// idle at a batch of 4, so each row is cut into `splits` chunks, one block
// a chunk (blockIdx.x the chunk, blockIdx.y the row).  A block reduces its
// chunk to one (value, index) pair (a warp shuffle, then the block's warps
// in order), writes it to part[r, s], and bumps the row's arrival counter;
// the last block of the row to arrive reduces the row's pairs in chunk
// order, writes tokens[r] and resets the counter (the pattern of
// decode_step.cuh's combine).  One launch, no float atomics, the same
// result on every call: the argmax of (value, index) pairs does not depend
// on the order of the reduction.
//
// What bounds it on an H100: operations.  A column costs one threefry2x32
// (72 32-bit operations), the uniform and two XLA logs (about 80 more with
// the compare; chip_smoke.py's CATEGORICAL_OPS), against 2 or 4 bytes
// read.
//
// C interface (bound with ctypes): the launcher returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "jax_random.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Best {
  float v;
  long long i;
};

// whether a is chosen over b: NaN above every number, then the larger
// value, then the smaller index
__device__ __forceinline__ bool better(const Best& a, const Best& b) {
  const bool an = isnan(a.v), bn = isnan(b.v);
  if (an || bn) return an && (!bn || a.i < b.i);
  if (a.v != b.v) return a.v > b.v;
  return a.i < b.i;
}

__device__ __forceinline__ Best warp_best(Best b) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Best o;
    o.v = __shfl_down_sync(0xFFFFFFFFu, b.v, off);
    o.i = __shfl_down_sync(0xFFFFFFFFu, b.i, off);
    if (better(o, b)) b = o;
  }
  return b;
}

template <int kDtype>
__device__ __forceinline__ float load_logp(const void* p, unsigned long long idx) {
  if constexpr (kDtype == 0) {
    return static_cast<const float*>(p)[idx];
  } else if constexpr (kDtype == 1) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[idx]);
  } else {
    return __half2float(static_cast<const __half*>(p)[idx]);
  }
}

template <int kDtype>
__global__ void __launch_bounds__(kThreads)
    categorical_kernel(const void* __restrict__ logp, long long V,
                       const uint32_t* __restrict__ keys, uint32_t k0, uint32_t k1,
                       long long* __restrict__ tokens, float* __restrict__ part_v,
                       long long* __restrict__ part_i, unsigned* __restrict__ counters,
                       int splits, long long chunk) {
  const int s = blockIdx.x;
  const unsigned long long r = blockIdx.y;
  unsigned long long base = r * (unsigned long long)V;  // one key: the flat counter
  if (keys != nullptr) {
    k0 = keys[2 * r];
    k1 = keys[2 * r + 1];
    base = 0;
  }
  const long long lo = (long long)s * chunk;
  const long long hi = lo + chunk < V ? lo + chunk : V;
  const float neg_inf = __uint_as_float(0xff800000u);
  Best b{neg_inf, V};  // loses to every column, -inf ones included
  for (long long v = lo + threadIdx.x; v < hi; v += kThreads) {
    const float g = jr::gumbel(jr::bits_at(k0, k1, base + (unsigned long long)v));
    const Best c{__fadd_rn(load_logp<kDtype>(logp, r * (unsigned long long)V + v), g), v};
    if (better(c, b)) b = c;
  }
  __shared__ Best warps[kWarps];
  b = warp_best(b);
  if (threadIdx.x % 32 == 0) warps[threadIdx.x / 32] = b;
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int w = 1; w < kWarps; ++w)
    if (better(warps[w], b)) b = warps[w];
  part_v[r * splits + s] = b.v;
  part_i[r * splits + s] = b.i;
  __threadfence();  // the pair is visible before the arrival is counted
  if (atomicAdd(counters + r, 1u) != (unsigned)splits - 1) return;  // not the last
  __threadfence();
  Best row{neg_inf, V};
  for (int j = 0; j < splits; ++j) {
    const Best c{__ldcg(part_v + r * splits + j), __ldcg(part_i + r * splits + j)};
    if (better(c, row)) row = c;
  }
  tokens[r] = row.i;
  counters[r] = 0u;  // every chunk of the row has arrived
}

}  // namespace

// logp: (rows, V) of dtype (0 float32, 1 bfloat16, 2 float16); keys: (rows,
// 2) uint32 on the device, or null for one key (k0, k1) over the flat
// counters; tokens: (rows,) int64; part_v, part_i: rows * splits scratch;
// counters: rows zeroed arrival counters (left zeroed).
extern "C" int categorical_launch(const void* logp, long long V, int rows, const void* keys,
                                  unsigned k0, unsigned k1, void* tokens, void* part_v,
                                  void* part_i, void* counters, int splits, long long chunk,
                                  int dtype, void* stream) {
  if (V < 1 || rows < 1 || rows > 65535 || splits < 1 || chunk < 1 ||
      (long long)splits * chunk < V || dtype < 0 || dtype > 2)
    return cudaErrorInvalidValue;
  const dim3 grid((unsigned)splits, (unsigned)rows);
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* kt = static_cast<const uint32_t*>(keys);
  long long* t = static_cast<long long*>(tokens);
  float* pv = static_cast<float*>(part_v);
  long long* pi = static_cast<long long*>(part_i);
  unsigned* c = static_cast<unsigned*>(counters);
  if (dtype == 0) {
    categorical_kernel<0><<<grid, kThreads, 0, s>>>(logp, V, kt, k0, k1, t, pv, pi, c, splits,
                                                    chunk);
  } else if (dtype == 1) {
    categorical_kernel<1><<<grid, kThreads, 0, s>>>(logp, V, kt, k0, k1, t, pv, pi, c, splits,
                                                    chunk);
  } else {
    categorical_kernel<2><<<grid, kThreads, 0, s>>>(logp, V, kt, k0, k1, t, pv, pi, c, splits,
                                                    chunk);
  }
  return cudaGetLastError();
}
