// The W-Icon stale read and the draw of its per-coordinate delays, for
// sm_90a.
//
// delay_gather_kernel replaces the Pallas TPU kernel
// src/repro/kernels/delay_gather.py (delay_gather_1d, body _kernel):
//
//     out[i] = history[slot_i, i],   slot_i = (head - delay_i) mod depth
//
// over one leaf's ring of iterates, history (depth, N).  The TPU kernel
// streams a (depth, 4096) tile of history through VMEM and selects by
// multiply-and-sum, sum_d history[d, i] * (d == slot_i), which reads all
// depth snapshots of every coordinate and turns a selected -0.0 into +0.0.
// Here each thread reads its delay, computes the slot, and copies the one
// element it selects — a true gather, bit for bit the element (-0.0, inf
// and nan included), for any 2- or 4-byte type (bfloat16, float32, int32:
// the copy moves raw bits).  The mod is folded in (the TPU wrapper computes
// slots with jnp.mod before the call), so no slot array is written.
//
// What bounds it on an H100: bytes.  Per coordinate it reads 4 bytes of
// delay and one element, and writes one element — no arithmetic to speak
// of.  Neighbouring threads take neighbouring coordinates, so the delay
// reads and the output writes are coalesced; the history reads are
// coalesced within each of the depth rows (a warp touches at most depth
// segments).
//
// coordinate_delays_kernel draws those delays: jax.random.randint(key,
// (n,), 0, span, int32) bit for bit, as src/repro/core/delay.py
// (sample_coordinate_delays) draws them under jax_threefry_partitionable —
// two 32-bit streams, threefry2x32(k_hi, (0, i)) and threefry2x32(k_lo,
// (0, i)) with (k_hi, k_lo) = split(key), each folded x0 ^ x1, reduced mod
// span and recombined with multiplier = 2^32 mod span.  Two threefry blocks
// (~160 integer operations) per coordinate against 4 bytes written: bound
// by operations.  The host computes the subkeys, the span and the
// multiplier (rng.randint_params).
//
// C interface (bound with ctypes): each launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

int blocks_for(long long n) {
  const long long want = (n + kThreads - 1) / kThreads;
  return (int)(want < kMaxBlocks ? want : kMaxBlocks);
}

template <typename W>  // W: the element's raw bits
__global__ void __launch_bounds__(kThreads)
    delay_gather_kernel(const W* __restrict__ hist, const int32_t* __restrict__ delays,
                        W* __restrict__ out, long long n, int depth, int head) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) {
    long long s = ((long long)head - delays[i]) % depth;  // 64-bit: no overflow
    if (s < 0) s += depth;
    out[i] = hist[s * n + i];
  }
}

__global__ void __launch_bounds__(kThreads)
    coordinate_delays_kernel(int32_t* __restrict__ out, long long n, uint32_t hk0,
                             uint32_t hk1, uint32_t lk0, uint32_t lk1, uint32_t span,
                             uint32_t mult) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) {
    uint32_t h0 = 0u, h1 = (uint32_t)i;
    threefry2x32(hk0, hk1, h0, h1);
    uint32_t l0 = 0u, l1 = (uint32_t)i;
    threefry2x32(lk0, lk1, l0, l1);
    const uint32_t off = (((h0 ^ h1) % span) * mult + (l0 ^ l1) % span) % span;
    out[i] = (int32_t)off;
  }
}

}  // namespace

// history (depth, n) of elem_bytes-byte elements, delays (n,) int32,
// out (n,).  depth >= 1, 0 <= head < depth.
extern "C" int delay_gather_launch(const void* hist, const void* delays, void* out,
                                   long long n, int depth, int head, int elem_bytes,
                                   void* stream) {
  if (n < 1 || depth < 1 || head < 0 || head >= depth) return cudaErrorInvalidValue;
  const int blocks = blocks_for(n);
  cudaStream_t s = (cudaStream_t)stream;
  if (elem_bytes == 2) {
    delay_gather_kernel<uint16_t><<<blocks, kThreads, 0, s>>>(
        static_cast<const uint16_t*>(hist), static_cast<const int32_t*>(delays),
        static_cast<uint16_t*>(out), n, depth, head);
  } else if (elem_bytes == 4) {
    delay_gather_kernel<uint32_t><<<blocks, kThreads, 0, s>>>(
        static_cast<const uint32_t*>(hist), static_cast<const int32_t*>(delays),
        static_cast<uint32_t*>(out), n, depth, head);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// out (n,) int32 in [0, span); 1 <= span < 2^16, n <= 2^32 (the counter).
extern "C" int coordinate_delays_launch(void* out, long long n, unsigned hk0, unsigned hk1,
                                        unsigned lk0, unsigned lk1, unsigned span,
                                        unsigned mult, void* stream) {
  if (n < 1 || n > (1LL << 32) || span < 1u || span >= 65536u) return cudaErrorInvalidValue;
  coordinate_delays_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<int32_t*>(out), n, hk0, hk1, lk0, lk1, span, mult);
  return cudaGetLastError();
}
