// The W-Icon stale read, and the draw of its per-coordinate delays, for
// sm_90a.
//
// The read replaces the Pallas TPU kernel src/repro/kernels/delay_gather.py
// (delay_gather_1d, body _kernel):
//
//     out[i] = history[slot_i, i],   slot_i = (head - delay_i) mod depth
//
// over one leaf's ring of iterates, history (depth, n).  The TPU kernel
// streams a (depth, 4096) tile of history through VMEM and selects by
// multiply-and-sum, sum_d history[d, i] * (d == slot_i), which reads all
// depth snapshots of every coordinate and turns a selected -0.0 into +0.0.
// Here the selected element's raw bits are copied (-0.0, inf and nan
// included) for any 2- or 4-byte type (bfloat16, float32, int32).
//
// One kernel, wicon_kernel, templated on where delay_i comes from (Source):
//
// - kArray (delay_gather_launch): from an int32 array, any value, the slot
//   taken with torch.remainder's semantics.  A delay in [0, depth) takes a
//   compare-and-add; the general modulo runs only off that path.
// - kBoth, kLow, kZero (wicon_read_launch): drawn in registers, bit for bit
//   jax.random.randint(key, (n,), 0, maxval, int32)[i] (randint.cuh), as
//   src/repro/core/delay.py (sample_coordinate_delays) draws them.  The
//   training path's read is then one launch a leaf that allocates and
//   writes no delay array: the two-pass read wrote 4 bytes of delay an
//   element and read them back.  0 <= d_i < maxval <= depth, so the slot
//   takes no modulo.  With maxval 1 every delay is 0 and nothing is drawn
//   (kZero); where 2^32 mod maxval = 0 (maxval 2, 4, ...) randint's high
//   stream drops out of its sum and only the low one is drawn (kLow).
//
// coordinate_delays_kernel keeps the draw as a kernel of its own (the
// counterpart of the jax.random.randint call), calling the same randint_at.
//
// What bounds it on an H100.  The drawn read is bound by integer operations:
// two threefry2x32 blocks, three remainders and the fold, ~152 32-bit
// operations an element, against 4 bytes an element moved at bfloat16
// (one element read, one written).  The gather from an array is bound by
// bytes: its delay (4 bytes), the element and the output.
//
// Selecting from the rows.  With delays spread over R rows (R = maxval when
// drawn, depth when read), a 32-byte sector of a row holds 16 bfloat16 or
// 8 float32 elements, and a gather skips it only when none of them selects
// that row: (1 - 1/R)^16 of the sectors at bfloat16, 0.15% at R = 3.  A
// one-element-a-thread gather therefore streams every row all the same,
// with one load instruction an element (the two-pass kernel's header said
// a warp touches "at most depth segments", and was silent that all depth
// rows are fetched).  So for R <= kSelectRows a thread reads each of the R
// rows as 16-byte vectors (8 bfloat16 or 4 float32 / int32 lanes) and
// selects per lane in registers: at R = 4 a gather would still fetch 99%
// (bfloat16) or 90% (float32) of the sectors, and the vectors cost one load
// instruction for 8 or 4 elements a row.  Above it (R >= 5, only with a
// deeper ring than the training path's tau + 1 = 3), each lane loads only
// its selected element, since a gather then skips a growing share of the
// sectors (12% at bfloat16 and 34% at float32 by R = 8).
//
// Vectors and alignment.  The vector path runs when history, out (and the
// delay array) start on 16 bytes and the row stride n * elem_bytes is a
// multiple of 16, so n is a whole number of vectors.  Otherwise (a leaf of
// odd size has misaligned rows) every element takes the scalar code, the
// same selection one element a thread.
// Indices are 32-bit (n <= 2^32, and the flat index is randint's counter);
// a row is addressed by one 64-bit offset, slot * n.
//
// C interface (bound with ctypes): each launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "randint.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;
constexpr int kSelectRows = 4;  // read whole rows up to this many, else gather

int blocks_for(unsigned long long work) {
  const unsigned long long want = (work + kThreads - 1) / kThreads;
  return (int)(want < kMaxBlocks ? want : kMaxBlocks);
}

// delay in [0, depth) with torch.remainder's semantics for any int32
__device__ __forceinline__ int wrap_delay(int d, int depth) {
  if ((unsigned)d >= (unsigned)depth) d = ((d % depth) + depth) % depth;  // off the main path
  return d;
}

__device__ __forceinline__ int slot_of(int head, int d, int depth) {
  const int s = head - d;  // in (-depth, depth)
  return s < 0 ? s + depth : s;
}

// Where a coordinate's delay comes from: an int32 array, or drawn — all 0
// (maxval 1), from randint's low stream alone (2^32 mod span = 0), or from
// both streams.  The launcher picks one for the launch.
enum Source { kArray, kZero, kLow, kBoth };

template <int kSrc>
__device__ __forceinline__ int delay_at(const int32_t* __restrict__ delays,
                                        const RandintKey& key, uint32_t i, int depth) {
  if constexpr (kSrc == kArray) {
    return wrap_delay(delays[i], depth);
  } else if constexpr (kSrc == kZero) {
    return 0;
  } else {
    return (int)randint_at<kSrc == kBoth>(key, i);
  }
}

template <typename W, int kSrc>
__global__ void __launch_bounds__(kThreads)
    wicon_kernel(const W* __restrict__ hist, const int32_t* __restrict__ delays,
                 W* __restrict__ out, unsigned long long n, int depth, int head, int rows,
                 RandintKey key, int vec) {
  constexpr int V = 16 / sizeof(W);  // lanes of a 16-byte vector
  const uint32_t tid = blockIdx.x * kThreads + threadIdx.x;
  const uint32_t stride = gridDim.x * kThreads;
  if (!vec) {
    const uint32_t last = (uint32_t)(n - 1);
    for (uint32_t i = tid; i <= last; i += stride) {  // the unaligned case
      const int d = delay_at<kSrc>(delays, key, i, depth);
      out[i] = hist[(unsigned long long)slot_of(head, d, depth) * n + i];
      if (last - i < stride) break;  // i + stride would pass last (or wrap)
    }
    return;
  }
  union Lanes {
    uint4 v;
    W e[V];
  };
  const uint32_t nv = (uint32_t)(n / V);  // n % V == 0: the rows are aligned
  const W* row[kSelectRows];  // row[j]: the snapshot of delay j
#pragma unroll
  for (int j = 0; j < kSelectRows; ++j)
    row[j] = hist + (unsigned long long)slot_of(head, j < rows ? j : 0, depth) * n;
  for (uint32_t v = tid; v < nv; v += stride) {
    const uint32_t base = v * V;
    int d[V];
    if constexpr (kSrc == kArray) {
#pragma unroll
      for (int q = 0; q < V / 4; ++q) {
        const int4 dv = reinterpret_cast<const int4*>(delays + base)[q];
        d[4 * q + 0] = wrap_delay(dv.x, depth);
        d[4 * q + 1] = wrap_delay(dv.y, depth);
        d[4 * q + 2] = wrap_delay(dv.z, depth);
        d[4 * q + 3] = wrap_delay(dv.w, depth);
      }
    } else {
#pragma unroll
      for (int l = 0; l < V; ++l) d[l] = delay_at<kSrc>(delays, key, base + l, depth);
    }
    Lanes o;
    if (rows <= kSelectRows) {
      o.v = reinterpret_cast<const uint4*>(row[0] + base)[0];
#pragma unroll
      for (int j = 1; j < kSelectRows; ++j) {
        if (j < rows) {
          Lanes r;
          r.v = reinterpret_cast<const uint4*>(row[j] + base)[0];
#pragma unroll
          for (int l = 0; l < V; ++l) o.e[l] = d[l] == j ? r.e[l] : o.e[l];
        }
      }
    } else {
#pragma unroll
      for (int l = 0; l < V; ++l)
        o.e[l] = hist[(unsigned long long)slot_of(head, d[l], depth) * n + base + l];
    }
    reinterpret_cast<uint4*>(out + base)[0] = o.v;
  }
}

template <bool kBoth>
__global__ void __launch_bounds__(kThreads)
    coordinate_delays_kernel(int32_t* __restrict__ out, unsigned long long n, RandintKey key) {
  const uint32_t tid = blockIdx.x * kThreads + threadIdx.x;
  const uint32_t stride = gridDim.x * kThreads;
  const uint32_t last = (uint32_t)(n - 1);
  for (uint32_t i = tid; i <= last; i += stride) {
    out[i] = (int32_t)randint_at<kBoth>(key, i);
    if (last - i < stride) break;
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

template <int kSrc>
int launch(const void* hist, const int32_t* delays, void* out, unsigned long long n,
           int depth, int head, int rows, const RandintKey& key, int elem_bytes,
           cudaStream_t s) {
  const bool vec = aligned16(hist) && aligned16(out) && (n * elem_bytes) % 16 == 0 &&
                   (kSrc != kArray || aligned16(delays));
  const unsigned long long work = vec ? n / (16 / elem_bytes) : n;
  const int blocks = blocks_for(work);
  if (elem_bytes == 2) {
    wicon_kernel<uint16_t, kSrc><<<blocks, kThreads, 0, s>>>(
        static_cast<const uint16_t*>(hist), delays, static_cast<uint16_t*>(out), n, depth,
        head, rows, key, vec);
  } else if (elem_bytes == 4) {
    wicon_kernel<uint32_t, kSrc><<<blocks, kThreads, 0, s>>>(
        static_cast<const uint32_t*>(hist), delays, static_cast<uint32_t*>(out), n, depth,
        head, rows, key, vec);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

RandintKey make_key(unsigned hk0, unsigned hk1, unsigned lk0, unsigned lk1, unsigned span,
                    unsigned mult, unsigned long long magic) {
  RandintKey k;
  k.hk0 = hk0;
  k.hk1 = hk1;
  k.lk0 = lk0;
  k.lk1 = lk1;
  k.span = span;
  k.mult = mult;
  k.magic = magic;
  return k;
}

}  // namespace

// history (depth, n) of elem_bytes-byte elements, delays (n,) int32 (any
// value: the slot is (head - delay) mod depth), out (n,).  1 <= n <= 2^32,
// depth >= 1, 0 <= head < depth.
extern "C" int delay_gather_launch(const void* hist, const void* delays, void* out,
                                   unsigned long long n, int depth, int head, int elem_bytes,
                                   void* stream) {
  if (n < 1 || n > (1ULL << 32) || depth < 1 || head < 0 || head >= depth)
    return cudaErrorInvalidValue;
  return launch<kArray>(hist, static_cast<const int32_t*>(delays), out, n, depth, head,
                        depth, make_key(0, 0, 0, 0, 1, 0, 0), elem_bytes,
                        (cudaStream_t)stream);
}

// The one-pass W-Icon read: history (depth, n), out (n,), the delays drawn
// as jax.random.randint(key, (n,), 0, span, int32) with the subkeys, mult
// and magic of rng.randint_params.  1 <= span <= depth, span < 2^16.
extern "C" int wicon_read_launch(const void* hist, void* out, unsigned long long n,
                                 int depth, int head, unsigned hk0, unsigned hk1,
                                 unsigned lk0, unsigned lk1, unsigned span, unsigned mult,
                                 unsigned long long magic, int elem_bytes, void* stream) {
  if (n < 1 || n > (1ULL << 32) || depth < 1 || head < 0 || head >= depth || span < 1u ||
      span > (unsigned)depth || span >= 65536u)
    return cudaErrorInvalidValue;
  const RandintKey key = make_key(hk0, hk1, lk0, lk1, span, mult, magic);
  cudaStream_t s = (cudaStream_t)stream;
  if (span == 1u) return launch<kZero>(hist, nullptr, out, n, depth, head, 1, key, elem_bytes, s);
  if (mult == 0u) return launch<kLow>(hist, nullptr, out, n, depth, head, span, key, elem_bytes, s);
  return launch<kBoth>(hist, nullptr, out, n, depth, head, span, key, elem_bytes, s);
}

// out (n,) int32 in [0, span); 1 <= span < 2^16, 1 <= n <= 2^32 (the counter).
extern "C" int coordinate_delays_launch(void* out, unsigned long long n, unsigned hk0,
                                        unsigned hk1, unsigned lk0, unsigned lk1,
                                        unsigned span, unsigned mult,
                                        unsigned long long magic, void* stream) {
  if (n < 1 || n > (1ULL << 32) || span < 1u || span >= 65536u) return cudaErrorInvalidValue;
  const RandintKey key = make_key(hk0, hk1, lk0, lk1, span, mult, magic);
  if (mult == 0u) {
    coordinate_delays_kernel<false><<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        static_cast<int32_t*>(out), n, key);
  } else {
    coordinate_delays_kernel<true><<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        static_cast<int32_t*>(out), n, key);
  }
  return cudaGetLastError();
}
