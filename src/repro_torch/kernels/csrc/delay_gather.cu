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
// One kernel, wicon_kernel, reads; wicon_row, its row loop, is templated on
// where delay_i comes from (Source):
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
// Indices.  The flat index within a chain's row is randint's counter, a
// 64-bit value split into a high and a low word as JAX splits it.  A row of
// at most 2^32 elements is indexed with 32-bit integers (the high word is
// then 0 and folds away); a longer row with 64-bit ones.  The index type is
// a template argument chosen once a launch, so every row up to 2^32
// elements runs the 32-bit code: a 64-bit loop counter would add integer
// operations an element on the pipe that already bounds the drawn read.  A
// row is addressed by one 64-bit offset, slot * n.
//
// The chain axis.  Every launch reads C chains (C = 1 for a single chain):
// the rings are (C, depth, n) and the output (C, n), one block row
// (blockIdx.y) a chain, each under its own head: the heads agree while
// every chain commits, and a masked commit (a lost commit, a quarantined
// chain) leaves that chain's head behind.  Each chain draws under its own
// key and its own maxval (its staleness differs), so the host builds a
// table of C rows (the subkeys, span, mult and remainder constant of
// rng.randint_params, then the chain's head) once a commit for every
// leaf, and each block reads its head and picks kZero, kLow or kBoth from
// its chain's row (one branch a block, no divergence inside it).  The
// delay array of kArray is (C, n), with the heads in a (C,) int32 array,
// and coordinate_delays_kernel writes (C, n) draws from the same table
// (it reads no head).  A chain's output does not depend on C.  The
// rows of every chain start on 16 bytes when the bases do and n *
// elem_bytes is a multiple of 16; otherwise every element takes the
// scalar code.  Row offsets are 64-bit.
//
// C interface (bound with ctypes): each launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "randint.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;
constexpr int kSelectRows = 4;  // read whole rows up to this many, else gather

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

template <int kSrc, typename I>
__device__ __forceinline__ int delay_at(const int32_t* __restrict__ delays,
                                        const RandintKey& key, I i, int depth) {
  if constexpr (kSrc == kArray) {
    return wrap_delay(delays[i], depth);
  } else if constexpr (kSrc == kZero) {
    return 0;
  } else {
    return (int)randint_at<kSrc == kBoth>(key, i);
  }
}

// One ring's read (history (depth, n) -> out (n,)) by the threads of one
// block row: thread tid of stride.  I indexes the row (uint32_t up to 2^32
// elements, else unsigned long long).
template <typename W, int kSrc, typename I>
__device__ __forceinline__ void wicon_row(const W* __restrict__ hist,
                                          const int32_t* __restrict__ delays,
                                          W* __restrict__ out, unsigned long long n, int depth,
                                          int head, int rows, const RandintKey& key, int vec,
                                          uint32_t tid, uint32_t stride) {
  constexpr int V = 16 / sizeof(W);  // lanes of a 16-byte vector
  if (!vec) {
    const I last = (I)(n - 1);
    for (I i = tid; i <= last; i += stride) {  // the unaligned case
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
  const I nv = (I)(n / V);  // n % V == 0: the rows are aligned
  const W* row[kSelectRows];  // row[j]: the snapshot of delay j
#pragma unroll
  for (int j = 0; j < kSelectRows; ++j)
    row[j] = hist + (unsigned long long)slot_of(head, j < rows ? j : 0, depth) * n;
  for (I v = tid; v < nv; v += stride) {
    const I base = v * V;
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

template <bool kBoth, typename I>
__device__ __forceinline__ void delays_row(int32_t* __restrict__ out, unsigned long long n,
                                           const RandintKey& key, uint32_t tid,
                                           uint32_t stride) {
  const I last = (I)(n - 1);
  for (I i = tid; i <= last; i += stride) {
    out[i] = (int32_t)randint_at<kBoth>(key, i);
    if (last - i < stride) break;
  }
}

// One row of the chain table: chain c's randint parameters (as
// rng.randint_params and rng.fastmod_magic give them) and its ring head.
struct ChainKey {
  uint32_t hk0, hk1, lk0, lk1, span, mult, magic_lo, magic_hi, head;
};

__device__ __forceinline__ RandintKey chain_key(const ChainKey* __restrict__ table) {
  const ChainKey c = table[blockIdx.y];
  RandintKey k;
  k.hk0 = c.hk0;
  k.hk1 = c.hk1;
  k.lk0 = c.lk0;
  k.lk1 = c.lk1;
  k.span = c.span;
  k.mult = c.mult;
  k.magic = ((unsigned long long)c.magic_hi << 32) | c.magic_lo;
  return k;
}

// The read of every chain: block row blockIdx.y is chain c, its ring
// hist[c] (depth, n) and its output out[c] (n,).  kFromArray: the delays
// are delays[c] (n,) int32 and the head heads[c]; else they are drawn
// under table row c, which also holds the head, the draw picked from the
// row (one branch a block).
template <typename W, bool kFromArray, typename I>
__global__ void __launch_bounds__(kThreads)
    wicon_kernel(const W* __restrict__ hist, const int32_t* __restrict__ delays,
                 W* __restrict__ out, unsigned long long n, int depth,
                 const int32_t* __restrict__ heads, const ChainKey* __restrict__ table,
                 int vec) {
  const unsigned long long c = blockIdx.y;
  const W* h = hist + c * depth * n;
  W* o = out + c * n;
  const uint32_t tid = blockIdx.x * kThreads + threadIdx.x, stride = gridDim.x * kThreads;
  if constexpr (kFromArray) {
    wicon_row<W, kArray, I>(h, delays + c * n, o, n, depth, heads[c], depth, RandintKey(), vec,
                         tid, stride);
  } else {
    const int head = (int)table[c].head;
    const RandintKey key = chain_key(table);
    if (key.span == 1u) {
      wicon_row<W, kZero, I>(h, nullptr, o, n, depth, head, 1, key, vec, tid, stride);
    } else if (key.mult == 0u) {
      wicon_row<W, kLow, I>(h, nullptr, o, n, depth, head, (int)key.span, key, vec, tid, stride);
    } else {
      wicon_row<W, kBoth, I>(h, nullptr, o, n, depth, head, (int)key.span, key, vec, tid, stride);
    }
  }
}

template <typename I>
__global__ void __launch_bounds__(kThreads)
    coordinate_delays_kernel(int32_t* __restrict__ out, unsigned long long n,
                             const ChainKey* __restrict__ table) {
  const RandintKey key = chain_key(table);
  int32_t* o = out + (unsigned long long)blockIdx.y * n;
  const uint32_t tid = blockIdx.x * kThreads + threadIdx.x, stride = gridDim.x * kThreads;
  if (key.mult == 0u) {
    delays_row<false, I>(o, n, key, tid, stride);
  } else {
    delays_row<true, I>(o, n, key, tid, stride);
  }
}

dim3 chain_grid(unsigned long long work, int chains) {
  const unsigned long long want = (work + kThreads - 1) / kThreads;
  const unsigned long long cap = kMaxBlocks / chains > 0 ? kMaxBlocks / chains : 1;
  return dim3((unsigned)(want < cap ? want : cap), (unsigned)chains);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

// A row of at most 2^32 elements is indexed with 32-bit integers.
constexpr unsigned long long kIndex32 = 1ULL << 32;
// The longest row: every offset c * depth * n below 2^63 is checked on the
// host; this bounds a row alone.
constexpr unsigned long long kMaxRow = 1ULL << 62;

bool bad_ring(unsigned long long n, int chains, int depth) {
  return n < 1 || n > kMaxRow || chains < 1 || chains > 65535 || depth < 1;
}

template <typename W, bool kFromArray>
void launch_wicon(dim3 grid, const void* hist, const int32_t* delays, void* out,
                  unsigned long long n, int depth, const int32_t* heads, const ChainKey* table,
                  int vec, cudaStream_t s) {
  if (n <= kIndex32) {
    wicon_kernel<W, kFromArray, uint32_t><<<grid, kThreads, 0, s>>>(
        static_cast<const W*>(hist), delays, static_cast<W*>(out), n, depth, heads, table,
        vec);
  } else {
    wicon_kernel<W, kFromArray, unsigned long long><<<grid, kThreads, 0, s>>>(
        static_cast<const W*>(hist), delays, static_cast<W*>(out), n, depth, heads, table,
        vec);
  }
}

template <bool kFromArray>
int launch(const void* hist, const int32_t* delays, void* out, unsigned long long n,
           int chains, int depth, const int32_t* heads, const ChainKey* table, int elem_bytes,
           cudaStream_t s) {
  const bool vec = aligned16(hist) && aligned16(out) && (n * elem_bytes) % 16 == 0 &&
                   (!kFromArray || aligned16(delays));
  const dim3 grid = chain_grid(vec ? n / (16 / elem_bytes) : n, chains);
  if (elem_bytes == 2) {
    launch_wicon<uint16_t, kFromArray>(grid, hist, delays, out, n, depth, heads, table, vec, s);
  } else if (elem_bytes == 4) {
    launch_wicon<uint32_t, kFromArray>(grid, hist, delays, out, n, depth, heads, table, vec, s);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// The one-pass W-Icon read: history (chains, depth, n) of elem_bytes-byte
// elements, out (chains, n); chain c's delays drawn as
// jax.random.randint(key_c, (n,), 0, span_c, int32) from table row c
// (chains, 9) 32-bit words on the device: hk0, hk1, lk0, lk1, span, mult,
// magic low, magic high (rng.randint_params, rng.fastmod_magic), and the
// chain's head.  The caller checks 1 <= span <= depth, span < 2^16 and
// 0 <= head < depth for every chain, and chains * depth * n < 2^63.
// 1 <= n <= 2^62, 1 <= chains <= 65535.
extern "C" int wicon_read_launch(const void* hist, void* out, unsigned long long n, int chains,
                                 int depth, const void* table, int elem_bytes, void* stream) {
  if (bad_ring(n, chains, depth)) return cudaErrorInvalidValue;
  return launch<false>(hist, nullptr, out, n, chains, depth, nullptr,
                       static_cast<const ChainKey*>(table), elem_bytes, (cudaStream_t)stream);
}

// history (chains, depth, n), delays (chains, n) int32 (any value: the
// slot is (heads[c] - delay) mod depth), heads (chains,) int32 on the
// device (the caller checks 0 <= heads[c] < depth), out (chains, n).
// Limits as wicon_read_launch.
extern "C" int delay_gather_launch(const void* hist, const void* delays, void* out,
                                   unsigned long long n, int chains, int depth,
                                   const void* heads, int elem_bytes, void* stream) {
  if (bad_ring(n, chains, depth)) return cudaErrorInvalidValue;
  return launch<true>(hist, static_cast<const int32_t*>(delays), out, n, chains, depth,
                      static_cast<const int32_t*>(heads), nullptr, elem_bytes,
                      (cudaStream_t)stream);
}

// out (chains, n) int32 in [0, span_c), chain c's row drawn under table
// row c (the caller checks 1 <= span < 2^16 and chains * n < 2^63).
// 1 <= n <= 2^62, 1 <= chains <= 65535.
extern "C" int coordinate_delays_launch(void* out, unsigned long long n, int chains,
                                        const void* table, void* stream) {
  if (n < 1 || n > kMaxRow || chains < 1 || chains > 65535) return cudaErrorInvalidValue;
  const dim3 grid = chain_grid(n, chains);
  int32_t* o = static_cast<int32_t*>(out);
  const ChainKey* t = static_cast<const ChainKey*>(table);
  if (n <= kIndex32) {
    coordinate_delays_kernel<uint32_t><<<grid, kThreads, 0, (cudaStream_t)stream>>>(o, n, t);
  } else {
    coordinate_delays_kernel<unsigned long long><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        o, n, t);
  }
  return cudaGetLastError();
}
