// Fused single-token decode steps for the chain-bank BMA server, for sm_90a.
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/decode_step.py:
//   decode_step_kernel        <- decode_step_2d    (_kernel, ring KV cache)
//   paged_decode_step_kernel  <- paged_decode_step (_paged_kernel, page pool)
//
// Each step writes this token's k/v row into the cache in place, then runs
// single-query GQA attention for the G query heads that share one KV head:
// q * (1/sqrt(hd)) in fp32, fp32 scores, a -1e30 mask, fp32 softmax
// (p = exp(s - max) / sum), p . V in fp32, the result cast to q's dtype.
//
// What bounds it on an H100: device-memory bytes.  A step reads the K and V
// rows it attends over once and does 4*G flops per element read (G = 4 on
// qwen3-4b), far under the ~295 flops/byte where the tensor cores would
// become the limit.  So the design is about bytes:
//   - one block per (row, KV head) covers all G query heads of that head,
//     so each K/V row is read from memory once, not G times;
//   - a warp reads whole cache rows (hd contiguous elements, 8 or 16 bytes
//     a lane), so loads are coalesced and vectorised, and keeps kRows rows
//     in flight at once, with 8 warps a block, so that one block per
//     (row, head) keeps enough loads in flight to cover memory latency;
//   - masked positions read no K, and positions whose softmax weight is
//     exactly 0 read no V: a ring cache is read only where it is valid, a
//     page table only up to the slot's position;
//   - scores live in shared memory (G * positions floats), never in
//     device memory.
// The new row is *overlaid* at its position from registers: no block ever
// reads back its own store, so the store and the attention cannot race.
// That is also what makes the paged kernel's garbage page safe: every
// inactive slot writes page 0, offset 0 from its own block at once, and
// none of them reads that row.
//
// C interface (bound with ctypes): each launcher returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 4;  // cache rows one warp keeps in flight
constexpr float kNegInf = -1e30f;  // the mask value of the JAX kernels

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// Load E contiguous elements (this lane's share of one hd-row) as fp32.
// The wrapper checks 16-byte alignment of every base pointer, and hd * size
// is a multiple of 16 bytes, so each lane's slice is aligned to its width.
template <typename T, int E>
__device__ __forceinline__ void load_row(const T* __restrict__ p, float (&out)[E]) {
  constexpr int kBytes = E * (int)sizeof(T);
  if constexpr (kBytes % 16 == 0) {
#pragma unroll
    for (int chunk = 0; chunk < kBytes / 16; ++chunk) {
      uint4 raw = reinterpret_cast<const uint4*>(p)[chunk];
      const T* t = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int e = 0; e < 16 / (int)sizeof(T); ++e) out[chunk * (16 / sizeof(T)) + e] = to_f(t[e]);
    }
  } else if constexpr (kBytes == 8) {
    uint2 raw = *reinterpret_cast<const uint2*>(p);
    const T* t = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int e = 0; e < E; ++e) out[e] = to_f(t[e]);
  } else if constexpr (kBytes == 4) {
    uint32_t raw = *reinterpret_cast<const uint32_t*>(p);
    const T* t = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int e = 0; e < E; ++e) out[e] = to_f(t[e]);
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) out[e] = to_f(p[e]);
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Softmax in place over scores[g * stride + c], c < n, for every g: one warp
// per head, the same op order as the JAX kernel (max, exp(s - max), sum,
// divide).
template <int G>
__device__ __forceinline__ void softmax_rows(float* scores, int stride, int n) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int g = warp; g < G; g += kWarps) {
    float* s = scores + (size_t)g * stride;
    float m = kNegInf;
    for (int c = lane; c < n; c += 32) m = fmaxf(m, s[c]);
    m = warp_max(m);
    float l = 0.f;
    for (int c = lane; c < n; c += 32) {
      float p = expf(s[c] - m);
      s[c] = p;
      l += p;
    }
    l = warp_sum(l);
    for (int c = lane; c < n; c += 32) s[c] = s[c] / l;
  }
}

// The attention of one (row, KV head) block once its scores are known: the
// caller passes functors k_row(c) / v_row(c) giving the cache rows of
// position c (nullptr for the overlaid new row).  Writes the G x HD output.
template <typename T, int HD, int G, typename KRow, typename VRow>
__device__ __forceinline__ void attend(const float (&qr)[G][HD / 32], const float (&kn)[HD / 32],
                                       const float (&vn)[HD / 32], const int* __restrict__ valid,
                                       int n, KRow k_row, VRow v_row, float* scores,
                                       float* red, T* __restrict__ out) {
  constexpr int E = HD / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // scores: each warp keeps kRows cache rows in flight
  for (int base = warp * kRows; base < n; base += kWarps * kRows) {
    float kr[kRows][E];
    bool live[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int c = base + r;
      live[r] = c < n && (valid == nullptr || valid[c] == 1);
      if (live[r]) {
        const T* kp = k_row(c);
        if (kp == nullptr) {
#pragma unroll
          for (int e = 0; e < E; ++e) kr[r][e] = kn[e];
        } else {
          load_row<T, E>(kp + lane * E, kr[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int c = base + r;
      if (c >= n) break;
      float s[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (live[r]) {
          float d = 0.f;
#pragma unroll
          for (int e = 0; e < E; ++e) d = fmaf(qr[g][e], kr[r][e], d);
          s[g] = warp_sum(d);
        } else {
          s[g] = kNegInf;  // masked: no K read
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int g = 0; g < G; ++g) scores[(size_t)g * n + c] = s[g];
      }
    }
  }
  __syncthreads();
  softmax_rows<G>(scores, n, n);
  __syncthreads();
  // p . V: rows whose weight is exactly 0 for every head are skipped
  float acc[G][E];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  for (int base = warp * kRows; base < n; base += kWarps * kRows) {
    float vr[kRows][E], pc[kRows][G];
    bool live[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int c = base + r;
      live[r] = false;
      if (c < n) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          pc[r][g] = scores[(size_t)g * n + c];
          live[r] |= pc[r][g] != 0.f;
        }
      }
      if (live[r]) {
        const T* vp = v_row(c);
        if (vp == nullptr) {
#pragma unroll
          for (int e = 0; e < E; ++e) vr[r][e] = vn[e];
        } else {
          load_row<T, E>(vp + lane * E, vr[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (!live[r]) continue;
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] = fmaf(pc[r][g], vr[r][e], acc[g][e]);
    }
  }
  // sum the warps' partial outputs, in warp order
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < E; ++e) red[((size_t)warp * G + g) * HD + lane * E + e] = acc[g][e];
  __syncthreads();
  for (int i = threadIdx.x; i < G * HD; i += kThreads) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) o += red[(size_t)w * G * HD + i];
    store_f(out + i, o);
  }
}

template <typename T, int HD, int G>
__device__ __forceinline__ void load_q_and_new(const T* __restrict__ qp, const T* __restrict__ knp,
                                               const T* __restrict__ vnp, float scale,
                                               float (&qr)[G][HD / 32], float (&kn)[HD / 32],
                                               float (&vn)[HD / 32]) {
  constexpr int E = HD / 32;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    load_row<T, E>(qp + (size_t)g * HD + lane * E, qr[g]);
#pragma unroll
    for (int e = 0; e < E; ++e) qr[g][e] *= scale;  // q.astype(f32) * scale
  }
  load_row<T, E>(knp + lane * E, kn);
  load_row<T, E>(vnp + lane * E, vn);
}

// ---------------------------------------------------------------------------
// ring-cache decode step: grid (N rows, KV heads)
// ---------------------------------------------------------------------------
template <typename T, int HD, int G>
__global__ void __launch_bounds__(kThreads)
decode_step_kernel(const T* __restrict__ q, const T* __restrict__ k_new,
                   const T* __restrict__ v_new, T* __restrict__ k_cache,
                   T* __restrict__ v_cache, T* __restrict__ out,
                   const int* __restrict__ valid, int slot, int smax, int KV, float scale) {
  extern __shared__ float smem[];
  float* scores = smem;                      // (G, smax)
  float* red = smem + (size_t)G * smax;      // (kWarps, G, HD)
  const int n = blockIdx.x, h = blockIdx.y;
  const size_t head = (size_t)n * KV + h;
  const size_t row_stride = (size_t)KV * HD;  // one cache position
  const T* knp = k_new + head * HD;
  const T* vnp = v_new + head * HD;
  T* kc = k_cache + (size_t)n * smax * row_stride + (size_t)h * HD;
  T* vc = v_cache + (size_t)n * smax * row_stride + (size_t)h * HD;

  float qr[G][HD / 32], kn[HD / 32], vn[HD / 32];
  load_q_and_new<T, HD, G>(q + head * G * HD, knp, vnp, scale, qr, kn, vn);
  // this block owns row (n, slot, h): store it; it is never read back
  for (int i = threadIdx.x; i < HD; i += kThreads) {
    kc[(size_t)slot * row_stride + i] = knp[i];
    vc[(size_t)slot * row_stride + i] = vnp[i];
  }
  auto k_row = [&](int c) -> const T* { return c == slot ? nullptr : kc + (size_t)c * row_stride; };
  auto v_row = [&](int c) -> const T* { return c == slot ? nullptr : vc + (size_t)c * row_stride; };
  attend<T, HD, G>(qr, kn, vn, valid, smax, k_row, v_row, scores, red, out + head * G * HD);
}

// ---------------------------------------------------------------------------
// paged decode step: grid (C chains * S slots, KV heads)
// ---------------------------------------------------------------------------
template <typename T, int HD, int G>
__global__ void __launch_bounds__(kThreads)
paged_decode_step_kernel(const T* __restrict__ q, const T* __restrict__ k_new,
                         const T* __restrict__ v_new, T* __restrict__ k_pages,
                         T* __restrict__ v_pages, T* __restrict__ out,
                         const int* __restrict__ tables, const int* __restrict__ pos,
                         int S, int n_pages, int ps, int maxp, int KV, float scale) {
  extern __shared__ float smem[];
  const int cs = blockIdx.x, h = blockIdx.y;
  const int c = cs / S, s = cs % S;
  const size_t head = (size_t)cs * KV + h;
  const size_t row_stride = (size_t)KV * HD;  // one pool row (page, offset)
  const size_t pool = (size_t)n_pages * ps * row_stride;
  T* kp = k_pages + (size_t)c * pool + (size_t)h * HD;
  T* vp = v_pages + (size_t)c * pool + (size_t)h * HD;
  const int* tbl = tables + (size_t)s * maxp;
  T* o = out + head * G * HD;
  const int p = pos[s];

  // a position or page id outside the pool would address memory the slot
  // does not own: refuse the block (NaN output, no store) instead
  int bad = (p < 0 || p >= maxp * ps) ? 1 : 0;
  if (!bad)
    for (int j = threadIdx.x; j <= p / ps; j += kThreads)
      bad |= (unsigned)tbl[j] >= (unsigned)n_pages;
  if (__syncthreads_or(bad)) {
    for (int i = threadIdx.x; i < G * HD; i += kThreads) store_f(o + i, __int_as_float(0x7fc00000));
    return;
  }

  const int n = p + 1;                      // logical positions 0..p
  float* scores = smem;                     // (G, n)
  float* red = smem + (size_t)G * maxp * ps;  // (kWarps, G, HD)
  const T* knp = k_new + head * HD;
  const T* vnp = v_new + head * HD;
  float qr[G][HD / 32], kn[HD / 32], vn[HD / 32];
  load_q_and_new<T, HD, G>(q + head * G * HD, knp, vnp, scale, qr, kn, vn);
  // one row per slot: (tables[s, p / ps], p % ps); garbage-page writers race
  // benignly, since no block reads that row back
  const size_t wrow = (size_t)tbl[p / ps] * ps + p % ps;
  for (int i = threadIdx.x; i < HD; i += kThreads) {
    kp[wrow * row_stride + i] = knp[i];
    vp[wrow * row_stride + i] = vnp[i];
  }
  // logical order through the page table; the new row overlaid at p
  auto k_row = [&](int t) -> const T* {
    return t == p ? nullptr : kp + ((size_t)tbl[t / ps] * ps + t % ps) * row_stride;
  };
  auto v_row = [&](int t) -> const T* {
    return t == p ? nullptr : vp + ((size_t)tbl[t / ps] * ps + t % ps) * row_stride;
  };
  attend<T, HD, G>(qr, kn, vn, nullptr, n, k_row, v_row, scores, red, o);
}

template <typename T, int HD, int G>
cudaError_t launch_decode(const void* q, const void* k_new, const void* v_new, void* k_cache,
                          void* v_cache, void* out, const int* valid, int slot, int N, int smax,
                          int KV, float scale, size_t smem, cudaStream_t stream) {
  auto kernel = decode_step_kernel<T, HD, G>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(N, KV), kThreads, smem, stream>>>(
      (const T*)q, (const T*)k_new, (const T*)v_new, (T*)k_cache, (T*)v_cache, (T*)out, valid,
      slot, smax, KV, scale);
  return cudaGetLastError();
}

template <typename T, int HD, int G>
cudaError_t launch_paged(const void* q, const void* k_new, const void* v_new, void* k_pages,
                         void* v_pages, void* out, const int* tables, const int* pos, int C, int S,
                         int n_pages, int ps, int maxp, int KV, float scale, size_t smem,
                         cudaStream_t stream) {
  auto kernel = paged_decode_step_kernel<T, HD, G>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(C * S, KV), kThreads, smem, stream>>>(
      (const T*)q, (const T*)k_new, (const T*)v_new, (T*)k_pages, (T*)v_pages, (T*)out, tables,
      pos, S, n_pages, ps, maxp, KV, scale);
  return cudaGetLastError();
}

// dispatch over (dtype, HD, G): dtype 0 = float32, 1 = bfloat16
#define DISPATCH_G(T, HD, FN, ...)                          \
  switch (G) {                                              \
    case 1: return FN<T, HD, 1>(__VA_ARGS__);               \
    case 2: return FN<T, HD, 2>(__VA_ARGS__);               \
    case 4: return FN<T, HD, 4>(__VA_ARGS__);               \
    case 8: return FN<T, HD, 8>(__VA_ARGS__);               \
    default: return cudaErrorInvalidValue;                  \
  }
#define DISPATCH_HD(T, FN, ...)                             \
  switch (HD) {                                             \
    case 64: DISPATCH_G(T, 64, FN, __VA_ARGS__)             \
    case 128: DISPATCH_G(T, 128, FN, __VA_ARGS__)           \
    default: return cudaErrorInvalidValue;                  \
  }
#define DISPATCH(FN, ...)                                   \
  switch (dtype) {                                          \
    case 0: DISPATCH_HD(float, FN, __VA_ARGS__)             \
    case 1: DISPATCH_HD(__nv_bfloat16, FN, __VA_ARGS__)     \
    default: return cudaErrorInvalidValue;                  \
  }

}  // namespace

extern "C" size_t decode_step_smem_bytes(int smax, int G, int HD) {
  return ((size_t)G * smax + (size_t)kWarps * G * HD) * sizeof(float);
}

extern "C" int decode_step_launch(const void* q, const void* k_new, const void* v_new,
                                  void* k_cache, void* v_cache, void* out, const void* valid,
                                  int slot, int N, int smax, int KV, int G, int HD, int dtype,
                                  float scale, void* stream) {
  const size_t smem = decode_step_smem_bytes(smax, G, HD);
  DISPATCH(launch_decode, q, k_new, v_new, k_cache, v_cache, out, (const int*)valid, slot, N,
           smax, KV, scale, smem, (cudaStream_t)stream)
  return cudaErrorInvalidValue;
}

extern "C" int paged_decode_step_launch(const void* q, const void* k_new, const void* v_new,
                                        void* k_pages, void* v_pages, void* out,
                                        const void* tables, const void* pos, int C, int S,
                                        int n_pages, int ps, int maxp, int KV, int G, int HD,
                                        int dtype, float scale, void* stream) {
  const size_t smem = decode_step_smem_bytes(maxp * ps, G, HD);
  DISPATCH(launch_paged, q, k_new, v_new, k_pages, v_pages, out, (const int*)tables,
           (const int*)pos, C, S, n_pages, ps, maxp, KV, scale, smem, (cudaStream_t)stream)
  return cudaErrorInvalidValue;
}
