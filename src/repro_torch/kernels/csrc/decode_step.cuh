// Fused single-token decode steps for the chain-bank BMA server, for sm_90a:
// split-KV ("flash-decoding") kernels.
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/decode_step.py:
//   decode_step_kernel        <- decode_step_2d    (_kernel, ring KV cache)
//   paged_decode_step_kernel  <- paged_decode_step (_paged_kernel, page pool)
//
// Each step writes this token's k/v row into the cache in place, then runs
// single-query GQA attention for the G query heads that share one KV head:
// fp32 scores scaled by 1/sqrt(hd), masked positions weigh 0 (the JAX
// kernels' -1e30), fp32 softmax, p . V accumulated in fp32, the result cast
// to q's dtype.
//
// What bounds it on an H100: device-memory bytes.  A step reads each K and V
// row it attends over once and does 4*G flops per element read (G = 4 on
// qwen3-4b), far under the ~295 flops/byte where arithmetic would become the
// limit.  Reaching 3.35 TB/s takes many blocks with loads in flight on all
// 132 SMs, and few instructions per byte, so the design is about
// parallelism, bytes in flight and a lean inner loop:
//   - split-KV: the positions of each (row or slot, KV head) are cut into up
//     to kMaxSplits splits, one block each.  The split plan depends on the
//     shapes alone and has one owner, kernels/decode_step.py, which passes
//     it in (a ring's splits and chunk; a pool's splits and the least and
//     most pages a split takes), so the output is deterministic.  A ring
//     chunk is a fixed run of positions; a paged chunk is a run of whole
//     pages whose length the block derives from its slot's `pos`, so a long
//     slot is spread over the splits instead of running alone;
//   - K and V tiles (kTile positions of one head: rows hd elements long at a
//     stride of KV*hd) stream into shared memory with cp.async, both
//     requested together, kStages deep: the next tile is in flight while
//     this one is used.  Rows that are masked or past the chunk are
//     zero-filled without a read; rows are padded by 16 bytes, so 16-byte
//     and ldmatrix reads of 8 rows hit 8 different bank groups;
//   - bf16 runs both products on the tensor cores (mma.sync m16n8k16, fp32
//     accumulation), with no per-row warp reductions: scores = K . q^T (q
//     unscaled in bf16, the G heads padded to 8, the scale applied to the
//     fp32 score), and O^T += V^T . P^T, V^T through ldmatrix.trans and
//     each weight split into a bf16 pair hi + lo, so P keeps about 16
//     significant bits.  f32 stays on the CUDA cores, fp32 FMAs (TF32
//     would miss 1e-5): a thread owns a (head, position) dot product over
//     the K row in shared memory, then a 16-byte column slice of p . V;
//   - an online softmax over the tiles (running max m, sum l, and the fp32
//     accumulator rescaled per tile), one warp a head;
//   - the splits are merged inside the same launch: each block writes its
//     (m, l, acc) to an fp32 scratch buffer the wrapper allocates, then
//     bumps a per-(row, head) arrival counter; the last block to arrive
//     loads every split's (m, l) at once, merges the splits in split order
//     (an empty split weighs 0) and resets the counter.  One launch a call,
//     no float atomics, the same bits on every call.  The counters are the
//     caller's: zero before the launch, zero again after it;
//   - short paged slots: splits past a slot's pages exit at once, and a
//     slot with one live split writes its output without the scratch
//     round trip;
//   - the page table is read once per page: the chunk's page ids into
//     shared memory, in the same pass that checks them.
// Shared memory per block depends on the tile and the number of heads, not
// on the cache length: a 16,384-slot ring and a 32,768-token window run.
//
// The new row is taken from k_new / v_new wherever the step attends to it
// (the cache row at its position is never read), and exactly one block of
// each (row, head), split 0, stores it.  So no block reads a row stored in
// this launch, and the inactive slots of the paged kernel, which all write
// page 0, offset 0 at once, race only on a row nobody reads.
//
// C interface (bound with ctypes): each launcher returns cudaGetLastError().
// One library a dtype: decode_step_bf16.cu and decode_step_f32.cu include this
// file with DECODE_STEP_T (the element type) and DECODE_STEP_DTYPE (its code,
// 0 = float32, 1 = bfloat16) defined, so nvcc builds the two halves of the
// (dtype, head_dim, group) instantiations at once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;       // positions a tile
constexpr int kStages = 2;      // tiles in flight a block
constexpr int kMaxSplits = 16;  // splits per (row, head)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// A head_dim need not divide the block: at hd 112 or 160 a row is 14 or 20
// (bf16), 28 or 40 (f32) 16-byte copies, and the copies walk the tile's
// (row, copy) pairs in one flat loop.  In f32's p . V the first
// kRowGroups * kSegs threads own a column slice each (kRowGroups row groups)
// and the rest sit the product out: 112 of 128 threads at hd 112, 120 at
// hd 160.
template <typename T, int HD>
struct Shape {
  static constexpr int kVec = 16 / (int)sizeof(T);          // elements a 16-byte copy
  static constexpr int kSegs = HD / kVec;                    // 16-byte copies a row
  static constexpr int kRowBytes = HD * (int)sizeof(T) + 16; // padded row in shared memory
  static constexpr int kTileBytes = kTile * kRowBytes;
  static constexpr int kRowGroups = kThreads / kSegs;        // p . V: threads a column slice
  static_assert(HD % kVec == 0 && kSegs <= kThreads && kRowGroups <= kTile, "tile shape");
  static_assert(kTile % 32 == 0 && kTile >= kMaxSplits, "a warp's lanes share a tile's "
                "scores, and the merge keeps its weights in the scores' place");
};

// Shared memory of one block, in bytes; decode_step.py::smem_bytes mirrors
// it.  First the K/V tiles, which the block's final reduction reuses, then
// q (f32 only: bf16 keeps it in registers), the scores, the row flags, the
// splits' (m, l), (m, l, alpha), a flag, and the paged kernel's chunk of the
// page table.  At bf16, G = 4, hd 128 a block takes 36,160 bytes, so six
// fit an SM (with the 1 KB the hardware reserves for each).  The reduction
// region holds floor(kThreads / kSegs) row groups, the threads that own a
// column slice in p . V.
__host__ __device__ constexpr size_t tile_region_bytes(int G, int HD, int elem) {
  const size_t tiles = (size_t)kStages * 2 * kTile * (HD * elem + 16);
  const size_t red = (size_t)(kThreads / (HD * elem / 16)) * G * HD * 4;
  return tiles > red ? tiles : red;
}
__host__ __device__ constexpr size_t smem_layout_bytes(int G, int HD, int elem, int max_pages) {
  return tile_region_bytes(G, HD, elem) +
         4 * ((elem == 4 ? (size_t)G * HD : 0) + G * kTile + kStages * kTile +
              2 * G * kMaxSplits + 3 * G + 4 + max_pages);
}

// Load 16 bytes (kVec elements) as fp32.
template <typename T>
__device__ __forceinline__ void load_vec(const void* p, float (&out)[16 / sizeof(T)]) {
  uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* t = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int e = 0; e < (int)(16 / sizeof(T)); ++e) out[e] = to_f(t[e]);
}

// 16-byte asynchronous copy global -> shared; `ok` false zero-fills the
// destination without reading `src`.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ldmatrix: four 8x8 b16 matrices from shared memory, lane i giving the
// address of row i % 8 of matrix i / 8 (.trans: each delivered transposed)
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* row) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* row) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
// d += a . b, m16n8k16, bf16 inputs, fp32 accumulation
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// One block's attention over the positions [t0, t1) of one (row, head), and
// the merge of the splits.  `row(t, kp, vp)` says whether position t is
// attended to and where its K and V rows are (the new row for the step's own
// position).  part: this launch's scratch, (heads * splits) partials of
// G * HD floats, then (heads * splits) of 2 * G floats (m, l).
template <typename A>
using acc_row_t = typename std::remove_extent<A>::type;

template <typename T, int HD, int G>
struct SplitAttention {
  using S = Shape<T, HD>;
  static constexpr int kVec = S::kVec;
  unsigned char* kv;  // kStages x {K, V} tiles; after the loop, the reduction buffer
  float* q_s;         // (G, HD) q * scale (f32)
  float* p_s;         // (G, kTile) scores, then weights
  int* ok_s;          // (kStages, kTile) row attended to
  float* w_s;         // (kMaxSplits, 2, G) the splits' (m, l) in the merge
  float* m_s;         // (G) running max
  float* l_s;         // (G) running sum
  float* a_s;         // (G) this tile's rescale factor
  int* flag_s;
  int* pages_s;       // the paged kernel's chunk of the page table

  __device__ explicit SplitAttention(unsigned char* smem) {
    kv = smem;
    q_s = reinterpret_cast<float*>(smem + tile_region_bytes(G, HD, sizeof(T)));
    p_s = q_s + (sizeof(T) == 4 ? G * HD : 0);
    ok_s = reinterpret_cast<int*>(p_s + G * kTile);
    w_s = reinterpret_cast<float*>(ok_s + kStages * kTile);
    m_s = w_s + 2 * G * kMaxSplits;
    l_s = m_s + G;
    a_s = l_s + G;
    flag_s = reinterpret_cast<int*>(a_s + G);
    pages_s = flag_s + 4;
  }

  // bf16 runs both products on the tensor cores; f32 on the CUDA cores.
  // p . V's HD / 16 row tiles of 16 go round the warps: warp w owns tiles
  // w, w + kWarps, ..., so at hd 112 (7 tiles) warps 0-2 take two and warp
  // 3 one, at hd 160 (10 tiles) warps 0-1 take three and 2-3 two.  Whether
  // a warp has its mt-th tile is the same for all its lanes, so the mma
  // instructions stay warp-uniform.
  static constexpr bool kMma = sizeof(T) == 2;
  static constexpr int kHdTiles = HD / 16;                       // mma: 16-row hd tiles
  static constexpr int kMt = (kHdTiles + kWarps - 1) / kWarps;   // ... a warp, at most
  static_assert(!kMma || (HD % 16 == 0 && kTile % 16 == 0 && G <= 8), "mma shape");
  __device__ __forceinline__ static int hd_tile(int warp, int mt) { return mt * kWarps + warp; }
  unsigned qb[HD / 16][2];  // mma: q as the B operand (n = head, padded to 8)
  float scale;

  // q and the running (m, l).  f32: q * scale in shared memory, the
  // reference's q.astype(f32) * scale.  bf16: q unscaled in registers, in
  // mma.sync's B layout, and the scale applied to each fp32 score.
  __device__ __forceinline__ void load_q(const T* __restrict__ qp, float scale_) {
    scale = scale_;
    if constexpr (kMma) {
      const int lane = threadIdx.x % 32, n = lane / 4, k = (lane % 4) * 2;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        qb[kk][0] = n < G ? *reinterpret_cast<const unsigned*>(qp + n * HD + kk * 16 + k) : 0u;
        qb[kk][1] = n < G ? *reinterpret_cast<const unsigned*>(qp + n * HD + kk * 16 + k + 8) : 0u;
      }
    } else {
      for (int i = threadIdx.x; i < G * S::kSegs; i += kThreads) {
        float f[kVec];
        load_vec<T>(qp + (size_t)i * kVec, f);
#pragma unroll
        for (int e = 0; e < kVec; ++e) q_s[i * kVec + e] = f[e] * scale;
      }
    }
    if (threadIdx.x < G) {
      m_s[threadIdx.x] = -INFINITY;
      l_s[threadIdx.x] = 0.f;
    }
  }

  template <typename Row>
  __device__ __forceinline__ void issue(int stage, int t_base, Row row, const T* any_ptr) {
    unsigned char* ks = kv + (size_t)stage * 2 * S::kTileBytes;
    unsigned char* vs = ks + S::kTileBytes;
    for (int i = threadIdx.x; i < kTile * S::kSegs; i += kThreads) {
      const int r = i / S::kSegs, seg = i % S::kSegs;
      const T* kp = any_ptr;
      const T* vp = any_ptr;
      const bool ok = row(t_base + r, kp, vp);
      cp_async16(ks + r * S::kRowBytes + seg * 16, ok ? kp + seg * kVec : any_ptr, ok);
      cp_async16(vs + r * S::kRowBytes + seg * 16, ok ? vp + seg * kVec : any_ptr, ok);
      if (seg == 0) ok_s[stage * kTile + r] = ok;
    }
  }

  // scores of one tile into p_s: masked rows get -inf
  __device__ __forceinline__ void scores(const unsigned char* ks, const int* ok) {
    if constexpr (kMma) {
      // S (positions x heads) = K (positions x hd) . q^T: one 16-position
      // m-tile a warp, fp32 accumulation
      const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
      for (int mt = warp; mt < kTile / 16; mt += kWarps) {
        const int m0 = mt * 16;
        const int mi = lane / 8, r = lane % 8;
        float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          unsigned a[4];
          ldmatrix_x4(a, ks + (m0 + r + (mi & 1) * 8) * S::kRowBytes + (kk * 16 + (mi >> 1) * 8) * 2);
          mma_bf16(d, a, qb[kk][0], qb[kk][1]);
        }
        const int gid = lane / 4, tig = lane % 4;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int m = m0 + gid + (i / 2) * 8, n = tig * 2 + (i % 2);
          if (n < G) p_s[n * kTile + m] = ok[m] ? d[i] * scale : -INFINITY;
        }
      }
    } else {
      // one (head, position) a thread, the whole dot product
      for (int i = threadIdx.x; i < G * kTile; i += kThreads) {
        const int g = i / kTile, r = i % kTile;
        float s = -INFINITY;
        if (ok[r]) {
          const unsigned char* krow = ks + r * S::kRowBytes;
          const float* qg = q_s + g * HD;
          float d[kVec];  // kVec independent sums: no chain of HD dependent FMAs
#pragma unroll
          for (int e = 0; e < kVec; ++e) d[e] = 0.f;
#pragma unroll
          for (int c = 0; c < S::kSegs; ++c) {
            float kf[kVec];
            load_vec<T>(krow + c * 16, kf);
#pragma unroll
            for (int e = 0; e < kVec; ++e) d[e] = fmaf(qg[c * kVec + e], kf[e], d[e]);
          }
#pragma unroll
          for (int w = kVec / 2; w > 0; w /= 2)
#pragma unroll
            for (int e = 0; e < w; ++e) d[e] += d[e + w];
          s = d[0];
        }
        p_s[i] = s;
      }
    }
  }

  // online softmax over one tile: one warp a head, kTile / 32 positions a lane;
  // leaves the weights in p_s and each head's rescale factor in a_s
  __device__ __forceinline__ void softmax(const int* ok) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    constexpr int kPer = kTile / 32;  // positions a lane
    for (int g = warp; g < G; g += kWarps) {
      float s[kPer];
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        s[j] = ok[lane + 32 * j] ? p_s[g * kTile + lane + 32 * j] : -INFINITY;
        mt = fmaxf(mt, s[j]);
      }
      const float mo = m_s[g];
      const float mn = fmaxf(mo, warp_max(mt));
      // mo == mn covers a tile with nothing attended to before any other
      const float alpha = mo == mn ? 1.f : expf(mo - mn);
      float lt = 0.f;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const float p = ok[lane + 32 * j] ? expf(s[j] - mn) : 0.f;
        p_s[g * kTile + lane + 32 * j] = p;
        lt += p;
      }
      lt = warp_sum(lt);
      if (lane == 0) {
        m_s[g] = mn;
        l_s[g] = fmaf(l_s[g], alpha, lt);
        a_s[g] = alpha;
      }
    }
  }

  // f32: p . V on the CUDA cores, a thread owning a 16-byte column slice of
  // every kRowGroups-th row
  __device__ __forceinline__ void pv(const unsigned char* vs, const int* ok, float (&acc)[G][kVec]) {
    const int cv = threadIdx.x % S::kSegs, rg = threadIdx.x / S::kSegs;
    if (rg >= S::kRowGroups) return;  // past the last whole row group
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float a = a_s[g];
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[g][e] *= a;
    }
    for (int r = rg; r < kTile; r += S::kRowGroups) {
      if (!ok[r]) continue;
      float vf[kVec];
      load_vec<T>(vs + r * S::kRowBytes + cv * 16, vf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = p_s[g * kTile + r];
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
      }
    }
  }

  // bf16: O^T (hd x heads) += V^T (hd x positions) . P^T on the tensor
  // cores, V^T through ldmatrix.trans; each weight goes in as a bf16 pair
  // hi + lo (about 16 significant bits; a single bf16 would keep 8), fp32
  // accumulation.  A warp owns up to kMt 16-row hd tiles (hd_tile).
  __device__ __forceinline__ void pv_mma(const unsigned char* vs, float (&acc)[kMt][4]) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int gid = lane / 4, tig = lane % 4, mi = lane / 8, r = lane % 8;
#pragma unroll
    for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][i] *= tig * 2 + (i % 2) < G ? a_s[tig * 2 + (i % 2)] : 1.f;
#pragma unroll
    for (int ks = 0; ks < kTile / 16; ++ks) {
      unsigned hi[2], lo[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int k = ks * 16 + tig * 2 + j * 8;
        const float p0 = gid < G ? p_s[gid * kTile + k] : 0.f;
        const float p1 = gid < G ? p_s[gid * kTile + k + 1] : 0.f;
        const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
        const __nv_bfloat162 l = __floats2bfloat162_rn(p0 - __low2float(h), p1 - __high2float(h));
        hi[j] = *reinterpret_cast<const unsigned*>(&h);
        lo[j] = *reinterpret_cast<const unsigned*>(&l);
      }
#pragma unroll
      for (int mt = 0; mt < kMt; ++mt) {
        if (hd_tile(warp, mt) >= kHdTiles) break;
        const int m0 = hd_tile(warp, mt) * 16;
        unsigned a[4];
        ldmatrix_x4_trans(a, vs + (ks * 16 + (mi >> 1) * 8 + r) * S::kRowBytes + (m0 + (mi & 1) * 8) * 2);
        mma_bf16(acc[mt], a, hi[0], hi[1]);
        mma_bf16(acc[mt], a, lo[0], lo[1]);
      }
    }
  }

  template <typename Acc>
  __device__ __forceinline__ void compute(int stage, Acc& acc) {
    const unsigned char* ks = kv + (size_t)stage * 2 * S::kTileBytes;
    const int* ok = ok_s + stage * kTile;
    scores(ks, ok);
    __syncthreads();
    softmax(ok);
    __syncthreads();
    if constexpr (kMma)
      pv_mma(ks + S::kTileBytes, acc);
    else
      pv(ks + S::kTileBytes, ok, acc);
  }

  // The block's p . V (G x HD, before dividing by l): with acc_out, into
  // device memory for the merge; without, divided by l into out.
  __device__ __forceinline__ void finish(float (&acc)[G][kVec], float* __restrict__ acc_out, T* __restrict__ out) {
    // sum the row groups' accumulators, in row-group order
    float* red = reinterpret_cast<float*>(kv);  // (kRowGroups, G, HD)
    const int cv = threadIdx.x % S::kSegs, rg = threadIdx.x / S::kSegs;
    if (rg < S::kRowGroups)
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int e = 0; e < kVec; ++e) red[((size_t)rg * G + g) * HD + cv * kVec + e] = acc[g][e];
    __syncthreads();
    for (int i = threadIdx.x; i < G * HD; i += kThreads) {
      float o = 0.f;
#pragma unroll
      for (int w = 0; w < S::kRowGroups; ++w) o += red[(size_t)w * G * HD + i];
      if (acc_out != nullptr)
        acc_out[i] = o;
      else
        store_f(out + i, o / l_s[i / HD]);
    }
  }
  __device__ __forceinline__ void finish_mma(float (&acc)[kMt][4], float* __restrict__ acc_out,
                             T* __restrict__ out) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gid = lane / 4, tig = lane % 4;
#pragma unroll
    for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = tig * 2 + (i % 2), m = hd_tile(warp, mt) * 16 + gid + (i / 2) * 8;
        if (n >= G || hd_tile(warp, mt) >= kHdTiles) continue;
        if (acc_out != nullptr)
          acc_out[n * HD + m] = acc[mt][i];
        else
          store_f(out + n * HD + m, acc[mt][i] / l_s[n]);
      }
  }

  // The tiles of [t0, t1), kStages deep, then finish(); leaves (m, l) in
  // m_s / l_s.  With acc_out, the block's sum of p . V goes there (G * HD
  // floats in device memory, for the merge); without, this block is the
  // only one with work for its (row, head) and writes the attention to out.
  template <typename Row>
  __device__ __forceinline__ void run(int t0, int t1, Row row, const T* any_ptr, float* __restrict__ acc_out,
                      T* __restrict__ out) {
    using Acc = typename std::conditional<kMma, float[kMt][4], float[G][kVec]>::type;
    constexpr int kRows = sizeof(Acc) / sizeof(acc_row_t<Acc>);
    constexpr int kCols = sizeof(acc_row_t<Acc>) / sizeof(float);
    Acc acc;
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
    const int n_tiles = (t1 - t0 + kTile - 1) / kTile;
    // kStages - 1 tiles ahead in flight; one commit group a tile (empty
    // groups past the end keep the count)
#pragma unroll
    for (int st = 0; st < kStages - 1; ++st) {
      if (st < n_tiles) issue(st, t0 + st * kTile, row, any_ptr);
      cp_async_commit();
    }
    for (int it = 0; it < n_tiles; ++it) {
      const int ahead = it + kStages - 1;
      if (ahead < n_tiles) issue(ahead % kStages, t0 + ahead * kTile, row, any_ptr);
      cp_async_commit();
      cp_async_wait<kStages - 1>();
      __syncthreads();
      compute(it % kStages, acc);
      __syncthreads();
    }
    cp_async_wait<0>();
    if constexpr (kMma)
      finish_mma(acc, acc_out, out);
    else
      finish(acc, acc_out, out);
  }

  // Write this split's (m, l) (l = 0: nothing attended to), arrive, and if
  // this block is the last of the `live` splits of its (row, head), merge
  // them in split order into out and reset the counter.  Returns whether
  // this block merged and found every split empty (the ring's all-masked
  // case).
  __device__ __forceinline__ bool arrive_and_merge(float* __restrict__ part, unsigned* __restrict__ counters,
                                   size_t head, int split, int splits, int live,
                                   size_t n_heads, T* __restrict__ out) {
    float* ml = part + n_heads * splits * G * HD;  // (heads, splits, 2, G)
    const float* hml = ml + head * splits * 2 * G;
    if (threadIdx.x < G) {
      float* mine = ml + (head * splits + split) * 2 * G;
      mine[threadIdx.x] = m_s[threadIdx.x];
      mine[G + threadIdx.x] = l_s[threadIdx.x];
    }
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) flag_s[0] = atomicAdd(counters + head, 1u) == (unsigned)live - 1;
    __syncthreads();
    if (!flag_s[0]) return false;
    __threadfence();
    // every split's (m, l) at once, then the weights exp(m_j - M)
    for (int i = threadIdx.x; i < live * 2 * G; i += kThreads) w_s[i] = __ldcg(hml + i);
    if (threadIdx.x == 0) counters[head] = 0u;  // every split has arrived
    __syncthreads();
    if (threadIdx.x < G) {
      const int g = threadIdx.x;
      float M = -INFINITY;
      for (int j = 0; j < live; ++j)
        if (w_s[j * 2 * G + G + g] > 0.f) M = fmaxf(M, w_s[j * 2 * G + g]);
      float L = 0.f;
      for (int j = 0; j < live; ++j) {
        const float l = w_s[j * 2 * G + G + g];
        const float w = l > 0.f ? expf(w_s[j * 2 * G + g] - M) : 0.f;
        p_s[g * kMaxSplits + j] = w;
        L = fmaf(l, w, L);
      }
      l_s[g] = L;
    }
    __syncthreads();
    if (!(l_s[0] > 0.f)) return true;
    const float* hacc = part + head * splits * G * HD;
    for (int i = threadIdx.x; i < G * HD; i += kThreads) {
      const int g = i / HD;
      float v[kMaxSplits];
#pragma unroll
      for (int j = 0; j < kMaxSplits; ++j)  // all loads in flight at once
        v[j] = j < live && p_s[g * kMaxSplits + j] > 0.f ? __ldcg(hacc + (size_t)j * G * HD + i) : 0.f;
      float o = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxSplits; ++j)
        if (j < live && p_s[g * kMaxSplits + j] > 0.f) o = fmaf(p_s[g * kMaxSplits + j], v[j], o);
      store_f(out + i, o / l_s[g]);
    }
    return false;
  }
};

// Copy one hd-row (new k or v) into the cache, 16 bytes a thread.
template <typename T, int HD>
__device__ __forceinline__ void store_row(T* __restrict__ dst, const T* __restrict__ src) {
  using S = Shape<T, HD>;
  if (threadIdx.x < S::kSegs)
    reinterpret_cast<uint4*>(dst)[threadIdx.x] = reinterpret_cast<const uint4*>(src)[threadIdx.x];
}

// ---------------------------------------------------------------------------
// ring-cache decode step: one block per (row, KV head, split)
// ---------------------------------------------------------------------------
template <typename T, int HD, int G>
__global__ void __launch_bounds__(kThreads)
decode_step_kernel(const T* __restrict__ q, const T* __restrict__ k_new,
                   const T* __restrict__ v_new, T* __restrict__ k_cache,
                   T* __restrict__ v_cache, T* __restrict__ out,
                   const int* __restrict__ valid, float* __restrict__ part,
                   unsigned* __restrict__ counters, int slot, int N, int smax, int KV,
                   int splits, int chunk, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  SplitAttention<T, HD, G> sa(smem);
  const int split = blockIdx.x % splits;
  const size_t head = blockIdx.x / splits;  // n * KV + h
  const size_t n = head / KV, h = head % KV;
  const size_t rs = (size_t)KV * HD;  // one cache position
  const T* knp = k_new + head * HD;
  const T* vnp = v_new + head * HD;
  T* kc = k_cache + n * smax * rs + h * HD;
  T* vc = v_cache + n * smax * rs + h * HD;
  T* o = out + head * G * HD;
  if (split == 0) {  // this block owns row (n, slot, h); no block reads it back
    store_row<T, HD>(kc + (size_t)slot * rs, knp);
    store_row<T, HD>(vc + (size_t)slot * rs, vnp);
  }
  const int t0 = split * chunk, t1 = min(t0 + chunk, smax);
  sa.load_q(q + head * G * HD, scale);  // in flight with the mask's loads
  int any = 0;  // the chunk's mask, read once
  for (int t = t0 + threadIdx.x; t < t1; t += kThreads) any |= valid[t] == 1;
  if (__syncthreads_or(any)) {
    auto row = [&](int t, const T*& kp, const T*& vp) -> bool {
      if (t >= t1 || valid[t] != 1) return false;
      kp = t == slot ? knp : kc + (size_t)t * rs;
      vp = t == slot ? vnp : vc + (size_t)t * rs;
      return true;
    };
    sa.run(t0, t1, row, knp, part + (head * splits + split) * G * HD, o);
  }  // else nothing attended to: (m, l) = (-inf, 0) from load_q
  if (sa.arrive_and_merge(part, counters, head, split, splits, splits, (size_t)N * KV, o)) {
    // no position is valid: every score is the mask value, so the reference
    // weighs all smax positions equally (the new row at the slot)
    const float w = 1.f / (float)smax;
    for (int i = threadIdx.x; i < G * HD; i += kThreads) {
      const int e = i % HD;
      float acc = 0.f;
      for (int t = 0; t < smax; ++t)
        acc = fmaf(w, to_f(t == slot ? vnp[e] : vc[(size_t)t * rs + e]), acc);
      store_f(o + i, acc);
    }
  }
}

// ---------------------------------------------------------------------------
// paged decode step: one block per (chain, slot, KV head, split)
// ---------------------------------------------------------------------------
template <typename T, int HD, int G>
__global__ void __launch_bounds__(kThreads)
paged_decode_step_kernel(const T* __restrict__ q, const T* __restrict__ k_new,
                         const T* __restrict__ v_new, T* __restrict__ k_pages,
                         T* __restrict__ v_pages, T* __restrict__ out,
                         const int* __restrict__ tables, const int* __restrict__ pos,
                         float* __restrict__ part, unsigned* __restrict__ counters, int C,
                         int S, int n_pages, int ps, int maxp, int KV, int splits,
                         int min_pages, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  SplitAttention<T, HD, G> sa(smem);
  const int split = blockIdx.x % splits;
  const size_t head = blockIdx.x / splits;  // (c * S + s) * KV + h
  const size_t cs = head / KV, h = head % KV;
  const size_t c = cs / S, s = cs % S;
  const size_t rs = (size_t)KV * HD;  // one pool row (page, offset)
  const size_t pool = (size_t)n_pages * ps * rs;
  T* kpool = k_pages + c * pool + h * HD;
  T* vpool = v_pages + c * pool + h * HD;
  const int* tbl = tables + s * maxp;
  T* o = out + head * G * HD;
  const int p = pos[s];
  // split 0 refuses a position outside the pool (NaN output, no store)
  if (p < 0 || p >= maxp * ps) {
    if (split == 0)
      for (int i = threadIdx.x; i < G * HD; i += kThreads) store_f(o + i, __int_as_float(0x7fc00000));
    return;
  }
  // this split's whole pages of the slot's `used`; the first `live` splits
  // have some, the others exit at once
  const int used = p / ps + 1;
  const int per = max((used + splits - 1) / splits, min_pages);
  const int live = (used + per - 1) / per;
  const int pg0 = split * per, pg1 = min(pg0 + per, used);
  if (split >= live) return;
  // the slot's page ids, read once: this chunk's into shared memory, all of
  // them checked, since a page id outside the pool would address memory the
  // slot does not own (every live split refuses it: NaN, no store)
  sa.load_q(q + head * G * HD, scale);
  int bad = 0;
  for (int j = threadIdx.x; j < used; j += kThreads) {
    const int pg = tbl[j];
    bad |= (unsigned)pg >= (unsigned)n_pages;
    if (j >= pg0 && j < pg1) sa.pages_s[j - pg0] = pg;
  }
  if (__syncthreads_or(bad)) {
    if (split == 0)
      for (int i = threadIdx.x; i < G * HD; i += kThreads) store_f(o + i, __int_as_float(0x7fc00000));
    return;
  }
  const T* knp = k_new + head * HD;
  const T* vnp = v_new + head * HD;
  if (split == 0) {  // one row per slot: (tables[s, p / ps], p % ps)
    const size_t w = (size_t)tbl[p / ps] * ps + p % ps;
    store_row<T, HD>(kpool + w * rs, knp);
    store_row<T, HD>(vpool + w * rs, vnp);
  }
  const int t0 = pg0 * ps, t1 = min(pg1 * ps, p + 1);
  const int shift = (ps & (ps - 1)) == 0 ? __ffs(ps) - 1 : -1;
  const int* pages = sa.pages_s;
  auto row = [&](int t, const T*& kp, const T*& vp) -> bool {
    if (t >= t1) return false;
    if (t == p) {
      kp = knp;
      vp = vnp;
      return true;
    }
    const int k = shift >= 0 ? (t - t0) >> shift : (t - t0) / ps;
    const size_t r = (size_t)pages[k] * ps + (t - t0 - k * ps);
    kp = kpool + r * rs;
    vp = vpool + r * rs;
    return true;
  };
  if (live == 1) {
    sa.run(t0, t1, row, knp, nullptr, o);
    return;
  }
  sa.run(t0, t1, row, knp, part + (head * splits + split) * G * HD, o);
  sa.arrive_and_merge(part, counters, head, split, splits, live, (size_t)C * S * KV, o);
}

template <typename T, int HD, int G>
cudaError_t launch_decode(const void* q, const void* k_new, const void* v_new, void* k_cache,
                          void* v_cache, void* out, const int* valid, float* part,
                          unsigned* counters, int slot, int N, int smax, int KV, int splits,
                          int chunk, float scale, cudaStream_t stream) {
  auto kernel = decode_step_kernel<T, HD, G>;
  const size_t smem = smem_layout_bytes(G, HD, sizeof(T), 0);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)((size_t)N * KV * splits), kThreads, smem, stream>>>(
      (const T*)q, (const T*)k_new, (const T*)v_new, (T*)k_cache, (T*)v_cache, (T*)out, valid,
      part, counters, slot, N, smax, KV, splits, chunk, scale);
  return cudaGetLastError();
}

template <typename T, int HD, int G>
cudaError_t launch_paged(const void* q, const void* k_new, const void* v_new, void* k_pages,
                         void* v_pages, void* out, const int* tables, const int* pos,
                         float* part, unsigned* counters, int C, int S, int n_pages, int ps,
                         int maxp, int KV, int splits, int min_pages, int max_pages,
                         float scale, cudaStream_t stream) {
  auto kernel = paged_decode_step_kernel<T, HD, G>;
  const size_t smem = smem_layout_bytes(G, HD, sizeof(T), max_pages);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)((size_t)C * S * KV * splits), kThreads, smem, stream>>>(
      (const T*)q, (const T*)k_new, (const T*)v_new, (T*)k_pages, (T*)v_pages, (T*)out, tables,
      pos, part, counters, C, S, n_pages, ps, maxp, KV, splits, min_pages, scale);
  return cudaGetLastError();
}

// dispatch over (HD, G), this library's dtype only.  G need not
// be a power of two: every loop over heads stops at G, the mma paths pad the
// heads to 8 (n < G), the softmax takes a warp a head (g += kWarps), and the
// shared-memory layout counts G exactly (G = 3: 12 query heads over 4 KV
// heads, the 110M example model; G = 5: hymba-1.5b's 25 over 5; G = 7:
// internvl2-1b's 14 over 2).  HD need not be a multiple of 64 (see Shape
// and kMt): 112 is kimi-k2's, 160 stablelm-12b's.
#define DISPATCH_G(T, HD, FN, ...)                          \
  switch (G) {                                              \
    case 1: return FN<T, HD, 1>(__VA_ARGS__);               \
    case 2: return FN<T, HD, 2>(__VA_ARGS__);               \
    case 3: return FN<T, HD, 3>(__VA_ARGS__);               \
    case 4: return FN<T, HD, 4>(__VA_ARGS__);               \
    case 5: return FN<T, HD, 5>(__VA_ARGS__);               \
    case 7: return FN<T, HD, 7>(__VA_ARGS__);               \
    case 8: return FN<T, HD, 8>(__VA_ARGS__);               \
    default: return cudaErrorInvalidValue;                  \
  }
#define DISPATCH_HD(T, FN, ...)                             \
  switch (HD) {                                             \
    case 64: DISPATCH_G(T, 64, FN, __VA_ARGS__)             \
    case 112: DISPATCH_G(T, 112, FN, __VA_ARGS__)           \
    case 128: DISPATCH_G(T, 128, FN, __VA_ARGS__)           \
    case 160: DISPATCH_G(T, 160, FN, __VA_ARGS__)           \
    default: return cudaErrorInvalidValue;                  \
  }
#define DISPATCH(FN, ...)                                   \
  if (dtype != DECODE_STEP_DTYPE) return cudaErrorInvalidValue; \
  DISPATCH_HD(DECODE_STEP_T, FN, __VA_ARGS__)

}  // namespace

extern "C" size_t decode_step_smem_bytes(int G, int HD, int elem, int max_pages) {
  return smem_layout_bytes(G, HD, elem, max_pages);
}

extern "C" int decode_step_launch(const void* q, const void* k_new, const void* v_new,
                                  void* k_cache, void* v_cache, void* out, const void* valid,
                                  void* part, void* counters, int slot, int N, int smax, int KV,
                                  int G, int HD, int dtype, int splits, int chunk, float scale,
                                  void* stream) {
  if (splits < 1 || splits > kMaxSplits || chunk < 1 || (long)splits * chunk < smax)
    return cudaErrorInvalidValue;
  DISPATCH(launch_decode, q, k_new, v_new, k_cache, v_cache, out, (const int*)valid,
           (float*)part, (unsigned*)counters, slot, N, smax, KV, splits, chunk, scale,
           (cudaStream_t)stream)
  return cudaErrorInvalidValue;
}

extern "C" int paged_decode_step_launch(const void* q, const void* k_new, const void* v_new,
                                        void* k_pages, void* v_pages, void* out,
                                        const void* tables, const void* pos, void* part,
                                        void* counters, int C, int S, int n_pages, int ps,
                                        int maxp, int KV, int G, int HD, int dtype, int splits,
                                        int min_pages, int max_pages, float scale,
                                        void* stream) {
  // a split takes max(ceil(used / splits), min_pages) <= max_pages pages of
  // the slot's used <= maxp, which is what sizes its page ids in shared memory
  if (splits < 1 || splits > kMaxSplits || min_pages < 1 ||
      max_pages < min(maxp, min_pages) || (long)max_pages * splits < maxp)
    return cudaErrorInvalidValue;
  DISPATCH(launch_paged, q, k_new, v_new, k_pages, v_pages, out, (const int*)tables,
           (const int*)pos, (float*)part, (unsigned*)counters, C, S, n_pages, ps, maxp, KV,
           splits, min_pages, max_pages, scale, (cudaStream_t)stream)
  return cudaErrorInvalidValue;
}
