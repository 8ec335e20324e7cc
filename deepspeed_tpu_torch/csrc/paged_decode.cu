// One-token decode attention straight against the paged KV pool, for Hopper.
//
// Replaces deepspeed_tpu/ops/attention/paged.py::_decode_kernel (the Pallas
// TPU kernel built by _paged_decode_pallas), both arities, as one kernel body
// with two tile loaders and two C entry points. Same function:
//   q (B, KH*G, hd); kpool, vpool (N, KH, page_size, hd); tables (B, P) int32;
//   positions (B,) int32 -> out (B, KH*G, hd) in q's dtype.
// Dense arity (paged_decode): the pools hold q's dtype, bf16 or fp32.
// Int8 arity (paged_decode_int8, the Pallas kernel's quantized=True): the
// pools hold int8 beside kscale, vscale (N, KH, page_size, nb) fp32, nb
// dividing hd: the scale of token row r's block j covers values
// [j*hd/nb, (j+1)*hd/nb) of that row, and a value is int8 -> fp32 times it.
// Row b attends its positions 0..pos over exactly pos / page_size + 1 pages
// of its table (capped at P). Positions past pos and table entries that are
// the null page 0 (or outside [1, N)) are masked, and such token rows are
// never read: an unwritten row's payload or scale may hold anything. The
// softmax is in fp32 with scale sm_scale and q is widened to fp32. Dense:
// q.K takes the pool dtype's values with fp32 accumulation, and the
// probabilities are rounded to the pool dtype before the P.V product. Int8:
// every product is fp32 and nothing is rounded before the output. A row with
// nothing visible writes 0, never NaN. In GQA the G query heads of a group
// share one kv head's pages.
//
// The split over the pages (flash-decoding). The grid is (S, KH, B): block
// (j, kh, b) takes table entries [j*pps, (j+1)*pps) of row b, pps (pages per
// split) chosen on the host from the shapes alone (ops/attention/paged.py::
// split_plan), so every call splits alike. A split past the row's live pages
// exits before any load; the others load the row's position, their table
// entries and the group's queries at once. A live split stages the visible
// token rows of its live pages, packed, into shared memory with cp.async (16
// bytes a thread): all its K rows and all its V rows are in flight before any
// math where they fit in two slots (64 KB), else they stream through the two
// slots as a double buffer, K tiles first, then V tiles. The int8 arity
// stages its payload as int8 and its scale rows beside it and dequantizes in
// registers.
//   Scores: a group of GS lanes (GS = the row's vectors, 16 bytes, 8 for
// int8, rounded up to a power of two, at most 32: 8 lanes at head_dim 64 in
// bf16 and int8) owns a token row and scores all G queries of the group from
// it, then reduces across the group with log2(GS) shuffles.
//   Softmax: a warp per (query, page) takes the page's max; the prefix max
// M_i over the split's pages up to page i is JAX's running max, restarted at
// each split. p of a token on page i is exp(s - M_i), rounded to the pool
// dtype in the dense arity (the Pallas kernel's rounding points), then
// weighted by exp(M_i - M) with M the split's max; l sums the unrounded
// exp(s - M_i) * exp(M_i - M) page by page.
//   P.V: every thread owns 4 output values of one query and a share of the
// rows; the shares are summed in a fixed order through shared memory.
//   With one split (S == 1) the block writes out = acc / l itself. Else it
// writes its partial (acc, m, l) to the workspace (B, KH, S, G, hd) fp32 and
// (B, KH, S, G, 2) after it, counts its arrival on the row's int32 counter,
// and the split that arrives last merges the row's live splits in split
// order, with no float atomics: m = max m_j, l = sum l_j e^(m_j - m),
// acc = sum acc_j e^(m_j - m), out = acc / l, or 0 where l = 0; it then sets
// the counter back to 0. Every sum runs in a fixed order whatever the order
// of arrival, so the bits do not change from run to run, and rows that share
// pages, query and position stay bitwise equal.
//
// What bounds it on an H100: device-memory bytes. The kernel reads K and V of
// each visible token row once (2 * hd values per kv head, plus 2 * nb fp32
// scales in the int8 arity) and does 4 * G * hd fp32 flop per token row (2 *
// hd more to dequantize): about G flop per byte in bf16 and 2 * G in int8,
// far below the ~295 flop/byte at which the bf16 tensor cores would become
// the limit, so there are no tensor cores (and the int8 arity's products are
// fp32 in any case). What the design does about the bytes: each is read once
// per group, all of a split's loads are in flight before the math, and the
// split fills the card when a batch has fewer (row, kv head) pairs than the
// card has SMs, which is what serving runs.
//
// Built by deepspeed_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// into a library with a plain C interface, loaded through ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxHd = 256;
constexpr int kMaxG = 8;
constexpr int kMaxPps = 64;          // pages per split
constexpr int kMaxSplitRows = 1024;  // pps * page_size
constexpr int kFitBytes = 64 * 1024; // the two staging slots together
// P.V's float4 outputs per thread: 1 where G * hd <= 4 * kThreads (every
// serving shape), else up to this many
constexpr int kMaxPairs = kMaxG * kMaxHd / 4 / kThreads;
constexpr int kMaxQVec = kMaxG * kMaxHd * 4 / 16 / kThreads;  // q vectors
constexpr float kNegInf = -1e30f;  // finite, as the Pallas kernel's NEG_INF

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// the two bf16 halves of a 32-bit word, exactly, as fp32
__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// two fp32, each rounded to bf16, as one 32-bit word (a in the low half)
__device__ __forceinline__ uint32_t bf16_pack(float a, float b) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16(a)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16(b)) << 16);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A pool hands the body the staged token rows of a slot. A slot holds up to
// TR packed rows: their payload (row t at byte t * hd * kElem) and, for the
// int8 pool, their scale rows after it (row t at float t * nb).
//   issue: cp.async rows r0 .. r0+n of kv head `head` (= page * KH + kh) of
//     the K (kv == 0) or V pool into slot rows dst .. dst+n;
//   vec: the kVec values of vector v of slot row t, as fp32 (a row has at
//     most 32 vectors);
//   four: values d0 .. d0+3 of slot row t, as fp32.

// bf16 or fp32 pools, staged as they are
template <typename T>
struct DensePool {
  static constexpr int kElem = sizeof(T);
  static constexpr int kVec = 8;  // scored 8 values (16 or 32 bytes) a lane
  static constexpr bool kRoundP = true;  // p goes to the pool dtype before P.V
  const T* k;
  const T* v;

  __host__ __device__ int row_bytes(int hd) const { return hd * kElem; }

  __device__ __forceinline__ void issue(int kv, char* slot, int, size_t head,
                                        int ps, int hd, int r0, int n, int dst,
                                        int tid) const {
    const int row_vecs = hd * kElem / 16;  // 16-byte copies
    const T* src = (kv == 0 ? k : v) + (head * ps + r0) * hd;
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(slot) + (size_t)dst * row_vecs;
    for (int x = tid; x < n * row_vecs; x += kThreads) cp_async16(d + x, s + x);
  }

  __device__ __forceinline__ void vec(const char* slot, int, int hd, int t,
                                      int vi, float* out) const {
    const uint4* row = reinterpret_cast<const uint4*>(
        slot + ((size_t)t * hd + vi * kVec) * kElem);
    if constexpr (kElem == 2) {
      const uint4 raw = row[0];
      const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        out[2 * e] = bf16_lo(w[e]);
        out[2 * e + 1] = bf16_hi(w[e]);
      }
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint4 raw = row[h];
        out[4 * h] = __uint_as_float(raw.x);
        out[4 * h + 1] = __uint_as_float(raw.y);
        out[4 * h + 2] = __uint_as_float(raw.z);
        out[4 * h + 3] = __uint_as_float(raw.w);
      }
    }
  }

  __device__ __forceinline__ float4 four(const char* slot, int, int hd, int t,
                                         int d0) const {
    const T* row = reinterpret_cast<const T*>(slot) + (size_t)t * hd + d0;
    if constexpr (kElem == 2) {
      const uint2 raw = *reinterpret_cast<const uint2*>(row);
      return make_float4(bf16_lo(raw.x), bf16_hi(raw.x), bf16_lo(raw.y),
                         bf16_hi(raw.y));
    } else {
      return *reinterpret_cast<const float4*>(row);
    }
  }
};

// int8 pools with fp32 scale pools: payload staged as int8, scale rows beside
// it, dequantized in registers
struct Int8Pool {
  static constexpr int kVec = 16;  // scored 16 values (16 bytes) a lane
  static constexpr bool kRoundP = false;  // fp32 throughout
  const int8_t* k;
  const int8_t* v;
  const float* kscale;
  const float* vscale;
  int nb;

  __host__ __device__ int row_bytes(int hd) const { return hd + 4 * nb; }

  __device__ __forceinline__ void issue(int kv, char* slot, int tr,
                                        size_t head, int ps, int hd, int r0,
                                        int n, int dst, int tid) const {
    const int row_vecs = hd / 16;  // 16-byte copies
    const int8_t* src = (kv == 0 ? k : v) + (head * ps + r0) * hd;
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(slot) + (size_t)dst * row_vecs;
    for (int x = tid; x < n * row_vecs; x += kThreads) cp_async16(d + x, s + x);
    const float* ssrc = (kv == 0 ? kscale : vscale) + (head * ps + r0) * nb;
    float* sdst =
        reinterpret_cast<float*>(slot + (size_t)tr * hd) + (size_t)dst * nb;
    for (int x = tid; x < n * nb; x += kThreads) cp_async4(sdst + x, ssrc + x);
  }

  __device__ __forceinline__ float scale(const char* slot, int tr, int hd,
                                         int t, int blk_idx) const {
    return reinterpret_cast<const float*>(slot + (size_t)tr * hd)
        [(size_t)t * nb + blk_idx];
  }

  __device__ __forceinline__ void vec(const char* slot, int tr, int hd, int t,
                                      int vi, float* out) const {
    const uint4 raw =
        reinterpret_cast<const uint4*>(slot)[(size_t)t * (hd / kVec) + vi];
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
    dequant<kVec>(w, slot, tr, hd, t, vi * kVec, out);
  }

  // n int8 values (packed in w, little endian) of slot row t from value d0,
  // each times its block's scale: the block index steps at each block edge
  template <int n>
  __device__ __forceinline__ void dequant(const uint32_t* w, const char* slot,
                                          int tr, int hd, int t, int d0,
                                          float* out) const {
    const int blk = hd / nb;
    int bi = d0 / blk;
    int edge = (bi + 1) * blk - d0;  // values before the next block
    float sc = scale(slot, tr, hd, t, bi);
#pragma unroll
    for (int e = 0; e < n; ++e) {
      if (e == edge) {
        edge += blk;
        sc = scale(slot, tr, hd, t, ++bi);
      }
      const int q = (int)(int8_t)((w[e >> 2] >> (8 * (e & 3))) & 0xffu);
      out[e] = (float)q * sc;
    }
  }

  __device__ __forceinline__ float4 four(const char* slot, int tr, int hd,
                                         int t, int d0) const {
    const uint32_t w =
        *reinterpret_cast<const uint32_t*>(slot + (size_t)t * hd + d0);
    float o[4];
    dequant<4>(&w, slot, tr, hd, t, d0, o);
    return make_float4(o[0], o[1], o[2], o[3]);
  }
};

// S splits; TR token rows a staging slot holds
struct Geometry {
  int num_pages, kv_heads, page_size, hd, G, P, pps, S, TR;
  float sm_scale;
};

// the rounding of p before P.V: to the pool dtype in the dense arity
template <typename T, typename Pool>
__device__ __forceinline__ float round_p(float x) {
  if constexpr (Pool::kRoundP) return to_f(from_f<T>(x));
  return x;
}

template <typename T>
__device__ __forceinline__ void store4(T* dst, float4 a) {
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(dst) = a;
  } else {
    *reinterpret_cast<uint2*>(dst) =
        make_uint2(bf16_pack(a.x, a.y), bf16_pack(a.z, a.w));
  }
}

__device__ __forceinline__ float4 fma4(float w, float4 v, float4 a) {
  return make_float4(fmaf(w, v.x, a.x), fmaf(w, v.y, a.y), fmaf(w, v.z, a.z),
                     fmaf(w, v.w, a.w));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float4 scale4(float4 a, float s) {
  return make_float4(a.x * s, a.y * s, a.z * s, a.w * s);
}

// acc / l, or acc where l == 0 (a row that saw nothing: acc is 0 there).
// __fdividef (2 ulp) and not "/", which brings the IEEE division's slow
// path into the kernel; l >= 1 wherever a row was seen (the largest term is
// e^0), far below the 2^126 where __fdividef gives 0.
__device__ __forceinline__ float4 div4(float4 a, float l) {
  const float d = l == 0.f ? 1.f : l;
  return make_float4(__fdividef(a.x, d), __fdividef(a.y, d),
                     __fdividef(a.z, d), __fdividef(a.w, d));
}

// dynamic shared memory: two slots, q (G, hd) fp32, the P.V reduction
// (kThreads float4), the scores and weights (G, pps * page_size) fp32
__host__ __device__ inline int slot_bytes(int tr, int row_bytes) {
  return (tr * row_bytes + 15) / 16 * 16;
}

__host__ __device__ inline int smem_bytes(const Geometry& g, int row_bytes) {
  return 2 * slot_bytes(g.TR, row_bytes) + g.G * g.hd * 4 + kThreads * 16 +
         g.G * g.pps * g.page_size * 4;
}

// kPairs: P.V's float4 outputs per thread (1, or kMaxPairs for G * hd past
// 4 * kThreads)
template <typename T, typename Pool, int kPairs>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const Pool pool,
                    const int32_t* __restrict__ tables,
                    const int32_t* __restrict__ positions,
                    T* __restrict__ out, float* __restrict__ ws,
                    int* __restrict__ arrivals, const Geometry geo) {
  extern __shared__ __align__(16) char smem[];
  __shared__ int page_s[kMaxPps];
  __shared__ int vis_s[kMaxPps];
  __shared__ int off_s[kMaxPps];
  __shared__ float pm_s[kMaxG * kMaxPps];
  __shared__ float lp_s[kMaxG * kMaxPps];
  __shared__ int rows_s;
  __shared__ int last_s;

  const int j = blockIdx.x;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ps = geo.page_size, hd = geo.hd, G = geo.G, KH = geo.kv_heads;
  const int p0 = j * geo.pps;
  const size_t row0 = ((size_t)b * KH + kh) * G;  // first query row of group
  const bool direct = geo.S == 1;
  const int n4 = hd / 4;
  const int npair = G * n4;

  // the row's position, this split's table entries and the group's
  // queries, all in flight at once
  const int pos = positions[b];
  int page = 0;
  if (tid < geo.pps && p0 + tid < geo.P)
    page = tables[(size_t)b * geo.P + p0 + tid];
  constexpr int kQVec = 16 / sizeof(T);  // q values per 16-byte vector
  const int qvecs = G * hd / kQVec;
  uint4 qv[kMaxQVec];
#pragma unroll
  for (int k = 0; k < kMaxQVec; ++k) {
    const int v = tid + k * kThreads;
    if (v < qvecs) qv[k] = reinterpret_cast<const uint4*>(q + row0 * hd)[v];
  }
  int num_pg = pos < 0 ? 0 : pos / ps + 1;
  if (num_pg > geo.P) num_pg = geo.P;
  const int live = (num_pg + geo.pps - 1) / geo.pps;  // live splits
  if (j >= live) {  // past the row's live pages: no load, no partial
    if (j == 0)     // nothing live at all: the row is 0
      for (int e = tid; e < npair; e += kThreads)
        store4(out + row0 * hd + (size_t)e * 4, make_float4(0.f, 0.f, 0.f, 0.f));
    return;
  }
  const int npg = min(geo.pps, num_pg - p0);

  const int tcap = geo.pps * ps;
  const int slot_b = slot_bytes(geo.TR, pool.row_bytes(hd));
  char* slots = smem;
  float* q_s = reinterpret_cast<float*>(smem + 2 * slot_b);
  float4* red = reinterpret_cast<float4*>(q_s + G * hd);
  float* sc = reinterpret_cast<float*>(red + kThreads);
  // the queries widened to fp32 once
#pragma unroll
  for (int k = 0; k < kMaxQVec; ++k) {
    const int v = tid + k * kThreads;
    if (v < qvecs) {
      float* dst = q_s + v * kQVec;
      if constexpr (sizeof(T) == 2) {
        const uint32_t w[4] = {qv[k].x, qv[k].y, qv[k].z, qv[k].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dst[2 * e] = bf16_lo(w[e]);
          dst[2 * e + 1] = bf16_hi(w[e]);
        }
      } else {
        *reinterpret_cast<float4*>(dst) =
            make_float4(__uint_as_float(qv[k].x), __uint_as_float(qv[k].y),
                        __uint_as_float(qv[k].z), __uint_as_float(qv[k].w));
      }
    }
  }
  // this split's pages: which are live, how many rows each shows
  if (tid < npg) {
    const bool ok = page > 0 && page < geo.num_pages;
    page_s[tid] = page;
    vis_s[tid] = ok ? min(ps, pos - (p0 + tid) * ps + 1) : 0;
  }
  __syncthreads();
  if (tid == 0) {
    int acc = 0;
    for (int i = 0; i < npg; ++i) {
      off_s[i] = acc;
      acc += vis_s[i];
    }
    rows_s = acc;
  }
  __syncthreads();
  const int rows = rows_s;

  // P.V: thread -> (pair of query g and values d0..d0+3, share rs of rows)
  const int nrs = npair >= kThreads ? 1 : kThreads / npair;
  const int rs = npair >= kThreads ? 0 : tid / npair;
  const int pair0 = npair >= kThreads ? tid : tid - rs * npair;
  float4 acc[kPairs];
#pragma unroll
  for (int k = 0; k < kPairs; ++k) acc[k] = make_float4(0.f, 0.f, 0.f, 0.f);

  if (rows > 0) {  // else only null pages: the partial is (0, NEG_INF, 0)
    const int ntile = (rows + geo.TR - 1) / geo.TR;
    const int nitem = 2 * ntile;  // K tiles, then V tiles
    auto issue = [=](int item) {
      const int kv = item < ntile ? 0 : 1;
      const int a = (item - kv * ntile) * geo.TR;
      const int e = min(a + geo.TR, rows);
      char* slot = slots + (item & 1) * slot_b;
      for (int i = 0; i < npg; ++i) {
        const int lo = max(off_s[i], a);
        const int hi = min(off_s[i] + vis_s[i], e);
        if (lo < hi) {
          const size_t head = (size_t)page_s[i] * KH + kh;
          pool.issue(kv, slot, geo.TR, head, ps, hd, lo - off_s[i], hi - lo,
                     lo - a, tid);
        }
      }
      cp_async_commit();
    };

    // scores: GS lanes own a row, a vector each
    constexpr int kVec = Pool::kVec;
    const int row_vecs = hd / kVec;
    int gs = 1;
    while (gs < row_vecs) gs <<= 1;
    const int nrg = kThreads / gs;
    const int rg = tid / gs;
    const int li = tid - rg * gs;

    issue(0);
    for (int item = 0; item < nitem; ++item) {
      if (item + 1 < nitem) {
        issue(item + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const char* slot = slots + (item & 1) * slot_b;
      if (item < ntile) {
        const int a = item * geo.TR;
        const int n = min(geo.TR, rows - a);
        for (int t0 = 0; t0 < n; t0 += nrg) {
          const int t = t0 + rg;
          const bool mine = t < n && li < row_vecs;
          float kvals[kVec];
          if (mine) pool.vec(slot, geo.TR, hd, t, li, kvals);
          // one query at a time: a lane's dot over its vector, then the
          // group's sum
          for (int g = 0; g < G; ++g) {
            float s = 0.f;
            if (mine) {  // four independent chains, then their sum
              const float4* qg =
                  reinterpret_cast<const float4*>(q_s + g * hd + li * kVec);
              float4 d = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
              for (int c = 0; c < kVec / 4; ++c) {
                const float4 qq = qg[c];
                d.x = fmaf(qq.x, kvals[4 * c], d.x);
                d.y = fmaf(qq.y, kvals[4 * c + 1], d.y);
                d.z = fmaf(qq.z, kvals[4 * c + 2], d.z);
                d.w = fmaf(qq.w, kvals[4 * c + 3], d.w);
              }
              s = (d.x + d.y) + (d.z + d.w);
            }
            for (int o = gs >> 1; o > 0; o >>= 1)
              s += __shfl_xor_sync(0xffffffffu, s, o);
            if (t < n && li == 0) sc[g * tcap + a + t] = s * geo.sm_scale;
          }
        }
      } else {
        if (item == ntile) {
          // every score is in: page maxima, then the weights and l by page
          for (int pr = warp; pr < G * npg; pr += kWarps) {
            const int g = pr / npg;
            const int i = pr - g * npg;
            const float* row = sc + g * tcap + off_s[i];
            float mx = kNegInf;
            for (int r = lane; r < vis_s[i]; r += 32) mx = fmaxf(mx, row[r]);
            mx = warp_max(mx);
            if (lane == 0) pm_s[g * kMaxPps + i] = mx;
          }
          __syncthreads();
          for (int pr = warp; pr < G * npg; pr += kWarps) {
            const int g = pr / npg;
            const int i = pr - g * npg;
            float mi = kNegInf, m = kNegInf;
            for (int p = 0; p < npg; ++p) {
              const float x = pm_s[g * kMaxPps + p];
              if (p <= i) mi = fmaxf(mi, x);
              m = fmaxf(m, x);
            }
            const float ci = expf(mi - m);
            float* row = sc + g * tcap + off_s[i];
            float lsum = 0.f;
            for (int r = lane; r < vis_s[i]; r += 32) {
              const float e = expf(row[r] - mi);
              lsum += e;
              row[r] = round_p<T, Pool>(e) * ci;
            }
            lsum = warp_sum(lsum);
            if (lane == 0) lp_s[g * kMaxPps + i] = lsum * ci;
          }
          __syncthreads();
        }
        const int a = (item - ntile) * geo.TR;
        const int n = min(geo.TR, rows - a);
#pragma unroll
        for (int k = 0; k < kPairs; ++k) {
          const int pr = pair0 + k * kThreads;
          if (rs < nrs && pr < npair && (k == 0 || nrs == 1)) {
            const int g = pr / n4;
            const int d0 = (pr - g * n4) * 4;
            const float* w = sc + g * tcap + a;
            // two chains over alternate rows, added at the end of the tile
            float4 av = make_float4(0.f, 0.f, 0.f, 0.f), bv = av;
            int t = rs;
            for (; t + nrs < n; t += 2 * nrs) {
              av = fma4(w[t], pool.four(slot, geo.TR, hd, t, d0), av);
              bv = fma4(w[t + nrs], pool.four(slot, geo.TR, hd, t + nrs, d0),
                        bv);
            }
            if (t < n) av = fma4(w[t], pool.four(slot, geo.TR, hd, t, d0), av);
            acc[k] = add4(acc[k], add4(av, bv));
          }
        }
      }
      __syncthreads();  // the slot is free for the item after next
    }

    // the shares of the rows, summed in order
    if (nrs > 1) {
      if (rs < nrs) red[rs * npair + pair0] = acc[0];
      __syncthreads();
      if (tid < npair) {
        float4 a = red[tid];
        for (int r = 1; r < nrs; ++r) a = add4(a, red[r * npair + tid]);
        acc[0] = a;
      }
    }
  }

  // the partial, or with one split the output
  const size_t part = ((size_t)b * KH + kh) * geo.S + j;  // workspace entry
  float* ws_acc = direct ? nullptr : ws + part * G * hd;
  float* ws_ml = direct ? nullptr
                        : ws + (size_t)gridDim.z * KH * geo.S * G * hd +
                              part * G * 2;
#pragma unroll
  for (int k = 0; k < kPairs; ++k) {
    const int pr = (nrs > 1 ? tid : pair0 + k * kThreads);
    if (pr < npair && (k == 0 || nrs == 1)) {
      const int g = pr / n4;
      const int d0 = (pr - g * n4) * 4;
      float l = 0.f, m = kNegInf;
      if (rows > 0) {
        for (int i = 0; i < npg; ++i) {
          l += lp_s[g * kMaxPps + i];
          m = fmaxf(m, pm_s[g * kMaxPps + i]);
        }
      }
      if (direct) {
        store4(out + (row0 + g) * hd + d0, div4(acc[k], l));
      } else {
        reinterpret_cast<float4*>(ws_acc)[pr] = acc[k];
        if (d0 == 0) {
          ws_ml[2 * g] = m;
          ws_ml[2 * g + 1] = l;
        }
      }
    }
  }
  if (direct) return;

  // the split that arrives last merges the row's live splits, in split
  // order (so the bits do not depend on the order of arrival), and sets
  // the row's arrival count back to 0 for the next launch
  __threadfence();
  __syncthreads();
  int* arrived = arrivals + (size_t)b * KH + kh;
  if (tid == 0) last_s = atomicAdd(arrived, 1) == live - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  const float* parts = ws + ((size_t)b * KH + kh) * geo.S * G * hd;
  const float* mls =
      ws + (size_t)gridDim.z * KH * geo.S * G * hd +
      ((size_t)b * KH + kh) * geo.S * G * 2;
  for (int e = tid; e < npair; e += kThreads) {
    const int g = e / n4;
    float m = kNegInf;
    for (int i = 0; i < live; ++i)
      m = fmaxf(m, __ldcg(mls + ((size_t)i * G + g) * 2));
    float l = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = 0; i < live; ++i) {
      const float f = expf(__ldcg(mls + ((size_t)i * G + g) * 2) - m);
      l += __ldcg(mls + ((size_t)i * G + g) * 2 + 1) * f;
      a = add4(a, scale4(__ldcg(reinterpret_cast<const float4*>(
                             parts + (size_t)i * G * hd) + e), f));
    }
    store4(out + row0 * hd + (size_t)e * 4, div4(a, l));
  }
  if (tid == 0) *arrived = 0;
}

template <typename T, typename Pool>
int launch(const void* q, const Pool& pool, const void* tables,
           const void* positions, void* out, void* ws, void* arrivals,
           int batch, Geometry geo, void* stream) {
  const int row_bytes = pool.row_bytes(geo.hd);
  const int tcap = geo.pps * geo.page_size;
  // all of a split's K and V rows in the two slots where they fit, else
  // tiles of TR rows through them
  geo.TR = min(tcap, max(1, kFitBytes / 2 / row_bytes));
  geo.S = (geo.P + geo.pps - 1) / geo.pps;
  const int smem = smem_bytes(geo, row_bytes);
  auto kernel = geo.G * geo.hd <= 4 * kThreads
                    ? paged_decode_kernel<T, Pool, 1>
                    : paged_decode_kernel<T, Pool, kMaxPairs>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<dim3(geo.S, geo.kv_heads, batch), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), pool, static_cast<const int32_t*>(tables),
      static_cast<const int32_t*>(positions), static_cast<T*>(out),
      static_cast<float*>(ws), static_cast<int*>(arrivals), geo);
  return (int)cudaGetLastError();
}

bool geometry_ok(int batch, int kv_heads, int page_size, int head_dim,
                 int row_multiple, int group, int pages_per_seq,
                 int pages_per_split) {
  return head_dim > 0 && head_dim <= kMaxHd && head_dim % row_multiple == 0 &&
         group > 0 && group <= kMaxG && page_size > 0 && batch > 0 &&
         batch <= 65535 && kv_heads > 0 && kv_heads <= 65535 &&
         pages_per_seq > 0 && pages_per_split > 0 &&
         pages_per_split <= kMaxPps &&
         pages_per_split * page_size <= kMaxSplitRows;
}

Geometry make_geometry(int num_pages, int kv_heads, int page_size,
                       int head_dim, int group, int pages_per_seq,
                       int pages_per_split, float sm_scale) {
  Geometry g;
  g.num_pages = num_pages;
  g.kv_heads = kv_heads;
  g.page_size = page_size;
  g.hd = head_dim;
  g.G = group;
  g.P = pages_per_seq;
  g.pps = pages_per_split;
  g.S = 1;
  g.TR = 1;
  g.sm_scale = sm_scale;
  return g;
}

}  // namespace

// dtype (of q, out and the pools): 0 = float32, 1 = bfloat16. ws: the
// workspace of ceil(pages_per_seq / pages_per_split) splits, batch *
// kv_heads * splits * group * (head_dim + 2) fp32 (unread with one split);
// arrivals: batch * kv_heads int32, 0 before the launch and 0 again after
// it (the split that arrives last sets its row's count back). Returns
// cudaGetLastError() of the launch.
extern "C" int paged_decode(const void* q, const void* kpool,
                            const void* vpool, const void* tables,
                            const void* positions, void* out, void* ws,
                            void* arrivals, int dtype, int batch,
                            int num_pages, int kv_heads,
                            int page_size, int head_dim, int group,
                            int pages_per_seq, int pages_per_split,
                            float sm_scale, void* stream) {
  if (!geometry_ok(batch, kv_heads, page_size, head_dim, 8, group,
                   pages_per_seq, pages_per_split))
    return (int)cudaErrorInvalidValue;
  const Geometry geo =
      make_geometry(num_pages, kv_heads, page_size, head_dim, group,
                    pages_per_seq, pages_per_split, sm_scale);
  if (dtype == 0) {
    const DensePool<float> pool{static_cast<const float*>(kpool),
                                static_cast<const float*>(vpool)};
    return launch<float>(q, pool, tables, positions, out, ws, arrivals, batch,
                         geo, stream);
  }
  if (dtype == 1) {
    const DensePool<__nv_bfloat16> pool{
        static_cast<const __nv_bfloat16*>(kpool),
        static_cast<const __nv_bfloat16*>(vpool)};
    return launch<__nv_bfloat16>(q, pool, tables, positions, out, ws,
                                 arrivals, batch, geo, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// The int8-pool arity. dtype (of q and out): 0 = float32, 1 = bfloat16.
// ws and arrivals as for paged_decode. Returns cudaGetLastError() of the
// launch.
extern "C" int paged_decode_int8(const void* q, const void* kpool,
                                 const void* vpool, const void* kscale,
                                 const void* vscale, const void* tables,
                                 const void* positions, void* out, void* ws,
                                 void* arrivals, int dtype, int batch,
                                 int num_pages,
                                 int kv_heads, int page_size, int head_dim,
                                 int group, int pages_per_seq,
                                 int scale_blocks, int pages_per_split,
                                 float sm_scale, void* stream) {
  if (!geometry_ok(batch, kv_heads, page_size, head_dim, 16, group,
                   pages_per_seq, pages_per_split) ||
      scale_blocks <= 0 || head_dim % scale_blocks != 0)
    return (int)cudaErrorInvalidValue;
  const Geometry geo =
      make_geometry(num_pages, kv_heads, page_size, head_dim, group,
                    pages_per_seq, pages_per_split, sm_scale);
  const Int8Pool pool{static_cast<const int8_t*>(kpool),
                      static_cast<const int8_t*>(vpool),
                      static_cast<const float*>(kscale),
                      static_cast<const float*>(vscale), scale_blocks};
  if (dtype == 0)
    return launch<float>(q, pool, tables, positions, out, ws, arrivals, batch,
                         geo, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, pool, tables, positions, out, ws,
                                 arrivals, batch, geo, stream);
  return (int)cudaErrorInvalidValue;
}
