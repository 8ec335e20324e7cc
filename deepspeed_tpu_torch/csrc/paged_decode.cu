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
// softmax is online in fp32 with scale sm_scale and q is widened to fp32.
// Dense: q.K takes the pool dtype's values with fp32 accumulation, and the
// probabilities are rounded to the pool dtype before the P.V product. Int8:
// every product is fp32 and nothing is rounded before the output. A row with
// nothing visible writes 0, never NaN. In GQA the G query heads of a group
// share one kv head's pages.
//
// What bounds it on an H100: device-memory bytes. Each block reads K and V of
// its row's live pages once (page_size * hd * 2 values per live page per kv
// head) and does 4 * G * hd flops per staged token, far below the ~295
// flop/byte at which the card's bf16 tensor cores would become the limit.
// So the design spends nothing on tensor cores and keeps every byte read
// once: one block per (row, kv head) loads its own block-table entries, walks
// only its live pages, stages each page in tiles of kChunk token rows in
// shared memory with 16-byte vector loads (only the visible rows are
// loaded), and scores all G queries of the group against the staged tile so
// K and V cross device memory once per group, not once per query head.
// The int8 pool halves the bytes and adds 2 * hd dequantizing multiplies per
// token row, still far below the balance: its loader reads 16 int8 values per
// 16-byte vector and dequantizes them on the way into shared memory as fp32;
// scales are read one fp32 at a time through the read-only cache (a tile's
// scales are shared by the threads of its rows).
// Not done yet (later work): cp.async double buffering, several rows per
// block, split-K over long contexts.
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
constexpr int kChunk = 16;   // token rows staged per shared-memory tile
constexpr int kMaxHd = 256;
constexpr int kMaxG = 8;
constexpr int kMaxAcc = kMaxG * kMaxHd / kThreads;  // fp32 acc per thread
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

// the probabilities as the P.V product sees them: rounded to the pool dtype
template <typename T>
__device__ __forceinline__ float round_to_pool(float x) {
  return to_f(from_f<T>(x));
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

// A pool hands the kernel body the visible token rows of one tile: rows
// c0 .. c0+vis of kv head `head` (= page * kv_heads + kh), staged into k_s and
// v_s as `Tile` values, row t at t * hd. The visible rows of a tile are
// contiguous in the pool: vector x is row x / row_vecs.

// bf16 or fp32 pools, staged as they are
template <typename T>
struct DensePool {
  using Tile = T;
  static constexpr bool kRoundP = true;  // p goes to the pool dtype before P.V
  const T* k;
  const T* v;

  __device__ __forceinline__ void load(size_t head, int page_size, int hd,
                                       int c0, int vis, Tile* k_s, Tile* v_s,
                                       int tid) const {
    constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
    const int row_vecs = hd / kVec;
    const size_t tile = head * page_size * hd + (size_t)c0 * hd;
    const uint4* ksrc = reinterpret_cast<const uint4*>(k + tile);
    const uint4* vsrc = reinterpret_cast<const uint4*>(v + tile);
    uint4* kdst = reinterpret_cast<uint4*>(k_s);
    uint4* vdst = reinterpret_cast<uint4*>(v_s);
    for (int x = tid; x < vis * row_vecs; x += kThreads) {
      kdst[x] = ksrc[x];
      vdst[x] = vsrc[x];
    }
  }
};

// 16 int8 values of one token row, starting at value d0, times the row's
// block scales -> 16 fp32 at dst (16-byte aligned). blk = hd / nb values
// share a scale; uniform says blk % 16 == 0, so the 16 share one.
__device__ __forceinline__ void dequant16(uint4 raw,
                                          const float* __restrict__ scales,
                                          int d0, int blk, bool uniform,
                                          float* __restrict__ dst) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  int cur = d0 / blk;
  float sc = __ldg(scales + cur);
  float vals[16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = 4 * i + j;   // little endian: byte j of word i
      if (!uniform) {
        const int bi = (d0 + e) / blk;
        if (bi != cur) {
          cur = bi;
          sc = __ldg(scales + cur);
        }
      }
      const int v = (int)(int8_t)((w[i] >> (8 * j)) & 0xffu);
      vals[e] = (float)v * sc;
    }
  }
  float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    d4[i] = make_float4(vals[4 * i], vals[4 * i + 1], vals[4 * i + 2],
                        vals[4 * i + 3]);
}

// int8 pools with fp32 scale pools, dequantized into fp32 tiles
struct Int8Pool {
  using Tile = float;
  static constexpr bool kRoundP = false;  // fp32 throughout
  const int8_t* k;
  const int8_t* v;
  const float* kscale;
  const float* vscale;
  int nb;

  __device__ __forceinline__ void load(size_t head, int page_size, int hd,
                                       int c0, int vis, Tile* k_s, Tile* v_s,
                                       int tid) const {
    constexpr int kVec = 16;  // int8 values per 16-byte load
    const int row_vecs = hd / kVec;
    const int blk = hd / nb;
    const bool uniform = (blk % kVec) == 0;
    const size_t tile = head * page_size * hd + (size_t)c0 * hd;
    const uint4* ksrc = reinterpret_cast<const uint4*>(k + tile);
    const uint4* vsrc = reinterpret_cast<const uint4*>(v + tile);
    const float* ksc = kscale + (head * page_size + c0) * nb;
    const float* vsc = vscale + (head * page_size + c0) * nb;
    for (int x = tid; x < vis * row_vecs; x += kThreads) {
      const int t = x / row_vecs;
      const int d0 = (x - t * row_vecs) * kVec;
      const uint4 kraw = ksrc[x];
      const uint4 vraw = vsrc[x];
      dequant16(kraw, ksc + t * nb, d0, blk, uniform, k_s + t * hd + d0);
      dequant16(vraw, vsc + t * nb, d0, blk, uniform, v_s + t * hd + d0);
    }
  }
};

template <typename T, typename Pool>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const Pool pool,
                    const int32_t* __restrict__ tables,
                    const int32_t* __restrict__ positions,
                    T* __restrict__ out, int num_pages, int kv_heads,
                    int page_size, int hd, int G, int pages_per_seq,
                    float sm_scale) {
  using Tile = typename Pool::Tile;
  __shared__ __align__(16) Tile k_s[kChunk * kMaxHd];
  __shared__ __align__(16) Tile v_s[kChunk * kMaxHd];
  __shared__ float q_s[kMaxG * kMaxHd];
  __shared__ float p_s[kMaxG][kChunk];
  __shared__ float m_s[kMaxG];
  __shared__ float l_s[kMaxG];
  __shared__ float alpha_s[kMaxG];

  const int b = blockIdx.x;
  const int kh = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int pos = positions[b];
  int num_pg = pos < 0 ? 0 : pos / page_size + 1;
  if (num_pg > pages_per_seq) num_pg = pages_per_seq;

  // this kv head's G query rows, widened to fp32 once
  const size_t row0 = (size_t)b * kv_heads * G + (size_t)kh * G;
  const T* qb = q + row0 * hd;
  for (int i = tid; i < G * hd; i += kThreads) q_s[i] = to_f(qb[i]);
  if (tid < G) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[kMaxAcc];
#pragma unroll
  for (int j = 0; j < kMaxAcc; ++j) acc[j] = 0.f;
  __syncthreads();

  for (int i = 0; i < num_pg; ++i) {
    const int page = tables[(size_t)b * pages_per_seq + i];
    if (page <= 0 || page >= num_pages) continue;  // null page: all masked
    const size_t head = (size_t)page * kv_heads + kh;
    for (int c0 = 0; c0 < page_size; c0 += kChunk) {
      // visible rows of this tile: absolute position i*page_size+c0+t <= pos
      int vis = pos - (i * page_size + c0) + 1;
      if (vis > page_size - c0) vis = page_size - c0;
      if (vis > kChunk) vis = kChunk;
      if (vis <= 0) break;  // the rest of the page is past pos
      pool.load(head, page_size, hd, c0, vis, k_s, v_s, tid);
      __syncthreads();

      // scores: one warp per (query g, row t), lanes stride over hd
      for (int gt = warp; gt < G * vis; gt += kWarps) {
        const int g = gt / vis;
        const int t = gt - g * vis;
        float s = 0.f;
        for (int d = lane; d < hd; d += 32)
          s += q_s[g * hd + d] * to_f(k_s[t * hd + d]);
        s = warp_sum(s);
        if (lane == 0) p_s[g][t] = s * sm_scale;
      }
      __syncthreads();

      // online softmax: warp w owns queries w, w+kWarps, ...; lane t row t
      for (int g = warp; g < G; g += kWarps) {
        const bool ok = lane < vis;
        const float s = ok ? p_s[g][lane] : kNegInf;
        const float m_old = m_s[g];
        const float m_new = fmaxf(m_old, warp_max(s));
        const float p = ok ? expf(s - m_new) : 0.f;
        const float sum = warp_sum(p);
        if (ok) p_s[g][lane] = Pool::kRoundP ? round_to_pool<T>(p) : p;
        if (lane == 0) {
          const float alpha = expf(m_old - m_new);
          alpha_s[g] = alpha;
          l_s[g] = l_s[g] * alpha + sum;
          m_s[g] = m_new;
        }
      }
      __syncthreads();

      // acc[g, d] = acc * alpha[g] + sum_t p[g, t] * v[t, d]
#pragma unroll
      for (int j = 0; j < kMaxAcc; ++j) {
        const int e = tid + j * kThreads;
        if (e < G * hd) {
          const int g = e / hd;
          const int d = e - g * hd;
          float a = acc[j] * alpha_s[g];
          for (int t = 0; t < vis; ++t) a += p_s[g][t] * to_f(v_s[t * hd + d]);
          acc[j] = a;
        }
      }
      __syncthreads();
    }
  }

  // a row that saw nothing keeps l == 0 and acc == 0: it writes 0
  T* ob = out + row0 * hd;
#pragma unroll
  for (int j = 0; j < kMaxAcc; ++j) {
    const int e = tid + j * kThreads;
    if (e < G * hd) {
      const float l = l_s[e / hd];
      ob[e] = from_f<T>(acc[j] / (l == 0.f ? 1.f : l));
    }
  }
}

template <typename T, typename Pool>
int launch(const void* q, Pool pool, const void* tables,
           const void* positions, void* out, int batch, int num_pages,
           int kv_heads, int page_size, int head_dim, int group,
           int pages_per_seq, float sm_scale, void* stream) {
  const dim3 grid(batch, kv_heads);
  paged_decode_kernel<T, Pool>
      <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(q), pool,
          static_cast<const int32_t*>(tables),
          static_cast<const int32_t*>(positions), static_cast<T*>(out),
          num_pages, kv_heads, page_size, head_dim, group, pages_per_seq,
          sm_scale);
  return (int)cudaGetLastError();
}

bool geometry_ok(int batch, int kv_heads, int page_size, int head_dim,
                 int row_multiple, int group, int pages_per_seq) {
  return head_dim > 0 && head_dim <= kMaxHd && head_dim % row_multiple == 0 &&
         group > 0 && group <= kMaxG && page_size > 0 && batch > 0 &&
         kv_heads > 0 && pages_per_seq > 0;
}

}  // namespace

// dtype (of q, out and the pools): 0 = float32, 1 = bfloat16. Returns
// cudaGetLastError() of the launch.
extern "C" int paged_decode(const void* q, const void* kpool,
                            const void* vpool, const void* tables,
                            const void* positions, void* out, int dtype,
                            int batch, int num_pages, int kv_heads,
                            int page_size, int head_dim, int group,
                            int pages_per_seq, float sm_scale,
                            void* stream) {
  if (!geometry_ok(batch, kv_heads, page_size, head_dim, 8, group,
                   pages_per_seq))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    const DensePool<float> pool{static_cast<const float*>(kpool),
                                static_cast<const float*>(vpool)};
    return launch<float>(q, pool, tables, positions, out, batch, num_pages,
                         kv_heads, page_size, head_dim, group, pages_per_seq,
                         sm_scale, stream);
  }
  if (dtype == 1) {
    const DensePool<__nv_bfloat16> pool{
        static_cast<const __nv_bfloat16*>(kpool),
        static_cast<const __nv_bfloat16*>(vpool)};
    return launch<__nv_bfloat16>(q, pool, tables, positions, out, batch,
                                 num_pages, kv_heads, page_size, head_dim,
                                 group, pages_per_seq, sm_scale, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// The int8-pool arity. dtype (of q and out): 0 = float32, 1 = bfloat16.
// Returns cudaGetLastError() of the launch.
extern "C" int paged_decode_int8(const void* q, const void* kpool,
                                 const void* vpool, const void* kscale,
                                 const void* vscale, const void* tables,
                                 const void* positions, void* out, int dtype,
                                 int batch, int num_pages, int kv_heads,
                                 int page_size, int head_dim, int group,
                                 int pages_per_seq, int scale_blocks,
                                 float sm_scale, void* stream) {
  if (!geometry_ok(batch, kv_heads, page_size, head_dim, 16, group,
                   pages_per_seq) ||
      scale_blocks <= 0 || head_dim % scale_blocks != 0)
    return (int)cudaErrorInvalidValue;
  const Int8Pool pool{static_cast<const int8_t*>(kpool),
                      static_cast<const int8_t*>(vpool),
                      static_cast<const float*>(kscale),
                      static_cast<const float*>(vscale), scale_blocks};
  if (dtype == 0)
    return launch<float>(q, pool, tables, positions, out, batch, num_pages,
                         kv_heads, page_size, head_dim, group, pages_per_seq,
                         sm_scale, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, pool, tables, positions, out, batch,
                                 num_pages, kv_heads, page_size, head_dim,
                                 group, pages_per_seq, sm_scale, stream);
  return (int)cudaErrorInvalidValue;
}
