// One-token decode attention straight against the paged KV pool, for Hopper.
//
// Replaces deepspeed_tpu/ops/attention/paged.py::_decode_kernel (the Pallas
// TPU kernel built by _paged_decode_pallas), dense-pool arity. Same function:
//   q (B, KH*G, hd); kpool, vpool (N, KH, page_size, hd); tables (B, P) int32;
//   positions (B,) int32 -> out (B, KH*G, hd) in q's dtype.
// Row b attends its positions 0..pos over exactly pos / page_size + 1 pages
// of its table (capped at P). Positions past pos and table entries that are
// the null page 0 (or outside [1, N)) are masked. The softmax is online in
// fp32 with scale sm_scale; q.K takes the pool dtype's values with fp32
// accumulation; the probabilities are rounded to the pool dtype before the
// P.V product; a row with nothing visible writes 0, never NaN. In GQA the G
// query heads of a group share one kv head's pages.
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kpool,
                    const T* __restrict__ vpool,
                    const int32_t* __restrict__ tables,
                    const int32_t* __restrict__ positions,
                    T* __restrict__ out, int num_pages, int kv_heads,
                    int page_size, int hd, int G, int pages_per_seq,
                    float sm_scale) {
  __shared__ __align__(16) T k_s[kChunk * kMaxHd];
  __shared__ __align__(16) T v_s[kChunk * kMaxHd];
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

  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  const int row_vecs = hd / kVec;
  const size_t head_stride = (size_t)page_size * hd;
  for (int i = 0; i < num_pg; ++i) {
    const int page = tables[(size_t)b * pages_per_seq + i];
    if (page <= 0 || page >= num_pages) continue;  // null page: all masked
    const size_t page_off = ((size_t)page * kv_heads + kh) * head_stride;
    for (int c0 = 0; c0 < page_size; c0 += kChunk) {
      // visible rows of this tile: absolute position i*page_size+c0+t <= pos
      int vis = pos - (i * page_size + c0) + 1;
      if (vis > page_size - c0) vis = page_size - c0;
      if (vis > kChunk) vis = kChunk;
      if (vis <= 0) break;  // the rest of the page is past pos
      const uint4* ksrc =
          reinterpret_cast<const uint4*>(kpool + page_off + (size_t)c0 * hd);
      const uint4* vsrc =
          reinterpret_cast<const uint4*>(vpool + page_off + (size_t)c0 * hd);
      uint4* kdst = reinterpret_cast<uint4*>(k_s);
      uint4* vdst = reinterpret_cast<uint4*>(v_s);
      for (int x = tid; x < vis * row_vecs; x += kThreads) {
        kdst[x] = ksrc[x];
        vdst[x] = vsrc[x];
      }
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
        if (ok) p_s[g][lane] = round_to_pool<T>(p);
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() of the launch.
extern "C" int paged_decode(const void* q, const void* kpool,
                            const void* vpool, const void* tables,
                            const void* positions, void* out, int dtype,
                            int batch, int num_pages, int kv_heads,
                            int page_size, int head_dim, int group,
                            int pages_per_seq, float sm_scale,
                            void* stream) {
  if (head_dim <= 0 || head_dim > kMaxHd || head_dim % 8 != 0 ||
      group <= 0 || group > kMaxG || page_size <= 0 || batch <= 0 ||
      kv_heads <= 0 || pages_per_seq <= 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(batch, kv_heads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    paged_decode_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(kpool),
        static_cast<const float*>(vpool),
        static_cast<const int32_t*>(tables),
        static_cast<const int32_t*>(positions), static_cast<float*>(out),
        num_pages, kv_heads, page_size, head_dim, group, pages_per_seq,
        sm_scale);
  } else if (dtype == 1) {
    paged_decode_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(kpool),
        static_cast<const __nv_bfloat16*>(vpool),
        static_cast<const int32_t*>(tables),
        static_cast<const int32_t*>(positions),
        static_cast<__nv_bfloat16*>(out), num_pages, kv_heads, page_size,
        head_dim, group, pages_per_seq, sm_scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
