// Tile helpers shared by the port's attention kernels (masked_flash.cu,
// flash.cu, blocksparse_v2.cu, banded.cu): fp32 products of shared-memory
// tiles on the CUDA cores, row staging, warp reductions, the attention
// dropout hash and the launch wrapper. Every
// definition sits in an unnamed namespace, so each source that includes
// this header holds its own copy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 32;        // rows a CTA owns, and rows per chunk
constexpr int kMaxBlk = 128;     // widest walk block
constexpr int kMaxHd = 128;
constexpr float kNegInf = -1e30f;       // flash.NEG_INF

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

// x as the next product's operand sees it: rounded to the operand dtype
template <typename T>
__device__ __forceinline__ float round_to(float x) {
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

// C[r][c] = (accumulate ? C[r][c] * row_scale[r] : 0) + sum_k A(r,k) B(k,c)
// for r < R, c < N, k < K, with A(r,k) = A[r*sar + k*sak] and
// B(k,c) = B[k*sbk + c*sbc], all fp32 in shared memory. Each thread owns
// 2 x 4 outputs: rows 2*rb, 2*rb+1 and columns cb + j*(N/4), so the lanes
// of a warp read neighbouring B columns and mostly one A row (a broadcast).
__device__ __forceinline__ void mm(float* C, int ldc, bool accumulate,
                                   const float* row_scale, const float* A,
                                   int sar, int sak, const float* B, int sbk,
                                   int sbc, int R, int N, int K) {
  constexpr int RPT = 2, CPT = 4;
  const int ncb = N / CPT;
  const int items = (R / RPT) * ncb;
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int rb = it / ncb;
    const int cb = it - rb * ncb;
    const float* a = A + (size_t)rb * RPT * sar;
    const float* b = B + (size_t)cb * sbc;
    float acc[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;
    for (int k = 0; k < K; ++k) {
      float av[RPT], bv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) av[i] = a[i * sar + k * sak];
#pragma unroll
      for (int j = 0; j < CPT; ++j) bv[j] = b[j * ncb * sbc + k * sbk];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = rb * RPT + i;
      const float sc = row_scale ? row_scale[r] : 1.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        float* cp = C + (size_t)r * ldc + cb + j * ncb;
        *cp = (accumulate ? *cp * sc : 0.f) + acc[i][j];
      }
    }
  }
}

// rows [0, n) of a (., D) global matrix -> fp32 shared rows of stride D+1
template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, int n,
                                           int D) {
  for (int e = threadIdx.x; e < n * D; e += blockDim.x) {
    const int r = e / D;
    const int d = e - r * D;
    dst[r * (D + 1) + d] = to_f(src[(size_t)r * D + d]);
  }
}

__device__ __forceinline__ void fill(float* dst, int n, float v) {
  for (int e = threadIdx.x; e < n; e += blockDim.x) dst[e] = v;
}

// the rows a CTA owns for a walk block: R = min(blk, 32)
__host__ __device__ inline int rows_of(int blk) {
  return blk < kRows ? blk : kRows;
}

// flash.dropout_keep_mask: a lowbias32-style hash of (seed, bh, q, k)
__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  return x ^ (x >> 16);
}

struct Dropout {
  int on;              // 0: no dropout
  uint32_t thresh;     // keep iff hash < thresh
  float inv_keep;      // 1 / (1 - rate), rounded to fp32
  uint32_t seed;       // the int32 seed's bits
  uint32_t bh0;        // added to b * H + h: a rank's first global row * H

  // the two-round finalizer (flash._HASH_FINAL_ROUNDS == 2, which the
  // wrappers require)
  __device__ __forceinline__ bool keep(int bh, int qi, int ki) const {
    const uint32_t row = mix32(
        (uint32_t)qi ^ (((uint32_t)bh + bh0) * 0x9E3779B9u) ^ seed);
    return mix32(row ^ (uint32_t)ki) < thresh;
  }
};

inline Dropout make_dropout(int on, uint32_t thresh, float inv_keep,
                            int seed, int bh0 = 0) {
  Dropout dr;
  dr.on = on;
  dr.thresh = thresh;
  dr.inv_keep = inv_keep;
  dr.seed = (uint32_t)seed;
  dr.bh0 = (uint32_t)bh0;
  return dr;
}

template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem);
  return cudaSuccess;
}

template <typename... KArgs, typename... Args>
cudaError_t launch(void (*kernel)(KArgs...), dim3 grid, size_t smem,
                   cudaStream_t s, Args... args) {
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, s>>>(args...);
  return cudaGetLastError();
}

}  // namespace
