// Tensor-core tile helpers for the port's attention kernels on Hopper:
// bf16 operands, fp32 accumulators, mma.sync.m16n8k16 fed by ldmatrix,
// cp.async staging into padded shared-memory rows, and the quad
// reductions over the mma fragment layout. Every definition sits in an
// unnamed namespace, so each source that includes this header holds its
// own copy.
//
// The fragment layout of mma.m16n8k16 (PTX ISA, "Matrix Fragments for
// mma.m16n8k16"), lane = 4 * g + t (g = lane / 4, t = lane % 4):
//   A (16 x 16, row): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//                     a3 (g+8, 2t+8..)
//   B (16 x 8, col):  b0 (k 2t..2t+1, n g), b1 (k 2t+8.., n g)
//   C (16 x 8, fp32): c0 c1 (g, 2t..2t+1), c2 c3 (g+8, 2t..2t+1)
// So the C fragments of two neighbouring 8-column tiles are the A
// fragment of their 16 columns: scores become the P operand of P.V in
// registers, and a row's values sit in the four lanes of a quad.
//
// Shared tiles hold rows of Dp = roundup(D, 16) bf16 at a stride of
// Dp + 8 elements: ldmatrix reads 8 rows of 16 bytes per 8 x 8 matrix,
// and a stride of 4 (mod 8) 32-bit words puts those 8 rows on 8 disjoint
// groups of 4 banks for every Dp. (An XOR swizzle needs Dp a multiple of
// 64, which head dims like 40 or 72 are not.) Columns D..Dp-1 are zeroed
// once, so a head dim that is a multiple of 8 but not of 16 runs the
// same mma steps with a zero tail.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kPadCols = 8;      // shared row stride: Dp + kPadCols

__host__ __device__ inline int pad16(int d) { return (d + 15) & ~15; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8 x 8 b16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i, register i holds this lane's pair of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// the same, each matrix transposed on the way (V's rows as B columns)
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a . b on the tensor cores: a 16 x 16 bf16, b 16 x 8 bf16, d fp32
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two fp32 values rounded to bf16 (to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the two bf16 halves of x as fp32 (exact), the low half first
__device__ __forceinline__ float2 bf16x2_to_float2(uint32_t x) {
  return make_float2(__uint_as_float(x << 16),
                     __uint_as_float(x & 0xFFFF0000u));
}

// |x| of both bf16 halves: the sign bits cleared
__device__ __forceinline__ uint32_t abs_bf16x2(uint32_t x) {
  return x & 0x7FFF7FFFu;
}

// whether p, off by at most `ulps` fp32 ulps, could round to bf16
// otherwise: a rounding midpoint (low 16 bits 0x8000) lies within `ulps`
// of it
__device__ __forceinline__ bool near_bf16_tie(float p, float ulps) {
  const int low = (int)(__float_as_uint(p) & 0xFFFFu) - 0x8000;
  return (float)abs(low) <= ulps;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the max and the sum over the four lanes of a quad (one fragment row)
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// rows [0, n) of a contiguous (., D) bf16 matrix into shared rows of
// stride ld, 16 bytes per cp.async, spread over the CTA (D % 8 == 0,
// src 16-byte aligned). The thread's (row, 16-byte column) steps by the
// CTA's width without a division in the loop.
__device__ __forceinline__ void stage_rows_async(bf16* dst, int ld,
                                                 const bf16* src, int n,
                                                 int D) {
  const int per_row = D >> 3;
  const int nthr = blockDim.x;
  const int rstep = nthr / per_row, cstep = nthr - rstep * per_row;
  int r = threadIdx.x / per_row, c = threadIdx.x - r * per_row;
  for (int i = threadIdx.x; i < n * per_row; i += nthr) {
    cp_async16(dst + r * ld + c * 8, src + (size_t)i * 8);
    r += rstep;
    c += cstep;
    if (c >= per_row) {
      c -= per_row;
      ++r;
    }
  }
}

// zero columns [D, Dp) of n shared rows of stride ld: the mma's zero tail
__device__ __forceinline__ void zero_tail(bf16* dst, int ld, int n, int D,
                                          int Dp) {
  const int per_row = (Dp - D) >> 3;
  for (int i = threadIdx.x; i < n * per_row; i += blockDim.x) {
    const int r = i / per_row;
    *reinterpret_cast<uint4*>(dst + r * ld + D + (i - r * per_row) * 8) =
        make_uint4(0u, 0u, 0u, 0u);
  }
}

// launch with `threads` threads per CTA and `smem` bytes of dynamic
// shared memory (opting in above 48 KB); the launch's error
template <typename... KArgs, typename... Args>
cudaError_t launch_rows(void (*kernel)(KArgs...), dim3 grid, int threads,
                        size_t smem, cudaStream_t s, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, smem, s>>>(args...);
  return cudaGetLastError();
}

}  // namespace
