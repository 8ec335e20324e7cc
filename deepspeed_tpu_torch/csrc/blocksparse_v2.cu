// Row-run block-sparse attention, forward and backward, for Hopper.
//
// Replaces the three Pallas TPU kernels of
// deepspeed_tpu/ops/sparse_attention/blocksparse_v2.py, in both arities
// (the template flag HAS_AM; null tiles pick HAS_AM = false):
//   K8  _v2_fwd_kernel -> blocksparse_v2_fwd : o, lse  (CSR row walk)
//   K9  _v2_dq_kernel  -> blocksparse_v2_dq  : dq      (CSR row walk)
//   K10 _v2_dkv_kernel -> blocksparse_v2_dkv : dk, dv  (CSC column walk)
// Same function as the Pallas kernels:
//   q, k, v (B*H, S, D) in fp32 or bf16; a layout of H heads walked at
//   block `blk` through its CSR (offs, cnts, cols, uids) or CSC (offs,
//   cnts, rows, uids) metadata over rows h * nq + r (columns h * nk + c);
//   per walked item the additive fp32 mask tile tiles[uid] (blk x blk,
//   row-major: query row, then key: a user mask, or a coarse walk's
//   structural tiles), or with null tiles none (JAX's has_am = False at
//   the fine walk: the kernels read no tile and no uid); optionally an
//   additive fp32 key mask kpm (B, S) (null: none).
// Semantics kept exactly: s = (q.k) * sm_scale, then s += kpm[b, key],
// then s += tile[q, key] (HAS_AM), in fp32; a cell with s <= VALID_THRESH
// (-1e29) has p = 0. The forward's online softmax runs per walked tile with no
// m_safe guard (p = exp(s - m_new), alpha = exp(m_old - m_new)); a row
// with l == 0 writes o = 0 and lse = m. K9 and K10 recompute
// p = exp(s - lse). p is rounded to V's (K10: do's) dtype before its
// product, ds = p * (dp - delta) to K's (K10: q's) dtype before its
// product; every sum accumulates in fp32. dq and dk are scaled by sm_scale
// once at the end, dv is not. A row or column whose every cell is masked
// (by the tile, the key mask or both) adds exactly 0.
//
// What bounds it on an H100: operations. At the main path's shape (B 8,
// H 16, S 2048, D 64, the fixed per-head layouts of ds_config_sparse.json
// at block 16) a walked 16 x 16 tile does 2-4 products of 16 x 16 x 64
// over 2 x 16 x 64 staged values and 256 mask values. In bf16 the three
// run on the tensor cores (mma.sync m16n8k16, the scores and accumulators
// in registers, the partner rows staged as bf16 by cp.async into a ring
// of chunks) with RowRunRule (-1e29), each score plus its cell of the
// walked item's mask tile, read straight from global memory (the few
// distinct tiles sit in L2): K8 on K1's forward body (mma_fwd.cuh, the
// mask per 8-key fragment; lse = m where l == 0) over the CSR walk of a
// block row, K9 on K2's dq body (mma_dq.cuh, float2 mask pairs per 8-key
// fragment) over the same walk, K10 on K3's dk/dv body (mma_dkv.cuh,
// which holds S^T: four scalar mask loads per 8-query tile, the cells of
// a key row blk apart in the row-major tile) over the CSC walk of a
// block column; every walked tile is FULL. A CTA owns R = min(blk, 64)
// rows of a block row (K8, K9) or keys of a block column (K10), 16 per
// warp, so at walk 128 two CTAs share one block row's or column's tiles
// (tr0 = r0 % blk, tc0 = kr0 % blk); an empty row or column walks
// nothing and writes zeros. In fp32 the three keep the first, simple
// design of masked_flash.cu (flash_tiles.cuh): fp32 FMAs on the CUDA
// cores, no tensor cores (TF32 would fail the fp32 checks). A CTA of 128
// threads owns R = min(blk, 32) rows of a walked block row (K8, K9) or
// column (K10); it stages its own rows once and each walked item's
// partner rows in chunks of R into shared memory as fp32, reads the mask
// tile's cells straight from global memory (each once per CTA), and keeps
// the softmax state and the accumulators in shared memory. The Pallas
// design's double-buffered DMA of transposed (D, block) tiles is a Mosaic
// lane rule and is not carried over. Later work: wgmma, TMA staging.
//
// Built by deepspeed_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// into a library with a plain C interface, loaded through ctypes.

#include <stdint.h>

#include "flash_tiles.cuh"
#include "mma_dq.cuh"

namespace {

// blocksparse_v2.VALID_THRESH (RowRunRule's in the tensor-core body)
constexpr float kRowRunThresh = -1e29f;

struct Shape {
  int H, S, D, blk;  // heads, sequence length, head dim, walk block
  float sm_scale;
};

// ------------------------------------------------------------------- K8
// fp32 (the CUDA-core body): grid (S / R, B*H); R = min(blk, 32) q rows
// per CTA.
template <typename T, bool HAS_AM>
__global__ void __launch_bounds__(kThreads)
v2_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const float* __restrict__ kpm,
              const float* __restrict__ tiles, T* __restrict__ o,
              float* __restrict__ lse, const int32_t* __restrict__ offs,
              const int32_t* __restrict__ cnts,
              const int32_t* __restrict__ cols,
              const int32_t* __restrict__ uids, Shape sh) {
  extern __shared__ float smem[];
  const int D = sh.D, blk = sh.blk;
  const int R = rows_of(blk);
  const int bh = blockIdx.y;
  const int h = bh % sh.H;
  const int b = bh / sh.H;
  const int r0 = blockIdx.x * R;
  const int mrow = h * (sh.S / blk) + r0 / blk;
  const int n = cnts[mrow];
  const int base = offs[mrow];
  const T* kg = k + (size_t)bh * sh.S * D;
  const T* vg = v + (size_t)bh * sh.S * D;
  const float* kpm_b = kpm ? kpm + (size_t)b * sh.S : nullptr;
  const int tr0 = r0 % blk;               // this CTA's first row in a tile

  float* qs = smem;                       // R x (D+1)
  float* ss = qs + R * (D + 1);           // R x blk: s, then p
  float* os = ss + R * blk;               // R x D accumulator
  float* kv = os + R * D;                 // R x (D+1) staged K or V rows
  float* m_s = kv + R * (D + 1);          // R
  float* l_s = m_s + R;                   // R
  float* a_s = l_s + R;                   // R: this tile's alpha

  stage_rows(qs, q + ((size_t)bh * sh.S + r0) * D, R, D);
  fill(os, R * D, 0.f);
  fill(m_s, R, kNegInf);
  fill(l_s, R, 0.f);
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int t = 0; t < n; ++t) {
    const int k0 = cols[base + t] * blk;
    const float* tile =
        HAS_AM ? tiles + (size_t)uids[base + t] * blk * blk + (size_t)tr0 * blk
               : nullptr;
    // s = q . k over the whole walked tile, R x blk
    for (int c0 = 0; c0 < blk; c0 += R) {
      stage_rows(kv, kg + (size_t)(k0 + c0) * D, R, D);
      __syncthreads();
      mm(ss + c0, blk, false, nullptr, qs, D + 1, 1, kv, 1, D + 1, R, R, D);
      __syncthreads();
    }
    // online softmax of the tile: warp w owns rows w, w + 4, ...
    for (int r = warp; r < R; r += kWarps) {
      float sv[kMaxBlk / 32];
      float mx = kNegInf;
#pragma unroll
      for (int u = 0; u < kMaxBlk / 32; ++u) {
        const int c = lane + 32 * u;
        float s = kNegInf;
        if (c < blk) {
          s = ss[r * blk + c] * sh.sm_scale;
          if (kpm_b) s += kpm_b[k0 + c];
          if (HAS_AM) s += tile[r * blk + c];
        }
        sv[u] = s;
        mx = fmaxf(mx, s);
      }
      mx = warp_max(mx);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < kMaxBlk / 32; ++u) {
        const int c = lane + 32 * u;
        if (c < blk) {
          const float p = sv[u] > kRowRunThresh ? expf(sv[u] - m_new) : 0.f;
          sum += p;
          ss[r * blk + c] = round_to<T>(p);
        }
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
    // acc = acc * alpha + p . v, alpha with chunk 0's product
    for (int c0 = 0; c0 < blk; c0 += R) {
      stage_rows(kv, vg + (size_t)(k0 + c0) * D, R, D);
      __syncthreads();
      mm(os, D, true, c0 == 0 ? a_s : nullptr, ss + c0, blk, 1, kv, D + 1, 1,
         R, D, R);
      __syncthreads();
    }
  }

  T* og = o + ((size_t)bh * sh.S + r0) * D;
  for (int e = threadIdx.x; e < R * D; e += blockDim.x) {
    const float l = l_s[e / D];
    og[e] = from_f<T>(os[e] / (l == 0.f ? 1.f : l));
  }
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    const float l = l_s[r];
    lse[(size_t)bh * sh.S + r0 + r] = m_s[r] + logf(l == 0.f ? 1.f : l);
  }
}

// K8 and K9 in bf16 (the tensor-core bodies, mma_fwd.cuh and mma_dq.cuh):
// grid (S / R, B*H), R = min(blk, 64) q rows of one block row per CTA, 16
// per warp; K8's W = blk.
struct RowRunWalk {
  const int32_t* cols;    // the block row's CSR columns and mask uids
  const int32_t* uids;
  const float* tiles;     // (U, blk, blk), or null (AM = false)
  int count, blk, tr0;    // tr0: the CTA's first row within a tile
  __device__ __forceinline__ int n() const { return count; }
  __device__ __forceinline__ int keys() const { return blk; }
  __device__ __forceinline__ int2 tile(int t) const {
    return make_int2(cols[t] * blk, 0);
  }
  __device__ __forceinline__ const float* mask(int t) const {
    return tiles + ((size_t)uids[t] * blk + tr0) * blk;
  }
  __device__ __forceinline__ int mask_ld() const { return blk; }
};

template <int W, int DMAX, bool KPM, bool AM>
__global__ void __launch_bounds__(2 * kMmaMaxRows,
                                  mma_fwd_min_ctas(W, DMAX, AM))
v2_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const float* __restrict__ kpm,
                  const float* __restrict__ tiles, bf16* __restrict__ o,
                  float* __restrict__ lse, const int32_t* __restrict__ offs,
                  const int32_t* __restrict__ cnts,
                  const int32_t* __restrict__ cols,
                  const int32_t* __restrict__ uids, Shape sh) {
  const int R = blockDim.x / 2;
  const int D = sh.D;
  const int bh = blockIdx.y;
  const int b = bh / sh.H;
  const int r0 = blockIdx.x * R;
  const int mrow = (bh % sh.H) * (sh.S / W) + r0 / W;
  const int base = offs[mrow];
  const RowRunWalk walk{cols + base, uids + base, tiles, cnts[mrow], W,
                        r0 % W};
  const size_t row0 = (size_t)bh * sh.S + r0;
  const size_t kv0 = (size_t)bh * sh.S * D;
  const FwdRows rows{q + row0 * D, k + kv0, v + kv0,
                     KPM ? kpm + (size_t)b * sh.S : nullptr, o + row0 * D,
                     lse + row0, r0, D, bh, sh.sm_scale};
  mma_fwd_body<W, DMAX, KPM, false, AM, RowRunRule>(rows, walk, NoBand{},
                                                    Dropout{});
}

// ------------------------------------------------------------------- K9
// fp32 (the CUDA-core body): grid (S / R, B*H); R = min(blk, 32) q rows
// per CTA; per walked item, chunk by chunk of R key rows.
template <bool HAS_AM>
__global__ void __launch_bounds__(kThreads)
v2_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             const float* __restrict__ kpm, const float* __restrict__ tiles,
             float* __restrict__ dq, const int32_t* __restrict__ offs,
             const int32_t* __restrict__ cnts,
             const int32_t* __restrict__ cols,
             const int32_t* __restrict__ uids, Shape sh) {
  extern __shared__ float smem[];
  const int D = sh.D, blk = sh.blk;
  const int R = rows_of(blk);
  const int bh = blockIdx.y;
  const int h = bh % sh.H;
  const int b = bh / sh.H;
  const int r0 = blockIdx.x * R;
  const int mrow = h * (sh.S / blk) + r0 / blk;
  const int n = cnts[mrow];
  const int base = offs[mrow];
  const float* kg = k + (size_t)bh * sh.S * D;
  const float* vg = v + (size_t)bh * sh.S * D;
  const float* kpm_b = kpm ? kpm + (size_t)b * sh.S : nullptr;
  const size_t row0 = (size_t)bh * sh.S + r0;
  const int tr0 = r0 % blk;

  float* qs = smem;                 // R x (D+1)
  float* dos = qs + R * (D + 1);    // R x (D+1)
  float* ks = dos + R * (D + 1);    // R x (D+1)
  float* vs = ks + R * (D + 1);     // R x (D+1)
  float* ps = vs + R * (D + 1);     // R x R: s, then ds
  float* dps = ps + R * R;          // R x R: dp
  float* dqs = dps + R * R;         // R x D accumulator
  float* lse_s = dqs + R * D;       // R
  float* dl_s = lse_s + R;          // R

  stage_rows(qs, q + row0 * D, R, D);
  stage_rows(dos, dout + row0 * D, R, D);
  fill(dqs, R * D, 0.f);
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    lse_s[r] = lse[row0 + r];
    dl_s[r] = delta[row0 + r];
  }
  __syncthreads();

  for (int t = 0; t < n; ++t) {
    const int k0 = cols[base + t] * blk;
    const float* tile =
        HAS_AM ? tiles + (size_t)uids[base + t] * blk * blk + (size_t)tr0 * blk
               : nullptr;
    for (int c0 = 0; c0 < blk; c0 += R) {
      stage_rows(ks, kg + (size_t)(k0 + c0) * D, R, D);
      stage_rows(vs, vg + (size_t)(k0 + c0) * D, R, D);
      __syncthreads();
      mm(ps, R, false, nullptr, qs, D + 1, 1, ks, 1, D + 1, R, R, D);
      mm(dps, R, false, nullptr, dos, D + 1, 1, vs, 1, D + 1, R, R, D);
      __syncthreads();
      for (int e = threadIdx.x; e < R * R; e += blockDim.x) {
        const int r = e / R;
        const int c = e - r * R;
        float s = ps[e] * sh.sm_scale;
        if (kpm_b) s += kpm_b[k0 + c0 + c];
        if (HAS_AM) s += tile[r * blk + c0 + c];
        const float p = s > kRowRunThresh ? expf(s - lse_s[r]) : 0.f;
        ps[e] = p * (dps[e] - dl_s[r]);
      }
      __syncthreads();
      mm(dqs, D, true, nullptr, ps, R, 1, ks, D + 1, 1, R, D, R);
      __syncthreads();
    }
  }

  float* dqg = dq + row0 * D;
  for (int e = threadIdx.x; e < R * D; e += blockDim.x)
    dqg[e] = dqs[e] * sh.sm_scale;
}

// K9 in bf16 (the tensor-core body, mma_dq.cuh): grid (S / R, B*H), R =
// min(blk, 64) q rows of one block row per CTA, over its RowRunWalk; CH =
// dq_chunk(blk) keys per chunk. `tally`: see DqRows.
template <int CH, int DMAX, bool KPM, bool AM>
__global__ void __launch_bounds__(2 * kMmaMaxRows, DMAX <= 64 ? 3 : 2)
v2_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 const float* __restrict__ kpm,
                 const float* __restrict__ tiles, bf16* __restrict__ dq,
                 unsigned long long* tally, const int32_t* __restrict__ offs,
                 const int32_t* __restrict__ cnts,
                 const int32_t* __restrict__ cols,
                 const int32_t* __restrict__ uids, Shape sh) {
  const int R = blockDim.x / 2;
  const int D = sh.D;
  const int bh = blockIdx.y;
  const int b = bh / sh.H;
  const int r0 = blockIdx.x * R;
  const int mrow = (bh % sh.H) * (sh.S / sh.blk) + r0 / sh.blk;
  const int base = offs[mrow];
  const RowRunWalk walk{cols + base, uids + base, tiles, cnts[mrow], sh.blk,
                        r0 % sh.blk};
  const size_t row0 = (size_t)bh * sh.S + r0;
  const size_t kv0 = (size_t)bh * sh.S * D;
  const DqRows rows{q + row0 * D, dout + row0 * D, lse + row0, delta + row0,
                    k + kv0, v + kv0, KPM ? kpm + (size_t)b * sh.S : nullptr,
                    dq + row0 * D, r0, D, bh, sh.sm_scale, tally};
  mma_dq_body<CH, DMAX, KPM, false, RowRunRule, AM>(rows, walk, NoBand{},
                                                    Dropout{});
}

// ------------------------------------------------------------------ K10
// fp32 (the CUDA-core body): grid (S / R, B*H): one CTA per head and R =
// min(blk, 32) key rows, over the CSC walk of the key block, chunk by
// chunk of R query rows. The CTA's R key rows'
// mask values are loaded once, beside the staged K and V rows.
template <bool HAS_AM>
__global__ void __launch_bounds__(kThreads)
v2_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              const float* __restrict__ kpm, const float* __restrict__ tiles,
              float* __restrict__ dk, float* __restrict__ dv,
              const int32_t* __restrict__ coffs,
              const int32_t* __restrict__ ccnts,
              const int32_t* __restrict__ crows,
              const int32_t* __restrict__ uids, Shape sh) {
  extern __shared__ float smem[];
  const int D = sh.D, blk = sh.blk;
  const int R = rows_of(blk);
  const int bh = blockIdx.y;
  const int h = bh % sh.H;
  const int b = bh / sh.H;
  const int kr0 = blockIdx.x * R;
  const int col = h * (sh.S / blk) + kr0 / blk;
  const int n = ccnts[col];
  const int base = coffs[col];
  const float* qg = q + (size_t)bh * sh.S * D;
  const float* dog = dout + (size_t)bh * sh.S * D;
  const int tc0 = kr0 % blk;              // this CTA's first key in a tile

  float* ks = smem;                 // R x (D+1)
  float* vs = ks + R * (D + 1);     // R x (D+1)
  float* qs = vs + R * (D + 1);     // R x (D+1)
  float* dos = qs + R * (D + 1);    // R x (D+1)
  float* ps = dos + R * (D + 1);    // R(q) x R(k): s, then p
  float* dps = ps + R * R;          // R(q) x R(k): dp, then ds
  float* dks = dps + R * R;         // R x D
  float* dvs = dks + R * D;         // R x D
  float* lse_s = dvs + R * D;       // R
  float* dl_s = lse_s + R;          // R
  float* km_s = dl_s + R;           // R: this CTA's key mask (0 without)

  stage_rows(ks, k + ((size_t)bh * sh.S + kr0) * D, R, D);
  stage_rows(vs, v + ((size_t)bh * sh.S + kr0) * D, R, D);
  fill(dks, R * D, 0.f);
  fill(dvs, R * D, 0.f);
  for (int c = threadIdx.x; c < R; c += blockDim.x)
    km_s[c] = kpm ? kpm[(size_t)b * sh.S + kr0 + c] : 0.f;
  __syncthreads();

  for (int t = 0; t < n; ++t) {
    const int q0 = crows[base + t] * blk;
    const float* tile =
        HAS_AM ? tiles + (size_t)uids[base + t] * blk * blk + tc0 : nullptr;
    for (int c0 = 0; c0 < blk; c0 += R) {
      const size_t qrow = (size_t)bh * sh.S + q0 + c0;
      stage_rows(qs, qg + (size_t)(q0 + c0) * D, R, D);
      stage_rows(dos, dog + (size_t)(q0 + c0) * D, R, D);
      for (int r = threadIdx.x; r < R; r += blockDim.x) {
        lse_s[r] = lse[qrow + r];
        dl_s[r] = delta[qrow + r];
      }
      __syncthreads();
      mm(ps, R, false, nullptr, qs, D + 1, 1, ks, 1, D + 1, R, R, D);
      mm(dps, R, false, nullptr, dos, D + 1, 1, vs, 1, D + 1, R, R, D);
      __syncthreads();
      for (int e = threadIdx.x; e < R * R; e += blockDim.x) {
        const int r = e / R;            // query row in the chunk
        const int c = e - r * R;        // key row of this CTA
        float s = ps[e] * sh.sm_scale;
        if (kpm) s += km_s[c];
        if (HAS_AM) s += tile[(size_t)(c0 + r) * blk + c];
        const float p = s > kRowRunThresh ? expf(s - lse_s[r]) : 0.f;
        ps[e] = p;
        dps[e] = p * (dps[e] - dl_s[r]);
      }
      __syncthreads();
      // dv += p^T . do ; dk += ds^T . q
      mm(dvs, D, true, nullptr, ps, 1, R, dos, D + 1, 1, R, D, R);
      mm(dks, D, true, nullptr, dps, 1, R, qs, D + 1, 1, R, D, R);
      __syncthreads();
    }
  }

  float* dkg = dk + ((size_t)bh * sh.S + kr0) * D;
  float* dvg = dv + ((size_t)bh * sh.S + kr0) * D;
  for (int e = threadIdx.x; e < R * D; e += blockDim.x) {
    dkg[e] = dks[e] * sh.sm_scale;
    dvg[e] = dvs[e];
  }
}

// K10 in bf16 (the tensor-core body, mma_dkv.cuh): grid (S / R, B*H), R =
// min(blk, 64) key rows of one block column per CTA, 16 per warp, over
// the column's CSC walk; CH = dkv_chunk(blk) query rows per chunk. The
// tiles are row-major (query, key), so a key row's cells lie blk apart
// and the CTA's keys start tc0 = kr0 % blk into each.
struct ColRunWalk {
  const int32_t* crows;   // the block column's CSC rows and mask uids
  const int32_t* uids;
  const float* tiles;     // (U, blk, blk), or null (AM = false)
  int count, blk, tc0;    // tc0: the CTA's first key within a tile
  __device__ __forceinline__ int n() const { return count; }
  __device__ __forceinline__ int rows() const { return blk; }
  __device__ __forceinline__ int2 tile(int t) const {
    return make_int2(crows[t] * blk, 0);
  }
  __device__ __forceinline__ const float* mask(int t) const {
    return tiles + (size_t)uids[t] * blk * blk + tc0;
  }
  __device__ __forceinline__ int mask_ld() const { return blk; }
};

template <int CH, int DMAX, bool KPM, bool AM>
__global__ void __launch_bounds__(2 * kMmaMaxRows, DMAX <= 64 ? 3 : 2)
v2_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  const float* __restrict__ kpm,
                  const float* __restrict__ tiles, bf16* __restrict__ dk,
                  bf16* __restrict__ dv, unsigned long long* tally,
                  const int32_t* __restrict__ coffs,
                  const int32_t* __restrict__ ccnts,
                  const int32_t* __restrict__ crows,
                  const int32_t* __restrict__ uids, Shape sh) {
  const int R = blockDim.x / 2;
  const int D = sh.D;
  const int bh = blockIdx.y;
  const int b = bh / sh.H;
  const int kr0 = blockIdx.x * R;
  const int col = (bh % sh.H) * (sh.S / sh.blk) + kr0 / sh.blk;
  const int base = coffs[col];
  const ColRunWalk walk{crows + base, uids + base, tiles, ccnts[col], sh.blk,
                        kr0 % sh.blk};
  const size_t q0 = (size_t)bh * sh.S;
  const size_t krow = q0 + kr0;
  const DkvRows rows{q + q0 * D, k + krow * D, v + krow * D, dout + q0 * D,
                     lse + q0, delta + q0,
                     KPM ? kpm + (size_t)b * sh.S : nullptr, dk + krow * D,
                     dv + krow * D, 0, kr0, D, bh, sh.sm_scale, tally};
  mma_dkv_body<CH, DMAX, KPM, false, RowRunRule, AM>(rows, walk, NoBand{},
                                                     Dropout{});
}

size_t fwd_smem(int R, int D, int blk) {
  return sizeof(float) *
         ((size_t)2 * R * (D + 1) + (size_t)R * blk + (size_t)R * D + 3 * R);
}

size_t bwd_smem(int R, int D) {
  return sizeof(float) * ((size_t)4 * R * (D + 1) + (size_t)2 * R * R +
                          (size_t)2 * R * D + 3 * R);
}

bool bad_shape(int bh, int H, int S, int D, int blk) {
  return bh <= 0 || bh > 65535 || H <= 0 || bh % H != 0 || D <= 0 ||
         D > kMaxHd || D % 8 != 0 ||
         (blk != 16 && blk != 32 && blk != 64 && blk != 128) || S <= 0 ||
         S % blk != 0;
}

template <bool HAS_AM>
cudaError_t run_fwd(dim3 grid, size_t smem, cudaStream_t s, const void* q,
                    const void* k, const void* v, const float* kpm,
                    const float* tiles, void* o, float* lse,
                    const int32_t* of, const int32_t* cn, const int32_t* co,
                    const int32_t* ui, Shape sh) {
  return launch(v2_fwd_kernel<float, HAS_AM>, grid, smem, s,
                static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v), kpm, tiles,
                static_cast<float*>(o), lse, of, cn, co, ui, sh);
}

template <int W, int DMAX, bool KPM, bool AM>
cudaError_t run_fwd_mma(dim3 grid, int threads, size_t smem, cudaStream_t s,
                        const void* q, const void* k, const void* v,
                        const float* kpm, const float* tiles, void* o,
                        float* lse, const int32_t* of, const int32_t* cn,
                        const int32_t* co, const int32_t* ui, Shape sh) {
  return launch_rows(v2_fwd_mma_kernel<W, DMAX, KPM, AM>, grid, threads,
                     smem, s, static_cast<const bf16*>(q),
                     static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                     kpm, tiles, static_cast<bf16*>(o), lse, of, cn, co, ui,
                     sh);
}

using FwdMma = decltype(&run_fwd_mma<16, 64, false, false>);

template <int W, int DMAX>
FwdMma pick_fwd_mma(bool kpm, bool am) {
  return kpm ? (am ? run_fwd_mma<W, DMAX, true, true>
                   : run_fwd_mma<W, DMAX, true, false>)
             : (am ? run_fwd_mma<W, DMAX, false, true>
                   : run_fwd_mma<W, DMAX, false, false>);
}

// the tensor-core instantiation of a walk block, head dim, key mask and
// mask tiles (the bad_shape checks passed: blk is 16, 32, 64 or 128, D
// <= 128)
FwdMma pick_fwd_mma_blk(int blk, int D, bool kpm, bool am) {
  if (D <= 64)
    return blk == 16   ? pick_fwd_mma<16, 64>(kpm, am)
           : blk == 32 ? pick_fwd_mma<32, 64>(kpm, am)
           : blk == 64 ? pick_fwd_mma<64, 64>(kpm, am)
                       : pick_fwd_mma<128, 64>(kpm, am);
  return blk == 16   ? pick_fwd_mma<16, 128>(kpm, am)
         : blk == 32 ? pick_fwd_mma<32, 128>(kpm, am)
         : blk == 64 ? pick_fwd_mma<64, 128>(kpm, am)
                     : pick_fwd_mma<128, 128>(kpm, am);
}

template <bool HAS_AM>
cudaError_t run_dq(dim3 grid, size_t smem, cudaStream_t s, const void* q,
                   const void* k, const void* v, const void* dout,
                   const float* ls, const float* dl, const float* kpm,
                   const float* tiles, void* dq, const int32_t* of,
                   const int32_t* cn, const int32_t* co, const int32_t* ui,
                   Shape sh) {
  return launch(v2_dq_kernel<HAS_AM>, grid, smem, s,
                static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v),
                static_cast<const float*>(dout), ls, dl, kpm, tiles,
                static_cast<float*>(dq), of, cn, co, ui, sh);
}

template <bool HAS_AM>
cudaError_t run_dkv(dim3 grid, size_t smem, cudaStream_t s, const void* q,
                    const void* k, const void* v, const void* dout,
                    const float* ls, const float* dl, const float* kpm,
                    const float* tiles, void* dk, void* dv, const int32_t* of,
                    const int32_t* cn, const int32_t* ro, const int32_t* ui,
                    Shape sh) {
  return launch(v2_dkv_kernel<HAS_AM>, grid, smem, s,
                static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v),
                static_cast<const float*>(dout), ls, dl, kpm, tiles,
                static_cast<float*>(dk), static_cast<float*>(dv), of, cn, ro,
                ui, sh);
}

// the tensor-core backward launchers of one instantiation (pick_bwd_mma)
template <int CH, int DMAX, bool KPM, bool AM>
struct DqMma {
  static cudaError_t run(dim3 grid, int threads, size_t smem, cudaStream_t s,
                         const void* q, const void* k, const void* v,
                         const void* dout, const float* ls, const float* dl,
                         const float* kpm, const float* tiles, void* dq,
                         unsigned long long* tally, const int32_t* of,
                         const int32_t* cn, const int32_t* co,
                         const int32_t* ui, Shape sh) {
    return launch_rows(v2_dq_mma_kernel<CH, DMAX, KPM, AM>, grid, threads,
                       smem, s, static_cast<const bf16*>(q),
                       static_cast<const bf16*>(k),
                       static_cast<const bf16*>(v),
                       static_cast<const bf16*>(dout), ls, dl, kpm, tiles,
                       static_cast<bf16*>(dq), tally, of, cn, co, ui, sh);
  }
};

template <int CH, int DMAX, bool KPM, bool AM>
struct DkvMma {
  static cudaError_t run(dim3 grid, int threads, size_t smem,
                         cudaStream_t s, const void* q, const void* k,
                         const void* v, const void* dout, const float* ls,
                         const float* dl, const float* kpm,
                         const float* tiles, void* dk, void* dv,
                         unsigned long long* tally, const int32_t* of,
                         const int32_t* cn, const int32_t* ro,
                         const int32_t* ui, Shape sh) {
    return launch_rows(v2_dkv_mma_kernel<CH, DMAX, KPM, AM>, grid, threads,
                       smem, s, static_cast<const bf16*>(q),
                       static_cast<const bf16*>(k),
                       static_cast<const bf16*>(v),
                       static_cast<const bf16*>(dout), ls, dl, kpm, tiles,
                       static_cast<bf16*>(dk), static_cast<bf16*>(dv), tally,
                       of, cn, ro, ui, sh);
  }
};

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. kpm: the (B, S) fp32 additive key
// mask, or null for none. tiles: the (U, block, block) fp32 mask tiles, or
// null for none (then uids are not read).
// offs, cnts, cols (rows for dkv), uids: int32 CSR (CSC) walk metadata.
// Each entry point returns the CUDA error of its launch (0 on success);
// it launches on `stream` and does not synchronise. Each runs bf16 on its
// tensor-core body (q, k, v, do and the outputs 16-byte aligned, kpm and
// tiles 8: else cudaErrorInvalidValue) and fp32 on its CUDA-core body.
// tally (blocksparse_v2_dq, blocksparse_v2_dkv): null, or a uint64 to
// which the tensor-core body adds the cells it sums again (a measurement;
// the fp32 bodies add nothing).
extern "C" int blocksparse_v2_fwd(
    const void* q, const void* k, const void* v, const void* kpm,
    const void* tiles, void* o, void* lse, const void* offs,
    const void* cnts, const void* cols, const void* uids, int dtype, int bh,
    int heads, int seq, int head_dim, int block, float sm_scale,
    void* stream) {
  if (bad_shape(bh, heads, seq, head_dim, block))
    return (int)cudaErrorInvalidValue;
  const Shape sh{heads, seq, head_dim, block, sm_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* km = static_cast<const float*>(kpm);
  const float* tl = static_cast<const float*>(tiles);
  const int32_t* of = static_cast<const int32_t*>(offs);
  const int32_t* cn = static_cast<const int32_t*>(cnts);
  const int32_t* co = static_cast<const int32_t*>(cols);
  const int32_t* ui = static_cast<const int32_t*>(uids);
  const bool am = tiles != nullptr;
  if (dtype == 1) {           // bf16: the tensor-core body, or an error
    if (fwd_misaligned(q, k, v, o, kpm, tiles))
      return (int)cudaErrorInvalidValue;
    const int R = mma_rows(block);
    return (int)pick_fwd_mma_blk(block, head_dim, kpm != nullptr, am)(
        dim3(seq / R, bh), 2 * R, mma_fwd_smem(R, block, head_dim), s, q, k,
        v, km, tl, o, static_cast<float*>(lse), of, cn, co, ui, sh);
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  const int R = rows_of(block);      // fp32: the CUDA-core body
  return (int)(am ? run_fwd<true> : run_fwd<false>)(
      dim3(seq / R, bh), fwd_smem(R, head_dim, block), s, q, k, v, km, tl, o,
      static_cast<float*>(lse), of, cn, co, ui, sh);
}

extern "C" int blocksparse_v2_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* kpm, const void* tiles,
    void* dq, void* tally, const void* offs, const void* cnts,
    const void* cols, const void* uids, int dtype, int bh, int heads,
    int seq, int head_dim, int block, float sm_scale, void* stream) {
  if (bad_shape(bh, heads, seq, head_dim, block))
    return (int)cudaErrorInvalidValue;
  const Shape sh{heads, seq, head_dim, block, sm_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ls = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const float* km = static_cast<const float*>(kpm);
  const float* tl = static_cast<const float*>(tiles);
  const int32_t* of = static_cast<const int32_t*>(offs);
  const int32_t* cn = static_cast<const int32_t*>(cnts);
  const int32_t* co = static_cast<const int32_t*>(cols);
  const int32_t* ui = static_cast<const int32_t*>(uids);
  const bool am = tiles != nullptr;
  if (dtype == 1) {           // bf16: the tensor-core body, or an error
    // one output: dq stands for both of dk/dv's
    if (dkv_misaligned(q, k, v, dout, dq, dq, kpm, tiles))
      return (int)cudaErrorInvalidValue;
    const int R = mma_rows(block);
    return (int)pick_bwd_mma<DqMma>(dq_chunk(block), head_dim,
                                    kpm != nullptr, am)(
        dim3(seq / R, bh), 2 * R, mma_dq_smem(R, block, head_dim), s, q, k,
        v, dout, ls, dl, km, tl, dq, static_cast<unsigned long long*>(tally),
        of, cn, co, ui, sh);
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  const int R = rows_of(block);      // fp32: the CUDA-core body
  return (int)(am ? run_dq<true> : run_dq<false>)(
      dim3(seq / R, bh), bwd_smem(R, head_dim), s, q, k, v, dout, ls, dl, km,
      tl, dq, of, cn, co, ui, sh);
}

extern "C" int blocksparse_v2_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* kpm, const void* tiles,
    void* dk, void* dv, void* tally, const void* coffs, const void* ccnts,
    const void* crows, const void* uids, int dtype, int bh, int heads,
    int seq, int head_dim, int block, float sm_scale, void* stream) {
  if (bad_shape(bh, heads, seq, head_dim, block))
    return (int)cudaErrorInvalidValue;
  const Shape sh{heads, seq, head_dim, block, sm_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ls = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const float* km = static_cast<const float*>(kpm);
  const float* tl = static_cast<const float*>(tiles);
  const int32_t* of = static_cast<const int32_t*>(coffs);
  const int32_t* cn = static_cast<const int32_t*>(ccnts);
  const int32_t* ro = static_cast<const int32_t*>(crows);
  const int32_t* ui = static_cast<const int32_t*>(uids);
  const bool am = tiles != nullptr;
  if (dtype == 1) {           // bf16: the tensor-core body, or an error
    if (dkv_misaligned(q, k, v, dout, dk, dv, kpm, tiles))
      return (int)cudaErrorInvalidValue;
    const int R = mma_rows(block);
    return (int)pick_bwd_mma<DkvMma>(dkv_chunk(block), head_dim,
                                     kpm != nullptr, am)(
        dim3(seq / R, bh), 2 * R, mma_dkv_smem(R, block, head_dim), s, q, k,
        v, dout, ls, dl, km, tl, dk, dv,
        static_cast<unsigned long long*>(tally), of, cn, ro, ui, sh);
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  const int R = rows_of(block);      // fp32: the CUDA-core body
  return (int)(am ? run_dkv<true> : run_dkv<false>)(
      dim3(seq / R, bh), bwd_smem(R, head_dim), s, q, k, v, dout, ls, dl, km,
      tl, dk, dv, of, cn, ro, ui, sh);
}
