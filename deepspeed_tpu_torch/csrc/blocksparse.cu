// The v1 block-sparse attention kernels, forward and backward, for Hopper.
//
// Replaces the three per-triple Pallas TPU kernels of
// deepspeed_tpu/ops/sparse_attention/blocksparse.py, which JAX reaches
// under USE_SPLASH_V2 = False (its test oracle for the row-run kernels),
// in every arity (template flags HAS_AM and HAS_KPM; a null pointer picks
// the flag off):
//   K14 _bs_fwd_kernel -> bs_fwd : o, lse  (row-major triples)
//   K15 _bs_dq_kernel  -> bs_dq  : dq      (row-major triples)
//   K16 _bs_dkv_kernel -> bs_dkv : dk, dv  (column-major triples)
// Same function as the Pallas kernels:
//   q, k, v (B*H, S, D) in fp32 or bf16; a layout of H heads at block
//   `blk`, walked through the triples of build_triples: item i (a block
//   row h * nq + r, or for K16 a block column h * nk + c) owns the
//   triples [offs[i], offs[i + 1]), each naming its partner block and
//   whether it is real (an empty row or column holds one dummy); the
//   additive fp32 attention mask am (S, S), read in place per coordinate
//   (null: none); the additive fp32 key mask kpm (B, S) (null: none; JAX
//   adds zeros, which change no value).
// Semantics kept exactly: s = (q.k) * sm_scale, then s += kpm[b, key],
// then s += am[query, key], in fp32; a dummy triple is a tile of NEG_INF
// (skipped here: with nothing walked before it in its row, that changes
// no state); a cell with s <= VALID_THRESH (-1e28, blocksparse.py:42,
// not the -1e29 of the row-run kernels) has p = 0. The forward's online
// softmax runs per walked tile with no m_safe guard (p = exp(s - m_new),
// alpha = exp(m_old - m_new)); a row with l == 0 writes o = 0 and
// lse = m (NEG_INF for an empty block row). K15 and K16 recompute
// p = exp(s - lse). p is rounded to V's (K16: do's) dtype before its
// product, ds = p * (dp - delta) to K's (K16: q's) dtype before its
// product; every sum accumulates in fp32. dq and dk are scaled by
// sm_scale once at the end, dv is not. A block column that no query
// block walks writes dk = dv = 0.
//
// What bounds it on an H100: operations. At the main path's shape (B 8,
// H 16, S 2048, D 64, the fixed per-head layouts of ds_config_sparse.json
// at block 16) a walked 16 x 16 tile does 2-4 products of 16 x 16 x 64
// over 2 x 16 x 64 staged values and 256 mask values. In bf16 the three
// run on the tensor cores (mma.sync m16n8k16, the scores and accumulators
// in registers, the partner rows staged as bf16 by cp.async into a ring
// of chunks), each over its block row's or column's real triples (an
// empty row's or column's dummy is not walked: o = 0, lse = NEG_INF, dq =
// 0, dk = dv = 0), each score plus its cell of the (S, S) mask read in
// place from global memory (the mask sits in L2), with v1's -1e28
// threshold: K14 on K1's forward body (mma_fwd.cuh, TripleRule: lse = m
// where l == 0, the mask per 8-key fragment), K15 on K2's dq body
// (mma_dq.cuh, float2 mask pairs per 8-key fragment), K16 on K3's dk/dv
// body (mma_dkv.cuh, which holds S^T: one scalar mask load per cell, S
// apart). A CTA owns R = min(blk, 64) rows of a block row (K14, K15) or
// keys of a block column (K16), 16 per warp. In fp32 the three keep the
// simple design of the row-run kernels (blocksparse_v2.cu, over
// flash_tiles.cuh): fp32 FMAs on the CUDA cores (TF32 would fail the fp32
// checks). A CTA of 128 threads owns R = min(blk, 32) rows of a block row
// (K14, K15) or column (K16) and walks its triples in a loop, which takes
// the place of JAX's sequential grid axis and its scratch reset on tfirst
// and flush on tlast; it stages its own rows once and each triple's
// partner rows in chunks of R into shared memory as fp32, reads each mask
// cell straight from global memory once per CTA, and keeps the softmax
// state and the accumulators in shared memory. Every CTA stores its rows,
// so empty rows and columns write their zeros. Later work: wgmma, TMA
// staging.
//
// Built by deepspeed_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// into a library with a plain C interface, loaded through ctypes.

#include <stdint.h>

#include "flash_tiles.cuh"
#include "mma_dq.cuh"

namespace {

// blocksparse.VALID_THRESH (TripleRule's in the tensor-core body)
constexpr float kTripleThresh = -1e28f;

struct Shape {
  int H, S, D, blk;  // heads, sequence length, head dim, block
  float sm_scale;
};

// the triples of one item: [begin, end) of partner / valid
struct Walk {
  const int32_t* offs;
  const int32_t* partner;
  const int32_t* valid;
};

// ------------------------------------------------------------------ K14
// fp32 (the CUDA-core body): grid (S / R, B*H); R = min(blk, 32) q rows
// per CTA.
template <bool HAS_AM, bool HAS_KPM>
__global__ void __launch_bounds__(kThreads)
bs_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ kpm,
              const float* __restrict__ am, float* __restrict__ o,
              float* __restrict__ lse, Walk w, Shape sh) {
  extern __shared__ float smem[];
  const int D = sh.D, blk = sh.blk;
  const int R = rows_of(blk);
  const int bh = blockIdx.y;
  const int b = bh / sh.H;
  const int r0 = blockIdx.x * R;
  const int item = (bh % sh.H) * (sh.S / blk) + r0 / blk;
  const int begin = w.offs[item], end = w.offs[item + 1];
  const float* kg = k + (size_t)bh * sh.S * D;
  const float* vg = v + (size_t)bh * sh.S * D;
  const float* kpm_b = HAS_KPM ? kpm + (size_t)b * sh.S : nullptr;

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
  for (int t = begin; t < end; ++t) {
    if (!w.valid[t]) continue;
    const int k0 = w.partner[t] * blk;
    const float* amt = HAS_AM ? am + (size_t)r0 * sh.S + k0 : nullptr;
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
          if (HAS_KPM) s += kpm_b[k0 + c];
          if (HAS_AM) s += amt[(size_t)r * sh.S + c];
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
          const float p = sv[u] > kTripleThresh ? expf(sv[u] - m_new) : 0.f;
          sum += p;
          ss[r * blk + c] = p;
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

  float* og = o + ((size_t)bh * sh.S + r0) * D;
  for (int e = threadIdx.x; e < R * D; e += blockDim.x) {
    const float l = l_s[e / D];
    og[e] = os[e] / (l == 0.f ? 1.f : l);
  }
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    const float l = l_s[r];
    lse[(size_t)bh * sh.S + r0 + r] = m_s[r] + logf(l == 0.f ? 1.f : l);
  }
}

// K14 and K15 in bf16 (the tensor-core bodies, mma_fwd.cuh and
// mma_dq.cuh): grid (S / R, B*H), R = min(blk, 64) q rows of one block row
// per CTA, 16 per warp, over the block row's real triples.
struct TripleWalk {
  const int32_t* partner;  // the block row's partner blocks
  const float* am;         // (S, S) at the CTA's first row, or null
  int count, blk, S;       // real triples, block, mask row stride
  __device__ __forceinline__ int n() const { return count; }
  __device__ __forceinline__ int keys() const { return blk; }
  __device__ __forceinline__ int2 tile(int t) const {
    return make_int2(partner[t] * blk, 0);
  }
  __device__ __forceinline__ const float* mask(int t) const {
    return am + partner[t] * blk;
  }
  __device__ __forceinline__ int mask_ld() const { return S; }
};

// the real triples of item `item` (an empty block row or column holds one
// dummy triple, a walked one none): their first index and count
__device__ __forceinline__ int2 real_triples(const Walk& w, int item) {
  const int begin = w.offs[item];
  return make_int2(begin, w.valid[begin] ? w.offs[item + 1] - begin : 0);
}

template <int W, int DMAX, bool KPM, bool AM>
__global__ void __launch_bounds__(2 * kMmaMaxRows,
                                  mma_fwd_min_ctas(W, DMAX, AM))
bs_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const float* __restrict__ kpm,
                  const float* __restrict__ am, bf16* __restrict__ o,
                  float* __restrict__ lse, Walk w, Shape sh) {
  const int R = blockDim.x / 2;
  const int D = sh.D;
  const int bh = blockIdx.y;
  const int b = bh / sh.H;
  const int r0 = blockIdx.x * R;
  const int2 tr = real_triples(w, (bh % sh.H) * (sh.S / W) + r0 / W);
  const TripleWalk walk{w.partner + tr.x,
                        AM ? am + (size_t)r0 * sh.S : nullptr, tr.y, W, sh.S};
  const size_t row0 = (size_t)bh * sh.S + r0;
  const size_t kv0 = (size_t)bh * sh.S * D;
  const FwdRows rows{q + row0 * D, k + kv0, v + kv0,
                     KPM ? kpm + (size_t)b * sh.S : nullptr, o + row0 * D,
                     lse + row0, r0, D, bh, sh.sm_scale};
  mma_fwd_body<W, DMAX, KPM, false, AM, TripleRule>(rows, walk, NoBand{},
                                                    Dropout{});
}

// ------------------------------------------------------------------ K15
// fp32 (the CUDA-core body): grid (S / R, B*H); per walked triple, chunk
// by chunk of R key rows.
template <bool HAS_AM, bool HAS_KPM>
__global__ void __launch_bounds__(kThreads)
bs_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             const float* __restrict__ kpm, const float* __restrict__ am,
             float* __restrict__ dq, Walk w, Shape sh) {
  extern __shared__ float smem[];
  const int D = sh.D, blk = sh.blk;
  const int R = rows_of(blk);
  const int bh = blockIdx.y;
  const int b = bh / sh.H;
  const int r0 = blockIdx.x * R;
  const int item = (bh % sh.H) * (sh.S / blk) + r0 / blk;
  const int begin = w.offs[item], end = w.offs[item + 1];
  const float* kg = k + (size_t)bh * sh.S * D;
  const float* vg = v + (size_t)bh * sh.S * D;
  const float* kpm_b = HAS_KPM ? kpm + (size_t)b * sh.S : nullptr;
  const size_t row0 = (size_t)bh * sh.S + r0;

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

  for (int t = begin; t < end; ++t) {
    if (!w.valid[t]) continue;
    const int k0 = w.partner[t] * blk;
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
        if (HAS_KPM) s += kpm_b[k0 + c0 + c];
        if (HAS_AM) s += am[(size_t)(r0 + r) * sh.S + k0 + c0 + c];
        const float p = s > kTripleThresh ? expf(s - lse_s[r]) : 0.f;
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

// K15 in bf16 (the tensor-core body, mma_dq.cuh): grid (S / R, B*H), R =
// min(blk, 64) q rows of one block row per CTA, over its TripleWalk; CH =
// dq_chunk(blk) keys per chunk. `tally`: see DqRows.
template <int CH, int DMAX, bool KPM, bool AM>
__global__ void __launch_bounds__(2 * kMmaMaxRows, DMAX <= 64 ? 3 : 2)
bs_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 const float* __restrict__ kpm, const float* __restrict__ am,
                 bf16* __restrict__ dq, unsigned long long* tally, Walk w,
                 Shape sh) {
  const int R = blockDim.x / 2;
  const int D = sh.D;
  const int bh = blockIdx.y;
  const int b = bh / sh.H;
  const int r0 = blockIdx.x * R;
  const int2 tr = real_triples(w, (bh % sh.H) * (sh.S / sh.blk) + r0 / sh.blk);
  const TripleWalk walk{w.partner + tr.x,
                        AM ? am + (size_t)r0 * sh.S : nullptr, tr.y, sh.blk,
                        sh.S};
  const size_t row0 = (size_t)bh * sh.S + r0;
  const size_t kv0 = (size_t)bh * sh.S * D;
  const DqRows rows{q + row0 * D, dout + row0 * D, lse + row0, delta + row0,
                    k + kv0, v + kv0, KPM ? kpm + (size_t)b * sh.S : nullptr,
                    dq + row0 * D, r0, D, bh, sh.sm_scale, tally};
  mma_dq_body<CH, DMAX, KPM, false, TripleRule, AM>(rows, walk, NoBand{},
                                                    Dropout{});
}

// ------------------------------------------------------------------ K16
// fp32 (the CUDA-core body): grid (S / R, B*H): one CTA per head and R
// key rows, over the column triples of the key block, chunk by chunk of R
// query rows. The CTA's R key rows' key-mask values are loaded once,
// beside the staged K and V.
template <bool HAS_AM, bool HAS_KPM>
__global__ void __launch_bounds__(kThreads)
bs_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              const float* __restrict__ kpm, const float* __restrict__ am,
              float* __restrict__ dk, float* __restrict__ dv, Walk w,
              Shape sh) {
  extern __shared__ float smem[];
  const int D = sh.D, blk = sh.blk;
  const int R = rows_of(blk);
  const int bh = blockIdx.y;
  const int b = bh / sh.H;
  const int kr0 = blockIdx.x * R;
  const int item = (bh % sh.H) * (sh.S / blk) + kr0 / blk;
  const int begin = w.offs[item], end = w.offs[item + 1];
  const float* qg = q + (size_t)bh * sh.S * D;
  const float* dog = dout + (size_t)bh * sh.S * D;

  float* ks = smem;                 // R x (D+1)
  float* vs = ks + R * (D + 1);     // R x (D+1)
  float* qs = vs + R * (D + 1);     // R x (D+1)
  float* dos = qs + R * (D + 1);    // R x (D+1)
  float* ps = dos + R * (D + 1);    // R(q) x R(k): s, then p rounded
  float* dps = ps + R * R;          // R(q) x R(k): dp, then ds
  float* dks = dps + R * R;         // R x D
  float* dvs = dks + R * D;         // R x D
  float* lse_s = dvs + R * D;       // R
  float* dl_s = lse_s + R;          // R
  float* km_s = dl_s + R;           // R: this CTA's key mask

  stage_rows(ks, k + ((size_t)bh * sh.S + kr0) * D, R, D);
  stage_rows(vs, v + ((size_t)bh * sh.S + kr0) * D, R, D);
  fill(dks, R * D, 0.f);
  fill(dvs, R * D, 0.f);
  for (int c = threadIdx.x; c < R; c += blockDim.x)
    km_s[c] = HAS_KPM ? kpm[(size_t)b * sh.S + kr0 + c] : 0.f;
  __syncthreads();

  for (int t = begin; t < end; ++t) {
    if (!w.valid[t]) continue;
    const int q0 = w.partner[t] * blk;
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
        if (HAS_KPM) s += km_s[c];
        if (HAS_AM) s += am[(size_t)(q0 + c0 + r) * sh.S + kr0 + c];
        const float p = s > kTripleThresh ? expf(s - lse_s[r]) : 0.f;
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

// K16 in bf16 (the tensor-core body, mma_dkv.cuh): grid (S / R, B*H), R =
// min(blk, 64) key rows of one block column per CTA, 16 per warp, over
// the column's real triples; CH = dkv_chunk(blk) query rows per chunk.
struct ColWalk {
  const int32_t* partner;  // the block column's partner (query) blocks
  const float* am;         // (S, S) at the CTA's first key, or null
  int count, blk, S;       // real triples, block, mask row stride
  __device__ __forceinline__ int n() const { return count; }
  __device__ __forceinline__ int rows() const { return blk; }
  __device__ __forceinline__ int2 tile(int t) const {
    return make_int2(partner[t] * blk, 0);
  }
  __device__ __forceinline__ const float* mask(int t) const {
    return am + (size_t)partner[t] * blk * S;
  }
  __device__ __forceinline__ int mask_ld() const { return S; }
};

template <int CH, int DMAX, bool KPM, bool AM>
__global__ void __launch_bounds__(2 * kMmaMaxRows, DMAX <= 64 ? 3 : 2)
bs_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  const float* __restrict__ kpm, const float* __restrict__ am,
                  bf16* __restrict__ dk, bf16* __restrict__ dv,
                  unsigned long long* tally, Walk w, Shape sh) {
  const int R = blockDim.x / 2;
  const int D = sh.D;
  const int bh = blockIdx.y;
  const int b = bh / sh.H;
  const int kr0 = blockIdx.x * R;
  const int2 tr =
      real_triples(w, (bh % sh.H) * (sh.S / sh.blk) + kr0 / sh.blk);
  const ColWalk walk{w.partner + tr.x, AM ? am + kr0 : nullptr, tr.y, sh.blk,
                     sh.S};
  const size_t q0 = (size_t)bh * sh.S;
  const size_t krow = q0 + kr0;
  const DkvRows rows{q + q0 * D, k + krow * D, v + krow * D, dout + q0 * D,
                     lse + q0, delta + q0,
                     KPM ? kpm + (size_t)b * sh.S : nullptr, dk + krow * D,
                     dv + krow * D, 0, kr0, D, bh, sh.sm_scale, tally};
  mma_dkv_body<CH, DMAX, KPM, false, TripleRule, AM>(rows, walk, NoBand{},
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

// the instantiation of `Kern<HAS_AM, HAS_KPM>` (an fp32 CUDA-core body)
// for the masks given
template <template <bool, bool> class Kern>
auto pick_fp32(bool am, bool kpm) -> decltype(&Kern<false, false>::run) {
  return am ? (kpm ? &Kern<true, true>::run : &Kern<true, false>::run)
            : (kpm ? &Kern<false, true>::run : &Kern<false, false>::run);
}

template <int W, int DMAX, bool KPM, bool AM>
cudaError_t run_fwd_mma(dim3 grid, int threads, size_t smem, cudaStream_t s,
                        const void* q, const void* k, const void* v,
                        const float* kpm, const float* am, void* o,
                        float* lse, Walk w, Shape sh) {
  return launch_rows(bs_fwd_mma_kernel<W, DMAX, KPM, AM>, grid, threads,
                     smem, s, static_cast<const bf16*>(q),
                     static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                     kpm, am, static_cast<bf16*>(o), lse, w, sh);
}

using FwdMma = decltype(&run_fwd_mma<16, 64, false, false>);

template <int W, int DMAX>
FwdMma pick_fwd_mma(bool kpm, bool am) {
  return kpm ? (am ? run_fwd_mma<W, DMAX, true, true>
                   : run_fwd_mma<W, DMAX, true, false>)
             : (am ? run_fwd_mma<W, DMAX, false, true>
                   : run_fwd_mma<W, DMAX, false, false>);
}

// the tensor-core instantiation of a block, head dim and the masks given
// (the bad_shape checks passed: blk is 16, 32, 64 or 128, D <= 128)
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

// the tensor-core backward launchers of one instantiation (pick_bwd_mma)
template <int CH, int DMAX, bool KPM, bool AM>
struct DqMma {
  static cudaError_t run(dim3 grid, int threads, size_t smem, cudaStream_t s,
                         const void* q, const void* k, const void* v,
                         const void* dout, const float* ls, const float* dl,
                         const float* kpm, const float* am, void* dq,
                         unsigned long long* tally, Walk w, Shape sh) {
    return launch_rows(bs_dq_mma_kernel<CH, DMAX, KPM, AM>, grid, threads,
                       smem, s, static_cast<const bf16*>(q),
                       static_cast<const bf16*>(k),
                       static_cast<const bf16*>(v),
                       static_cast<const bf16*>(dout), ls, dl, kpm, am,
                       static_cast<bf16*>(dq), tally, w, sh);
  }
};

template <int CH, int DMAX, bool KPM, bool AM>
struct DkvMma {
  static cudaError_t run(dim3 grid, int threads, size_t smem,
                         cudaStream_t s, const void* q, const void* k,
                         const void* v, const void* dout, const float* ls,
                         const float* dl, const float* kpm, const float* am,
                         void* dk, void* dv, unsigned long long* tally,
                         Walk w, Shape sh) {
    return launch_rows(bs_dkv_mma_kernel<CH, DMAX, KPM, AM>, grid, threads,
                       smem, s, static_cast<const bf16*>(q),
                       static_cast<const bf16*>(k),
                       static_cast<const bf16*>(v),
                       static_cast<const bf16*>(dout), ls, dl, kpm, am,
                       static_cast<bf16*>(dk), static_cast<bf16*>(dv), tally,
                       w, sh);
  }
};

template <bool AM, bool KPM>
struct Fwd {
  static cudaError_t run(dim3 grid, size_t smem, cudaStream_t s,
                         const void* q, const void* k, const void* v,
                         const float* kpm, const float* am, void* o,
                         float* lse, Walk w, Shape sh) {
    return launch(bs_fwd_kernel<AM, KPM>, grid, smem, s,
                  static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v), kpm, am,
                  static_cast<float*>(o), lse, w, sh);
  }
};

template <bool AM, bool KPM>
struct Dq {
  static cudaError_t run(dim3 grid, size_t smem, cudaStream_t s,
                         const void* q, const void* k, const void* v,
                         const void* dout, const float* ls, const float* dl,
                         const float* kpm, const float* am, void* dq, Walk w,
                         Shape sh) {
    return launch(bs_dq_kernel<AM, KPM>, grid, smem, s,
                  static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v),
                  static_cast<const float*>(dout), ls, dl, kpm, am,
                  static_cast<float*>(dq), w, sh);
  }
};

template <bool AM, bool KPM>
struct Dkv {
  static cudaError_t run(dim3 grid, size_t smem, cudaStream_t s,
                         const void* q, const void* k, const void* v,
                         const void* dout, const float* ls, const float* dl,
                         const float* kpm, const float* am, void* dk,
                         void* dv, Walk w, Shape sh) {
    return launch(bs_dkv_kernel<AM, KPM>, grid, smem, s,
                  static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v),
                  static_cast<const float*>(dout), ls, dl, kpm, am,
                  static_cast<float*>(dk), static_cast<float*>(dv), w, sh);
  }
};

Walk walk_of(const void* offs, const void* partner, const void* valid) {
  return Walk{static_cast<const int32_t*>(offs),
              static_cast<const int32_t*>(partner),
              static_cast<const int32_t*>(valid)};
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. kpm: the (B, S) fp32 additive key
// mask, or null for none. am: the (S, S) fp32 additive attention mask, or
// null for none. offs (items + 1), partner, valid: int32 triples of the
// row walk (bs_fwd, bs_dq) or the column walk (bs_dkv). Each entry point
// returns the CUDA error of its launch (0 on success); it launches on
// `stream` and does not synchronise. Each runs bf16 on its tensor-core
// body (q, k, v, do and the outputs 16-byte aligned, kpm and am 8: else
// cudaErrorInvalidValue) and fp32 on its CUDA-core body. tally (bs_dq,
// bs_dkv): null, or a uint64 to which the tensor-core body adds the
// cells it sums again (a measurement; the fp32 bodies add nothing).
extern "C" int bs_fwd(const void* q, const void* k, const void* v,
                      const void* kpm, const void* am, void* o, void* lse,
                      const void* offs, const void* partner,
                      const void* valid, int dtype, int bh, int heads,
                      int seq, int head_dim, int block, float sm_scale,
                      void* stream) {
  if (bad_shape(bh, heads, seq, head_dim, block))
    return (int)cudaErrorInvalidValue;
  const Shape sh{heads, seq, head_dim, block, sm_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* km = static_cast<const float*>(kpm);
  const float* mk = static_cast<const float*>(am);
  const Walk w = walk_of(offs, partner, valid);
  if (dtype == 1) {           // bf16: the tensor-core body, or an error
    if (fwd_misaligned(q, k, v, o, kpm, am))
      return (int)cudaErrorInvalidValue;
    const int R = mma_rows(block);
    return (int)pick_fwd_mma_blk(block, head_dim, kpm != nullptr,
                                 am != nullptr)(
        dim3(seq / R, bh), 2 * R, mma_fwd_smem(R, block, head_dim), s, q, k,
        v, km, mk, o, static_cast<float*>(lse), w, sh);
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  const int R = rows_of(block);      // fp32: the CUDA-core body
  return (int)pick_fp32<Fwd>(am != nullptr, kpm != nullptr)(
      dim3(seq / R, bh), fwd_smem(R, head_dim, block), s, q, k, v, km, mk, o,
      static_cast<float*>(lse), w, sh);
}

extern "C" int bs_dq(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     const void* kpm, const void* am, void* dq, void* tally,
                     const void* offs, const void* partner,
                     const void* valid, int dtype, int bh, int heads,
                     int seq, int head_dim, int block, float sm_scale,
                     void* stream) {
  if (bad_shape(bh, heads, seq, head_dim, block))
    return (int)cudaErrorInvalidValue;
  const Shape sh{heads, seq, head_dim, block, sm_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ls = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const float* km = static_cast<const float*>(kpm);
  const float* mk = static_cast<const float*>(am);
  const Walk w = walk_of(offs, partner, valid);
  if (dtype == 1) {           // bf16: the tensor-core body, or an error
    // one output: dq stands for both of dk/dv's
    if (dkv_misaligned(q, k, v, dout, dq, dq, kpm, am))
      return (int)cudaErrorInvalidValue;
    const int R = mma_rows(block);
    return (int)pick_bwd_mma<DqMma>(dq_chunk(block), head_dim,
                                    kpm != nullptr, am != nullptr)(
        dim3(seq / R, bh), 2 * R, mma_dq_smem(R, block, head_dim), s, q, k,
        v, dout, ls, dl, km, mk, dq,
        static_cast<unsigned long long*>(tally), w, sh);
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  const int R = rows_of(block);      // fp32: the CUDA-core body
  return (int)pick_fp32<Dq>(am != nullptr, kpm != nullptr)(
      dim3(seq / R, bh), bwd_smem(R, head_dim), s, q, k, v, dout, ls, dl, km,
      mk, dq, w, sh);
}

extern "C" int bs_dkv(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      const void* kpm, const void* am, void* dk, void* dv,
                      void* tally, const void* offs, const void* partner,
                      const void* valid, int dtype, int bh, int heads,
                      int seq, int head_dim, int block, float sm_scale,
                      void* stream) {
  if (bad_shape(bh, heads, seq, head_dim, block))
    return (int)cudaErrorInvalidValue;
  const Shape sh{heads, seq, head_dim, block, sm_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ls = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const float* km = static_cast<const float*>(kpm);
  const float* mk = static_cast<const float*>(am);
  const Walk w = walk_of(offs, partner, valid);
  if (dtype == 1) {           // bf16: the tensor-core body, or an error
    if (dkv_misaligned(q, k, v, dout, dk, dv, kpm, am))
      return (int)cudaErrorInvalidValue;
    const int R = mma_rows(block);
    return (int)pick_bwd_mma<DkvMma>(dkv_chunk(block), head_dim,
                                     kpm != nullptr, am != nullptr)(
        dim3(seq / R, bh), 2 * R, mma_dkv_smem(R, block, head_dim), s, q, k,
        v, dout, ls, dl, km, mk, dk, dv,
        static_cast<unsigned long long*>(tally), w, sh);
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  const int R = rows_of(block);      // fp32: the CUDA-core body
  return (int)pick_fp32<Dkv>(am != nullptr, kpm != nullptr)(
      dim3(seq / R, bh), bwd_smem(R, head_dim), s, q, k, v, dout, ls, dl, km,
      mk, dk, dv, w, sh);
}
