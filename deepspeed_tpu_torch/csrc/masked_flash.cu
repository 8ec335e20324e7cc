// Masked flash attention for training, forward and backward, for Hopper.
//
// Replaces the three Pallas TPU kernels of
// deepspeed_tpu/ops/attention/masked_flash.py:
//   K1 _mf_fwd_kernel  -> masked_flash_fwd : o, lse     (CSR row walk)
//   K2 _mf_dq_kernel   -> masked_flash_dq  : dq         (CSR row walk)
//   K3 _mf_dkv_kernel  -> masked_flash_dkv : dk, dv     (CSC column walk)
// Same function as the Pallas kernels, for block kinds FULL, CAUSAL and
// BAND:
//   q (B*H, Sq, D); k, v (B*Hkv, Sk, D) in fp32 or bf16, GQA row
//   b*Hkv + h / (H/Hkv); a block mask of block `blk` walked through its
//   CSR (offs, cnts, cols, kinds) or CSC metadata, Hm = 1 or H mask heads;
//   optionally an additive fp32 key mask kpm (B, Sk) (the has_kpm arity,
//   the template flag KPM: a null kpm pointer runs the KPM = false
//   instantiation, whose code is the mask-free kernel's); optionally the
//   banded fine structure of KIND_BAND tiles (the template flag BAND: a
//   band with fine_block 0 runs the BAND = false instantiation).
// Semantics kept exactly: s = (q.k) * sm_scale, then s += kpm[b, key] in
// fp32 (b = bh / H: every head and every GQA group of a batch row reads
// one mask row), then the causal clip of CAUSAL tiles and the band
// predicate of BAND tiles (Band::keep, masked_flash.py::_partial_keep)
// set s = NEG_INF; a
// cell with s <= VALID_THRESH has p = 0 (BERT's -1e9 pads stay above it:
// p = exp(s - m) = 0 unless every key of the row is a pad, and then the
// row attends uniformly, as in the Pallas kernels);
// the online softmax runs per walked tile in fp32 (m_safe = 0 while the
// running max is still masked); a row with no valid entry writes o = 0 and
// lse = NEG_INF. Under the band a walked coarse tile may hold a row (K1,
// K2) or a column (K3) with no kept cell: its scores are all NEG_INF, so
// m_safe keeps the row's max at 0 and s > VALID_THRESH gives p = 0, and
// such a row adds exactly 0 to l, o, dq, dk and dv. A chunk of R rows by
// R keys of a BAND tile in which Band::any finds no kept cell is skipped
// (K1 skips the whole tile when every chunk of its rows is; K1 in bf16
// skips a tile the CTA's rows keep no cell of, and per warp each group
// of 16 rows by 16 keys with no kept cell), so a coarse walk computes
// the band's cells at the granularity of R, not of the walk block; every
// output equals that of the walk without the skip bit for bit. p is
// rounded to V's dtype before P.V and ds to K/Q's dtype before its products; every sum
// accumulates in fp32. Dropout regenerates
// the keep mask of flash.dropout_keep_mask from (seed, bh0 + b*H + h, q,
// k) in all three kernels (bh0: a data-parallel rank's first global batch
// row times H, so a rank draws its rows' masks of the global batch); the forward scales o by 1/(1-rate) after the
// normalization, dq scales dp, and dk/dv use the dropped, scaled pd for dv
// and the undropped p in ds. dq and dk are scaled by sm_scale once at the
// end, dv is not. At G > 1 dk/dv are written as fp32 per-q-head partials
// that the caller sums per group.
//
// What bounds it on an H100: operations. At the GPT-2 345M training
// shapes (S 1024, D 64, block 128, causal) a walked tile does 2-4 small
// products of 128 x 128 x 64 for 2 x 128 x 64 input values, well above the
// ~295 flop/byte line. K1 in bf16 runs on the tensor cores (mma_fwd.cuh:
// mma.sync m16n8k16 with bf16 operands and fp32 accumulators, Q, the
// scores and O in registers, K and V staged as bf16 by cp.async into a
// three-chunk ring, a CTA of min(blk, 64) rows of one block row sharing
// each staged tile). K2 and K3 in bf16 run on the tensor cores too: K2 on
// mma_dq.cuh (a CTA of min(blk, 64) query rows of one block row, 16 per
// warp, dQ in registers, K and V streamed as bf16 through a cp.async ring
// in chunks of up to 32 keys), K3 on mma_dkv.cuh (a CTA of min(blk, 64)
// key rows of one key block, 16 per warp, dK and dV in registers, Q and
// dO streamed in chunks of up to 32 query rows). The fp32 arity of K1-K3
// is the first, simple design on the CUDA cores: a CTA of 128 threads
// owns 32 rows of a tile (q rows for K1/K2, k rows for K3); it stages its
// own operand rows once and each walked tile's partner rows in chunks of
// 32 into shared memory as fp32 (rows padded to D+1 words, so the
// transposed reads are free of bank conflicts), and does every product
// with a 2x4 register micro-tile of fp32 FMAs. The per-row softmax state
// and the accumulators stay in shared memory beside the operands. K1
// keeps the whole tile's scores so the running max moves once per walked
// tile, as in the Pallas kernel; K2 and K3 need no running max (p =
// exp(s - lse)), so they go chunk by chunk. The fp32 checks' tolerance
// (1e-5) is tighter than TF32 holds, so fp32 stays on the CUDA cores.
//
// Built by deepspeed_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// into a library with a plain C interface, loaded through ctypes.

#include <stdint.h>

#include "flash_tiles.cuh"
#include "mma_dq.cuh"

namespace {

// The banded fine structure of KIND_BAND tiles, in fine blocks of fb
// rows: keep a cell of query qi, key ki iff its fine row is a global row,
// its fine column a global column, or they are at most w apart, then
// (clip) the layout's causal clip. Every body passes the walked tile's
// kind first; every KIND_BAND tile keeps this one predicate.
struct Band {
  int fb, w, g_r, g_c, clip;

  __device__ __forceinline__ bool keep(int, int qi, int ki) const {
    const int qf = qi / fb;
    const int kf = ki / fb;
    const int d = qf - kf;
    bool ok = qf < g_r || kf < g_c || (d <= w && -d <= w);
    if (clip) ok = ok && kf <= qf;
    return ok;
  }

  // whether keep() holds for any cell of queries [qa, qb] x keys [ka, kb]
  // (inclusive): a chunk of a BAND tile for which it does not adds
  // exactly 0 to every output, so the kernels skip it
  __device__ __forceinline__ bool any(int, int qa, int qb, int ka,
                                      int kb) const {
    const int q0 = qa / fb, q1 = qb / fb, k0 = ka / fb, k1 = kb / fb;
    // the window: qf - kf in [-w, w] ([0, w] under the clip)
    bool ok = q0 - k1 <= w && k0 - q1 <= (clip ? 0 : w);
    ok = ok || (q0 < g_r && (!clip || k0 <= min(q1, g_r - 1)));
    ok = ok || (k0 < g_c && (!clip || k0 <= q1));
    return ok;
  }
};

struct Shape {
  int H, Hkv, Hm;      // q heads, kv heads, mask heads (1 or H)
  int Sq, Sk, D, blk;  // sequence lengths, head dim, walk block
  float sm_scale;
};

// ------------------------------------------------------------------- K1
// fp32 (the CUDA-core body): grid (Sq / R, B*H); R = min(blk, 32) q rows
// per CTA.
template <typename T, bool KPM, bool BAND>
__global__ void __launch_bounds__(kThreads)
mf_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const float* __restrict__ kpm,
              T* __restrict__ o,
              float* __restrict__ lse, const int32_t* __restrict__ offs,
              const int32_t* __restrict__ cnts,
              const int32_t* __restrict__ cols,
              const int32_t* __restrict__ kinds, Shape sh, Band bd,
              Dropout dr) {
  extern __shared__ float smem[];
  const int D = sh.D, blk = sh.blk;
  const int R = blk < kRows ? blk : kRows;
  const int bh = blockIdx.y;
  const int h = bh % sh.H;
  const int b = bh / sh.H;
  const int r0 = blockIdx.x * R;
  const int j = r0 / blk;
  const int mrow = (h % sh.Hm) * (sh.Sq / blk) + j;
  const int n = cnts[mrow];
  const int base = offs[mrow];
  const int kvr = b * sh.Hkv + h / (sh.H / sh.Hkv);
  const T* kg = k + (size_t)kvr * sh.Sk * D;
  const T* vg = v + (size_t)kvr * sh.Sk * D;
  const float* kpm_b = KPM ? kpm + (size_t)b * sh.Sk : nullptr;

  float* qs = smem;                       // R x (D+1)
  float* ss = qs + R * (D + 1);           // R x blk: s, then p
  float* os = ss + R * blk;               // R x D accumulator
  float* kv = os + R * D;                 // R x (D+1) staged K or V rows
  float* m_s = kv + R * (D + 1);          // R
  float* l_s = m_s + R;                   // R
  float* a_s = l_s + R;                   // R: this tile's alpha

  stage_rows(qs, q + ((size_t)bh * sh.Sq + r0) * D, R, D);
  fill(os, R * D, 0.f);
  fill(m_s, R, kNegInf);
  fill(l_s, R, 0.f);
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int t = 0; t < n; ++t) {
    const int k0 = cols[base + t] * blk;
    const int kind = kinds[base + t];
    // bit i: chunk i of R keys holds a kept cell of this CTA's rows (with
    // R == 32 for walks of 32 and wider, chunk i is lane group u == i
    // below); a BAND tile's other chunks are skipped, and a tile with no
    // live chunk leaves m, l and the accumulator as they are (alpha 1)
    unsigned live = ~0u;
    if constexpr (BAND) {
      if (kind & kKindBand) {
        live = 0u;
        for (int c0 = 0; c0 < blk; c0 += R)
          if (bd.any(kind, r0, r0 + R - 1, k0 + c0,
                     k0 + c0 + R - 1))
            live |= 1u << (c0 / R);
        if (live == 0u) continue;
      }
    }
    // s = q . k over the whole walked tile, R x blk
    for (int c0 = 0; c0 < blk; c0 += R) {
      if constexpr (BAND)
        if (!((live >> (c0 / R)) & 1u)) continue;
      stage_rows(kv, kg + (size_t)(k0 + c0) * D, R, D);
      __syncthreads();
      mm(ss + c0, blk, false, nullptr, qs, D + 1, 1, kv, 1, D + 1, R, R, D);
      __syncthreads();
    }
    // online softmax of the tile: warp w owns rows w, w + 4, ...
    for (int r = warp; r < R; r += kWarps) {
      const int qi = r0 + r;
      float sv[kMaxBlk / 32];
      float mx = kNegInf;
#pragma unroll
      for (int u = 0; u < kMaxBlk / 32; ++u) {
        const int c = lane + 32 * u;
        float s = kNegInf;
        bool in_tile = c < blk;
        if constexpr (BAND) in_tile = in_tile && ((live >> u) & 1u);
        if (in_tile) {
          s = ss[r * blk + c] * sh.sm_scale;
          if constexpr (KPM) s += kpm_b[k0 + c];
          if ((kind & kKindCausal) && qi < k0 + c) s = kNegInf;
          if constexpr (BAND)
            if ((kind & kKindBand) && !bd.keep(kind, qi, k0 + c))
              s = kNegInf;
        }
        sv[u] = s;
        mx = fmaxf(mx, s);
      }
      mx = warp_max(mx);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const float m_safe = m_new <= kValidThresh ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < kMaxBlk / 32; ++u) {
        const int c = lane + 32 * u;
        bool in_tile = c < blk;
        if constexpr (BAND) in_tile = in_tile && ((live >> u) & 1u);
        if (in_tile) {
          float p = sv[u] > kValidThresh ? expf(sv[u] - m_safe) : 0.f;
          sum += p;
          if (dr.on && !dr.keep(bh, qi, k0 + c)) p = 0.f;
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
    [[maybe_unused]] bool scaled = false;
    for (int c0 = 0; c0 < blk; c0 += R) {
      if constexpr (BAND) {
        if (!((live >> (c0 / R)) & 1u)) continue;
        if (c0 != 0 && !scaled) {
          // chunk 0 was skipped: scale as its product of zeros would
          // have, round(acc * alpha), so the outputs equal those of the
          // walk without the skip bit for bit
          for (int e = threadIdx.x; e < R * D; e += blockDim.x)
            os[e] = os[e] * a_s[e / D];
          __syncthreads();
        }
        scaled = true;
      }
      stage_rows(kv, vg + (size_t)(k0 + c0) * D, R, D);
      __syncthreads();
      mm(os, D, true, c0 == 0 ? a_s : nullptr, ss + c0, blk, 1, kv, D + 1, 1,
         R, D, R);
      __syncthreads();
    }
  }

  T* og = o + ((size_t)bh * sh.Sq + r0) * D;
  for (int e = threadIdx.x; e < R * D; e += blockDim.x) {
    const int r = e / D;
    const float l = l_s[r];
    float out = os[e] / (l == 0.f ? 1.f : l);
    if (dr.on) out = out * dr.inv_keep;
    og[e] = from_f<T>(out);
  }
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    const float l = l_s[r];
    const float m = m_s[r];
    lse[(size_t)bh * sh.Sq + r0 + r] =
        l == 0.f ? kNegInf : (m <= kValidThresh ? 0.f : m) + logf(l);
  }
}

// K1 in bf16 (the tensor-core body, mma_fwd.cuh): grid (Sq / R, B*H),
// R = min(blk, 64) q rows of one block row per CTA, 16 per warp; W = blk.
struct CsrWalk {
  const int32_t* cols;    // the block row's CSR columns and kinds
  const int32_t* kinds;
  int count, blk;
  __device__ __forceinline__ int n() const { return count; }
  __device__ __forceinline__ int keys() const { return blk; }
  __device__ __forceinline__ int2 tile(int t) const {
    return make_int2(cols[t] * blk, kinds[t]);
  }
};

template <int W, int DMAX, bool KPM, bool BAND>
__global__ void __launch_bounds__(2 * kMmaMaxRows,
                                  mma_fwd_min_ctas(W, DMAX, false))
mf_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const float* __restrict__ kpm,
                  bf16* __restrict__ o, float* __restrict__ lse,
                  const int32_t* __restrict__ offs,
                  const int32_t* __restrict__ cnts,
                  const int32_t* __restrict__ cols,
                  const int32_t* __restrict__ kinds, Shape sh, Band bd,
                  Dropout dr) {
  const int R = blockDim.x / 2;
  const int D = sh.D;
  const int bh = blockIdx.y;
  const int h = bh % sh.H;
  const int b = bh / sh.H;
  // the last rows first: under a causal mask they walk the most tiles
  const int r0 = (gridDim.x - 1 - blockIdx.x) * R;
  const int mrow = (h % sh.Hm) * (sh.Sq / W) + r0 / W;
  const int base = offs[mrow];
  const CsrWalk walk{cols + base, kinds + base, cnts[mrow], W};
  const size_t kvr = (size_t)b * sh.Hkv + h / (sh.H / sh.Hkv);
  const size_t row0 = (size_t)bh * sh.Sq + r0;
  const FwdRows rows{q + row0 * D, k + kvr * sh.Sk * D, v + kvr * sh.Sk * D,
                     KPM ? kpm + (size_t)b * sh.Sk : nullptr, o + row0 * D,
                     lse + row0, r0, D, bh, sh.sm_scale};
  if constexpr (BAND)
    mma_fwd_body<W, DMAX, KPM, true, false, MaskedFlashRule>(rows, walk, bd,
                                                          dr);
  else
    mma_fwd_body<W, DMAX, KPM, false, false, MaskedFlashRule>(
        rows, walk, NoBand{}, dr);
}

// ------------------------------------------------------------------- K2
// fp32 (the CUDA-core body): grid (Sq / R, B*H); per walked tile, chunk
// by chunk of R key rows.
template <bool KPM, bool BAND>
__global__ void __launch_bounds__(kThreads)
mf_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ kpm,
             const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             float* __restrict__ dq, const int32_t* __restrict__ offs,
             const int32_t* __restrict__ cnts,
             const int32_t* __restrict__ cols,
             const int32_t* __restrict__ kinds, Shape sh, Band bd,
             Dropout dr) {
  extern __shared__ float smem[];
  const int D = sh.D, blk = sh.blk;
  const int R = blk < kRows ? blk : kRows;
  const int bh = blockIdx.y;
  const int h = bh % sh.H;
  const int b = bh / sh.H;
  const int r0 = blockIdx.x * R;
  const int j = r0 / blk;
  const int mrow = (h % sh.Hm) * (sh.Sq / blk) + j;
  const int n = cnts[mrow];
  const int base = offs[mrow];
  const int kvr = b * sh.Hkv + h / (sh.H / sh.Hkv);
  const float* kg = k + (size_t)kvr * sh.Sk * D;
  const float* vg = v + (size_t)kvr * sh.Sk * D;
  const float* kpm_b = KPM ? kpm + (size_t)b * sh.Sk : nullptr;
  const size_t row0 = (size_t)bh * sh.Sq + r0;

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
    const int kind = kinds[base + t];
    for (int c0 = 0; c0 < blk; c0 += R) {
      // a chunk of a BAND tile with no kept cell adds 0 to dq
      if constexpr (BAND)
        if ((kind & kKindBand) &&
            !bd.any(kind, r0, r0 + R - 1, k0 + c0, k0 + c0 + R - 1))
          continue;
      stage_rows(ks, kg + (size_t)(k0 + c0) * D, R, D);
      stage_rows(vs, vg + (size_t)(k0 + c0) * D, R, D);
      __syncthreads();
      mm(ps, R, false, nullptr, qs, D + 1, 1, ks, 1, D + 1, R, R, D);
      mm(dps, R, false, nullptr, dos, D + 1, 1, vs, 1, D + 1, R, R, D);
      __syncthreads();
      for (int e = threadIdx.x; e < R * R; e += blockDim.x) {
        const int r = e / R;
        const int c = e - r * R;
        const int qi = r0 + r;
        const int ki = k0 + c0 + c;
        float s = ps[e] * sh.sm_scale;
        if constexpr (KPM) s += kpm_b[ki];
        if ((kind & kKindCausal) && qi < ki) s = kNegInf;
        if constexpr (BAND)
          if ((kind & kKindBand) && !bd.keep(kind, qi, ki)) s = kNegInf;
        const float p = s > kValidThresh ? expf(s - lse_s[r]) : 0.f;
        float dp = dps[e];
        if (dr.on) dp = dr.keep(bh, qi, ki) ? dp * dr.inv_keep : 0.f;
        ps[e] = p * (dp - dl_s[r]);
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

// K2 in bf16 (the tensor-core body, mma_dq.cuh): grid (Sq / R, B*H),
// R = min(blk, 64) q rows of one block row per CTA, 16 per warp, over the
// block row's CSR walk; CH = dq_chunk(blk) keys per chunk.
template <int CH, int DMAX, bool KPM, bool BAND>
__global__ void __launch_bounds__(2 * kMmaMaxRows, DMAX <= 64 ? 3 : 2)
mf_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const float* __restrict__ kpm,
                 const bf16* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, bf16* __restrict__ dq,
                 const int32_t* __restrict__ offs,
                 const int32_t* __restrict__ cnts,
                 const int32_t* __restrict__ cols,
                 const int32_t* __restrict__ kinds, Shape sh, Band bd,
                 Dropout dr) {
  const int R = blockDim.x / 2;
  const int D = sh.D;
  const int bh = blockIdx.y;
  const int h = bh % sh.H;
  const int b = bh / sh.H;
  // the last rows first: under a causal mask they walk the most tiles
  const int r0 = (gridDim.x - 1 - blockIdx.x) * R;
  const int mrow = (h % sh.Hm) * (sh.Sq / sh.blk) + r0 / sh.blk;
  const int base = offs[mrow];
  const CsrWalk walk{cols + base, kinds + base, cnts[mrow], sh.blk};
  const size_t kvr = (size_t)b * sh.Hkv + h / (sh.H / sh.Hkv);
  const size_t row0 = (size_t)bh * sh.Sq + r0;
  const DqRows rows{q + row0 * D, dout + row0 * D, lse + row0,
                    delta + row0, k + kvr * sh.Sk * D, v + kvr * sh.Sk * D,
                    KPM ? kpm + (size_t)b * sh.Sk : nullptr, dq + row0 * D,
                    r0, D, bh, sh.sm_scale};
  if constexpr (BAND)
    mma_dq_body<CH, DMAX, KPM, true, MaskedFlashRule>(rows, walk, bd, dr);
  else
    mma_dq_body<CH, DMAX, KPM, false, MaskedFlashRule>(rows, walk,
                                                       NoBand{}, dr);
}

// ------------------------------------------------------------------- K3
// fp32 (the CUDA-core body): grid (Sk / R, B*H): one CTA per q head and
// R key rows, over the CSC walk of the key block, chunk by chunk of R
// query rows. With KPM the CTA's R key rows' mask values are loaded
// once, beside the staged K and V rows.
template <bool KPM, bool BAND>
__global__ void __launch_bounds__(kThreads)
mf_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ kpm,
              const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dk, float* __restrict__ dv,
              const int32_t* __restrict__ coffs,
              const int32_t* __restrict__ ccnts,
              const int32_t* __restrict__ crows,
              const int32_t* __restrict__ ckinds, Shape sh, Band bd,
              Dropout dr) {
  extern __shared__ float smem[];
  const int D = sh.D, blk = sh.blk;
  const int R = blk < kRows ? blk : kRows;
  const int bh = blockIdx.y;
  const int h = bh % sh.H;
  const int b = bh / sh.H;
  const int kr0 = blockIdx.x * R;
  const int jb = kr0 / blk;
  const int col = (h % sh.Hm) * (sh.Sk / blk) + jb;
  const int n = ccnts[col];
  const int base = coffs[col];
  const int kvr = b * sh.Hkv + h / (sh.H / sh.Hkv);
  const float* qg = q + (size_t)bh * sh.Sq * D;
  const float* dog = dout + (size_t)bh * sh.Sq * D;

  float* ks = smem;                 // R x (D+1)
  float* vs = ks + R * (D + 1);     // R x (D+1)
  float* qs = vs + R * (D + 1);     // R x (D+1)
  float* dos = qs + R * (D + 1);    // R x (D+1)
  float* ps = dos + R * (D + 1);    // R(q) x R(k): s, then pd
  float* dps = ps + R * R;          // R(q) x R(k): dp, then ds
  float* dks = dps + R * R;         // R x D
  float* dvs = dks + R * D;         // R x D
  float* lse_s = dvs + R * D;       // R
  float* dl_s = lse_s + R;          // R
  float* km_s = dl_s + R;           // R, with KPM: this CTA's key mask

  stage_rows(ks, k + ((size_t)kvr * sh.Sk + kr0) * D, R, D);
  stage_rows(vs, v + ((size_t)kvr * sh.Sk + kr0) * D, R, D);
  fill(dks, R * D, 0.f);
  fill(dvs, R * D, 0.f);
  if constexpr (KPM) {
    for (int c = threadIdx.x; c < R; c += blockDim.x)
      km_s[c] = kpm[(size_t)b * sh.Sk + kr0 + c];
  }
  __syncthreads();

  for (int t = 0; t < n; ++t) {
    const int q0 = crows[base + t] * blk;
    const int kind = ckinds[base + t];
    for (int c0 = 0; c0 < blk; c0 += R) {
      // a chunk of a BAND tile with no kept cell adds 0 to dk and dv
      if constexpr (BAND)
        if ((kind & kKindBand) &&
            !bd.any(kind, q0 + c0, q0 + c0 + R - 1, kr0, kr0 + R - 1))
          continue;
      const size_t qrow = (size_t)bh * sh.Sq + q0 + c0;
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
        const int qi = q0 + c0 + r;
        const int ki = kr0 + c;
        float s = ps[e] * sh.sm_scale;
        if constexpr (KPM) s += km_s[c];
        if ((kind & kKindCausal) && qi < ki) s = kNegInf;
        if constexpr (BAND)
          if ((kind & kKindBand) && !bd.keep(kind, qi, ki)) s = kNegInf;
        const float p = s > kValidThresh ? expf(s - lse_s[r]) : 0.f;
        float dp = dps[e];
        float pd = p;
        if (dr.on) {
          const bool kp = dr.keep(bh, qi, ki);
          pd = kp ? p * dr.inv_keep : 0.f;
          dp = kp ? dp * dr.inv_keep : 0.f;
        }
        ps[e] = pd;
        dps[e] = p * (dp - dl_s[r]);
      }
      __syncthreads();
      // dv += pd^T . do ; dk += ds^T . q
      mm(dvs, D, true, nullptr, ps, 1, R, dos, D + 1, 1, R, D, R);
      mm(dks, D, true, nullptr, dps, 1, R, qs, D + 1, 1, R, D, R);
      __syncthreads();
    }
  }

  float* dkg = dk + ((size_t)bh * sh.Sk + kr0) * D;
  float* dvg = dv + ((size_t)bh * sh.Sk + kr0) * D;
  for (int e = threadIdx.x; e < R * D; e += blockDim.x) {
    dkg[e] = dks[e] * sh.sm_scale;
    dvg[e] = dvs[e];
  }
}

// K3 in bf16 (the tensor-core body, mma_dkv.cuh): grid (Sk / R, B*H),
// R = min(blk, 64) key rows of one key block per CTA, 16 per warp, over
// the block's CSC column; CH = dkv_chunk(blk) query rows per chunk.
struct CscWalk {
  const int32_t* rws;     // the key block's CSC rows and kinds
  const int32_t* kinds;
  int count, blk;
  __device__ __forceinline__ int n() const { return count; }
  __device__ __forceinline__ int rows() const { return blk; }
  __device__ __forceinline__ int2 tile(int t) const {
    return make_int2(rws[t] * blk, kinds[t]);
  }
};

template <int CH, int DMAX, bool KPM, bool BAND>
__global__ void __launch_bounds__(2 * kMmaMaxRows, DMAX <= 64 ? 3 : 2)
mf_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const float* __restrict__ kpm,
                  const bf16* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, void* dk, void* dv,
                  const int32_t* __restrict__ coffs,
                  const int32_t* __restrict__ ccnts,
                  const int32_t* __restrict__ crows,
                  const int32_t* __restrict__ ckinds, Shape sh, Band bd,
                  Dropout dr, int fp32_out) {
  const int R = blockDim.x / 2;
  const int D = sh.D;
  const int bh = blockIdx.y;
  const int h = bh % sh.H;
  const int b = bh / sh.H;
  const int kr0 = blockIdx.x * R;   // the first keys walk the most tiles
  const int col = (h % sh.Hm) * (sh.Sk / sh.blk) + kr0 / sh.blk;
  const int base = coffs[col];
  const CscWalk walk{crows + base, ckinds + base, ccnts[col], sh.blk};
  const size_t kvr = (size_t)b * sh.Hkv + h / (sh.H / sh.Hkv);
  const size_t qrow = (size_t)bh * sh.Sq;
  const size_t krow = kvr * sh.Sk + kr0;
  const size_t out0 = ((size_t)bh * sh.Sk + kr0) * D * (fp32_out ? 4 : 2);
  const DkvRows rows{q + qrow * D, k + krow * D, v + krow * D,
                     dout + qrow * D, lse + qrow, delta + qrow,
                     KPM ? kpm + (size_t)b * sh.Sk : nullptr,
                     static_cast<char*>(dk) + out0,
                     static_cast<char*>(dv) + out0, fp32_out, kr0, D, bh,
                     sh.sm_scale};
  if constexpr (BAND)
    mma_dkv_body<CH, DMAX, KPM, true, MaskedFlashRule>(rows, walk, bd,
                                                       dr);
  else
    mma_dkv_body<CH, DMAX, KPM, false, MaskedFlashRule>(rows, walk,
                                                        NoBand{}, dr);
}

size_t fwd_smem(int R, int D, int blk) {
  return sizeof(float) *
         ((size_t)2 * R * (D + 1) + (size_t)R * blk + (size_t)R * D + 3 * R);
}

// K3 with a key mask holds R more floats (K2 reads its mask from global)
size_t bwd_smem(int R, int D, bool kpm_rows) {
  return sizeof(float) *
         ((size_t)4 * R * (D + 1) + (size_t)2 * R * R + (size_t)2 * R * D +
          (kpm_rows ? 3 : 2) * R);
}

bool bad_shape(int bh, int H, int Hkv, int Hm, int Sq, int Sk, int D,
               int blk) {
  return bh <= 0 || bh > 65535 || H <= 0 || Hkv <= 0 || H % Hkv != 0 ||
         bh % H != 0 || (Hm != 1 && Hm != H) || D <= 0 || D > kMaxHd ||
         D % 8 != 0 ||
         (blk != 16 && blk != 32 && blk != 64 && blk != 128) ||
         Sq <= 0 || Sk <= 0 || Sq % blk != 0 || Sk % blk != 0;
}

// fine_block 0: no band (the BAND = false instantiation)
bool bad_band(const Band& bd) {
  return bd.fb < 0 ||
         (bd.fb > 0 && (bd.w < 0 || bd.g_r < 0 || bd.g_c < 0));
}

template <typename T, bool KPM, bool BAND>
cudaError_t run_fwd(dim3 grid, size_t smem, cudaStream_t s, const void* q,
                    const void* k, const void* v, const void* kpm, void* o,
                    void* lse, const int32_t* of, const int32_t* cn,
                    const int32_t* co, const int32_t* ki, Shape sh, Band bd,
                    Dropout dr) {
  return launch(mf_fwd_kernel<T, KPM, BAND>, grid, smem, s,
                static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), static_cast<const float*>(kpm),
                static_cast<T*>(o), static_cast<float*>(lse), of, cn, co, ki,
                sh, bd, dr);
}

template <int W, int DMAX, bool KPM, bool BAND>
cudaError_t run_fwd_mma(dim3 grid, int threads, size_t smem, cudaStream_t s,
                        const void* q, const void* k, const void* v,
                        const void* kpm, void* o, void* lse,
                        const int32_t* of, const int32_t* cn,
                        const int32_t* co, const int32_t* ki, Shape sh,
                        Band bd, Dropout dr) {
  return launch_rows(mf_fwd_mma_kernel<W, DMAX, KPM, BAND>, grid, threads,
                     smem, s, static_cast<const bf16*>(q),
                     static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                     static_cast<const float*>(kpm), static_cast<bf16*>(o),
                     static_cast<float*>(lse), of, cn, co, ki, sh, bd, dr);
}

using FwdMma = decltype(&run_fwd_mma<16, 64, false, false>);

template <int W, int DMAX>
FwdMma pick_fwd_mma(bool kpm, bool band) {
  return kpm ? (band ? run_fwd_mma<W, DMAX, true, true>
                     : run_fwd_mma<W, DMAX, true, false>)
             : (band ? run_fwd_mma<W, DMAX, false, true>
                     : run_fwd_mma<W, DMAX, false, false>);
}

// the tensor-core instantiation of a walk block, head dim, key mask and
// band (the bad_shape checks passed: blk is 16, 32, 64 or 128, D <= 128)
template <int DMAX>
FwdMma pick_fwd_mma_blk(int blk, bool kpm, bool band) {
  return blk == 16   ? pick_fwd_mma<16, DMAX>(kpm, band)
         : blk == 32 ? pick_fwd_mma<32, DMAX>(kpm, band)
         : blk == 64 ? pick_fwd_mma<64, DMAX>(kpm, band)
                     : pick_fwd_mma<128, DMAX>(kpm, band);
}

template <bool KPM, bool BAND>
cudaError_t run_dq(dim3 grid, size_t smem, cudaStream_t s, const void* q,
                   const void* k, const void* v, const void* kpm,
                   const void* dout, const float* ls, const float* dl,
                   void* dq, const int32_t* of, const int32_t* cn,
                   const int32_t* co, const int32_t* ki, Shape sh, Band bd,
                   Dropout dr) {
  return launch(mf_dq_kernel<KPM, BAND>, grid, smem, s,
                static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v), static_cast<const float*>(kpm),
                static_cast<const float*>(dout), ls, dl,
                static_cast<float*>(dq), of, cn, co, ki, sh, bd, dr);
}

template <int CH, int DMAX, bool KPM, bool BAND>
cudaError_t run_dq_mma(dim3 grid, int threads, size_t smem, cudaStream_t s,
                       const void* q, const void* k, const void* v,
                       const void* kpm, const void* dout, const float* ls,
                       const float* dl, void* dq, const int32_t* of,
                       const int32_t* cn, const int32_t* co,
                       const int32_t* ki, Shape sh, Band bd, Dropout dr) {
  return launch_rows(mf_dq_mma_kernel<CH, DMAX, KPM, BAND>, grid, threads,
                     smem, s, static_cast<const bf16*>(q),
                     static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                     static_cast<const float*>(kpm),
                     static_cast<const bf16*>(dout), ls, dl,
                     static_cast<bf16*>(dq), of, cn, co, ki, sh, bd, dr);
}

using DqMma = decltype(&run_dq_mma<16, 64, false, false>);

template <int CH, int DMAX>
DqMma pick_dq_mma(bool kpm, bool band) {
  return kpm ? (band ? run_dq_mma<CH, DMAX, true, true>
                     : run_dq_mma<CH, DMAX, true, false>)
             : (band ? run_dq_mma<CH, DMAX, false, true>
                     : run_dq_mma<CH, DMAX, false, false>);
}

// the tensor-core instantiation of a walk block's chunk, head dim, key
// mask and band (the bad_shape checks passed: D <= 128)
DqMma pick_dq_mma_blk(int blk, int D, bool kpm, bool band) {
  const bool wide = D > 64;
  return dq_chunk(blk) == 16
             ? (wide ? pick_dq_mma<16, 128>(kpm, band)
                     : pick_dq_mma<16, 64>(kpm, band))
             : (wide ? pick_dq_mma<32, 128>(kpm, band)
                     : pick_dq_mma<32, 64>(kpm, band));
}

template <bool KPM, bool BAND>
cudaError_t run_dkv(dim3 grid, size_t smem, cudaStream_t s, const void* q,
                    const void* k, const void* v, const void* kpm,
                    const void* dout, const float* ls, const float* dl,
                    void* dk, void* dv, const int32_t* of, const int32_t* cn,
                    const int32_t* ro, const int32_t* ki, Shape sh, Band bd,
                    Dropout dr) {
  return launch(mf_dkv_kernel<KPM, BAND>, grid, smem, s,
                static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v), static_cast<const float*>(kpm),
                static_cast<const float*>(dout), ls, dl,
                static_cast<float*>(dk), static_cast<float*>(dv), of, cn, ro,
                ki, sh, bd, dr);
}

// the instantiation of one dtype for a call's key mask and band
template <typename T>
auto pick_fwd(bool kpm, bool band) {
  return kpm ? (band ? run_fwd<T, true, true> : run_fwd<T, true, false>)
             : (band ? run_fwd<T, false, true> : run_fwd<T, false, false>);
}

auto pick_dq(bool kpm, bool band) {
  return kpm ? (band ? run_dq<true, true> : run_dq<true, false>)
             : (band ? run_dq<false, true> : run_dq<false, false>);
}

auto pick_dkv(bool kpm, bool band) {
  return kpm ? (band ? run_dkv<true, true> : run_dkv<true, false>)
             : (band ? run_dkv<false, true> : run_dkv<false, false>);
}

template <int CH, int DMAX, bool KPM, bool BAND>
cudaError_t run_dkv_mma(dim3 grid, int threads, size_t smem,
                        cudaStream_t s, const void* q, const void* k,
                        const void* v, const void* kpm, const void* dout,
                        const float* ls, const float* dl, void* dk, void* dv,
                        const int32_t* of, const int32_t* cn,
                        const int32_t* ro, const int32_t* ki, Shape sh,
                        Band bd, Dropout dr, int fp32_out) {
  return launch_rows(mf_dkv_mma_kernel<CH, DMAX, KPM, BAND>, grid, threads,
                     smem, s, static_cast<const bf16*>(q),
                     static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                     static_cast<const float*>(kpm),
                     static_cast<const bf16*>(dout), ls, dl, dk, dv, of, cn,
                     ro, ki, sh, bd, dr, fp32_out);
}

using DkvMma = decltype(&run_dkv_mma<16, 64, false, false>);

template <int CH, int DMAX>
DkvMma pick_dkv_mma(bool kpm, bool band) {
  return kpm ? (band ? run_dkv_mma<CH, DMAX, true, true>
                     : run_dkv_mma<CH, DMAX, true, false>)
             : (band ? run_dkv_mma<CH, DMAX, false, true>
                     : run_dkv_mma<CH, DMAX, false, false>);
}

// the tensor-core instantiation of a walk block's chunk, head dim, key
// mask and band (the bad_shape checks passed: D <= 128)
DkvMma pick_dkv_mma_blk(int blk, int D, bool kpm, bool band) {
  const bool wide = D > 64;
  return dkv_chunk(blk) == 16
             ? (wide ? pick_dkv_mma<16, 128>(kpm, band)
                     : pick_dkv_mma<16, 64>(kpm, band))
             : (wide ? pick_dkv_mma<32, 128>(kpm, band)
                     : pick_dkv_mma<32, 64>(kpm, band));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. kpm: the (B, Sk) fp32 additive key
// mask, or null for none. fine_block, band_w, band_g_r, band_g_c,
// band_causal: the band of KIND_BAND tiles (fine_block 0 for none). Each
// entry point returns the CUDA error of its launch (0 on success); it
// launches on `stream` and does not synchronise. Each runs bf16 on its
// tensor-core body (q, k, v, do and the outputs 16-byte aligned, kpm 8:
// else cudaErrorInvalidValue) and fp32 on its CUDA-core body.
extern "C" int masked_flash_fwd(
    const void* q, const void* k, const void* v, const void* kpm, void* o,
    void* lse, const void* offs, const void* cnts, const void* cols,
    const void* kinds, int dtype, int bh, int heads, int kv_heads,
    int mask_heads, int seq_q, int seq_k, int head_dim, int block,
    int fine_block, int band_w, int band_g_r, int band_g_c, int band_causal,
    float sm_scale, int dropout, unsigned keep_thresh, float inv_keep,
    int seed, int bh0, void* stream) {
  const Band bd{fine_block, band_w, band_g_r, band_g_c, band_causal};
  if (bad_shape(bh, heads, kv_heads, mask_heads, seq_q, seq_k, head_dim,
                block) || bad_band(bd))
    return (int)cudaErrorInvalidValue;
  const Shape sh{heads, kv_heads, mask_heads, seq_q, seq_k,
                 head_dim, block, sm_scale};
  const Dropout dr = make_dropout(dropout, keep_thresh, inv_keep, seed,
                                  bh0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* of = static_cast<const int32_t*>(offs);
  const int32_t* cn = static_cast<const int32_t*>(cnts);
  const int32_t* co = static_cast<const int32_t*>(cols);
  const int32_t* ki = static_cast<const int32_t*>(kinds);
  const bool band = fine_block > 0, has_kpm = kpm != nullptr;
  if (dtype == 1) {           // bf16: the tensor-core body, or an error
    if (fwd_misaligned(q, k, v, o, kpm)) return (int)cudaErrorInvalidValue;
    const int R = mma_rows(block);
    auto run = head_dim <= 64 ? pick_fwd_mma_blk<64>(block, has_kpm, band)
                              : pick_fwd_mma_blk<128>(block, has_kpm, band);
    return (int)run(dim3(seq_q / R, bh), 2 * R,
                    mma_fwd_smem(R, block, head_dim), s, q, k, v, kpm, o,
                    lse, of, cn, co, ki, sh, bd, dr);
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  const int R = rows_of(block);      // fp32: the CUDA-core body
  return (int)pick_fwd<float>(has_kpm, band)(
      dim3(seq_q / R, bh), fwd_smem(R, head_dim, block), s, q, k, v, kpm, o,
      lse, of, cn, co, ki, sh, bd, dr);
}

extern "C" int masked_flash_dq(
    const void* q, const void* k, const void* v, const void* kpm,
    const void* dout, const void* lse, const void* delta, void* dq,
    const void* offs, const void* cnts, const void* cols, const void* kinds,
    int dtype, int bh, int heads, int kv_heads, int mask_heads, int seq_q,
    int seq_k, int head_dim, int block, int fine_block, int band_w,
    int band_g_r, int band_g_c, int band_causal, float sm_scale,
    int dropout, unsigned keep_thresh, float inv_keep, int seed, int bh0,
    void* stream) {
  const Band bd{fine_block, band_w, band_g_r, band_g_c, band_causal};
  if (bad_shape(bh, heads, kv_heads, mask_heads, seq_q, seq_k, head_dim,
                block) || bad_band(bd))
    return (int)cudaErrorInvalidValue;
  const Shape sh{heads, kv_heads, mask_heads, seq_q, seq_k,
                 head_dim, block, sm_scale};
  const Dropout dr = make_dropout(dropout, keep_thresh, inv_keep, seed,
                                  bh0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ls = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const int32_t* of = static_cast<const int32_t*>(offs);
  const int32_t* cn = static_cast<const int32_t*>(cnts);
  const int32_t* co = static_cast<const int32_t*>(cols);
  const int32_t* ki = static_cast<const int32_t*>(kinds);
  const bool band = fine_block > 0, has_kpm = kpm != nullptr;
  if (dtype == 1) {           // bf16: the tensor-core body, or an error
    // one output: dq stands for both of dk/dv's
    if (dkv_misaligned(q, k, v, dout, dq, dq, kpm))
      return (int)cudaErrorInvalidValue;
    const int R = mma_rows(block);
    return (int)pick_dq_mma_blk(block, head_dim, has_kpm, band)(
        dim3(seq_q / R, bh), 2 * R, mma_dq_smem(R, block, head_dim), s, q, k,
        v, kpm, dout, ls, dl, dq, of, cn, co, ki, sh, bd, dr);
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  const int R = rows_of(block);      // fp32: the CUDA-core body
  return (int)pick_dq(has_kpm, band)(
      dim3(seq_q / R, bh), bwd_smem(R, head_dim, false), s, q, k, v, kpm,
      dout, ls, dl, dq, of, cn, co, ki, sh, bd, dr);
}

// fp32_out: 1 writes dk, dv as fp32 per-q-head partials (GQA), 0 in the
// input dtype. Both are (B*H, Sk, D).
extern "C" int masked_flash_dkv(
    const void* q, const void* k, const void* v, const void* kpm,
    const void* dout, const void* lse, const void* delta, void* dk, void* dv,
    const void* coffs, const void* ccnts, const void* crows,
    const void* ckinds, int dtype, int fp32_out, int bh, int heads,
    int kv_heads, int mask_heads, int seq_q, int seq_k, int head_dim,
    int block, int fine_block, int band_w, int band_g_r, int band_g_c,
    int band_causal, float sm_scale, int dropout, unsigned keep_thresh,
    float inv_keep, int seed, int bh0, void* stream) {
  const Band bd{fine_block, band_w, band_g_r, band_g_c, band_causal};
  if (bad_shape(bh, heads, kv_heads, mask_heads, seq_q, seq_k, head_dim,
                block) || bad_band(bd))
    return (int)cudaErrorInvalidValue;
  const Shape sh{heads, kv_heads, mask_heads, seq_q, seq_k,
                 head_dim, block, sm_scale};
  const Dropout dr = make_dropout(dropout, keep_thresh, inv_keep, seed,
                                  bh0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ls = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const int32_t* of = static_cast<const int32_t*>(coffs);
  const int32_t* cn = static_cast<const int32_t*>(ccnts);
  const int32_t* ro = static_cast<const int32_t*>(crows);
  const int32_t* ki = static_cast<const int32_t*>(ckinds);
  const bool band = fine_block > 0, has_kpm = kpm != nullptr;
  if (dtype == 1) {           // bf16: the tensor-core body, or an error
    if (dkv_misaligned(q, k, v, dout, dk, dv, kpm))
      return (int)cudaErrorInvalidValue;
    const int R = mma_rows(block);
    return (int)pick_dkv_mma_blk(block, head_dim, has_kpm, band)(
        dim3(seq_k / R, bh), 2 * R, mma_dkv_smem(R, block, head_dim), s, q,
        k, v, kpm, dout, ls, dl, dk, dv, of, cn, ro, ki, sh, bd, dr,
        fp32_out != 0);
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  const int R = rows_of(block);      // fp32: the CUDA-core body
  return (int)pick_dkv(has_kpm, band)(
      dim3(seq_k / R, bh), bwd_smem(R, head_dim, has_kpm), s, q, k, v, kpm,
      dout, ls, dl, dk, dv, of, cn, ro, ki, sh, bd, dr);
}
