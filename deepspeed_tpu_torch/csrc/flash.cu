// Dense flash attention for training, forward and backward, for Hopper:
// the legacy per-path kernels behind set_attention_options(kernel="flash").
//
// Replaces the three Pallas TPU kernels of
// deepspeed_tpu/ops/attention/flash.py:
//   K5 _fwd_kernel     -> flash_fwd : o, lse     (walk over key blocks)
//   K6 _bwd_dq_kernel  -> flash_dq  : dq         (walk over key blocks)
//   K7 _bwd_dkv_kernel -> flash_dkv : dk, dv     (walk over query blocks)
// Same function as the Pallas kernels, in every arity they have:
//   q (B*H, Sq, D); k, v (B*Hkv, Sk, D) in fp32 or bf16, GQA kv row
//   b*Hkv + h / (H/Hkv) (JAX's bh // q_per_kv); rectangular tiles of bq
//   query rows by bk keys; full or causal (q_idx >= k_idx, with
//   Sq != Sk too); optionally the additive fp32 key mask kpm (B, Sk)
//   (the template flag KPM: a null kpm pointer runs KPM = false);
//   optionally the counter-hash dropout keyed on the q-head row b*H + h.
// The causal walk: q block qb walks key blocks [0, ceil((qb*bq + bq) / bk))
// as in JAX, capped at the Sk / bk blocks that exist (JAX walks past them
// when Sq > Sk: on the TPU that reads past the block, in interpret mode
// it repeats the last key block); K7's key block kb walks query blocks
// [kb*bk / bq, Sq / bq), so the keys no query reaches (Sq < Sk) get
// dk = dv = 0.
// Semantics kept exactly: s = (q.k) * sm_scale, then s += kpm[b, key] in
// fp32, then the causal clip sets s = NEG_INF. No validity threshold, as
// in the Pallas bodies: K5's online softmax takes p = exp(s - m_new) and
// alpha = exp(m_old - m_new) per walked tile of bk keys, l from the
// undropped p, and writes o = acc / l (l = 0 taken as 1) and
// lse = m + log(l); K6 and K7 take p = exp(s - lse). Dropout drops p
// after l (K5) and scales o by 1/(1-rate) after the normalization; K6
// scales dp, K7 both pd (for dv) and dp; ds = p * (dp - delta) takes the
// undropped p. p is rounded to V's dtype before P.V, pd to do's and ds to
// K/Q's dtype before their products; every sum accumulates in fp32; dq
// and dk are scaled by sm_scale once at the end. K7 keeps JAX's grid
// over q heads: at G > 1 it writes fp32 per-q-head partials that the
// caller sums per group.
//
// What bounds it on an H100: operations. At the GPT-2 345M training
// shapes (B 8, H 16, S 1024, D 64, causal) a walked 128 x 128 tile does
// 2-4 products of 128 x 128 x 64 for 2 x 128 x 64 input values, well
// above the ~295 flop/byte line. K5 in bf16 runs K1's tensor-core body
// (mma_fwd.cuh) over this walk: a CTA owns min(bq, 64) query rows of one
// query block, 16 per warp, with Q, the scores and O in registers, and
// streams the walked tiles of bk keys through a cp.async ring of bf16
// chunks. K6 in bf16 runs K2's tensor-core body (mma_dq.cuh) over the
// same walk: a CTA owns min(bq, 64) query rows, 16 per warp, with dQ in
// registers, and streams K and V in chunks of up to 32 keys. K7 in bf16
// runs K3's tensor-core body (mma_dkv.cuh) over its walk of query tiles:
// a CTA owns min(bk, 64) key rows of one key tile, 16 per warp, with dK
// and dV in registers, and streams Q and dO in chunks of up to 32 query
// rows. The fp32 arity of K5-K7 is the first, simple design of K1-K3
// (masked_flash.cu) on the CUDA cores: a
// CTA of 128 threads owns R = min(bq, 32) query rows (K5, K6) or R =
// min(bk, 32) key rows (K7); it stages its own rows once and the partner
// rows of each walked tile in chunks of min(b, 32) rows into shared
// memory as fp32 (rows padded to D+1 words), and does every product with
// the 2x4 register micro-tile of flash_tiles.cuh's mm. K5 keeps a whole
// tile's scores so that the running max moves once per walked tile of bk
// keys, as in the Pallas kernel. JAX's streamed layout (K/V or q/do
// through double-buffered DMA above STREAM_THRESHOLD) is a TPU VMEM
// layout: these kernels stage through shared memory at every length and
// need no second code path.
//
// Built by deepspeed_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// into a library with a plain C interface, loaded through ctypes.

#include <stdint.h>

#include "flash_tiles.cuh"
#include "mma_dq.cuh"

namespace {

struct Geo {
  int H, Hkv;          // q heads, kv heads
  int Sq, Sk, D;       // sequence lengths, head dim
  int bq, bk;          // the walk's tile: query rows by keys
  int causal;
  float sm_scale;
};

// K5, K6: the key blocks query block qb walks (JAX's num_kb, capped)
__device__ __forceinline__ int key_blocks(const Geo& g, int qb) {
  const int nk = g.Sk / g.bk;
  if (!g.causal) return nk;
  const int n = (qb * g.bq + g.bq + g.bk - 1) / g.bk;
  return n < nk ? n : nk;
}

// ------------------------------------------------------------------- K5
// fp32 (the CUDA-core body): grid (Sq / R, B*H); R = min(bq, 32) query
// rows per CTA, key chunks of C = min(bk, 32) rows.
template <typename T, bool KPM>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ kpm,
                 T* __restrict__ o, float* __restrict__ lse, Geo g,
                 Dropout dr) {
  extern __shared__ float smem[];
  const int D = g.D, bk = g.bk;
  const int R = rows_of(g.bq);
  const int C = rows_of(bk);
  const int bh = blockIdx.y;
  const int h = bh % g.H;
  const int b = bh / g.H;
  const int r0 = blockIdx.x * R;
  const int nkb = key_blocks(g, r0 / g.bq);
  const int kvr = b * g.Hkv + h / (g.H / g.Hkv);
  const T* kg = k + (size_t)kvr * g.Sk * D;
  const T* vg = v + (size_t)kvr * g.Sk * D;
  const float* kpm_b = KPM ? kpm + (size_t)b * g.Sk : nullptr;

  float* qs = smem;                       // R x (D+1)
  float* ss = qs + R * (D + 1);           // R x bk: s, then p
  float* os = ss + R * bk;                // R x D accumulator
  float* kv = os + R * D;                 // C x (D+1) staged K or V rows
  float* m_s = kv + C * (D + 1);          // R
  float* l_s = m_s + R;                   // R
  float* a_s = l_s + R;                   // R: this tile's alpha

  stage_rows(qs, q + ((size_t)bh * g.Sq + r0) * D, R, D);
  fill(os, R * D, 0.f);
  fill(m_s, R, kNegInf);
  fill(l_s, R, 0.f);
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int j = 0; j < nkb; ++j) {
    const int k0 = j * bk;
    // s = q . k over the whole walked tile, R x bk
    for (int c0 = 0; c0 < bk; c0 += C) {
      stage_rows(kv, kg + (size_t)(k0 + c0) * D, C, D);
      __syncthreads();
      mm(ss + c0, bk, false, nullptr, qs, D + 1, 1, kv, 1, D + 1, R, C, D);
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
        if (c < bk) {
          s = ss[r * bk + c] * g.sm_scale;
          if constexpr (KPM) s += kpm_b[k0 + c];
          if (g.causal && qi < k0 + c) s = kNegInf;
          mx = fmaxf(mx, s);
        }
        sv[u] = s;
      }
      mx = warp_max(mx);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < kMaxBlk / 32; ++u) {
        const int c = lane + 32 * u;
        if (c < bk) {
          float p = expf(sv[u] - m_new);
          sum += p;
          if (dr.on && !dr.keep(bh, qi, k0 + c)) p = 0.f;
          ss[r * bk + c] = round_to<T>(p);
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
    for (int c0 = 0; c0 < bk; c0 += C) {
      stage_rows(kv, vg + (size_t)(k0 + c0) * D, C, D);
      __syncthreads();
      mm(os, D, true, c0 == 0 ? a_s : nullptr, ss + c0, bk, 1, kv, D + 1, 1,
         R, D, C);
      __syncthreads();
    }
  }

  T* og = o + ((size_t)bh * g.Sq + r0) * D;
  for (int e = threadIdx.x; e < R * D; e += blockDim.x) {
    const float l = l_s[e / D];
    float out = os[e] / (l == 0.f ? 1.f : l);
    if (dr.on) out = out * dr.inv_keep;
    og[e] = from_f<T>(out);
  }
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    const float l = l_s[r];
    lse[(size_t)bh * g.Sq + r0 + r] = m_s[r] + logf(l == 0.f ? 1.f : l);
  }
}

// K5 and K6 in bf16 (the tensor-core bodies, mma_fwd.cuh and mma_dq.cuh):
// grid (Sq / R, B*H), R = min(bq, 64) query rows of one query block per
// CTA, 16 per warp; W = bk. A walked tile is CAUSAL (the clip) when
// causal and a key of it lies past the CTA's first row r0, else FULL.
struct BlockWalk {
  int count, bk, causal, r0;
  __device__ __forceinline__ int n() const { return count; }
  __device__ __forceinline__ int keys() const { return bk; }
  __device__ __forceinline__ int2 tile(int t) const {
    const int k0 = t * bk;
    return make_int2(k0, causal && k0 + bk - 1 > r0 ? kKindCausal : 0);
  }
};

template <int W, int DMAX, bool KPM>
__global__ void __launch_bounds__(2 * kMmaMaxRows,
                                  mma_fwd_min_ctas(W, DMAX, false))
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const float* __restrict__ kpm, bf16* __restrict__ o,
                     float* __restrict__ lse, Geo g, Dropout dr) {
  const int R = blockDim.x / 2;
  const int D = g.D;
  const int bh = blockIdx.y;
  const int h = bh % g.H;
  const int b = bh / g.H;
  // the last rows first: under a causal mask they walk the most tiles
  const int r0 = (gridDim.x - 1 - blockIdx.x) * R;
  const BlockWalk walk{key_blocks(g, r0 / g.bq), W, g.causal, r0};
  const size_t kvr = (size_t)b * g.Hkv + h / (g.H / g.Hkv);
  const size_t row0 = (size_t)bh * g.Sq + r0;
  const FwdRows rows{q + row0 * D, k + kvr * g.Sk * D, v + kvr * g.Sk * D,
                     KPM ? kpm + (size_t)b * g.Sk : nullptr, o + row0 * D,
                     lse + row0, r0, D, bh, g.sm_scale};
  mma_fwd_body<W, DMAX, KPM, false, false, FlashRule>(rows, walk, NoBand{},
                                                     dr);
}

// ------------------------------------------------------------------- K6
// fp32 (the CUDA-core body): grid (Sq / R, B*H); per walked tile, chunk
// by chunk of C keys.
template <bool KPM>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ kpm,
                const float* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dq,
                Geo g, Dropout dr) {
  extern __shared__ float smem[];
  const int D = g.D, bk = g.bk;
  const int R = rows_of(g.bq);
  const int C = rows_of(bk);
  const int bh = blockIdx.y;
  const int h = bh % g.H;
  const int b = bh / g.H;
  const int r0 = blockIdx.x * R;
  const int nkb = key_blocks(g, r0 / g.bq);
  const int kvr = b * g.Hkv + h / (g.H / g.Hkv);
  const float* kg = k + (size_t)kvr * g.Sk * D;
  const float* vg = v + (size_t)kvr * g.Sk * D;
  const float* kpm_b = KPM ? kpm + (size_t)b * g.Sk : nullptr;
  const size_t row0 = (size_t)bh * g.Sq + r0;

  float* qs = smem;                 // R x (D+1)
  float* dos = qs + R * (D + 1);    // R x (D+1)
  float* ks = dos + R * (D + 1);    // C x (D+1)
  float* vs = ks + C * (D + 1);     // C x (D+1)
  float* ps = vs + C * (D + 1);     // R x C: s, then ds
  float* dps = ps + R * C;          // R x C: dp
  float* dqs = dps + R * C;         // R x D accumulator
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

  for (int j = 0; j < nkb; ++j) {
    for (int c0 = 0; c0 < bk; c0 += C) {
      const int k0 = j * bk + c0;
      stage_rows(ks, kg + (size_t)k0 * D, C, D);
      stage_rows(vs, vg + (size_t)k0 * D, C, D);
      __syncthreads();
      mm(ps, C, false, nullptr, qs, D + 1, 1, ks, 1, D + 1, R, C, D);
      mm(dps, C, false, nullptr, dos, D + 1, 1, vs, 1, D + 1, R, C, D);
      __syncthreads();
      for (int e = threadIdx.x; e < R * C; e += blockDim.x) {
        const int r = e / C;
        const int qi = r0 + r;
        const int ki = k0 + e - r * C;
        float s = ps[e] * g.sm_scale;
        if constexpr (KPM) s += kpm_b[ki];
        if (g.causal && qi < ki) s = kNegInf;
        const float p = expf(s - lse_s[r]);
        float dp = dps[e];
        if (dr.on) dp = dr.keep(bh, qi, ki) ? dp * dr.inv_keep : 0.f;
        ps[e] = p * (dp - dl_s[r]);
      }
      __syncthreads();
      mm(dqs, D, true, nullptr, ps, C, 1, ks, D + 1, 1, R, D, C);
      __syncthreads();
    }
  }

  float* dqg = dq + row0 * D;
  for (int e = threadIdx.x; e < R * D; e += blockDim.x)
    dqg[e] = dqs[e] * g.sm_scale;
}

// K6 in bf16 (the tensor-core body, mma_dq.cuh): grid (Sq / R, B*H),
// R = min(bq, 64) query rows of one query block per CTA, 16 per warp,
// over K5's walk of key tiles; CH = dq_chunk(bk) keys per chunk.
template <int CH, int DMAX, bool KPM>
__global__ void __launch_bounds__(2 * kMmaMaxRows, DMAX <= 64 ? 3 : 2)
flash_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v,
                    const float* __restrict__ kpm,
                    const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    Geo g, Dropout dr) {
  const int R = blockDim.x / 2;
  const int D = g.D;
  const int bh = blockIdx.y;
  const int h = bh % g.H;
  const int b = bh / g.H;
  // the last rows first: under a causal mask they walk the most tiles
  const int r0 = (gridDim.x - 1 - blockIdx.x) * R;
  const BlockWalk walk{key_blocks(g, r0 / g.bq), g.bk, g.causal, r0};
  const size_t kvr = (size_t)b * g.Hkv + h / (g.H / g.Hkv);
  const size_t row0 = (size_t)bh * g.Sq + r0;
  const DqRows rows{q + row0 * D, dout + row0 * D, lse + row0,
                    delta + row0, k + kvr * g.Sk * D, v + kvr * g.Sk * D,
                    KPM ? kpm + (size_t)b * g.Sk : nullptr, dq + row0 * D,
                    r0, D, bh, g.sm_scale};
  mma_dq_body<CH, DMAX, KPM, false, FlashRule>(rows, walk, NoBand{},
                                                dr);
}

// ------------------------------------------------------------------- K7
// fp32 (the CUDA-core body): grid (Sk / R, B*H): one CTA per q head and
// R = min(bk, 32) key rows, over the query blocks of its key block, chunk
// by chunk of C = min(bq, 32) query rows.
template <bool KPM>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ kpm,
                 const float* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dk,
                 float* __restrict__ dv, Geo g, Dropout dr) {
  extern __shared__ float smem[];
  const int D = g.D;
  const int R = rows_of(g.bk);
  const int C = rows_of(g.bq);
  const int bh = blockIdx.y;
  const int h = bh % g.H;
  const int b = bh / g.H;
  const int kr0 = blockIdx.x * R;
  // JAX's first_qb: the query blocks before it hold no row at or past
  // this key block
  const int first = g.causal ? (kr0 / g.bk) * g.bk / g.bq * g.bq : 0;
  const int kvr = b * g.Hkv + h / (g.H / g.Hkv);
  const float* qg = q + (size_t)bh * g.Sq * D;
  const float* dog = dout + (size_t)bh * g.Sq * D;

  float* ks = smem;                 // R x (D+1)
  float* vs = ks + R * (D + 1);     // R x (D+1)
  float* qs = vs + R * (D + 1);     // C x (D+1)
  float* dos = qs + C * (D + 1);    // C x (D+1)
  float* ps = dos + C * (D + 1);    // C(q) x R(k): s, then pd
  float* dps = ps + C * R;          // C(q) x R(k): dp, then ds
  float* dks = dps + C * R;         // R x D
  float* dvs = dks + R * D;         // R x D
  float* lse_s = dvs + R * D;       // C
  float* dl_s = lse_s + C;          // C
  float* km_s = dl_s + C;           // R, with KPM: this CTA's key mask

  stage_rows(ks, k + ((size_t)kvr * g.Sk + kr0) * D, R, D);
  stage_rows(vs, v + ((size_t)kvr * g.Sk + kr0) * D, R, D);
  fill(dks, R * D, 0.f);
  fill(dvs, R * D, 0.f);
  if constexpr (KPM) {
    for (int c = threadIdx.x; c < R; c += blockDim.x)
      km_s[c] = kpm[(size_t)b * g.Sk + kr0 + c];
  }
  __syncthreads();

  for (int q0 = first; q0 < g.Sq; q0 += C) {
    const size_t qrow = (size_t)bh * g.Sq + q0;
    stage_rows(qs, qg + (size_t)q0 * D, C, D);
    stage_rows(dos, dog + (size_t)q0 * D, C, D);
    for (int r = threadIdx.x; r < C; r += blockDim.x) {
      lse_s[r] = lse[qrow + r];
      dl_s[r] = delta[qrow + r];
    }
    __syncthreads();
    mm(ps, R, false, nullptr, qs, D + 1, 1, ks, 1, D + 1, C, R, D);
    mm(dps, R, false, nullptr, dos, D + 1, 1, vs, 1, D + 1, C, R, D);
    __syncthreads();
    for (int e = threadIdx.x; e < C * R; e += blockDim.x) {
      const int r = e / R;            // query row in the chunk
      const int c = e - r * R;        // key row of this CTA
      const int qi = q0 + r;
      const int ki = kr0 + c;
      float s = ps[e] * g.sm_scale;
      if constexpr (KPM) s += km_s[c];
      if (g.causal && qi < ki) s = kNegInf;
      const float p = expf(s - lse_s[r]);
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
    mm(dvs, D, true, nullptr, ps, 1, R, dos, D + 1, 1, R, D, C);
    mm(dks, D, true, nullptr, dps, 1, R, qs, D + 1, 1, R, D, C);
    __syncthreads();
  }

  float* dkg = dk + ((size_t)bh * g.Sk + kr0) * D;
  float* dvg = dv + ((size_t)bh * g.Sk + kr0) * D;
  for (int e = threadIdx.x; e < R * D; e += blockDim.x) {
    dkg[e] = dks[e] * g.sm_scale;
    dvg[e] = dvs[e];
  }
}

// K7 in bf16 (the tensor-core body, mma_dkv.cuh): grid (Sk / R, B*H),
// R = min(bk, 64) key rows of one key tile per CTA, 16 per warp, over
// the query tiles of bq rows from JAX's first_qb on. A walked tile is
// CAUSAL (the clip) when causal and one of its queries lies before the
// CTA's last key, else FULL.
struct QBlockWalk {
  int first, count, bq, causal, klast;
  __device__ __forceinline__ int n() const { return count; }
  __device__ __forceinline__ int rows() const { return bq; }
  __device__ __forceinline__ int2 tile(int t) const {
    const int q0 = first + t * bq;
    return make_int2(q0, causal && q0 < klast ? kKindCausal : 0);
  }
};

template <int CH, int DMAX, bool KPM>
__global__ void __launch_bounds__(2 * kMmaMaxRows, DMAX <= 64 ? 3 : 2)
flash_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const float* __restrict__ kpm,
                     const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, void* dk, void* dv,
                     Geo g, Dropout dr, int fp32_out) {
  const int R = blockDim.x / 2;
  const int D = g.D;
  const int bh = blockIdx.y;
  const int h = bh % g.H;
  const int b = bh / g.H;
  const int kr0 = blockIdx.x * R;   // the first keys walk the most tiles
  const int first = g.causal ? (kr0 / g.bk) * g.bk / g.bq * g.bq : 0;
  const int count = first < g.Sq ? (g.Sq - first) / g.bq : 0;
  const QBlockWalk walk{first, count, g.bq, g.causal, kr0 + R - 1};
  const size_t kvr = (size_t)b * g.Hkv + h / (g.H / g.Hkv);
  const size_t qrow = (size_t)bh * g.Sq;
  const size_t krow = kvr * g.Sk + kr0;
  const size_t out0 = ((size_t)bh * g.Sk + kr0) * D * (fp32_out ? 4 : 2);
  const DkvRows rows{q + qrow * D, k + krow * D, v + krow * D,
                     dout + qrow * D, lse + qrow, delta + qrow,
                     KPM ? kpm + (size_t)b * g.Sk : nullptr,
                     static_cast<char*>(dk) + out0,
                     static_cast<char*>(dv) + out0, fp32_out, kr0, D, bh,
                     g.sm_scale};
  mma_dkv_body<CH, DMAX, KPM, false, FlashRule>(rows, walk, NoBand{},
                                                 dr);
}

size_t fwd_smem(int R, int C, int D, int bk) {
  return sizeof(float) * ((size_t)(R + C) * (D + 1) + (size_t)R * bk +
                          (size_t)R * D + 3 * R);
}

size_t dq_smem(int R, int C, int D) {
  return sizeof(float) * ((size_t)2 * (R + C) * (D + 1) + (size_t)2 * R * C +
                          (size_t)R * D + 2 * R);
}

size_t dkv_smem(int R, int C, int D) {
  return sizeof(float) * ((size_t)2 * (R + C) * (D + 1) + (size_t)2 * R * C +
                          (size_t)2 * R * D + 2 * C + R);
}

bool bad_block(int blk) {
  return blk != 16 && blk != 32 && blk != 64 && blk != 128;
}

bool bad_shape(int bh, int H, int Hkv, int Sq, int Sk, int D, int bq,
               int bk) {
  return bh <= 0 || bh > 65535 || H <= 0 || Hkv <= 0 || H % Hkv != 0 ||
         bh % H != 0 || D <= 0 || D > kMaxHd || D % 8 != 0 ||
         bad_block(bq) || bad_block(bk) || Sq <= 0 || Sk <= 0 ||
         Sq % bq != 0 || Sk % bk != 0;
}

template <typename T, bool KPM>
cudaError_t run_fwd(dim3 grid, size_t smem, cudaStream_t s, const void* q,
                    const void* k, const void* v, const void* kpm, void* o,
                    void* lse, Geo g, Dropout dr) {
  return launch(flash_fwd_kernel<T, KPM>, grid, smem, s,
                static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), static_cast<const float*>(kpm),
                static_cast<T*>(o), static_cast<float*>(lse), g, dr);
}

template <int W, int DMAX, bool KPM>
cudaError_t run_fwd_mma(dim3 grid, int threads, size_t smem, cudaStream_t s,
                        const void* q, const void* k, const void* v,
                        const void* kpm, void* o, void* lse, Geo g,
                        Dropout dr) {
  return launch_rows(flash_fwd_mma_kernel<W, DMAX, KPM>, grid, threads, smem,
                     s, static_cast<const bf16*>(q),
                     static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                     static_cast<const float*>(kpm), static_cast<bf16*>(o),
                     static_cast<float*>(lse), g, dr);
}

using FwdMma = decltype(&run_fwd_mma<16, 64, false>);

// the tensor-core instantiation of a key tile and key mask (the
// bad_shape checks passed: bk is 16, 32, 64 or 128)
template <int DMAX>
FwdMma pick_fwd_mma(int bk, bool kpm) {
  return bk == 16   ? (kpm ? run_fwd_mma<16, DMAX, true>
                           : run_fwd_mma<16, DMAX, false>)
         : bk == 32 ? (kpm ? run_fwd_mma<32, DMAX, true>
                           : run_fwd_mma<32, DMAX, false>)
         : bk == 64 ? (kpm ? run_fwd_mma<64, DMAX, true>
                           : run_fwd_mma<64, DMAX, false>)
                    : (kpm ? run_fwd_mma<128, DMAX, true>
                           : run_fwd_mma<128, DMAX, false>);
}

template <bool KPM>
cudaError_t run_dq(dim3 grid, size_t smem, cudaStream_t s, const void* q,
                   const void* k, const void* v, const void* kpm,
                   const void* dout, const float* ls, const float* dl,
                   void* dq, Geo g, Dropout dr) {
  return launch(flash_dq_kernel<KPM>, grid, smem, s,
                static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v), static_cast<const float*>(kpm),
                static_cast<const float*>(dout), ls, dl,
                static_cast<float*>(dq), g, dr);
}

template <int CH, int DMAX, bool KPM>
cudaError_t run_dq_mma(dim3 grid, int threads, size_t smem, cudaStream_t s,
                       const void* q, const void* k, const void* v,
                       const void* kpm, const void* dout, const float* ls,
                       const float* dl, void* dq, Geo g, Dropout dr) {
  return launch_rows(flash_dq_mma_kernel<CH, DMAX, KPM>, grid, threads,
                     smem, s, static_cast<const bf16*>(q),
                     static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                     static_cast<const float*>(kpm),
                     static_cast<const bf16*>(dout), ls, dl,
                     static_cast<bf16*>(dq), g, dr);
}

using DqMma = decltype(&run_dq_mma<16, 64, false>);

// the tensor-core instantiation of a key tile's chunk, head dim and key
// mask (the bad_shape checks passed: D <= 128)
DqMma pick_dq_mma(int bk, int D, bool kpm) {
  const bool c16 = dq_chunk(bk) == 16, wide = D > 64;
  return c16 ? (wide ? (kpm ? run_dq_mma<16, 128, true>
                            : run_dq_mma<16, 128, false>)
                     : (kpm ? run_dq_mma<16, 64, true>
                            : run_dq_mma<16, 64, false>))
             : (wide ? (kpm ? run_dq_mma<32, 128, true>
                            : run_dq_mma<32, 128, false>)
                     : (kpm ? run_dq_mma<32, 64, true>
                            : run_dq_mma<32, 64, false>));
}

template <bool KPM>
cudaError_t run_dkv(dim3 grid, size_t smem, cudaStream_t s, const void* q,
                    const void* k, const void* v, const void* kpm,
                    const void* dout, const float* ls, const float* dl,
                    void* dk, void* dv, Geo g, Dropout dr) {
  return launch(flash_dkv_kernel<KPM>, grid, smem, s,
                static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v), static_cast<const float*>(kpm),
                static_cast<const float*>(dout), ls, dl,
                static_cast<float*>(dk), static_cast<float*>(dv), g, dr);
}

template <int CH, int DMAX, bool KPM>
cudaError_t run_dkv_mma(dim3 grid, int threads, size_t smem,
                        cudaStream_t s, const void* q, const void* k,
                        const void* v, const void* kpm, const void* dout,
                        const float* ls, const float* dl, void* dk, void* dv,
                        Geo g, Dropout dr, int fp32_out) {
  return launch_rows(flash_dkv_mma_kernel<CH, DMAX, KPM>, grid, threads,
                     smem, s, static_cast<const bf16*>(q),
                     static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                     static_cast<const float*>(kpm),
                     static_cast<const bf16*>(dout), ls, dl, dk, dv, g, dr,
                     fp32_out);
}

using DkvMma = decltype(&run_dkv_mma<16, 64, false>);

// the tensor-core instantiation of a query tile's chunk, head dim and key
// mask (the bad_shape checks passed: D <= 128)
DkvMma pick_dkv_mma(int bq, int D, bool kpm) {
  const bool c16 = dkv_chunk(bq) == 16, wide = D > 64;
  return c16 ? (wide ? (kpm ? run_dkv_mma<16, 128, true>
                            : run_dkv_mma<16, 128, false>)
                     : (kpm ? run_dkv_mma<16, 64, true>
                            : run_dkv_mma<16, 64, false>))
             : (wide ? (kpm ? run_dkv_mma<32, 128, true>
                            : run_dkv_mma<32, 128, false>)
                     : (kpm ? run_dkv_mma<32, 64, true>
                            : run_dkv_mma<32, 64, false>));
}
}  // namespace

// dtype: 0 = float32, 1 = bfloat16. kpm: the (B, Sk) fp32 additive key
// mask, or null for none. block_q, block_k: the walk's tile (16, 32, 64
// or 128 each). Each entry point returns the CUDA error of its launch (0
// on success); it launches on `stream` and does not synchronise. Each
// runs bf16 on its tensor-core body (q, k, v, do and the outputs 16-byte
// aligned, kpm 8: else cudaErrorInvalidValue) and fp32 on its CUDA-core
// body.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         const void* kpm, void* o, void* lse, int dtype,
                         int bh, int heads, int kv_heads, int seq_q,
                         int seq_k, int head_dim, int block_q, int block_k,
                         int causal, float sm_scale, int dropout,
                         unsigned keep_thresh, float inv_keep, int seed,
                         void* stream) {
  if (bad_shape(bh, heads, kv_heads, seq_q, seq_k, head_dim, block_q,
                block_k))
    return (int)cudaErrorInvalidValue;
  const Geo g{heads, kv_heads, seq_q, seq_k, head_dim,
              block_q, block_k, causal != 0, sm_scale};
  const Dropout dr = make_dropout(dropout, keep_thresh, inv_keep, seed);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool has_kpm = kpm != nullptr;
  if (dtype == 1) {           // bf16: the tensor-core body, or an error
    if (fwd_misaligned(q, k, v, o, kpm)) return (int)cudaErrorInvalidValue;
    const int R = mma_rows(block_q);
    auto run = head_dim <= 64 ? pick_fwd_mma<64>(block_k, has_kpm)
                              : pick_fwd_mma<128>(block_k, has_kpm);
    return (int)run(dim3(seq_q / R, bh), 2 * R,
                    mma_fwd_smem(R, block_k, head_dim), s, q, k, v, kpm, o,
                    lse, g, dr);
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  const int R = rows_of(block_q), C = rows_of(block_k);  // fp32: CUDA cores
  return (int)(has_kpm ? run_fwd<float, true> : run_fwd<float, false>)(
      dim3(seq_q / R, bh), fwd_smem(R, C, head_dim, block_k), s, q, k, v,
      kpm, o, lse, g, dr);
}

extern "C" int flash_dq(const void* q, const void* k, const void* v,
                        const void* kpm, const void* dout, const void* lse,
                        const void* delta, void* dq, int dtype, int bh,
                        int heads, int kv_heads, int seq_q, int seq_k,
                        int head_dim, int block_q, int block_k, int causal,
                        float sm_scale, int dropout, unsigned keep_thresh,
                        float inv_keep, int seed, void* stream) {
  if (bad_shape(bh, heads, kv_heads, seq_q, seq_k, head_dim, block_q,
                block_k))
    return (int)cudaErrorInvalidValue;
  const Geo g{heads, kv_heads, seq_q, seq_k, head_dim,
              block_q, block_k, causal != 0, sm_scale};
  const Dropout dr = make_dropout(dropout, keep_thresh, inv_keep, seed);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ls = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const bool has_kpm = kpm != nullptr;
  if (dtype == 1) {           // bf16: the tensor-core body, or an error
    // one output: dq stands for both of dk/dv's
    if (dkv_misaligned(q, k, v, dout, dq, dq, kpm))
      return (int)cudaErrorInvalidValue;
    const int R = mma_rows(block_q);
    return (int)pick_dq_mma(block_k, head_dim, has_kpm)(
        dim3(seq_q / R, bh), 2 * R, mma_dq_smem(R, block_k, head_dim), s, q,
        k, v, kpm, dout, ls, dl, dq, g, dr);
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  const int R = rows_of(block_q), C = rows_of(block_k);  // fp32: CUDA cores
  return (int)(has_kpm ? run_dq<true> : run_dq<false>)(
      dim3(seq_q / R, bh), dq_smem(R, C, head_dim), s, q, k, v, kpm, dout,
      ls, dl, dq, g, dr);
}

// fp32_out: 1 writes dk, dv as fp32 per-q-head partials (GQA), 0 in the
// input dtype. Both are (B*H, Sk, D).
extern "C" int flash_dkv(const void* q, const void* k, const void* v,
                         const void* kpm, const void* dout, const void* lse,
                         const void* delta, void* dk, void* dv, int dtype,
                         int fp32_out, int bh, int heads, int kv_heads,
                         int seq_q, int seq_k, int head_dim, int block_q,
                         int block_k, int causal, float sm_scale,
                         int dropout, unsigned keep_thresh, float inv_keep,
                         int seed, void* stream) {
  if (bad_shape(bh, heads, kv_heads, seq_q, seq_k, head_dim, block_q,
                block_k))
    return (int)cudaErrorInvalidValue;
  const Geo g{heads, kv_heads, seq_q, seq_k, head_dim,
              block_q, block_k, causal != 0, sm_scale};
  const Dropout dr = make_dropout(dropout, keep_thresh, inv_keep, seed);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ls = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const bool has_kpm = kpm != nullptr;
  if (dtype == 1) {           // bf16: the tensor-core body, or an error
    if (dkv_misaligned(q, k, v, dout, dk, dv, kpm))
      return (int)cudaErrorInvalidValue;
    const int R = mma_rows(block_k);
    return (int)pick_dkv_mma(block_q, head_dim, has_kpm)(
        dim3(seq_k / R, bh), 2 * R, mma_dkv_smem(R, block_q, head_dim), s,
        q, k, v, kpm, dout, ls, dl, dk, dv, g, dr, fp32_out != 0);
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  const int R = rows_of(block_k), C = rows_of(block_q);  // fp32: CUDA cores
  return (int)(has_kpm ? run_dkv<true> : run_dkv<false>)(
      dim3(seq_k / R, bh), dkv_smem(R, C, head_dim), s, q, k, v, kpm, dout,
      ls, dl, dk, dv, g, dr);
}
