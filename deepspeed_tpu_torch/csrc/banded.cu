// Banded block-sparse attention, forward and backward, for Hopper.
//
// Replaces the three Pallas TPU kernels of
// deepspeed_tpu/ops/sparse_attention/banded.py (one body each, shared by
// every instance of build_banded_impls):
//   K11 _fwd_body -> banded_fwd : o, lse  (a q tile walks kv tiles)
//   K12 _dq_body  -> banded_dq  : dq      (the same walk)
//   K13 _dkv_body -> banded_dkv : dk, dv  (a kv tile walks q tiles)
// Same function as the Pallas kernels:
//   q, k, v (B*H, S, D) in fp32 or bf16; walk tiles (bq, bkv); a layout of
//   fine blocks fb whose kept cells are, on block indices rb = row / fb,
//   cb = col / fb, the predicate (rb < g_r) | (cb < g_c) | (|rb - cb| <= w)
//   [& cb <= rb when causal], cut into instances whose cells partition it:
//     walk "row" (K11, K12): kind 0 "band" (GT global-column steps, then
//     the band steps over [start[i], end[i]]), kind 1 "gr" (the global
//     rows, every kv tile);
//     walk "col" (K13): kind 0 "band" (q tiles [start[t], end[t]]), kind 2
//     "gc" (global columns from q tile q0 on), kind 1 "gr" (the global
//     rows' q tiles);
//   optionally an additive fp32 key mask kpm (B, S) (null: none).
// Semantics kept exactly: s = (q.k) * sm_scale, then s += kpm[b, key]
// (skipped without a key mask: JAX adds zeros), then s = NEG_INF where
// the predicate drops the cell; p = 0 where s <= VALID_THRESH (-1e28).
// The forward's online softmax runs per walk step over the whole tile
// with no m_safe guard; a row with l == 0 writes o = 0 and lse = m. K12
// and K13 recompute p = exp(s - lse) from the instance's lse. p is
// rounded to V's (K13: do's) dtype before its product, ds = p * (dp -
// delta) to K's (K13: q's) dtype; every sum accumulates in fp32. dq and dk
// are scaled by sm_scale once at the end, dv is not. The scale multiply is
// rounded on its own (__fmul_rn), never fused with the key mask's add, as
// in JAX. The kernels read no mask bytes: the predicate is evaluated on
// block indices in registers.
//
// Skipping. A step whose walked tile keeps no cell of a CTA's rows, and
// inside a step a chunk of keys (K13: of queries) that keeps none, is not
// computed: with every s at NEG_INF the running max stays, alpha is
// exactly 1 and p is 0, so the skip changes no bit. That covers JAX's
// clamped repeat steps past end[i], which keep nothing. The forward
// rescales its accumulator by alpha once per step, in the first chunk it
// computes, as the product of a skipped chunk would add exactly 0.
//
// What bounds it on an H100: operations. At the s8k geometry (B 1, H 16,
// S 8192, D 64, BSLongformer block 128, window 3) a walked 128 x 128 tile
// does 2-4 products of 128 x 128 x 64. This first version is the simple
// design of masked_flash.cu and blocksparse_v2.cu (flash_tiles.cuh): fp32
// FMAs on the CUDA cores, no tensor cores. A CTA of 128 threads owns R =
// min(bq, 32) query rows of a q tile (K11, K12) or R = min(bkv, 32) key
// rows of a kv tile (K13); it stages its own rows once and each walked
// tile's partner rows in chunks of min(tile, 32) into shared memory as
// fp32, and keeps the softmax state and the accumulators in shared
// memory. The Pallas grid's sequential walk axis becomes a loop inside
// the CTA. Later work: mma/wgmma, cp.async/TMA staging.
//
// Built by deepspeed_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// into a library with a plain C interface, loaded through ctypes.

#include <stdint.h>

#include "flash_tiles.cuh"

namespace {

constexpr float kValidThresh = -1e28f;  // banded.VALID_THRESH

enum Pred { kNone, kBandCells, kGlobalCols, kGlobalRows };
enum Kind { kBand = 0, kGlobalRowsInst = 1, kGlobalColsInst = 2 };

struct Geo {
  int H, S, D;
  int bq, bkv, fb;          // walk tiles, fine block
  int g_r, g_c, w, causal;  // the band
  int kind, steps;          // instance kind and its walk steps per tile
  int gt, q0;               // GT (row band), gc_q0 (col gc)
  int lse_rows;             // rows per (b, h) of the lse read (K12, K13)
  float sm_scale;
};

// whether the cell of block indices (rb, cb) is kept under predicate p
__device__ __forceinline__ bool keep(Pred p, int rb, int cb, const Geo& g) {
  bool k;
  if (p == kBandCells)
    k = rb >= g.g_r && cb >= g.g_c && rb - cb <= g.w &&
        cb - rb <= (g.causal ? 0 : g.w);
  else if (p == kGlobalCols)
    k = rb >= g.g_r && cb < g.g_c;
  else if (p == kGlobalRows)
    k = rb < g.g_r;
  else
    k = false;
  return k && (!g.causal || cb <= rb);
}

struct Step {
  int partner;  // the walked tile: a kv tile (row walk) or a q tile (col)
  Pred pred;
};

// step j of tile i of the row walk (JAX's band_kt / gr_kt, band_keep /
// gr_keep)
__device__ __forceinline__ Step row_step(const Geo& g, const int32_t* start,
                                         const int32_t* end, int i, int j) {
  if (g.kind == kGlobalRowsInst) return {j, kGlobalRows};
  if (g.gt && j < g.gt) return {j, kGlobalCols};
  const int s = start[i] + (j - g.gt);
  return {min(s, end[i]), s <= end[i] ? kBandCells : kNone};
}

// step j of tile t of the column walk (band_qt, gc_qt, gr_dkv_qt)
__device__ __forceinline__ Step col_step(const Geo& g, const int32_t* start,
                                         const int32_t* end, int t, int j) {
  if (g.kind == kGlobalRowsInst) return {j, kGlobalRows};
  if (g.kind == kGlobalColsInst) return {g.q0 + j, kGlobalCols};
  const int s = start[t] + j;
  return {min(s, end[t]), s <= end[t] ? kBandCells : kNone};
}

// live[c] for the nch chunks of a walked tile: chunk c covers rows
// [r0 + c * rstep, + nr) and columns [c0 + c * cstep, + nc); whether any of
// its cells is kept. Returns whether any chunk is (uniform over the CTA).
// The first barrier lets every thread finish reading the last step's
// flags before they are cleared.
__device__ bool mark_live(int* live, Pred p, int r0, int nr, int rstep,
                          int c0, int nc, int cstep, int nch, const Geo& g) {
  __syncthreads();
  for (int c = threadIdx.x; c < nch; c += blockDim.x) live[c] = 0;
  __syncthreads();
  if (p != kNone) {
    const int nrb = (nr - 1) / g.fb + 2;   // fine blocks a chunk may touch
    const int ncb = (nc - 1) / g.fb + 2;
    for (int e = threadIdx.x; e < nch * nrb * ncb; e += blockDim.x) {
      const int c = e / (nrb * ncb);
      const int rr = e / ncb - c * nrb;
      const int cc = e - (c * nrb + rr) * ncb;
      const int lo_r = r0 + c * rstep, lo_c = c0 + c * cstep;
      const int rb = lo_r / g.fb + rr, cb = lo_c / g.fb + cc;
      if (rb <= (lo_r + nr - 1) / g.fb && cb <= (lo_c + nc - 1) / g.fb &&
          keep(p, rb, cb, g))
        live[c] = 1;
    }
  }
  __syncthreads();
  int any = 0;
  for (int c = 0; c < nch; ++c) any |= live[c];
  return any != 0;
}

// ------------------------------------------------------------------ K11
// grid (tiles * bq / R, B*H); R = min(bq, 32) q rows per CTA, keys in
// chunks of C = min(bkv, 32).
template <typename T>
__global__ void __launch_bounds__(kThreads)
banded_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ kpm,
                  T* __restrict__ o, float* __restrict__ lse,
                  const int32_t* __restrict__ start,
                  const int32_t* __restrict__ end, Geo g) {
  extern __shared__ float smem[];
  const int D = g.D, bkv = g.bkv;
  const int R = rows_of(g.bq);
  const int C = rows_of(bkv);
  const int nch = bkv / C;
  const int bh = blockIdx.y;
  const int b = bh / g.H;
  const int r0 = blockIdx.x * R;
  const int i = r0 / g.bq;
  const int out_rows = gridDim.x * R;
  const T* kg = k + (size_t)bh * g.S * D;
  const T* vg = v + (size_t)bh * g.S * D;
  const float* kpm_b = kpm ? kpm + (size_t)b * g.S : nullptr;

  float* qs = smem;                       // R x (D+1)
  float* ss = qs + R * (D + 1);           // R x bkv: s, then p
  float* os = ss + R * bkv;               // R x D accumulator
  float* kv = os + R * D;                 // C x (D+1) staged K or V rows
  float* m_s = kv + C * (D + 1);          // R
  float* l_s = m_s + R;                   // R
  float* a_s = l_s + R;                   // R: this step's alpha
  int* live = reinterpret_cast<int*>(a_s + R);   // nch

  stage_rows(qs, q + ((size_t)bh * g.S + r0) * D, R, D);
  fill(os, R * D, 0.f);
  fill(m_s, R, kNegInf);
  fill(l_s, R, 0.f);
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int j = 0; j < g.steps; ++j) {
    const Step st = row_step(g, start, end, i, j);
    const int k0 = st.partner * bkv;
    if (!mark_live(live, st.pred, r0, R, 0, k0, C, C, nch, g)) continue;
    // s = q . k over the live chunks of the walked tile
    for (int c = 0; c < nch; ++c) {
      if (!live[c]) continue;
      stage_rows(kv, kg + (size_t)(k0 + c * C) * D, C, D);
      __syncthreads();
      mm(ss + c * C, bkv, false, nullptr, qs, D + 1, 1, kv, 1, D + 1, R, C,
         D);
      __syncthreads();
    }
    // online softmax of the tile: warp w owns rows w, w + 4, ...
    for (int r = warp; r < R; r += kWarps) {
      const int rb = (r0 + r) / g.fb;
      float sv[kMaxBlk / 32];
      float mx = kNegInf;
#pragma unroll
      for (int u = 0; u < kMaxBlk / 32; ++u) {
        const int c = lane + 32 * u;
        float s = kNegInf;
        if (c < bkv && keep(st.pred, rb, (k0 + c) / g.fb, g)) {
          s = __fmul_rn(ss[r * bkv + c], g.sm_scale);
          if (kpm_b) s += kpm_b[k0 + c];
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
        if (c < bkv) {
          const float p = sv[u] > kValidThresh ? expf(sv[u] - m_new) : 0.f;
          sum += p;
          ss[r * bkv + c] = round_to<T>(p);
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
    // acc = acc * alpha + p . v, alpha with the first live chunk's product
    bool first = true;
    for (int c = 0; c < nch; ++c) {
      if (!live[c]) continue;
      stage_rows(kv, vg + (size_t)(k0 + c * C) * D, C, D);
      __syncthreads();
      mm(os, D, true, first ? a_s : nullptr, ss + c * C, bkv, 1, kv, D + 1,
         1, R, D, C);
      first = false;
      __syncthreads();
    }
  }

  T* og = o + ((size_t)bh * out_rows + r0) * D;
  for (int e = threadIdx.x; e < R * D; e += blockDim.x) {
    const float l = l_s[e / D];
    og[e] = from_f<T>(os[e] / (l == 0.f ? 1.f : l));
  }
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    const float l = l_s[r];
    lse[(size_t)bh * out_rows + r0 + r] = m_s[r] + logf(l == 0.f ? 1.f : l);
  }
}

// ------------------------------------------------------------------ K12
// grid (tiles * bq / R, B*H); per walk step, chunk by chunk of C keys.
template <typename T>
__global__ void __launch_bounds__(kThreads)
banded_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 const float* __restrict__ kpm, T* __restrict__ dq,
                 const int32_t* __restrict__ start,
                 const int32_t* __restrict__ end, Geo g) {
  extern __shared__ float smem[];
  const int D = g.D, bkv = g.bkv;
  const int R = rows_of(g.bq);
  const int C = rows_of(bkv);
  const int nch = bkv / C;
  const int bh = blockIdx.y;
  const int b = bh / g.H;
  const int r0 = blockIdx.x * R;
  const int i = r0 / g.bq;
  const int out_rows = gridDim.x * R;
  const T* kg = k + (size_t)bh * g.S * D;
  const T* vg = v + (size_t)bh * g.S * D;
  const float* kpm_b = kpm ? kpm + (size_t)b * g.S : nullptr;
  const size_t row0 = (size_t)bh * g.S + r0;

  float* qs = smem;                 // R x (D+1)
  float* dos = qs + R * (D + 1);    // R x (D+1)
  float* ks = dos + R * (D + 1);    // C x (D+1)
  float* vs = ks + C * (D + 1);     // C x (D+1)
  float* ps = vs + C * (D + 1);     // R x C: s, then ds
  float* dps = ps + R * C;          // R x C: dp
  float* dqs = dps + R * C;         // R x D accumulator
  float* lse_s = dqs + R * D;       // R
  float* dl_s = lse_s + R;          // R
  int* live = reinterpret_cast<int*>(dl_s + R);  // nch

  stage_rows(qs, q + row0 * D, R, D);
  stage_rows(dos, dout + row0 * D, R, D);
  fill(dqs, R * D, 0.f);
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    lse_s[r] = lse[(size_t)bh * g.lse_rows + r0 + r];
    dl_s[r] = delta[row0 + r];
  }
  __syncthreads();

  for (int j = 0; j < g.steps; ++j) {
    const Step st = row_step(g, start, end, i, j);
    const int k0 = st.partner * bkv;
    if (!mark_live(live, st.pred, r0, R, 0, k0, C, C, nch, g)) continue;
    for (int c = 0; c < nch; ++c) {
      if (!live[c]) continue;
      const int kc = k0 + c * C;
      stage_rows(ks, kg + (size_t)kc * D, C, D);
      stage_rows(vs, vg + (size_t)kc * D, C, D);
      __syncthreads();
      mm(ps, C, false, nullptr, qs, D + 1, 1, ks, 1, D + 1, R, C, D);
      mm(dps, C, false, nullptr, dos, D + 1, 1, vs, 1, D + 1, R, C, D);
      __syncthreads();
      for (int e = threadIdx.x; e < R * C; e += blockDim.x) {
        const int r = e / C;
        const int cc = e - r * C;
        float p = 0.f;
        if (keep(st.pred, (r0 + r) / g.fb, (kc + cc) / g.fb, g)) {
          float s = __fmul_rn(ps[e], g.sm_scale);
          if (kpm_b) s += kpm_b[kc + cc];
          p = s > kValidThresh ? expf(s - lse_s[r]) : 0.f;
        }
        ps[e] = round_to<T>(p * (dps[e] - dl_s[r]));
      }
      __syncthreads();
      mm(dqs, D, true, nullptr, ps, C, 1, ks, D + 1, 1, R, D, C);
      __syncthreads();
    }
  }

  T* dqg = dq + ((size_t)bh * out_rows + r0) * D;
  for (int e = threadIdx.x; e < R * D; e += blockDim.x)
    dqg[e] = from_f<T>(dqs[e] * g.sm_scale);
}

// ------------------------------------------------------------------ K13
// grid (tiles * bkv / R, B*H): R = min(bkv, 32) key rows of a kv tile per
// CTA; per walk step, chunk by chunk of C = min(bq, 32) query rows.
template <typename T>
__global__ void __launch_bounds__(kThreads)
banded_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  const float* __restrict__ kpm, T* __restrict__ dk,
                  T* __restrict__ dv, const int32_t* __restrict__ start,
                  const int32_t* __restrict__ end, Geo g) {
  extern __shared__ float smem[];
  const int D = g.D, bq = g.bq;
  const int R = rows_of(g.bkv);
  const int C = rows_of(bq);
  const int nch = bq / C;
  const int bh = blockIdx.y;
  const int b = bh / g.H;
  const int kr0 = blockIdx.x * R;
  const int t = kr0 / g.bkv;
  const int out_rows = gridDim.x * R;
  const T* qg = q + (size_t)bh * g.S * D;
  const T* dog = dout + (size_t)bh * g.S * D;

  float* ks = smem;                 // R x (D+1)
  float* vs = ks + R * (D + 1);     // R x (D+1)
  float* qs = vs + R * (D + 1);     // C x (D+1)
  float* dos = qs + C * (D + 1);    // C x (D+1)
  float* ps = dos + C * (D + 1);    // C(q) x R(k): s, then p rounded
  float* dps = ps + C * R;          // C(q) x R(k): dp, then ds
  float* dks = dps + C * R;         // R x D
  float* dvs = dks + R * D;         // R x D
  float* lse_s = dvs + R * D;       // C
  float* dl_s = lse_s + C;          // C
  float* km_s = dl_s + C;           // R: this CTA's key mask (0 without)
  int* live = reinterpret_cast<int*>(km_s + R);  // nch

  stage_rows(ks, k + ((size_t)bh * g.S + kr0) * D, R, D);
  stage_rows(vs, v + ((size_t)bh * g.S + kr0) * D, R, D);
  fill(dks, R * D, 0.f);
  fill(dvs, R * D, 0.f);
  for (int c = threadIdx.x; c < R; c += blockDim.x)
    km_s[c] = kpm ? kpm[(size_t)b * g.S + kr0 + c] : 0.f;
  __syncthreads();

  for (int j = 0; j < g.steps; ++j) {
    const Step st = col_step(g, start, end, t, j);
    const int q0 = st.partner * bq;
    if (!mark_live(live, st.pred, q0, C, C, kr0, R, 0, nch, g)) continue;
    for (int c = 0; c < nch; ++c) {
      if (!live[c]) continue;
      const int qc = q0 + c * C;
      stage_rows(qs, qg + (size_t)qc * D, C, D);
      stage_rows(dos, dog + (size_t)qc * D, C, D);
      for (int r = threadIdx.x; r < C; r += blockDim.x) {
        lse_s[r] = lse[(size_t)bh * g.lse_rows + qc + r];
        dl_s[r] = delta[(size_t)bh * g.S + qc + r];
      }
      __syncthreads();
      mm(ps, R, false, nullptr, qs, D + 1, 1, ks, 1, D + 1, C, R, D);
      mm(dps, R, false, nullptr, dos, D + 1, 1, vs, 1, D + 1, C, R, D);
      __syncthreads();
      for (int e = threadIdx.x; e < C * R; e += blockDim.x) {
        const int r = e / R;            // query row in the chunk
        const int cc = e - r * R;       // key row of this CTA
        float p = 0.f;
        if (keep(st.pred, (qc + r) / g.fb, (kr0 + cc) / g.fb, g)) {
          float s = __fmul_rn(ps[e], g.sm_scale);
          if (kpm) s += km_s[cc];
          p = s > kValidThresh ? expf(s - lse_s[r]) : 0.f;
        }
        ps[e] = round_to<T>(p);
        dps[e] = round_to<T>(p * (dps[e] - dl_s[r]));
      }
      __syncthreads();
      // dv += p^T . do ; dk += ds^T . q
      mm(dvs, D, true, nullptr, ps, 1, R, dos, D + 1, 1, R, D, C);
      mm(dks, D, true, nullptr, dps, 1, R, qs, D + 1, 1, R, D, C);
      __syncthreads();
    }
  }

  T* dkg = dk + ((size_t)bh * out_rows + kr0) * D;
  T* dvg = dv + ((size_t)bh * out_rows + kr0) * D;
  for (int e = threadIdx.x; e < R * D; e += blockDim.x) {
    dkg[e] = from_f<T>(dks[e] * g.sm_scale);
    dvg[e] = from_f<T>(dvs[e]);
  }
}

size_t fwd_smem(int R, int C, int D, int bkv) {
  return sizeof(float) * ((size_t)R * (D + 1) + (size_t)R * bkv +
                          (size_t)R * D + (size_t)C * (D + 1) + 3 * R) +
         sizeof(int) * (bkv / C);
}

size_t dq_smem(int R, int C, int D, int nch) {
  return sizeof(float) * ((size_t)2 * R * (D + 1) + (size_t)2 * C * (D + 1) +
                          (size_t)2 * R * C + (size_t)R * D + 2 * R) +
         sizeof(int) * nch;
}

size_t dkv_smem(int R, int C, int D, int nch) {
  return sizeof(float) * ((size_t)2 * R * (D + 1) + (size_t)2 * C * (D + 1) +
                          (size_t)2 * C * R + (size_t)2 * R * D + 2 * C + R) +
         sizeof(int) * nch;
}

bool tile_ok(int b) { return b == 16 || b == 32 || b == 64 || b == 128; }

// the geometry of one launch, or a refusal; `tile` is the instance's
// output tile (bq for the row walk, bkv for the column walk)
bool bad_geo(int bh, const Geo& g, int tiles, int tile) {
  return bh <= 0 || bh > 65535 || g.H <= 0 || bh % g.H != 0 || g.D <= 0 ||
         g.D > kMaxHd || g.D % 8 != 0 || !tile_ok(g.bq) || !tile_ok(g.bkv) ||
         g.S <= 0 || g.S % g.bq != 0 || g.S % g.bkv != 0 || g.fb <= 0 ||
         tiles <= 0 || tiles * tile > g.S || g.steps < 0 || g.lse_rows <= 0 ||
         g.lse_rows > g.S || g.kind < 0 || g.kind > 2;
}

Geo make_geo(int heads, int seq, int head_dim, int bq, int bkv, int fb,
             int g_r, int g_c, int w, int causal, int kind, int steps, int gt,
             int q0, int lse_rows, float sm_scale) {
  return Geo{heads, seq, head_dim, bq, bkv, fb, g_r, g_c, w, causal != 0,
             kind, steps, gt, q0, lse_rows, sm_scale};
}

}  // namespace

#define GEO_ARGS                                                            \
  int dtype, int bh, int heads, int seq, int head_dim, int bq, int bkv,     \
      int fb, int g_r, int g_c, int w, int causal, int kind, int tiles,     \
      int steps, int gt, int q0, int lse_rows, float sm_scale, void* stream
#define GEO                                                                  \
  make_geo(heads, seq, head_dim, bq, bkv, fb, g_r, g_c, w, causal, kind,     \
           steps, gt, q0, lse_rows, sm_scale)

// dtype: 0 = float32, 1 = bfloat16. kpm: the (B, S) fp32 additive key
// mask, or null for none. start, end: the band instance's int32 walk
// bounds per tile (read only by kind 0). tiles: the instance's output
// tiles (q tiles for banded_fwd and banded_dq, kv tiles for banded_dkv);
// the outputs hold tiles * bq (tiles * bkv) rows per (b, h). lse_rows:
// the rows per (b, h) of the lse that banded_dq and banded_dkv read.
// Each entry point returns the CUDA error of its launch (0 on success);
// it launches on `stream` and does not synchronise.
extern "C" int banded_fwd(const void* q, const void* k, const void* v,
                          const void* kpm, void* o, void* lse,
                          const void* start, const void* end, GEO_ARGS) {
  const Geo g = GEO;
  if (bad_geo(bh, g, tiles, bq)) return (int)cudaErrorInvalidValue;
  const int R = rows_of(bq), C = rows_of(bkv);
  const dim3 grid(tiles * bq / R, bh);
  const size_t smem = fwd_smem(R, C, head_dim, bkv);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* kp = static_cast<const float*>(kpm);
  const auto* st = static_cast<const int32_t*>(start);
  const auto* en = static_cast<const int32_t*>(end);
  if (dtype == 0)
    return (int)launch(banded_fwd_kernel<float>, grid, smem, s,
                       static_cast<const float*>(q),
                       static_cast<const float*>(k),
                       static_cast<const float*>(v), kp,
                       static_cast<float*>(o), static_cast<float*>(lse), st,
                       en, g);
  if (dtype == 1)
    return (int)launch(banded_fwd_kernel<__nv_bfloat16>, grid, smem, s,
                       static_cast<const __nv_bfloat16*>(q),
                       static_cast<const __nv_bfloat16*>(k),
                       static_cast<const __nv_bfloat16*>(v), kp,
                       static_cast<__nv_bfloat16*>(o),
                       static_cast<float*>(lse), st, en, g);
  return (int)cudaErrorInvalidValue;
}

extern "C" int banded_dq(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta,
                         const void* kpm, void* dq, const void* start,
                         const void* end, GEO_ARGS) {
  const Geo g = GEO;
  if (bad_geo(bh, g, tiles, bq)) return (int)cudaErrorInvalidValue;
  const int R = rows_of(bq), C = rows_of(bkv);
  const dim3 grid(tiles * bq / R, bh);
  const size_t smem = dq_smem(R, C, head_dim, bkv / C);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* ls = static_cast<const float*>(lse);
  const auto* dl = static_cast<const float*>(delta);
  const auto* kp = static_cast<const float*>(kpm);
  const auto* st = static_cast<const int32_t*>(start);
  const auto* en = static_cast<const int32_t*>(end);
  if (dtype == 0)
    return (int)launch(banded_dq_kernel<float>, grid, smem, s,
                       static_cast<const float*>(q),
                       static_cast<const float*>(k),
                       static_cast<const float*>(v),
                       static_cast<const float*>(dout), ls, dl, kp,
                       static_cast<float*>(dq), st, en, g);
  if (dtype == 1)
    return (int)launch(banded_dq_kernel<__nv_bfloat16>, grid, smem, s,
                       static_cast<const __nv_bfloat16*>(q),
                       static_cast<const __nv_bfloat16*>(k),
                       static_cast<const __nv_bfloat16*>(v),
                       static_cast<const __nv_bfloat16*>(dout), ls, dl, kp,
                       static_cast<__nv_bfloat16*>(dq), st, en, g);
  return (int)cudaErrorInvalidValue;
}

extern "C" int banded_dkv(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse,
                          const void* delta, const void* kpm, void* dk,
                          void* dv, const void* start, const void* end,
                          GEO_ARGS) {
  const Geo g = GEO;
  if (bad_geo(bh, g, tiles, bkv)) return (int)cudaErrorInvalidValue;
  const int R = rows_of(bkv), C = rows_of(bq);
  const dim3 grid(tiles * bkv / R, bh);
  const size_t smem = dkv_smem(R, C, head_dim, bq / C);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* ls = static_cast<const float*>(lse);
  const auto* dl = static_cast<const float*>(delta);
  const auto* kp = static_cast<const float*>(kpm);
  const auto* st = static_cast<const int32_t*>(start);
  const auto* en = static_cast<const int32_t*>(end);
  if (dtype == 0)
    return (int)launch(banded_dkv_kernel<float>, grid, smem, s,
                       static_cast<const float*>(q),
                       static_cast<const float*>(k),
                       static_cast<const float*>(v),
                       static_cast<const float*>(dout), ls, dl, kp,
                       static_cast<float*>(dk), static_cast<float*>(dv), st,
                       en, g);
  if (dtype == 1)
    return (int)launch(banded_dkv_kernel<__nv_bfloat16>, grid, smem, s,
                       static_cast<const __nv_bfloat16*>(q),
                       static_cast<const __nv_bfloat16*>(k),
                       static_cast<const __nv_bfloat16*>(v),
                       static_cast<const __nv_bfloat16*>(dout), ls, dl, kp,
                       static_cast<__nv_bfloat16*>(dk),
                       static_cast<__nv_bfloat16*>(dv), st, en, g);
  return (int)cudaErrorInvalidValue;
}
