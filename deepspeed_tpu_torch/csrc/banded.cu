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
// does 2-4 products of 128 x 128 x 64.
//
// K11 in bf16 runs K1's tensor-core forward body (mma_fwd.cuh, mma.sync,
// BandedRule: the -1e28 threshold, lse = m where l == 0): a CTA owns R =
// min(bq, 64) rows of a q tile, 16 per warp, and walks its instance's
// steps (BandedWalk: the band instance's GT global-column steps, then
// min(start[i] + j - GT, end[i]); the gr instance's kv tiles). Each
// step's predicate rides in the walked tile's kind bits (kKindBand | pred
// << kPredShift), and BandedKeep evaluates it on block indices in
// registers, per cell and per rectangle (the body skips a tile, and a
// warp's 16-key group, that keeps nothing, as the CUDA-core body skips a
// chunk); a repeat step clamped past end[i] keeps nothing. The score
// order is K1's key-mask order (s * sm_scale, + kpm, then the
// predicate), so the body's rounding repair sees the plain version's
// roundings.
//
// The global-rows walk split over the keys (bf16). At s8k the gr instance
// is one q tile of 128 rows per (b, h) walking all 64 kv tiles: 32 CTAs of
// 64 rows on 132 SMs, each walking 8192 keys in series. Its grid gets a
// third axis, the splits of kv_tiles_per_split kv tiles
// (banded.gr_split_plan, from the shapes alone). Each CTA walks its
// split from a fresh state and writes its fp32 partial (the unnormalised
// accumulator, m and l) to a workspace, counts its arrival on its row
// block's int32 counter, and the CTA that arrives last merges the row
// block's splits in split order (m = max m_z, l = sum l_z e^(m_z - m),
// acc = sum acc_z e^(m_z - m), each product and sum rounded on its own),
// writes o = acc / l in bf16 and lse = m + log l, and sets the counter
// back to 0. No float atomics and a fixed order: the bits do not change
// from run to run. A split that keeps nothing has m = NEG_INF and l = 0,
// so an empty row still writes o = 0 and lse = m. p rounds to bf16 under
// its split's running max, not the whole walk's: the split plain version
// (banded_fwd_plain(kv_tiles_per_split=...)) walks alike. With one split
// the CTA writes o and lse itself, as the one walk.
//
// K12 and K13 in bf16 run K2's dq and K3's dk/dv tensor-core bodies
// (mma_dq.cuh, mma_dkv.cuh; BandedRule) over the same walks: K12 over
// BandedWalk (a CTA of min(bq, 64) q rows), K13 over BandedColWalk (a CTA
// of min(bkv, 64) key rows walking q tiles: col_step's steps, the
// predicate in the kind bits), both with BandedKeep. The score order is
// K2's and K3's key-mask order, so the bodies' rounding repair of ds (and
// of K13's p) sees the plain versions' roundings. Their serial walks
// split as K11's gr walk does: K12's gr instance over its kv tiles, K13's
// gc instance (one kv tile per (b, h) at s8k, walking 63 q tiles) over
// its q tiles (banded.fwd_split / dkv_split, from the shapes alone). Each
// CTA writes its split's fp32 sums (dq; dk and dv), unscaled, to a
// workspace; the last to arrive on its row block's counter adds them in
// split order from 0, scales dq and dk by sm_scale and rounds once to
// bf16. dq, dk and dv are sums with no running max, so the split moves
// only the fp32 order of a sum, never a bf16 rounding of p or ds; a split
// that keeps no cell writes zeros. The band instances and K13's gr
// instance walk one split.
//
// In fp32 the three keep the first design, that of masked_flash.cu and
// blocksparse_v2.cu (flash_tiles.cuh): fp32 FMAs on the CUDA cores, no
// tensor cores (TF32 would fail the fp32 checks). A CTA of 128 threads
// owns R = min(bq, 32) query rows of a q tile (K11, K12) or R = min(bkv,
// 32) key rows of a kv tile (K13); it stages its own rows once and each
// walked tile's partner rows in chunks of min(tile, 32) into shared
// memory as fp32, and keeps the softmax state and the accumulators in
// shared memory. The Pallas grid's sequential walk axis becomes a loop
// inside the CTA.
//
// Built by deepspeed_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// into a library with a plain C interface, loaded through ctypes.

#include <stdint.h>

#include "flash_tiles.cuh"
#include "mma_dq.cuh"

namespace {

// kValidThresh (mma_fwd.cuh, -1e28) is banded.VALID_THRESH too

enum Pred { kNone, kBandCells, kGlobalCols, kGlobalRows };
// a step's predicate in the tensor-core body's kind bits: kKindBand |
// pred << kPredShift
constexpr int kPredShift = 2;
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
__device__ __forceinline__ bool kept(Pred p, int rb, int cb, const Geo& g) {
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
          kept(p, rb, cb, g))
        live[c] = 1;
    }
  }
  __syncthreads();
  int any = 0;
  for (int c = 0; c < nch; ++c) any |= live[c];
  return any != 0;
}

// ------------------------------------------------------------------ K11
// fp32 (the CUDA-core body): grid (tiles * bq / R, B*H); R = min(bq, 32)
// q rows per CTA, keys in chunks of C = min(bkv, 32).
__global__ void __launch_bounds__(kThreads)
banded_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ kpm,
                  float* __restrict__ o, float* __restrict__ lse,
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
  const float* kg = k + (size_t)bh * g.S * D;
  const float* vg = v + (size_t)bh * g.S * D;
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
        if (c < bkv && kept(st.pred, rb, (k0 + c) / g.fb, g)) {
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
          ss[r * bkv + c] = p;
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

  float* og = o + ((size_t)bh * out_rows + r0) * D;
  for (int e = threadIdx.x; e < R * D; e += blockDim.x) {
    const float l = l_s[e / D];
    og[e] = os[e] / (l == 0.f ? 1.f : l);
  }
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    const float l = l_s[r];
    lse[(size_t)bh * out_rows + r0 + r] = m_s[r] + logf(l == 0.f ? 1.f : l);
  }
}

// K11 in bf16 on the tensor-core body. BandedKeep: the predicate of the
// walked step (its kind bits) on the fine blocks of a query and a key;
// any(): whether a rectangle of queries [qa, qb] x keys [ka, kb] keeps a
// cell, exactly (the body skips what keeps none).
struct BandedKeep {
  Geo g;
  int shift;  // log2(fb) where fb is a power of two, else -1

  __device__ __forceinline__ int blk(int x) const {
    return shift >= 0 ? x >> shift : x / g.fb;
  }
  __device__ __forceinline__ bool keep(int kind, int qi, int ki) const {
    return kept(Pred(kind >> kPredShift), blk(qi), blk(ki), g);
  }
  __device__ __forceinline__ bool any(int kind, int qa, int qb, int ka,
                                      int kb) const {
    const int r0 = blk(qa), r1 = blk(qb), c0 = blk(ka), c1 = blk(kb);
    switch (Pred(kind >> kPredShift)) {
      case kGlobalRows:
        return r0 < g.g_r && (!g.causal || c0 <= min(r1, g.g_r - 1));
      case kGlobalCols:
        return r1 >= g.g_r && c0 < g.g_c && (!g.causal || c0 <= r1);
      case kBandCells: {
        // rb - cb takes every value in [R0 - c1, r1 - C0]; kept ones lie
        // in [-(causal ? 0 : w), w]
        const int R0 = max(r0, g.g_r), C0 = max(c0, g.g_c);
        return R0 <= r1 && C0 <= c1 && R0 - c1 <= g.w &&
               C0 - r1 <= (g.causal ? 0 : g.w);
      }
      default:
        return false;
    }
  }
};

// the steps of one CTA's row walk: the band instance's (GT global-column
// steps, then the band steps over [start, end], clamped past it and
// keeping nothing there: row_step), or `count` kv tiles of the gr
// instance from `first` (one split)
struct BandedWalk {
  int gr, first, count, gt, start, end, bkv;
  __device__ __forceinline__ int n() const { return count; }
  __device__ __forceinline__ int keys() const { return bkv; }
  __device__ __forceinline__ int2 tile(int t) const {
    int part, pred;
    if (gr) {
      part = first + t;
      pred = kGlobalRows;
    } else if (t < gt) {
      part = t;
      pred = kGlobalCols;
    } else {
      const int s = start + (t - gt);
      part = min(s, end);
      pred = s <= end ? kBandCells : kNone;
    }
    return make_int2(part * bkv, kKindBand | pred << kPredShift);
  }
};

// The splits of a serial walk (K11's gr, K12's gr, K13's gc): each CTA
// writes its split's fp32 partial, then counts its arrival on its row
// block's int32 counter; the CTA that arrives last sees every split's
// partial, merges them in split order and sets the counter back to 0
// for the next launch (0 before the launch and after it).
__device__ __forceinline__ bool arrive_last(int* arrived, int splits) {
  __shared__ int last_s;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last_s = atomicAdd(arrived, 1) == splits - 1;
  __syncthreads();
  if (!last_s) return false;
  __threadfence();
  if (threadIdx.x == 0) *arrived = 0;
  return true;
}

// this lane's fragments of a CTA's accumulator (rows g and g + 8 of its
// warp's 16) as fp32 rows of stride D, the CTA's first at dst
template <int DMAX>
__device__ __forceinline__ void store_partial(float* dst,
                                              const float (&acc)[DMAX / 8][4],
                                              int D) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float* row = dst + (size_t)(warp * 16 + g + 8 * r) * D;
#pragma unroll
    for (int j = 0; j < DMAX / 8; ++j)
      if (8 * j < D)
        *reinterpret_cast<float2*>(row + 8 * j + 2 * tq) =
            make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
  }
}

// The last CTA's merge of a row block's sums (dq, dk, dv): out row lr =
// (the splits' partials of that row added in split order, from 0) *
// scale, rounded to bf16 once. part: split 0's first row of the CTA, rows
// of stride D; the splits lie `stride` floats apart. Two threads a row,
// each half of the head dim in fp32x4.
template <int DMAX>
__device__ __forceinline__ void merge_sums(const float* part, size_t stride,
                                           int splits, int D, float scale,
                                           bf16* out) {
  const int lr = threadIdx.x >> 1;
  const int half = D / 2;
  const int c0 = (threadIdx.x & 1) * half;
  float4 acc[DMAX / 8];
#pragma unroll
  for (int c = 0; c < DMAX / 8; ++c) acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int z = 0; z < splits; ++z) {
    const float4* src = reinterpret_cast<const float4*>(
        part + z * stride + (size_t)lr * D + c0);
#pragma unroll
    for (int c = 0; c < DMAX / 8; ++c) {
      if (4 * c < half) {
        const float4 x = __ldcg(src + c);
        acc[c].x = __fadd_rn(acc[c].x, x.x);
        acc[c].y = __fadd_rn(acc[c].y, x.y);
        acc[c].z = __fadd_rn(acc[c].z, x.z);
        acc[c].w = __fadd_rn(acc[c].w, x.w);
      }
    }
  }
  bf16* orow = out + (size_t)lr * D + c0;
#pragma unroll
  for (int c = 0; c < DMAX / 8; ++c) {
    if (4 * c < half) {
      auto* dst = reinterpret_cast<__nv_bfloat162*>(orow + 4 * c);
      dst[0] = __floats2bfloat162_rn(acc[c].x * scale, acc[c].y * scale);
      dst[1] = __floats2bfloat162_rn(acc[c].z * scale, acc[c].w * scale);
    }
  }
}

// grid (tiles * bq / R, B*H, splits), R = min(bq, 64) q rows per CTA, 16
// per warp; splits > 1 only for the gr instance, each of
// kv_tiles_per_split kv tiles (the last may hold fewer). ws: splits x B*H
// x rows x D fp32 partial accumulators, then splits x B*H x rows x (m, l);
// arrivals: B*H x (tiles * bq / R) int32, 0 before the launch and after.
template <int W, int DMAX, bool KPM>
__global__ void __launch_bounds__(2 * kMmaMaxRows,
                                  mma_fwd_min_ctas(W, DMAX, false))
banded_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const float* __restrict__ kpm, bf16* __restrict__ o,
                      float* __restrict__ lse,
                      const int32_t* __restrict__ start,
                      const int32_t* __restrict__ end, float* ws,
                      int* arrivals, Geo g, int shift, int kps) {
  const int R = blockDim.x / 2;
  const int D = g.D;
  const int bh = blockIdx.y;
  const int b = bh / g.H;
  const int r0 = blockIdx.x * R;
  const int i = r0 / g.bq;
  const int rows = gridDim.x * R;        // the instance's output rows
  const int split = blockIdx.z, splits = gridDim.z;
  BandedWalk walk{g.kind == kGlobalRowsInst, 0, g.steps, g.gt, 0, 0, g.bkv};
  if (walk.gr) {
    walk.first = split * kps;
    walk.count = min(kps, g.steps - walk.first);
  } else {
    walk.start = start[i];
    walk.end = end[i];
  }
  const size_t kv0 = (size_t)bh * g.S * D;
  const size_t out0 = (size_t)bh * rows + r0;
  const FwdRows a{q + (kv0 + (size_t)r0 * D), k + kv0, v + kv0,
                  KPM ? kpm + (size_t)b * g.S : nullptr, o + out0 * D,
                  lse + out0, r0, D, bh, g.sm_scale};
  FwdState<DMAX> st;
  mma_fwd_walk<W, DMAX, KPM, true, false, BandedRule>(
      a, walk, BandedKeep{g, shift}, Dropout{}, st);
  if (splits == 1) {
    mma_fwd_store<DMAX, BandedRule>(a, Dropout{}, st);
    return;
  }

  // this split's partial: rows of a slice of B*H x rows, this CTA's from
  // out0 on
  const size_t slice = (size_t)gridDim.y * rows;
  float* ws_ml = ws + (size_t)splits * slice * D;
  {
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const size_t row = split * slice + out0 + warp * 16 + gq + 8 * r;
      float* dst = ws + row * D;
#pragma unroll
      for (int j = 0; j < DMAX / 8; ++j)
        if (8 * j < D)
          *reinterpret_cast<float2*>(dst + 8 * j + 2 * tq) =
              make_float2(st.acc[j][2 * r], st.acc[j][2 * r + 1]);
      if (tq == 0)
        *reinterpret_cast<float2*>(ws_ml + row * 2) =
            make_float2(st.m[r], st.l[r]);
    }
  }
  // the CTA that arrives last merges the row block's splits, in split
  // order
  if (!arrive_last(arrivals + (size_t)bh * gridDim.x + blockIdx.x, splits))
    return;
  // two threads a row, each half of the head dim in fp32x4
  const int lr = threadIdx.x >> 1;
  const int half = D / 2;
  const int c0 = (threadIdx.x & 1) * half;
  const size_t rix = out0 + lr;
  float m = kNegInf;
  for (int z = 0; z < splits; ++z)
    m = fmaxf(m, __ldcg(ws_ml + (z * slice + rix) * 2));
  float l = 0.f;
  float4 acc[DMAX / 8];
#pragma unroll
  for (int c = 0; c < DMAX / 8; ++c) acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int z = 0; z < splits; ++z) {
    const float2 ml =
        __ldcg(reinterpret_cast<const float2*>(ws_ml + (z * slice + rix) * 2));
    const float f = expf(ml.x - m);
    l = __fadd_rn(l, __fmul_rn(ml.y, f));
    const float4* src =
        reinterpret_cast<const float4*>(ws + (z * slice + rix) * D + c0);
#pragma unroll
    for (int c = 0; c < DMAX / 8; ++c) {
      if (4 * c < half) {
        const float4 x = __ldcg(src + c);
        acc[c].x = __fadd_rn(acc[c].x, __fmul_rn(x.x, f));
        acc[c].y = __fadd_rn(acc[c].y, __fmul_rn(x.y, f));
        acc[c].z = __fadd_rn(acc[c].z, __fmul_rn(x.z, f));
        acc[c].w = __fadd_rn(acc[c].w, __fmul_rn(x.w, f));
      }
    }
  }
  const float ls = l == 0.f ? 1.f : l;
  bf16* orow = a.o + (size_t)lr * D + c0;
#pragma unroll
  for (int c = 0; c < DMAX / 8; ++c) {
    if (4 * c < half) {
      auto* dst = reinterpret_cast<__nv_bfloat162*>(orow + 4 * c);
      dst[0] = __floats2bfloat162_rn(acc[c].x / ls, acc[c].y / ls);
      dst[1] = __floats2bfloat162_rn(acc[c].z / ls, acc[c].w / ls);
    }
  }
  if (c0 == 0) a.lse[lr] = m + logf(ls);
}

// ------------------------------------------------------------------ K12
// fp32 (the CUDA-core body): grid (tiles * bq / R, B*H); per walk step,
// chunk by chunk of C keys.
__global__ void __launch_bounds__(kThreads)
banded_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 const float* __restrict__ kpm, float* __restrict__ dq,
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
  const float* kg = k + (size_t)bh * g.S * D;
  const float* vg = v + (size_t)bh * g.S * D;
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
        if (kept(st.pred, (r0 + r) / g.fb, (kc + cc) / g.fb, g)) {
          float s = __fmul_rn(ps[e], g.sm_scale);
          if (kpm_b) s += kpm_b[kc + cc];
          p = s > kValidThresh ? expf(s - lse_s[r]) : 0.f;
        }
        ps[e] = p * (dps[e] - dl_s[r]);
      }
      __syncthreads();
      mm(dqs, D, true, nullptr, ps, C, 1, ks, D + 1, 1, R, D, C);
      __syncthreads();
    }
  }

  float* dqg = dq + ((size_t)bh * out_rows + r0) * D;
  for (int e = threadIdx.x; e < R * D; e += blockDim.x)
    dqg[e] = dqs[e] * g.sm_scale;
}

// ------------------------------------------------------------------ K13
// fp32 (the CUDA-core body): grid (tiles * bkv / R, B*H): R = min(bkv,
// 32) key rows of a kv tile per
// CTA; per walk step, chunk by chunk of C = min(bq, 32) query rows.
__global__ void __launch_bounds__(kThreads)
banded_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  const float* __restrict__ kpm, float* __restrict__ dk,
                  float* __restrict__ dv, const int32_t* __restrict__ start,
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
  const float* qg = q + (size_t)bh * g.S * D;
  const float* dog = dout + (size_t)bh * g.S * D;

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
        if (kept(st.pred, (qc + r) / g.fb, (kr0 + cc) / g.fb, g)) {
          float s = __fmul_rn(ps[e], g.sm_scale);
          if (kpm) s += km_s[cc];
          p = s > kValidThresh ? expf(s - lse_s[r]) : 0.f;
        }
        ps[e] = p;
        dps[e] = p * (dps[e] - dl_s[r]);
      }
      __syncthreads();
      // dv += p^T . do ; dk += ds^T . q
      mm(dvs, D, true, nullptr, ps, 1, R, dos, D + 1, 1, R, D, C);
      mm(dks, D, true, nullptr, dps, 1, R, qs, D + 1, 1, R, D, C);
      __syncthreads();
    }
  }

  float* dkg = dk + ((size_t)bh * out_rows + kr0) * D;
  float* dvg = dv + ((size_t)bh * out_rows + kr0) * D;
  for (int e = threadIdx.x; e < R * D; e += blockDim.x) {
    dkg[e] = dks[e] * g.sm_scale;
    dvg[e] = dvs[e];
  }
}

// K12 in bf16 on K2's tensor-core dq body (mma_dq.cuh): grid (tiles * bq
// / R, B*H, splits), R = min(bq, 64) q rows per CTA, 16 per warp, over
// K11's BandedWalk and BandedKeep; CH = dq_chunk(bkv) keys per chunk.
// splits > 1 only for the gr instance, each of kv_tiles_per_split kv
// tiles (the last may hold fewer). ws: splits x B*H x rows x D fp32
// partials (dq before its scale); arrivals: B*H x (tiles * bq / R) int32.
// `tally`: see DqRows.
template <int CH, int DMAX, bool KPM>
__global__ void __launch_bounds__(2 * kMmaMaxRows, DMAX <= 64 ? 3 : 2)
banded_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const float* __restrict__ kpm, bf16* __restrict__ dq,
                     const int32_t* __restrict__ start,
                     const int32_t* __restrict__ end, float* ws,
                     int* arrivals, unsigned long long* tally, Geo g,
                     int shift, int kps) {
  const int R = blockDim.x / 2;
  const int D = g.D;
  const int bh = blockIdx.y;
  const int b = bh / g.H;
  const int r0 = blockIdx.x * R;
  const int i = r0 / g.bq;
  const int rows = gridDim.x * R;        // the instance's output rows
  const int split = blockIdx.z, splits = gridDim.z;
  BandedWalk walk{g.kind == kGlobalRowsInst, 0, g.steps, g.gt, 0, 0, g.bkv};
  if (walk.gr) {
    walk.first = split * kps;
    walk.count = min(kps, g.steps - walk.first);
  } else {
    walk.start = start[i];
    walk.end = end[i];
  }
  const size_t kv0 = (size_t)bh * g.S * D;
  const size_t row0 = (size_t)bh * g.S + r0;
  const size_t out0 = (size_t)bh * rows + r0;
  const DqRows a{q + row0 * D, dout + row0 * D,
                 lse + (size_t)bh * g.lse_rows + r0, delta + row0, k + kv0,
                 v + kv0, KPM ? kpm + (size_t)b * g.S : nullptr,
                 dq + out0 * D, r0, D, bh, g.sm_scale, tally};
  DqState<DMAX> st;
  mma_dq_walk<CH, DMAX, KPM, true, BandedRule>(a, walk, BandedKeep{g, shift},
                                               Dropout{}, st);
  if (splits == 1) {
    mma_dq_store<DMAX>(a, st);
    return;
  }
  const size_t slice = (size_t)gridDim.y * rows;
  store_partial<DMAX>(ws + (split * slice + out0) * D, st.acc, D);
  if (!arrive_last(arrivals + (size_t)bh * gridDim.x + blockIdx.x, splits))
    return;
  merge_sums<DMAX>(ws + out0 * D, slice * D, splits, D, g.sm_scale, a.dq);
}

// the steps of one CTA's column walk (col_step's, the predicate in the
// tile's kind bits as BandedWalk's): the band instance's q tiles over
// [start, end], clamped past it and keeping nothing there; `count` q
// tiles of the gc instance from q tile q0 + first (one split); the gr
// instance's q tiles from 0
struct BandedColWalk {
  int kind, first, count, q0, start, end, bq;
  __device__ __forceinline__ int n() const { return count; }
  __device__ __forceinline__ int rows() const { return bq; }
  __device__ __forceinline__ int2 tile(int t) const {
    int part, pred;
    if (kind == kGlobalRowsInst) {
      part = t;
      pred = kGlobalRows;
    } else if (kind == kGlobalColsInst) {
      part = q0 + first + t;
      pred = kGlobalCols;
    } else {
      const int s = start + t;
      part = min(s, end);
      pred = s <= end ? kBandCells : kNone;
    }
    return make_int2(part * bq, kKindBand | pred << kPredShift);
  }
};

// K13 in bf16 on K3's tensor-core dk/dv body (mma_dkv.cuh): grid (tiles *
// bkv / R, B*H, splits), R = min(bkv, 64) key rows per CTA, 16 per warp,
// over BandedColWalk and BandedKeep; CH = dkv_chunk(bq) query rows per
// chunk. splits > 1 only for the gc instance, each of q_tiles_per_split q
// tiles (the last may hold fewer). ws: splits x B*H x rows x D fp32 dk
// partials (before the scale), then as many dv partials; arrivals: B*H x
// (tiles * bkv / R) int32. `tally`: see DkvRows.
template <int CH, int DMAX, bool KPM>
__global__ void __launch_bounds__(2 * kMmaMaxRows, DMAX <= 64 ? 3 : 2)
banded_dkv_mma_kernel(const bf16* __restrict__ q,
                      const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const bf16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const float* __restrict__ kpm, bf16* __restrict__ dk,
                      bf16* __restrict__ dv,
                      const int32_t* __restrict__ start,
                      const int32_t* __restrict__ end, float* ws,
                      int* arrivals, unsigned long long* tally, Geo g,
                      int shift, int qps) {
  const int R = blockDim.x / 2;
  const int D = g.D;
  const int bh = blockIdx.y;
  const int b = bh / g.H;
  const int kr0 = blockIdx.x * R;
  const int t = kr0 / g.bkv;
  const int rows = gridDim.x * R;        // the instance's output rows
  const int split = blockIdx.z, splits = gridDim.z;
  BandedColWalk walk{g.kind, 0, g.steps, g.q0, 0, 0, g.bq};
  if (g.kind == kGlobalColsInst) {
    walk.first = split * qps;
    walk.count = min(qps, g.steps - walk.first);
  } else if (g.kind == kBand) {
    walk.start = start[t];
    walk.end = end[t];
  }
  const size_t q0 = (size_t)bh * g.S;
  const size_t krow = q0 + kr0;
  const size_t out0 = (size_t)bh * rows + kr0;
  const DkvRows a{q + q0 * D, k + krow * D, v + krow * D, dout + q0 * D,
                  lse + (size_t)bh * g.lse_rows, delta + q0,
                  KPM ? kpm + (size_t)b * g.S : nullptr, dk + out0 * D,
                  dv + out0 * D, 0, kr0, D, bh, g.sm_scale, tally};
  DkvState<DMAX> st;
  mma_dkv_walk<CH, DMAX, KPM, true, BandedRule>(
      a, walk, BandedKeep{g, shift}, Dropout{}, st);
  if (splits == 1) {
    mma_dkv_store<DMAX>(a, st);
    return;
  }
  const size_t slice = (size_t)gridDim.y * rows;
  float* ws_v = ws + splits * slice * D;
  store_partial<DMAX>(ws + (split * slice + out0) * D, st.k, D);
  store_partial<DMAX>(ws_v + (split * slice + out0) * D, st.v, D);
  if (!arrive_last(arrivals + (size_t)bh * gridDim.x + blockIdx.x, splits))
    return;
  merge_sums<DMAX>(ws + out0 * D, slice * D, splits, D, g.sm_scale,
                   dk + out0 * D);
  merge_sums<DMAX>(ws_v + out0 * D, slice * D, splits, D, 1.f,
                   dv + out0 * D);
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

template <int W, int DMAX, bool KPM>
cudaError_t run_fwd_mma(dim3 grid, int threads, size_t smem, cudaStream_t s,
                        const void* q, const void* k, const void* v,
                        const float* kpm, void* o, float* lse,
                        const int32_t* start, const int32_t* end, float* ws,
                        int* arrivals, Geo g, int shift, int kps) {
  return launch_rows(banded_fwd_mma_kernel<W, DMAX, KPM>, grid, threads,
                     smem, s, static_cast<const bf16*>(q),
                     static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                     kpm, static_cast<bf16*>(o), lse, start, end, ws,
                     arrivals, g, shift, kps);
}

using FwdMma = decltype(&run_fwd_mma<16, 64, false>);

template <int DMAX>
FwdMma pick_fwd_mma(int bkv, bool kpm) {
  return bkv == 16   ? (kpm ? run_fwd_mma<16, DMAX, true>
                            : run_fwd_mma<16, DMAX, false>)
         : bkv == 32 ? (kpm ? run_fwd_mma<32, DMAX, true>
                            : run_fwd_mma<32, DMAX, false>)
         : bkv == 64 ? (kpm ? run_fwd_mma<64, DMAX, true>
                            : run_fwd_mma<64, DMAX, false>)
                     : (kpm ? run_fwd_mma<128, DMAX, true>
                            : run_fwd_mma<128, DMAX, false>);
}

// the tensor-core backward launchers of one instantiation (pick_bwd)
template <int CH, int DMAX, bool KPM>
struct DqMma {
  static cudaError_t run(dim3 grid, int threads, size_t smem,
                         cudaStream_t s, const void* q, const void* k,
                         const void* v, const void* dout, const float* lse,
                         const float* delta, const float* kpm, void* dq,
                         const int32_t* start, const int32_t* end, float* ws,
                         int* arrivals, unsigned long long* tally, Geo g,
                         int shift, int kps) {
    return launch_rows(banded_dq_mma_kernel<CH, DMAX, KPM>, grid, threads,
                       smem, s, static_cast<const bf16*>(q),
                       static_cast<const bf16*>(k),
                       static_cast<const bf16*>(v),
                       static_cast<const bf16*>(dout), lse, delta, kpm,
                       static_cast<bf16*>(dq), start, end, ws, arrivals,
                       tally, g, shift, kps);
  }
};

template <int CH, int DMAX, bool KPM>
struct DkvMma {
  static cudaError_t run(dim3 grid, int threads, size_t smem,
                         cudaStream_t s, const void* q, const void* k,
                         const void* v, const void* dout, const float* lse,
                         const float* delta, const float* kpm, void* dk,
                         void* dv, const int32_t* start, const int32_t* end,
                         float* ws, int* arrivals,
                         unsigned long long* tally, Geo g, int shift,
                         int qps) {
    return launch_rows(banded_dkv_mma_kernel<CH, DMAX, KPM>, grid, threads,
                       smem, s, static_cast<const bf16*>(q),
                       static_cast<const bf16*>(k),
                       static_cast<const bf16*>(v),
                       static_cast<const bf16*>(dout), lse, delta, kpm,
                       static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                       start, end, ws, arrivals, tally, g, shift, qps);
  }
};

// Run<CH, DMAX, KPM>::run for a walk's chunk (16 or 32), head dim (DMAX
// 64 up to 64, else 128) and key mask
template <template <int, int, bool> class Run>
auto pick_bwd(int chunk, int D, bool kpm)
    -> decltype(&Run<16, 64, false>::run) {
  if (chunk == 16)
    return D <= 64 ? (kpm ? &Run<16, 64, true>::run : &Run<16, 64, false>::run)
                   : (kpm ? &Run<16, 128, true>::run
                          : &Run<16, 128, false>::run);
  return D <= 64 ? (kpm ? &Run<32, 64, true>::run : &Run<32, 64, false>::run)
                 : (kpm ? &Run<32, 128, true>::run : &Run<32, 128, false>::run);
}

// the splits of a walk of `steps` steps in splits of `per` (all of them
// where per is 0: the instance is not split), or 0 for a refused split
int splits_of(int steps, int per) {
  if (steps <= 0 || per < 0) return 0;
  const int n = per == 0 ? 1 : (steps + per - 1) / per;
  return n > 65535 ? 0 : n;
}

// log2(fb) where fb is a power of two, else -1
int fb_shift(int fb) {
  int sh = 0;
  while ((1 << sh) < fb) ++sh;
  return (1 << sh) == fb ? sh : -1;
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
//
// banded_fwd in bf16 runs the tensor-core body (q, k, v and o 16-byte
// aligned, kpm 8: else cudaErrorInvalidValue), and splits the gr
// instance (kind 1) into ceil(steps / kv_tiles_per_split) splits of its
// kv tiles; with more than one, ws holds splits * bh * rows * (head_dim +
// 2) fp32 (rows = tiles * bq) and arrivals bh * rows / min(bq, 64) int32,
// 0 before the launch (and 0 again after it). The band instance (kind 0)
// and fp32 walk one split; kv_tiles_per_split, ws and arrivals are then
// not read.
extern "C" int banded_fwd(const void* q, const void* k, const void* v,
                          const void* kpm, void* o, void* lse, void* ws,
                          void* arrivals, const void* start, const void* end,
                          int kv_tiles_per_split, GEO_ARGS) {
  const Geo g = GEO;
  if (bad_geo(bh, g, tiles, bq)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* kp = static_cast<const float*>(kpm);
  const auto* st = static_cast<const int32_t*>(start);
  const auto* en = static_cast<const int32_t*>(end);
  if (dtype == 1) {           // bf16: the tensor-core body, or an error
    if (fwd_misaligned(q, k, v, o, kpm)) return (int)cudaErrorInvalidValue;
    const int kps = kind == kGlobalRowsInst ? kv_tiles_per_split : steps;
    if (kps <= 0 || steps <= 0) return (int)cudaErrorInvalidValue;
    const int splits = (steps + kps - 1) / kps;
    if (splits > 65535 || (splits > 1 && (!ws || !arrivals)))
      return (int)cudaErrorInvalidValue;
    const int R = mma_rows(bq);
    return (int)(head_dim <= 64 ? pick_fwd_mma<64>(bkv, kp != nullptr)
                                : pick_fwd_mma<128>(bkv, kp != nullptr))(
        dim3(tiles * bq / R, bh, splits), 2 * R,
        mma_fwd_smem(R, bkv, head_dim), s, q, k, v, kp, o,
        static_cast<float*>(lse), st, en, static_cast<float*>(ws),
        static_cast<int*>(arrivals), g, fb_shift(fb), kps);
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  const int R = rows_of(bq), C = rows_of(bkv);   // fp32: the CUDA cores
  return (int)launch(banded_fwd_kernel, dim3(tiles * bq / R, bh),
                     fwd_smem(R, C, head_dim, bkv), s,
                     static_cast<const float*>(q),
                     static_cast<const float*>(k),
                     static_cast<const float*>(v), kp,
                     static_cast<float*>(o), static_cast<float*>(lse), st,
                     en, g);
}

// banded_dq and banded_dkv in bf16 run the tensor-core bodies (q, k, v,
// do and the outputs 16-byte aligned, kpm 8: else cudaErrorInvalidValue)
// and split one instance each: banded_dq the gr instance (kind 1) into
// ceil(steps / tiles_per_split) splits of its kv tiles, banded_dkv the gc
// instance (kind 2) into splits of its q tiles. With more than one, ws
// holds splits * bh * rows * head_dim fp32 (banded_dkv twice that; rows =
// tiles * bq, or tiles * bkv) and arrivals bh * rows / min(bq, 64) (or
// min(bkv, 64)) int32, 0 before the launch (and 0 again after it); the
// other instances and fp32 walk one split, and tiles_per_split, ws and
// arrivals are then not read. tally: null, or one uint64 to which the
// bf16 bodies add the cells they sum again.
extern "C" int banded_dq(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta,
                         const void* kpm, void* dq, void* ws, void* arrivals,
                         void* tally, const void* start, const void* end,
                         int kv_tiles_per_split, GEO_ARGS) {
  const Geo g = GEO;
  if (bad_geo(bh, g, tiles, bq)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* ls = static_cast<const float*>(lse);
  const auto* dl = static_cast<const float*>(delta);
  const auto* kp = static_cast<const float*>(kpm);
  const auto* st = static_cast<const int32_t*>(start);
  const auto* en = static_cast<const int32_t*>(end);
  if (dtype == 1) {           // bf16: the tensor-core body, or an error
    // one output: dq stands for both of dk/dv's
    if (dkv_misaligned(q, k, v, dout, dq, dq, kpm))
      return (int)cudaErrorInvalidValue;
    const int kps = kind == kGlobalRowsInst ? kv_tiles_per_split : 0;
    const int splits = splits_of(steps, kps);
    if (splits == 0 || (splits > 1 && (!ws || !arrivals)))
      return (int)cudaErrorInvalidValue;
    const int R = mma_rows(bq);
    return (int)pick_bwd<DqMma>(dq_chunk(bkv), head_dim, kp != nullptr)(
        dim3(tiles * bq / R, bh, splits), 2 * R,
        mma_dq_smem(R, bkv, head_dim), s, q, k, v, dout, ls, dl, kp, dq, st,
        en, static_cast<float*>(ws), static_cast<int*>(arrivals),
        static_cast<unsigned long long*>(tally), g, fb_shift(fb),
        kps ? kps : steps);
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  const int R = rows_of(bq), C = rows_of(bkv);   // fp32: the CUDA cores
  return (int)launch(banded_dq_kernel, dim3(tiles * bq / R, bh),
                     dq_smem(R, C, head_dim, bkv / C), s,
                     static_cast<const float*>(q),
                     static_cast<const float*>(k),
                     static_cast<const float*>(v),
                     static_cast<const float*>(dout), ls, dl, kp,
                     static_cast<float*>(dq), st, en, g);
}

extern "C" int banded_dkv(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse,
                          const void* delta, const void* kpm, void* dk,
                          void* dv, void* ws, void* arrivals, void* tally,
                          const void* start, const void* end,
                          int q_tiles_per_split, GEO_ARGS) {
  const Geo g = GEO;
  if (bad_geo(bh, g, tiles, bkv)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* ls = static_cast<const float*>(lse);
  const auto* dl = static_cast<const float*>(delta);
  const auto* kp = static_cast<const float*>(kpm);
  const auto* st = static_cast<const int32_t*>(start);
  const auto* en = static_cast<const int32_t*>(end);
  if (dtype == 1) {           // bf16: the tensor-core body, or an error
    if (dkv_misaligned(q, k, v, dout, dk, dv, kpm))
      return (int)cudaErrorInvalidValue;
    const int qps = kind == kGlobalColsInst ? q_tiles_per_split : 0;
    const int splits = splits_of(steps, qps);
    if (splits == 0 || (splits > 1 && (!ws || !arrivals)))
      return (int)cudaErrorInvalidValue;
    const int R = mma_rows(bkv);
    return (int)pick_bwd<DkvMma>(dkv_chunk(bq), head_dim, kp != nullptr)(
        dim3(tiles * bkv / R, bh, splits), 2 * R,
        mma_dkv_smem(R, bq, head_dim), s, q, k, v, dout, ls, dl, kp, dk, dv,
        st, en, static_cast<float*>(ws), static_cast<int*>(arrivals),
        static_cast<unsigned long long*>(tally), g, fb_shift(fb),
        qps ? qps : steps);
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  const int R = rows_of(bkv), C = rows_of(bq);   // fp32: the CUDA cores
  return (int)launch(banded_dkv_kernel, dim3(tiles * bkv / R, bh),
                     dkv_smem(R, C, head_dim, bq / C), s,
                     static_cast<const float*>(q),
                     static_cast<const float*>(k),
                     static_cast<const float*>(v),
                     static_cast<const float*>(dout), ls, dl, kp,
                     static_cast<float*>(dk), static_cast<float*>(dv), st,
                     en, g);
}
