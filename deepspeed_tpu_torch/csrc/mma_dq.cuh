// The bf16 dq body of K2 (masked_flash.cu), K6 (flash.cu), K9
// (blocksparse_v2.cu), K12 (banded.cu) and K15 (blocksparse.cu) on the
// tensor cores: one walk over key tiles for a CTA of 16 query rows per
// warp, on mma_tiles.cuh's fragments.
//
// A CTA owns R = 16 * warps query rows of one q head (one block row of K2's
// or K9's CSR walk, one query tile of K6 or K12, one block row of K15's row
// triples), R = min(tile rows, 64). Its Q and dO rows are staged once as
// bf16; each lane holds the lse and delta of its two rows, and each warp
// the dQ accumulator of its 16 rows in registers. K and V stream through a
// ring of shared chunks of CH = min(tile keys, 32) keys in bf16, loaded
// with cp.async, kDqAhead chunks in flight ahead of the one computing, one
// barrier per chunk. Per chunk and warp: S = Q K^T and dP = dO V^T (16
// queries x CH keys; each 16-wide step an mma from zero whose partial is
// added in fp32, K and V as B operands by ldmatrix), the cells' p and ds in
// registers, then dQ += dS K with dS as the A operand straight from the
// score fragments (the C-to-A identity of mma_tiles.cuh) and K as the B
// operand through ldmatrix.trans. Nothing goes back to shared memory but
// the descriptors of the cells summed again.
//
// The function is the CUDA-core bodies' (mf_dq_kernel, flash_dq_kernel,
// v2_dq_kernel, bs_dq_kernel) and their plain versions': s = (q.k) *
// sm_scale, + kpm[key], then with AM (K9, K15) + the walk's additive mask
// cell am[q, key] (K9's tile by uid, K15's (S, S) mask read in place;
// float2 pairs per 8-key fragment), each rounded in fp32; then the causal
// clip of a CAUSAL tile and the band predicate of a BAND tile set NEG_INF;
// p = exp(s - lse[q]), and the kernel's Rule (mma_fwd.cuh) sets the guard:
// p = 0 where s <= its threshold (K2, K12 and K15 -1e28, K9 -1e29; K6
// none);
// under dropout, keyed on (bh, q, k), dp = dp / (1 - rate) where kept and
// 0 where dropped; ds = p (dp - delta[q]), rounded to bf16 before dQ +=
// dS K; dq is scaled by sm_scale once at the end and written in bf16 (dq
// is per q head: no GQA partials). mma_dq_walk leaves the unscaled
// accumulator in registers (DqState) and mma_dq_store writes dq from it;
// mma_dq_body is the two. K12's split walks keep each split's sum and
// add them (banded.cu).
//
// The rounding of ds is held to the plain versions' as mma_dkv.cuh holds
// it (its derivation of up and ud, with pd left out: dq rounds ds only).
// Beside S the body takes sum_d |q_d k_d| and beside dP sum_d |do_d v_d|
// (the mmas of |Q| and |K|, of |dO| and |V|); their largest over a
// lane's cells of one query row bounds how far its score and dp can part
// from theirs (with AM, up counts the mask's sum as mma_dkv.cuh does). A
// cell whose ds lies within ud ulps of a bf16 rounding midpoint is summed
// again in their order from the staged rows (ordered_dot2: its s and its
// dp) and its p taken with their expf; the warp spreads its flagged cells
// over its lanes (resum_spread).
//
// Skips, each leaving every output as the walk without it: a chunk in which
// no cell of the CTA's rows is kept (a CAUSAL tile's chunk wholly past the
// CTA's last row, a BAND tile's chunk the band's any() rejects: no load, no
// product), and per warp each 16-key group of a CAUSAL or BAND chunk its 16
// rows keep no cell of (p = 0 there, and ds = 0 adds nothing to dQ).

#pragma once

#include "mma_dkv.cuh"

namespace {

constexpr int kDqAhead = 3;                // chunks in flight
constexpr int kDqStages = kDqAhead + 1;    // ring slots
constexpr int kDqChunk = 32;               // keys per chunk, at most

// one CTA's operands, already offset to its q head, rows and kv head
struct DqRows {
  const bf16* q;        // (R, D): the CTA's query rows
  const bf16* dout;     // (R, D)
  const float* lse;     // (R)
  const float* delta;   // (R)
  const bf16* k;        // (Sk, D): its kv head's keys
  const bf16* v;        // (Sk, D)
  const float* kpm;     // (Sk): its batch row's key mask, with KPM
  bf16* dq;             // (R, D)
  int r0;               // the first query index of the CTA
  int D, bh;
  float sm_scale;
  // where given (K15's measurement), the body adds the cells it sums
  // again; left out (null) by the kernels that count none
  unsigned long long* tally;
};

// keys per staged chunk for a walk of tiles of `keys` keys
__host__ __device__ inline int dq_chunk(int keys) {
  return keys < kDqChunk ? keys : kDqChunk;
}

// the tensor-core backward instantiation of a call (the dq or the dk/dv
// body of any walk): `Run<CH, DMAX, A, B>::run` launches one, with CH the
// walk's chunk (16 or 32: dq_chunk / dkv_chunk of its tiles), DMAX 64 for
// head dims up to 64 and 128 above (the bad_shape checks passed: D <= 128),
// A the key mask and B the kernel's other flag (a band, or mask tiles)
template <template <int, int, bool, bool> class Run, int CH, int DMAX>
auto pick_bwd_mma_flags(bool a, bool b)
    -> decltype(&Run<CH, DMAX, false, false>::run) {
  return a ? (b ? &Run<CH, DMAX, true, true>::run
                : &Run<CH, DMAX, true, false>::run)
           : (b ? &Run<CH, DMAX, false, true>::run
                : &Run<CH, DMAX, false, false>::run);
}

template <template <int, int, bool, bool> class Run>
auto pick_bwd_mma(int chunk, int D, bool a, bool b)
    -> decltype(&Run<16, 64, false, false>::run) {
  const bool wide = D > 64;
  return chunk == 16 ? (wide ? pick_bwd_mma_flags<Run, 16, 128>(a, b)
                             : pick_bwd_mma_flags<Run, 16, 64>(a, b))
                     : (wide ? pick_bwd_mma_flags<Run, 32, 128>(a, b)
                             : pick_bwd_mma_flags<Run, 32, 64>(a, b));
}

// shared bytes of the dq body: Q and dO rows, the ring of K and V chunks,
// and each warp's re-sum buffer
inline size_t mma_dq_smem(int R, int keys, int D) {
  const size_t ch = dq_chunk(keys);
  const size_t ld = pad16(D) + kPadCols;
  return sizeof(bf16) * (2 * R + kDqStages * 2 * ch) * ld +
         (size_t)(R / 16) * kRedoBytes;
}

// what a CTA's walk leaves in registers: this lane's fragments of the
// dQ accumulator of its rows g and g + 8 of its warp's 16, not yet scaled
template <int DMAX>
struct DqState {
  float acc[DMAX / 8][4];
};

// Walk: n() tiles, tile(t) = (first key, kind bits), keys() keys per
// tile (16, 32, 64, 128); with AM, mask(t) the tile's additive fp32 mask
// at the CTA's first row (row stride mask_ld(), even, 8-byte aligned).
// CH = dq_chunk(keys()); DMAX: 64 or 128; Rule: the kernel's softmax rule
// (mma_fwd.cuh; its kGuard and kValid). BAND: the tiles with kKindBand in
// their kind keep the cells of bd.keep(kind, q, k) (bd.any(kind, q0, q1,
// k0, k1): whether any cell of a rectangle is kept).
template <int CH, int DMAX, bool KPM, bool BAND, typename Rule,
          bool AM = false, typename Walk, typename BandT>
__device__ __forceinline__ void mma_dq_walk(const DqRows& a, const Walk& walk,
                                            const BandT& bd,
                                            const Dropout& dr,
                                            DqState<DMAX>& st) {
  constexpr int NT = CH / 8;        // 8-key score tiles per warp
  constexpr int NG = CH / 16;       // 16-key groups (mma k-steps of dQ)
  constexpr int KD = DMAX / 16;     // 16-wide steps over the head dim
  extern __shared__ __align__(16) unsigned char dq_shared[];
  const int D = a.D;
  const int Dp = pad16(D);
  const int nkd = Dp / 16;
  const int ld = Dp + kPadCols;
  const int R = blockDim.x / 2;     // 16 query rows per warp of 32 lanes
  bf16* qs = reinterpret_cast<bf16*>(dq_shared);
  bf16* dos = qs + R * ld;
  bf16* ring = dos + R * ld;
  const int stage = 2 * CH * ld;    // a slot: CH K rows, then CH V rows
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int wr0 = a.r0 + warp * 16;  // the warp's first query index
  const int rlast = a.r0 + R - 1;    // the CTA's last query index
  int* redo_cell = reinterpret_cast<int*>(
      reinterpret_cast<unsigned char*>(ring + kDqStages * stage) +
      warp * kRedoBytes);
  float2* redo_sum = reinterpret_cast<float2*>(redo_cell + 32);
  const int n = walk.n();
  const int nch = walk.keys() / CH;

  // whether chunk c of tile tr holds a kept cell of the CTA's rows
  auto live_chunk = [&](int2 tr, int c) {
    const int ka = tr.x + c * CH, kb = ka + CH - 1;
    if ((tr.y & kKindCausal) && ka > rlast) return false;
    if constexpr (BAND) {
      if ((tr.y & kKindBand) && !bd.any(tr.y, a.r0, rlast, ka, kb))
        return false;
    }
    return true;
  };
  // (t, c) moved on to the first live chunk at or after it
  auto next_live = [&](int& t, int& c) {
    for (; t < n; ++t, c = 0) {
      const int2 tr = walk.tile(t);
      for (; c < nch; ++c)
        if (live_chunk(tr, c)) return;
    }
  };

  // the producer: K and V rows of the next live chunk
  int ft = 0, fc = 0;
  next_live(ft, fc);
  auto issue = [&](int slot) {
    if (ft < n) {
      const int k0 = walk.tile(ft).x + fc * CH;
      bf16* kd = ring + slot * stage;
      stage_rows_async(kd, ld, a.k + (size_t)k0 * D, CH, D);
      stage_rows_async(kd + CH * ld, ld, a.v + (size_t)k0 * D, CH, D);
      ++fc;
      next_live(ft, fc);
    }
    cp_async_commit();
  };

  zero_tail(qs, ld, 2 * R, D, Dp);     // Q and dO rows are contiguous
  for (int s = 0; s < kDqStages; ++s)
    zero_tail(ring + s * stage, ld, 2 * CH, D, Dp);
  stage_rows_async(qs, ld, a.q, R, D);
  stage_rows_async(dos, ld, a.dout, R, D);
#pragma unroll
  for (int i = 0; i < kDqAhead; ++i) issue(i);  // group 0 holds Q, dO too
  cp_async_wait<kDqAhead - 1>();
  __syncthreads();

  // A operands: the warp's 16 Q (dO) rows, 16 of the head dim per step,
  // read from shared memory at each step (held in registers they ran
  // slower at head dims up to 64, PERF.md section 6)
  const int arow = (warp * 16 + (lane & 15)) * ld + (lane >> 4) * 8;
  // this lane's rows wr0 + g and wr0 + g + 8: lse, delta, and up's part
  // of each (4 |lse| + 4; AM: 8 |lse| + 4)
  float lse_r[2], dl_r[2], lu[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int lr = warp * 16 + g + 8 * r;
    lse_r[r] = a.lse[lr];
    dl_r[r] = a.delta[lr];
    lu[r] = fmaf(AM ? 8.f : 4.f, fabsf(lse_r[r]), 4.f);
  }

  int step = 0;
  auto advance = [&]() {
    cp_async_wait<kDqAhead - 1>();
    __syncthreads();
    issue((step + kDqAhead) % kDqStages);
    return ring + (step++ % kDqStages) * stage;
  };

  float(&acc)[DMAX / 8][4] = st.acc;
#pragma unroll
  for (int j = 0; j < DMAX / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  // ldmatrix row and column of this lane: K and V as B columns (S, dP),
  // K as B rows transposed on the load (dQ)
  const int brow = (lane & 7) + ((lane >> 4) << 3);
  const int bcol = ((lane >> 3) & 1) * 8;
  const int trow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int tcol = (lane >> 4) * 8;
  const float inv = dr.on ? dr.inv_keep : 1.f;
  const float sq = sqrtf((float)D);

  int ct = 0, cc = 0;
  next_live(ct, cc);
  while (ct < n) {
    const int2 tr = walk.tile(ct);
    const int k0 = tr.x + cc * CH, kind = tr.y;
    const bf16* kch = advance();
    const bf16* vch = kch + CH * ld;
    // AM: this lane's mask row g at the chunk's key 2tq (row g + 8 lies
    // 8 mld past it)
    const float* amr = nullptr;
    int mld = 0;
    if constexpr (AM) {
      mld = walk.mask_ld();
      amr = walk.mask(ct) + (warp * 16 + g) * mld + cc * CH + 2 * tq;
    }
    // bit j: whether the warp's rows keep a cell of keys 16j..16j+15
    unsigned live = (1u << NG) - 1u;
    if (kind & kKindCausal) {
#pragma unroll
      for (int j = 0; j < NG; ++j)
        if (k0 + 16 * j > wr0 + 15) live &= ~(1u << j);
    }
    if constexpr (BAND) {
      if (kind & kKindBand) {
#pragma unroll
        for (int j = 0; j < NG; ++j)
          if (!bd.any(kind, wr0, wr0 + 15, k0 + 16 * j, k0 + 16 * j + 15))
            live &= ~(1u << j);
      }
    }
    if (live != 0u) {
      // S = Q K^T and dP = dO V^T beside sum_d |q_d k_d| and
      // sum_d |do_d v_d|, whose max over this lane's cells of a query row
      // bounds the error of each of its sums
      float s[NT][4], dpv[NT][4];
      float bs[2] = {0.f, 0.f}, bd2[2] = {0.f, 0.f};
      // bit 4j + e: cell (j, e)'s sum_d |do_d v_d| is 0, so every term of
      // its dp is 0 and dp is exactly 0 in either order (a dO row of
      // zeros: a pad query, a row the loss does not reach)
      uint32_t dzero = 0u;
#pragma unroll
      for (int j = 0; j < NG; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[2 * j][e] = s[2 * j + 1][e] = dpv[2 * j][e] =
              dpv[2 * j + 1][e] = 0.f;
        if (!((live >> j) & 1u)) continue;
        float us0[4] = {0.f, 0.f, 0.f, 0.f}, us1[4] = {0.f, 0.f, 0.f, 0.f};
        float ud0[4] = {0.f, 0.f, 0.f, 0.f}, ud1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kd = 0; kd < KD; ++kd) {
          if (kd < nkd) {
            uint32_t A[4], Ad[4];
            ldsm_x4(A, qs + arow + kd * 16);
            ldsm_x4(Ad, dos + arow + kd * 16);
            const int boff = (j * 16 + brow) * ld + kd * 16 + bcol;
            uint32_t b[4], aa[4];
            float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
            ldsm_x4(b, kch + boff);
            mma_bf16(t0, A, b[0], b[1]);
            mma_bf16(t1, A, b[2], b[3]);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              s[2 * j][e] += t0[e];
              s[2 * j + 1][e] += t1[e];
              t0[e] = t1[e] = 0.f;
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) aa[i] = abs_bf16x2(A[i]);
            mma_bf16(us0, aa, abs_bf16x2(b[0]), abs_bf16x2(b[1]));
            mma_bf16(us1, aa, abs_bf16x2(b[2]), abs_bf16x2(b[3]));
            ldsm_x4(b, vch + boff);
            mma_bf16(t0, Ad, b[0], b[1]);
            mma_bf16(t1, Ad, b[2], b[3]);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              dpv[2 * j][e] += t0[e];
              dpv[2 * j + 1][e] += t1[e];
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) aa[i] = abs_bf16x2(Ad[i]);
            mma_bf16(ud0, aa, abs_bf16x2(b[0]), abs_bf16x2(b[1]));
            mma_bf16(ud1, aa, abs_bf16x2(b[2]), abs_bf16x2(b[3]));
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dzero |= (uint32_t)(ud0[e] == 0.f) << (8 * j + e) |
                   (uint32_t)(ud1[e] == 0.f) << (8 * j + 4 + e);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          bs[r] = fmaxf(bs[r], fmaxf(fmaxf(us0[2 * r], us0[2 * r + 1]),
                                     fmaxf(us1[2 * r], us1[2 * r + 1])));
          bd2[r] = fmaxf(bd2[r], fmaxf(fmaxf(ud0[2 * r], ud0[2 * r + 1]),
                                       fmaxf(ud1[2 * r], ud1[2 * r + 1])));
        }
      }

      // this lane's cells: queries wr0 + g (e < 2) and wr0 + g + 8
      // (e >= 2), keys k0 + 8j + 2tq + (e & 1); ds into s
      float us[2], ud[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        us[r] = 16777216.f * kSumErr * sq * bs[r] * a.sm_scale;
        ud[r] = 16777216.f * kSumErr * sq * bd2[r] * inv;
      }
      // the scaled score plus the key mask's value km of its key, then
      // with AM the mask's value am of its cell
      auto score = [&](float raw, float km, float am) {
        const float x = __fmul_rn(raw, a.sm_scale);
        const float y = KPM ? __fadd_rn(x, km) : x;
        return AM ? __fadd_rn(y, am) : y;
      };
      // whether the cell (query qi, key ki) of score tile j is masked:
      // its group skipped, the causal clip, the band
      auto masked = [&](int j, int qi, int ki) {
        bool m = !((live >> (j >> 1)) & 1u) ||
                 ((kind & kKindCausal) && qi < ki);
        if constexpr (BAND)
          m = m || ((kind & kKindBand) && !bd.keep(kind, qi, ki));
        return m;
      };
      // the flags are set without a branch: a branch per cell costs
      // more than the arithmetic it skips
      uint32_t redo = 0u;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int kc = k0 + 8 * j + 2 * tq;
        float2 km = make_float2(0.f, 0.f);
        if constexpr (KPM) km = *reinterpret_cast<const float2*>(a.kpm + kc);
        // AM: the mask's pairs at keys 8j + 2tq of rows g and g + 8
        float2 am0 = make_float2(0.f, 0.f), am1 = am0;
        if constexpr (AM) {
          am0 = *reinterpret_cast<const float2*>(amr + 8 * j);
          am1 = *reinterpret_cast<const float2*>(amr + 8 * mld + 8 * j);
        }
        const float av[4] = {am0.x, am0.y, am1.x, am1.y};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int qi = wr0 + g + 8 * r, ki = kc + (e & 1);
          const float x =
              masked(j, qi, ki)
                  ? kNegInf
                  : score(s[j][e], (e & 1) ? km.y : km.x, av[e]);
          const float arg = x - lse_r[r];
          // ex2.approx here; the plain versions' expf where the rounding
          // of ds is at stake
          const float p =
              (!Rule::kGuard || x > Rule::kValid) ? __expf(arg) : 0.f;
          float dp = dpv[j][e];
          bool kept = true;
          if (dr.on) {
            kept = dr.keep(a.bh, qi, ki);
            dp = kept ? dp * dr.inv_keep : 0.f;
          }
          const float t = dp - dl_r[r], ta = fabsf(t);
          const float ds = p * t;
          float up = us[r] + lu[r] + (AM ? 13.25f : 9.25f) * fabsf(arg);
          if constexpr (AM) up = fmaf(4.f, fabsf(av[e]), up);
          // dp's part of ud (t = 0 makes it infinite: at stake)
          const float dterm = kept && !((dzero >> (4 * j + e)) & 1u)
                                  ? ud[r] + (dr.on ? 2.f * fabsf(dp) : 0.f)
                                  : 0.f;
          const bool tie =
              (p != 0.f) & near_bf16_tie(ds, ds_ulps(up, dterm, ta));
          redo |= (uint32_t)tie << (4 * j + e);
          s[j][e] = ds;
        }
      }
      // s[i / 4][i % 4] = v in registers for an i known only at run time
      auto put = [&](int idx, float v) {
        const int jj = idx >> 2, e = idx & 3;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if (j == jj) {
            s[j][0] = e == 0 ? v : s[j][0];
            s[j][1] = e == 1 ? v : s[j][1];
            s[j][2] = e == 2 ? v : s[j][2];
            s[j][3] = e == 3 ? v : s[j][3];
          }
        }
      };
      // the warp's cells at stake, summed again in the plain versions'
      // order from the staged rows, spread over its lanes; cell i's ds
      // from its score and dp summed so
      resum_spread(
          redo, lane, redo_cell, redo_sum, a.tally,
          [&](int ol, int i) {
            const int qr = (warp * 16 + (ol >> 2) + 8 * ((i & 3) >> 1)) * ld;
            const int kr = (8 * (i >> 2) + 2 * (ol & 3) + (i & 1)) * ld;
            return ordered_dot2(qs + qr, kch + kr, dos + qr, vch + kr, D);
          },
          [&](int i, float2 sd) {
            const int r = (i & 3) >> 1;
            const int qi = wr0 + g + 8 * r;
            const int ki = k0 + 8 * (i >> 2) + 2 * tq + (i & 1);
            const float am =
                AM ? amr[r * 8 * mld + 8 * (i >> 2) + (i & 1)] : 0.f;
            const float x = masked(i >> 2, qi, ki)
                                ? kNegInf
                                : score(sd.x, KPM ? a.kpm[ki] : 0.f, am);
            const float p = (!Rule::kGuard || x > Rule::kValid)
                                ? expf(x - lse_r[r])
                                : 0.f;
            float dp = sd.y;
            if (dr.on) dp = dr.keep(a.bh, qi, ki) ? dp * dr.inv_keep : 0.f;
            put(i, p * (dp - dl_r[r]));
          });

      // dQ += dS K, dS rounded to bf16 in registers
#pragma unroll
      for (int kk = 0; kk < NG; ++kk) {
        if (!((live >> kk) & 1u)) continue;
        const uint32_t da[4] = {
            pack_bf16(s[2 * kk][0], s[2 * kk][1]),
            pack_bf16(s[2 * kk][2], s[2 * kk][3]),
            pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int dp = 0; dp < KD; ++dp) {
          if (dp < nkd) {
            uint32_t b[4];
            ldsm_x4_t(b, kch + (kk * 16 + trow) * ld + dp * 16 + tcol);
            mma_bf16(acc[2 * dp], da, b[0], b[1]);
            mma_bf16(acc[2 * dp + 1], da, b[2], b[3]);
          }
        }
      }
    }
    ++cc;
    next_live(ct, cc);
  }
  cp_async_wait<0>();
}

// dq = acc * sm_scale in bf16 for the CTA's rows, from its walk's state
template <int DMAX>
__device__ __forceinline__ void mma_dq_store(const DqRows& a,
                                             const DqState<DMAX>& st) {
  const int D = a.D;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const float(&acc)[DMAX / 8][4] = st.acc;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    bf16* row = a.dq + (size_t)(warp * 16 + g + 8 * r) * D;
#pragma unroll
    for (int j = 0; j < DMAX / 8; ++j) {
      if (8 * j < D)
        *reinterpret_cast<__nv_bfloat162*>(row + 8 * j + 2 * tq) =
            __floats2bfloat162_rn(acc[j][2 * r] * a.sm_scale,
                                  acc[j][2 * r + 1] * a.sm_scale);
    }
  }
}

template <int CH, int DMAX, bool KPM, bool BAND, typename Rule,
          bool AM = false, typename Walk, typename BandT>
__device__ __forceinline__ void mma_dq_body(const DqRows& a, const Walk& walk,
                                            const BandT& bd,
                                            const Dropout& dr) {
  DqState<DMAX> st;
  mma_dq_walk<CH, DMAX, KPM, BAND, Rule, AM>(a, walk, bd, dr, st);
  mma_dq_store<DMAX>(a, st);
}

}  // namespace
