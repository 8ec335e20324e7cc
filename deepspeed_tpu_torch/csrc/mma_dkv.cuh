// The bf16 dk/dv body of K3 (masked_flash.cu), K7 (flash.cu), K10
// (blocksparse_v2.cu) and K16 (blocksparse.cu) on the tensor cores: one
// walk over tiles of query rows for a CTA of 16 key rows per warp, on
// mma_tiles.cuh's fragments.
//
// A CTA owns R = 16 * warps key rows of one q head's kv row (one key
// block of K3's or K10's CSC walk, one key tile of K7, one key block of
// K16's column triples), R = min(key block, 64).
// Each warp keeps the dK and dV accumulators of its 16 keys in
// registers and reads its K and V fragments from the CTA's staged K and
// V rows at each step. Q and dO stream through a ring of shared
// chunks of CH = min(tile rows, 32) query rows in bf16, loaded with
// cp.async beside the chunk's lse and delta, kAhead chunks in flight
// ahead of the one computing, one barrier per chunk. Per chunk and warp:
// S^T = K Q^T and dP^T = V dO^T (16 keys x CH queries; each 16-wide step
// an mma from zero whose partial is added in fp32), the cells' p, pd and
// ds in registers, then dV += Pd^T dO and dK += dS^T Q with Pd^T and
// dS^T as A operands straight from the score fragments (the C-to-A
// identity of mma_tiles.cuh) and dO and Q as B operands through
// ldmatrix.trans. Nothing goes back to shared memory.
//
// The function is the CUDA-core bodies' (mf_dkv_kernel, flash_dkv_kernel,
// v2_dkv_kernel, bs_dkv_kernel): s = (q.k) * sm_scale, + kpm[key], then
// with AM (K10, K16) + the walk's additive mask cell am[q, key] (K10's
// tile by uid, K16's (S, S) mask read in place; S^T puts the cells of a
// key row mask_ld() apart), each rounded in fp32; then the causal clip of
// a CAUSAL tile and the band predicate of a BAND tile set NEG_INF; p =
// exp(s - lse[q]), and the kernel's Rule (mma_fwd.cuh) sets the guard: p
// = 0 where s <= its threshold (K3 and K16 -1e28, K10 -1e29; K7 none);
// under dropout, keyed on (bh, q, k), pd = p / (1 - rate) and dp = dp /
// (1 - rate) where kept, both 0 where dropped; ds = p (dp - delta[q]). pd
// and ds round to bf16 before their products; dK is scaled by sm_scale at
// the end, dV is not; outputs in bf16, or fp32 per-q-head partials
// (fp32_out, GQA).
//
// The rounding of pd and ds. The plain versions sum q.k and do.v one
// term at a time in fp32 (flash.ordered_dot; cuBLAS's fp32 products at
// these shapes sum the same way), and pd and ds round to bf16 from their
// values: one rounding that lands on the other side moves a long dk or
// dv sum past TRAIN_TOL. So the body holds both roundings to theirs.
// Beside S^T it takes sum_d |k_d q_d| (the mma of |K| and |Q|) and
// beside dP^T sum_d |v_d do_d| (|V| and |dO|); the largest of each over
// a lane's cells of one key row bounds how far its sums and theirs can
// part: eps_s = kSumErr sqrt(D) max sum |k q| * sm_scale for s and eps_d
// = kSumErr sqrt(D) max sum |v do| for dp (mma_fwd.cuh derives kSumErr).
// In fp32 ulps of the value (an ulp of x is at least |x| 2^-24):
//   p = exp(a), a = s - lse: p's relative error is |da| plus exp's own,
//     so with u(x) = 2^24 |x|, up = u(eps_s) + 4 |lse| + 4 + 9.25 |a|
//     (mma_fwd.cuh's count, the row max m replaced by lse: one rounding
//     each of the scale, the key mask and s - lse, __expf's and expf's
//     errors); with AM the mask's sum is one more rounding, 4 |s| <=
//     4 |lse| + 4 |a| more, and the sums before it may lie |mask| above
//     |s|, 4 |mask| more: up = u(eps_s) + 8 |lse| + 4 + 13.25 |a| +
//     4 |mask| (mma_fwd.cuh counts the same); pd = p / (1 - rate) adds
//     one rounding: up + 2.
//   ds = p t, t = dp' - delta (dp' = dp, or dp / (1 - rate)): dds <=
//     dp |t| + p dt + 2 ulps of the two roundings, with dp <= up ulps of
//     p and dt <= eps_d / (1 - rate) + |dp'| 2^-23 (the scaling's
//     rounding) + |t| 2^-24; over ds's ulp (>= p |t| 2^-24):
//     ud = 2 up + (u(eps_d) / (1 - rate) + 2 |dp'|) / |t| + 8, the dp
//     terms left out where the cell is dropped (dp' = 0 in both) or its
//     sum |v do| is 0 (every term of dp is 0: dp = 0 in both; a dO row
//     of zeros, as pad queries and rows the loss does not reach have).
// (Without dropout pd = p and dp' = dp: no scaling, and neither its 2
// ulps nor its 2 |dp'| / |t|.) A cell whose pd lies within up (+ 2)
// ulps of a bf16 rounding midpoint, or whose ds lies within ud (t = 0
// with a dp term counts as at stake), is summed again in their order
// from the staged rows (ordered_dot2: its s and its dp) and its p taken
// with their expf; the others round as theirs do. A warp spreads its
// flagged cells over its 32 lanes, 32 a round, through a small shared
// buffer: a lane re-sums a cell of any lane, so the warp runs
// ceil(flagged / 32) rounds, not the most one lane holds. lse is given,
// so no running max is at stake here (K1's max re-sum has no
// counterpart). A cell whose p is 0 (the guard's, a masked or pad key's:
// 0 in both, and so are pd and ds) is never at stake, whatever its
// bounds, which are huge there.
//
// Skips, each leaving every output as the walk without it: a chunk in
// which no cell of the CTA's keys is kept (a CAUSAL tile's chunk wholly
// before the CTA's first key, a BAND tile's chunk Band::any rejects: no
// load, no product), and per warp each 16-query group of a CAUSAL or
// BAND chunk its 16 keys keep no cell of (p = 0 there, and pd = ds = 0
// add nothing to dK and dV).

#pragma once

#include "mma_fwd.cuh"

namespace {

constexpr int kDkvAhead = 3;                // chunks in flight
constexpr int kDkvStages = kDkvAhead + 1;   // ring slots
constexpr int kDkvChunk = 32;               // query rows per chunk, at most
// per warp, a round of cells at stake: 32 descriptors (lane << 4 | cell)
// and their two sums
constexpr int kRedoBytes = 32 * (sizeof(int) + sizeof(float2));

// one CTA's operands, already offset to its q head and its key rows
struct DkvRows {
  const bf16* q;        // (Sq, D): the CTA's q head
  const bf16* k;        // (R, D): its key rows of the kv head
  const bf16* v;        // (R, D)
  const bf16* dout;     // (Sq, D)
  const float* lse;     // (Sq)
  const float* delta;   // (Sq)
  const float* kpm;     // (Sk): its batch row's key mask, with KPM
  void* dk;             // (R, D) rows of the output, bf16 or fp32
  void* dv;
  int fp32_out;         // 1: dk, dv are fp32 (per-q-head partials)
  int k0;               // the first key index of the CTA
  int D, bh;
  float sm_scale;
  // where given (K16's measurement), the body adds the cells it sums
  // again; left out (null) by the kernels that count none
  unsigned long long* tally;
};

// query rows per staged chunk for a walk of tiles of `rows` query rows
__host__ __device__ inline int dkv_chunk(int rows) {
  return rows < kDkvChunk ? rows : kDkvChunk;
}

// shared bytes of the dk/dv body: K and V rows, and the ring of Q and dO
// chunks with their lse and delta
inline size_t mma_dkv_smem(int R, int rows, int D) {
  const size_t ch = dkv_chunk(rows);
  const size_t ld = pad16(D) + kPadCols;
  return sizeof(bf16) * (2 * R + kDkvStages * 2 * ch) * ld +
         sizeof(float) * kDkvStages * 2 * ch + (size_t)(R / 16) * kRedoBytes;
}

// whether the backward bodies' loads or stores would be misaligned:
// 16-byte rows of q, k, v, do (and the outputs), the key mask's and the
// additive mask's 8-byte pairs
inline bool dkv_misaligned(const void* q, const void* k, const void* v,
                           const void* dout, const void* dk, const void* dv,
                           const void* kpm, const void* am = nullptr) {
  auto off = [](const void* p, uintptr_t a) {
    return reinterpret_cast<uintptr_t>(p) % a != 0;
  };
  return off(q, 16) || off(k, 16) || off(v, 16) || off(dout, 16) ||
         off(dk, 16) || off(dv, 16) || (kpm != nullptr && off(kpm, 8)) ||
         (am != nullptr && off(am, 8));
}

// one fp32 value into shared memory (lse, delta), asynchronously
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

// ordered_dot's two sums a0 . b0 and a1 . b1 over shared bf16 rows at
// once, each one term at a time in the plain versions' order, in two
// independent chains. Out of line, as ordered_dot.
__device__ __noinline__ float2 ordered_dot2(const bf16* a0, const bf16* b0,
                                            const bf16* a1, const bf16* b1,
                                            int D) {
  float s0 = 0.f, s1 = 0.f;
#pragma unroll 1
  for (int d = 0; d < D; d += 8) {
    const uint4 x0 = *reinterpret_cast<const uint4*>(a0 + d);
    const uint4 y0 = *reinterpret_cast<const uint4*>(b0 + d);
    const uint4 x1 = *reinterpret_cast<const uint4*>(a1 + d);
    const uint4 y1 = *reinterpret_cast<const uint4*>(b1 + d);
    const uint32_t xw0[4] = {x0.x, x0.y, x0.z, x0.w};
    const uint32_t yw0[4] = {y0.x, y0.y, y0.z, y0.w};
    const uint32_t xw1[4] = {x1.x, x1.y, x1.z, x1.w};
    const uint32_t yw1[4] = {y1.x, y1.y, y1.z, y1.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 a = bf16x2_to_float2(xw0[i]), b = bf16x2_to_float2(yw0[i]);
      const float2 c = bf16x2_to_float2(xw1[i]), e = bf16x2_to_float2(yw1[i]);
      s0 = fmaf(a.x, b.x, s0);
      s1 = fmaf(c.x, e.x, s1);
      s0 = fmaf(a.y, b.y, s0);
      s1 = fmaf(c.y, e.y, s1);
    }
  }
  return make_float2(s0, s1);
}

// ud of the derivation above: how far ds may sit from the plain
// versions' ds, in its fp32 ulps, from up (p's), the cell's dp term
// (0 where the cell is dropped or its dp is exactly 0) and |t|
__device__ __forceinline__ float ds_ulps(float up, float dterm, float ta) {
  return fmaf(2.f, up, 8.f) + (dterm > 0.f ? dterm / ta : 0.f);
}

// A warp's cells at stake, summed again 32 a round, one a lane: the set
// bits of each lane's `redo` (cell numbers below 32) are numbered across
// the warp, lane by lane, and cell n of a round goes to lane n % 32.
// sum(ol, i) gives the two ordered sums of lane ol's cell i on the lane
// that takes it; apply(i, sums) hands them back to the lane that owns the
// cell. `cell` and `sums` are the warp's 32-entry shared buffers. Where
// `tally` is given, lane 0 adds the warp's count of cells to it.
template <typename Sum, typename Apply>
__device__ __forceinline__ void resum_spread(uint32_t redo, int lane,
                                             int* cell, float2* sums,
                                             unsigned long long* tally,
                                             const Sum& sum,
                                             const Apply& apply) {
  const int cnt = __popc(redo);
  int off = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, off, o);
    if (lane >= o) off += y;
  }
  const int total = __shfl_sync(0xffffffffu, off, 31);
  if (tally != nullptr && lane == 0 && total > 0)
    atomicAdd(tally, (unsigned long long)total);
  off -= cnt;
#pragma unroll 1
  for (int base = 0; base < total; base += 32) {
    int n0 = off;
    for (uint32_t w = redo; w != 0u; w &= w - 1u, ++n0)
      if (n0 >= base && n0 < base + 32)
        cell[n0 - base] = lane << 5 | (__ffs((int)w) - 1);
    __syncwarp();
    if (base + lane < total) {
      const int c = cell[lane];
      sums[lane] = sum(c >> 5, c & 31);
    }
    __syncwarp();
    n0 = off;
    for (uint32_t w = redo; w != 0u; w &= w - 1u, ++n0)
      if (n0 >= base && n0 < base + 32)
        apply(__ffs((int)w) - 1, sums[n0 - base]);
    __syncwarp();
  }
}

// Walk: n() tiles, tile(t) = (first query, kind bits), rows() query rows
// per tile (16, 32, 64, 128); with AM, mask(t) the tile's additive fp32
// mask at its first query and the CTA's first key (query stride
// mask_ld()). CH = dkv_chunk(rows()); DMAX: 64 or 128; Rule: the
// kernel's softmax rule (mma_fwd.cuh; its kGuard and kValid).
template <int CH, int DMAX, bool KPM, bool BAND, typename Rule,
          bool AM = false, typename Walk, typename BandT>
__device__ __forceinline__ void mma_dkv_body(const DkvRows& a,
                                             const Walk& walk,
                                             const BandT& bd,
                                             const Dropout& dr) {
  constexpr int NT = CH / 8;        // 8-query score tiles per warp
  constexpr int NG = CH / 16;       // 16-query groups (mma k-steps)
  constexpr int KD = DMAX / 16;     // 16-wide steps over the head dim
  extern __shared__ __align__(16) unsigned char dkv_shared[];
  const int D = a.D;
  const int Dp = pad16(D);
  const int nkd = Dp / 16;
  const int ld = Dp + kPadCols;
  const int R = blockDim.x / 2;     // 16 key rows per warp of 32 lanes
  bf16* ks = reinterpret_cast<bf16*>(dkv_shared);
  bf16* vs = ks + R * ld;
  bf16* ring = vs + R * ld;
  // a slot: CH Q rows, CH dO rows, then CH lse and CH delta (fp32)
  const int stage = 2 * CH * ld + 4 * CH;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int wk0 = a.k0 + warp * 16;  // the warp's first key index
  int* redo_cell = reinterpret_cast<int*>(
      reinterpret_cast<unsigned char*>(ring + kDkvStages * stage) +
      warp * kRedoBytes);
  float2* redo_sum = reinterpret_cast<float2*>(redo_cell + 32);
  const int n = walk.n();
  const int nch = walk.rows() / CH;

  // whether chunk c of tile tr holds a kept cell of the CTA's keys
  auto live_chunk = [&](int2 tr, int c) {
    const int qa = tr.x + c * CH, qb = qa + CH - 1;
    if ((tr.y & kKindCausal) && qb < a.k0) return false;
    if constexpr (BAND) {
      if ((tr.y & kKindBand) && !bd.any(qa, qb, a.k0, a.k0 + R - 1))
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

  // the producer: Q, dO, lse and delta of the next live chunk
  int ft = 0, fc = 0;
  next_live(ft, fc);
  auto issue = [&](int slot) {
    if (ft < n) {
      const int q0 = walk.tile(ft).x + fc * CH;
      bf16* qd = ring + slot * stage;
      stage_rows_async(qd, ld, a.q + (size_t)q0 * D, CH, D);
      stage_rows_async(qd + CH * ld, ld, a.dout + (size_t)q0 * D, CH, D);
      float* ls = reinterpret_cast<float*>(qd + 2 * CH * ld);
      for (int i = threadIdx.x; i < 2 * CH; i += blockDim.x)
        cp_async4(ls + i, i < CH ? a.lse + q0 + i : a.delta + q0 + i - CH);
      ++fc;
      next_live(ft, fc);
    }
    cp_async_commit();
  };

  zero_tail(ks, ld, 2 * R, D, Dp);     // K and V rows are contiguous
  for (int s = 0; s < kDkvStages; ++s)
    zero_tail(ring + s * stage, ld, 2 * CH, D, Dp);
  stage_rows_async(ks, ld, a.k, R, D);
  stage_rows_async(vs, ld, a.v, R, D);
#pragma unroll
  for (int i = 0; i < kDkvAhead; ++i) issue(i);  // group 0 holds K, V too
  cp_async_wait<kDkvAhead - 1>();
  __syncthreads();

  // A operands: the warp's 16 K (V) rows, 16 of the head dim per step,
  // read from shared memory at each step (held in registers they leave
  // the compiler less room, and the body ran slower)
  const int arow = (warp * 16 + (lane & 15)) * ld + (lane >> 4) * 8;
  float km[2] = {0.f, 0.f};   // the key mask of this lane's two keys
  if constexpr (KPM) {
    km[0] = a.kpm[wk0 + g];
    km[1] = a.kpm[wk0 + g + 8];
  }

  int step = 0;
  auto advance = [&]() {
    cp_async_wait<kDkvAhead - 1>();
    __syncthreads();
    issue((step + kDkvAhead) % kDkvStages);
    return ring + (step++ % kDkvStages) * stage;
  };

  float acck[DMAX / 8][4], accv[DMAX / 8][4];
#pragma unroll
  for (int j = 0; j < DMAX / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acck[j][e] = accv[j][e] = 0.f;
  // ldmatrix row and column of this lane: Q and dO as B columns (S^T,
  // dP^T), and as B rows transposed on the load (dV, dK)
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
    const int q0 = tr.x + cc * CH, kind = tr.y;
    const bf16* qch = advance();
    const bf16* dch = qch + CH * ld;
    const float* ls = reinterpret_cast<const float*>(dch + CH * ld);
    const float* dl = ls + CH;
    // AM: the mask at the chunk's first query and this lane's key wk0 + g
    // (key + 8 lies 8 past it, query + 1 mld past it)
    const float* amr = nullptr;
    int mld = 0;
    if constexpr (AM) {
      mld = walk.mask_ld();
      amr = walk.mask(ct) + (size_t)cc * CH * mld + warp * 16 + g;
    }
    // bit j: whether the warp's keys keep a cell of queries 16j..16j+15
    unsigned live = (1u << NG) - 1u;
    if (kind & kKindCausal) {
#pragma unroll
      for (int j = 0; j < NG; ++j)
        if (q0 + 16 * j + 15 < wk0) live &= ~(1u << j);
    }
    if constexpr (BAND) {
      if (kind & kKindBand) {
#pragma unroll
        for (int j = 0; j < NG; ++j)
          if (!bd.any(q0 + 16 * j, q0 + 16 * j + 15, wk0, wk0 + 15))
            live &= ~(1u << j);
      }
    }
    if (live != 0u) {
      // S^T = K Q^T and dP^T = V dO^T beside sum_d |k_d q_d| and
      // sum_d |v_d do_d|, whose max over this lane's cells of a key row
      // bounds the error of each of its sums
      float s[NT][4], dpv[NT][4];
      float bs[2] = {0.f, 0.f}, bd2[2] = {0.f, 0.f};
      // bit 4j + e: cell (j, e)'s sum_d |v_d do_d| is 0, so every term of
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
            uint32_t A[4], Av[4];
            ldsm_x4(A, ks + arow + kd * 16);
            ldsm_x4(Av, vs + arow + kd * 16);
            const int boff = (j * 16 + brow) * ld + kd * 16 + bcol;
            uint32_t b[4], aa[4];
            float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
            ldsm_x4(b, qch + boff);
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
            ldsm_x4(b, dch + boff);
            mma_bf16(t0, Av, b[0], b[1]);
            mma_bf16(t1, Av, b[2], b[3]);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              dpv[2 * j][e] += t0[e];
              dpv[2 * j + 1][e] += t1[e];
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) aa[i] = abs_bf16x2(Av[i]);
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

      // this lane's cells: keys wk0 + g (e < 2) and wk0 + g + 8 (e >= 2),
      // queries q0 + 8j + 2tq + (e & 1); pd into s, ds into dpv
      float us[2], ud[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        us[r] = 16777216.f * kSumErr * sq * bs[r] * a.sm_scale;
        ud[r] = 16777216.f * kSumErr * sq * bd2[r] * inv;
      }
      auto score = [&](float raw, int r, float am) {
        const float x = __fmul_rn(raw, a.sm_scale);
        const float y = KPM ? __fadd_rn(x, km[r]) : x;
        return AM ? __fadd_rn(y, am) : y;
      };
      // whether the cell (query qi, key ki) of score tile j is masked:
      // its group skipped, the causal clip, the band
      auto masked = [&](int j, int qi, int ki) {
        bool m = !((live >> (j >> 1)) & 1u) ||
                 ((kind & kKindCausal) && qi < ki);
        if constexpr (BAND)
          m = m || ((kind & kKindBand) && !bd.keep(qi, ki));
        return m;
      };
      // the flags are set without a branch: a branch per cell costs
      // more than the arithmetic it skips
      uint32_t redo = 0u;
      const float pd_ulps = dr.on ? 2.f : 0.f;   // pd = p / (1 - rate)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int qc = 8 * j + 2 * tq;
        const float2 lq = *reinterpret_cast<const float2*>(ls + qc);
        const float2 dq = *reinterpret_cast<const float2*>(dl + qc);
        // up's part of each query: 4 |lse| + 4 (AM: 8 |lse| + 4)
        constexpr float kLse = AM ? 8.f : 4.f;
        const float2 lu = make_float2(fmaf(kLse, fabsf(lq.x), 4.f),
                                      fmaf(kLse, fabsf(lq.y), 4.f));
        // AM: cell e's mask value, query qc + (e & 1), key g + 8 (e >> 1)
        float av[4] = {0.f, 0.f, 0.f, 0.f};
        if constexpr (AM) {
          const float* m0 = amr + qc * mld;
          av[0] = m0[0];
          av[1] = m0[mld];
          av[2] = m0[8];
          av[3] = m0[mld + 8];
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int qi = q0 + qc + (e & 1), ki = wk0 + g + 8 * r;
          const float lse_q = (e & 1) ? lq.y : lq.x;
          const float dlt = (e & 1) ? dq.y : dq.x;
          const float x =
              masked(j, qi, ki) ? kNegInf : score(s[j][e], r, av[e]);
          const float arg = x - lse_q;
          // ex2.approx here; the plain versions' expf where a rounding
          // is at stake
          const float p =
              (!Rule::kGuard || x > Rule::kValid) ? __expf(arg) : 0.f;
          float dp = dpv[j][e], pd = p;
          bool kept = true;
          if (dr.on) {
            kept = dr.keep(a.bh, qi, ki);
            pd = kept ? p * dr.inv_keep : 0.f;
            dp = kept ? dp * dr.inv_keep : 0.f;
          }
          const float t = dp - dlt, ta = fabsf(t);
          const float ds = p * t;
          float up = us[r] + ((e & 1) ? lu.y : lu.x) +
                     (AM ? 13.25f : 9.25f) * fabsf(arg);
          if constexpr (AM) up = fmaf(4.f, fabsf(av[e]), up);
          // dp's part of ud (t = 0 makes it infinite: at stake)
          const float dterm = kept && !((dzero >> (4 * j + e)) & 1u)
                                  ? ud[r] + (dr.on ? 2.f * fabsf(dp) : 0.f)
                                  : 0.f;
          const bool tie =
              (p != 0.f) & (near_bf16_tie(pd, up + pd_ulps) |
                            near_bf16_tie(ds, ds_ulps(up, dterm, ta)));
          redo |= (uint32_t)tie << (4 * j + e);
          s[j][e] = pd;
          dpv[j][e] = ds;
        }
      }
      // the cells at stake, summed again in the plain versions' order
      // from the staged rows; put(x, i, v): x[i / 4][i % 4] = v in
      // registers for an i known only at run time
      auto put = [&](float(&x)[NT][4], int idx, float v) {
        const int jj = idx >> 2, e = idx & 3;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if (j == jj) {
            x[j][0] = e == 0 ? v : x[j][0];
            x[j][1] = e == 1 ? v : x[j][1];
            x[j][2] = e == 2 ? v : x[j][2];
            x[j][3] = e == 3 ? v : x[j][3];
          }
        }
      };
      // cell i's pd and ds from its score and dp summed in their order
      auto exact = [&](int i, float raw, float dp) {
        const int qc = 8 * (i >> 2) + 2 * tq + (i & 1), r = (i & 3) >> 1;
        const int qi = q0 + qc, ki = wk0 + g + 8 * r;
        const float x = masked(i >> 2, qi, ki)
                            ? kNegInf
                            : score(raw, r, AM ? amr[qc * mld + 8 * r] : 0.f);
        const float p =
            (!Rule::kGuard || x > Rule::kValid) ? expf(x - ls[qc]) : 0.f;
        float pd = p;
        if (dr.on) {
          const bool kept = dr.keep(a.bh, qi, ki);
          pd = kept ? p * dr.inv_keep : 0.f;
          dp = kept ? dp * dr.inv_keep : 0.f;
        }
        put(s, i, pd);
        put(dpv, i, p * (dp - dl[qc]));
      };
      // the warp's cells at stake, spread over its lanes
      resum_spread(
          redo, lane, redo_cell, redo_sum, a.tally,
          [&](int ol, int i) {
            const int qr = (8 * (i >> 2) + 2 * (ol & 3) + (i & 1)) * ld;
            const int kr = (warp * 16 + (ol >> 2) + 8 * ((i & 3) >> 1)) * ld;
            return ordered_dot2(qch + qr, ks + kr, dch + qr, vs + kr, D);
          },
          [&](int i, float2 sd) { exact(i, sd.x, sd.y); });

      // dV += Pd^T dO and dK += dS^T Q, Pd^T and dS^T rounded to bf16 in
      // registers
#pragma unroll
      for (int kk = 0; kk < NG; ++kk) {
        if (!((live >> kk) & 1u)) continue;
        const uint32_t pa[4] = {
            pack_bf16(s[2 * kk][0], s[2 * kk][1]),
            pack_bf16(s[2 * kk][2], s[2 * kk][3]),
            pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        const uint32_t da[4] = {
            pack_bf16(dpv[2 * kk][0], dpv[2 * kk][1]),
            pack_bf16(dpv[2 * kk][2], dpv[2 * kk][3]),
            pack_bf16(dpv[2 * kk + 1][0], dpv[2 * kk + 1][1]),
            pack_bf16(dpv[2 * kk + 1][2], dpv[2 * kk + 1][3])};
#pragma unroll
        for (int dp = 0; dp < KD; ++dp) {
          if (dp < nkd) {
            const int toff = (kk * 16 + trow) * ld + dp * 16 + tcol;
            uint32_t b[4];
            ldsm_x4_t(b, dch + toff);
            mma_bf16(accv[2 * dp], pa, b[0], b[1]);
            mma_bf16(accv[2 * dp + 1], pa, b[2], b[3]);
            ldsm_x4_t(b, qch + toff);
            mma_bf16(acck[2 * dp], da, b[0], b[1]);
            mma_bf16(acck[2 * dp + 1], da, b[2], b[3]);
          }
        }
      }
    }
    ++cc;
    next_live(ct, cc);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const size_t row = (size_t)(warp * 16 + g + 8 * r) * D;
#pragma unroll
    for (int j = 0; j < DMAX / 8; ++j) {
      if (8 * j < D) {
        const size_t at = row + 8 * j + 2 * tq;
        const float k0 = acck[j][2 * r] * a.sm_scale;
        const float k1 = acck[j][2 * r + 1] * a.sm_scale;
        if (a.fp32_out) {
          *reinterpret_cast<float2*>(static_cast<float*>(a.dk) + at) =
              make_float2(k0, k1);
          *reinterpret_cast<float2*>(static_cast<float*>(a.dv) + at) =
              make_float2(accv[j][2 * r], accv[j][2 * r + 1]);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(a.dk) +
                                             at) =
              __floats2bfloat162_rn(k0, k1);
          *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(a.dv) +
                                             at) =
              __floats2bfloat162_rn(accv[j][2 * r], accv[j][2 * r + 1]);
        }
      }
    }
  }
}

}  // namespace
