// The bf16 forward body of K1 (masked_flash.cu), K5 (flash.cu), K8
// (blocksparse_v2.cu) and K14 (blocksparse.cu) on the tensor cores: one
// online-softmax walk over key tiles of W keys for a CTA of 16 query rows
// per warp, on mma_tiles.cuh's fragments.
//
// A CTA owns R = 16 * warps query rows of one walk (one block row of
// K1's mask, one query block of K5, one block row of K8's or K14's
// layout), R = min(block rows, 64). Each warp
// keeps its 16 rows' Q fragments, the tile's scores (then P) and the O
// accumulator in registers; the row max and sum run over the quad that
// holds a fragment row. K and V stream through a ring of shared chunks
// of CH = min(W, 64) keys in bf16, loaded with cp.async, kAhead chunks
// in flight ahead of the one computing, one barrier per chunk. Per
// walked tile: the K chunks (S = Q K^T, each 16-wide step an mma from
// zero whose partial is added in fp32), the online softmax of the whole
// tile (the running max moves once per tile), then the V chunks (O =
// O * alpha + P V, P rounded to bf16 first).
//
// The function is the CUDA-core bodies' (masked_flash.cu, flash.cu,
// blocksparse_v2.cu, blocksparse.cu): s = (q.k) * sm_scale, + kpm[key],
// then with AM + the walk's additive mask cell (K8's tile, K14's (S, S)
// mask read in place), each rounded in fp32; then the causal clip of a
// CAUSAL tile and the band predicate of a BAND tile set NEG_INF. The
// kernel's Rule sets the rest: with a threshold (K1 -1e28, K8 -1e29, K14
// -1e28) a cell at or below it has p = 0, else (K5) p = exp(s - m_new);
// a row with l == 0 writes o = 0 and lse = NEG_INF (K1) or m + log(1) =
// m (K5, K8, K14: NEG_INF too for a row that walks no tile). A running
// max at or below the threshold leaves every p of its row 0, so K1's
// m_safe changes no p and the body needs none. l sums the unrounded,
// undropped p; dropout drops p after it, keyed on (bh, q, k) from the
// fragment's coordinates; o = acc / l, then scaled by 1/(1-rate).
//
// The rounding of p. The plain versions sum q.k one term at a time in
// fp32 (d = 0, 1, ...), and p rounds to bf16 from their scores: one
// rounding of p that lands on the other side, in a row with a small l,
// moves o past TRAIN_TOL (a plain version fed correctly rounded scores
// fails the same check). So the body holds m and the rounding of p to
// theirs: beside S it takes sum_d |q_d k_d| (the mma of |Q| and |K|),
// which bounds how far its score and theirs can part (eps, below); a
// score that could hold the row's max, or whose p lies within that
// distance of a bf16 rounding midpoint, is summed again in their order
// from the staged Q and K rows (ordered_dot) and its p taken with their
// expf. The others round p as theirs do. The additive mask's sum is one
// more fp32 rounding on the way to p, which both bounds count.
//
// Skips, each leaving every output as the walk without it: a BAND tile
// in which no cell of the CTA's rows is kept (no load, no state change),
// and per warp each 16-key group of a CAUSAL or BAND tile its 16 rows
// keep no cell of (those scores are set by the mask alone, and their
// zero p adds nothing to O).

#pragma once

#include "flash_tiles.cuh"
#include "mma_tiles.cuh"

namespace {

constexpr float kValidThresh = -1e28f;  // masked_flash.VALID_THRESH
constexpr int kKindCausal = 1;          // masked_flash.KIND_CAUSAL
constexpr int kKindBand = 2;            // masked_flash.KIND_BAND
constexpr int kMmaMaxRows = 64;         // query rows a CTA owns, at most
// eps = kSumErr sqrt(D) sum_d |q_d k_d| (u = 2^-24): the two sums part by
// the rounding errors of D fp32 additions of partial sums at most sum_d
// |q_d k_d|, a walk of D steps of at most u of it each (the tensor cores'
// partials of 16 exact products add a few more); 4 u sqrt(D) is 7 times
// that walk's deviation when every partial is that large, and 50 times
// it for random signs. Each other fp32 rounding on the way to p (the
// scale, the key mask, x - m) counts kSumErr of its value.
constexpr float kSumErr = 4.f / 16777216.f;

// The softmax rule of a kernel on this body and of its backward on the
// dq and dk/dv bodies (mma_dq.cuh, mma_dkv.cuh: kGuard and kValid): with
// kGuard, p = 0 for a score at or below kValid; with kEmptyNegInf, a row
// with l == 0 writes lse = NEG_INF, else m + log(1).
struct MaskedFlashRule {                 // K1, K2, K3
  static constexpr bool kGuard = true;
  static constexpr float kValid = kValidThresh;
  static constexpr bool kEmptyNegInf = true;
};
struct FlashRule {                       // K5, K6, K7
  static constexpr bool kGuard = false;
  static constexpr float kValid = 0.f;
  static constexpr bool kEmptyNegInf = false;
};
struct RowRunRule {                      // K8, K9, K10
  static constexpr bool kGuard = true;
  static constexpr float kValid = -1e29f;  // blocksparse_v2.VALID_THRESH
  static constexpr bool kEmptyNegInf = false;
};
struct TripleRule {                      // K14, K15, K16
  static constexpr bool kGuard = true;
  static constexpr float kValid = -1e28f;  // blocksparse.VALID_THRESH
  static constexpr bool kEmptyNegInf = false;
};

// chunks in flight; the ring holds them beside a tile's K chunks, which
// stay until its softmax (which may sum scores again from them) is done
constexpr int kAhead = 3;
template <int NC>
__host__ __device__ constexpr int ring_stages() {
  return NC + kAhead;
}

// the walk without a band (K5, and K1's BAND = false instantiations)
struct NoBand {
  __device__ __forceinline__ bool keep(int, int) const { return true; }
  __device__ __forceinline__ bool any(int, int, int, int) const {
    return true;
  }
};

// one CTA's operands, already offset to its rows and its kv head
struct FwdRows {
  const bf16* q;      // (R, D): the CTA's query rows
  const bf16* k;      // (Sk, D): its kv head's keys
  const bf16* v;      // (Sk, D)
  const float* kpm;   // (Sk): its batch row's key mask, with KPM
  bf16* o;            // (R, D)
  float* lse;         // (R)
  int r0;             // the first query index of the CTA
  int D, bh;
  float sm_scale;
};

// the second __launch_bounds__ argument of a forward kernel's CTAs of 2 *
// kMmaMaxRows threads: 3 to an SM, at most 168 registers. At W 16 a CTA
// is one warp, which the SM's registers bound: at 128 registers 16 fit,
// at 130 (allocated as 136) 15, so without the mask (AM), where the body
// sits at that edge, 4 (128 registers) keep the 16.
__host__ __device__ constexpr int mma_fwd_min_ctas(int W, int DMAX,
                                                   bool AM) {
  return W == 16 && DMAX == 64 && !AM ? 4 : 3;
}

// the rows a CTA of the forward body owns for walk blocks of `rows`
__host__ __device__ inline int mma_rows(int rows) {
  return rows < kMmaMaxRows ? rows : kMmaMaxRows;
}

// shared bytes of the forward body: Q rows and the K/V ring
inline size_t mma_fwd_smem(int R, int W, int D) {
  const int ch = W < 64 ? W : 64;
  const int stages = W / ch == 1 ? ring_stages<1>() : ring_stages<2>();
  return sizeof(bf16) * (size_t)(R + stages * ch) * (pad16(D) + kPadCols);
}

// whether the body's loads would be misaligned: 16-byte rows (D % 8 ==
// 0) need 16-byte aligned bases, the key mask's and the additive mask's
// pairs 8-byte ones
inline bool fwd_misaligned(const void* q, const void* k, const void* v,
                           const void* o, const void* kpm,
                           const void* am = nullptr) {
  auto off = [](const void* p, uintptr_t a) {
    return reinterpret_cast<uintptr_t>(p) % a != 0;
  };
  return off(q, 16) || off(k, 16) || off(v, 16) || off(o, 16) ||
         (kpm != nullptr && off(kpm, 8)) || (am != nullptr && off(am, 8));
}

// sum_d q[d] k[d] over shared bf16 rows, one term at a time in the
// plain versions' order (d = 0, 1, ...; each product is exact in fp32),
// 8 values per shared load. Out of line: it runs for few scores, and
// inlined at its two call sites it makes the widest bodies spill.
__device__ __noinline__ float ordered_dot(const bf16* q, const bf16* k,
                                          int D) {
  float acc = 0.f;
#pragma unroll 1
  for (int d = 0; d < D; d += 8) {
    const uint4 qv = *reinterpret_cast<const uint4*>(q + d);
    const uint4 kv = *reinterpret_cast<const uint4*>(k + d);
    const uint32_t qw[4] = {qv.x, qv.y, qv.z, qv.w};
    const uint32_t kw[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 a = bf16x2_to_float2(qw[i]);
      const float2 b = bf16x2_to_float2(kw[i]);
      acc = fmaf(a.x, b.x, acc);
      acc = fmaf(a.y, b.y, acc);
    }
  }
  return acc;
}

// Walk: n() tiles, tile(t) = (first key, kind bits); with AM, mask(t)
// the tile's additive fp32 mask at the CTA's first row (row stride
// mask_ld(), even, 8-byte aligned). W: keys per tile (16, 32, 64, 128);
// DMAX: 64 or 128, head dims up to it; Rule: the kernel's softmax rule.
template <int W, int DMAX, bool KPM, bool BAND, bool AM, typename Rule,
          typename Walk, typename BandT>
__device__ __forceinline__ void mma_fwd_body(const FwdRows& a,
                                             const Walk& walk,
                                             const BandT& bd,
                                             const Dropout& dr) {
  constexpr int CH = W < 64 ? W : 64;   // keys per staged chunk
  constexpr int NC = W / CH;            // K (and V) chunks per tile
  constexpr int NT = W / 8;             // 8-key score tiles per warp
  constexpr int KD = DMAX / 16;         // 16-wide steps over the head dim
  constexpr int kStages = ring_stages<NC>();
  // Q's fragments (and |Q|'s) in registers, but at W 128 and DMAX 128
  // (whose scores and accumulator alone hold 128 registers) read again
  // from shared memory at each step
  constexpr bool QREG = W * DMAX < 128 * 128;
  extern __shared__ __align__(16) unsigned char mma_smem[];
  const int D = a.D;
  const int Dp = pad16(D);
  const int nkd = Dp / 16;
  const int ld = Dp + kPadCols;
  const int R = blockDim.x / 2;         // 16 rows per warp of 32 lanes
  bf16* qs = reinterpret_cast<bf16*>(mma_smem);
  bf16* ring = qs + R * ld;
  const int stage = CH * ld;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int wr0 = a.r0 + warp * 16;     // the warp's first query index
  const int n = walk.n();

  // BAND: whether any cell of the CTA's rows in tile t is kept
  auto next_live = [&](int t) {
    if constexpr (BAND) {
      for (; t < n; ++t) {
        const int2 tr = walk.tile(t);
        if (!(tr.y & kKindBand) ||
            bd.any(a.r0, a.r0 + R - 1, tr.x, tr.x + W - 1))
          break;
      }
    }
    return t;
  };

  // the producer: chunk fj of live tile ft (K chunks, then V chunks)
  int ft = next_live(0), fj = 0;
  auto issue = [&](int slot) {
    if (ft < n) {
      const int k0 = walk.tile(ft).x + (fj % NC) * CH;
      stage_rows_async(ring + slot * stage, ld,
                       (fj < NC ? a.k : a.v) + (size_t)k0 * D, CH, D);
      if (++fj == 2 * NC) {
        fj = 0;
        ft = next_live(ft + 1);
      }
    }
    cp_async_commit();
  };

  zero_tail(qs, ld, R, D, Dp);
  zero_tail(ring, ld, kStages * CH, D, Dp);
  stage_rows_async(qs, ld, a.q, R, D);
#pragma unroll
  for (int i = 0; i < kAhead; ++i) issue(i);   // group 0 holds Q too
  cp_async_wait<kAhead - 1>();
  __syncthreads();
  const bf16* qrow = qs + (warp * 16 + (lane & 15)) * ld + (lane >> 4) * 8;
  uint32_t qf[QREG ? KD : 1][4], qabs[QREG ? KD : 1][4];
  if constexpr (QREG) {
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      qf[kd][0] = qf[kd][1] = qf[kd][2] = qf[kd][3] = 0u;
      if (kd < nkd) ldsm_x4(qf[kd], qrow + kd * 16);
#pragma unroll
      for (int i = 0; i < 4; ++i) qabs[kd][i] = abs_bf16x2(qf[kd][i]);
    }
  }

  // chunk `step` has landed and every warp is done with the chunk whose
  // slot takes chunk step + kAhead
  int step = 0;
  auto advance = [&]() {
    cp_async_wait<kAhead - 1>();
    __syncthreads();
    issue((step + kAhead) % kStages);
    return ring + (step++ % kStages) * stage;
  };

  float acc[DMAX / 8][4];
#pragma unroll
  for (int j = 0; j < DMAX / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
  // ldmatrix row and column of this lane: K (keys as B columns) and V
  // (keys as B rows, transposed on the load)
  const int krow = (lane & 7) + ((lane >> 4) << 3);
  const int kcol = ((lane >> 3) & 1) * 8;
  const int vrow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int vcol = (lane >> 4) * 8;

  for (int t = next_live(0); t < n; t = next_live(t + 1)) {
    const int2 tr = walk.tile(t);
    const int k0 = tr.x, kind = tr.y;
    // AM: this lane's mask row (row g; row g + 8 lies 8 * mld past it)
    const float* amr = nullptr;
    int mld = 0;
    if constexpr (AM) {
      mld = walk.mask_ld();
      amr = walk.mask(t) + (warp * 16 + g) * mld + 2 * tq;
    }
    // BAND: bit j, whether the warp's rows keep a cell of keys 16j..16j+15
    // CAUSAL: the groups past the warp's last row hold no kept cell
    unsigned live = ~0u;
    if (kind & kKindCausal) {
      const int n16 = (wr0 + 16 - k0 + 15) / 16;
      live = n16 <= 0 ? 0u : n16 >= 32 ? ~0u : (1u << n16) - 1u;
    }
    if constexpr (BAND) {
      if (kind & kKindBand) {
        unsigned band = 0u;
#pragma unroll
        for (int j = 0; j < W / 16; ++j)
          if (bd.any(wr0, wr0 + 15, k0 + 16 * j, k0 + 16 * j + 15))
            band |= 1u << j;
        live &= band;
      }
    }
    // S = Q K^T: per 16-wide step an mma from zero, the partials added
    // in fp32; beside it sum_d |q_d k_d| (the mma of |Q| and |K|), whose
    // max over this lane's keys bounds the error of each of its scores
    float s[NT][4];
    float bnd[2] = {0.f, 0.f};
    const bf16* kch[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const bf16* ks = advance();
      kch[c] = ks;
#pragma unroll
      for (int np = 0; np < CH / 16; ++np) {
        const int j = c * (CH / 16) + np;
        float u0[4] = {0.f, 0.f, 0.f, 0.f}, u1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int e = 0; e < 4; ++e) s[2 * j][e] = s[2 * j + 1][e] = 0.f;
        if (!((live >> j) & 1u)) continue;
#pragma unroll
        for (int kd = 0; kd < KD; ++kd) {
          if (kd < nkd) {
            uint32_t b[4], qa[4];
            ldsm_x4(b, ks + (np * 16 + krow) * ld + kd * 16 + kcol);
            if constexpr (!QREG) ldsm_x4(qa, qrow + kd * 16);
            const uint32_t(&a)[4] = QREG ? qf[QREG ? kd : 0] : qa;
            float t0[4] = {0.f, 0.f, 0.f, 0.f};
            float t1[4] = {0.f, 0.f, 0.f, 0.f};
            mma_bf16(t0, a, b[0], b[1]);
            mma_bf16(t1, a, b[2], b[3]);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              s[2 * j][e] += t0[e];
              s[2 * j + 1][e] += t1[e];
            }
            uint32_t qa_abs[4];
            if constexpr (!QREG)
#pragma unroll
              for (int i = 0; i < 4; ++i) qa_abs[i] = abs_bf16x2(qa[i]);
            const uint32_t(&aa)[4] = QREG ? qabs[QREG ? kd : 0] : qa_abs;
            mma_bf16(u0, aa, abs_bf16x2(b[0]), abs_bf16x2(b[1]));
            mma_bf16(u1, aa, abs_bf16x2(b[2]), abs_bf16x2(b[3]));
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r)
          bnd[r] = fmaxf(bnd[r], fmaxf(fmaxf(u0[2 * r], u0[2 * r + 1]),
                                       fmaxf(u1[2 * r], u1[2 * r + 1])));
      }
    }

    // the online softmax of the tile: this lane's rows wr0 + g (e < 2)
    // and wr0 + g + 8 (e >= 2), keys k0 + 8j + 2tq + (e & 1)
    auto score = [&](float raw, float km, float am) {
      const float x = __fmul_rn(raw, a.sm_scale);
      const float y = KPM ? __fadd_rn(x, km) : x;
      return AM ? __fadd_rn(y, am) : y;
    };
    // AM: the mask's pairs at keys 8j + 2tq of rows g (.x) and g + 8
    auto mask_pair = [&](int j) {
      float4 am = make_float4(0.f, 0.f, 0.f, 0.f);
      if constexpr (AM) {
        const float2 a0 = *reinterpret_cast<const float2*>(amr + 8 * j);
        const float2 a1 =
            *reinterpret_cast<const float2*>(amr + 8 * mld + 8 * j);
        am = make_float4(a0.x, a0.y, a1.x, a1.y);
      }
      return am;
    };
    // score (j, e) summed in the plain versions' order, from the staged
    // Q row and K row, 8 values per shared load
    auto exact_score = [&](int j, int e) {
      const int c = 8 * j / CH;                     // the key's K chunk
      const int kt = 8 * j + 2 * tq + (e & 1);      // the key in the tile
      const bf16* kr = (c == 0 ? kch[0] : kch[NC - 1]) + (kt - c * CH) * ld;
      const bf16* qr = qs + (warp * 16 + g + (e >> 1) * 8) * ld;
      float km = 0.f, am = 0.f;
      if constexpr (KPM) km = a.kpm[k0 + kt];
      if constexpr (AM) am = amr[(e >> 1) * 8 * mld + kt - 2 * tq];
      return score(ordered_dot(qr, kr, D), km, am);
    };
    // s[j][e] = v for a (j, e) known only at run time, in registers
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
    float eps[2];
#pragma unroll
    for (int r = 0; r < 2; ++r)
      eps[r] = kSumErr * sqrtf((float)D) * bnd[r] * a.sm_scale;
    // AM: the largest |mask| of a cell above the threshold, per row
    float amx[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float2 km = make_float2(0.f, 0.f);
      if constexpr (KPM)
        km = *reinterpret_cast<const float2*>(a.kpm + k0 + 8 * j + 2 * tq);
      const float4 am = mask_pair(j);
      const float av[4] = {am.x, am.y, am.z, am.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = score(s[j][e], (e & 1) ? km.y : km.x, av[e]);
        if (AM && s[j][e] > Rule::kValid)
          amx[e >> 1] = fmaxf(amx[e >> 1], fabsf(av[e]));
      }
    }
    if (kind & kKindCausal) {
      // query wr0 + g + 8r drops key k0 + 8j + 2tq + (e & 1) past it
      const int lead = wr0 + g - k0 - 2 * tq;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (lead + (e >> 1) * 8 < 8 * j + (e & 1)) s[j][e] = kNegInf;
    }
    if constexpr (BAND) {
      if (kind & kKindBand) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (!bd.keep(wr0 + g + (e >> 1) * 8,
                         k0 + 8 * j + 2 * tq + (e & 1)))
              s[j][e] = kNegInf;
      }
    }
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < NT * 4; ++i)
      mx[(i & 3) >> 1] = fmaxf(mx[(i & 3) >> 1], s[i >> 2][i & 3]);
    // the row's max: every score within 2 er of the tensor cores' max
    // is summed again (the others lie below the max in either order); er
    // is eps, with AM plus one rounding each of the mask's sum (at the
    // max) and of the sums before it (at most |mask| off the max)
    {
      // (a score below the running max by more than er stays below it)
      uint64_t redo = 0;
      float top[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float qm = quad_max(mx[r]);
        const float er =
            AM ? eps[r] + kSumErr * (fabsf(qm) + amx[r]) : eps[r];
        top[r] = fmaxf(qm - 2.f * er, m_r[r] - er);
      }
      if (mx[0] >= top[0] || mx[1] >= top[1]) {
#pragma unroll
        for (int i = 0; i < NT * 4; ++i) {
          const float x = s[i >> 2][i & 3];
          if (x != kNegInf && x >= top[(i & 3) >> 1]) redo |= 1ull << i;
        }
      }
      if (redo) {
#pragma unroll 1
        for (uint64_t w = redo; w != 0; w &= w - 1) {
          const int i = __ffsll((long long)w) - 1;
          put(i, exact_score(i >> 2, i & 3));
        }
        mx[0] = mx[1] = kNegInf;
#pragma unroll
        for (int i = 0; i < NT * 4; ++i)
          mx[(i & 3) >> 1] = fmaxf(mx[(i & 3) >> 1], s[i >> 2][i & 3]);
      }
    }
    // (with a threshold, a max at or below it leaves every p 0)
    float m_new[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) m_new[r] = fmaxf(m_r[r], quad_max(mx[r]));
    float slack[2];
#pragma unroll
    for (int r = 0; r < 2; ++r)
      slack[r] = 16777216.f * eps[r] + (AM ? 8.f : 4.f) * fabsf(m_new[r]) +
                 4.f;
    uint64_t tie = 0;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float4 am = mask_pair(j);
      const float av[4] = {am.x, am.y, am.z, am.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[j][e];
        const float m = m_new[e >> 1];
        // ex2.approx here; the plain versions' expf where the rounding of
        // p is at stake
        const float p =
            (!Rule::kGuard || x > Rule::kValid) ? __expf(x - m) : 0.f;
        // how far p may sit from theirs, in fp32 ulps of p: 2^24 times
        // the score's error eps, 4 |x| + 4 |x - m| for one more rounding
        // each of the scale, the key mask and x - m, and 4 + 1.25 |x - m|
        // for __expf's and expf's own errors; with |x| <= |m| + (m - x),
        // at most slack + 9.25 (m - x). AM: 4 |x| more for the mask's
        // sum, and 4 |mask| for the sums before it, which may lie that
        // far above |x|: slack + 13.25 (m - x) + 4 |mask|
        float ulps = fmaf(AM ? 13.25f : 9.25f, m - x, slack[e >> 1]);
        if constexpr (AM) ulps = fmaf(4.f, fabsf(av[e]), ulps);
        if (p != 0.f && x != kNegInf && near_bf16_tie(p, ulps))
          tie |= 1ull << (4 * j + e);
        s[j][e] = p;
      }
    }
#pragma unroll 1
    for (uint64_t w = tie; w != 0; w &= w - 1) {
      const int i = __ffsll((long long)w) - 1;
      const float x = exact_score(i >> 2, i & 3);
      put(i, (!Rule::kGuard || x > Rule::kValid)
                 ? expf(x - m_new[(i & 3) >> 1])
                 : 0.f);
    }
#pragma unroll
    for (int i = 0; i < NT * 4; ++i) sum[(i & 3) >> 1] += s[i >> 2][i & 3];
    if (dr.on) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!dr.keep(a.bh, wr0 + g + (e >> 1) * 8,
                       k0 + 8 * j + 2 * tq + (e & 1)))
            s[j][e] = 0.f;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float alpha = expf(m_r[r] - m_new[r]);
      l_r[r] = l_r[r] * alpha + quad_sum(sum[r]);
      m_r[r] = m_new[r];
#pragma unroll
      for (int j = 0; j < DMAX / 8; ++j) {
        acc[j][2 * r] *= alpha;
        acc[j][2 * r + 1] *= alpha;
      }
    }

    // O += P . V, P rounded to bf16 in registers
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const bf16* vs = advance();
#pragma unroll
      for (int kk = 0; kk < CH / 16; ++kk) {
        const int j = c * (CH / 16) + kk;
        if (!((live >> j) & 1u)) continue;
        const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                                pack_bf16(s[2 * j][2], s[2 * j][3]),
                                pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                                pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
        for (int dp = 0; dp < KD; ++dp) {
          if (dp < nkd) {
            uint32_t b[4];
            ldsm_x4_t(b, vs + (kk * 16 + vrow) * ld + dp * 16 + vcol);
            mma_bf16(acc[2 * dp], pa, b[0], b[1]);
            mma_bf16(acc[2 * dp + 1], pa, b[2], b[3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int lr = warp * 16 + g + 8 * r;   // the row within the CTA
    const float l = l_r[r];
    const float ls = l == 0.f ? 1.f : l;
    bf16* orow = a.o + (size_t)lr * D;
#pragma unroll
    for (int j = 0; j < DMAX / 8; ++j) {
      if (8 * j < D) {
        float x0 = acc[j][2 * r] / ls, x1 = acc[j][2 * r + 1] / ls;
        if (dr.on) {
          x0 = x0 * dr.inv_keep;
          x1 = x1 * dr.inv_keep;
        }
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * tq) =
            __floats2bfloat162_rn(x0, x1);
      }
    }
    if (tq == 0) {
      const float m = m_r[r];
      a.lse[lr] = Rule::kEmptyNegInf && l == 0.f ? kNegInf : m + logf(ls);
    }
  }
}

}  // namespace
