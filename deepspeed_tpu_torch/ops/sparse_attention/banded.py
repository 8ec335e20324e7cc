"""Banded block-sparse attention, the kernels K11-K13 (the port of
``deepspeed_tpu/ops/sparse_attention/banded.py``).

A banded layout (BSLongformer-class: a global prefix of rows and of
columns plus a sliding window around the diagonal, optionally clipped
causally) is a closed-form predicate on block indices:

    keep(rb, cb) = (rb < g_r) | (cb < g_c) | (|rb - cb| <= w)
                   [& cb <= rb when causal]

:func:`detect_banded` matches the realized layout bits, not the config
class. The legacy dispatch of ``blocksparse.py`` (``USE_MASKED_FLASH =
False``) runs such a layout here, and :meth:`BlockMask.from_layout` uses
the same detection to coarsen the walk of the masked flash kernels.

The work splits into instances whose walks are uniform (JAX's
``build_banded_impls``), which partition the kept cells exactly:

    fwd/dq  "band"  per q tile: GT global-column steps, then the band
    fwd/dq  "gr"    the GQ q tiles of the g_r global rows, every kv tile
    dkv     "band"  per kv tile: the transposed band walk
    dkv     "gc"    the GT kv tiles of the global columns, rows >= g_r
    dkv     "gr"    every kv tile against the GQ global-row q tiles

Three kernels, each with a wrapper and a plain PyTorch version of the
same function, called once per instance:

- :func:`banded_fwd` — K11, ``o`` and ``lse`` of one instance (replaces
  ``_fwd_body``); in bf16 on the tensor cores, the global-rows ("gr")
  instance split over its kv tiles (:func:`gr_split_plan`);
- :func:`banded_dq` — K12, ``dq`` (replaces ``_dq_body``); in bf16 on
  the tensor cores, the gr instance split over its kv tiles as K11's
  (:func:`fwd_split`);
- :func:`banded_dkv` — K13, ``dk`` and ``dv`` (replaces ``_dkv_body``);
  in bf16 on the tensor cores, the global-columns ("gc") instance split
  over its q tiles (:func:`dkv_split`).

For CUDA tensors each wrapper launches its hand-written kernel in
``csrc/banded.cu`` (built with nvcc for sm_90a at first use) or raises;
it never falls back. For CPU tensors it runs the plain version
(``*_plain``). Each launch adds one to the wrapper's ``launches`` and to
its ``bodies`` under the body it ran (:data:`FWD_BODIES`,
:data:`DQ_BODIES`, :data:`DKV_BODIES`: "mma" in bf16, "fma" in fp32).
:func:`banded_fwd_impl` and :func:`banded_bwd_impl` combine the
instances as JAX does; :func:`build_banded_fn` is the
``torch.autograd.Function`` entry over them.

Semantics (JAX's kernels, rounding included): ``s = (q . k) * sm_scale``,
then ``s += kpm[key]`` (skipped when the key mask is None: JAX adds
zeros), then ``s = NEG_INF`` where the predicate drops a cell; ``p = 0``
where ``s <= VALID_THRESH`` (-1e28 here, not the -1e29 of K8-K10); no
``m_safe``; a row with ``l == 0`` writes ``o = 0`` and ``lse = m``; ``p``
is rounded to V's (K13: do's) dtype before its product and ``ds`` to K's
(K13: q's) dtype; dq and dk are scaled by ``sm_scale`` at the end, dv is
not.

The split of K11's gr instance (bf16 on the card): each split of
``kv_tiles_per_split`` kv tiles walks from a fresh state, and the splits
merge in order (``m = max m_z``, ``l = sum l_z e^(m_z - m)``, ``acc =
sum acc_z e^(m_z - m)``). p rounds to bf16 under its split's running max,
not the whole walk's: ``banded_fwd_plain(kv_tiles_per_split=n)`` walks
so; with None it is JAX's one walk. The splits of K12's gr walk and
K13's gc walk each sum their partial dq (dk and dv) from zero, and the
partials add in split order before dq and dk take ``sm_scale``: dq, dk
and dv are sums with no running max, so that split moves only the fp32
order of a sum, never a bf16 rounding of p or ds.
``banded_dq_plain(kv_tiles_per_split=n)`` and
``banded_dkv_plain(q_tiles_per_split=n)`` sum so; with None each is JAX's
one walk.

The walk tiles: on CPU tensors JAX's interpret-mode rule (the fine block,
halved until it divides S); on the card the (bq, bkv) pair of
``KERNEL_BLOCKS`` with the least modeled cost (:func:`walk_cost`, the
``"banded"`` constants of ``masked_flash.WALK_COSTS``), in place of the
TPU's measured table and its 128-multiple heuristic.
"""

import ctypes
import functools
import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.profiling.flops import counted_flops, uncounted
from deepspeed_tpu_torch.ops._build import arrival_counts
from deepspeed_tpu_torch.ops.attention.flash import ordered_dot as _dot
from deepspeed_tpu_torch.ops.attention.masked_flash import (
    CHUNK, DKV_BODIES, DQ_BODIES, FWD_BODIES, KERNEL_BLOCKS, MAX_HEAD_DIM,
    _check_aligned, _count_body, walk_cost_us)
from deepspeed_tpu_torch.ops.sparse_attention.blocksparse_v2 import \
    _check_tally

__all__ = ["NEG_INF", "VALID_THRESH", "BandedParams", "BandedPlan",
           "detect_banded", "pick_blocks", "walk_stats", "walk_counts",
           "walk_cost", "plan", "walk_split_plan", "gr_split_plan",
           "fwd_split", "dkv_split",
           "banded_fwd", "banded_dq", "banded_dkv", "banded_fwd_plain",
           "banded_dq_plain", "banded_dkv_plain", "banded_fwd_impl",
           "banded_bwd_impl", "build_banded_fn", "reset_launches"]

NEG_INF = -1e30
VALID_THRESH = -1e28     # matches blocksparse.py (several -1e30 may stack)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# test/autotune override for the walk tile sizes; None = pick automatically
_FORCE_BLOCKS: Optional[Tuple[int, int]] = None
# the tensor-core bodies: a CTA owns min(bq, MMA_ROWS) rows of a q tile
# (K11, K12) or min(bkv, MMA_ROWS) key rows of a kv tile (K13)
MMA_ROWS = 64
# walk_split_plan's rule: halve a serial walk's split while its grid has
# fewer than GR_SPLIT_TARGET_WARPS warps (16 rows each) and the halved
# split keeps GR_SPLIT_MIN_KEYS keys (or queries). Phase 26's sweep of
# K11's gr walk on an H100 80GB HBM3 put the best split at 1024 warps at
# the s8k geometry (4 warps a CTA) and at 1024-2048 at sparse BERT's (one
# warp a CTA); its sweeps of K12's gr and K13's gc walks find this rule's
# split the best at sparse BERT's and within 2-10% of the best (2 to 8
# tiles a split, which part by as much from run to run) at s8k
GR_SPLIT_TARGET_WARPS = 1024
GR_SPLIT_MIN_KEYS = 256


class BandedParams(NamedTuple):
    g_r: int      # global ROW prefix, in fine blocks (rows that see all)
    g_c: int      # global COL prefix, in fine blocks (cols all rows see)
    w: int        # band half-width, in fine blocks
    causal: bool  # block-level lower-triangular clip


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def detect_banded(layout: np.ndarray) -> Optional[BandedParams]:
    """Match a (H, nb, nb) 0/1 layout against the global-prefix + band
    predicate. Returns params or None (per-head layouts, non-prefix
    globals, random blocks, fully dense all decline)."""
    L = np.asarray(layout).astype(bool)
    if L.ndim != 3 or L.shape[1] != L.shape[2] or L.shape[1] == 0:
        return None
    l = L[0]
    if not (L == l[None]).all():
        return None
    n = l.shape[0]
    idx = np.arange(n)
    rb, cb = idx[:, None], idx[None, :]
    for causal in (False, True):
        clip = (cb <= rb) if causal else np.ones((n, n), bool)
        # global prefixes: leading rows/cols equal to their clip pattern
        row_full = (l == clip).all(axis=1)
        col_full = (l == clip).all(axis=0)
        g_r = 0
        while g_r < n and row_full[g_r]:
            g_r += 1
        g_c = 0
        while g_c < n and col_full[g_c]:
            g_c += 1
        if g_r >= n:          # fully dense: not a band
            continue
        # infer w from the last row (never a global row here): its
        # non-global cols must be a contiguous run ending at the diagonal
        last = np.nonzero(l[n - 1, g_c:])[0] + g_c
        if len(last) == 0:
            # pure-global layout (no band): declined, as in JAX
            continue
        run = np.arange(int(last.min()), n)
        if len(last) != len(run) or not (last == run).all():
            continue
        w = (n - 1) - int(last.min())
        pred = ((rb < g_r) | (cb < g_c) | (np.abs(rb - cb) <= w)) & clip
        if (pred == l).all():
            return BandedParams(g_r, g_c, w, bool(causal))
    return None


# --------------------------------------------------------------------- #
# walk arithmetic (JAX's, number for number)
# --------------------------------------------------------------------- #
def _blocks_valid(S: int, bq: int, bkv: int, cpu: bool) -> bool:
    """Tiles dividing S; on the card also tiles the kernels take (JAX:
    128-multiples unless ``interpret``, whose part CPU tensors play)."""
    return (S % bq == 0 and S % bkv == 0 and
            (cpu or (bq in KERNEL_BLOCKS and bkv in KERNEL_BLOCKS)))


def _band_extents(S, fb, w, causal, bq, bkv):
    """(bstart, bend, WT): per-q-tile kv-tile range of the band walk —
    the ONE definition shared by the plan's walks and walk_stats' cost
    accounting."""
    NQ = S // bq
    bstart = np.zeros(NQ, np.int32)
    bend = np.zeros(NQ, np.int32)
    for i in range(NQ):
        lo = max(((i * bq) // fb - w) * fb, 0)
        hi = min(((i * bq + bq - 1) // fb + (0 if causal else w)) * fb
                 + fb - 1, S - 1)
        bstart[i] = lo // bkv
        bend[i] = hi // bkv
    return bstart, bend, int((bend - bstart).max()) + 1


def _band_dkv_extents(S, fb, w, causal, bq, bkv):
    """(qstart, qend, J2): per-kv-tile q-tile range of the transposed
    band walk (dkv)."""
    NK = S // bkv
    qstart = np.zeros(NK, np.int32)
    qend = np.zeros(NK, np.int32)
    for t in range(NK):
        lo = max(((t * bkv) // fb - (0 if causal else w)) * fb, 0)
        hi = min(((t * bkv + bkv - 1) // fb + w) * fb + fb - 1, S - 1)
        qstart[t] = lo // bq
        qend[t] = hi // bq
    return qstart, qend, int((qend - qstart).max()) + 1


def _gr_kv_walk(S, fb, g_r, causal, bkv):
    """kv-tile walk length of the global-rows instance (0 when g_r=0;
    causal global rows only reach cols < g_r*fb)."""
    if not g_r:
        return 0
    return _ceil_div(g_r * fb, bkv) if causal else S // bkv


def walk_stats(S: int, fb: int, params: BandedParams, bq: int, bkv: int,
               n_active_blocks: Optional[int] = None):
    """Static cost accounting for the banded walk at a geometry: grid
    step counts per instance and total fwd/bwd tile dots per (batch,
    head), plus the exact-sparse bound from the layout cell count (JAX's
    ``walk_stats``)."""
    g_r, g_c, w, causal = params
    NQ, NK = S // bq, S // bkv
    GQ = _ceil_div(g_r * fb, bq) if g_r else 0
    GT = _ceil_div(g_c * fb, bkv) if g_c else 0
    _, _, WT = _band_extents(S, fb, w, causal, bq, bkv)
    _, _, J2 = _band_dkv_extents(S, fb, w, causal, bq, bkv)
    GRK = _gr_kv_walk(S, fb, g_r, causal, bkv)
    steps = {
        "band_fwd": NQ * (GT + WT),
        "gr_fwd": GQ * GRK,
        "band_dq": NQ * (GT + WT),
        "gr_dq": GQ * GRK,
        "band_dkv": NK * J2,
        "gc_dkv": GT * (NQ - (g_r * fb) // bq) if GT else 0,
        "gr_dkv": GRK * GQ,
    }
    tile = bq * bkv
    # tile dots per step per (b, h): fwd 2 (s, pv), dq 3 (s, dp, dq),
    # dkv 4 (s, dv, dp, dk) — matches the kernel bodies
    macs = (2 * (steps["band_fwd"] + steps["gr_fwd"]) +
            3 * (steps["band_dq"] + steps["gr_dq"]) +
            4 * (steps["band_dkv"] + steps["gc_dkv"] + steps["gr_dkv"]))
    computed_cells = macs * tile
    bound = None
    if n_active_blocks is not None:
        # exact sparse bound: 9 tile dots per active fine block
        bound = 9 * n_active_blocks * fb * fb
    return {"steps": steps, "computed_cell_dots": computed_cells,
            "exact_cell_dots": bound,
            "waste": (computed_cells / bound) if bound else None}


# --------------------------------------------------------------------- #
# the instance plan
# --------------------------------------------------------------------- #
# the walks: "row" (K11, K12: a q tile walks kv tiles) and "col" (K13: a
# kv tile walks q tiles); the instance kinds' codes in the kernels
_KIND_CODE = {"band": 0, "gr": 1, "gc": 2}


class BandedPlan:
    """JAX's ``build_banded_impls`` decomposition as a host plan: for H
    heads over S at fine block ``fb``, walk tiles (bq, bkv), the
    instances of each walk (``instances["row"]`` for K11/K12,
    ``instances["col"]`` for K13) as ``{kind: (tiles, steps)}``, their
    start/end arrays (int32, copied once per device) and, per step, the
    partner tile and the keep predicate of every cell."""

    def __init__(self, H: int, S: int, fb: int, params: BandedParams,
                 bq: int, bkv: int):
        g_r, g_c, w, causal = params
        if S % bq or S % bkv:
            raise ValueError(f"walk tiles ({bq}, {bkv}) do not divide {S}")
        self.heads, self.seq, self.fine_block = int(H), int(S), int(fb)
        self.params = BandedParams(int(g_r), int(g_c), int(w), bool(causal))
        self.bq, self.bkv = int(bq), int(bkv)
        self.NQ, self.NK = S // bq, S // bkv
        self.GQ = _ceil_div(g_r * fb, bq) if g_r else 0
        self.GT = _ceil_div(g_c * fb, bkv) if g_c else 0
        self.bstart, self.bend, WT = _band_extents(S, fb, w, causal, bq, bkv)
        self.qstart, self.qend, J2 = _band_dkv_extents(S, fb, w, causal, bq,
                                                       bkv)
        self.GRK = _gr_kv_walk(S, fb, g_r, causal, bkv)
        self.gc_q0 = (g_r * fb) // bq
        self.upper = 0 if causal else w
        row = {"band": (self.NQ, self.GT + WT)}
        col = {"band": (self.NK, J2)}
        if self.GT:
            col["gc"] = (self.GT, self.NQ - self.gc_q0)
        if g_r:
            row["gr"] = (self.GQ, self.GRK)
            col["gr"] = (self.GRK, self.GQ)
        self.instances = {"row": row, "col": col}
        self._device = {}

    def bounds(self, walk: str, device) -> Tuple[torch.Tensor, ...]:
        """The band instance's start/end arrays of ``walk`` as int32
        tensors on ``device``."""
        key = (walk, str(device))
        got = self._device.get(key)
        if got is None:
            host = ((self.bstart, self.bend) if walk == "row"
                    else (self.qstart, self.qend))
            got = tuple(torch.from_numpy(a).to(device) for a in host)
            self._device[key] = got
        return got

    def step(self, walk: str, kind: str, j: int):
        """Step ``j`` of instance ``kind`` of ``walk``: (partner tile per
        tile (int64), predicate "band" / "gcol" / "grow", per-tile
        step validity or None) — JAX's ``*_kt`` / ``*_qt`` index maps and
        ``*_keep`` predicates."""
        n = self.instances[walk][kind][0]
        if walk == "row" and kind == "band":
            if self.GT and j < self.GT:
                return np.full(n, j, np.int64), "gcol", None
            s = self.bstart.astype(np.int64) + (j - self.GT)
            return np.minimum(s, self.bend), "band", s <= self.bend
        if walk == "col" and kind == "band":
            s = self.qstart.astype(np.int64) + j
            return np.minimum(s, self.qend), "band", s <= self.qend
        if kind == "gc":
            return np.full(n, self.gc_q0 + j, np.int64), "gcol", None
        return np.full(n, j, np.int64), "grow", None

    def keep(self, pred: str, rb, cb):
        """The predicate on block indices (numpy or torch), clip
        included."""
        g_r, g_c, w, causal = self.params
        if pred == "band":
            k = ((rb >= g_r) & (cb >= g_c) & (rb - cb <= w) &
                 (cb - rb <= self.upper))
        elif pred == "gcol":
            k = (rb >= g_r) & (cb < g_c)
        else:
            k = rb < g_r
        return k & (cb <= rb) if causal else k

    def computed_chunks(self) -> Dict[str, int]:
        """Per (batch, head), the chunks of min(bq, CHUNK) x min(bkv,
        CHUNK) cells each instance's kernel computes: those of its walked
        tiles that keep a cell (the kernels skip the others). Keys
        ``"<walk> <kind>"``."""
        S, fb = self.seq, self.fine_block
        rr, cc = min(self.bq, CHUNK), min(self.bkv, CHUNK)
        nb = S // fb
        blk = np.arange(nb)
        xr, yc = np.arange(S // rr), np.arange(S // cc)
        r_lo, r_hi = xr * rr // fb, (xr * rr + rr - 1) // fb
        c_lo, c_hi = yc * cc // fb, (yc * cc + cc - 1) // fb

        def prefix(a):
            p = np.zeros((a.shape[0] + 1, a.shape[1] + 1), np.int64)
            p[1:, 1:] = a.astype(np.int64).cumsum(0).cumsum(1)
            return p

        def rect(p, r0, r1, c0, c1):         # sums over [r0, r1) x [c0, c1)
            return p[r1, c1] - p[r0, c1] - p[r1, c0] + p[r0, c0]

        live = {}
        for pred in ("band", "gcol", "grow"):
            pb = prefix(np.broadcast_to(
                self.keep(pred, blk[:, None], blk[None, :]), (nb, nb)))
            chunk = rect(pb, r_lo[:, None], r_hi[:, None] + 1, c_lo[None, :],
                         c_hi[None, :] + 1) > 0
            live[pred] = prefix(chunk)
        qr, kc = self.bq // rr, self.bkv // cc     # chunks per tile side
        out = {}
        for walk, kinds in self.instances.items():
            for kind, (n, steps) in kinds.items():
                tiles = np.arange(n)
                total = 0
                for j in range(steps):
                    part, pred, ok = self.step(walk, kind, j)
                    qt, kt = (tiles, part) if walk == "row" else (part, tiles)
                    got = rect(live[pred], qt * qr, qt * qr + qr, kt * kc,
                               kt * kc + kc)
                    total += int((got if ok is None else got * ok).sum())
                out[f"{walk} {kind}"] = total
        return out


@functools.lru_cache(maxsize=None)
def walk_counts(S: int, fb: int, params: BandedParams, bq: int,
                bkv: int) -> Tuple[float, float, float]:
    """(tiles, chunks, chunk) per (batch, head) of the three kernels at
    tiles (bq, bkv), averaged over K11, K12 and K13 as a forward and
    backward walk of K1-K3 counts them: the walk steps, the computed
    chunks, and the side of a square chunk of as many cells (min(bq, 32)
    x min(bkv, 32))."""
    steps = walk_stats(S, fb, params, bq, bkv)["steps"]
    chunks = BandedPlan(1, S, fb, params, bq, bkv).computed_chunks()
    row = sum(c for k, c in chunks.items() if k.startswith("row"))
    col = sum(c for k, c in chunks.items() if k.startswith("col"))
    return (sum(steps.values()) / 3, (2 * row + col) / 3,
            math.sqrt(min(bq, CHUNK) * min(bkv, CHUNK)))


def walk_cost(S: int, fb: int, params: BandedParams, bq: int,
              bkv: int) -> float:
    """Modeled us per (batch, head) of the three kernels at tiles (bq,
    bkv): ``walk_cost_us("banded", *walk_counts(...))``."""
    return walk_cost_us("banded", *walk_counts(S, fb, params, bq, bkv))


def pick_blocks(S: int, fine_block: int, params: BandedParams,
                cpu: bool) -> Optional[Tuple[int, int]]:
    """VALID walk tile sizes (bq, bkv), or None. ``_FORCE_BLOCKS`` first,
    when valid; on CPU tensors the fine block, halved until it divides S
    (JAX's interpret-mode rule, so small layouts walk several tiles); on
    the card the pair of ``KERNEL_BLOCKS`` dividing S with the least
    :func:`walk_cost` (first found on a tie)."""
    if _FORCE_BLOCKS is not None and \
            _blocks_valid(S, *_FORCE_BLOCKS, cpu):
        return _FORCE_BLOCKS
    if cpu:
        b = min(fine_block, 256)
        while b > 1 and S % b:
            b //= 2
        return (b, b)
    best = None
    for bq in KERNEL_BLOCKS:
        for bkv in KERNEL_BLOCKS:
            if S % bq or S % bkv:
                continue
            cost = walk_cost(S, fine_block, params, bq, bkv)
            if best is None or cost < best[0]:
                best = (cost, (bq, bkv))
    return best[1] if best else None


def walk_split_plan(batch: int, heads: int, rows: int, tile: int,
                    steps: int) -> int:
    """Steps per split of a serial tensor-core walk for a call of these
    shapes (``rows`` output rows per (batch, head), each walking
    ``steps`` tiles of ``tile`` keys or queries): the whole walk, halved
    (rounding up) while the grid (splits x batch x heads x the rows'
    warps of 16) has fewer than ``GR_SPLIT_TARGET_WARPS`` warps and the
    halved split keeps ``GR_SPLIT_MIN_KEYS`` keys (queries) or more.
    Shapes only: every call of a shape splits alike, with no device
    sync."""
    warps = batch * heads * rows // 16
    per = max(int(steps), 1)
    while per > 1 and _ceil_div(per, 2) * tile >= GR_SPLIT_MIN_KEYS and \
            warps * _ceil_div(steps, per) < GR_SPLIT_TARGET_WARPS:
        per = _ceil_div(per, 2)
    return per


def gr_split_plan(batch: int, heads: int, gq: int, bq: int, bkv: int,
                  grk: int) -> int:
    """KV tiles per split of the tensor-core gr walk of K11 and K12 (one
    shape: ``gq`` q tiles of ``bq`` rows walking ``grk`` kv tiles of
    ``bkv`` keys, per (batch, head)): :func:`walk_split_plan`'s."""
    return walk_split_plan(batch, heads, gq * bq, bkv, grk)


def fwd_split(q, bp: BandedPlan, kind: str) -> Optional[int]:
    """The kv tiles per split K11's and K12's kernels walk instance
    ``kind`` in for inputs like ``q`` ((B, H, S, D)): their gr walks have
    one shape, so :func:`gr_split_plan`'s for the gr instance in bf16;
    None (one walk) for the band instance and fp32."""
    if kind != "gr" or q.dtype != torch.bfloat16:
        return None
    return gr_split_plan(q.shape[0], bp.heads, bp.GQ, bp.bq, bp.bkv,
                         bp.GRK)


def dkv_split(q, bp: BandedPlan, kind: str) -> Optional[int]:
    """The q tiles per split K13's kernel walks instance ``kind`` in for
    inputs like ``q``: for the gc instance in bf16 (``GT`` kv tiles of
    ``bkv`` key rows walking its q tiles of ``bq`` queries, per (batch,
    head)) :func:`walk_split_plan`'s; None (one walk) for the band and gr
    instances and fp32."""
    if kind != "gc" or q.dtype != torch.bfloat16:
        return None
    return walk_split_plan(q.shape[0], bp.heads, bp.GT * bp.bkv, bp.bq,
                           bp.instances["col"]["gc"][1])


def plan(layout, fine_block: int, cpu: bool):
    """THE banded-dispatch decision, shared by _sparse_attention_fn and
    planned_kernel: (params, (bq, bkv)) when the banded path will run,
    else None."""
    params = detect_banded(layout)
    if params is None:
        return None
    S = np.asarray(layout).shape[1] * fine_block
    blocks = pick_blocks(S, fine_block, params, cpu)
    if blocks is None or not _blocks_valid(S, *blocks, cpu):
        return None
    return params, blocks


# --------------------------------------------------------------------- #
# plain versions: one instance's walk in PyTorch, batched over every
# (batch, head, tile) item, one walk step per iteration
# --------------------------------------------------------------------- #
def _step_cells(bp: BandedPlan, walk, kind, j, device):
    """Step ``j``: the partner tiles (int64 tensor) and the keep mask
    (n, bq, bkv) of every tile of the instance (q rows by keys)."""
    part, pred, ok = bp.step(walk, kind, j)
    n = len(part)
    tiles = np.arange(n)
    qt, kt = (tiles, part) if walk == "row" else (part, tiles)
    ar_q = torch.arange(bp.bq, device=device)
    ar_k = torch.arange(bp.bkv, device=device)
    rb = ((torch.from_numpy(qt * bp.bq).to(device)[:, None] + ar_q)
          // bp.fine_block)[:, :, None]
    cb = ((torch.from_numpy(kt * bp.bkv).to(device)[:, None] + ar_k)
          // bp.fine_block)[:, None, :]
    keep = bp.keep(pred, rb, cb)
    if ok is not None:
        keep = keep & torch.from_numpy(ok).to(device)[:, None, None]
    return torch.from_numpy(part).to(device), keep


def _tiles(x, n, size):
    """(B, H, rows, D) -> (B, H, rows // size, size, D), first n tiles."""
    B, H, rows, D = x.shape
    return x.reshape(B, H, rows // size, size, D)[:, :, :n]


def _key_tiles(key_mask, bkv, tiles):
    """The key mask's (B, 1, n, 1, bkv) rows of kv ``tiles``."""
    B, S = key_mask.shape
    return key_mask.reshape(B, S // bkv, bkv)[:, tiles][:, None, :, None, :]


def _scores(qt, kt, sm_scale, km, keep):
    """(q . k) * sm_scale, then the key mask, then NEG_INF where the
    predicate drops a cell, in fp32."""
    s = _dot(qt, kt) * sm_scale
    if km is not None:
        s = s + km
    return torch.where(keep, s, NEG_INF)


def _fwd_walk(qt, kt, vt, key_mask, bp: BandedPlan, kind: str,
              sm_scale: float, steps):
    """K11's online softmax over walk ``steps`` of instance ``kind`` from
    a fresh state: (m, l, acc) in fp32."""
    B, H, n, bq, D = qt.shape
    m = torch.full((B, H, n, bq), NEG_INF, dtype=torch.float32,
                   device=qt.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, H, n, bq, D), dtype=torch.float32,
                      device=qt.device)
    for j in steps:
        part, keep = _step_cells(bp, "row", kind, j, qt.device)
        km = None if key_mask is None else _key_tiles(key_mask, bp.bkv, part)
        s = _scores(qt, kt[:, :, part].float(), sm_scale, km, keep)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(s > VALID_THRESH, torch.exp(s - m_new[..., None]),
                        0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + \
            p.to(vt.dtype).float() @ vt[:, :, part].float()
        m = m_new
    return m, l, acc


def banded_fwd_plain(q, k, v, key_mask, bp: BandedPlan, kind: str,
                     sm_scale: float,
                     kv_tiles_per_split: Optional[int] = None):
    """K11's function in plain PyTorch for instance ``kind`` ("band" or
    "gr"): per walk step an fp32 online softmax (no m_safe), p rounded to
    V's dtype before P.V. q, k, v (B, H, S, D); ``key_mask`` (B, S) fp32
    or None -> o (q's dtype), lse fp32 over the instance's n * bq rows.
    ``kv_tiles_per_split`` None walks the steps as one online softmax, as
    JAX does; an integer walks each split of that many steps (the gr
    instance's kv tiles) from a fresh state and merges the splits in
    order, as the kernel's split gr walk: m = max m_z, l = sum l_z e^(m_z
    - m), acc = sum acc_z e^(m_z - m)."""
    B, H, S, D = q.shape
    n, steps = bp.instances["row"][kind]
    qt = _tiles(q, n, bp.bq).float()
    kt, vt = (x.reshape(B, H, S // bp.bkv, bp.bkv, D) for x in (k, v))
    walk = (qt, kt, vt, key_mask, bp, kind, sm_scale)
    if kv_tiles_per_split is None:
        m, l, acc = _fwd_walk(*walk, range(steps))
    else:
        if kv_tiles_per_split < 1:
            raise ValueError(f"kv_tiles_per_split must be >= 1, got "
                             f"{kv_tiles_per_split}")
        parts = [_fwd_walk(*walk, range(j, min(j + kv_tiles_per_split,
                                                steps)))
                 for j in range(0, steps, kv_tiles_per_split)]
        m = torch.full_like(parts[0][0], NEG_INF)
        for m_z, _, _ in parts:
            m = torch.maximum(m, m_z)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(parts[0][2])
        for m_z, l_z, acc_z in parts:
            f = torch.exp(m_z - m)
            l = l + l_z * f
            acc = acc + acc_z * f[..., None]
    l_safe = torch.where(l == 0.0, 1.0, l)
    o = (acc / l_safe[..., None]).to(q.dtype).reshape(B, H, n * bp.bq, D)
    return o, (m + torch.log(l_safe)).reshape(B, H, n * bp.bq)


def _split_sum(walk, steps: int, per: Optional[int]):
    """``walk(range(steps))``, the one walk, for ``per`` None; else the
    sums ``walk`` returns (a tensor or a tuple of them) of each split of
    ``per`` steps, each from zero, added in split order from zero: the
    kernels' split walks and their merge."""
    if per is None:
        return walk(range(steps))
    if per < 1:
        raise ValueError(f"tiles per split must be >= 1, got {per}")
    parts = [walk(range(j, min(j + per, steps)))
             for j in range(0, steps, per)] or [walk(range(0))]
    one = isinstance(parts[0], torch.Tensor)
    acc = [torch.zeros_like(x) for x in ((parts[0],) if one else parts[0])]
    for part in parts:
        acc = [a + x for a, x in zip(acc, (part,) if one else part)]
    return acc[0] if one else tuple(acc)


def _dq_walk(qt, dot, lse_t, dl_t, kt, vt, key_mask, bp: BandedPlan,
             kind: str, sm_scale: float, k_dtype, steps):
    """K12's dq sum (before its scale) over walk ``steps`` of instance
    ``kind``, from zero, in fp32."""
    B, H, n, bq, D = qt.shape
    acc = torch.zeros((B, H, n, bq, D), dtype=torch.float32,
                      device=qt.device)
    for j in steps:
        part, keep = _step_cells(bp, "row", kind, j, qt.device)
        km = None if key_mask is None else _key_tiles(key_mask, bp.bkv, part)
        kj = kt[:, :, part].float()
        s = _scores(qt, kj, sm_scale, km, keep)
        p = torch.where(s > VALID_THRESH, torch.exp(s - lse_t[..., None]),
                        0.0)
        dp = _dot(dot, vt[:, :, part])
        ds = p * (dp - dl_t[..., None])
        acc = acc + ds.to(k_dtype).float() @ kj
    return acc


def banded_dq_plain(q, k, v, do, lse, delta, key_mask, bp: BandedPlan,
                    kind: str, sm_scale: float,
                    kv_tiles_per_split: Optional[int] = None):
    """K12's function in plain PyTorch for instance ``kind``: p
    recomputed from ``lse`` (the instance's rows), ds = p * (dp - delta)
    rounded to K's dtype, dq scaled by sm_scale at the end; dq over the
    instance's n * bq rows. ``kv_tiles_per_split`` None sums the walk in
    one, as JAX does; an integer sums each split of that many steps (the
    gr instance's kv tiles) from zero and adds the splits in order before
    the scale, as the kernel's split gr walk."""
    B, H, S, D = q.shape
    n, steps = bp.instances["row"][kind]
    qt, dot = (_tiles(x, n, bp.bq).float() for x in (q, do))
    lse_t = lse.reshape(B, H, -1, bp.bq)[:, :, :n]
    dl_t = delta.reshape(B, H, S // bp.bq, bp.bq)[:, :, :n]
    kt, vt = (x.reshape(B, H, S // bp.bkv, bp.bkv, D) for x in (k, v))
    acc = _split_sum(lambda js: _dq_walk(qt, dot, lse_t, dl_t, kt, vt,
                                         key_mask, bp, kind, sm_scale,
                                         k.dtype, js),
                     steps, kv_tiles_per_split)
    return (acc * sm_scale).to(q.dtype).reshape(B, H, n * bp.bq, D)


def _dkv_walk(qt, dot, kt, vt, lse_t, dl_t, km, bp: BandedPlan, kind: str,
              sm_scale: float, q_dtype, do_dtype, steps):
    """K13's dk (before its scale) and dv sums over walk ``steps`` of
    instance ``kind``, from zero, in fp32."""
    B, H, n, bkv, D = kt.shape
    acc_k = torch.zeros((B, H, n, bkv, D), dtype=torch.float32,
                        device=kt.device)
    acc_v = torch.zeros_like(acc_k)
    for j in steps:
        part, keep = _step_cells(bp, "col", kind, j, kt.device)
        qj, doj = qt[:, :, part].float(), dot[:, :, part].float()
        s = _scores(qj, kt, sm_scale, km, keep)               # (.., bq, bkv)
        p = torch.where(s > VALID_THRESH,
                        torch.exp(s - lse_t[:, :, part, :, None]), 0.0)
        acc_v = acc_v + p.to(do_dtype).float().transpose(-1, -2) @ doj
        dp = _dot(doj, vt)
        ds = p * (dp - dl_t[:, :, part, :, None])
        acc_k = acc_k + ds.to(q_dtype).float().transpose(-1, -2) @ qj
    return acc_k, acc_v


def banded_dkv_plain(q, k, v, do, lse, delta, key_mask, bp: BandedPlan,
                     kind: str, sm_scale: float,
                     q_tiles_per_split: Optional[int] = None):
    """K13's function in plain PyTorch for instance ``kind`` ("band",
    "gc" or "gr"): per kv tile the transposed walk over q tiles, p from
    ``lse`` (the rows the instance reads: all S, or the global rows' for
    "gr"), dv from p rounded to do's dtype, dk from ds rounded to q's
    dtype and scaled by sm_scale at the end; dk, dv over the instance's
    n * bkv rows. ``q_tiles_per_split`` None sums the walk in one, as JAX
    does; an integer sums each split of that many steps (the gc
    instance's q tiles) from zero and adds the splits in order before
    dk's scale, as the kernel's split gc walk."""
    B, H, S, D = q.shape
    n, steps = bp.instances["col"][kind]
    kt, vt = (_tiles(x, n, bp.bkv).float() for x in (k, v))
    qt, dot = (x.reshape(B, H, S // bp.bq, bp.bq, D) for x in (q, do))
    lse_t = lse.reshape(B, H, -1, bp.bq)
    dl_t = delta.reshape(B, H, S // bp.bq, bp.bq)
    km = None if key_mask is None else _key_tiles(
        key_mask, bp.bkv, torch.arange(n, device=q.device))
    acc_k, acc_v = _split_sum(
        lambda js: _dkv_walk(qt, dot, kt, vt, lse_t, dl_t, km, bp, kind,
                             sm_scale, q.dtype, do.dtype, js),
        steps, q_tiles_per_split)
    rows = n * bp.bkv
    return ((acc_k * sm_scale).to(k.dtype).reshape(B, H, rows, D),
            acc_v.to(v.dtype).reshape(B, H, rows, D))


# --------------------------------------------------------------------- #
# the kernels' wrappers
# --------------------------------------------------------------------- #
def _check_args(q, k, v, key_mask, bp: BandedPlan, walk, kind):
    """What the kernels and their plain versions both require."""
    if q.dim() != 4 or q.shape != k.shape or k.shape != v.shape:
        raise ValueError(f"the banded kernels take one (B, H, S, D) shape "
                         f"for q, k and v, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, S, _ = q.shape
    if (H, S) != (bp.heads, bp.seq):
        raise ValueError(f"plan of {bp.heads} heads over {bp.seq} vs inputs "
                         f"{tuple(q.shape)}")
    if kind not in bp.instances[walk]:
        raise ValueError(f"no {kind!r} instance in the {walk} walk of "
                         f"{bp.params}")
    if key_mask is not None and (tuple(key_mask.shape) != (B, S)
                                 or key_mask.dtype != torch.float32):
        raise ValueError(f"the banded kernels take an fp32 (B, S) = ({B}, "
                         f"{S}) key mask, got {key_mask.dtype} "
                         f"{tuple(key_mask.shape)}")


def _check_stats(q, lse, delta, bp: BandedPlan, kind):
    """The backward's row statistics: ``lse`` over the rows instance
    ``kind`` reads (the global rows' for "gr", else all S), ``delta`` over
    all S."""
    B, H, S, _ = q.shape
    rows = bp.GQ * bp.bq if kind == "gr" else S
    if tuple(lse.shape) != (B, H, rows) or tuple(delta.shape) != (B, H, S):
        raise ValueError(f"the {kind!r} instance takes lse ({B}, {H}, {rows}) "
                         f"and delta ({B}, {H}, {S}), got "
                         f"{tuple(lse.shape)} and {tuple(delta.shape)}")


def _check_cuda(operands, fp32, bp: BandedPlan):
    """``operands``: q, k, v (and do) in one dtype; ``fp32``: the fp32
    operands (lse, delta, the key mask or None)."""
    q = operands[0]
    B, H, S, D = q.shape
    if q.device.type != "cuda":
        raise ValueError(f"the banded kernels run on cuda or cpu, not "
                         f"{q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"the banded kernels take {list(_DTYPE_CODE)}, got "
                        f"{q.dtype}")
    for t in (*operands, *(t for t in fp32 if t is not None)):
        if t.device != q.device:
            raise ValueError(f"the banded kernels: operands on {t.device} "
                             f"and {q.device}")
        if not t.is_contiguous():
            raise ValueError("the banded kernels need contiguous operands")
    for t in operands[1:]:
        if t.dtype != q.dtype:
            raise TypeError(f"the banded kernels take one dtype for q, k, v "
                            f"and do, got {q.dtype} and {t.dtype}")
    for t in fp32:
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"the banded kernels take fp32 lse, delta and key "
                            f"mask, got {t.dtype}")
    if D % 8 != 0 or D > MAX_HEAD_DIM:
        raise ValueError(f"the banded kernels take head_dim a multiple of 8 "
                         f"up to {MAX_HEAD_DIM}, got {D}")
    if bp.bq not in KERNEL_BLOCKS or bp.bkv not in KERNEL_BLOCKS:
        raise ValueError(f"the banded kernels take walk tiles of "
                         f"{KERNEL_BLOCKS}, got ({bp.bq}, {bp.bkv})")
    if B * H > 65535:
        raise ValueError(f"the banded kernels take B*H <= 65535, got {B * H}")


_fns = {}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# after the pointers (and the kernel's tiles per split): dtype, bh,
# heads, seq, head_dim, bq, bkv, fine block, g_r, g_c, w, causal, kind,
# tiles, steps, GT, gc_q0, lse rows, sm_scale, stream
_TAIL = [_I] * 18 + [_F, _P]


def _kernel(name: str, n_ptrs: int, n_ints: int = 0):
    """One of the library's C entry points, built and typed at first
    use."""
    fn = _fns.get(name)
    if fn is None:
        from deepspeed_tpu_torch.ops._build import load
        fn = getattr(load("banded.cu"), name)
        fn.restype = ctypes.c_int
        fn.argtypes = [_P] * n_ptrs + [_I] * n_ints + _TAIL
        _fns[name] = fn
    return fn


def _launch(name, q, ptrs, bp: BandedPlan, walk, kind, lse_rows, sm_scale,
            ints=()):
    """Launch ``name`` for instance ``kind`` of ``walk`` on q's device and
    current stream; raise on a refused launch. ``ptrs`` end with the
    walk's start and end; ``ints`` follow them."""
    B, H, S, D = q.shape
    n, steps = bp.instances[walk][kind]
    g_r, g_c, w, causal = bp.params
    fn = _kernel(name, len(ptrs), len(ints))
    args = [None if t is None else t.data_ptr() for t in ptrs] + [
        *ints, _DTYPE_CODE[q.dtype], B * H, H, S, D, bp.bq, bp.bkv,
        bp.fine_block, g_r, g_c, w, int(causal), _KIND_CODE[kind], n, steps,
        bp.GT, bp.gc_q0, lse_rows, float(sm_scale)]
    with torch.cuda.device(q.device):
        err = fn(*args, torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _tiles_per_split(rule: Optional[int], given: Optional[int], q,
                     kind: str, what: str, name: str, steps: int) -> int:
    """The steps per split a kernel walks instance ``kind`` in: ``given``
    where not None (an error where the kernel does not split that walk:
    ``rule`` None), else ``rule``'s, else the whole walk (one split)."""
    if given is not None:
        if rule is None:
            raise ValueError(f"the {q.dtype} {kind!r} walk of the banded "
                             f"{what} kernel is not split: got "
                             f"{name}={given}")
        rule = int(given)
        if rule < 1:
            raise ValueError(f"{name} must be >= 1, got {rule}")
    return min(rule or steps, steps)


def _split_buffers(owner: str, q, splits: int, floats: int, blocks: int):
    """The workspace of a split walk's partials (``floats`` fp32 a split)
    and the arrival counters of its ``blocks`` row blocks, or (None,
    None) for one split."""
    if splits == 1:
        return None, None
    ws = torch.empty(splits * floats, dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    return ws, arrival_counts(owner, q.device, stream, blocks)


@counted_flops("banded_fwd", uncounted)
def banded_fwd(q, k, v, key_mask, bp: BandedPlan, kind: str,
               sm_scale: float, kv_tiles_per_split: Optional[int] = None):
    """K11: ``(o, lse)`` of :func:`banded_fwd_plain` for instance
    ``kind``. A CUDA ``q`` launches the sm_90a kernel (raising on any
    dtype, shape, device or launch problem): in bf16 the tensor-core
    body, which walks the gr instance in splits of ``kv_tiles_per_split``
    kv tiles (None: :func:`fwd_split`'s) merged in the same launch; in
    fp32 the CUDA-core body, one walk. A CPU ``q`` runs the plain version
    with the split given (None: JAX's one walk)."""
    _check_args(q, k, v, key_mask, bp, "row", kind)
    if q.device.type == "cpu":
        return banded_fwd_plain(q, k, v, key_mask, bp, kind, sm_scale,
                                kv_tiles_per_split)
    _check_cuda((q, k, v), (key_mask,), bp)
    _check_aligned("banded forward", FWD_BODIES, q.dtype,
                   (("q", q), ("k", k), ("v", v), ("key_mask", key_mask)))
    B, H, _, D = q.shape
    n, steps = bp.instances["row"][kind]
    kps = _tiles_per_split(fwd_split(q, bp, kind), kv_tiles_per_split, q,
                           kind, "forward", "kv_tiles_per_split", steps)
    rows = n * bp.bq
    o = torch.empty((B, H, rows, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, rows), dtype=torch.float32, device=q.device)
    # the splits' partials (acc, then m and l), merged by the last split;
    # one counter per (b, h, row block)
    ws, arrivals = _split_buffers(
        "banded_fwd", q, _ceil_div(steps, kps), B * H * rows * (D + 2),
        B * H * (rows // min(bp.bq, MMA_ROWS)))
    start, end = bp.bounds("row", q.device)
    _launch("banded_fwd", q, [q, k, v, key_mask, o, lse, ws, arrivals,
                              start, end], bp, "row", kind, rows, sm_scale,
            ints=(kps,))
    banded_fwd.launches += 1
    _count_body(banded_fwd, q.dtype, FWD_BODIES)
    return o, lse


def _check_bwd_aligned(q, k, v, do, key_mask=None):
    """K12's and K13's operands for their tensor-core bodies (dq, dk and
    dv, allocated by the wrappers, are aligned)."""
    _check_aligned("banded backward", DQ_BODIES, q.dtype,
                   (("q", q), ("k", k), ("v", v), ("do", do),
                    ("key_mask", key_mask)))


@counted_flops("banded_dq", uncounted)
def banded_dq(q, k, v, do, lse, delta, key_mask, bp: BandedPlan, kind: str,
              sm_scale: float, kv_tiles_per_split: Optional[int] = None,
              tally=None):
    """K12: ``dq`` of :func:`banded_dq_plain` for instance ``kind``. A
    CUDA ``q`` launches the sm_90a kernel (raising on any dtype, shape,
    device, alignment or launch problem): in bf16 the tensor-core dq
    body, which walks the gr instance in splits of ``kv_tiles_per_split``
    kv tiles (None: :func:`fwd_split`'s) summed in the same launch; in fp32
    the CUDA-core body, one walk. A CPU ``q`` runs the plain version with
    the split given (None: JAX's one walk). ``tally`` (a measurement):
    None, or one int64 on q's device to which the tensor-core body adds
    the cells it sums again in the plain order."""
    _check_args(q, k, v, key_mask, bp, "row", kind)
    _check_stats(q, lse, delta, bp, kind)
    if q.device.type == "cpu":
        return banded_dq_plain(q, k, v, do, lse, delta, key_mask, bp, kind,
                               sm_scale, kv_tiles_per_split)
    _check_cuda((q, k, v, do), (lse, delta, key_mask), bp)
    _check_bwd_aligned(q, k, v, do, key_mask)
    _check_tally(tally, q)
    B, H, _, D = q.shape
    n, steps = bp.instances["row"][kind]
    kps = _tiles_per_split(fwd_split(q, bp, kind), kv_tiles_per_split, q,
                           kind, "dq", "kv_tiles_per_split", steps)
    rows = n * bp.bq
    dq = torch.empty((B, H, rows, D), dtype=q.dtype, device=q.device)
    ws, arrivals = _split_buffers(
        "banded_dq", q, _ceil_div(steps, kps), B * H * rows * D,
        B * H * (rows // min(bp.bq, MMA_ROWS)))
    start, end = bp.bounds("row", q.device)
    _launch("banded_dq", q, [q, k, v, do, lse, delta, key_mask, dq, ws,
                             arrivals, tally, start, end], bp, "row", kind,
            lse.shape[-1], sm_scale, ints=(kps,))
    banded_dq.launches += 1
    _count_body(banded_dq, q.dtype, DQ_BODIES)
    return dq


@counted_flops("banded_dkv", uncounted)
def banded_dkv(q, k, v, do, lse, delta, key_mask, bp: BandedPlan, kind: str,
               sm_scale: float, q_tiles_per_split: Optional[int] = None,
               tally=None):
    """K13: ``(dk, dv)`` of :func:`banded_dkv_plain` for instance
    ``kind``. A CUDA ``q`` launches the sm_90a kernel as
    :func:`banded_dq` does: in bf16 the tensor-core dk/dv body, which
    walks the gc instance in splits of ``q_tiles_per_split`` q tiles
    (None: :func:`dkv_split`'s) summed in the same launch; in fp32 the
    CUDA-core body, one walk. A CPU ``q`` runs the plain version with the
    split given (None: JAX's one walk). ``tally``: as :func:`banded_dq`'s."""
    _check_args(q, k, v, key_mask, bp, "col", kind)
    _check_stats(q, lse, delta, bp, kind)
    if q.device.type == "cpu":
        return banded_dkv_plain(q, k, v, do, lse, delta, key_mask, bp, kind,
                                sm_scale, q_tiles_per_split)
    _check_cuda((q, k, v, do), (lse, delta, key_mask), bp)
    _check_bwd_aligned(q, k, v, do, key_mask)
    _check_tally(tally, q)
    B, H, _, D = q.shape
    n, steps = bp.instances["col"][kind]
    qps = _tiles_per_split(dkv_split(q, bp, kind), q_tiles_per_split, q,
                           kind, "dk/dv", "q_tiles_per_split", steps)
    rows = n * bp.bkv
    dk = torch.empty((B, H, rows, D), dtype=k.dtype, device=q.device)
    dv = torch.empty((B, H, rows, D), dtype=v.dtype, device=q.device)
    # the splits' dk partials, then their dv partials
    ws, arrivals = _split_buffers(
        "banded_dkv", q, _ceil_div(steps, qps), 2 * B * H * rows * D,
        B * H * (rows // min(bp.bkv, MMA_ROWS)))
    start, end = bp.bounds("col", q.device)
    _launch("banded_dkv", q, [q, k, v, do, lse, delta, key_mask, dk, dv,
                              ws, arrivals, tally, start, end], bp, "col",
            kind, lse.shape[-1], sm_scale, ints=(qps,))
    banded_dkv.launches += 1
    _count_body(banded_dkv, q.dtype, DKV_BODIES)
    return dk, dv


def reset_launches():
    """Set every launch count of K11-K13 to 0, also by body."""
    for w in (banded_fwd, banded_dq, banded_dkv):
        w.launches = 0
        w.bodies = {}


reset_launches()


# --------------------------------------------------------------------- #
# the instances combined (JAX's fwd_impl / bwd_impl)
# --------------------------------------------------------------------- #
def _add_rows(out, part):
    """``out`` with ``part`` (the first rows) added in fp32, rounded to
    ``out``'s dtype: JAX's ``o_b + pad(o_g.astype(f32)).astype(..)``."""
    n = part.shape[2]
    head = (out[:, :, :n].float() + part.float()).to(out.dtype)
    return torch.cat([head, out[:, :, n:]], dim=2)


def banded_fwd_impl(q, k, v, key_mask, bp: BandedPlan, sm_scale: float):
    """(o, lse_band, lse_gr): K11's band instance, and with global rows
    its gr instance added into the first GQ * bq rows (the rows of the
    two are disjoint, so the add is exact). ``lse_gr`` covers those rows
    (empty without global rows)."""
    o, lse_b = banded_fwd(q, k, v, key_mask, bp, "band", sm_scale)
    if "gr" in bp.instances["row"]:
        o_g, lse_g = banded_fwd(q, k, v, key_mask, bp, "gr", sm_scale)
        o = _add_rows(o, o_g)
    else:
        lse_g = lse_b[:, :, :0]
    return o, lse_b, lse_g


def banded_bwd_impl(q, k, v, key_mask, bp: BandedPlan, sm_scale: float, o,
                    lse_b, lse_g, do):
    """(dq, dk, dv) from K12's and K13's instances, delta = sum(do * o)
    in fp32. dq adds its gr part as the forward does; dk and dv round each
    instance's result to k's / v's dtype, then sum band + gc + gr in fp32
    and round once (JAX's order)."""
    delta = (do.float() * o.float()).sum(dim=-1)
    args = (key_mask, bp)
    dq = banded_dq(q, k, v, do, lse_b, delta, *args, "band", sm_scale)
    dk, dv = banded_dkv(q, k, v, do, lse_b, delta, *args, "band", sm_scale)
    col = bp.instances["col"]
    if "gr" in bp.instances["row"]:
        dq = _add_rows(dq, banded_dq(q, k, v, do, lse_g, delta, *args, "gr",
                                     sm_scale))
    if "gc" in col or "gr" in col:
        acc_k, acc_v = dk.float(), dv.float()
        for kind, lse in (("gc", lse_b), ("gr", lse_g)):
            if kind in col:
                pk, pv = banded_dkv(q, k, v, do, lse, delta, *args, kind,
                                    sm_scale)
                n = pk.shape[2]
                acc_k[:, :, :n] += pk.float()
                acc_v[:, :, :n] += pv.float()
        dk, dv = acc_k.to(k.dtype), acc_v.to(v.dtype)
    return dq, dk, dv


class _Banded(torch.autograd.Function):
    """Forward K11's instances, saving (q, k, v, key_mask, o, lse_band,
    lse_gr); backward K12's and K13's. The key mask takes no gradient:
    zeros where asked for, as the JAX package's vjp returns."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, bp, sm_scale):
        o, lse_b, lse_g = banded_fwd_impl(q, k, v, key_mask, bp, sm_scale)
        ctx.save_for_backward(q, k, v, key_mask, o, lse_b, lse_g)
        ctx.bp, ctx.sm_scale = bp, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, key_mask, o, lse_b, lse_g = ctx.saved_tensors
        dq, dk, dv = banded_bwd_impl(q, k, v, key_mask, ctx.bp, ctx.sm_scale,
                                     o, lse_b, lse_g, do.contiguous())
        dkm = (torch.zeros_like(key_mask)
               if key_mask is not None and ctx.needs_input_grad[3] else None)
        return dq, dk, dv, dkm, None, None


def build_banded_fn(layout_shape, fine_block: int, params: BandedParams,
                    sm_scale: float, blocks: Tuple[int, int]):
    """Differentiable ``f(q, k, v, key_mask) -> o`` for the banded path
    (inputs pre-validated by :func:`plan`); ``key_mask`` is the additive
    fp32 (B, S) key mask or None. ``f.kernel_kind`` is "banded",
    ``f.banded_blocks`` the walk tiles, ``f.plan`` the
    :class:`BandedPlan`."""
    H, nb, _ = layout_shape
    bp = BandedPlan(H, nb * fine_block, fine_block, params, *blocks)

    def f(q, k, v, key_mask):
        if key_mask is not None:
            key_mask = key_mask.float().contiguous()
        return _Banded.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                             key_mask, bp, float(sm_scale))

    f.kernel_kind = "banded"
    f.banded_blocks = (bp.bq, bp.bkv)
    f.plan = bp
    return f
