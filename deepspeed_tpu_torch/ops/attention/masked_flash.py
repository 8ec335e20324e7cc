"""Masked flash attention for training (the port of
``deepspeed_tpu/ops/attention/masked_flash.py``).

One mask-parameterized attention, forward and backward, over a static
:class:`BlockMask` (dense and causal are mask choices). Three kernels,
each with a wrapper and a plain PyTorch version of the same tile walk:

- :func:`masked_flash_fwd` — K1, ``o`` and ``lse`` over the mask's CSR
  walk (replaces ``_mf_fwd_kernel``);
- :func:`masked_flash_dq` — K2, ``dq`` over the CSR walk (replaces
  ``_mf_dq_kernel``);
- :func:`masked_flash_dkv` — K3, ``dk`` and ``dv`` over the CSC walk, as
  fp32 per-q-head partials summed per group outside the kernel at G > 1
  (replaces ``_mf_dkv_kernel``).

For CUDA tensors each wrapper launches its hand-written kernel in
``csrc/masked_flash.cu`` (built with nvcc for sm_90a at first use) or
raises; it never falls back. K1 in bf16 runs the tensor-core body of
``csrc/mma_fwd.cuh`` (shared with K5), K2 that of ``csrc/mma_dq.cuh``
(shared with K6), K3 that of ``csrc/mma_dkv.cuh`` (shared with K7), in
fp32 each the CUDA-core body (:data:`FWD_BODIES`, :data:`DQ_BODIES`,
:data:`DKV_BODIES`). For CPU tensors it runs the
plain version (``*_plain``). Each launch adds one to the wrapper's
``launches``. :func:`masked_flash_call` is the ``torch.autograd.Function``
over the three; :func:`masked_flash_attention` is the public entry.

Ported arity: block kinds FULL, CAUSAL and BAND, GQA, mask heads 1 or
H, dropout, fp32 and bf16, head_dim a multiple of 8 up to 128, walk
blocks 16, 32, 64 and 128, and the additive fp32 key-padding mask
(``has_kpm``: a ``(B, Sk)`` row added to the scaled scores of every head
before the partial-tile predicates). ``KIND_BAND`` tiles carry the
banded fine structure of a coarsened walk (:meth:`BlockMask.from_layout`
on a head-uniform global-prefix + window layout): the predicate
``band = (fine_block, w, g_r, g_c, causal)`` is evaluated per cell, a
template flag of the kernels beside the key mask.
"""

import ctypes
import math
from typing import Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.ops.attention import flash as _flash
from deepspeed_tpu_torch.profiling.flops import counted_flops
from deepspeed_tpu_torch.ops.attention.flash import (NEG_INF,
                                                     dropout_keep_mask,
                                                     dropout_mask_reference,
                                                     keep_threshold)

__all__ = ["BlockMask", "masked_flash_attention", "masked_flash_call",
           "masked_flash_cost", "walk_cost_us", "masked_flash_reference", "masked_flash_fwd",
           "masked_flash_dq", "masked_flash_dkv", "masked_flash_fwd_plain",
           "masked_flash_dq_plain", "masked_flash_dkv_plain"]

# scores below this are structurally masked
VALID_THRESH = -1e28

# partial-tile predicate bits (BlockMask.kinds cell values)
KIND_FULL = 0          # every cell computed (block-level mask semantics)
KIND_CAUSAL = 1        # elementwise q_idx >= k_idx (diagonal tiles)
KIND_BAND = 2          # banded fine structure (global prefix + window)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the body K1, K5, K8 and K14 run by input dtype: bf16 on the tensor cores
# (csrc/mma_fwd.cuh), fp32 on the CUDA cores (fp32 FMAs: the fp32
# checks' 1e-5 tolerance is tighter than TF32 holds)
FWD_BODIES = {torch.bfloat16: "mma", torch.float32: "fma"}
# the body K2 and K6 run by input dtype: bf16 on the tensor cores
# (csrc/mma_dq.cuh), fp32 on the CUDA cores
DQ_BODIES = {torch.bfloat16: "mma", torch.float32: "fma"}
# the body K3 and K7 run by input dtype: bf16 on the tensor cores
# (csrc/mma_dkv.cuh), fp32 on the CUDA cores
DKV_BODIES = {torch.bfloat16: "mma", torch.float32: "fma"}
KERNEL_BLOCKS = (16, 32, 64, 128)
MAX_HEAD_DIM = 128
# the coarse walk tiles a banded layout may take (the kernels take walk
# blocks up to 128); the rule (BlockMask._pick_walk_block) takes one only
# on a modeled win
COARSE_WALK_BLOCKS = (128, 64, 32)
# the kernels compute a walked tile in chunks of R x R cells, R =
# min(walk block, CHUNK): K1-K3 skip the chunks of a KIND_BAND tile that
# keep no cell, K8-K10 compute every chunk of a walked tile
CHUNK = 32

# The cost of a walk on one H100, in us per (batch, head): per walked tile,
# per computed chunk (a floor: staging, barriers, the softmax pass) and
# per computed cell, for the three kernels of a forward and backward
# together. Each is a non-negative least-squares fit
# (chip_smoke.fit_walk_costs) of a sweep of chip_smoke.py's sparse kernel
# timing phases (medians of CUDA-event-timed calls, L2 flushed; B 8, H 16,
# S 2048, D 64, bf16; NVIDIA H100 80GB HBM3 at 700 W; PERF.md section 6):
# - "masked_flash" (K1-K3, all three in bf16 on their tensor-core
#   bodies): the BSLongformer layout at walks 128, 64, 32 and 16 (74, 154,
#   314 tiles over 314 live chunks of 32, and 634 tiles of 16, in 5.016,
#   4.388, 4.468 and 2.267 ms); neither the tiles nor the chunks cost
#   anything measurable beside their cells, so a coarse walk, which never
#   computes fewer cells, never wins and the rule keeps the fine walk;
# - "blocksparse_v2" (K8-K10): the fixed per-head layouts of
#   ds_config_sparse.json under an (S, S) 'mul' mask at walks 16, 32, 64
#   and 128 (4480, 2112, 1024 and 256 tiles per (b, h), in 24.14, 39.37,
#   78.98 and 79.79 ms, K9 and K10 on the CUDA cores); they compute every
#   chunk of a walked tile, so a coarse walk of this layout computes
#   1.9-3.7x the fine walk's cells and the fine walk wins. Kept since K9
#   and K10 run the tensor-core bodies: that sweep alone (6.961, 9.453,
#   12.370 and 14.135 ms) fits a floor per tile and none per chunk, which
#   would walk small layouts of S 128 at 128, off JAX's fine walk (bf16
#   outputs then part from JAX's beyond the tests' tolerance), where three
#   small launches take 0.1-0.2 ms and no walk wins in every run
#   (chip_smoke.v2_walk_picks; PERF.md section 6);
# - "banded" (K11-K13, banded.walk_cost picks their walk tiles; a tile is
#   a walk step of the three kernels, a chunk min(bq, 32) x min(bkv, 32)
#   cells they compute): the s8k BSLongformer layout (B 1, H 16, S 8192,
#   block 128, window 3) at tiles (32, 32), (64, 64), (128, 128),
#   (64, 128) and (128, 64) (5115 to 320 steps over 5024 chunks of 32 per
#   (b, h), in 28.53, 27.83, 27.02, 27.97 and 27.36 ms); every tile pair
#   computes the same chunks there, so the fit splits nothing between
#   chunk and cell (K1-K3's constants were the start; both pick (128, 128)
#   here and (16, 16) for sparse BERT's block 16).
# Only ratios matter: the rules compare walks of one layout.
WALK_COSTS = {
    # (us per tile, us per chunk, us per cell)
    "masked_flash": (0.0, 0.0, 1.12099e-4),
    "blocksparse_v2": (0.0, 5.885e-3, 1.4145e-4),
    "banded": (1.49198e-2, 0.0, 3.32402e-4),
}


def walk_cost_us(kernels: str, tiles: int, chunks: int, chunk: int) -> float:
    """Modeled cost of one walk of ``kernels`` ("masked_flash",
    "blocksparse_v2" or "banded"): ``tiles`` walked tiles, ``chunks``
    computed chunks of ``chunk`` x ``chunk`` cells, per (batch, head)."""
    per_tile, per_chunk, per_cell = WALK_COSTS[kernels]
    return tiles * per_tile + chunks * (per_chunk + per_cell * chunk * chunk)


def _live_chunks(layout: np.ndarray, fine_block: int, chunk: int) -> int:
    """The ``chunk`` x ``chunk`` cell chunks of a fine (H, nb, nb) layout
    that hold a kept cell: what a walk computes when it skips the others
    (a fine tile wider than ``chunk`` holds (fine_block / chunk)**2)."""
    fine = np.asarray(layout).astype(bool)
    if fine_block >= chunk:
        return int(fine.sum()) * (fine_block // chunk) ** 2
    g = chunk // fine_block
    H, nb, _ = fine.shape
    return int(fine.reshape(H, nb // g, g, nb // g, g).any(axis=(2, 4)).sum())


class BlockMask:
    """Static block-level attention mask (numpy; the JAX package's class).

    ``active``: (Hm, nq, nk) bool — which (q-block, k-block) tiles are
    walked; ``kinds``: (Hm, nq, nk) uint8 bitmask over active tiles
    (KIND_CAUSAL / KIND_BAND; 0 = full). ``Hm`` is 1 (head-uniform) or
    the head count. ``band`` carries the fine structure of KIND_BAND
    tiles, ``(fine_block, w, g_r, g_c, causal_clip)`` in fine-block
    units. Instances are immutable and hashable, and cache their CSR/CSC
    walk metadata (and its device copies)."""

    def __init__(self, active: np.ndarray, kinds: np.ndarray, block: int,
                 seq_q: int, seq_k: int,
                 band: Optional[Tuple[int, int, int, int, bool]] = None,
                 fine_block: Optional[int] = None):
        active = np.ascontiguousarray(np.asarray(active, bool))
        kinds = np.ascontiguousarray(np.asarray(kinds, np.uint8))
        if active.ndim != 3 or active.shape != kinds.shape:
            raise ValueError(f"BlockMask: active {active.shape} and kinds "
                             f"{kinds.shape} must be one (Hm, nq, nk) shape")
        Hm, nq, nk = active.shape
        if nq * block != seq_q or nk * block != seq_k:
            raise ValueError(f"BlockMask: {active.shape} blocks of {block} "
                             f"do not tile seq ({seq_q}, {seq_k})")
        # whether a walked tile is KIND_BAND: the kernels' band arity
        self.has_band = bool((kinds[active] & KIND_BAND).any())
        if band is None and self.has_band:
            raise ValueError("BlockMask: KIND_BAND tiles need a band "
                             "(fine_block, w, g_r, g_c, causal)")
        self.active = active
        self.kinds = kinds
        self.block = int(block)
        self.seq_q = int(seq_q)
        self.seq_k = int(seq_k)
        self.heads = Hm
        self.band = tuple(band) if band is not None else None
        # the layout's own block (== block unless the walk was coarsened)
        self.fine_block = int(fine_block or block)
        self._key = (self.block, self.seq_q, self.seq_k, self.band,
                     active.tobytes(), kinds.tobytes())
        self._csr = None
        self._csc = None
        self._device_walks = {}

    # ---------------------------------------------------- constructors
    @classmethod
    def dense(cls, seq_q: int, seq_k: int, block: int) -> "BlockMask":
        nq, nk = seq_q // block, seq_k // block
        return cls(np.ones((1, nq, nk), bool),
                   np.zeros((1, nq, nk), np.uint8), block, seq_q, seq_k)

    @classmethod
    def causal(cls, seq: int, block: int) -> "BlockMask":
        """Square causal mask: tiles below the diagonal are FULL, the
        diagonal tiles apply the elementwise clip, above is skipped."""
        nb = seq // block
        r = np.arange(nb)[:, None]
        c = np.arange(nb)[None, :]
        active = (r >= c)[None]
        kinds = np.where(r == c, KIND_CAUSAL, KIND_FULL
                         ).astype(np.uint8)[None]
        return cls(active, kinds * active, block, seq, seq)

    @classmethod
    def from_layout(cls, layout: np.ndarray, fine_block: int,
                    walk_block: Optional[int] = None) -> "BlockMask":
        """A SparsityConfig layout (H, nb, nb) as a BlockMask.

        Head-identical layouts collapse to one mask head. When the
        collapsed layout is banded (``detect_banded``: a global prefix
        plus a window, BSLongformer-class) the walk may be coarsened: the
        tiles of ``walk_block`` that hold any kept fine block are walked,
        those partly kept are KIND_BAND and carry the fine structure in
        ``band``. Other layouts walk at the fine block. ``walk_block``
        forces a coarse tile (0 forces the fine walk); without it a tile
        of ``COARSE_WALK_BLOCKS`` is taken only where :func:`walk_cost_us`
        models a win of more than 10% over the fine walk."""
        layout = np.asarray(layout)
        if layout.ndim != 3 or layout.shape[1] != layout.shape[2]:
            raise ValueError(f"layout must be (H, nb, nb), got "
                             f"{layout.shape}")
        if (layout == layout[:1]).all():
            layout = layout[:1]                  # head-uniform: collapse
        H, nb, _ = layout.shape
        S = nb * fine_block
        fine = layout.astype(bool)
        bp = None
        if H == 1:
            from deepspeed_tpu_torch.ops.sparse_attention.banded import \
                detect_banded
            bp = detect_banded(layout)
        cb = cls._pick_walk_block(fine, fine_block, S, bp, walk_block)
        if cb is None:
            return cls(fine, np.zeros_like(fine, np.uint8), fine_block,
                       S, S, fine_block=fine_block)
        f = cb // fine_block
        nc = nb // f
        sub = fine.reshape(1, nc, f, nc, f)
        coarse_any = sub.any(axis=(2, 4))
        coarse_all = sub.all(axis=(2, 4))
        kinds = np.where(coarse_any & ~coarse_all, KIND_BAND, KIND_FULL
                         ).astype(np.uint8)
        band = (fine_block, bp.w, bp.g_r, bp.g_c, bool(bp.causal))
        return cls(coarse_any, kinds, cb, S, S, band=band,
                   fine_block=fine_block)

    @staticmethod
    def _pick_walk_block(fine, fine_block, S, bp, walk_block):
        """The coarse walk tile, or None for the fine walk (the JAX
        package's rule with this card's costs): a coarse tile needs a
        banded layout (the predicate must reproduce every partial tile
        exactly) and a modeled win of more than 10% over the fine walk. A
        requested one that cannot be honoured raises rather than silently
        walking the fine blocks."""
        if walk_block == 0:
            return None
        if bp is None:
            if walk_block is not None:
                raise ValueError(
                    f"walk_block={walk_block} requested but the layout "
                    "is not banded-describable (per-head, random blocks, "
                    "or non-prefix globals) — coarse partial tiles need "
                    "the register band predicate. Use walk_block=0 (fine "
                    "walk) or a banded layout.")
            return None
        if walk_block is not None:
            if not (walk_block > fine_block and walk_block % fine_block == 0
                    and S % walk_block == 0):
                raise ValueError(
                    f"walk_block={walk_block} must be wider than the fine "
                    f"block {fine_block}, a multiple of it, and divide the "
                    f"sequence {S}")
            return walk_block
        nnz_f = int(fine.sum())
        r_f = min(fine_block, CHUNK)
        fine_cost = walk_cost_us("masked_flash", nnz_f,
                                 nnz_f * (fine_block // r_f) ** 2, r_f)
        best = None
        for cb in COARSE_WALK_BLOCKS:
            if cb <= fine_block or cb % fine_block or S % cb:
                continue
            f = cb // fine_block
            nc = (S // fine_block) // f
            tiles = int(fine.reshape(1, nc, f, nc, f).any(axis=(2, 4)).sum())
            r = min(cb, CHUNK)
            cost = walk_cost_us("masked_flash", tiles,
                                _live_chunks(fine, fine_block, r), r)
            if cost < fine_cost * 0.9 and (best is None or cost < best[0]):
                best = (cost, cb)
        return best[1] if best else None

    # ------------------------------------------------------- metadata
    @property
    def nq(self) -> int:
        return self.seq_q // self.block

    @property
    def nk(self) -> int:
        return self.seq_k // self.block

    @property
    def nnz(self) -> int:
        return int(self.active.sum())

    @property
    def has_partials(self) -> bool:
        return bool((self.kinds[self.active] != 0).any())

    def csr(self):
        """(offs, cnts, cols, kinds) flattened over rows mh * nq + r."""
        if self._csr is None:
            self._csr = self._runs(self.active, self.kinds)
        return self._csr

    def csc(self):
        """(offs, cnts, rows, kinds) flattened over cols mh * nk + c —
        the column-major walk the dk/dv pass follows."""
        if self._csc is None:
            self._csc = self._runs(
                np.ascontiguousarray(self.active.transpose(0, 2, 1)),
                np.ascontiguousarray(self.kinds.transpose(0, 2, 1)))
        return self._csc

    @staticmethod
    def _runs(active, kinds):
        offs, cnts, idxs, iks = [], [], [], []
        off = 0
        H, nr, _ = active.shape
        for h in range(H):
            for r in range(nr):
                nz = np.nonzero(active[h, r])[0]
                offs.append(off)
                cnts.append(len(nz))
                idxs.extend(int(c) for c in nz)
                iks.extend(int(kinds[h, r, c]) for c in nz)
                off += len(nz)
        return (np.asarray(offs, np.int32), np.asarray(cnts, np.int32),
                np.asarray(idxs if idxs else [0], np.int32),
                np.asarray(iks if iks else [0], np.int32))

    def device_walk(self, which: str, device) -> Tuple[torch.Tensor, ...]:
        """The CSR (``which="csr"``) or CSC walk as int32 tensors on
        ``device``, copied once per device."""
        key = (which, str(device))
        walk = self._device_walks.get(key)
        if walk is None:
            host = self.csr() if which == "csr" else self.csc()
            walk = tuple(torch.from_numpy(a).to(device) for a in host)
            self._device_walks[key] = walk
        return walk

    def dense_additive(self) -> np.ndarray:
        """(Hm, Sq, Sk) additive 0 / NEG_INF expansion — the oracle view
        of what the kernels compute tile by tile."""
        b = self.block
        keep = np.kron(self.active, np.ones((b, b), bool))
        qi = np.arange(self.seq_q)[:, None]
        ki = np.arange(self.seq_k)[None, :]
        kinds = np.kron(self.kinds, np.ones((b, b), np.uint8))
        if (kinds & KIND_CAUSAL).any():
            keep &= ~((kinds & KIND_CAUSAL).astype(bool)) | (qi >= ki)
        if self.band is not None and (kinds & KIND_BAND).any():
            keep &= ~((kinds & KIND_BAND).astype(bool)) | \
                _band_keep(self.band, qi, ki)
        return np.where(keep, 0.0, NEG_INF).astype(np.float32)

    def describe(self) -> str:
        s = f"masked(block={self.block}, nnz={self.nnz}/" \
            f"{self.heads * self.nq * self.nk}"
        if self.block != self.fine_block:
            s += f", coarsened from {self.fine_block}"
        return s + ")"

    def __hash__(self):
        return hash(self._key)

    def __eq__(self, other):
        return isinstance(other, BlockMask) and self._key == other._key


def _band_keep(band, q_idx, k_idx):
    """The band predicate on absolute indices: global rows, global
    columns or the window, in fine blocks, then the layout's own causal
    clip."""
    fb, w, g_r, g_c, clip = band
    qf = q_idx // fb
    kf = k_idx // fb
    ok = (qf < g_r) | (kf < g_c) | (abs(qf - kf) <= w)
    if clip:
        ok = ok & (kf <= qf)
    return ok


def masked_flash_cost(mask: BlockMask, batch: int, heads: int,
                      head_dim: int, dtype_bytes: int = 2,
                      backward: bool = False):
    """Modeled FLOPs and bytes of one forward (optionally + backward)
    pass, the JAX package's accounting: ``flops`` counts the products of
    every walked tile; ``kv_bytes`` the K/V tiles each walked item reads
    (a TPU VMEM model); ``io_bytes`` q in, o/lse out per block row."""
    hm = heads if mask.heads == 1 else 1
    items = mask.nnz * hm * batch
    rows = mask.heads * mask.nq * hm * batch
    b, d = mask.block, head_dim
    dots_per_item = 2 if not backward else 2 + 6
    flops = items * dots_per_item * 2 * b * b * d
    kv_tile = b * d * dtype_bytes
    q_tile = b * d * dtype_bytes
    row_io = q_tile + q_tile + b * 4
    kv_bytes = items * 2 * kv_tile
    io_bytes = rows * row_io
    if backward:
        kv_bytes *= 2
        io_bytes += rows * 3 * q_tile
    return {"flops": int(flops), "kv_bytes": int(kv_bytes),
            "io_bytes": int(io_bytes),
            "bytes": int(kv_bytes + io_bytes),
            "items": int(items), "block": b}


def masked_flash_reference(q, k, v, mask: BlockMask, key_mask=None,
                           sm_scale=None, dropout_rate: float = 0.0,
                           dropout_seed=None):
    """Dense fp32 oracle with the mask expanded additively: exact-zero
    probabilities for structurally masked cells, zero output for fully
    masked rows, the kernels' hash dropout."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if k.shape[1] != q.shape[1]:
        rep = q.shape[1] // k.shape[1]
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    s = (q.float() @ k.float().transpose(-1, -2)) * sm_scale
    if key_mask is not None:
        s = s + key_mask.reshape(key_mask.shape[0], 1, 1, -1).float()
    s = s + torch.from_numpy(mask.dense_additive()).to(q.device)[None]
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.where(m <= VALID_THRESH, 0.0, m)
    p = torch.where(s > VALID_THRESH, torch.exp(s - m_safe), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(l == 0.0, 1.0, l)
    if dropout_rate > 0.0:
        b_, h_, sq_, sk_ = p.shape
        keep = dropout_mask_reference(dropout_seed, b_, h_, sq_, sk_,
                                      dropout_rate, device=q.device)
        p = torch.where(keep, p, 0.0) / (1.0 - dropout_rate)
    return (p @ v.float()).to(q.dtype)


# --------------------------------------------------------------------- #
# plain versions: the kernels' tile walk in PyTorch
# --------------------------------------------------------------------- #
def _head_groups(mask: BlockMask, H: int, G: int, B: int, device):
    """Per mask head: (hm, q-head index, kv-head index, (B, nh) b*H+h)."""
    out = []
    for hm in range(mask.heads):
        hs = (torch.arange(H, device=device) if mask.heads == 1
              else torch.tensor([hm], device=device))
        bh = torch.arange(B, device=device)[:, None] * H + hs[None, :]
        out.append((hm, hs, hs // G, bh))
    return out


def _tile_scores(qt, kt, sm_scale, kind, q_idx, k_idx, kpm=None,
                 band=None):
    """Scores of one walked tile in fp32: ``(q . k) * sm_scale``, then
    the key mask's row ``kpm`` ((B, 1, 1, blk) or None) added, then the
    partial-tile predicates (JAX's ``_partial_keep``): the causal clip
    of a CAUSAL tile, the ``band`` predicate of a BAND tile."""
    s = (qt @ kt.transpose(-1, -2)) * sm_scale
    if kpm is not None:
        s = s + kpm
    if kind & KIND_CAUSAL:
        s = torch.where(q_idx[:, None] >= k_idx[None, :], s, NEG_INF)
    if kind & KIND_BAND:
        s = torch.where(_band_keep(band, q_idx[:, None], k_idx[None, :]),
                        s, NEG_INF)
    return s


def _kpm_tile(key_mask, c, blk):
    """Key block ``c`` of the (B, Sk) fp32 key mask, shaped to broadcast
    over (B, heads, rows, blk); None without a mask."""
    if key_mask is None:
        return None
    return key_mask[:, None, None, c * blk:(c + 1) * blk]


def _keep(seed, bh, q_idx, k_idx, seq_k, rate):
    return dropout_keep_mask(seed, bh[:, :, None, None], q_idx[:, None],
                             k_idx[None, :], seq_k, rate)


def masked_flash_fwd_plain(q, k, v, mask: BlockMask, sm_scale: float,
                           rate: float = 0.0, seed: int = 0, key_mask=None,
                           bh0: int = 0):
    """K1's function in plain PyTorch, with its tile walk: per walked
    tile an fp32 online-softmax step, p rounded to V's dtype before P.V.
    q (B, H, Sq, D), k/v (B, Hkv, Sk, D), optional fp32 ``key_mask``
    (B, Sk) -> o (q's dtype), lse (B, H, Sq) fp32. The dropout hashes
    ``bh0 + b * H + h`` (``bh0``: the first row's offset in a global
    batch, times H)."""
    B, H, Sq, D = q.shape
    G = H // k.shape[1]
    blk = mask.block
    offs, cnts, cols, kinds = mask.csr()
    o = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    ar = torch.arange(blk, device=q.device)
    for hm, hs, kvh, bh in _head_groups(mask, H, G, B, q.device):
        qh, kh, vh = q[:, hs].float(), k[:, kvh].float(), v[:, kvh]
        for j in range(mask.nq):
            row = hm * mask.nq + j
            rows = slice(j * blk, (j + 1) * blk)
            q_idx = j * blk + ar
            qt = qh[:, :, rows]
            m = torch.full(qt.shape[:-1], NEG_INF, dtype=torch.float32,
                           device=q.device)
            l = torch.zeros_like(m)
            acc = torch.zeros_like(qt)
            for t in range(int(cnts[row])):
                c, kind = int(cols[offs[row] + t]), int(kinds[offs[row] + t])
                k_idx = c * blk + ar
                s = _tile_scores(qt, kh[:, :, c * blk:(c + 1) * blk],
                                 sm_scale, kind, q_idx, k_idx,
                                 _kpm_tile(key_mask, c, blk), mask.band)
                m_new = torch.maximum(m, s.amax(dim=-1))
                m_safe = torch.where(m_new <= VALID_THRESH, 0.0, m_new)
                alpha = torch.exp(m - m_new)
                p = torch.where(s > VALID_THRESH,
                                torch.exp(s - m_safe[..., None]), 0.0)
                l = l * alpha + p.sum(dim=-1)
                if rate > 0.0:
                    p = torch.where(_keep(seed, bh + bh0, q_idx, k_idx,
                                          k.shape[2], rate), p, 0.0)
                vt = vh[:, :, c * blk:(c + 1) * blk]
                acc = acc * alpha[..., None] + \
                    p.to(v.dtype).float() @ vt.float()
                m = m_new
            l_safe = torch.where(l == 0.0, 1.0, l)
            out = acc / l_safe[..., None]
            if rate > 0.0:
                out = out * (1.0 / (1.0 - rate))
            o[:, hs, rows] = out.to(q.dtype)
            lse[:, hs, rows] = torch.where(
                l == 0.0, NEG_INF,
                torch.where(m <= VALID_THRESH, 0.0, m) + torch.log(l_safe))
    return o, lse


def masked_flash_dq_plain(q, k, v, do, lse, delta, mask: BlockMask,
                          sm_scale: float, rate: float = 0.0,
                          seed: int = 0, key_mask=None, bh0: int = 0):
    """K2's function in plain PyTorch over the CSR walk: p recomputed
    from lse (the key mask added as in K1), ds = p * (dp - delta) rounded
    to K's dtype, dq scaled by sm_scale at the end."""
    B, H, Sq, D = q.shape
    G = H // k.shape[1]
    blk = mask.block
    offs, cnts, cols, kinds = mask.csr()
    dq = torch.empty_like(q)
    ar = torch.arange(blk, device=q.device)
    inv = 1.0 / (1.0 - rate) if rate > 0.0 else 1.0
    for hm, hs, kvh, bh in _head_groups(mask, H, G, B, q.device):
        qh, kh, vh = q[:, hs].float(), k[:, kvh].float(), v[:, kvh].float()
        doh, lseh, dlh = do[:, hs].float(), lse[:, hs], delta[:, hs]
        for j in range(mask.nq):
            row = hm * mask.nq + j
            rows = slice(j * blk, (j + 1) * blk)
            q_idx = j * blk + ar
            qt, dot = qh[:, :, rows], doh[:, :, rows]
            acc = torch.zeros_like(qt)
            for t in range(int(cnts[row])):
                c, kind = int(cols[offs[row] + t]), int(kinds[offs[row] + t])
                k_idx = c * blk + ar
                kt = kh[:, :, c * blk:(c + 1) * blk]
                s = _tile_scores(qt, kt, sm_scale, kind, q_idx, k_idx,
                                 _kpm_tile(key_mask, c, blk), mask.band)
                p = torch.where(s > VALID_THRESH,
                                torch.exp(s - lseh[:, :, rows, None]), 0.0)
                dp = dot @ vh[:, :, c * blk:(c + 1) * blk].transpose(-1, -2)
                if rate > 0.0:
                    dp = torch.where(_keep(seed, bh + bh0, q_idx, k_idx,
                                           k.shape[2], rate), dp * inv, 0.0)
                ds = p * (dp - dlh[:, :, rows, None])
                acc = acc + ds.to(k.dtype).float() @ kt
            dq[:, hs, rows] = (acc * sm_scale).to(q.dtype)
    return dq


def masked_flash_dkv_plain(q, k, v, do, lse, delta, mask: BlockMask,
                           sm_scale: float, rate: float = 0.0,
                           seed: int = 0, key_mask=None, bh0: int = 0):
    """K3's function in plain PyTorch over the CSC walk: p recomputed
    with the key block's mask row, dv from the dropped, scaled pd, dk
    from the undropped p in ds; per-q-head fp32 partials summed per group
    at G > 1. Returns (dk, dv) shaped like k."""
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = H // Hkv
    blk = mask.block
    offs, cnts, rws, kinds = mask.csc()
    part = torch.float32 if G > 1 else k.dtype
    dk = torch.empty((B, H, Sk, D), dtype=part, device=q.device)
    dv = torch.empty_like(dk)
    ar = torch.arange(blk, device=q.device)
    inv = 1.0 / (1.0 - rate) if rate > 0.0 else 1.0
    for hm, hs, kvh, bh in _head_groups(mask, H, G, B, q.device):
        qh, kh, vh = q[:, hs].float(), k[:, kvh].float(), v[:, kvh].float()
        doh, lseh, dlh = do[:, hs].float(), lse[:, hs], delta[:, hs]
        for jb in range(mask.nk):
            col = hm * mask.nk + jb
            cols_ = slice(jb * blk, (jb + 1) * blk)
            k_idx = jb * blk + ar
            kt, vt = kh[:, :, cols_], vh[:, :, cols_]
            kpm_row = _kpm_tile(key_mask, jb, blk)
            acc_k = torch.zeros_like(kt)
            acc_v = torch.zeros_like(vt)
            for t in range(int(cnts[col])):
                rq, kind = int(rws[offs[col] + t]), int(kinds[offs[col] + t])
                rows = slice(rq * blk, (rq + 1) * blk)
                q_idx = rq * blk + ar
                qt, dot = qh[:, :, rows], doh[:, :, rows]
                s = _tile_scores(qt, kt, sm_scale, kind, q_idx, k_idx,
                                 kpm_row, mask.band)
                p = torch.where(s > VALID_THRESH,
                                torch.exp(s - lseh[:, :, rows, None]), 0.0)
                dp = dot @ vt.transpose(-1, -2)
                if rate > 0.0:
                    keep = _keep(seed, bh + bh0, q_idx, k_idx, Sk, rate)
                    pd = torch.where(keep, p * inv, 0.0)
                    dp = torch.where(keep, dp * inv, 0.0)
                else:
                    pd = p
                acc_v = acc_v + \
                    pd.to(do.dtype).float().transpose(-1, -2) @ dot
                ds = p * (dp - dlh[:, :, rows, None])
                acc_k = acc_k + ds.to(q.dtype).float().transpose(-1, -2) @ qt
            dk[:, hs, cols_] = (acc_k * sm_scale).to(part)
            dv[:, hs, cols_] = acc_v.to(part)
    return _group_sum(dk, dv, k, v)


def _group_sum(dk, dv, k, v):
    """Per-q-head partials (B, H, Sk, D) -> (B, Hkv, Sk, D): summed in
    fp32 per group at G > 1, then cast to k's / v's dtype."""
    B, Hkv, Sk, D = k.shape
    G = dk.shape[1] // Hkv
    if G == 1:
        return dk, dv
    return (dk.reshape(B, Hkv, G, Sk, D).sum(2).to(k.dtype),
            dv.reshape(B, Hkv, G, Sk, D).sum(2).to(v.dtype))


# --------------------------------------------------------------------- #
# the work a walk does, for the FLOP counter
# --------------------------------------------------------------------- #
# products per computed (query, key) cell: K1 q.k and p.v; K2 q.k again,
# do.v and ds.k; K3 q.k, do.v, p^T.do and ds^T.q
FWD_DOTS, DQ_DOTS, DKV_DOTS = 2, 3, 4


def walked_cells(mask: BlockMask) -> int:
    """The cells the kernels compute over every mask head of ``mask``:
    a FULL tile's every cell, a CAUSAL tile's lower triangle, a BAND
    tile's kept cells (never the masked-off part of a tile). Key-mask
    pads count: the kernels compute them. Cached on the mask."""
    cells = getattr(mask, "_walked_cells", None)
    if cells is not None:
        return cells
    b = mask.block
    kinds = mask.kinds[mask.active]
    cells = int((kinds == KIND_FULL).sum()) * b * b
    hs, rs, cs = np.nonzero(mask.active & (mask.kinds != KIND_FULL))
    span = np.arange(b)
    for r, c, kind in zip(rs, cs, mask.kinds[hs, rs, cs]):
        qi = r * b + span[:, None]
        ki = c * b + span[None, :]
        keep = np.ones((b, b), bool)
        if kind & KIND_CAUSAL:
            keep &= qi >= ki
        if kind & KIND_BAND:
            keep &= _band_keep(mask.band, qi, ki)
        cells += int(keep.sum())
    mask._walked_cells = cells
    return cells


def walk_flops(q, mask: BlockMask, dots: int) -> int:
    """FLOPs of one kernel call on (B, H, S, D) ``q``: two per product,
    ``dots`` products of length D per walked cell."""
    B, H, _, D = q.shape
    per_head = H if mask.heads == 1 else 1
    return walked_cells(mask) * B * per_head * dots * 2 * D


# --------------------------------------------------------------------- #
# the kernels' wrappers
# --------------------------------------------------------------------- #
def _check_args(q, k, v, mask: BlockMask, key_mask=None):
    """What the kernels and their plain versions both require."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"masked flash takes (B, H, S, D) q and (B, Hkv, "
                         f"S, D) k/v, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, Sq, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or H % k.shape[1] != 0:
        raise ValueError(f"masked flash shapes: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    if mask.seq_q != Sq or mask.seq_k != k.shape[2]:
        raise ValueError(f"mask geometry ({mask.seq_q}, {mask.seq_k}) vs "
                         f"inputs ({Sq}, {k.shape[2]})")
    if mask.heads not in (1, H):
        raise ValueError(f"mask heads {mask.heads} must be 1 (uniform) or "
                         f"{H}")
    if key_mask is not None and (
            tuple(key_mask.shape) != (B, k.shape[2])
            or key_mask.dtype != torch.float32):
        raise ValueError(f"masked flash takes an fp32 (B, Sk) = "
                         f"({B}, {k.shape[2]}) key mask, got "
                         f"{key_mask.dtype} {tuple(key_mask.shape)}")


def _check_cuda(tensors, mask: BlockMask, key_mask=None):
    q = tensors[0]
    B, H, Sq, D = q.shape
    if q.device.type != "cuda":
        raise ValueError(f"masked flash runs on cuda or cpu, not "
                         f"{q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"masked flash kernels take {list(_DTYPE_CODE)}, "
                        f"got {q.dtype}")
    for t in (*tensors, *(() if key_mask is None else (key_mask,))):
        if t.device != q.device:
            raise ValueError(f"masked flash: operands on {t.device} and "
                             f"{q.device}")
        if not t.is_contiguous():
            raise ValueError("masked flash kernels need contiguous "
                             "operands")
    for t in tensors[1:4]:
        if t.dtype != q.dtype:
            raise TypeError(f"masked flash kernels take one dtype for q, "
                            f"k, v and do, got {q.dtype} and {t.dtype}")
    if D % 8 != 0 or D > MAX_HEAD_DIM:
        raise ValueError(f"masked flash kernels take head_dim a multiple "
                         f"of 8 up to {MAX_HEAD_DIM}, got {D}")
    if mask.block not in KERNEL_BLOCKS:
        raise ValueError(f"masked flash kernels take walk blocks "
                         f"{KERNEL_BLOCKS}, got {mask.block}")
    if B * H > 65535:
        raise ValueError(f"masked flash kernels take B*H <= 65535, got "
                         f"{B * H}")


# the fp32 operands a tensor-core body reads in 8-byte pairs: the key
# mask, and the additive mask of K8 (its tiles) and K14-K16 (the (S, S)
# mask)
_PAIR_OPERANDS = ("key_mask", "tiles", "attn_mask")


def _check_aligned(what, bodies, dtype, operands):
    """A tensor-core body (bf16) loads 16-byte rows from 16-byte aligned
    operands, and the fp32 masks in 8-byte pairs: raise for an operand of
    ``operands`` ((name, tensor or None), ...) the C entry point would
    refuse."""
    if bodies[dtype] != "mma":
        return
    for name, t in operands:
        align = 8 if name in _PAIR_OPERANDS else 16
        if t is not None and t.data_ptr() % align:
            raise ValueError(f"the bf16 {what} kernels take a {name} "
                             f"aligned to {align} bytes, got address "
                             f"{t.data_ptr():#x}")


def _check_fwd_aligned(q, k, v, key_mask=None):
    """K1's and K5's operands for their tensor-core body."""
    _check_aligned("forward", FWD_BODIES, q.dtype,
                   (("q", q), ("k", k), ("v", v), ("key_mask", key_mask)))


def _check_dq_aligned(q, k, v, do, key_mask=None):
    """K2's and K6's operands for their tensor-core body (dq, allocated
    by the wrapper, is aligned)."""
    _check_aligned("dq", DQ_BODIES, q.dtype,
                   (("q", q), ("k", k), ("v", v), ("do", do),
                    ("key_mask", key_mask)))


def _check_dkv_aligned(q, k, v, do, key_mask=None):
    """K3's and K7's operands for their tensor-core body."""
    _check_aligned("dk/dv", DKV_BODIES, q.dtype,
                   (("q", q), ("k", k), ("v", v), ("do", do),
                    ("key_mask", key_mask)))


_fns = {}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# what every entry point takes after its pointers, dtype (and fp32_out):
# bh, heads, kv_heads, mask_heads, seq_q, seq_k, head_dim, block, the
# band (fine_block, w, g_r, g_c, causal; fine_block 0: no band arity),
# then sm_scale, dropout, keep_thresh, inv_keep, seed, (bh0,) stream
_GEOMETRY = [_I] * 13
_TAIL = [_F, _I, ctypes.c_uint32, _F, ctypes.c_int32, _P]
# masked_flash.cu's entry points take the dropout's bh0 before the stream
_TAIL_BH0 = _TAIL[:-1] + [_I, _P]


def _ptr(t) -> Optional[int]:
    """A tensor's device pointer; None (a null pointer) for no tensor."""
    return None if t is None else t.data_ptr()


def _kernel(name: str, argtypes):
    """One of the library's C entry points, built and typed at first
    use."""
    fn = _fns.get(name)
    if fn is None:
        from deepspeed_tpu_torch.ops._build import load
        fn = getattr(load("masked_flash.cu"), name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        _fns[name] = fn
    return fn


def _as_int32(x: int) -> int:
    x = int(x) & 0xFFFFFFFF
    return x - (1 << 32) if x >= (1 << 31) else x


def _check_hash_rounds(rate: float):
    """The kernels hash with the two-round finalizer only; the plain
    versions follow ``flash._HASH_FINAL_ROUNDS``. The wrappers refuse any
    other value on every device, so the two cannot drift apart."""
    if rate > 0.0 and _flash._HASH_FINAL_ROUNDS != 2:
        raise NotImplementedError(
            f"masked flash kernels: flash._HASH_FINAL_ROUNDS = "
            f"{_flash._HASH_FINAL_ROUNDS}; the kernels' dropout hash has "
            f"the two-round finalizer only")


def _geometry(q, k, mask: BlockMask):
    B, H, Sq, D = q.shape
    band = mask.band if mask.has_band else (0, 0, 0, 0, False)
    return [B * H, H, k.shape[1], mask.heads, Sq, mask.seq_k, D, mask.block,
            *(int(x) for x in band)]


def _dropout(sm_scale: float, rate: float, seed: int):
    if rate <= 0.0:
        return [float(sm_scale), 0, 0, 1.0, 0]
    return [float(sm_scale), 1, keep_threshold(rate),
            float(1.0 / (1.0 - rate)), _as_int32(seed)]


def _run(name, fn, q, args):
    """Launch ``fn(*args, stream)`` on q's device and current stream."""
    def go():
        return fn(*args, torch.cuda.current_stream(q.device).cuda_stream)

    if q.device.index == torch.cuda.current_device():
        err = go()
    else:                     # the launch goes to the current device
        with torch.cuda.device(q.device):
            err = go()
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


@counted_flops("masked_flash_fwd", lambda q, k, v, mask, *a, **kw:
               walk_flops(q, mask, FWD_DOTS))
def masked_flash_fwd(q, k, v, mask: BlockMask, sm_scale: float,
                     rate: float = 0.0, seed: int = 0, key_mask=None,
                     bh0: int = 0):
    """K1: ``(o, lse)`` of :func:`masked_flash_fwd_plain`. A CUDA ``q``
    launches the sm_90a kernel (raising on any dtype, shape, device or
    launch problem), its tensor-core body in bf16 and its CUDA-core body
    in fp32 (:data:`FWD_BODIES`); a CPU ``q`` runs the plain version.
    With a ``key_mask`` the kernel's key-mask arity runs; with KIND_BAND
    tiles its band arity. Every launch counts in ``launches``, in
    ``arities`` under :func:`arity` and in ``bodies`` under its body."""
    _check_args(q, k, v, mask, key_mask)
    _check_hash_rounds(rate)
    if q.device.type == "cpu":
        return masked_flash_fwd_plain(q, k, v, mask, sm_scale, rate, seed,
                                      key_mask, bh0)
    _check_cuda((q, k, v), mask, key_mask)
    _check_fwd_aligned(q, k, v, key_mask)
    B, H, Sq, D = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    # q, k, v, kpm, o, lse, offs, cnts, cols, kinds; dtype
    fn = _kernel("masked_flash_fwd",
                 [_P] * 10 + [_I] + _GEOMETRY + _TAIL_BH0)
    walk = mask.device_walk("csr", q.device)
    _run("masked_flash_fwd", fn, q,
         [q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(key_mask),
          o.data_ptr(), lse.data_ptr(), *(w.data_ptr() for w in walk),
          _DTYPE_CODE[q.dtype], *_geometry(q, k, mask),
          *_dropout(sm_scale, rate, seed), int(bh0)])
    _count(masked_flash_fwd, key_mask, mask)
    _count_body(masked_flash_fwd, q.dtype)
    return o, lse


@counted_flops("masked_flash_dq", lambda q, k, v, do, lse, delta, mask,
               *a, **kw: walk_flops(q, mask, DQ_DOTS))
def masked_flash_dq(q, k, v, do, lse, delta, mask: BlockMask,
                    sm_scale: float, rate: float = 0.0, seed: int = 0,
                    key_mask=None, bh0: int = 0):
    """K2: ``dq`` of :func:`masked_flash_dq_plain`; kernel on CUDA (its
    key-mask arity with a ``key_mask``), its tensor-core body in bf16 and
    its CUDA-core body in fp32 (:data:`DQ_BODIES`, counted in
    ``bodies``); plain version on the CPU."""
    _check_args(q, k, v, mask, key_mask)
    _check_hash_rounds(rate)
    if q.device.type == "cpu":
        return masked_flash_dq_plain(q, k, v, do, lse, delta, mask,
                                     sm_scale, rate, seed, key_mask, bh0)
    _check_cuda((q, k, v, do, lse, delta), mask, key_mask)
    _check_dq_aligned(q, k, v, do, key_mask)
    dq = torch.empty_like(q)
    # q, k, v, kpm, do, lse, delta, dq, offs, cnts, cols, kinds; dtype
    fn = _kernel("masked_flash_dq",
                 [_P] * 12 + [_I] + _GEOMETRY + _TAIL_BH0)
    walk = mask.device_walk("csr", q.device)
    _run("masked_flash_dq", fn, q,
         [q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(key_mask),
          do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
          *(w.data_ptr() for w in walk),
          _DTYPE_CODE[q.dtype], *_geometry(q, k, mask),
          *_dropout(sm_scale, rate, seed), int(bh0)])
    _count(masked_flash_dq, key_mask, mask)
    _count_body(masked_flash_dq, q.dtype, DQ_BODIES)
    return dq


@counted_flops("masked_flash_dkv", lambda q, k, v, do, lse, delta, mask,
               *a, **kw: walk_flops(q, mask, DKV_DOTS))
def masked_flash_dkv(q, k, v, do, lse, delta, mask: BlockMask,
                     sm_scale: float, rate: float = 0.0, seed: int = 0,
                     key_mask=None, bh0: int = 0):
    """K3: ``(dk, dv)`` of :func:`masked_flash_dkv_plain`; kernel on
    CUDA (fp32 per-q-head partials at G > 1, summed here; its key-mask
    arity with a ``key_mask``), its tensor-core body in bf16 and its
    CUDA-core body in fp32 (:data:`DKV_BODIES`, counted in ``bodies``);
    plain version on the CPU."""
    _check_args(q, k, v, mask, key_mask)
    _check_hash_rounds(rate)
    if q.device.type == "cpu":
        return masked_flash_dkv_plain(q, k, v, do, lse, delta, mask,
                                      sm_scale, rate, seed, key_mask, bh0)
    _check_cuda((q, k, v, do, lse, delta), mask, key_mask)
    _check_dkv_aligned(q, k, v, do, key_mask)
    B, H, Sq, D = q.shape
    G = H // k.shape[1]
    part = torch.float32 if G > 1 else k.dtype
    dk = torch.empty((B, H, k.shape[2], D), dtype=part, device=q.device)
    dv = torch.empty_like(dk)
    # q, k, v, kpm, do, lse, delta, dk, dv, coffs, ccnts, crows, ckinds;
    # dtype, fp32_out
    fn = _kernel("masked_flash_dkv",
                 [_P] * 13 + [_I, _I] + _GEOMETRY + _TAIL_BH0)
    walk = mask.device_walk("csc", q.device)
    _run("masked_flash_dkv", fn, q,
         [q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(key_mask),
          do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
          dv.data_ptr(), *(w.data_ptr() for w in walk),
          _DTYPE_CODE[q.dtype], int(G > 1), *_geometry(q, k, mask),
          *_dropout(sm_scale, rate, seed), int(bh0)])
    _count(masked_flash_dkv, key_mask, mask)
    _count_body(masked_flash_dkv, q.dtype, DKV_BODIES)
    return _group_sum(dk, dv, k, v)


def arity(key_mask, mask: BlockMask) -> str:
    """The name of the kernel arity a call runs, with its walk block and
    mask heads: e.g. ``"kpm+band walk128 heads1"``; ``"plain"`` names
    the arity with neither the key mask nor the band."""
    flags = [f for f, on in (("kpm", key_mask is not None),
                             ("band", mask.has_band)) if on]
    return (f"{'+'.join(flags) or 'plain'} walk{mask.block} "
            f"heads{mask.heads}")


def _count(wrapper, key_mask, mask: BlockMask):
    """One launch of ``wrapper``'s kernel: ``launches`` counts every
    launch, ``arities`` every launch by :func:`arity`."""
    wrapper.launches += 1
    name = arity(key_mask, mask)
    wrapper.arities[name] = wrapper.arities.get(name, 0) + 1


def _count_body(wrapper, dtype, bodies=FWD_BODIES):
    """One launch of ``wrapper`` (K1-K3, K5-K8 or K14-K16), counted in its
    ``bodies`` by the body it ran (``bodies``: :data:`FWD_BODIES`,
    :data:`DQ_BODIES` or :data:`DKV_BODIES`)."""
    body = bodies[dtype]
    wrapper.bodies[body] = wrapper.bodies.get(body, 0) + 1


def reset_launches():
    """Set every launch count of K1-K3 to 0."""
    for w in (masked_flash_fwd, masked_flash_dq, masked_flash_dkv):
        w.launches = 0
        w.arities = {}
        w.bodies = {}


reset_launches()


# --------------------------------------------------------------------- #
# autograd + public API
# --------------------------------------------------------------------- #
class _MaskedFlash(torch.autograd.Function):
    """Forward K1, saving (q, k, v, key_mask, o, lse); backward delta =
    sum(do*o) in fp32, then K2 and K3. The key mask takes no gradient: a
    zero one where asked for, as the JAX package's vjp returns."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, seed, mask, sm_scale, rate, bh0):
        o, lse = masked_flash_fwd(q, k, v, mask, sm_scale, rate, seed,
                                  key_mask, bh0)
        ctx.save_for_backward(q, k, v, key_mask, o, lse)
        ctx.mask, ctx.sm_scale, ctx.rate, ctx.seed = mask, sm_scale, rate, \
            seed
        ctx.bh0 = bh0
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, key_mask, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = (do.float() * o.float()).sum(dim=-1)
        args = (ctx.mask, ctx.sm_scale, ctx.rate, ctx.seed, key_mask,
                ctx.bh0)
        dq = masked_flash_dq(q, k, v, do, lse, delta, *args)
        dk, dv = masked_flash_dkv(q, k, v, do, lse, delta, *args)
        dkpm = (torch.zeros_like(key_mask) if ctx.needs_input_grad[3]
                else None)
        return dq, dk, dv, dkpm, None, None, None, None, None


def masked_flash_call(q, k, v, seed: int, mask: BlockMask, sm_scale: float,
                      rate: float, key_mask=None, bh0: int = 0):
    """Low-level entry, all operands explicit: ``o`` with the custom
    backward. ``seed`` is the dropout seed (int32; unused at rate 0);
    ``key_mask`` the optional fp32 (B, Sk) additive key mask; ``bh0``
    offsets the dropout's ``b * H + h`` (a rank's first global row
    times H)."""
    return _MaskedFlash.apply(
        q.contiguous(), k.contiguous(), v.contiguous(),
        None if key_mask is None else key_mask.contiguous(), int(seed),
        mask, float(sm_scale), float(rate), int(bh0))


def masked_flash_attention(q, k, v, mask: BlockMask, key_mask=None,
                           sm_scale: Optional[float] = None,
                           dropout_rate: float = 0.0,
                           dropout_seed: Optional[int] = None,
                           dropout_bh0: int = 0):
    """Blocked flash attention under a static :class:`BlockMask`.

    q: (B, H, Sq, D); k, v: (B, kv_heads, Sk, D) with H % kv_heads == 0.
    ``mask.heads`` must be 1 or H. ``key_mask``: optional *additive* key
    mask, (B, Sk) or BERT-style (B, 1, 1, Sk), taken in fp32.
    ``dropout_rate > 0`` requires ``dropout_seed`` (an int32);
    ``dropout_bh0`` offsets the dropout hash's ``b * H + h``."""
    if key_mask is not None:
        key_mask = key_mask.reshape(q.shape[0], k.shape[2]).float()
    _check_args(q, k, v, mask, key_mask)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    dropout_rate = float(dropout_rate)
    if dropout_rate > 0.0:
        if dropout_seed is None:
            raise ValueError("masked_flash_attention: dropout_rate > 0 "
                             "requires dropout_seed")
        if dropout_rate >= 1.0:
            raise ValueError(f"dropout_rate must be < 1, got "
                             f"{dropout_rate}")
    return masked_flash_call(q, k, v, dropout_seed or 0, mask, sm_scale,
                             dropout_rate, key_mask, dropout_bh0)
