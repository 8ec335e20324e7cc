"""Block-sparse attention, the front end (the port of
``deepspeed_tpu/ops/sparse_attention/blocksparse.py``).

The routes of the JAX package, chosen by its five module flags
(``USE_MASKED_FLASH``, ``USE_SPLASH_V2``, ``USE_BANDED``, ``USE_HYBRID``,
``USE_COARSE``, with JAX's defaults):

- without a user ``attn_mask`` (``USE_MASKED_FLASH``), a layout from
  ``sparsity_config.py`` (numpy ``(H, nb, nb)``, 1 = an attended
  (query-block, key-block) pair) becomes a :class:`BlockMask` of the
  masked flash kernels K1-K3 (``ops/attention/masked_flash.py``):
  head-uniform layouts collapse to one mask head, banded layouts may
  coarsen their walk onto KIND_BAND tiles, and the key-padding mask rides
  the kernels' additive ``(B, S)`` key-mask arity;
- with an ``attn_mask``, the row-run kernels K8-K10
  (``blocksparse_v2.py``) over the layout's walk or a coarse one that
  :func:`_pick_coarse_block` picks, the ``(S, S)`` mask deduplicated into
  unique tiles;
- the legacy dispatch without an ``attn_mask`` (``USE_MASKED_FLASH =
  False``), in JAX's order: the banded kernels K11-K13 (``banded.py``) for
  a global-prefix + band layout, the hybrid (``hybrid.py``: K11-K13 on the
  band, K8-K10 without a mask tile on the residue), the row-run kernels
  at the fine walk or a coarse one, and last K1-K3 ('masked-fallback');
- ``USE_SPLASH_V2 = False`` (with an ``attn_mask``, or without one on
  the legacy dispatch where the layout is not banded): JAX's per-triple
  v1 kernels K14-K16 of this module ('v1'), JAX's test oracle for
  K8-K10. :class:`TriplePlan` holds the row triples (:func:`build_triples`)
  and those of the transposed layout; :func:`bs_fwd` (K14, ``o`` and
  ``lse``; replaces ``_bs_fwd_kernel``), :func:`bs_dq` (K15;
  ``_bs_dq_kernel``) and :func:`bs_dkv` (K16, dk and dv over the column
  triples; ``_bs_dkv_kernel``) launch the hand-written kernels of
  ``csrc/blocksparse.cu`` (built with nvcc for sm_90a at first use) on
  CUDA tensors or raise (in bf16 on the tensor cores: K14 on K1's forward
  body, ``csrc/mma_fwd.cuh``, K15 on K2's dq body, ``csrc/mma_dq.cuh``,
  K16 on K3's dk/dv body, ``csrc/mma_dkv.cuh``; in fp32 on the CUDA
  cores: :data:`FWD_BODIES`, :data:`DQ_BODIES`, :data:`DKV_BODIES`), and
  run their plain versions (``bs_*_plain``) on CPU tensors; each launch
  adds one to the wrapper's ``launches``, to ``arities`` under
  :func:`v1_arity` and to ``bodies`` under the body it ran.
  :func:`triple_attention` is the
  ``torch.autograd.Function`` entry over the three. Their semantics are
  JAX's, threshold included: ``p = 0`` where ``s <= VALID_THRESH``
  (-1e28, not the -1e29 of K8-K10), and a row with no valid key writes
  ``o = 0`` and ``lse`` = its running max (``NEG_INF`` for an empty
  block row).

Where JAX asks for ``block % 128 == 0`` or ``interpret``, the port asks
for CPU tensors or a block the kernels take (``KERNEL_BLOCKS``).

The port does not pre-block the masks (``_block_kpm`` / ``_block_am`` are
a TPU lane rule: K8-K10 take unique tiles gathered from the ``(S, S)``
mask, K14-K16 read it in place per coordinate, and all take the ``(B,
S)`` key row, adding nothing when it is None where JAX adds zeros), and
has no dense-reference fallback for an ``attn_mask``: a walk block the
kernels cannot take raises on the card.

Mask semantics (the reference's sparse softmax): scores are scaled, then
rpe added, then the key-padding mask and the attention mask applied —
'add' mode adds the mask values; 'mul' mode maps zero entries to
``NEG_INF`` and nonzero ones to 0 (a hard keep/drop mask).

An ``rpe`` routes to the dense reference, as in JAX.
"""

import ctypes
import math
from typing import Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.profiling.flops import counted_flops, uncounted
from deepspeed_tpu_torch.ops.attention.flash import ordered_dot
# FWD_BODIES, DQ_BODIES, DKV_BODIES: K14, K15 and K16 run K1's, K2's and
# K3's bodies, by dtype as those do
from deepspeed_tpu_torch.ops.attention.masked_flash import (
    CHUNK, COARSE_WALK_BLOCKS, DKV_BODIES, DQ_BODIES, FWD_BODIES,
    KERNEL_BLOCKS, MAX_HEAD_DIM, BlockMask, _check_aligned, _count_body,
    masked_flash_attention, walk_cost_us)
from deepspeed_tpu_torch.ops.sparse_attention import banded, hybrid
from deepspeed_tpu_torch.ops.sparse_attention.blocksparse_v2 import (
    RowRunPlan, _check_tally, build_coarse_index, row_run_attention)

__all__ = ["NEG_INF", "VALID_THRESH", "block_sparse_attention",
           "block_sparse_attention_reference", "build_row_luts",
           "build_col_luts", "layout_additive_mask", "planned_kernel",
           "build_triples", "TriplePlan", "triple_attention", "bs_fwd",
           "bs_dq", "bs_dkv", "bs_fwd_plain", "bs_dq_plain",
           "bs_dkv_plain", "v1_arity", "reset_launches", "FWD_BODIES",
           "DQ_BODIES", "DKV_BODIES"]

NEG_INF = -1e30
# scores below this are structurally masked: several -1e30 mask terms may
# stack, so the threshold sits well above any sum of them but far below
# any finite score
VALID_THRESH = -1e28

# --------------------------------------------------------------------- #
# layout utilities
# --------------------------------------------------------------------- #
def build_row_luts(layout: np.ndarray):
    """Per-(head, query-block) list of active key-block indices.

    Returns (lut, cnt): lut (H, nq, A) int32 padded with 0, cnt (H, nq)
    int32; A = max active blocks over all rows (>= 1)."""
    H, nq, _ = layout.shape
    cnt = layout.sum(axis=-1).astype(np.int32)
    A = max(int(cnt.max()) if cnt.size else 0, 1)
    lut = np.zeros((H, nq, A), dtype=np.int32)
    for h in range(H):
        for r in range(nq):
            idx = np.nonzero(layout[h, r])[0]
            lut[h, r, :len(idx)] = idx
    return lut, cnt


def build_col_luts(layout: np.ndarray):
    """Column-wise LUTs (which query blocks touch each key block)."""
    return build_row_luts(np.ascontiguousarray(layout.transpose(0, 2, 1)))


def layout_additive_mask(layout: np.ndarray, block: int) -> np.ndarray:
    """Expand a block layout to a dense (H, S, S) additive mask (0 keep /
    NEG_INF drop) — the oracle path."""
    dense = np.kron(layout, np.ones((block, block), dtype=np.int32))
    return np.where(dense != 0, 0.0, NEG_INF).astype(np.float32)


def _to_additive(mask, mode):
    mask = mask.float()
    if mode == "add":
        return mask
    if mode == "mul":
        return torch.where(mask == 0, NEG_INF, 0.0)
    raise ValueError(f"mask mode must be 'add' or 'mul', got {mode!r}")


# --------------------------------------------------------------------- #
# oracle
# --------------------------------------------------------------------- #
def block_sparse_attention_reference(q, k, v, layout, sm_scale=None,
                                     key_padding_mask=None,
                                     key_padding_mask_mode="add",
                                     attn_mask=None, attn_mask_mode="mul",
                                     rpe=None):
    """Dense-masked attention equivalent to the block-sparse kernels.

    q, k, v: (B, H, S, D). layout: numpy (H, nb, nb). Rows with no valid
    key (structurally or via masks) produce zero output."""
    B, H, S, D = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    block = S // layout.shape[1]
    s = (q.float() @ k.float().transpose(-1, -2)) * sm_scale
    if rpe is not None:
        s = s + rpe.float()
    if key_padding_mask is not None:
        kpm = _to_additive(key_padding_mask, key_padding_mask_mode)
        s = s + kpm[:, None, None, :]
    if attn_mask is not None:
        am = _to_additive(attn_mask, attn_mask_mode)
        s = s + am[None, None, :, :]
    s = s + torch.from_numpy(layout_additive_mask(layout, block)).to(
        q.device)[None]
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.where(m <= VALID_THRESH, 0.0, m)
    p = torch.where(s > VALID_THRESH, torch.exp(s - m_safe), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(l == 0.0, 1.0, l)
    return (p @ v.float()).to(q.dtype)


# --------------------------------------------------------------------- #
# the v1 kernels K14-K16: one walk per block row (K14, K15) or block
# column (K16) over the layout's nonzero triples
# --------------------------------------------------------------------- #
def build_triples(layout: np.ndarray):
    """Flatten a (H, nr, nc) layout into row-major nonzero triples.

    Returns int32 arrays (trow, tcol, tfirst, tlast, tvalid), each (T,):
    trow = h * nr + r, tcol = c, tfirst/tlast mark row boundaries, and
    empty rows contribute a single valid=0 dummy so every output block is
    produced."""
    H, nr, _ = layout.shape
    trow, tcol, tfirst, tlast, tvalid = [], [], [], [], []
    for h in range(H):
        for r in range(nr):
            idx = np.nonzero(layout[h, r])[0]
            valid = 1
            if len(idx) == 0:
                idx, valid = np.array([0]), 0
            n = len(idx)
            trow.extend([h * nr + r] * n)
            tcol.extend(int(c) for c in idx)
            tfirst.extend([1] + [0] * (n - 1))
            tlast.extend([0] * (n - 1) + [1])
            tvalid.extend([valid] * n)
    return tuple(np.asarray(x, np.int32)
                 for x in (trow, tcol, tfirst, tlast, tvalid))


def _triple_walk(triples):
    """(offs, partner, valid) of :func:`build_triples`' output: item i's
    triples are ``[offs[i], offs[i + 1])`` in the order JAX's grid walks
    them (every item has one, a dummy when its row is empty)."""
    trow, tcol, tfirst, _, tvalid = triples
    offs = np.append(np.nonzero(tfirst)[0], len(tfirst)).astype(np.int32)
    return offs, tcol, tvalid


class TriplePlan:
    """The walks of K14-K16 over one layout (H, nb, nb) at ``block``:
    ``rows`` the row-major triples (items h * nq + r: K14 and K15),
    ``cols`` those of the transposed layout (items h * nk + c: K16), each
    ``(offs, partner, valid)`` (:func:`_triple_walk`). Device copies are
    made once per device."""

    def __init__(self, layout: np.ndarray, block: int):
        layout = np.asarray(layout)
        self.block = int(block)
        self.heads, self.nq, self.nk = layout.shape
        self.seq = self.nq * self.block
        self.tiles_walked = int(np.count_nonzero(layout))
        self.rows = _triple_walk(build_triples(layout))
        self.cols = _triple_walk(build_triples(
            np.ascontiguousarray(layout.transpose(0, 2, 1))))
        self._device = {}

    def device(self, which: str, device) -> Tuple[torch.Tensor, ...]:
        """``rows`` or ``cols`` as int32 tensors on ``device``."""
        key = (which, str(device))
        got = self._device.get(key)
        if got is None:
            got = tuple(torch.from_numpy(a).to(device)
                        for a in getattr(self, which))
            self._device[key] = got
        return got


# plain versions: the kernels' walks in PyTorch, batched over every
# (batch, head, block row or column) item, one walk position per step
def _v1_steps(plan: TriplePlan, which: str, device):
    """Per walk position t of the ``rows`` or ``cols`` walk: the walked
    items, their partner block items (same head), the partner blocks and
    whether each triple is real, as tensors on ``device``."""
    offs, partner, valid = getattr(plan, which)
    cnts = np.diff(offs)
    per_head = plan.nq if which == "rows" else plan.nk
    n_partner = plan.nk if which == "rows" else plan.nq
    for t in range(int(cnts.max(initial=0))):
        live = np.nonzero(cnts > t)[0]
        at = offs[live] + t
        yield tuple(torch.from_numpy(a.astype(np.int64)).to(device) for a in (
            live, live // per_head * n_partner + partner[at], partner[at])) \
            + (torch.from_numpy(valid[at] == 1).to(device),)


def _v1_scores(qt, kt, sm_scale, kpm_t, am_t, real):
    """(q . k) * sm_scale summed in the kernels' order, then the key
    mask's row, then the attention mask's tile, in fp32; ``NEG_INF``
    across a dummy triple's tile."""
    s = ordered_dot(qt, kt) * sm_scale
    if kpm_t is not None:
        s = s + kpm_t
    if am_t is not None:
        s = s + am_t
    return torch.where(real[:, None, None], s, NEG_INF)


def _v1_masks(key_mask, attn_mask, plan: TriplePlan):
    """The key mask as (B, nk, 1, b) and the (S, S) attention mask as
    (nq, b, nk, b) blocks (each None when absent)."""
    b = plan.block
    return (None if key_mask is None else
            key_mask.reshape(key_mask.shape[0], plan.nk, 1, b),
            None if attn_mask is None else
            attn_mask.reshape(plan.nq, b, plan.nk, b))


def bs_fwd_plain(q, k, v, key_mask, attn_mask, plan: TriplePlan,
                 sm_scale: float):
    """K14's function in plain PyTorch: per walked triple an fp32 online
    softmax step (no ``m_safe`` guard), ``p = 0`` where ``s <=
    VALID_THRESH``, p rounded to V's dtype before P.V. q, k, v (B, H, S,
    D); ``key_mask`` (B, S) and ``attn_mask`` (S, S) additive fp32 or None
    -> o (q's dtype), lse (B, H, S) fp32. A row with no valid key writes
    o = 0 and lse = its running max (``NEG_INF`` for an empty block
    row)."""
    B, H, S, D = q.shape
    b, rows = plan.block, H * plan.nq
    qb, kb, vb = (x.reshape(B, rows, b, D) for x in (q, k, v))
    kpmb, amb = _v1_masks(key_mask, attn_mask, plan)
    m = torch.full((B, rows, b), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, rows, b, D), dtype=torch.float32, device=q.device)
    for li, kid, col, real in _v1_steps(plan, "rows", q.device):
        s = _v1_scores(qb[:, li], kb[:, kid], sm_scale,
                       None if kpmb is None else kpmb[:, col],
                       None if amb is None else amb[li % plan.nq, :, col],
                       real)
        m_old = m[:, li]
        m_new = torch.maximum(m_old, s.amax(dim=-1))
        p = torch.where(s > VALID_THRESH, torch.exp(s - m_new[..., None]),
                        0.0)
        alpha = torch.exp(m_old - m_new)
        l[:, li] = l[:, li] * alpha + p.sum(dim=-1)
        acc[:, li] = acc[:, li] * alpha[..., None] + \
            p.to(v.dtype).float() @ vb[:, kid].float()
        m[:, li] = m_new
    l_safe = torch.where(l == 0.0, 1.0, l)
    o = (acc / l_safe[..., None]).to(q.dtype).reshape(B, H, S, D)
    lse = (m + torch.log(l_safe)).reshape(B, H, S)
    return o, lse


def bs_dq_plain(q, k, v, do, lse, delta, key_mask, attn_mask,
                plan: TriplePlan, sm_scale: float):
    """K15's function in plain PyTorch over the row triples: p recomputed
    from lse, ds = p * (dp - delta) rounded to K's dtype, dq scaled by
    sm_scale at the end."""
    B, H, S, D = q.shape
    b, rows = plan.block, H * plan.nq
    qb, kb, vb, dob = (x.reshape(B, rows, b, D) for x in (q, k, v, do))
    lseb, dlb = (x.reshape(B, rows, b) for x in (lse, delta))
    kpmb, amb = _v1_masks(key_mask, attn_mask, plan)
    acc = torch.zeros((B, rows, b, D), dtype=torch.float32, device=q.device)
    for li, kid, col, real in _v1_steps(plan, "rows", q.device):
        kt = kb[:, kid]
        s = _v1_scores(qb[:, li], kt, sm_scale,
                       None if kpmb is None else kpmb[:, col],
                       None if amb is None else amb[li % plan.nq, :, col],
                       real)
        p = torch.where(s > VALID_THRESH,
                        torch.exp(s - lseb[:, li, :, None]), 0.0)
        ds = p * (ordered_dot(dob[:, li], vb[:, kid]) - dlb[:, li, :, None])
        acc[:, li] += ds.to(k.dtype).float() @ kt.float()
    return (acc * sm_scale).to(q.dtype).reshape(B, H, S, D)


def bs_dkv_plain(q, k, v, do, lse, delta, key_mask, attn_mask,
                 plan: TriplePlan, sm_scale: float):
    """K16's function in plain PyTorch over the column triples: p
    recomputed with the key block's mask row and the partner query
    block's lse, dv from p rounded to do's dtype, dk from ds rounded to
    q's dtype, dk scaled by sm_scale at the end; a key block that no
    query block walks writes dk = dv = 0. Returns (dk, dv) shaped like
    k."""
    B, H, S, D = q.shape
    b = plan.block
    qb, kb, vb, dob = (x.reshape(B, H * plan.nq, b, D)
                       for x in (q, k, v, do))
    lseb, dlb = (x.reshape(B, H * plan.nq, b) for x in (lse, delta))
    kpmb, amb = _v1_masks(key_mask, attn_mask, plan)
    acc_k = torch.zeros((B, H * plan.nk, b, D), dtype=torch.float32,
                        device=q.device)
    acc_v = torch.zeros_like(acc_k)
    for li, qid, row, real in _v1_steps(plan, "cols", q.device):
        qt, dot = qb[:, qid], dob[:, qid]
        col = li % plan.nk
        s = _v1_scores(qt, kb[:, li], sm_scale,
                       None if kpmb is None else kpmb[:, col],
                       None if amb is None else amb[row, :, col], real)
        p = torch.where(s > VALID_THRESH,
                        torch.exp(s - lseb[:, qid, :, None]), 0.0)
        acc_v[:, li] += p.to(do.dtype).float().transpose(-1, -2) @ \
            dot.float()
        ds = p * (ordered_dot(dot, vb[:, li]) - dlb[:, qid, :, None])
        acc_k[:, li] += ds.to(q.dtype).float().transpose(-1, -2) @ \
            qt.float()
    return ((acc_k * sm_scale).to(k.dtype).reshape(B, H, S, D),
            acc_v.to(v.dtype).reshape(B, H, S, D))


# the kernels' wrappers
def v1_arity(key_mask, attn_mask) -> str:
    """The name of the arity a call of K14-K16 runs: ``"am kpm"``,
    ``"am"``, ``"kpm"`` or ``"plain"``."""
    return " ".join(n for n, t in (("am", attn_mask), ("kpm", key_mask))
                    if t is not None) or "plain"


def _v1_check(q, k, v, key_mask, attn_mask, plan: TriplePlan, bwd=()):
    """What the kernels and their plain versions both require, and on
    CUDA what the kernels take; ``bwd``: (do, lse, delta)."""
    if q.dim() != 4 or q.shape != k.shape or k.shape != v.shape:
        raise ValueError(f"K14-K16 take one (B, H, S, D) shape for q, k "
                         f"and v, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, S, D = q.shape
    if (H, S) != (plan.heads, plan.seq):
        raise ValueError(f"layout of {plan.heads} heads over {plan.seq} vs "
                         f"inputs {tuple(q.shape)}")
    for name, t, shape in (("key mask", key_mask, (B, S)),
                           ("attention mask", attn_mask, (S, S))):
        if t is not None and (tuple(t.shape) != shape
                              or t.dtype != torch.float32):
            raise ValueError(f"K14-K16 take an fp32 {shape} {name}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if q.device.type == "cpu":
        return
    if q.device.type != "cuda":
        raise ValueError(f"K14-K16 run on cuda or cpu, not {q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"K14-K16 take {list(_DTYPE_CODE)}, got {q.dtype}")
    for t in (k, v, *bwd[:1]):
        if t.dtype != q.dtype:
            raise TypeError(f"K14-K16 take one dtype for q, k, v and do, "
                            f"got {q.dtype} and {t.dtype}")
    for t in bwd[1:]:
        if t.dtype != torch.float32:
            raise TypeError(f"K14-K16 take fp32 lse and delta, got "
                            f"{t.dtype}")
    for t in (q, k, v, key_mask, attn_mask, *bwd):
        if t is not None and (t.device != q.device
                              or not t.is_contiguous()):
            raise ValueError(f"K14-K16 take contiguous operands on "
                             f"{q.device}, got one on {t.device}")
    if D % 8 != 0 or D > MAX_HEAD_DIM:
        raise ValueError(f"K14-K16 take head_dim a multiple of 8 up to "
                         f"{MAX_HEAD_DIM}, got {D}")
    if plan.block not in KERNEL_BLOCKS:
        raise ValueError(f"K14-K16 take blocks {KERNEL_BLOCKS} on the "
                         f"card, got {plan.block}")
    if B * H > 65535:
        raise ValueError(f"K14-K16 take B*H <= 65535, got {B * H}")


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_v1_fns = {}


def _v1_check_fwd_aligned(q, k, v, key_mask=None, attn_mask=None):
    """K14's operands for its tensor-core body (o, allocated by the
    wrapper, is aligned)."""
    _check_aligned("v1 forward", FWD_BODIES, q.dtype,
                   (("q", q), ("k", k), ("v", v), ("key_mask", key_mask),
                    ("attn_mask", attn_mask)))


def _v1_check_bwd_aligned(q, k, v, do, key_mask=None, attn_mask=None):
    """K15's and K16's operands for their tensor-core bodies, which take
    the same operands and the same alignment (dq, dk and dv, allocated by
    the wrappers, are aligned)."""
    _check_aligned("v1 backward", DQ_BODIES, q.dtype,
                   (("q", q), ("k", k), ("v", v), ("do", do),
                    ("key_mask", key_mask), ("attn_mask", attn_mask)))


def _v1_launch(name, q, ptrs, plan: TriplePlan, sm_scale):
    """Launch ``name`` of ``csrc/blocksparse.cu`` (built and typed at
    first use) on q's device and current stream; raise on a refused
    launch. After the pointers: dtype, bh, heads, seq, head_dim, block,
    sm_scale, stream."""
    fn = _v1_fns.get(name)
    if fn is None:
        from deepspeed_tpu_torch.ops._build import load
        fn = getattr(load("blocksparse.cu"), name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_void_p]
        _v1_fns[name] = fn
    B, H, S, D = q.shape
    args = [None if t is None else t.data_ptr() for t in ptrs] + [
        _DTYPE_CODE[q.dtype], B * H, H, S, D, plan.block, float(sm_scale)]
    with torch.cuda.device(q.device):
        err = fn(*args, torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _v1_count(wrapper, key_mask, attn_mask):
    """One launch of ``wrapper``'s kernel: ``launches`` counts every
    launch, ``arities`` every launch by :func:`v1_arity`."""
    wrapper.launches += 1
    name = v1_arity(key_mask, attn_mask)
    wrapper.arities[name] = wrapper.arities.get(name, 0) + 1


@counted_flops("bs_fwd", uncounted)
def bs_fwd(q, k, v, key_mask, attn_mask, plan: TriplePlan, sm_scale: float):
    """K14: ``(o, lse)`` of :func:`bs_fwd_plain`. A CUDA ``q`` launches
    the sm_90a kernel (raising on any dtype, shape, device, alignment or
    launch problem), its tensor-core body in bf16 and its CUDA-core body
    in fp32 (:data:`FWD_BODIES`, counted in ``bodies``); a CPU ``q`` runs
    the plain version."""
    _v1_check(q, k, v, key_mask, attn_mask, plan)
    if q.device.type == "cpu":
        return bs_fwd_plain(q, k, v, key_mask, attn_mask, plan, sm_scale)
    _v1_check_fwd_aligned(q, k, v, key_mask, attn_mask)
    B, H, S, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    _v1_launch("bs_fwd", q, [q, k, v, key_mask, attn_mask, o, lse,
                             *plan.device("rows", q.device)], plan, sm_scale)
    _v1_count(bs_fwd, key_mask, attn_mask)
    _count_body(bs_fwd, q.dtype, FWD_BODIES)
    return o, lse


@counted_flops("bs_dq", uncounted)
def bs_dq(q, k, v, do, lse, delta, key_mask, attn_mask, plan: TriplePlan,
          sm_scale: float, tally=None):
    """K15: ``dq`` of :func:`bs_dq_plain`. A CUDA ``q`` launches the sm_90a
    kernel (raising on any dtype, shape, device, alignment or launch
    problem), its tensor-core body in bf16 and its CUDA-core body in fp32
    (:data:`DQ_BODIES`, counted in ``bodies``); a CPU ``q`` runs the plain
    version. ``tally`` (a measurement): None, or one int64 on q's device
    to which the tensor-core body adds the cells it sums again in the
    plain order."""
    _v1_check(q, k, v, key_mask, attn_mask, plan, (do, lse, delta))
    if q.device.type == "cpu":
        return bs_dq_plain(q, k, v, do, lse, delta, key_mask, attn_mask,
                           plan, sm_scale)
    _v1_check_bwd_aligned(q, k, v, do, key_mask, attn_mask)
    _check_tally(tally, q)
    dq = torch.empty_like(q)
    _v1_launch("bs_dq", q, [q, k, v, do, lse, delta, key_mask, attn_mask,
                            dq, tally, *plan.device("rows", q.device)], plan,
               sm_scale)
    _v1_count(bs_dq, key_mask, attn_mask)
    _count_body(bs_dq, q.dtype, DQ_BODIES)
    return dq


@counted_flops("bs_dkv", uncounted)
def bs_dkv(q, k, v, do, lse, delta, key_mask, attn_mask, plan: TriplePlan,
           sm_scale: float, tally=None):
    """K16: ``(dk, dv)`` of :func:`bs_dkv_plain`; on CUDA as :func:`bs_dq`
    (:data:`DKV_BODIES`), plain version on the CPU."""
    _v1_check(q, k, v, key_mask, attn_mask, plan, (do, lse, delta))
    if q.device.type == "cpu":
        return bs_dkv_plain(q, k, v, do, lse, delta, key_mask, attn_mask,
                            plan, sm_scale)
    _v1_check_bwd_aligned(q, k, v, do, key_mask, attn_mask)
    _check_tally(tally, q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _v1_launch("bs_dkv", q, [q, k, v, do, lse, delta, key_mask, attn_mask,
                             dk, dv, tally, *plan.device("cols", q.device)],
               plan, sm_scale)
    _v1_count(bs_dkv, key_mask, attn_mask)
    _count_body(bs_dkv, q.dtype, DKV_BODIES)
    return dk, dv


def reset_launches():
    """Set every launch count of K14-K16 to 0, also by body."""
    for w in (bs_fwd, bs_dq, bs_dkv):
        w.launches = 0
        w.arities = {}
        w.bodies = {}


reset_launches()


class _Triples(torch.autograd.Function):
    """Forward K14, saving (q, k, v, key_mask, attn_mask, o, lse);
    backward delta = sum(do * o) in fp32, then K15 and K16. The key mask
    and the attention mask take no gradient: zeros where asked for, as
    the JAX package's vjp returns."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, attn_mask, plan, sm_scale):
        o, lse = bs_fwd(q, k, v, key_mask, attn_mask, plan, sm_scale)
        ctx.save_for_backward(q, k, v, key_mask, attn_mask, o, lse)
        ctx.plan, ctx.sm_scale = plan, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, key_mask, attn_mask, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = (do.float() * o.float()).sum(dim=-1)
        args = (key_mask, attn_mask, ctx.plan, ctx.sm_scale)
        dq = bs_dq(q, k, v, do, lse, delta, *args)
        dk, dv = bs_dkv(q, k, v, do, lse, delta, *args)
        zero = [torch.zeros_like(t) if t is not None and need else None
                for t, need in ((key_mask, ctx.needs_input_grad[3]),
                                (attn_mask, ctx.needs_input_grad[4]))]
        return dq, dk, dv, *zero, None, None


def triple_attention(q, k, v, plan: TriplePlan, attn_mask=None,
                     key_mask=None, sm_scale: Optional[float] = None):
    """Block-sparse attention over ``plan``'s triples under the optional
    additive (S, S) ``attn_mask`` and additive (B, S) ``key_mask``, with
    the custom backward: K14 forward, K15 and K16 backward."""
    if sm_scale is None:
        sm_scale = float(q.shape[-1]) ** -0.5
    key_mask, attn_mask = (None if t is None else t.float().contiguous()
                           for t in (key_mask, attn_mask))
    return _Triples.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                          key_mask, attn_mask, plan, float(sm_scale))


# --------------------------------------------------------------------- #
# dispatch
# --------------------------------------------------------------------- #
_FN_CACHE = {}

# the masked flash kernels K1-K3 for every layout without a user attention
# mask; flip off to reach the legacy dispatch (banded / hybrid / v2 / coarse)
USE_MASKED_FLASH = True
# the row-run kernels K8-K10 with a user attention mask and within the
# legacy dispatch; off reaches the per-triple v1 kernels K14-K16 (JAX's
# test oracle for K8-K10, never picked on its own)
USE_SPLASH_V2 = True
# the banded kernels K11-K13 for global-prefix + sliding-window layouts
USE_BANDED = True
# the hybrid: K11-K13 on the banded sub-pattern, K8-K10 on the residue
USE_HYBRID = True
# coarse walks of K8-K10 (_pick_coarse_block)
USE_COARSE = True
# the coarse walk of the row-run kernels: None = the rule below, 0 = the
# fine walk, N = force N
_FORCE_COARSE_BLOCK = None
_COARSE_TILE_BUDGET = 256 * 2 ** 20   # bytes of unique (cb, cb) tiles


def _pick_coarse_block(layout: np.ndarray, block: int, has_am: bool):
    """The coarse walk tile of the row-run kernels, or None (JAX's rule
    with this card's candidates and costs): coarsening must beat the fine
    walk's modeled cost (:func:`walk_cost_us`, "blocksparse_v2": they
    compute every chunk of a walked tile) by more than 10% and keep the
    unique mask tiles under the byte budget (per coordinate with a user
    mask, by content without). A fine block the kernels cannot take costs
    the fine walk nothing finite, so any admitted coarse tile is taken."""
    if not USE_COARSE:
        return None
    H, nq, nk = layout.shape
    if _FORCE_COARSE_BLOCK is not None:
        cb = _FORCE_COARSE_BLOCK
        if not cb:
            return None
        if not (cb > block and cb % block == 0 and cb in KERNEL_BLOCKS
                and (nq * block) % cb == 0 and (nk * block) % cb == 0):
            raise ValueError(f"_FORCE_COARSE_BLOCK={cb} incompatible with "
                             f"block={block}, S=({nq * block}, "
                             f"{nk * block})")
        return cb
    nnz_f = int(np.count_nonzero(layout))
    r_f = min(block, CHUNK)
    fine_cost = (walk_cost_us("blocksparse_v2", nnz_f,
                              nnz_f * (block // r_f) ** 2, r_f)
                 if block in KERNEL_BLOCKS else float("inf"))
    best = None
    for cb in COARSE_WALK_BLOCKS:
        if cb <= block or cb % block or (nq * block) % cb or \
                (nk * block) % cb:
            continue
        nnz_c, n_unique = build_coarse_index(layout, block, cb,
                                             per_coord=has_am,
                                             count_only=True)
        if n_unique * cb * cb * 4 > _COARSE_TILE_BUDGET:
            continue
        r = min(cb, CHUNK)
        cost = walk_cost_us("blocksparse_v2", nnz_c,
                            nnz_c * (cb // r) ** 2, r)
        if cost < fine_cost * 0.9 and (best is None or cost < best[0]):
            best = (cost, cb)
    return best[1] if best else None


def planned_kernel(layout, block, has_am=False, cpu=False) -> str:
    """Which route :func:`block_sparse_attention` takes for this layout
    (reporting only), JAX's names: ``'masked'`` / ``'masked-coarse<N>'``
    (K1-K3, the default without a user mask), and under
    ``USE_MASKED_FLASH = False`` ``'banded'`` (K11-K13), ``'hybrid'``
    (K11-K13 and K8-K10), ``'v2'`` / ``'v2-coarse<N>'`` (K8-K10 at the
    layout's block or over a walk of N, the fine structure in the tiles),
    ``'masked-fallback'`` (K1-K3 where K8-K10 cannot walk) or ``'v1'``
    (``USE_SPLASH_V2 = False``: K14-K16). With a user attention
    mask ``'v2'`` or ``'v2-coarse<N>'``. ``cpu``: the rule for CPU
    tensors, in place of JAX's ``interpret``."""
    layout = np.asarray(layout)
    if USE_MASKED_FLASH and not has_am:
        bm = BlockMask.from_layout(layout, block)
        return (f"masked-coarse{bm.block}" if bm.block != block
                else "masked")
    if USE_BANDED and not has_am:
        if banded.plan(layout, block, cpu) is not None:
            return "banded"
        if USE_HYBRID and USE_SPLASH_V2 and \
                hybrid.plan_hybrid(layout, block, cpu) is not None:
            return "hybrid"
    if not USE_SPLASH_V2:
        return "v1"
    coarse = _pick_coarse_block(layout, block, has_am)
    if has_am or cpu or block in KERNEL_BLOCKS or coarse is not None:
        return f"v2-coarse{coarse}" if coarse else "v2"
    return "masked-fallback"


def _sparse_attention_fn(layout: np.ndarray, block: int, sm_scale: float,
                         has_am: bool, cpu: bool = False):
    """``f(q, k, v, key_mask[, attn_mask])`` for the layout, cached per
    layout, block, scale, route, device kind and every flag: the route
    :func:`planned_kernel` names. ``key_mask`` is the additive fp32
    ``(B, S)`` key mask or None, ``attn_mask`` the additive ``(S, S)``
    mask."""
    key = (layout.shape, layout.tobytes(), block, float(sm_scale), has_am,
           cpu, USE_MASKED_FLASH, USE_SPLASH_V2, USE_COARSE,
           _FORCE_COARSE_BLOCK, _COARSE_TILE_BUDGET, USE_BANDED, USE_HYBRID,
           banded._FORCE_BLOCKS)
    fn = _FN_CACHE.get(key)
    if fn is not None:
        return fn
    route = planned_kernel(layout, block, has_am, cpu)
    if route in ("masked", "masked-fallback") or \
            route.startswith("masked-coarse"):
        bm = BlockMask.from_layout(layout, block)

        def fn(q, k, v, key_mask):
            return masked_flash_attention(q, k, v, bm, key_mask=key_mask,
                                          sm_scale=sm_scale)
    elif route == "banded":
        params, blocks = banded.plan(layout, block, cpu)
        fn = banded.build_banded_fn(layout.shape, block, params, sm_scale,
                                    blocks)
    elif route == "hybrid":
        fn = hybrid.build_hybrid_fn(layout, block,
                                    hybrid.plan_hybrid(layout, block, cpu),
                                    sm_scale)
    elif route == "v1":
        tplan = TriplePlan(layout, block)

        def fn(q, k, v, key_mask, attn_mask=None):
            return triple_attention(q, k, v, tplan, attn_mask,
                                    key_mask=key_mask, sm_scale=sm_scale)
    else:
        plan = RowRunPlan(layout, block,
                          _pick_coarse_block(layout, block, has_am),
                          per_coord=has_am)
        if has_am:
            def fn(q, k, v, key_mask, attn_mask):
                return row_run_attention(q, k, v, plan, attn_mask,
                                         key_mask=key_mask,
                                         sm_scale=sm_scale)
        else:
            def fn(q, k, v, key_mask):
                return row_run_attention(q, k, v, plan, key_mask=key_mask,
                                         sm_scale=sm_scale)
        fn.kernel_kind = route
    _FN_CACHE[key] = fn
    return fn


# --------------------------------------------------------------------- #
# public API
# --------------------------------------------------------------------- #
def block_sparse_attention(q, k, v, layout, sm_scale: Optional[float] = None,
                           key_padding_mask=None,
                           key_padding_mask_mode: str = "add",
                           attn_mask=None, attn_mask_mode: str = "mul",
                           rpe=None, force_reference: bool = False):
    """Block-sparse attention.

    q, k, v: (B, H, S, D); layout: numpy int (H, nb, nb) from a
    SparsityConfig (block size = S // nb). key_padding_mask: (B, S);
    attn_mask: (S, S); modes per the reference's sparse softmax ('add'
    adds values, 'mul' drops zero entries). rpe (dense additive
    (B, H, S, S)) and ``force_reference`` route through the dense
    reference. Otherwise the call runs the route :func:`planned_kernel`
    names: the masked flash kernels K1-K3, or with an ``attn_mask`` the
    row-run kernels K8-K10, or under ``USE_MASKED_FLASH = False`` the
    legacy dispatch, or under ``USE_SPLASH_V2 = False`` the v1 kernels
    K14-K16 (their plain versions on CPU tensors).
    """
    B, H, S, D = q.shape
    layout = np.asarray(layout)
    if layout.ndim != 3 or layout.shape[0] != H:
        raise ValueError(f"layout heads {layout.shape} vs q heads {H}")
    if S % layout.shape[1] != 0:
        raise ValueError(f"layout {layout.shape} does not tile seq {S}")
    block = S // layout.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    if force_reference or rpe is not None:
        return block_sparse_attention_reference(
            q, k, v, layout, sm_scale=sm_scale,
            key_padding_mask=key_padding_mask,
            key_padding_mask_mode=key_padding_mask_mode,
            attn_mask=attn_mask, attn_mask_mode=attn_mask_mode, rpe=rpe)
    kpm = (None if key_padding_mask is None else
           _to_additive(key_padding_mask, key_padding_mask_mode))
    fn = _sparse_attention_fn(layout, block, float(sm_scale),
                              attn_mask is not None,
                              cpu=q.device.type == "cpu")
    if attn_mask is None:
        return fn(q, k, v, kpm)
    return fn(q, k, v, kpm, _to_additive(attn_mask, attn_mask_mode).to(
        q.device))
