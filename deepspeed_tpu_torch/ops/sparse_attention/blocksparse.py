"""Block-sparse attention, the front end (the port of
``deepspeed_tpu/ops/sparse_attention/blocksparse.py``).

A layout from ``sparsity_config.py`` (numpy ``(H, nb, nb)``, 1 = an
attended (query-block, key-block) pair) becomes a :class:`BlockMask` of
the masked flash kernels K1-K3 (``ops/attention/masked_flash.py``),
the JAX package's default route (``USE_MASKED_FLASH``): head-uniform
layouts collapse to one mask head, banded layouts coarsen their walk
onto KIND_BAND tiles, and the key-padding mask rides the kernels'
additive ``(B, S)`` key-mask arity. The port does not pre-block the key
mask (``_block_kpm`` is a TPU lane rule).

Mask semantics (the reference's sparse softmax): scores are scaled, then
rpe added, then the key-padding mask and the attention mask applied —
'add' mode adds the mask values; 'mul' mode maps zero entries to
``NEG_INF`` and nonzero ones to 0 (a hard keep/drop mask).

Not ported: a user ``attn_mask`` (the JAX package sends it to the
row-run kernels K8-K10 of ``blocksparse_v2.py``) raises
``NotImplementedError``; the legacy dispatch behind the module flags
(banded K11-K13, v1 K14-K16) is not here. An ``rpe`` routes to the
dense reference, as in JAX.
"""

import math
from typing import Optional

import numpy as np
import torch

from deepspeed_tpu_torch.ops.attention.masked_flash import (
    BlockMask, masked_flash_attention)

__all__ = ["NEG_INF", "VALID_THRESH", "block_sparse_attention",
           "block_sparse_attention_reference", "build_row_luts",
           "build_col_luts", "layout_additive_mask", "planned_kernel"]

NEG_INF = -1e30
# scores below this are structurally masked: several -1e30 mask terms may
# stack, so the threshold sits well above any sum of them but far below
# any finite score
VALID_THRESH = -1e28

_ATTN_MASK_UNPORTED = (
    "block_sparse_attention with a user attn_mask: the JAX package runs it "
    "on the row-run block-sparse kernels K8-K10 "
    "(ops/sparse_attention/blocksparse_v2.py), which are not ported yet")


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
# dispatch
# --------------------------------------------------------------------- #
_FN_CACHE = {}


def planned_kernel(layout, block, has_am=False) -> str:
    """Which route :func:`block_sparse_attention` takes for this layout
    (reporting only): ``'masked'`` (K1-K3 at the layout's block) or
    ``'masked-coarse<N>'`` (K1-K3 over a coarsened walk of N with
    KIND_BAND tiles). A user attention mask raises: its kernels, K8-K10,
    are not ported."""
    if has_am:
        raise NotImplementedError(_ATTN_MASK_UNPORTED)
    bm = BlockMask.from_layout(np.asarray(layout), block)
    return f"masked-coarse{bm.block}" if bm.block != block else "masked"


def _sparse_attention_fn(layout: np.ndarray, block: int, sm_scale: float):
    """``f(q, k, v, key_mask)`` over the layout's :class:`BlockMask`
    (cached per layout, block and scale); ``key_mask`` the additive fp32
    ``(B, S)`` key mask or None."""
    key = (layout.shape, layout.tobytes(), block, float(sm_scale))
    fn = _FN_CACHE.get(key)
    if fn is None:
        bm = BlockMask.from_layout(layout, block)

        def fn(q, k, v, key_mask):
            return masked_flash_attention(q, k, v, bm, key_mask=key_mask,
                                          sm_scale=sm_scale)
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
    reference. Otherwise the call runs the masked flash kernels K1-K3
    (their plain versions on CPU tensors); a user ``attn_mask`` raises.
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
    if attn_mask is not None:
        raise NotImplementedError(_ATTN_MASK_UNPORTED)
    kpm = (None if key_padding_mask is None else
           _to_additive(key_padding_mask, key_padding_mask_mode))
    return _sparse_attention_fn(layout, block, float(sm_scale))(q, k, v, kpm)
