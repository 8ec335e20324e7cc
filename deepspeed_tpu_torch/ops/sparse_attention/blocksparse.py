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
  at the fine walk or a coarse one, and last K1-K3 ('masked-fallback').
  ``USE_SPLASH_V2 = False`` would reach the v1 kernels K14-K16, which are
  not ported: that route raises.

Where JAX asks for ``block % 128 == 0`` or ``interpret``, the port asks
for CPU tensors or a block the kernels take (``KERNEL_BLOCKS``).

The port does not pre-block the masks (``_block_kpm`` / ``_block_am`` are
a TPU lane rule), and has no dense-reference fallback for an
``attn_mask``: a walk block the kernels cannot take raises on the card.

Mask semantics (the reference's sparse softmax): scores are scaled, then
rpe added, then the key-padding mask and the attention mask applied —
'add' mode adds the mask values; 'mul' mode maps zero entries to
``NEG_INF`` and nonzero ones to 0 (a hard keep/drop mask).

An ``rpe`` routes to the dense reference, as in JAX.
"""

import math
from typing import Optional

import numpy as np
import torch

from deepspeed_tpu_torch.ops.attention.masked_flash import (
    CHUNK, COARSE_WALK_BLOCKS, KERNEL_BLOCKS, BlockMask,
    masked_flash_attention, walk_cost_us)
from deepspeed_tpu_torch.ops.sparse_attention import banded, hybrid
from deepspeed_tpu_torch.ops.sparse_attention.blocksparse_v2 import (
    RowRunPlan, build_coarse_index, row_run_attention)

__all__ = ["NEG_INF", "VALID_THRESH", "block_sparse_attention",
           "block_sparse_attention_reference", "build_row_luts",
           "build_col_luts", "layout_additive_mask", "planned_kernel"]

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
# dispatch
# --------------------------------------------------------------------- #
_FN_CACHE = {}

# the masked flash kernels K1-K3 for every layout without a user attention
# mask; flip off to reach the legacy dispatch (banded / hybrid / v2 / coarse)
USE_MASKED_FLASH = True
# the row-run kernels K8-K10 within the legacy dispatch; off reaches the
# per-triple v1 kernels K14-K16, which the port has not ported (raises)
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
    (``USE_SPLASH_V2 = False``: raises when called). With a user attention
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
        raise NotImplementedError(
            "USE_SPLASH_V2 = False routes to the v1 block-sparse kernels "
            "K14-K16 (deepspeed_tpu/ops/sparse_attention/blocksparse.py "
            "_bs_fwd_kernel, _bs_dq_kernel, _bs_dkv_kernel), which the port "
            "has not ported yet")
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
    legacy dispatch (their plain versions on CPU tensors).
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
