"""Hybrid banded + residual block-sparse attention (the port of
``deepspeed_tpu/ops/sparse_attention/hybrid.py``).

BigBird layouts (random blocks + sliding window + global blocks) are
mostly banded. The hybrid splits the layout exactly:

    banded part   = the maximal global-prefix + band predicate under the
                    head intersection of the layout (so the banded
                    kernels stay head-uniform when random blocks differ
                    per head)
    residual part = layout & ~banded  (per head; the random blocks)

and runs the banded kernels K11-K13 (``banded.py``) on the first and the
row-run kernels K8-K10 without a mask tile (``blocksparse_v2.py``, the
fine walk of the residual layout) on the second. The parts partition the
kept cells, so the softmax is recovered by the merge on the per-part
log-sum-exp:

    L   = logaddexp(lse_banded, lse_residual)
    out = exp(lse_banded - L) * o_banded + exp(lse_residual - L) * o_res

The backward needs no new kernel: ``ds = p * (dp - delta)`` only uses
the merged row statistics, so each part's backward gets the merged L and
the merged output, and their dq, dk, dv add (each touches only its own
cells).

The dispatch (``blocksparse._sparse_attention_fn``) tries the exact
banded path, then this one. JAX engages the hybrid only where its v2
walk can stream the residual (128-multiple blocks, compiled); the port's
condition is that K8-K10 take the fine block (``KERNEL_BLOCKS``), or the
tensors lie on the CPU.
"""

from typing import NamedTuple, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.ops.attention.masked_flash import KERNEL_BLOCKS
from deepspeed_tpu_torch.ops.sparse_attention.banded import (
    NEG_INF, BandedParams, BandedPlan, _blocks_valid, banded_bwd_impl,
    banded_fwd_impl, pick_blocks, walk_stats)
from deepspeed_tpu_torch.ops.sparse_attention.blocksparse_v2 import (
    RowRunPlan, blocksparse_v2_fwd, row_run_bwd)

__all__ = ["HybridPlan", "detect_banded_subpattern", "plan_hybrid",
           "build_hybrid_fn", "hybrid_stats", "merge"]

# the banded part must cover at least this fraction of the layout's
# active cells: below it the residual walk dominates anyway and the
# extra banded pass + merge is pure overhead
_MIN_COVERAGE = 0.5


class HybridPlan(NamedTuple):
    params: BandedParams
    blocks: tuple             # (bq, bkv) banded walk tiles
    residual: np.ndarray      # (H, nb, nb) 0/1 residual layout
    coverage: float           # banded cells / total active cells


def detect_banded_subpattern(layout: np.ndarray) -> Optional[tuple]:
    """Maximal (BandedParams, residual, coverage) with the banded
    predicate a SUBSET of every head's layout (fit under the head
    intersection); the leftover cells become the residual."""
    L = np.asarray(layout).astype(bool)
    if L.ndim != 3 or L.shape[1] != L.shape[2] or L.shape[1] == 0:
        return None
    base = L.all(axis=0)                  # head-intersection
    n = base.shape[0]
    idx = np.arange(n)
    rb, cb = idx[:, None], idx[None, :]
    best = None
    for causal in (False, True):
        clip = (cb <= rb) if causal else np.ones((n, n), bool)
        covered = base | ~clip            # cells set-or-clipped-away
        row_full = covered.all(axis=1)
        col_full = covered.all(axis=0)
        g_r = 0
        while g_r < n and row_full[g_r]:
            g_r += 1
        g_c = 0
        while g_c < n and col_full[g_c]:
            g_c += 1
        if g_r >= n:                      # fully dense under this clip
            continue
        # max w with every |rb-cb| <= w diagonal fully set inside the
        # non-global region (w = -1: no full diagonal -> no band)
        region = (rb >= g_r) & (cb >= g_c) & clip
        w = -1
        for cand in range(n):
            diag = region & (np.abs(rb - cb) == cand)
            if not base[diag].all():
                break
            w = cand
        if w < 0:
            continue
        pred = ((rb < g_r) | (cb < g_c) | (np.abs(rb - cb) <= w)) & clip
        total = int(L.sum())
        if total == 0:
            continue
        coverage = L.shape[0] * int(pred.sum()) / total
        if best is None or coverage > best[2]:
            residual = (L & ~pred[None]).astype(np.int32)
            best = (BandedParams(g_r, g_c, w, bool(causal)),
                    residual, coverage)
    return best


def plan_hybrid(layout: np.ndarray, fine_block: int,
                cpu: bool) -> Optional[HybridPlan]:
    """THE hybrid-dispatch decision (mirrors banded.plan): a HybridPlan
    when the split pays, else None. Declines when the residual is empty
    (the exact banded path owns that), when coverage is too low, or on
    the card when K8-K10 cannot walk the residual at the fine block."""
    if not cpu and fine_block not in KERNEL_BLOCKS:
        return None
    det = detect_banded_subpattern(layout)
    if det is None:
        return None
    params, residual, coverage = det
    if residual.sum() == 0 or coverage < _MIN_COVERAGE:
        return None
    S = np.asarray(layout).shape[1] * fine_block
    blocks = pick_blocks(S, fine_block, params, cpu)
    if blocks is None or not _blocks_valid(S, *blocks, cpu):
        return None
    return HybridPlan(params, blocks, residual, coverage)


def merge(o_b, lse_b, lse_g, o_r, lse_r):
    """(o, L): the two parts' outputs merged by their row log-sum-exp, o
    in the parts' dtype. The global-rows instance's lse folds into a
    full-length banded lse first: per row exactly one of (band, gr) holds
    mass, the other is NEG_INF."""
    lse_bf = lse_b
    if lse_g.shape[-1]:
        B, H, S = lse_b.shape
        pad = torch.full((B, H, S - lse_g.shape[-1]), NEG_INF,
                         dtype=torch.float32, device=lse_b.device)
        lse_bf = torch.logaddexp(lse_b, torch.cat([lse_g, pad], dim=-1))
    L = torch.logaddexp(lse_bf, lse_r)
    wb = torch.exp(lse_bf - L)[..., None]
    wr = torch.exp(lse_r - L)[..., None]
    o = (wb * o_b.float() + wr * o_r.float()).to(o_b.dtype)
    return o, L


class _Hybrid(torch.autograd.Function):
    """Forward both parts and merge; backward hands both parts the merged
    L and o, then adds their grads in fp32 and rounds once."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, bp, rp, sm_scale):
        o, L = merge(*banded_fwd_impl(q, k, v, key_mask, bp, sm_scale),
                     *blocksparse_v2_fwd(q, k, v, key_mask, None, rp,
                                         sm_scale))
        ctx.save_for_backward(q, k, v, key_mask, o, L)
        ctx.bp, ctx.rp, ctx.sm_scale = bp, rp, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, key_mask, o, L = ctx.saved_tensors
        do = do.contiguous()
        bp = ctx.bp
        L_g = L[:, :, :bp.GQ * bp.bq].contiguous()
        grads_b = banded_bwd_impl(q, k, v, key_mask, bp, ctx.sm_scale, o, L,
                                  L_g, do)
        grads_r = row_run_bwd(q, k, v, key_mask, None, ctx.rp, ctx.sm_scale,
                              o, L, do)
        dq, dk, dv = ((a.float() + b.float()).to(x.dtype)
                      for a, b, x in zip(grads_b, grads_r, (q, k, v)))
        dkm = (torch.zeros_like(key_mask)
               if key_mask is not None and ctx.needs_input_grad[3] else None)
        return dq, dk, dv, dkm, None, None, None


def build_hybrid_fn(layout: np.ndarray, fine_block: int, plan: HybridPlan,
                    sm_scale: float):
    """Differentiable ``f(q, k, v, key_mask) -> o`` for the hybrid path;
    the signature of ``build_banded_fn`` and the v2 route (``key_mask`` the
    additive fp32 (B, S) key mask or None). ``f.kernel_kind`` is
    "hybrid"; ``f.plan`` and ``f.residual_plan`` are the two parts'
    plans."""
    H, nb, _ = np.asarray(layout).shape
    bp = BandedPlan(H, nb * fine_block, fine_block, plan.params,
                    *plan.blocks)
    rp = RowRunPlan(plan.residual, fine_block, None, per_coord=False)

    def f(q, k, v, key_mask):
        if key_mask is not None:
            key_mask = key_mask.float().contiguous()
        return _Hybrid.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                             key_mask, bp, rp, float(sm_scale))

    f.kernel_kind = "hybrid"
    f.banded_blocks = (bp.bq, bp.bkv)
    f.hybrid_coverage = plan.coverage
    f.plan, f.residual_plan = bp, rp
    return f


def hybrid_stats(layout: np.ndarray, fine_block: int, plan: HybridPlan):
    """Static FLOP accounting for the hybrid at a geometry (JAX's): the
    banded walk's cost plus the residual walk's against the exact-sparse
    bound of the whole layout."""
    H, nb, _ = np.asarray(layout).shape
    S = nb * fine_block
    bq, bkv = plan.blocks
    # banded part: uniform across heads -> use one head's pred count
    L = np.asarray(layout).astype(bool)
    pred = L[0] & ~plan.residual[0].astype(bool)
    banded = walk_stats(S, fine_block, plan.params, bq, bkv,
                        n_active_blocks=int(pred.sum()))
    # residual v2 walk: 9 tile dots per active fine block per head
    res_nnz = int(plan.residual.sum())
    res_cells = 9 * res_nnz * fine_block * fine_block
    total_nnz = int(L.sum())
    exact = 9 * total_nnz * fine_block * fine_block
    computed = H * banded["computed_cell_dots"] + res_cells
    return {
        "banded_steps": banded["steps"],
        "banded_cell_dots_per_head": banded["computed_cell_dots"],
        "residual_nnz_blocks": res_nnz,
        "residual_cell_dots": res_cells,
        "computed_cell_dots": computed,
        "exact_cell_dots": exact,
        "waste": computed / exact if exact else None,
        "coverage": plan.coverage,
    }
