"""Banded layout detection (the port of ``BandedParams`` and
``detect_banded`` of ``deepspeed_tpu/ops/sparse_attention/banded.py``).

A banded layout (BSLongformer-class: a global prefix of rows and of
columns plus a sliding window around the diagonal, optionally clipped
causally) is a closed-form predicate on block indices:

    keep(rb, cb) = (rb < g_r) | (cb < g_c) | (|rb - cb| <= w)
                   [& cb <= rb when causal]

:func:`detect_banded` matches the realized layout bits, not the config
class. :meth:`BlockMask.from_layout` uses it to coarsen the walk of the
masked flash kernels K1-K3 onto KIND_BAND tiles, whose fine structure
the kernels evaluate per cell. The JAX module's own banded Pallas
kernels (K11-K13) are not ported yet.
"""

from typing import NamedTuple, Optional

import numpy as np

__all__ = ["BandedParams", "detect_banded"]


class BandedParams(NamedTuple):
    g_r: int      # global ROW prefix, in fine blocks (rows that see all)
    g_c: int      # global COL prefix, in fine blocks (cols all rows see)
    w: int        # band half-width, in fine blocks
    causal: bool  # block-level lower-triangular clip


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
