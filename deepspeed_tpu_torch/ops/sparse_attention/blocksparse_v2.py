"""Row-run block-sparse attention (the port of
``deepspeed_tpu/ops/sparse_attention/blocksparse_v2.py``).

The route a user ``attn_mask`` takes through ``block_sparse_attention``,
and without one the v2 route of the legacy dispatch (``USE_MASKED_FLASH =
False``) and the residue of the hybrid (``hybrid.py``): one walk per
block row over its CSR column list. With an ``attn_mask``, per walked
item a ``(b, b)`` additive mask tile picked by a uid from the UNIQUE
tiles of the head-union layout (masks are head-independent, so per-item
tiles would multiply the bytes by H); without one, no tile at the fine
walk (``tiles=None``: the kernels read none, JAX's ``has_am=False``
arity) and the structural tiles on a coarse walk. Three kernels, each
with a wrapper and a plain PyTorch version of the same function:

- :func:`blocksparse_v2_fwd` — K8, ``o`` and ``lse`` over the CSR walk
  (replaces ``_v2_fwd_kernel``);
- :func:`blocksparse_v2_dq` — K9, ``dq`` over the CSR walk (replaces
  ``_v2_dq_kernel``);
- :func:`blocksparse_v2_dkv` — K10, ``dk`` and ``dv`` over the CSC walk
  (replaces ``_v2_dkv_kernel``).

For CUDA tensors each wrapper launches its hand-written kernel in
``csrc/blocksparse_v2.cu`` (built with nvcc for sm_90a at first use) or
raises; it never falls back. In bf16 K8 runs K1's tensor-core forward
body (``csrc/mma_fwd.cuh``, :data:`FWD_BODIES`), K9 K2's dq body
(``csrc/mma_dq.cuh``, :data:`DQ_BODIES`) and K10 K3's dk/dv body
(``csrc/mma_dkv.cuh``, :data:`DKV_BODIES`); in fp32 all three run on
the CUDA cores. For CPU tensors each wrapper runs the plain version
(``*_plain``). Each launch adds one to the wrapper's ``launches`` and to
its ``bodies`` under the body it ran.
:func:`row_run_attention` is the ``torch.autograd.Function`` entry over
the three.

The walk is a :class:`RowRunPlan`: the fine layout at its block, or a
coarse walk (``build_coarse_index``) whose unique tiles carry the fine
structure as ``NEG_INF`` cells, with the user's mask folded in per
coordinate (``per_coord``) or, without a mask, deduplicated by content.
The port gathers the unique ``(U, b, b)`` tiles straight from the
``(S, S)`` additive mask: JAX's ``_block_am`` / ``_block_kpm``
pre-blocking is a TPU lane rule. JAX streams the structural tiles of a
coarse walk without a mask in bf16; the port keeps fp32 tiles holding
the bf16-rounded values (``NEG_INF`` becomes -1.0003e30), so every
result is JAX's without a second tile dtype in the kernels.

Semantics (JAX's kernels, rounding included): ``s = (q . k) * sm_scale``,
then ``s += kpm[key]``, then ``s += tile`` in fp32; ``p = 0`` where
``s <= VALID_THRESH`` (-1e29 here, not the -1e28 of ``blocksparse.py``);
no ``m_safe`` guard in the forward; ``p`` is rounded to V's dtype before
P.V and ``ds`` to K's / Q's dtype before its products; a row with
``l == 0`` writes ``o = 0`` and ``lse = m``; dq and dk are scaled by
``sm_scale`` at the end, dv is not.
"""

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

# FWD_BODIES, DQ_BODIES, DKV_BODIES: K8, K9 and K10 run K1's, K2's and
# K3's bodies, by dtype as those do
from deepspeed_tpu_torch.profiling.flops import counted_flops, uncounted
from deepspeed_tpu_torch.ops.attention.masked_flash import (
    DKV_BODIES, DQ_BODIES, FWD_BODIES, KERNEL_BLOCKS, MAX_HEAD_DIM,
    _check_aligned, _count_body)

__all__ = ["NEG_INF", "VALID_THRESH", "build_row_runs", "build_am_index",
           "build_coarse_index", "RowRunPlan", "row_run_attention",
           "blocksparse_v2_fwd", "blocksparse_v2_dq", "blocksparse_v2_dkv",
           "blocksparse_v2_fwd_plain", "blocksparse_v2_dq_plain",
           "blocksparse_v2_dkv_plain", "row_run_bwd", "reset_launches",
           "FWD_BODIES", "DQ_BODIES", "DKV_BODIES"]

NEG_INF = -1e30
VALID_THRESH = -1e29
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


# --------------------------------------------------------------------- #
# host builders (numpy; JAX's, array for array)
# --------------------------------------------------------------------- #
def build_row_runs(layout: np.ndarray) -> Tuple[np.ndarray, ...]:
    """CSR over block-rows: (rows, offs, cnts, cols) with rows encoding
    h * nr + r. Every row gets a program (cnt may be 0: zero output)."""
    H, nr, _ = layout.shape
    rows, offs, cnts, cols = [], [], [], []
    off = 0
    for h in range(H):
        for r in range(nr):
            idx = np.nonzero(layout[h, r])[0]
            rows.append(h * nr + r)
            offs.append(off)
            cnts.append(len(idx))
            cols.extend(int(c) for c in idx)
            off += len(idx)
    return (np.asarray(rows, np.int32), np.asarray(offs, np.int32),
            np.asarray(cnts, np.int32),
            np.asarray(cols if cols else [0], np.int32))


def build_am_index(layout: np.ndarray):
    """(uq, uk, csr_uids, csc_uids): unique (qb, kb) tile coordinates of
    the head-union layout, plus per-item indices into that unique array
    in CSR (row-run) and CSC (column-run) walk order."""
    H, nq, nk = layout.shape
    union = layout.sum(axis=0) > 0
    pairs = np.argwhere(union)                      # (U, 2) [qb, kb]
    uid_of = {(int(a), int(b)): i for i, (a, b) in enumerate(pairs)}
    csr_uids, csc_uids = [], []
    for h in range(H):
        for r in range(nq):
            for c in np.nonzero(layout[h, r])[0]:
                csr_uids.append(uid_of[(r, int(c))])
    lt = layout.transpose(0, 2, 1)
    for h in range(H):
        for kb in range(nk):
            for rq in np.nonzero(lt[h, kb])[0]:
                csc_uids.append(uid_of[(int(rq), kb)])
    return (np.asarray(pairs[:, 0], np.int32),
            np.asarray(pairs[:, 1], np.int32),
            np.asarray(csr_uids or [0], np.int32),
            np.asarray(csc_uids or [0], np.int32))


def build_coarse_index(fine_layout: np.ndarray, fine_block: int,
                       coarse_block: int, per_coord: bool,
                       count_only: bool = False):
    """Coarsen a fine block layout to ``coarse_block`` tiles, the fine
    structure as additive NEG_INF cells of unique mask tiles, deduplicated
    by the content of their (f, f) fine-bit pattern and, with
    ``per_coord`` (a user mask is folded in per coordinate), by (R, C).
    Returns (coarse_layout, tiles, csr_uids, csc_uids, qrows, kcols); with
    ``count_only`` just (coarse_nnz, n_unique)."""
    H, nqf, nkf = fine_layout.shape
    f = coarse_block // fine_block
    nqc, nkc = nqf // f, nkf // f
    fine = fine_layout.astype(bool)
    coarse = fine.reshape(H, nqc, f, nkc, f).any(axis=(2, 4))

    pat_of = {}
    pats, coords = [], []

    def uid_for(h, R, C):
        patt = np.ascontiguousarray(fine[h, R * f:(R + 1) * f,
                                         C * f:(C + 1) * f])
        key = patt.tobytes() + (b"|%d,%d" % (R, C) if per_coord else b"")
        uid = pat_of.get(key)
        if uid is None:
            uid = len(pats)
            pat_of[key] = uid
            pats.append(patt)
            coords.append((R, C))
        return uid

    csr, csc = [], []
    for h in range(H):
        for R in range(nqc):
            for C in np.nonzero(coarse[h, R])[0]:
                csr.append(uid_for(h, R, int(C)))
    if count_only:
        return len(csr), len(pats)
    for h in range(H):
        for C in range(nkc):
            for R in np.nonzero(coarse[h, :, C])[0]:
                csc.append(uid_for(h, int(R), C))

    b = fine_block
    ones = np.ones((b, b), bool)
    tiles = np.stack([np.where(np.kron(p, ones), 0.0, NEG_INF)
                      for p in pats]).astype(np.float32) \
        if pats else np.zeros((1, coarse_block, coarse_block), np.float32)
    qrows = np.asarray([[R * f + i for i in range(f)]
                        for R, _ in coords] or [[0] * f], np.int32)
    kcols = np.asarray([[C * f + j for j in range(f)]
                        for _, C in coords] or [[0] * f], np.int32)
    return (coarse.astype(fine_layout.dtype), tiles,
            np.asarray(csr or [0], np.int32),
            np.asarray(csc or [0], np.int32), qrows, kcols)


class RowRunPlan:
    """The walk of K8-K10 over one layout (H, nb, nb) of fine ``block``:
    at the fine block, or over ``coarse_block`` tiles with the fine
    structure in the mask tiles, deduplicated per coordinate when
    ``per_coord`` (a user mask folds in: JAX's ``per_coord=has_am``).
    ``csr`` = (offs, cnts, cols, uids) over rows h * nq + r, ``csc`` =
    (offs, cnts, rows, uids) over columns h * nk + c; ``tile_rows`` /
    ``tile_cols`` the walk-block coordinates of the unique tiles;
    ``struct`` the (U, cb, cb) structural tiles of a coarse walk (None at
    the fine walk). Device copies are made once per device."""

    def __init__(self, layout: np.ndarray, block: int,
                 coarse_block: Optional[int] = None, per_coord: bool = True):
        layout = np.asarray(layout)
        self.fine_block = int(block)
        self.per_coord = bool(per_coord)
        self.struct = None
        if coarse_block is not None:
            (layout, self.struct, csr_uids, csc_uids, qrows,
             kcols) = build_coarse_index(layout, block, coarse_block,
                                         per_coord=per_coord)
            f = coarse_block // block
            self.tile_rows, self.tile_cols = qrows[:, 0] // f, \
                kcols[:, 0] // f
            block = coarse_block
        else:
            (self.tile_rows, self.tile_cols, csr_uids,
             csc_uids) = build_am_index(layout)
        self.block = int(block)
        self.heads, self.nq, self.nk = layout.shape
        self.seq = self.nq * self.block
        self.tiles_walked = int(np.count_nonzero(layout))
        rr = build_row_runs(layout)
        cr = build_row_runs(np.ascontiguousarray(layout.transpose(0, 2, 1)))
        self.csr = (rr[1], rr[2], rr[3], csr_uids)
        self.csc = (cr[1], cr[2], cr[3], csc_uids)
        self._device = {}

    @property
    def unique_tiles(self) -> int:
        return len(self.tile_rows)

    def device(self, which: str, device) -> Tuple[torch.Tensor, ...]:
        """``csr`` or ``csc`` as int32 tensors on ``device``, or
        ``"struct"``: the structural tiles as an fp32 tensor there."""
        key = (which, str(device))
        got = self._device.get(key)
        if got is None:
            host = getattr(self, which)
            got = (torch.from_numpy(host).to(device) if which == "struct"
                   else tuple(torch.from_numpy(a).to(device) for a in host))
            self._device[key] = got
        return got

    def structural_tiles(self, device) -> Optional[torch.Tensor]:
        """The tiles of a walk without a user mask: None at the fine walk
        (the kernels read no tile), else the structural tiles holding the
        bf16-rounded values JAX streams (0 and bf16(NEG_INF)), in fp32."""
        if self.struct is None:
            return None
        key = ("struct_bf16", str(device))
        got = self._device.get(key)
        if got is None:
            got = self.device("struct", device).to(torch.bfloat16).float()
            self._device[key] = got
        return got

    def mask_tiles(self, am: torch.Tensor) -> torch.Tensor:
        """The unique (U, b, b) fp32 tiles of the walk from the (S, S)
        additive attention mask: each tile's block of ``am`` at its
        coordinates, plus its structural tile on a coarse walk (JAX's
        ``_unique_am``)."""
        b, n = self.block, self.seq // self.block
        if self.struct is not None and not self.per_coord:
            raise ValueError("a coarse walk without per_coord has no tile "
                             "per coordinate to fold an attention mask into")
        if tuple(am.shape) != (self.seq, self.seq):
            raise ValueError(f"attn_mask must be ({self.seq}, {self.seq}), "
                             f"got {tuple(am.shape)}")
        blocks = am.float().reshape(n, b, n, b)
        rows = torch.from_numpy(self.tile_rows.astype(np.int64)).to(am.device)
        cols = torch.from_numpy(self.tile_cols.astype(np.int64)).to(am.device)
        tiles = blocks[rows, :, cols, :]                     # (U, b, b)
        if self.struct is not None:
            tiles = tiles + self.device("struct", am.device)
        return tiles.contiguous()


# --------------------------------------------------------------------- #
# plain versions: the kernels' walks in PyTorch, batched over every
# (batch, head, block row or column) item, one walk position per step
# --------------------------------------------------------------------- #
def _blocks(x, block):
    """(B, H, S, D) -> (B, H * S / block, block, D): item h * n + r."""
    B, H, S, D = x.shape
    return x.reshape(B, H * (S // block), block, D)


def _steps(cnts):
    """Per walk position t, the walked rows (or columns) and their item
    offsets are ``offs[rows] + t``."""
    for t in range(int(cnts.max(initial=0))):
        yield t, np.nonzero(cnts > t)[0]


def _scores(qt, kt, sm_scale, kpm_t, tiles, uid):
    """(q . k) * sm_scale, then the key mask's row, then the mask tile
    (none when ``tiles`` is None), in fp32."""
    s = (qt @ kt.transpose(-1, -2)) * sm_scale
    if kpm_t is not None:
        s = s + kpm_t
    return s if tiles is None else s + tiles[uid]


def _walk_ids(plan: RowRunPlan, which, live, t, device):
    """For the walked rows (CSR) or columns (CSC) ``live`` at position
    ``t``, as int64 tensors on ``device``: themselves, their partner
    block items (same head), the mask-tile uids and the partner blocks."""
    offs, _, idx, uids = plan.csr if which == "csr" else plan.csc
    item = offs[live] + t
    n = plan.nk if which == "csr" else plan.nq
    head = live // (plan.nq if which == "csr" else plan.nk)
    return tuple(torch.from_numpy(a.astype(np.int64)).to(device)
                 for a in (live, head * n + idx[item], uids[item],
                           idx[item]))


def blocksparse_v2_fwd_plain(q, k, v, key_mask, tiles, plan: RowRunPlan,
                             sm_scale: float):
    """K8's function in plain PyTorch: per walked item an fp32 online
    softmax step (no m_safe guard), p rounded to V's dtype before P.V.
    q, k, v (B, H, S, D); ``key_mask`` (B, S) fp32 or None; ``tiles``
    (U, b, b) fp32 or None (no tile) -> o (q's dtype), lse (B, H, S)
    fp32."""
    B, H, S, D = q.shape
    b = plan.block
    qb, kb, vb = (_blocks(x, b) for x in (q, k, v))
    kpmb = None if key_mask is None else key_mask.reshape(B, plan.nk, 1, b)
    rows = H * plan.nq
    m = torch.full((B, rows, b), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, rows, b, D), dtype=torch.float32, device=q.device)
    for t, live in _steps(plan.csr[1]):
        li, kid, uid, col = _walk_ids(plan, "csr", live, t, q.device)
        s = _scores(qb[:, li].float(), kb[:, kid].float(), sm_scale,
                    None if kpmb is None else kpmb[:, col], tiles, uid)
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


def blocksparse_v2_dq_plain(q, k, v, do, lse, delta, key_mask, tiles,
                            plan: RowRunPlan, sm_scale: float):
    """K9's function in plain PyTorch over the CSR walk: p recomputed
    from lse, ds = p * (dp - delta) rounded to K's dtype, dq scaled by
    sm_scale at the end."""
    B, H, S, D = q.shape
    b = plan.block
    qb, kb, vb, dob = (_blocks(x, b) for x in (q, k, v, do))
    lseb, dlb = (x.reshape(B, H * plan.nq, b) for x in (lse, delta))
    kpmb = None if key_mask is None else key_mask.reshape(B, plan.nk, 1, b)
    acc = torch.zeros((B, H * plan.nq, b, D), dtype=torch.float32,
                      device=q.device)
    for t, live in _steps(plan.csr[1]):
        li, kid, uid, col = _walk_ids(plan, "csr", live, t, q.device)
        kt = kb[:, kid].float()
        s = _scores(qb[:, li].float(), kt, sm_scale,
                    None if kpmb is None else kpmb[:, col], tiles, uid)
        p = torch.where(s > VALID_THRESH,
                        torch.exp(s - lseb[:, li, :, None]), 0.0)
        dp = dob[:, li].float() @ vb[:, kid].float().transpose(-1, -2)
        ds = p * (dp - dlb[:, li, :, None])
        acc[:, li] += ds.to(k.dtype).float() @ kt
    return (acc * sm_scale).to(q.dtype).reshape(B, H, S, D)


def blocksparse_v2_dkv_plain(q, k, v, do, lse, delta, key_mask, tiles,
                             plan: RowRunPlan, sm_scale: float):
    """K10's function in plain PyTorch over the CSC walk: p recomputed
    with the key block's mask row, dv from p rounded to do's dtype, dk
    from ds rounded to q's dtype, dk scaled by sm_scale at the end.
    Returns (dk, dv) shaped like k."""
    B, H, S, D = q.shape
    b = plan.block
    qb, kb, vb, dob = (_blocks(x, b) for x in (q, k, v, do))
    lseb, dlb = (x.reshape(B, H * plan.nq, b) for x in (lse, delta))
    kpmb = None if key_mask is None else key_mask.reshape(B, plan.nk, 1, b)
    cols = H * plan.nk
    acc_k = torch.zeros((B, cols, b, D), dtype=torch.float32,
                        device=q.device)
    acc_v = torch.zeros_like(acc_k)
    for t, live in _steps(plan.csc[1]):
        li, qid, uid, _ = _walk_ids(plan, "csc", live, t, q.device)
        qt, dot = qb[:, qid].float(), dob[:, qid].float()
        s = _scores(qt, kb[:, li].float(), sm_scale,
                    None if kpmb is None else kpmb[:, li % plan.nk],
                    tiles, uid)
        p = torch.where(s > VALID_THRESH,
                        torch.exp(s - lseb[:, qid, :, None]), 0.0)
        acc_v[:, li] += p.to(do.dtype).float().transpose(-1, -2) @ dot
        dp = dot @ vb[:, li].float().transpose(-1, -2)
        ds = p * (dp - dlb[:, qid, :, None])
        acc_k[:, li] += ds.to(q.dtype).float().transpose(-1, -2) @ qt
    return ((acc_k * sm_scale).to(k.dtype).reshape(B, H, S, D),
            acc_v.to(v.dtype).reshape(B, H, S, D))


# --------------------------------------------------------------------- #
# the kernels' wrappers
# --------------------------------------------------------------------- #
def _check_args(q, k, v, key_mask, tiles, plan: RowRunPlan):
    """What the kernels and their plain versions both require."""
    if q.dim() != 4 or q.shape != k.shape or k.shape != v.shape:
        raise ValueError(f"the row-run kernels take one (B, H, S, D) shape "
                         f"for q, k and v, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, S, _ = q.shape
    if (H, S) != (plan.heads, plan.seq):
        raise ValueError(f"layout of {plan.heads} heads over {plan.seq} vs "
                         f"inputs {tuple(q.shape)}")
    if key_mask is not None and (tuple(key_mask.shape) != (B, S)
                                 or key_mask.dtype != torch.float32):
        raise ValueError(f"the row-run kernels take an fp32 (B, S) = ({B}, "
                         f"{S}) key mask, got {key_mask.dtype} "
                         f"{tuple(key_mask.shape)}")
    want = (plan.unique_tiles, plan.block, plan.block)
    if tiles is None:
        if plan.struct is not None:
            raise ValueError("a coarse walk needs its mask tiles")
    elif tuple(tiles.shape) != want or tiles.dtype != torch.float32:
        raise ValueError(f"the row-run kernels take fp32 mask tiles {want}, "
                         f"got {tiles.dtype} {tuple(tiles.shape)}")


def _check_cuda(operands, fp32, plan: RowRunPlan):
    """``operands``: q, k, v (and do) in one dtype; ``fp32``: the fp32
    operands (lse, delta, the key mask or None, the tiles)."""
    q = operands[0]
    B, H, S, D = q.shape
    if q.device.type != "cuda":
        raise ValueError(f"the row-run kernels run on cuda or cpu, not "
                         f"{q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"the row-run kernels take {list(_DTYPE_CODE)}, got "
                        f"{q.dtype}")
    for t in (*operands, *(t for t in fp32 if t is not None)):
        if t.device != q.device:
            raise ValueError(f"the row-run kernels: operands on {t.device} "
                             f"and {q.device}")
        if not t.is_contiguous():
            raise ValueError("the row-run kernels need contiguous operands")
    for t in operands[1:]:
        if t.dtype != q.dtype:
            raise TypeError(f"the row-run kernels take one dtype for q, k, "
                            f"v and do, got {q.dtype} and {t.dtype}")
    for t in fp32:
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"the row-run kernels take fp32 lse, delta, key "
                            f"mask and tiles, got {t.dtype}")
    if D % 8 != 0 or D > MAX_HEAD_DIM:
        raise ValueError(f"the row-run kernels take head_dim a multiple of "
                         f"8 up to {MAX_HEAD_DIM}, got {D}")
    if plan.block not in KERNEL_BLOCKS:
        raise ValueError(f"the row-run kernels take walk blocks "
                         f"{KERNEL_BLOCKS}, got {plan.block}")
    if B * H > 65535:
        raise ValueError(f"the row-run kernels take B*H <= 65535, got "
                         f"{B * H}")


def _check_fwd_aligned(q, k, v, key_mask=None, tiles=None):
    """K8's operands for its tensor-core body (o, allocated by the
    wrapper, is aligned)."""
    _check_aligned("row-run forward", FWD_BODIES, q.dtype,
                   (("q", q), ("k", k), ("v", v), ("key_mask", key_mask),
                    ("tiles", tiles)))


def _check_bwd_aligned(q, k, v, do, key_mask=None, tiles=None):
    """K9's and K10's operands for their tensor-core bodies, which take
    the same operands and the same alignment (dq, dk and dv, allocated by
    the wrappers, are aligned)."""
    _check_aligned("row-run backward", DQ_BODIES, q.dtype,
                   (("q", q), ("k", k), ("v", v), ("do", do),
                    ("key_mask", key_mask), ("tiles", tiles)))


def _check_tally(tally, q):
    """``tally``: None, or one int64 on q's device (the cells the
    tensor-core body sums again are added to it)."""
    if tally is not None and (tally.dtype != torch.int64
                              or tally.numel() != 1
                              or tally.device != q.device):
        raise ValueError(f"a tally is one int64 on {q.device}, got "
                         f"{tally.dtype} {tuple(tally.shape)} on "
                         f"{tally.device}")


_fns = {}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# after the pointers: dtype, bh, heads, seq, head_dim, block, sm_scale,
# stream
_TAIL = [_I] * 6 + [_F, _P]


def _kernel(name: str, n_ptrs: int):
    """One of the library's C entry points, built and typed at first
    use."""
    fn = _fns.get(name)
    if fn is None:
        from deepspeed_tpu_torch.ops._build import load
        fn = getattr(load("blocksparse_v2.cu"), name)
        fn.restype = ctypes.c_int
        fn.argtypes = [_P] * n_ptrs + _TAIL
        _fns[name] = fn
    return fn


def _launch(name, q, ptrs, plan: RowRunPlan, sm_scale):
    """Launch ``name`` on q's device and current stream; raise on a
    refused launch."""
    B, H, S, D = q.shape
    fn = _kernel(name, len(ptrs))
    args = [None if t is None else t.data_ptr() for t in ptrs] + [
        _DTYPE_CODE[q.dtype], B * H, H, S, D, plan.block, float(sm_scale)]
    with torch.cuda.device(q.device):
        err = fn(*args, torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


@counted_flops("blocksparse_v2_fwd", uncounted)
def blocksparse_v2_fwd(q, k, v, key_mask, tiles, plan: RowRunPlan,
                       sm_scale: float):
    """K8: ``(o, lse)`` of :func:`blocksparse_v2_fwd_plain`. A CUDA ``q``
    launches the sm_90a kernel (raising on any dtype, shape, device,
    alignment or launch problem), its tensor-core body in bf16 and its
    CUDA-core body in fp32 (:data:`FWD_BODIES`, counted in ``bodies``);
    a CPU ``q`` runs the plain version."""
    _check_args(q, k, v, key_mask, tiles, plan)
    if q.device.type == "cpu":
        return blocksparse_v2_fwd_plain(q, k, v, key_mask, tiles, plan,
                                        sm_scale)
    _check_cuda((q, k, v), (key_mask, tiles), plan)
    _check_fwd_aligned(q, k, v, key_mask, tiles)
    B, H, S, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    _launch("blocksparse_v2_fwd", q,
            [q, k, v, key_mask, tiles, o, lse,
             *plan.device("csr", q.device)], plan, sm_scale)
    blocksparse_v2_fwd.launches += 1
    _count_body(blocksparse_v2_fwd, q.dtype, FWD_BODIES)
    return o, lse


@counted_flops("blocksparse_v2_dq", uncounted)
def blocksparse_v2_dq(q, k, v, do, lse, delta, key_mask, tiles,
                      plan: RowRunPlan, sm_scale: float, tally=None):
    """K9: ``dq`` of :func:`blocksparse_v2_dq_plain`. A CUDA ``q``
    launches the sm_90a kernel (raising on any dtype, shape, device,
    alignment or launch problem), its tensor-core body in bf16 and its
    CUDA-core body in fp32 (:data:`DQ_BODIES`, counted in ``bodies``); a
    CPU ``q`` runs the plain version. ``tally`` (a measurement): None, or
    one int64 on q's device to which the tensor-core body adds the cells
    it sums again in the plain order."""
    _check_args(q, k, v, key_mask, tiles, plan)
    if q.device.type == "cpu":
        return blocksparse_v2_dq_plain(q, k, v, do, lse, delta, key_mask,
                                       tiles, plan, sm_scale)
    _check_cuda((q, k, v, do), (lse, delta, key_mask, tiles), plan)
    _check_bwd_aligned(q, k, v, do, key_mask, tiles)
    _check_tally(tally, q)
    dq = torch.empty_like(q)
    _launch("blocksparse_v2_dq", q,
            [q, k, v, do, lse, delta, key_mask, tiles, dq, tally,
             *plan.device("csr", q.device)], plan, sm_scale)
    blocksparse_v2_dq.launches += 1
    _count_body(blocksparse_v2_dq, q.dtype, DQ_BODIES)
    return dq


@counted_flops("blocksparse_v2_dkv", uncounted)
def blocksparse_v2_dkv(q, k, v, do, lse, delta, key_mask, tiles,
                       plan: RowRunPlan, sm_scale: float, tally=None):
    """K10: ``(dk, dv)`` of :func:`blocksparse_v2_dkv_plain`; on CUDA as
    :func:`blocksparse_v2_dq` (:data:`DKV_BODIES`), plain version on the
    CPU."""
    _check_args(q, k, v, key_mask, tiles, plan)
    if q.device.type == "cpu":
        return blocksparse_v2_dkv_plain(q, k, v, do, lse, delta, key_mask,
                                        tiles, plan, sm_scale)
    _check_cuda((q, k, v, do), (lse, delta, key_mask, tiles), plan)
    _check_bwd_aligned(q, k, v, do, key_mask, tiles)
    _check_tally(tally, q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch("blocksparse_v2_dkv", q,
            [q, k, v, do, lse, delta, key_mask, tiles, dk, dv, tally,
             *plan.device("csc", q.device)], plan, sm_scale)
    blocksparse_v2_dkv.launches += 1
    _count_body(blocksparse_v2_dkv, q.dtype, DKV_BODIES)
    return dk, dv


def reset_launches():
    """Set every launch count of K8-K10 to 0, also by body."""
    for w in (blocksparse_v2_fwd, blocksparse_v2_dq, blocksparse_v2_dkv):
        w.launches = 0
        w.bodies = {}


reset_launches()


# --------------------------------------------------------------------- #
# the backward impl (JAX's bwd_impl) and autograd
# --------------------------------------------------------------------- #
def row_run_bwd(q, k, v, key_mask, tiles, plan: RowRunPlan, sm_scale, o, lse,
                do):
    """(dq, dk, dv) of K9 and K10 from the row statistics ``lse`` and the
    output ``o`` (delta = sum(do * o) in fp32): K8's own, or the merged
    ones of the hybrid."""
    delta = (do.float() * o.float()).sum(dim=-1)
    args = (key_mask, tiles, plan, sm_scale)
    dq = blocksparse_v2_dq(q, k, v, do, lse, delta, *args)
    dk, dv = blocksparse_v2_dkv(q, k, v, do, lse, delta, *args)
    return dq, dk, dv


class _RowRun(torch.autograd.Function):
    """Forward K8, saving (q, k, v, key_mask, tiles, o, lse); backward K9
    and K10. The key mask and the mask tiles take no gradient: zeros
    where asked for, as the JAX package's vjp returns."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, tiles, plan, sm_scale):
        o, lse = blocksparse_v2_fwd(q, k, v, key_mask, tiles, plan,
                                    sm_scale)
        ctx.save_for_backward(q, k, v, key_mask, tiles, o, lse)
        ctx.plan, ctx.sm_scale = plan, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, key_mask, tiles, o, lse = ctx.saved_tensors
        dq, dk, dv = row_run_bwd(q, k, v, key_mask, tiles, ctx.plan,
                                 ctx.sm_scale, o, lse, do.contiguous())
        zero = [torch.zeros_like(t) if t is not None and need else None
                for t, need in ((key_mask, ctx.needs_input_grad[3]),
                                (tiles, ctx.needs_input_grad[4]))]
        return dq, dk, dv, *zero, None, None


def row_run_attention(q, k, v, plan: RowRunPlan, attn_mask=None,
                      key_mask=None, sm_scale: Optional[float] = None):
    """Block-sparse attention over ``plan`` under the additive (S, S)
    ``attn_mask`` (or none: the plan's structural tiles on a coarse walk,
    no tile on the fine one) and the optional additive (B, S)
    ``key_mask``, with the custom backward: K8 forward, K9 and K10
    backward."""
    if sm_scale is None:
        sm_scale = float(q.shape[-1]) ** -0.5
    tiles = (plan.structural_tiles(q.device) if attn_mask is None
             else plan.mask_tiles(attn_mask))
    if key_mask is not None:
        key_mask = key_mask.float().contiguous()
    return _RowRun.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                         key_mask, tiles, plan, float(sm_scale))
