"""Flash attention (the port of ``deepspeed_tpu/ops/attention/flash.py``):
the front end's routing and options, the dropout hash, the reference,
and the legacy dense kernels K5-K7.

:func:`flash_attention` routes as the JAX function does, by the
process-wide :class:`AttentionOptions` (``set_attention_options``):

- ``force_reference=True``, the ``kernel="reference"`` option below
  ``STREAM_THRESHOLD`` (the O(S^2) :func:`attention_reference` with bf16
  operands and fp32 sums; at or above the threshold the option is
  ignored, with one log line), and a sequence length that is not a
  multiple of 16 (logged once above 2048 tokens) go to
  :func:`attention_reference`;
- the default ``kernel="masked"`` runs the masked-flash kernels K1-K3
  (``masked_flash.py``) over a dense or causal ``BlockMask``, with an
  additive ``(B, 1, 1, Sk)`` mask (BERT's padding) in their key-mask
  arity, when the attention is full or ``seq_q == seq_k``;
- every other case (``kernel="flash"``, causal attention with
  ``seq_q != seq_k``, and ``"reference"`` at long sequences) runs the
  legacy per-path kernels K5-K7 of this module through one
  ``torch.autograd.Function`` (:func:`flash_call`).

K5-K7 (``csrc/flash.cu``, built with nvcc for sm_90a at first use) are
:func:`flash_fwd` (K5, ``o`` and ``lse``; replaces ``_fwd_kernel``),
:func:`flash_dq` (K6; ``_bwd_dq_kernel``) and :func:`flash_dkv` (K7, dk
and dv; ``_bwd_dkv_kernel``, fp32 per-q-head partials summed per group
outside the kernel at G > 1). Each wrapper launches its kernel for a
CUDA tensor or raises, and runs its plain PyTorch version (``*_plain``)
for a CPU tensor; each launch adds one to the wrapper's ``launches``.
Their arity is JAX's: full or causal (``seq_q != seq_k`` too), the
additive key mask, dropout, GQA, fp32 and bf16.

One deliberate difference: for causal attention with ``seq_q > seq_k``
JAX's K5 and K6 walk ``ceil((qb * bq + bq) / bk)`` key blocks, more than
exist (interpret mode repeats the last key block, the TPU reads past
it). The port caps the walk at the ``seq_k / bk`` blocks that exist and
equals :func:`attention_reference` there.

The tiles (:func:`_pick_blocks`): for CPU tensors JAX's heuristic (its
answer without the autotune table, which was measured on a TPU); on the
card the port's own rule, ``bq`` from ``seq_q`` and ``bk`` from
``seq_k`` independently, each the widest of 128, 64, 32, 16 that divides
its length (the kernels take those). ``_FORCE_BLOCKS`` overrides both.

The JAX function's pad-to-128 branch for long irregular sequences and
its streamed K/V layout exist only for Mosaic's 128-lane DMA rule and
the TPU's VMEM; the CUDA kernels stage K/V through shared memory at
every length, so neither carries over.

The dropout keep mask is the JAX package's counter hash, bit for bit.
The port takes an int32 ``dropout_seed`` where JAX takes a ``jax.random``
key (whose ``randint`` torch cannot reproduce). torch on the CPU has no
logical ``>>`` for uint32, so the hash runs in int64 with the 32-bit
wrap-around done by hand.
"""

import ctypes
import dataclasses
import math
import os
from functools import lru_cache
from typing import Optional, Tuple

import torch

from deepspeed_tpu_torch.profiling.flops import counted_flops
from deepspeed_tpu_torch.utils.logging import log_once

__all__ = ["NEG_INF", "STREAM_THRESHOLD", "AttentionOptions",
           "get_attention_options", "set_attention_options",
           "flash_attention", "attention_reference", "dropout_keep_mask",
           "dropout_mask_reference", "keep_threshold", "pick_block",
           "flash_call", "flash_fwd", "flash_dq", "flash_dkv",
           "flash_fwd_plain", "flash_dq_plain", "flash_dkv_plain",
           "reset_launches"]

NEG_INF = -1e30
# dropout-hash finalizer rounds: 2 = lowbias32 (default), 1 = a single
# multiply-xorshift round (the JAX package's A/B knob). The plain hash
# follows it; the CUDA kernels have the two rounds compiled in, and their
# wrappers refuse any other value
_HASH_FINAL_ROUNDS = 2

_M32 = 0xFFFFFFFF
KERNELS = ("masked", "flash", "reference")


@dataclasses.dataclass
class AttentionOptions:
    """Process-wide attention-kernel selection (JAX's class).

    kernel: what :func:`flash_attention` runs -- ``"masked"`` (default):
    the masked-flash kernels K1-K3 over a dense or causal BlockMask;
    ``"flash"``: the legacy per-path kernels K5-K7; ``"reference"``: the
    O(S^2) :func:`attention_reference` with bf16 operands and fp32 sums,
    ignored (loudly, once) at or above STREAM_THRESHOLD. The default is
    the ``DSTPU_ATTENTION_KERNEL`` environment variable's value, read when
    the options are made (the process's at import)."""
    kernel: str = dataclasses.field(default_factory=lambda: os.environ.get(
        "DSTPU_ATTENTION_KERNEL", "masked"))

    def __post_init__(self):
        if self.kernel not in KERNELS:
            raise ValueError(f"attention kernel must be one of {KERNELS}, "
                             f"got {self.kernel!r}")


_OPTIONS = AttentionOptions()


def get_attention_options() -> AttentionOptions:
    return _OPTIONS


def set_attention_options(**kw) -> AttentionOptions:
    """Update the kernel-selection knobs; returns the PREVIOUS options so
    that callers (tests, A/B runs) can restore them."""
    global _OPTIONS
    old = _OPTIONS
    _OPTIONS = dataclasses.replace(_OPTIONS, **kw)
    return old


def _mul32(x, c: int):
    """``(x * c) mod 2**32`` for ``x`` in ``[0, 2**32)`` (an int or an
    int64 tensor): ``c`` is split in 16-bit halves so that no product
    leaves int64."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _mix32(x):
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def keep_threshold(rate: float) -> int:
    """Keep a cell iff its hash is below this (the JAX package's
    rounding)."""
    return min(int(round((1.0 - rate) * 2.0**32)), 2**32 - 1)


def dropout_keep_mask(seed, bh, q_idx, k_idx, seq_k, rate):
    """Stateless keep-mask for attention dropout, the same bits as the
    JAX package's ``dropout_keep_mask`` and the kernels'.

    seed: int32 (an int, or an int64 tensor); bh: the ``b * H + h`` index
    (int or int64 tensor); q_idx/k_idx: broadcastable int64 tensors;
    rate: in (0, 1). ``seq_k`` is unused, as in JAX. Returns bool, True =
    keep."""
    del seq_k
    row = _mix32((q_idx & _M32) ^ _mul32(bh & _M32, 0x9E3779B9)
                 ^ (seed & _M32))
    x = row ^ (k_idx & _M32)
    if _HASH_FINAL_ROUNDS == 1:
        x = _mul32(x ^ (x >> 16), 0x7FEB352D)
        x = x ^ (x >> 15)
    else:
        x = _mix32(x)
    return x < keep_threshold(rate)


def dropout_mask_reference(seed, b, h, sq, sk, rate, device=None):
    """Materialized (B, H, Sq, Sk) keep-mask: the oracle view of what the
    kernels regenerate tile by tile. Small shapes only."""
    bh = torch.arange(b * h, dtype=torch.int64, device=device)[:, None, None]
    q_idx = torch.arange(sq, dtype=torch.int64, device=device)[None, :, None]
    k_idx = torch.arange(sk, dtype=torch.int64, device=device)[None, None, :]
    keep = dropout_keep_mask(int(seed), bh, q_idx, k_idx, sk, rate)
    return keep.reshape(b, h, sq, sk)


def attention_reference(q, k, v, mask=None, causal: bool = False,
                        sm_scale: Optional[float] = None,
                        dropout_rate: float = 0.0, dropout_seed=None,
                        mxu_bf16: bool = False):
    """Plain attention with fp32 sums. q, k, v: (B, H, S, D), k/v may
    carry H/G heads (GQA); mask: additive, broadcastable to (B, H, Sq,
    Sk); with ``dropout_rate > 0`` the kernels' hash keep-mask from
    ``dropout_seed``. ``mxu_bf16`` (the ``kernel="reference"`` option):
    the probabilities are rounded to V's dtype before P.V, as the
    kernels' bf16 operands are (q.k is the same in both modes: the
    products of bf16 values are exact in fp32). Returns q's dtype."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if k.shape[1] != q.shape[1]:
        rep = q.shape[1] // k.shape[1]
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    s = (q.float() @ k.float().transpose(-1, -2)) * sm_scale
    if mask is not None:
        s = s + mask.float()
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        idx_q = torch.arange(sq, device=q.device)[:, None]
        idx_k = torch.arange(sk, device=q.device)[None, :]
        s = torch.where(idx_q >= idx_k, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    if dropout_rate > 0.0:
        b_, h_, sq_, sk_ = p.shape
        keep = dropout_mask_reference(dropout_seed, b_, h_, sq_, sk_,
                                      dropout_rate, device=q.device)
        p = torch.where(keep, p, 0.0) / (1.0 - dropout_rate)
    if mxu_bf16:
        p = p.to(v.dtype)
    return (p.float() @ v.float()).to(q.dtype)


def pick_block(seq_q: int, seq_k: int) -> int:
    """The walk block of a dense or causal mask: the widest of 128, 64,
    32, 16 that divides both lengths. (The JAX package's autotune table
    was measured on a TPU and does not apply here.)"""
    for b in (128, 64, 32, 16):
        if seq_q % b == 0 and seq_k % b == 0:
            return b
    raise ValueError(f"no walk block divides seq ({seq_q}, {seq_k})")


@lru_cache(maxsize=64)
def _dense_block_mask(seq_q: int, seq_k: int, causal: bool):
    from deepspeed_tpu_torch.ops.attention.masked_flash import BlockMask
    block = pick_block(seq_q, seq_k)
    return (BlockMask.causal(seq_q, block) if causal
            else BlockMask.dense(seq_q, seq_k, block))


# --------------------------------------------------------------------- #
# K5-K7's tiles
# --------------------------------------------------------------------- #
# at or beyond this length JAX streams K/V through DMA tiles; here it
# only decides JAX's tile cap and where the "reference" option is ignored
STREAM_THRESHOLD = 8192
_FORCE_BLOCKS: Optional[Tuple[int, int]] = None   # (bq, bk) override


def _largest_divisor_block(seq, cap=512):
    for b in (512, 256, 128, 64, 32, 16):
        if b <= cap and seq % b == 0:
            return b
    return min(seq, cap)


def _use_stream(seq_q, seq_k):
    """JAX's streaming regime, which sets its tile cap: both lengths
    multiples of 128 (its DMA lanes), one at or beyond STREAM_THRESHOLD.
    (JAX also logs a long length that is not; the port's kernels need no
    such layout, so nothing is logged.)"""
    return (seq_q % 128 == 0 and seq_k % 128 == 0
            and max(seq_q, seq_k) >= STREAM_THRESHOLD)


def _block_cap(seq, stream):
    if stream:
        return 512
    if seq >= 8192:
        return 256
    return 512


def _pick_blocks(seq_q: int, seq_k: int, device) -> Tuple[int, int]:
    """K5-K7's (bq, bk): ``_FORCE_BLOCKS`` when set; for the CPU JAX's
    heuristic (its tile cap, then the widest of 512 ... 16 dividing each
    length); on the card, independently for each length, the widest of
    the kernels' tiles (128, 64, 32, 16) that divides it."""
    if _FORCE_BLOCKS is not None:
        return tuple(_FORCE_BLOCKS)
    if torch.device(device).type == "cpu":
        cap = _block_cap(max(seq_q, seq_k), _use_stream(seq_q, seq_k))
        return (_largest_divisor_block(seq_q, cap),
                _largest_divisor_block(seq_k, cap))
    return pick_block(seq_q, seq_q), pick_block(seq_k, seq_k)


# --------------------------------------------------------------------- #
# plain versions of K5-K7: the kernels' walk in PyTorch
# --------------------------------------------------------------------- #
def ordered_dot(a, b):
    """``a @ b^T`` over the last dim in fp32, summed one term at a time
    in the kernels' order (d = 0, 1, ...). With bf16 operands every
    product is exact in fp32, so each sum is the kernels' chain of fused
    multiply-adds bit for bit, whatever order a BLAS library would pick
    for the batch at hand: the scores and dp decide where p and ds round
    to bf16, and one flipped rounding of a large p moves a long sum of the
    backward by more than its last bf16 digit."""
    a, b = a.float(), b.float()
    out = a[..., :, None, 0] * b[..., None, :, 0]
    for d in range(1, a.shape[-1]):
        out = out + a[..., :, None, d] * b[..., None, :, d]
    return out


def _per_q_head(x, G):
    """(B, Hkv, S, D) -> (B, H, S, D): the kv row of each q head."""
    return x if G == 1 else x.repeat_interleave(G, dim=1)


def _scores(qt, kt, sm_scale, key_mask, causal, q_idx, k_idx):
    """(q . k) * sm_scale in the kernels' order, then the key mask's
    columns ``k_idx`` added, then NEG_INF where the causal clip drops a
    cell, in fp32."""
    s = ordered_dot(qt, kt) * sm_scale
    if key_mask is not None:
        s = s + key_mask[:, None, None, k_idx]
    if causal:
        s = torch.where(q_idx[:, None] >= k_idx[None, :], s, NEG_INF)
    return s


def _keep(seed, q, q_idx, k_idx, rate):
    """The (B, H, rows, cols) keep mask, keyed on the q-head row b*H + h."""
    B, H = q.shape[:2]
    bh = (torch.arange(B, device=q.device)[:, None] * H
          + torch.arange(H, device=q.device)[None, :])[:, :, None, None]
    return dropout_keep_mask(seed, bh, q_idx[:, None], k_idx[None, :], 0,
                             rate)


def _walks(q_idx, j, bq, bk, causal):
    """Whether the query block of each row in ``q_idx`` walks key block
    ``j`` (K5 and K6), or None when every row does: JAX's
    ``ceil((qb * bq + bq) / bk)`` blocks when causal. The plain versions
    loop over the key blocks that exist, which caps the walk."""
    if not causal:
        return None
    return (q_idx // bq * bq + bq + bk - 1) // bk > j


def flash_fwd_plain(q, k, v, causal: bool, sm_scale: float,
                    rate: float = 0.0, seed: int = 0, key_mask=None,
                    blocks=None):
    """K5's function in plain PyTorch, with its walk over key blocks of
    ``bk``: per walked tile an fp32 online softmax (no validity
    threshold: p = exp(s - m_new)), l from the undropped p, p rounded to
    V's dtype before P.V; o = acc / l scaled by 1/(1-rate) after the
    normalization, lse = m + log(l). q (B, H, Sq, D), k/v (B, Hkv, Sk,
    D), optional fp32 ``key_mask`` (B, Sk); ``blocks`` (bq, bk) default
    to :func:`_pick_blocks` for q's device -> o (q's dtype), lse (B, H,
    Sq) fp32."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    G = H // k.shape[1]
    bq, bk = blocks or _pick_blocks(Sq, Sk, q.device)
    kh, vh = _per_q_head(k, G), _per_q_head(v, G)
    qf = q.float()
    q_idx = torch.arange(Sq, device=q.device)
    m = torch.full((B, H, Sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, H, Sq, D), dtype=torch.float32, device=q.device)
    for j in range(Sk // bk):
        k_idx = j * bk + torch.arange(bk, device=q.device)
        cols = slice(j * bk, (j + 1) * bk)
        s = _scores(qf, kh[:, :, cols], sm_scale, key_mask, causal, q_idx,
                    k_idx)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l_new = l * alpha + p.sum(dim=-1)
        if rate > 0.0:
            p = torch.where(_keep(seed, q, q_idx, k_idx, rate), p, 0.0)
        acc_new = acc * alpha[..., None] + \
            p.to(v.dtype).float() @ vh[:, :, cols].float()
        walk = _walks(q_idx, j, bq, bk, causal)
        if walk is None:
            m, l, acc = m_new, l_new, acc_new
        else:
            m = torch.where(walk, m_new, m)
            l = torch.where(walk, l_new, l)
            acc = torch.where(walk[:, None], acc_new, acc)
    l_safe = torch.where(l == 0.0, 1.0, l)
    out = acc / l_safe[..., None]
    if rate > 0.0:
        out = out * (1.0 / (1.0 - rate))
    return out.to(q.dtype), m + torch.log(l_safe)


def flash_dq_plain(q, k, v, do, lse, delta, causal: bool, sm_scale: float,
                   rate: float = 0.0, seed: int = 0, key_mask=None,
                   blocks=None):
    """K6's function in plain PyTorch over K5's walk: p = exp(s - lse),
    dp = do . v (dropped and scaled by 1/(1-rate) under dropout),
    ds = p * (dp - delta) rounded to K's dtype, dq scaled by sm_scale at
    the end."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    G = H // k.shape[1]
    bq, bk = blocks or _pick_blocks(Sq, Sk, q.device)
    kh, vh = _per_q_head(k, G), _per_q_head(v, G)
    qf, dof = q.float(), do.float()
    q_idx = torch.arange(Sq, device=q.device)
    inv = 1.0 / (1.0 - rate) if rate > 0.0 else 1.0
    acc = torch.zeros((B, H, Sq, D), dtype=torch.float32, device=q.device)
    for j in range(Sk // bk):
        k_idx = j * bk + torch.arange(bk, device=q.device)
        cols = slice(j * bk, (j + 1) * bk)
        kt = kh[:, :, cols]
        s = _scores(qf, kt, sm_scale, key_mask, causal, q_idx, k_idx)
        p = torch.exp(s - lse[..., None])
        dp = ordered_dot(dof, vh[:, :, cols])
        if rate > 0.0:
            dp = torch.where(_keep(seed, q, q_idx, k_idx, rate), dp * inv,
                             0.0)
        ds = p * (dp - delta[..., None])
        new = acc + ds.to(k.dtype).float() @ kt.float()
        walk = _walks(q_idx, j, bq, bk, causal)
        acc = new if walk is None else torch.where(walk[:, None], new, acc)
    return (acc * sm_scale).to(q.dtype)


def flash_dkv_plain(q, k, v, do, lse, delta, causal: bool, sm_scale: float,
                    rate: float = 0.0, seed: int = 0, key_mask=None,
                    blocks=None):
    """K7's function in plain PyTorch, with its walk over query blocks of
    ``bq``: key block kb takes the query blocks from ``kb * bk // bq`` on
    when causal (keys no query reaches get dk = dv = 0); p from ``lse``,
    dv from pd (the dropped p scaled by 1/(1-rate)) rounded to do's
    dtype, dk from ds = p * (dp - delta) rounded to q's dtype and scaled
    by sm_scale at the end; per-q-head fp32 partials summed per group at
    G > 1. Returns (dk, dv) shaped like k."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    G = H // k.shape[1]
    bq, bk = blocks or _pick_blocks(Sq, Sk, q.device)
    kh, vh = _per_q_head(k, G).float(), _per_q_head(v, G).float()
    k_idx = torch.arange(Sk, device=q.device)
    first = k_idx // bk * bk // bq      # JAX's first_qb of each key
    inv = 1.0 / (1.0 - rate) if rate > 0.0 else 1.0
    acc_k = torch.zeros((B, H, Sk, D), dtype=torch.float32, device=q.device)
    acc_v = torch.zeros_like(acc_k)
    for i in range(Sq // bq):
        rows = slice(i * bq, (i + 1) * bq)
        q_idx = i * bq + torch.arange(bq, device=q.device)
        qt, dot = q[:, :, rows].float(), do[:, :, rows].float()
        s = _scores(qt, kh, sm_scale, key_mask, causal, q_idx, k_idx)
        p = torch.exp(s - lse[:, :, rows, None])
        dp = ordered_dot(dot, vh)
        pd = p
        if rate > 0.0:
            keep = _keep(seed, q, q_idx, k_idx, rate)
            pd = torch.where(keep, p * inv, 0.0)
            dp = torch.where(keep, dp * inv, 0.0)
        ds = p * (dp - delta[:, :, rows, None])
        new_v = acc_v + pd.to(do.dtype).float().transpose(-1, -2) @ dot
        new_k = acc_k + ds.to(q.dtype).float().transpose(-1, -2) @ qt
        if causal:
            walk = (i >= first)[:, None]
            new_v = torch.where(walk, new_v, acc_v)
            new_k = torch.where(walk, new_k, acc_k)
        acc_k, acc_v = new_k, new_v
    from deepspeed_tpu_torch.ops.attention.masked_flash import _group_sum
    part = torch.float32 if G > 1 else k.dtype
    return _group_sum((acc_k * sm_scale).to(part), acc_v.to(part), k, v)


# --------------------------------------------------------------------- #
# the kernels' wrappers
# --------------------------------------------------------------------- #
def _check_args(q, k, v, key_mask, blocks):
    """What the kernels and their plain versions both require."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash kernels take (B, H, Sq, D) q and (B, Hkv, "
                         f"Sk, D) k/v, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or H % k.shape[1] != 0:
        raise ValueError(f"flash kernels' shapes: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    bq, bk = blocks
    if Sq % bq != 0 or Sk % bk != 0:
        raise ValueError(f"tiles ({bq}, {bk}) do not divide seq ({Sq}, "
                         f"{Sk})")
    if key_mask is not None and (tuple(key_mask.shape) != (B, Sk)
                                 or key_mask.dtype != torch.float32):
        raise ValueError(f"flash kernels take an fp32 (B, Sk) = ({B}, {Sk}) "
                         f"key mask, got {key_mask.dtype} "
                         f"{tuple(key_mask.shape)}")


def _check_cuda(tensors, key_mask, blocks):
    from deepspeed_tpu_torch.ops.attention.masked_flash import (
        _DTYPE_CODE, KERNEL_BLOCKS, MAX_HEAD_DIM)
    q = tensors[0]
    B, H, _, D = q.shape
    if q.device.type != "cuda":
        raise ValueError(f"flash kernels run on cuda or cpu, not "
                         f"{q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash kernels take {list(_DTYPE_CODE)}, got "
                        f"{q.dtype}")
    for t in (*tensors, *(() if key_mask is None else (key_mask,))):
        if t.device != q.device:
            raise ValueError(f"flash kernels: operands on {t.device} and "
                             f"{q.device}")
        if not t.is_contiguous():
            raise ValueError("flash kernels need contiguous operands")
    for t in tensors[1:4]:
        if t.dtype != q.dtype:
            raise TypeError(f"flash kernels take one dtype for q, k, v and "
                            f"do, got {q.dtype} and {t.dtype}")
    for t in tensors[4:]:
        if t.dtype != torch.float32:
            raise TypeError(f"flash kernels take fp32 lse and delta, got "
                            f"{t.dtype}")
    if D % 8 != 0 or D > MAX_HEAD_DIM:
        raise ValueError(f"flash kernels take head_dim a multiple of 8 up "
                         f"to {MAX_HEAD_DIM}, got {D}")
    if any(b not in KERNEL_BLOCKS for b in blocks):
        raise ValueError(f"flash kernels take tiles of {KERNEL_BLOCKS}, got "
                         f"{tuple(blocks)}")
    if B * H > 65535:
        raise ValueError(f"flash kernels take B*H <= 65535, got {B * H}")


_fns = {}
_P, _I = ctypes.c_void_p, ctypes.c_int
# what every entry point takes after its pointers and dtype (and
# fp32_out): bh, heads, kv_heads, seq_q, seq_k, head_dim, block_q,
# block_k, causal; then masked_flash._TAIL (sm_scale, dropout,
# keep_thresh, inv_keep, seed, stream)
_GEOMETRY = [_I] * 9


def _kernel(name: str, n_ptrs: int, n_ints: int):
    """One of ``flash.cu``'s C entry points, built and typed at first use:
    ``n_ptrs`` pointers and ``n_ints`` ints before the geometry."""
    fn = _fns.get(name)
    if fn is None:
        from deepspeed_tpu_torch.ops._build import load
        from deepspeed_tpu_torch.ops.attention.masked_flash import _TAIL
        fn = getattr(load("flash.cu"), name)
        fn.restype = ctypes.c_int
        fn.argtypes = [_P] * n_ptrs + [_I] * n_ints + _GEOMETRY + _TAIL
        _fns[name] = fn
    return fn


def _launch(name, q, k, ptrs, ints, causal, blocks, sm_scale, rate, seed):
    """Launch ``name`` with the tensors ``ptrs`` (None: a null pointer),
    q's dtype code and ``ints`` on q's device and current stream; raise on
    a refused launch."""
    from deepspeed_tpu_torch.ops.attention.masked_flash import (
        _DTYPE_CODE, _dropout, _run)
    B, H, Sq, D = q.shape
    fn = _kernel(name, len(ptrs), 1 + len(ints))
    _run(name, fn, q,
         [None if t is None else t.data_ptr() for t in ptrs]
         + [_DTYPE_CODE[q.dtype], *ints, B * H, H, k.shape[1], Sq,
            k.shape[2], D, *blocks, int(bool(causal))]
         + _dropout(sm_scale, rate, seed))


def arity(key_mask, causal: bool) -> str:
    """The name of the kernel arity a call runs: ``"kpm causal"``,
    ``"plain full"``, ..."""
    return (f"{'kpm' if key_mask is not None else 'plain'} "
            f"{'causal' if causal else 'full'}")


def _count(wrapper, key_mask, causal):
    """One launch of ``wrapper``'s kernel: ``launches`` counts every
    launch, ``arities`` every launch by :func:`arity`."""
    wrapper.launches += 1
    name = arity(key_mask, causal)
    wrapper.arities[name] = wrapper.arities.get(name, 0) + 1


def _prepare(q, k, v, key_mask, blocks, rate):
    from deepspeed_tpu_torch.ops.attention.masked_flash import \
        _check_hash_rounds
    blocks = tuple(blocks or _pick_blocks(q.shape[2], k.shape[2], q.device))
    _check_args(q, k, v, key_mask, blocks)
    _check_hash_rounds(rate)
    return blocks


def causal_cells(seq_q: int, seq_k: int) -> int:
    """The (query, key) cells causal attention computes per (batch,
    head): key j of query i for j <= i, of the keys that exist."""
    n = min(seq_q, seq_k)
    return n * (n + 1) // 2 + (seq_q - n) * seq_k


def walk_flops(q, k, causal: bool, dots: int) -> int:
    """FLOPs of one K5-K7 call: two per product, ``dots`` products of
    length D (``masked_flash.FWD_DOTS`` ...) per computed cell, the
    causal cells only under ``causal``; key-mask pads count."""
    B, H, sq, D = q.shape
    sk = k.shape[2]
    cells = causal_cells(sq, sk) if causal else sq * sk
    return cells * B * H * dots * 2 * D


@counted_flops("flash_fwd", lambda q, k, v, causal, *a, **kw:
               walk_flops(q, k, causal, 2))
def flash_fwd(q, k, v, causal: bool, sm_scale: float, rate: float = 0.0,
              seed: int = 0, key_mask=None, blocks=None):
    """K5: ``(o, lse)`` of :func:`flash_fwd_plain`. A CUDA ``q`` launches
    the sm_90a kernel (raising on any dtype, shape, device or launch
    problem), K1's tensor-core body in bf16 and the CUDA-core body in
    fp32 (``masked_flash.FWD_BODIES``); a CPU ``q`` runs the plain
    version. Every launch counts in ``launches``, in ``arities`` under
    :func:`arity` and in ``bodies`` under its body."""
    blocks = _prepare(q, k, v, key_mask, blocks, rate)
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, causal, sm_scale, rate, seed,
                               key_mask, blocks)
    from deepspeed_tpu_torch.ops.attention.masked_flash import (
        _check_fwd_aligned, _count_body)
    _check_cuda((q, k, v), key_mask, blocks)
    _check_fwd_aligned(q, k, v, key_mask)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    _launch("flash_fwd", q, k, [q, k, v, key_mask, o, lse], [], causal,
            blocks, sm_scale, rate, seed)
    _count(flash_fwd, key_mask, causal)
    _count_body(flash_fwd, q.dtype)
    return o, lse


@counted_flops("flash_dq", lambda q, k, v, do, lse, delta, causal, *a,
               **kw: walk_flops(q, k, causal, 3))
def flash_dq(q, k, v, do, lse, delta, causal: bool, sm_scale: float,
             rate: float = 0.0, seed: int = 0, key_mask=None, blocks=None):
    """K6: ``dq`` of :func:`flash_dq_plain`; kernel on CUDA, K2's
    tensor-core body in bf16 and the CUDA-core body in fp32
    (``masked_flash.DQ_BODIES``, counted in ``bodies``); plain version on
    the CPU."""
    blocks = _prepare(q, k, v, key_mask, blocks, rate)
    if q.device.type == "cpu":
        return flash_dq_plain(q, k, v, do, lse, delta, causal, sm_scale,
                              rate, seed, key_mask, blocks)
    from deepspeed_tpu_torch.ops.attention.masked_flash import (
        DQ_BODIES, _check_dq_aligned, _count_body)
    _check_cuda((q, k, v, do, lse, delta), key_mask, blocks)
    _check_dq_aligned(q, k, v, do, key_mask)
    dq = torch.empty_like(q)
    _launch("flash_dq", q, k, [q, k, v, key_mask, do, lse, delta, dq], [],
            causal, blocks, sm_scale, rate, seed)
    _count(flash_dq, key_mask, causal)
    _count_body(flash_dq, q.dtype, DQ_BODIES)
    return dq


@counted_flops("flash_dkv", lambda q, k, v, do, lse, delta, causal, *a,
               **kw: walk_flops(q, k, causal, 4))
def flash_dkv(q, k, v, do, lse, delta, causal: bool, sm_scale: float,
              rate: float = 0.0, seed: int = 0, key_mask=None, blocks=None):
    """K7: ``(dk, dv)`` of :func:`flash_dkv_plain`; kernel on CUDA (fp32
    per-q-head partials at G > 1, summed here), K3's tensor-core body in
    bf16 and the CUDA-core body in fp32 (``masked_flash.DKV_BODIES``,
    counted in ``bodies``); plain version on the CPU."""
    blocks = _prepare(q, k, v, key_mask, blocks, rate)
    if q.device.type == "cpu":
        return flash_dkv_plain(q, k, v, do, lse, delta, causal, sm_scale,
                               rate, seed, key_mask, blocks)
    from deepspeed_tpu_torch.ops.attention.masked_flash import (
        DKV_BODIES, _check_dkv_aligned, _count_body, _group_sum)
    _check_cuda((q, k, v, do, lse, delta), key_mask, blocks)
    _check_dkv_aligned(q, k, v, do, key_mask)
    B, H, _, D = q.shape
    G = H // k.shape[1]
    part = torch.float32 if G > 1 else k.dtype
    dk = torch.empty((B, H, k.shape[2], D), dtype=part, device=q.device)
    dv = torch.empty_like(dk)
    _launch("flash_dkv", q, k, [q, k, v, key_mask, do, lse, delta, dk, dv],
            [int(G > 1)], causal, blocks, sm_scale, rate, seed)
    _count(flash_dkv, key_mask, causal)
    _count_body(flash_dkv, q.dtype, DKV_BODIES)
    return _group_sum(dk, dv, k, v)


def reset_launches():
    """Set every launch count of K5-K7 to 0."""
    for w in (flash_fwd, flash_dq, flash_dkv):
        w.launches = 0
        w.arities = {}
        w.bodies = {}


reset_launches()


class _Flash(torch.autograd.Function):
    """Forward K5, saving (q, k, v, key_mask, o, lse); backward delta =
    sum(do * o) in fp32, then K6 and K7. The key mask takes no gradient:
    a zero one where asked for, as the JAX package's vjp returns."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, seed, causal, sm_scale, rate):
        o, lse = flash_fwd(q, k, v, causal, sm_scale, rate, seed, key_mask)
        ctx.save_for_backward(q, k, v, key_mask, o, lse)
        ctx.args = (causal, sm_scale, rate, seed)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, key_mask, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = (do.float() * o.float()).sum(dim=-1)
        args = (*ctx.args, key_mask)
        dq = flash_dq(q, k, v, do, lse, delta, *args)
        dk, dv = flash_dkv(q, k, v, do, lse, delta, *args)
        dkm = (torch.zeros_like(key_mask) if ctx.needs_input_grad[3]
               else None)
        return dq, dk, dv, dkm, None, None, None, None


def flash_call(q, k, v, seed: int, causal: bool, sm_scale: float,
               rate: float, key_mask=None):
    """Low-level entry of K5-K7, all operands explicit: ``o`` with the
    custom backward. ``seed`` is the dropout seed (int32; unused at rate
    0); ``key_mask`` the optional fp32 (B, Sk) additive key mask."""
    return _Flash.apply(
        q.contiguous(), k.contiguous(), v.contiguous(),
        None if key_mask is None else key_mask.contiguous(), int(seed),
        bool(causal), float(sm_scale), float(rate))


# --------------------------------------------------------------------- #
# public API
# --------------------------------------------------------------------- #
def flash_attention(q, k, v, mask=None, causal: bool = False,
                    sm_scale: Optional[float] = None,
                    dropout_rate: float = 0.0,
                    dropout_seed: Optional[int] = None,
                    force_reference: bool = False,
                    kernel: Optional[str] = None):
    """Flash attention with O(S) memory and in-kernel attention dropout.

    q: (batch, heads, seq, head_dim); k, v: (batch, kv_heads, seq_k,
    head_dim) with heads % kv_heads == 0 (GQA served natively).
    mask: optional additive key mask (batch, 1, 1, seq_k).
    dropout_rate > 0 requires ``dropout_seed`` (an int32).
    ``force_reference``: the fp32 :func:`attention_reference`.
    ``kernel``: None (default) follows :func:`get_attention_options`;
    "masked", "flash" or "reference" override it for this call. Inside
    ``functional.batch_rows(row0)`` the dropout draws the masks of the
    global batch's rows from ``row0`` on (the masked route; another route
    raises there)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.shape[1] % k.shape[1] != 0 or k.shape[1] != v.shape[1]:
        raise ValueError(f"flash_attention: heads must be a multiple of "
                         f"kv_heads, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if kernel is None:
        kernel = _OPTIONS.kernel
    elif kernel not in KERNELS:
        raise ValueError(f"flash_attention: kernel must be one of "
                         f"{KERNELS}, got {kernel!r}")
    dropout_rate = float(dropout_rate)
    if dropout_rate > 0.0:
        if dropout_seed is None:
            raise ValueError("flash_attention: dropout_rate > 0 requires "
                             "dropout_seed")
        if dropout_rate >= 1.0:
            raise ValueError(f"dropout_rate must be < 1, got "
                             f"{dropout_rate}")
    sq, sk = q.shape[2], k.shape[2]
    from deepspeed_tpu_torch.ops.functional import batch_row0
    bh0 = batch_row0() * q.shape[1]
    masked = kernel == "masked" and (not causal or sq == sk) and \
        not force_reference and sq % 16 == 0 and sk % 16 == 0
    if dropout_rate > 0.0 and bh0 and not masked:
        raise NotImplementedError(
            "flash_attention: attention dropout at a data-parallel rank's "
            "rows of a global batch runs on the masked route (K1-K3) only; "
            f"kernel={kernel!r}, seq ({sq}, {sk}) would draw the local "
            "rows' masks")
    force_ref = kernel == "reference"
    if force_ref and max(sq, sk) >= STREAM_THRESHOLD:
        # the A/B knob never re-routes a long-context run onto the O(S^2)
        # path: at the streaming threshold it is ignored, loudly
        log_once(("ref-stream", sq, sk),
                 f"flash_attention: kernel='reference' ignored at seq "
                 f"({sq}, {sk}) >= {STREAM_THRESHOLD} — the O(S^2) "
                 "reference path is not meaningful (or feasible) there.",
                 warn=True)
        force_ref = False
    if force_reference or force_ref or sq % 16 != 0 or sk % 16 != 0:
        if not force_reference and not force_ref and max(sq, sk) > 2048:
            log_once(("irregular-fallback", sq, sk),
                     f"flash_attention: seq ({sq}, {sk}) not divisible "
                     "by 16 — falling back to the O(S^2)-memory dense "
                     "reference path. Pad the sequence to a multiple of "
                     "16 to use the kernels.", warn=True)
        return attention_reference(
            q, k, v, mask=mask, causal=causal, sm_scale=sm_scale,
            dropout_rate=dropout_rate,
            dropout_seed=dropout_seed if dropout_rate > 0.0 else None,
            mxu_bf16=force_ref and not force_reference)
    if mask is not None and (mask.dim() != 4 or mask.shape[1] != 1
                             or mask.shape[2] != 1):
        raise ValueError(f"flash path expects a (B,1,1,Sk) additive mask, "
                         f"got {tuple(mask.shape)}")
    if kernel == "masked" and (not causal or sq == sk):
        from deepspeed_tpu_torch.ops.attention.masked_flash import \
            masked_flash_attention
        return masked_flash_attention(
            q, k, v, _dense_block_mask(sq, sk, bool(causal)),
            key_mask=mask, sm_scale=float(sm_scale),
            dropout_rate=dropout_rate, dropout_seed=dropout_seed,
            dropout_bh0=bh0)
    key_mask = None if mask is None else mask.reshape(q.shape[0], sk).float()
    return flash_call(q, k, v, dropout_seed or 0, causal, sm_scale,
                      dropout_rate, key_mask)
