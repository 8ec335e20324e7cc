"""Flash attention's front end (the port of the routing, dropout hash and
reference of ``deepspeed_tpu/ops/attention/flash.py``).

:func:`flash_attention` routes as the JAX function does:

- a sequence length that is not a multiple of 16 goes to
  :func:`attention_reference` (the plain O(S^2) path), logged once above
  2048 tokens;
- the default ``kernel="masked"`` route runs the masked-flash kernels
  K1-K3 (``masked_flash.py``) over a dense or causal ``BlockMask``, with
  an additive ``(B, 1, 1, Sk)`` mask (BERT's padding) in their key-mask
  arity;
- the legacy route (``kernel="flash"``, or causal attention with
  ``sq != sk``) reaches the per-path Pallas kernels K5-K7, which are not
  ported: it raises.

The JAX function's pad-to-128 branch for long irregular sequences exists
only for Mosaic's 128-lane DMA rule on the TPU. The CUDA kernels always
stream K/V through shared memory in 32-row chunks, so it does not carry
over.

The dropout keep mask is the JAX package's counter hash, bit for bit.
The port takes an int32 ``dropout_seed`` where JAX takes a ``jax.random``
key (whose ``randint`` torch cannot reproduce). torch on the CPU has no
logical ``>>`` for uint32, so the hash runs in int64 with the 32-bit
wrap-around done by hand.
"""

import math
from functools import lru_cache
from typing import Optional

import torch

from deepspeed_tpu_torch.utils.logging import log_once

__all__ = ["NEG_INF", "flash_attention", "attention_reference",
           "dropout_keep_mask", "dropout_mask_reference", "keep_threshold",
           "pick_block"]

NEG_INF = -1e30
# dropout-hash finalizer rounds: 2 = lowbias32 (default), 1 = a single
# multiply-xorshift round (the JAX package's A/B knob). The plain hash
# follows it; the CUDA kernels have the two rounds compiled in, and their
# wrappers refuse any other value
_HASH_FINAL_ROUNDS = 2

_M32 = 0xFFFFFFFF


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
                        dropout_rate: float = 0.0, dropout_seed=None):
    """Plain attention in fp32. q, k, v: (B, H, S, D), k/v may carry H/G
    heads (GQA); mask: additive, broadcastable to (B, H, Sq, Sk); with
    ``dropout_rate > 0`` the kernels' hash keep-mask from
    ``dropout_seed``. Returns q's dtype."""
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
    return (p @ v.float()).to(q.dtype)


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


def flash_attention(q, k, v, mask=None, causal: bool = False,
                    sm_scale: Optional[float] = None,
                    dropout_rate: float = 0.0,
                    dropout_seed: Optional[int] = None,
                    kernel: str = "masked"):
    """Flash attention with O(S) memory and in-kernel attention dropout.

    q: (batch, heads, seq, head_dim); k, v: (batch, kv_heads, seq_k,
    head_dim) with heads % kv_heads == 0 (GQA served natively).
    mask: optional additive key mask (batch, 1, 1, seq_k).
    dropout_rate > 0 requires ``dropout_seed`` (an int32).
    ``kernel``: "masked" (default, K1-K3) or "flash" (the legacy
    kernels K5-K7, not ported: raises)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.shape[1] % k.shape[1] != 0 or k.shape[1] != v.shape[1]:
        raise ValueError(f"flash_attention: heads must be a multiple of "
                         f"kv_heads, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if kernel not in ("masked", "flash"):
        raise ValueError(f"flash_attention: kernel must be 'masked' or "
                         f"'flash', got {kernel!r}")
    dropout_rate = float(dropout_rate)
    if dropout_rate > 0.0:
        if dropout_seed is None:
            raise ValueError("flash_attention: dropout_rate > 0 requires "
                             "dropout_seed")
        if dropout_rate >= 1.0:
            raise ValueError(f"dropout_rate must be < 1, got "
                             f"{dropout_rate}")
    sq, sk = q.shape[2], k.shape[2]
    if sq % 16 != 0 or sk % 16 != 0:
        if max(sq, sk) > 2048:
            log_once(("irregular-fallback", sq, sk),
                     f"flash_attention: seq ({sq}, {sk}) not divisible "
                     "by 16 — falling back to the O(S^2)-memory dense "
                     "reference path. Pad the sequence to a multiple of "
                     "16 to use the kernels.", warn=True)
        return attention_reference(
            q, k, v, mask=mask, causal=causal, sm_scale=sm_scale,
            dropout_rate=dropout_rate,
            dropout_seed=dropout_seed if dropout_rate > 0.0 else None)
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
            dropout_rate=dropout_rate, dropout_seed=dropout_seed)
    raise NotImplementedError(
        "flash_attention: the legacy route (kernel='flash', or causal "
        "attention with seq_q != seq_k) runs the Pallas kernels K5-K7 "
        "(deepspeed_tpu/ops/attention/flash.py _fwd_kernel, "
        "_bwd_dq_kernel, _bwd_dkv_kernel), which are not ported yet")
