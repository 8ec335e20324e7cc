"""Elementwise building blocks (the port of
``deepspeed_tpu/ops/functional.py``'s ``layer_norm``, ``rms_norm``,
``_hash_keep_mask`` and ``dropout``).

GELU is ``torch.nn.functional.gelu(x, approximate="tanh")`` at its call
site, as ``jax.nn.gelu(approximate=True)`` is in the JAX model.

``dropout`` takes its 32-bit seed directly: the JAX function folds it out
of a ``jax.random`` key's data, which torch cannot reproduce. Given the
same seed, the keep mask is the JAX package's bit for bit (the hash runs
in int64 with the uint32 wrap-around done by hand; see
``ops/attention/flash.py``).
"""

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.ops.attention.flash import (_M32, _mul32,
                                                     keep_threshold)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-12) -> torch.Tensor:
    """LayerNorm with fp32 statistics whatever the input dtype (biased
    variance, as the JAX version), output in the input dtype."""
    out = F.layer_norm(x.float(), (x.shape[-1],), w.float(), b.float(),
                       eps)
    return out.to(x.dtype)


def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with fp32 statistics (no mean subtraction, no bias),
    output in the input dtype: the pre-norm of the llama family."""
    x32 = x.float()
    ms = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(ms + eps) * w.float()).to(x.dtype)


def _hash_keep_mask(seed32: int, n: int, rate: float,
                    device=None) -> torch.Tensor:
    """lowbias32-style counter hash over ``0..n-1`` -> bool keep mask of
    n elements (True = keep)."""
    x = torch.arange(n, dtype=torch.int64, device=device) ^ (int(seed32)
                                                              & _M32)
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    x = x ^ (x >> 16)
    return x < keep_threshold(rate)


def dropout(x: torch.Tensor, rate: float, seed32, deterministic: bool):
    """Inverted dropout with the hash keep mask of ``seed32``; identity
    when deterministic, rate == 0 or ``seed32`` is None."""
    if deterministic or rate == 0.0 or seed32 is None:
        return x
    keep = 1.0 - rate
    mask = _hash_keep_mask(seed32, x.numel(), rate,
                           device=x.device).reshape(x.shape)
    return torch.where(mask, x / keep, torch.zeros_like(x))
