"""int8-resident parameter storage (the port of
``deepspeed_tpu/runtime/quantized_params.py``): ZeRO++ qwZ blocks kept as
the live weights of a serving engine.

A :class:`QuantizedParam` holds an int8 payload ``q`` with the weight's
own shape and fp32 absmax scales, one per ``block`` values along the last
axis (``scale`` is ``lead + (nb,)``, ``nb = ceil(d / block)``; the last
block may be narrower). The serving programs dequantize each weight at
its use (``models.gpt2._wd``, ``_emb_rows``), so the resident copy stays
int8: a (h, d) weight costs ``h*d + 4*h*nb`` bytes against ``2*h*d`` in
bf16, about 0.51x at the default block of 256.

The payload and the scales are bitwise the JAX package's: absmax per
block, ``absmax / 127`` (1.0 for an all-zero block), round half to even,
clip to +-127, all in fp32.
"""

from typing import Any, Tuple

import torch

from deepspeed_tpu_torch.utils.tree import tree_leaves

__all__ = ["QuantizedParam", "quantize_param", "dequantize_param",
           "quantize_param_tree", "dequantize_param_tree",
           "is_quantized_tree", "quantized_tree_bytes", "param_tree_bytes",
           "map_quantized", "DEFAULT_WEIGHT_BLOCK"]

DEFAULT_WEIGHT_BLOCK = 256


class QuantizedParam:
    """One int8-resident weight: ``q`` int8 (the weight's shape),
    ``scale`` fp32 ``lead + (nb,)``, the dtype it stands in for
    (``orig_dtype``, what :func:`dequantize_param` gives back by
    default) and the block. A tree walker sees it as one leaf."""

    __slots__ = ("q", "scale", "orig_dtype", "block")

    def __init__(self, q: torch.Tensor, scale: torch.Tensor, orig_dtype,
                 block: int):
        self.q = q
        self.scale = scale
        self.orig_dtype = orig_dtype
        self.block = int(block)

    @property
    def shape(self):
        return self.q.shape

    @property
    def nbytes(self) -> int:
        return self.q.numel() * self.q.element_size() + \
            self.scale.numel() * self.scale.element_size()

    def to(self, device) -> "QuantizedParam":
        return QuantizedParam(self.q.to(device), self.scale.to(device),
                              self.orig_dtype, self.block)

    def __repr__(self):
        return (f"QuantizedParam(shape={tuple(self.q.shape)}, "
                f"block={self.block}, orig_dtype={self.orig_dtype})")


def quantize_param(x: torch.Tensor,
                   block: int = DEFAULT_WEIGHT_BLOCK) -> QuantizedParam:
    """Symmetric int8 absmax quantization per ``block`` values along the
    last axis. ``q`` keeps x's shape; ``scale`` is ``lead + (nb,)``."""
    x = torch.as_tensor(x)
    d = x.shape[-1]
    nb = -(-d // block)
    pad = nb * block - d
    xf = x.float()
    if pad:
        xf = torch.nn.functional.pad(xf, (0, pad))
    blocks = xf.reshape(tuple(x.shape[:-1]) + (nb, block))
    absmax = blocks.abs().amax(dim=-1)
    scale = torch.where(absmax > 0, absmax / 127.0,
                        torch.ones_like(absmax))
    q = torch.clamp(torch.round(blocks / scale[..., None]), -127, 127)
    q = q.reshape(tuple(x.shape[:-1]) + (nb * block,))[..., :d]
    return QuantizedParam(q.to(torch.int8).contiguous(), scale, x.dtype,
                          block)


def dequantize_param(p: QuantizedParam, dtype=None) -> torch.Tensor:
    """Per-block dequantization back to ``dtype`` (default: the original
    dtype), in fp32 then cast: the dequantization each weight use
    runs. Where the blocks tile the last axis exactly, each block's scale
    broadcasts over it (one pass over the payload, no widened copy of
    the scales); a narrower last block takes the repeated scales."""
    d = p.q.shape[-1]
    nb = p.scale.shape[-1]
    if nb * p.block == d:
        out = (p.q.reshape(tuple(p.q.shape[:-1]) + (nb, p.block))
               * p.scale[..., None]).reshape(p.q.shape)
    else:
        s = torch.repeat_interleave(p.scale, p.block, dim=-1)[..., :d]
        out = p.q * s
    return out.to(dtype if dtype is not None else p.orig_dtype)


def _is_qp(x) -> bool:
    return isinstance(x, QuantizedParam)


def map_quantized(params, fn, dense_fn=None):
    """Map over a tree of dicts with :class:`QuantizedParam` as a leaf:
    ``fn`` on quantized leaves, ``dense_fn`` (default: identity) on the
    rest."""
    dense_fn = dense_fn or (lambda x: x)
    if isinstance(params, dict):
        return {k: map_quantized(v, fn, dense_fn) for k, v in params.items()}
    return fn(params) if _is_qp(params) else dense_fn(params)


def quantize_param_tree(params, block: int = DEFAULT_WEIGHT_BLOCK):
    """Quantize every floating leaf of two or more dims (matmul weights
    and embeddings); 1-D leaves (biases, norms) stay dense. Quantized
    leaves pass through, so quantizing a quantized tree changes
    nothing."""
    def one(x):
        t = torch.as_tensor(x)
        if t.dim() >= 2 and t.is_floating_point():
            return quantize_param(t, block)
        return x
    return map_quantized(params, lambda p: p, one)


def dequantize_param_tree(params, dtype=None):
    """The floating view of a (possibly) quantized tree."""
    return map_quantized(params, lambda p: dequantize_param(p, dtype))


def _leaves(params):
    if isinstance(params, dict):
        for v in params.values():
            yield from _leaves(v)
    elif _is_qp(params):
        yield params
    else:
        yield from tree_leaves(params)


def is_quantized_tree(params) -> bool:
    return any(_is_qp(leaf) for leaf in _leaves(params))


def _dense_bytes(x) -> int:
    t = torch.as_tensor(x)
    return t.numel() * t.element_size()


def param_tree_bytes(params) -> int:
    """Resident bytes of a param tree (quantized leaves: payload and
    scales)."""
    return sum(leaf.nbytes if _is_qp(leaf) else _dense_bytes(leaf)
               for leaf in _leaves(params))


def quantized_tree_bytes(params) -> Tuple[int, int]:
    """(resident bytes, dense bytes) of one tree: the dense count takes
    every quantized leaf at its original dtype."""
    def dense_one(x: Any) -> int:
        if _is_qp(x):
            return x.q.numel() * torch.empty(
                (), dtype=x.orig_dtype).element_size()
        return _dense_bytes(x)
    return (param_tree_bytes(params),
            sum(dense_one(leaf) for leaf in _leaves(params)))
