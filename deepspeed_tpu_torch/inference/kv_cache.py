"""Paged KV-cache geometry, allocation and accounting (the port of the
paged half of ``deepspeed_tpu/inference/kv_cache.py``).

A fixed pool of ``num_pages`` pages, each ``(kv_heads, page_size,
head_dim)``, held as one pair of tensors shaped ``(layers, num_pages,
kv_heads, page_size, head_dim)`` on the engine's device, plus the
host-side :class:`PageAllocator`. Page 0 is the reserved *null page*:
unallocated block-table entries and padding-row writes land there, and
nothing ever reads it unmasked.

Writes happen inside the model forward
(:func:`deepspeed_tpu_torch.models.gpt2.write_paged_kv_cache`), in
place: where the JAX engine donates the pool to each compiled program
and gets a new one back, the port's programs update these two tensors
directly and never reallocate them.
"""

import math
from typing import Any, NamedTuple, Tuple

import torch

from deepspeed_tpu_torch.inference.paging import PageAllocator, pages_for

__all__ = ["PagedKVSpec", "paged_spec_for", "init_paged_kv_cache",
           "paged_kv_bytes", "pages_for", "PageAllocator"]


class PagedKVSpec(NamedTuple):
    """Static geometry of the paged serving KV cache. ``pages_per_seq``
    is the block-table width: every slot's table maps that many logical
    page positions (covering ``max_len`` tokens), entries beyond its
    reservation pointing at the null page 0."""
    num_layers: int
    num_pages: int       # pool size, INCLUDING the reserved null page 0
    page_size: int
    kv_heads: int
    head_dim: int
    pages_per_seq: int
    dtype: Any = torch.bfloat16

    @property
    def shape(self) -> Tuple[int, int, int, int, int]:
        return (self.num_layers, self.num_pages, self.kv_heads,
                self.page_size, self.head_dim)


def _model_kv_geometry(model_config):
    kv_heads = getattr(model_config, "kv_heads", None) or \
        model_config.num_heads
    head_dim = getattr(model_config, "head_dim", None) or (
        model_config.hidden_size // model_config.num_heads)
    return kv_heads, head_dim


def paged_spec_for(model_config, num_pages: int, page_size: int,
                   max_len: int, dtype=torch.bfloat16) -> PagedKVSpec:
    """Paged cache geometry from a model config. The engine resolves
    ``num_pages == 0`` (auto) before calling."""
    kv_heads, head_dim = _model_kv_geometry(model_config)
    if max_len > model_config.max_position_embeddings:
        raise ValueError(
            f"paged kv cache max_len {max_len} exceeds the model's "
            f"max_position_embeddings {model_config.max_position_embeddings}")
    if page_size < 1 or num_pages < 2:
        raise ValueError(
            f"paged kv cache needs page_size >= 1 and num_pages >= 2 "
            f"(one null + one usable), got page_size={page_size}, "
            f"num_pages={num_pages}")
    return PagedKVSpec(num_layers=model_config.num_layers,
                       num_pages=num_pages, page_size=page_size,
                       kv_heads=kv_heads, head_dim=head_dim,
                       pages_per_seq=pages_for(max_len, page_size),
                       dtype=dtype)


def init_paged_kv_cache(spec: PagedKVSpec, device) -> Tuple[torch.Tensor,
                                                             torch.Tensor]:
    """Allocate the zeroed ``(kc, vc)`` pool pair on ``device``."""
    return (torch.zeros(spec.shape, dtype=spec.dtype, device=device),
            torch.zeros(spec.shape, dtype=spec.dtype, device=device))


def paged_kv_bytes(spec: PagedKVSpec) -> int:
    """Total bytes of the (kc, vc) pool pair."""
    return 2 * math.prod(spec.shape) * \
        torch.empty((), dtype=spec.dtype).element_size()
