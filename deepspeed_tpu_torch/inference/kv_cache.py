"""KV-cache geometry, allocation and accounting (the port of
``deepspeed_tpu/inference/kv_cache.py``). Two geometries:

**Dense** (``paged_kv.enabled: false``): one preallocated pair of tensors
``(kc, vc)``, each ``(layers, batch_rows, kv_heads, max_len, head_dim)``:
every serving slot owns a whole ``max_len`` row. ``batch_rows`` is
``max_batch_size + 1``: the extra row is the *scratch slot*, where the
padding rows of a partly filled prefill bucket write.

**Paged** (the default): a fixed pool of ``num_pages`` pages, each
``(kv_heads, page_size, head_dim)``, held as one pair of tensors shaped
``(layers, num_pages, kv_heads, page_size, head_dim)`` on the engine's
device, plus the host-side :class:`PageAllocator`. Page 0 is the reserved *null page*:
unallocated block-table entries and padding-row writes land there, and
nothing ever reads it unmasked. An int8 pool carries two more tensors,
the fp32 per-token-row scale pools ``(layers, num_pages, kv_heads,
page_size, scale_blocks)``, addressed by the same block tables: the
allocator knows nothing of them.

Writes happen inside the model forward
(:func:`deepspeed_tpu_torch.models.gpt2.write_kv_cache`,
:func:`~deepspeed_tpu_torch.models.gpt2.write_paged_kv_cache`), in
place: where the JAX engine donates the pool to each compiled program
and gets a new one back, the port's programs update these tensors
directly and never reallocate them.
"""

import math
from typing import Any, NamedTuple, Tuple

import torch

from deepspeed_tpu_torch.inference.paging import PageAllocator, pages_for

__all__ = ["KVCacheSpec", "cache_spec_for", "init_kv_cache",
           "kv_cache_bytes", "PagedKVSpec", "paged_spec_for",
           "init_paged_kv_cache", "paged_kv_bytes", "pages_for",
           "PageAllocator"]


class KVCacheSpec(NamedTuple):
    """Static geometry of the dense serving KV cache."""
    num_layers: int
    batch_rows: int      # serving slots + 1 scratch row
    kv_heads: int        # GQA: the cache stays kv_heads-sized
    max_len: int
    head_dim: int
    dtype: Any = torch.bfloat16

    @property
    def shape(self) -> Tuple[int, int, int, int, int]:
        return (self.num_layers, self.batch_rows, self.kv_heads,
                self.max_len, self.head_dim)


def cache_spec_for(model_config, batch_rows: int, max_len: int,
                   dtype=torch.bfloat16) -> KVCacheSpec:
    """Dense cache geometry from a model config: kv_heads-sized for the
    GQA family."""
    kv_heads, head_dim = _model_kv_geometry(model_config)
    if max_len > model_config.max_position_embeddings:
        raise ValueError(
            f"kv cache max_len {max_len} exceeds the model's "
            f"max_position_embeddings {model_config.max_position_embeddings}")
    return KVCacheSpec(num_layers=model_config.num_layers,
                       batch_rows=batch_rows, kv_heads=kv_heads,
                       max_len=max_len, head_dim=head_dim, dtype=dtype)


def init_kv_cache(spec: KVCacheSpec, device) -> Tuple[torch.Tensor, ...]:
    """The zeroed ``(kc, vc)`` pair on ``device``."""
    return tuple(torch.zeros(spec.shape, dtype=spec.dtype, device=device)
                 for _ in range(2))


def _pair_bytes(spec) -> int:
    """Bytes of a (kc, vc) pair of ``spec.shape`` and ``spec.dtype``."""
    return 2 * math.prod(spec.shape) * \
        torch.empty((), dtype=spec.dtype).element_size()


def kv_cache_bytes(spec: KVCacheSpec) -> int:
    """Total bytes of the dense (kc, vc) pair."""
    return _pair_bytes(spec)


class PagedKVSpec(NamedTuple):
    """Static geometry of the paged serving KV cache. ``pages_per_seq``
    is the block-table width: every slot's table maps that many logical
    page positions (covering ``max_len`` tokens), entries beyond its
    reservation pointing at the null page 0.

    ``dtype=torch.int8`` is the quantized pool: int8 payload with
    per-token-row fp32 absmax scales beside it, the cache tree being the
    4-tuple ``(kc, vc, kscale, vscale)``. ``quant_block`` is the scale
    granularity along head_dim (0 = one scale per token row). Scales
    are per token row because decode fills a page one token at a time."""
    num_layers: int
    num_pages: int       # pool size, INCLUDING the reserved null page 0
    page_size: int
    kv_heads: int
    head_dim: int
    pages_per_seq: int
    dtype: Any = torch.bfloat16
    quant_block: int = 0  # scale block over head_dim (0 = head_dim)

    @property
    def shape(self) -> Tuple[int, int, int, int, int]:
        return (self.num_layers, self.num_pages, self.kv_heads,
                self.page_size, self.head_dim)

    @property
    def quantized(self) -> bool:
        return self.dtype == torch.int8

    @property
    def scale_blocks(self) -> int:
        """Scales per token row: head_dim / quant_block."""
        return self.head_dim // (self.quant_block or self.head_dim)

    @property
    def scale_shape(self) -> Tuple[int, int, int, int, int]:
        return (self.num_layers, self.num_pages, self.kv_heads,
                self.page_size, self.scale_blocks)


def _model_kv_geometry(model_config):
    """(kv_heads, head_dim): a LlamaConfig carries both (the pool is
    kv_heads-sized under GQA); a GPT2Config has one kv head per head."""
    kv_heads = getattr(model_config, "kv_heads", None) or \
        model_config.num_heads
    head_dim = getattr(model_config, "head_dim", None) or (
        model_config.hidden_size // model_config.num_heads)
    return kv_heads, head_dim


def paged_spec_for(model_config, num_pages: int, page_size: int,
                   max_len: int, dtype=torch.bfloat16,
                   kv_quant_block: int = 0) -> PagedKVSpec:
    """Paged cache geometry from a model config. The engine resolves
    ``num_pages == 0`` (auto) before calling. ``dtype=torch.int8``
    selects the quantized pool; ``kv_quant_block`` (0 = head_dim) sets
    its per-row scale block and must divide head_dim."""
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
    block = int(kv_quant_block) if dtype == torch.int8 else 0
    if block and head_dim % block != 0:
        raise ValueError(
            f"paged kv cache kv_quant_block ({block}) must divide "
            f"head_dim ({head_dim})")
    return PagedKVSpec(num_layers=model_config.num_layers,
                       num_pages=num_pages, page_size=page_size,
                       kv_heads=kv_heads, head_dim=head_dim,
                       pages_per_seq=pages_for(max_len, page_size),
                       dtype=dtype, quant_block=block)


def init_paged_kv_cache(spec: PagedKVSpec, device) -> Tuple[torch.Tensor,
                                                             ...]:
    """Allocate the zeroed pool tree on ``device``: the ``(kc, vc)``
    pair, plus the ``(kscale, vscale)`` fp32 scale pools when the spec
    is int8 (a 4-tuple). Zero scales are fine: the null page and
    unwritten rows are never read unmasked, and a quantized write always
    stores a scale > 0."""
    pools = tuple(torch.zeros(spec.shape, dtype=spec.dtype, device=device)
                  for _ in range(2))
    if spec.quantized:
        pools += tuple(torch.zeros(spec.scale_shape, dtype=torch.float32,
                                   device=device) for _ in range(2))
    return pools


def paged_kv_bytes(spec: PagedKVSpec) -> int:
    """Total bytes of the pool tree: the payload pair, and the fp32
    scale pools when int8."""
    total = _pair_bytes(spec)
    if spec.quantized:
        total += 2 * math.prod(spec.scale_shape) * 4
    return total
