"""GPT-2 for serving (the port of the cached, paged path of
``deepspeed_tpu/models/gpt2.py``).

Parameters are a plain dict with the JAX package's tree layout:
``wte``, ``wpe``, ``ln_f`` and one ``h_{i}`` dict per block, each leaf a
``torch.Tensor`` with the JAX leaf's shape (weights are ``(in, out)``,
so a projection is ``x @ w + b`` in both packages). :func:`params_from_jax`
carries a JAX tree across through numpy, under either JAX layout.

The forward here is the serving forward: one token of decode or a padded
prompt of prefill, with K/V written into the paged pool and attention
read back from it. Training (causal flash attention, dropout, the loss)
arrives with the training slice.
"""

import math
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.ops.attention.paged import (NEG_INF,
                                                     paged_decode_attention)
from deepspeed_tpu_torch.ops.functional import layer_norm

__all__ = ["GPT2Config", "GPT2_SMALL", "GPT2_MEDIUM", "GPT2_LARGE",
           "GPT2_XL", "init_gpt2_params", "params_from_jax", "gpt2_block",
           "gpt2_forward", "causal_cache_mask", "write_paged_kv_cache",
           "gather_paged_kv", "paged_decode_ctx"]


class GPT2Config(NamedTuple):
    vocab_size: int = 50257
    max_position_embeddings: int = 1024
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 0      # 0 => 4*hidden
    embd_dropout: float = 0.1
    attn_dropout: float = 0.1
    resid_dropout: float = 0.1
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-5
    # the JAX package's stacked-layer layout switch; params_from_jax
    # reads either layout, and the port always keeps one h_{i} per block
    scan_layers: bool = False

    @property
    def inter(self):
        return self.intermediate_size or 4 * self.hidden_size


# canonical sizes (Megatron/GPT-2 papers)
GPT2_SMALL = GPT2Config()                                          # 124M
GPT2_MEDIUM = GPT2Config(hidden_size=1024, num_layers=24,
                         num_heads=16)                             # 345M
GPT2_LARGE = GPT2Config(hidden_size=1280, num_layers=36,
                        num_heads=20)                              # 774M
GPT2_XL = GPT2Config(hidden_size=1600, num_layers=48,
                     num_heads=25)                                 # 1.5B


def init_gpt2_params(config: GPT2Config,
                     generator: torch.Generator) -> Dict[str, Any]:
    """Random fp32 parameters with the JAX init's distributions (normal
    weights at ``initializer_range``, output projections scaled by
    ``1/sqrt(2 * num_layers)``, zero biases, unit LayerNorm gains), on
    the generator's device. The numbers differ from ``jax.random``'s;
    use :func:`params_from_jax` for the same weights in both packages."""
    h, inter = config.hidden_size, config.inter
    rng = config.initializer_range
    out_rng = rng / math.sqrt(2.0 * config.num_layers)
    dev = generator.device

    def normal(shape, std):
        return torch.randn(shape, generator=generator, device=dev,
                           dtype=torch.float32) * std

    def ones(n):
        return torch.ones((n,), dtype=torch.float32, device=dev)

    def zeros(n):
        return torch.zeros((n,), dtype=torch.float32, device=dev)

    params: Dict[str, Any] = {
        "wte": normal((config.vocab_size, h), rng),
        "wpe": normal((config.max_position_embeddings, h), rng),
        "ln_f": {"w": ones(h), "b": zeros(h)},
    }
    for i in range(config.num_layers):
        params[f"h_{i}"] = {
            "ln_1": {"w": ones(h), "b": zeros(h)},
            "attn": {"qkvw": normal((h, 3 * h), rng),
                     "qkvb": zeros(3 * h),
                     "ow": normal((h, h), out_rng),
                     "ob": zeros(h)},
            "ln_2": {"w": ones(h), "b": zeros(h)},
            "mlp": {"fc_w": normal((h, inter), rng),
                    "fc_b": zeros(inter),
                    "proj_w": normal((inter, h), out_rng),
                    "proj_b": zeros(h)},
        }
    return params


def _tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def params_from_jax(tree) -> Dict[str, Any]:
    """Torch parameters from a JAX GPT-2 param tree whose leaves are
    numpy arrays (``np.asarray`` of each JAX leaf). Reads both JAX
    layouts — one ``h_{i}`` dict per block, or the ``scan_layers``
    stack ``h`` with a leading layer dim — and returns the ``h_{i}``
    layout. Values and dtypes are kept as they are."""
    def leaf(a):
        return torch.from_numpy(np.array(a, copy=True))

    out = {k: _tree_map(leaf, v) for k, v in tree.items() if k != "h"}
    if "h" in tree:
        layers = next(iter(_leaves(tree["h"]))).shape[0]
        for i in range(layers):
            out[f"h_{i}"] = _tree_map(lambda a, i=i: leaf(np.asarray(a)[i]),
                                      tree["h"])
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def gpt2_block(block_params, config: GPT2Config, x: torch.Tensor, dtype,
               attention_fn: Callable) -> torch.Tensor:
    """One pre-LN transformer block, deterministic (serving).
    ``attention_fn(q, k, v)`` takes (B, heads, S, hd) tensors and returns
    the context in the same layout; the serving paths pass the paged
    cache attention of :func:`_paged_cache_attention`."""
    if attention_fn is None:
        raise NotImplementedError(
            "gpt2_block without attention_fn is the JAX package's causal "
            "flash-attention training path (Pallas kernels K1-K3), which "
            "is not ported yet")
    B, S, h = x.shape
    heads = config.num_heads
    hd = h // heads
    a_in = layer_norm(x, block_params["ln_1"]["w"], block_params["ln_1"]["b"],
                      config.layer_norm_eps)
    ap = block_params["attn"]
    qkv = a_in @ ap["qkvw"].to(dtype) + ap["qkvb"].to(dtype)
    q, k, v = qkv.split(h, dim=-1)
    q = q.reshape(B, S, heads, hd).transpose(1, 2)
    k = k.reshape(B, S, heads, hd).transpose(1, 2)
    v = v.reshape(B, S, heads, hd).transpose(1, 2)
    ctx = attention_fn(q, k, v)
    ctx = ctx.transpose(1, 2).reshape(B, S, h)
    x = x + (ctx @ ap["ow"].to(dtype) + ap["ob"].to(dtype))

    m_in = layer_norm(x, block_params["ln_2"]["w"], block_params["ln_2"]["b"],
                      config.layer_norm_eps)
    mp = block_params["mlp"]
    hmid = m_in @ mp["fc_w"].to(dtype) + mp["fc_b"].to(dtype)
    hmid = F.gelu(hmid, approximate="tanh")
    return x + (hmid @ mp["proj_w"].to(dtype) + mp["proj_b"].to(dtype))


def tied_head_weight(wte: torch.Tensor, dtype) -> torch.Tensor:
    """The LM head's weight operand: ``wte`` rounded to ``dtype`` and
    held in fp32 (see :func:`_tied_logits`). A serving engine makes it
    once rather than casting the whole embedding at every step."""
    return wte.to(dtype).float()


def _tied_logits(x: torch.Tensor, head_w: torch.Tensor,
                 dtype) -> torch.Tensor:
    """LM head tied to the embedding: operands in ``dtype``, fp32
    accumulation and fp32 logits. ``head_w`` is
    :func:`tied_head_weight`. The product of two bf16 values is exact in
    fp32, so widening the rounded operands and multiplying in fp32 gives
    the JAX head's bf16-operand, fp32-accumulate result."""
    return x.to(dtype).float() @ head_w.t()


def causal_cache_mask(cache_position: torch.Tensor, q_len: int,
                      kv_len: int) -> torch.Tensor:
    """Causal mask over a KV cache that respects per-row cache offsets:
    query j of row b sits at ``cache_position[b] + j`` and may attend
    cache slots ``<=`` that position. Returns bool (B, 1, q_len,
    kv_len)."""
    dev = cache_position.device
    q_pos = cache_position.long()[:, None] + \
        torch.arange(q_len, device=dev)[None, :]
    k_idx = torch.arange(kv_len, device=dev)
    return k_idx[None, None, None, :] <= q_pos[:, None, :, None]


def write_paged_kv_cache(pool: torch.Tensor, new: torch.Tensor,
                         block_table: torch.Tensor,
                         cache_position: torch.Tensor) -> torch.Tensor:
    """Scatter ``new`` (B, heads, S, hd) into the paged pool
    ``(num_pages, heads, page_size, hd)`` IN PLACE: row b's token j lands
    in page ``block_table[b, (cache_position[b]+j) // page_size]`` at
    offset ``(cache_position[b]+j) % page_size``. Positions past the
    table's extent, and unreserved (0) entries, land in the null page
    0, which nothing reads unmasked. Returns ``pool``."""
    B, H, S, hd = new.shape
    P = block_table.shape[1]
    ps = pool.shape[2]
    pos = cache_position.long()[:, None] + \
        torch.arange(S, device=pool.device)[None, :]             # (B, S)
    slot = pos // ps
    page = torch.where(
        slot < P,
        torch.gather(block_table.long(), 1, torch.clamp(slot, max=P - 1)),
        torch.zeros_like(slot))
    vals = new.to(pool.dtype).transpose(1, 2).reshape(B * S, H, hd)
    pool[page.reshape(-1), :, (pos % ps).reshape(-1)] = vals
    return pool


def gather_paged_kv(pool: torch.Tensor,
                    block_table: torch.Tensor) -> torch.Tensor:
    """Each row's logical K or V stripe from the paged pool:
    ``(B, pages_per_seq)`` table over ``(num_pages, heads, page_size,
    hd)`` -> ``(B, heads, pages_per_seq * page_size, hd)``; gathered
    position ``t * page_size + o`` is the row's absolute position."""
    B, P = block_table.shape
    _, H, ps, hd = pool.shape
    return pool[block_table.long()].transpose(1, 2).reshape(B, H, P * ps, hd)


def paged_decode_ctx(q, kpool, vpool, block_table, cache_position):
    """The seq-1 kernel dispatch: run
    :func:`~deepspeed_tpu_torch.ops.attention.paged.paged_decode_attention`
    against the (already-written) pool and restore the (B, H, 1, hd)
    context layout."""
    out = paged_decode_attention(q[:, :, 0].contiguous(), kpool, vpool,
                                 block_table, cache_position)
    return out[:, :, None, :]


def _paged_cache_attention(kpool, vpool, block_table, cache_position,
                           attn_kernel: str = "gather"):
    """attention_fn for the paged cached forward: scatter this call's
    K/V into the pool (in place), then attend. Single-query calls with
    ``attn_kernel="kernel"`` run the paged-decode kernel straight
    against the pool (only live pages are read); everything else gathers
    each row's stripe and attends in fp32 under
    :func:`causal_cache_mask` — the plain path, as in the JAX package."""
    def attn(q, k, v):
        write_paged_kv_cache(kpool, k, block_table, cache_position)
        write_paged_kv_cache(vpool, v, block_table, cache_position)
        if attn_kernel == "kernel" and q.shape[2] == 1:
            return paged_decode_ctx(q, kpool, vpool, block_table,
                                    cache_position)
        kc = gather_paged_kv(kpool, block_table)
        vc = gather_paged_kv(vpool, block_table)
        hd = q.shape[-1]
        scores = (q.float() @ kc.float().transpose(-1, -2)) / math.sqrt(hd)
        mask = causal_cache_mask(cache_position, q.shape[2], kc.shape[2])
        scores = torch.where(mask, scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        return (probs @ vc.float()).to(q.dtype)
    return attn


def _gpt2_trunk_cached(params, config: GPT2Config, input_ids, kv_cache,
                       cache_position, dtype, block_tables,
                       paged_attn_kernel: str = "gather") -> torch.Tensor:
    """Run ``input_ids`` (B, S) through every block with attention over
    the paged pool pair ``kv_cache = (kc, vc)`` (each (layers, num_pages,
    heads, page_size, hd)), writing this call's K/V at each row's
    ``cache_position`` offset in place. Returns the hidden states after
    ``ln_f``. Serves prefill (S = padded prompt) and decode (S = 1) with
    one code path."""
    if block_tables is None:
        raise NotImplementedError(
            "the dense (B, heads, max_len, hd) KV cache of the JAX package "
            "(inference.paged_kv.enabled: false) is not ported; pass "
            "block_tables over a paged pool")
    kc, vc = kv_cache
    B, S = input_ids.shape
    dev = input_ids.device
    pos = cache_position.long()[:, None] + torch.arange(S, device=dev)[None, :]
    # jnp gathers clamp out-of-range indices; so do these
    pos = pos.clamp(0, config.max_position_embeddings - 1)
    ids = input_ids.long().clamp(0, config.vocab_size - 1)
    x = (params["wte"][ids].float() + params["wpe"][pos].float()).to(dtype)
    for i in range(config.num_layers):
        attn = _paged_cache_attention(kc[i], vc[i], block_tables,
                                      cache_position, paged_attn_kernel)
        x = gpt2_block(params[f"h_{i}"], config, x, dtype, attention_fn=attn)
    return layer_norm(x, params["ln_f"]["w"], params["ln_f"]["b"],
                      config.layer_norm_eps)


def gpt2_forward(params, config: GPT2Config, input_ids, dtype=torch.bfloat16,
                 kv_cache=None, cache_position=None, block_tables=None,
                 paged_attn_kernel: str = "gather"):
    """Serving forward: ``(logits (B, S, vocab) fp32, kv_cache)``.

    ``kv_cache = (kc, vc)`` is the paged pool pair, updated in place
    (the same tensors come back); ``cache_position`` ((B,) int) is each
    row's first query position; ``block_tables`` ((B, pages_per_seq)
    int) maps logical pages to pool pages; ``paged_attn_kernel`` is
    ``"kernel"`` (the paged-decode kernel for seq-1 queries) or
    ``"gather"`` (the plain stripe path)."""
    if kv_cache is None:
        raise NotImplementedError(
            "gpt2_forward without kv_cache is the JAX package's training "
            "forward (causal flash attention), which is not ported yet")
    if cache_position is None:
        cache_position = torch.zeros((input_ids.shape[0],), dtype=torch.int32,
                                     device=input_ids.device)
    x = _gpt2_trunk_cached(params, config, input_ids, kv_cache,
                           cache_position, dtype, block_tables,
                           paged_attn_kernel)
    return _tied_logits(x, tied_head_weight(params["wte"], dtype),
                        dtype), kv_cache
