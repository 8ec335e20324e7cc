"""Llama-style decoder family (the port of ``deepspeed_tpu/models/llama.py``):
RoPE, RMSNorm, SwiGLU and grouped-query attention, for the forward and
the cached, paged serving path.

Parameters are a plain dict with the JAX package's tree layout:
``tok_emb``, ``ln_f``, the untied ``lm_head`` (stored (vocab, hidden)
like a tied embedding) and the blocks, either one ``h_{i}`` dict per
block or, under ``scan_layers``, one stacked ``h`` with a leading layer
dim. Weights are ``(in, out)``. :func:`llama_params_from_jax` carries a
JAX tree across through numpy.

Without a cache the blocks run causal
:func:`~deepspeed_tpu_torch.ops.attention.flash.flash_attention`, whose
kernels serve GQA natively. Training: :func:`llama_loss_fn` is the
engine's loss contract, with per-block activation checkpointing under
``remat``; the stacked layout's leaves take their gradients through the
per-block views. With a paged cache they run
``models.gpt2._paged_cache_attention`` (the JAX package's
``_gqa_paged_cache_attention``): K/V go into the kv_heads-sized pool,
dense or int8, and seq-1 queries read it through the paged-decode
kernel, the q heads of a group sharing their kv head's pages. With the
dense slot cache they run ``models.gpt2._offset_cache_attention`` (the
JAX package's ``_gqa_offset_cache_attention``). Weights go through
``models.gpt2._wd``, so int8-resident blocks dequantize at each use.
:func:`llama_generate` prefills through causal flash attention (K1 on
the card) and decodes over a kv_heads-sized dense cache.

Not ported yet: ``llama_param_specs`` and the ring-prefill branch of the
paged attention (they need a serving mesh).
"""

import math
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.models.gpt2 import (_checkpointed, _emb_rows,
                                             _generate_blocks,
                                             _generator_for,
                                             _offset_cache_attention,
                                             _paged_cache_attention,
                                             _tied_logits,
                                             _tied_xent_chunked, _wd,
                                             count_params,
                                             make_token_sampler,
                                             params_from_jax,
                                             run_decode_scan,
                                             tied_head_weight)
from deepspeed_tpu_torch.ops.attention.flash import flash_attention
from deepspeed_tpu_torch.ops.functional import ieee_fp32_matmul, rms_norm
from deepspeed_tpu_torch.utils.tree import tree_map

__all__ = ["LlamaConfig", "init_llama_params", "llama_params_from_jax",
           "count_params", "rope_cos_sin", "apply_rope", "llama_block",
           "llama_forward", "llama_loss_fn", "llama_generate"]


class LlamaConfig(NamedTuple):
    vocab_size: int = 32000
    hidden_size: int = 512
    num_layers: int = 8
    num_heads: int = 8
    num_kv_heads: int = 0          # 0 => num_heads (MHA); 1 = MQA
    intermediate_size: int = 0     # 0 => the llama 8/3 * hidden, 128-aligned
    max_position_embeddings: int = 2048
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5
    initializer_range: float = 0.02
    scan_layers: bool = False

    @property
    def kv_heads(self):
        return self.num_kv_heads or self.num_heads

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads

    @property
    def inter(self):
        if self.intermediate_size:
            return self.intermediate_size
        raw = int(self.hidden_size * 8 / 3)
        return (raw + 127) // 128 * 128


def init_llama_params(config: LlamaConfig,
                      generator: Optional[torch.Generator],
                      device=None) -> Dict[str, Any]:
    """Random fp32 parameters with the JAX init's distributions (normal
    weights at ``initializer_range``, ``wo`` and ``w_down`` scaled by
    ``1/sqrt(2 * num_layers)``, unit RMSNorm gains), on the generator's
    device, in the layout ``config.scan_layers`` names. The numbers
    differ from ``jax.random``'s; use :func:`llama_params_from_jax` for
    the same weights in both packages. ``device="meta"`` (``generator``
    None) gives the tree's shapes and dtypes without memory: a checkpoint
    loader's template."""
    h, hd = config.hidden_size, config.head_dim
    hkv, inter = config.kv_heads, config.inter
    rng = config.initializer_range
    out_rng = rng / math.sqrt(2.0 * config.num_layers)
    dev = torch.device(device) if device is not None else generator.device

    def normal(shape, std):
        if dev.type == "meta":
            return torch.empty(shape, dtype=torch.float32, device=dev)
        return torch.randn(shape, generator=generator, device=dev,
                           dtype=torch.float32) * std

    def ones(n):
        return torch.ones((n,), dtype=torch.float32, device=dev)

    params: Dict[str, Any] = {
        "tok_emb": normal((config.vocab_size, h), rng),
        "ln_f": {"w": ones(h)},
        "lm_head": normal((config.vocab_size, h), rng),
    }
    layers = []
    for _ in range(config.num_layers):
        layers.append({
            "ln_1": {"w": ones(h)},
            "attn": {"wq": normal((h, h), rng),
                     "wk": normal((h, hkv * hd), rng),
                     "wv": normal((h, hkv * hd), rng),
                     "wo": normal((h, h), out_rng)},
            "ln_2": {"w": ones(h)},
            "mlp": {"w_gate": normal((h, inter), rng),
                    "w_up": normal((h, inter), rng),
                    "w_down": normal((inter, h), out_rng)},
        })
    if config.scan_layers:
        params["h"] = tree_map(lambda *xs: torch.stack(xs), *layers)
    else:
        for i, lp in enumerate(layers):
            params[f"h_{i}"] = lp
    return params


def llama_params_from_jax(tree) -> Dict[str, Any]:
    """Torch parameters from a JAX Llama param tree whose leaves are
    numpy arrays (``np.asarray`` of each JAX leaf), read from either JAX
    layout and returned with one ``h_{i}`` dict per block (the model
    functions read either). Values and dtypes are kept as they are."""
    return params_from_jax(tree)


def layer_params(params, i: int):
    """Block i's parameters under whichever layout the tree has."""
    if "h" in params:
        return tree_map(lambda a: a[i], params["h"])
    return params[f"h_{i}"]


def rope_cos_sin(seq_len: int, head_dim: int, theta: float,
                 dtype=torch.float32, device=None):
    """(S, hd/2) cos/sin tables for rotary embedding. The inverse
    frequencies are made in numpy fp32 and the angles as an fp32 outer
    product, as in the JAX package, so the angles are the same bits;
    ``torch.cos``/``sin`` may differ from XLA's by an ulp."""
    inv = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                           / head_dim))
    t = torch.arange(seq_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, torch.from_numpy(inv.astype(np.float32)).to(
        t.device))
    return torch.cos(freqs).to(dtype), torch.sin(freqs).to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate (B, H, S, hd) by per-position angles, in x's dtype.

    ``cos``/``sin`` are either the shared (S, hd/2) tables (every row at
    positions 0..S-1) or per-row (B, S, hd/2) gathers (serving slots sit
    at different absolute positions). Pair layout is (x[..., :hd/2],
    x[..., hd/2:]), the "rotate_half" convention."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.dim() == 3:           # (B, S, hd/2): broadcast over heads only
        c = cos[:, None].to(x.dtype)
        s = sin[:, None].to(x.dtype)
    else:                        # (S, hd/2): broadcast over batch + heads
        c = cos[None, None].to(x.dtype)
        s = sin[None, None].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)


def llama_block(block_params, config: LlamaConfig, x: torch.Tensor, cos,
                sin, dtype,
                attention_fn: Optional[Callable] = None) -> torch.Tensor:
    """One pre-RMSNorm block: GQA attention with RoPE, then SwiGLU.
    ``attention_fn(q, k, v) -> ctx`` replaces causal GQA flash attention
    (q post-RoPE (B, H, S, hd); k/v (B, kv_heads, S, hd), k post-RoPE):
    the KV-cache hook."""
    B, S, h = x.shape
    H, hkv, hd = config.num_heads, config.kv_heads, config.head_dim
    a_in = rms_norm(x, block_params["ln_1"]["w"], config.rms_norm_eps)
    ap = block_params["attn"]
    q = (a_in @ _wd(ap["wq"], dtype)).reshape(B, S, H, hd)
    k = (a_in @ _wd(ap["wk"], dtype)).reshape(B, S, hkv, hd)
    v = (a_in @ _wd(ap["wv"], dtype)).reshape(B, S, hkv, hd)
    q = apply_rope(q.transpose(1, 2), cos, sin)
    k = apply_rope(k.transpose(1, 2), cos, sin)
    v = v.transpose(1, 2)
    if attention_fn is not None:
        ctx = attention_fn(q, k, v)
    else:
        ctx = flash_attention(q, k, v, causal=True)      # native GQA
    ctx = ctx.transpose(1, 2).reshape(B, S, h)
    x = x + ctx @ _wd(ap["wo"], dtype)

    m_in = rms_norm(x, block_params["ln_2"]["w"], config.rms_norm_eps)
    mp = block_params["mlp"]
    gate = F.silu(m_in @ _wd(mp["w_gate"], dtype))
    up = m_in @ _wd(mp["w_up"], dtype)
    return x + (gate * up) @ _wd(mp["w_down"], dtype)


def _llama_trunk(params, config: LlamaConfig, input_ids,
                 dtype=torch.bfloat16, remat: bool = False) -> torch.Tensor:
    """Final hidden states (B, S, hidden) after ln_f (no LM head).
    ``remat`` recomputes each block's activations in the backward
    instead of keeping them (``jax.checkpoint`` per block in JAX)."""
    B, S = input_ids.shape
    if S > config.max_position_embeddings:
        raise ValueError(
            f"sequence length {S} exceeds max_position_embeddings "
            f"{config.max_position_embeddings}: RoPE would extrapolate")
    x = _emb_rows(params["tok_emb"], input_ids, dtype)
    cos, sin = rope_cos_sin(S, config.head_dim, config.rope_theta,
                            device=x.device)
    block = _checkpointed(llama_block) if remat else llama_block
    for i in range(config.num_layers):
        x = block(layer_params(params, i), config, x, cos, sin, dtype)
    return rms_norm(x, params["ln_f"]["w"], config.rms_norm_eps)


def llama_loss_fn(config: LlamaConfig, dtype=torch.bfloat16,
                  remat: bool = False, deterministic: bool = True):
    """Engine-contract loss: ``batch = {"input_ids": (B, S+1) int}``,
    next-token cross entropy on the shifted ids through the chunked fp32
    head over the untied ``lm_head``. The family has no dropout, so
    ``deterministic`` and the step's seed are accepted and ignored."""
    del deterministic

    def loss_fn(params, batch, seed):
        del seed
        ids = batch["input_ids"]
        inputs, targets = ids[:, :-1], ids[:, 1:]
        x = _llama_trunk(params, config, inputs, dtype=dtype, remat=remat)
        return _tied_xent_chunked(x, params["lm_head"], targets, dtype)
    return loss_fn


# the JAX package's names for the cache attention_fns of this family;
# the port's gpt2 ones attend group-wise already, so both families share
# them
_gqa_paged_cache_attention = _paged_cache_attention
_gqa_offset_cache_attention = _offset_cache_attention


def _llama_trunk_cached(params, config: LlamaConfig, input_ids, kv_cache,
                        cache_position, dtype, block_tables,
                        paged_attn_kernel: str = "gather",
                        rope=None) -> torch.Tensor:
    """Cache-carrying trunk (see ``gpt2._gpt2_trunk_cached``): one code
    path for prefill into the cache and decode, through the same
    :func:`llama_block` as the plain forward. ``kv_cache`` is the paged
    pool tree, ``(kc, vc)`` (each (layers, num_pages, kv_heads,
    page_size, hd)) or the int8 pool's ``(kc, vc, kscale, vscale)``, or
    without ``block_tables`` the dense slot cache ``(kc, vc)`` (each
    (layers, B, kv_heads, max_len, hd)), updated in place. RoPE angles
    are gathered per row at each token's absolute position from
    ``rope``, the ``(cos, sin)`` tables of :func:`rope_cos_sin` (made
    here over the cache's extent when None; a serving engine makes them
    once). Returns the hidden states after ln_f."""
    B, S = input_ids.shape
    dev = input_ids.device
    if rope is None:
        max_len = kv_cache[0].shape[3] if block_tables is None else \
            block_tables.shape[1] * kv_cache[0].shape[3]
        rope = rope_cos_sin(max_len, config.head_dim, config.rope_theta,
                            device=dev)
    cos_full, sin_full = rope
    pos = cache_position.long()[:, None] + torch.arange(S, device=dev)[None, :]
    # jnp gathers clamp out-of-range indices; so do these
    pos = pos.clamp(0, cos_full.shape[0] - 1)
    cos_b, sin_b = cos_full[pos], sin_full[pos]          # (B, S, hd/2)
    x = _emb_rows(params["tok_emb"], input_ids, dtype)
    for i in range(config.num_layers):
        kc, vc, *scales = (c[i] for c in kv_cache)
        if block_tables is None:
            attn = _gqa_offset_cache_attention(kc, vc, cache_position)
        else:
            attn = _gqa_paged_cache_attention(kc, vc, block_tables,
                                              cache_position,
                                              paged_attn_kernel, *scales)
        x = llama_block(layer_params(params, i), config, x, cos_b,
                        sin_b, dtype, attention_fn=attn)
    return rms_norm(x, params["ln_f"]["w"], config.rms_norm_eps)


def llama_forward(params, config: LlamaConfig, input_ids,
                  dtype=torch.bfloat16, kv_cache=None, cache_position=None,
                  block_tables=None, paged_attn_kernel: str = "gather"):
    """Logits (B, S, vocab) in fp32, through the untied ``lm_head``.

    Serving: with ``kv_cache`` (the paged pool tree, or without
    ``block_tables`` the dense slot cache, updated in place; the same
    tensors come back with the logits), ``cache_position``
    ((B,) int, each row's first query position) and ``block_tables``
    ((B, pages_per_seq) int) — the contract of
    :func:`deepspeed_tpu_torch.models.gpt2.gpt2_forward`, including
    ``paged_attn_kernel`` ``"kernel"`` or ``"gather"``."""
    head_w = tied_head_weight(params["lm_head"], dtype)
    if kv_cache is None:
        x = _llama_trunk(params, config, input_ids, dtype=dtype)
        with ieee_fp32_matmul():
            return _tied_logits(x, head_w, dtype)
    if cache_position is None:
        cache_position = torch.zeros((input_ids.shape[0],), dtype=torch.int32,
                                     device=input_ids.device)
    x = _llama_trunk_cached(params, config, input_ids, kv_cache,
                            cache_position, dtype, block_tables,
                            paged_attn_kernel)
    return _tied_logits(x, head_w, dtype), kv_cache


def llama_generate(params, config: LlamaConfig, prompt_ids: torch.Tensor,
                   max_new_tokens: int, generator=None,
                   temperature: float = 1.0, top_k: int = 0,
                   dtype=torch.bfloat16) -> torch.Tensor:
    """Autoregressive sampling with a kv_heads-sized dense KV cache:
    the contract of :func:`deepspeed_tpu_torch.models.gpt2.gpt2_generate`.
    The prefill runs causal :func:`flash_attention` (native GQA, K1 on
    the card) and captures the post-RoPE K/V; each decoded token is one
    forward over the dense cached attention, group-wise."""
    B, Pl = prompt_ids.shape
    if max_new_tokens <= 0:
        return prompt_ids
    L = Pl + max_new_tokens
    if L > config.max_position_embeddings:
        raise ValueError(f"prompt + new tokens ({L}) exceed "
                         f"max_position_embeddings "
                         f"({config.max_position_embeddings})")
    hkv, hd = config.kv_heads, config.head_dim
    nl = config.num_layers
    greedy = generator is None or temperature == 0.0
    dev = prompt_ids.device
    generator = _generator_for(generator, dev)
    sample = make_token_sampler(config.vocab_size, temperature, top_k,
                                greedy)
    with torch.no_grad():
        blocks = _generate_blocks(params, nl, dtype)
        head_w = tied_head_weight(params["lm_head"], dtype)
        cos_full, sin_full = rope_cos_sin(L, hd, config.rope_theta,
                                          device=dev)
        # prefill: one forward over the prompt, capturing post-RoPE K/V
        x = _emb_rows(params["tok_emb"], prompt_ids, dtype)
        kc = torch.zeros((nl, B, hkv, L, hd), dtype=dtype, device=dev)
        vc = torch.zeros_like(kc)
        for i in range(nl):
            def capture(q, k, v, i=i):
                kc[i, :, :, :Pl] = k
                vc[i, :, :, :Pl] = v
                return flash_attention(q, k, v, causal=True)
            x = llama_block(blocks[i], config, x, cos_full[:Pl],
                            sin_full[:Pl], dtype, attention_fn=capture)
        x = rms_norm(x, params["ln_f"]["w"], config.rms_norm_eps)
        first_tok = sample(_tied_logits(x[:, -1], head_w, dtype), generator)

        def step_logits(tok, t, caches):
            kc, vc = caches
            pos = Pl + t                  # position of `tok` in the stream
            x = _emb_rows(params["tok_emb"], tok[:, None], dtype)
            cos_t, sin_t = cos_full[pos:pos + 1], sin_full[pos:pos + 1]
            posv = torch.full((B,), pos, dtype=torch.int32, device=dev)
            for i in range(nl):
                x = llama_block(blocks[i], config, x, cos_t, sin_t, dtype,
                                attention_fn=_gqa_offset_cache_attention(
                                    kc[i], vc[i], posv))
            x = rms_norm(x, params["ln_f"]["w"], config.rms_norm_eps)
            return _tied_logits(x[:, 0], head_w, dtype), caches

        gen = run_decode_scan(step_logits, sample, first_tok, (kc, vc),
                              max_new_tokens, generator)
    return torch.cat([prompt_ids.to(torch.int32), gen], dim=1)
