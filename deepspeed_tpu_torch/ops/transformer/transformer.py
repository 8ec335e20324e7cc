"""The DeepSpeed transformer layer (the port of
``deepspeed_tpu/ops/transformer/transformer.py``).

The layer is a function over a dict of 12 parameters, ``qkvw``, ``qkvb``,
``ow``, ``ob``, ``attn_nw``, ``attn_nb``, ``inter_w``, ``inter_b``,
``output_w``, ``output_b``, ``norm_w`` and ``norm_b``, with the JAX
package's names and shapes (weights are ``(in, out)``). The attention
core is :func:`~deepspeed_tpu_torch.ops.attention.flash.flash_attention`,
which runs the masked-flash kernels K1-K3, with a BERT ``(B, 1, 1, S)``
additive mask in their key-mask arity and the attention dropout inside
them. GELU is the exact one, as ``jax.nn.gelu(approximate=False)``.

Where the JAX layer splits a ``jax.random`` key into one key per dropout
site, the port takes the layer's int32 ``seed`` and folds one seed per
site (:func:`~deepspeed_tpu_torch.ops.functional.fold_seed`): the masks
are the JAX package's hash, but not the JAX run's bits.

The recompute knobs map onto non-reentrant ``torch.utils.checkpoint``
over the segment each names: ``attn_dropout_checkpoint`` the attention
block, ``gelu_checkpoint`` the feed-forward block, ``normalize_invertible``
each LayerNorm. They change what is kept for the backward, not the
numbers.
"""

import math
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from deepspeed_tpu_torch.ops.attention.flash import flash_attention
from deepspeed_tpu_torch.ops.functional import dropout, fold_seed, layer_norm
from deepspeed_tpu_torch.utils.logging import log_once

__all__ = ["DeepSpeedTransformerConfig", "DeepSpeedTransformerLayer",
           "init_transformer_params", "transformer_layer_forward"]


class DeepSpeedTransformerConfig:
    """The layer's configuration (the JAX class's fields and defaults).
    The CUDA-build knobs of the reference (``stochastic_mode``,
    ``huggingface``, ``local_rank``, ``seed``) are kept for config
    compatibility."""

    def __init__(self,
                 batch_size: int = -1,
                 max_seq_length: int = -1,
                 hidden_size: int = -1,
                 intermediate_size: int = -1,
                 heads: int = -1,
                 attn_dropout_ratio: float = -1,
                 hidden_dropout_ratio: float = -1,
                 num_hidden_layers: int = -1,
                 initializer_range: float = -1,
                 local_rank: int = -1,
                 seed: int = -1,
                 fp16: bool = False,
                 bf16: bool = True,
                 pre_layer_norm: bool = True,
                 normalize_invertible: bool = False,
                 gelu_checkpoint: bool = False,
                 adjust_init_range: bool = True,
                 attn_dropout_checkpoint: bool = False,
                 stochastic_mode: bool = False,
                 huggingface: bool = False,
                 training: bool = True):
        self.batch_size = batch_size
        self.max_seq_length = max_seq_length
        self.hidden_size = hidden_size
        self.intermediate_size = (intermediate_size if intermediate_size > 0
                                  else 4 * hidden_size)
        self.heads = heads
        self.attn_dropout_ratio = max(attn_dropout_ratio, 0.0)
        self.hidden_dropout_ratio = max(hidden_dropout_ratio, 0.0)
        self.num_hidden_layers = num_hidden_layers
        self.initializer_range = (initializer_range if initializer_range > 0
                                  else 0.02)
        self.local_rank = local_rank
        self.seed = seed
        self.fp16 = fp16
        self.bf16 = bf16 and not fp16
        self.pre_layer_norm = pre_layer_norm
        self.normalize_invertible = normalize_invertible
        self.gelu_checkpoint = gelu_checkpoint
        self.attn_dropout_checkpoint = attn_dropout_checkpoint
        self.adjust_init_range = adjust_init_range
        self.stochastic_mode = stochastic_mode
        self.huggingface = huggingface
        self.training = training

    @property
    def compute_dtype(self) -> torch.dtype:
        if self.fp16:
            return torch.float16
        if self.bf16:
            return torch.bfloat16
        return torch.float32

    @classmethod
    def from_dict(cls, json_object):
        config = cls()
        for key, value in json_object.items():
            setattr(config, key, value)
        if config.intermediate_size <= 0:
            config.intermediate_size = 4 * config.hidden_size
        return config


def init_transformer_params(config: DeepSpeedTransformerConfig,
                            generator: torch.Generator,
                            layer_id: int = 0) -> Dict[str, torch.Tensor]:
    """The 12 parameters, fp32 on the generator's device: normal weights
    at ``initializer_range`` (``ow`` and ``output_w`` scaled by
    ``1/sqrt(2 * num_hidden_layers)`` under ``adjust_init_range``), zero
    biases, unit LayerNorm gains. The numbers differ from ``jax.random``'s;
    carry a JAX tree across for the same weights."""
    del layer_id                       # as in JAX: the scaling is per stack
    h = config.hidden_size
    inter = config.intermediate_size
    rng = config.initializer_range
    out_rng = rng
    if config.adjust_init_range and config.num_hidden_layers > 0:
        out_rng = rng / math.sqrt(2.0 * config.num_hidden_layers)
    dev = generator.device

    def normal(shape, std):
        return torch.randn(shape, generator=generator, device=dev,
                           dtype=torch.float32) * std

    def full(n, value):
        return torch.full((n,), value, dtype=torch.float32, device=dev)

    return {
        "qkvw": normal((h, 3 * h), rng), "qkvb": full(3 * h, 0.0),
        "ow": normal((h, h), out_rng), "ob": full(h, 0.0),
        "attn_nw": full(h, 1.0), "attn_nb": full(h, 0.0),
        "inter_w": normal((h, inter), rng), "inter_b": full(inter, 0.0),
        "output_w": normal((inter, h), out_rng), "output_b": full(h, 0.0),
        "norm_w": full(h, 1.0), "norm_b": full(h, 0.0),
    }


def _maybe_checkpoint(fn: Callable, on: bool) -> Callable:
    if not on:
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


def transformer_layer_forward(params: Dict[str, Any],
                              config: DeepSpeedTransformerConfig,
                              hidden_states: torch.Tensor,
                              attention_mask: Optional[torch.Tensor] = None,
                              seed: Optional[int] = None,
                              deterministic: Optional[bool] = None,
                              use_flash: bool = True,
                              attention_fn: Optional[Callable] = None):
    """One encoder layer, pre-LN or post-LN. hidden_states: (B, S, H);
    ``attention_mask``: additive (B, 1, 1, S) or None; ``seed``: this
    layer's int32 dropout seed (None: no dropout). ``use_flash=False``
    runs the attention as two einsums with an fp32 softmax;
    ``attention_fn(q, k, v, additive_mask) -> ctx`` replaces the core on
    (B, heads, S, hd) tensors (it applies no attention dropout).
    Returns (B, S, H) in the config's compute dtype."""
    if deterministic is None:
        deterministic = not config.training
    dtype = config.compute_dtype
    x = hidden_states.to(dtype)
    h = config.hidden_size
    heads = config.heads
    if heads <= 0 or h % heads != 0:
        raise ValueError(f"hidden_size {h} must be divisible by heads "
                         f"{heads}")
    hd = h // heads
    B, S, _ = x.shape
    s_attn, s_h1, s_h2 = ((None,) * 3 if seed is None
                          else (fold_seed(seed, i) for i in range(3)))

    def attn_block(x_in):
        qkv = x_in @ params["qkvw"].to(dtype) + params["qkvb"].to(dtype)
        q, k, v = (t.reshape(B, S, heads, hd).transpose(1, 2)
                   for t in qkv.split(h, dim=-1))
        attn_drop = (config.attn_dropout_ratio
                     if (config.attn_dropout_ratio > 0 and not deterministic
                         and s_attn is not None) else 0.0)
        if attention_fn is not None:
            if attn_drop > 0:
                log_once("attention_fn-no-dropout",
                         "attention_fn override active with attn_dropout "
                         "> 0: the custom core attention applies NO "
                         "attention dropout; hidden dropout still applies",
                         warn=True)
            ctx = attention_fn(q, k, v, attention_mask)
        elif not use_flash:
            s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) \
                * (1.0 / math.sqrt(hd))
            if attention_mask is not None:
                s = s + attention_mask.float()
            p = torch.softmax(s, dim=-1).to(dtype)
            p = dropout(p, config.attn_dropout_ratio, s_attn, deterministic)
            ctx = torch.einsum("bhqk,bhkd->bhqd", p, v)
        else:
            ctx = flash_attention(q, k, v, mask=attention_mask,
                                  dropout_rate=attn_drop,
                                  dropout_seed=s_attn if attn_drop > 0
                                  else None)
        ctx = ctx.transpose(1, 2).reshape(B, S, h)
        out = ctx @ params["ow"].to(dtype) + params["ob"].to(dtype)
        return dropout(out, config.hidden_dropout_ratio, s_h1, deterministic)

    def ff_block(x_in):
        inter = x_in @ params["inter_w"].to(dtype) + \
            params["inter_b"].to(dtype)
        inter = F.gelu(inter)
        out = inter @ params["output_w"].to(dtype) + \
            params["output_b"].to(dtype)
        return dropout(out, config.hidden_dropout_ratio, s_h2, deterministic)

    attn = _maybe_checkpoint(attn_block, config.attn_dropout_checkpoint)
    ff = _maybe_checkpoint(ff_block, config.gelu_checkpoint)
    ln = _maybe_checkpoint(layer_norm, config.normalize_invertible)
    if config.pre_layer_norm:
        x = x + attn(ln(x, params["attn_nw"], params["attn_nb"]))
        x = x + ff(ln(x, params["norm_w"], params["norm_b"]))
    else:                                  # post-LN (original BERT)
        x = ln(x + attn(x), params["attn_nw"], params["attn_nb"])
        x = ln(x + ff(x), params["norm_w"], params["norm_b"])
    return x


class DeepSpeedTransformerLayer(torch.nn.Module):
    """Module facade over :func:`transformer_layer_forward`, mirroring the
    reference class: the 12 parameters as ``nn.Parameter``s, from
    ``initial_params`` or :func:`init_transformer_params` with
    ``generator`` (default: seeded from ``config.seed``, or 0)."""

    layer_id_counter = 0

    def __init__(self, config: DeepSpeedTransformerConfig,
                 generator: Optional[torch.Generator] = None,
                 initial_params: Optional[Dict[str, Any]] = None):
        super().__init__()
        self.config = config
        self.layer_id = DeepSpeedTransformerLayer.layer_id_counter
        DeepSpeedTransformerLayer.layer_id_counter += 1
        if initial_params is None:
            if generator is None:
                generator = torch.Generator().manual_seed(
                    config.seed if config.seed >= 0 else 0)
            initial_params = init_transformer_params(config, generator,
                                                     self.layer_id)
        for name, value in initial_params.items():
            if not isinstance(value, torch.Tensor):
                value = torch.from_numpy(np.array(value))
            self.register_parameter(name, torch.nn.Parameter(
                value.detach().to(torch.float32).clone()))

    def forward(self, hidden_states, attention_mask=None,
                seed: Optional[int] = None,
                deterministic: Optional[bool] = None):
        return transformer_layer_forward(
            dict(self.named_parameters()), self.config, hidden_states,
            attention_mask=attention_mask, seed=seed,
            deterministic=deterministic)
