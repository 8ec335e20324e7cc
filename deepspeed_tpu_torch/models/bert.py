"""BERT (the port of ``deepspeed_tpu/models/bert.py``): the bing_bert MLM
pretraining workload on the DeepSpeed transformer layer stack.

Parameters are a plain dict with the JAX package's tree layout:
``tok_emb``, ``pos_emb``, ``type_emb``, ``emb_ln``, ``mlm_dense``,
``mlm_ln``, ``mlm_bias`` and either one ``layer_{i}`` dict per layer or
the stacked ``layers`` dict (leading layer dim). The model reads the
layout the tree has. :func:`bert_params_from_jax` carries a JAX tree
across through numpy.

:func:`bert_mlm_loss_fn` is the engine's loss contract
``loss_fn(params, batch, seed)``: embeddings, LayerNorm, the layers with
BERT's ``-1e9`` additive padding mask (which reaches the masked-flash
kernels K1-K3 through their key-mask arity), then the MLM head (dense,
exact GELU, LayerNorm, the bf16-operand fp32-accumulation product
against the tied ``tok_emb``, ``mlm_bias``) and the masked mean NLL with
``-100`` labels ignored. Layer ``i`` draws its dropout seed as
``fold_seed(seed, i)``.

With a ``sparsity_config`` the layers' core attention is block-sparse
(``ops/sparse_attention``): ``SparseSelfAttention`` in 'mul' mode over
the batch's (B, S) 1/0 mask, through the layer's ``attention_fn`` hook,
so K1-K3 run on the config's layout (per-head layouts at their block,
banded ones over a coarsened walk with KIND_BAND tiles).

Not ported: the sequence-parallel ``bert_mlm_sp_loss_fn`` (ring
attention, K5-K7) and ``bert_param_specs`` (tensor parallelism).
"""

from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from deepspeed_tpu_torch.models.gpt2 import count_params
from deepspeed_tpu_torch.ops.functional import (fold_seed, layer_norm,
                                                matmul_bf16_accum_fp32)
from deepspeed_tpu_torch.ops.transformer.transformer import (
    DeepSpeedTransformerConfig, init_transformer_params,
    transformer_layer_forward)
from deepspeed_tpu_torch.utils.tree import tree_leaves, tree_map

__all__ = ["BertConfig", "BERT_BASE", "BERT_LARGE", "layer_config",
           "init_bert_params", "bert_params_from_jax", "bert_encoder",
           "bert_mlm_loss_fn", "count_params"]


class BertConfig(NamedTuple):
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout: float = 0.1
    attn_dropout: float = 0.1
    initializer_range: float = 0.02
    pre_layer_norm: bool = True
    # the JAX package's stacked-layer layout switch: init_bert_params
    # makes the stacked ``layers`` tree under it
    scan_layers: bool = False


BERT_BASE = BertConfig()
BERT_LARGE = BertConfig(hidden_size=1024, num_layers=24, num_heads=16,
                        intermediate_size=4096)


def layer_config(config: BertConfig, training: bool = True,
                 dtype=torch.bfloat16) -> DeepSpeedTransformerConfig:
    return DeepSpeedTransformerConfig(
        bf16=(dtype == torch.bfloat16),
        fp16=(dtype == torch.float16),
        hidden_size=config.hidden_size,
        intermediate_size=config.intermediate_size,
        heads=config.num_heads,
        attn_dropout_ratio=config.attn_dropout,
        hidden_dropout_ratio=config.hidden_dropout,
        num_hidden_layers=config.num_layers,
        initializer_range=config.initializer_range,
        pre_layer_norm=config.pre_layer_norm,
        training=training)


def init_bert_params(config: BertConfig,
                     generator: torch.Generator) -> Dict[str, Any]:
    """Random fp32 parameters with the JAX init's distributions, on the
    generator's device, in the ``layer_{i}`` layout or (``scan_layers``)
    the stacked ``layers`` one. The numbers differ from ``jax.random``'s;
    use :func:`bert_params_from_jax` for the same weights in both
    packages."""
    h = config.hidden_size
    rng = config.initializer_range
    dev = generator.device

    def normal(shape):
        return torch.randn(shape, generator=generator, device=dev,
                           dtype=torch.float32) * rng

    def full(n, value):
        return torch.full((n,), value, dtype=torch.float32, device=dev)

    params: Dict[str, Any] = {
        "tok_emb": normal((config.vocab_size, h)),
        "pos_emb": normal((config.max_position_embeddings, h)),
        "type_emb": normal((config.type_vocab_size, h)),
        "emb_ln": {"w": full(h, 1.0), "b": full(h, 0.0)},
        "mlm_dense": {"w": normal((h, h)), "b": full(h, 0.0)},
        "mlm_ln": {"w": full(h, 1.0), "b": full(h, 0.0)},
        "mlm_bias": full(config.vocab_size, 0.0),
    }
    lcfg = layer_config(config)
    layers = [init_transformer_params(lcfg, generator, i)
              for i in range(config.num_layers)]
    if config.scan_layers:
        params["layers"] = tree_map(lambda *xs: torch.stack(xs), *layers)
    else:
        for i, lp in enumerate(layers):
            params[f"layer_{i}"] = lp
    return params


def bert_params_from_jax(tree) -> Dict[str, Any]:
    """Torch parameters from a JAX BERT param tree whose leaves are numpy
    arrays (``np.asarray`` of each JAX leaf), in the layout the tree has
    (``layer_{i}`` or stacked ``layers``). Values and dtypes are kept."""
    return tree_map(lambda a: torch.from_numpy(np.array(a, copy=True)),
                    dict(tree))


def _num_layers(params) -> int:
    if "layers" in params:
        return int(next(tree_leaves(params["layers"])).shape[0])
    return sum(1 for k in params if k.startswith("layer_"))


def _layer(params, i: int):
    if "layers" in params:
        return tree_map(lambda t: t[i], params["layers"])
    return params[f"layer_{i}"]


def _ln(x, p, eps: float = 1e-12):
    return layer_norm(x, p["w"], p["b"], eps)


def bert_encoder(params, config: BertConfig, input_ids, attention_mask=None,
                 token_type_ids=None, seed: Optional[int] = None,
                 deterministic: bool = True, dtype=torch.bfloat16,
                 remat: bool = False, sparsity_config=None):
    """Sequence output (B, S, H) in ``dtype``. ``attention_mask``: (B, S)
    with 1 = keep; ``seed``: the step's int32 dropout seed (None: no
    dropout); ``remat`` recomputes each layer in the backward
    (non-reentrant ``torch.utils.checkpoint``).

    ``sparsity_config``: a SparsityConfig — the layers' core attention is
    block-sparse, the projections and all other params unchanged. S must
    be a multiple of its block (``SparseAttentionUtils.pad_to_block_size``).
    Positions past the table clamp to its last row, as JAX's gather does:
    extend the table first
    (``SparseAttentionUtils.extend_position_embedding``)."""
    B, S = input_ids.shape
    lcfg = layer_config(config, training=not deterministic, dtype=dtype)
    dev = input_ids.device
    # jnp gathers clamp out-of-range indices; so do these
    ids = input_ids.long().clamp(0, params["tok_emb"].shape[0] - 1)
    pos = torch.arange(S, device=dev).clamp(
        max=params["pos_emb"].shape[0] - 1)[None, :]
    tt = (torch.zeros_like(ids) if token_type_ids is None else
          token_type_ids.long().clamp(0, params["type_emb"].shape[0] - 1))
    x = params["tok_emb"][ids] + params["pos_emb"][pos] + \
        params["type_emb"][tt]
    x = _ln(x, params["emb_ln"]).to(dtype)

    add_mask = None
    if attention_mask is not None:
        add_mask = (1.0 - attention_mask[:, None, None, :].float()) * -1e9

    attention_fn = None
    if sparsity_config is not None:
        from deepspeed_tpu_torch.ops.sparse_attention import \
            SparseSelfAttention
        # 'mul' mode: the (B, S) mask is 1 = keep / 0 = pad, so its zeros
        # become NEG_INF ('add' would add the raw 1/0 values)
        sparse_attn = SparseSelfAttention(sparsity_config,
                                          key_padding_mask_mode="mul")

        def attention_fn(q, k, v, _add_mask):
            return sparse_attn(q, k, v, key_padding_mask=attention_mask)

    def layer(lp, x, layer_seed):
        return transformer_layer_forward(lp, lcfg, x, add_mask, layer_seed,
                                         deterministic,
                                         attention_fn=attention_fn)

    for i in range(_num_layers(params)):
        layer_seed = None if seed is None else fold_seed(seed, i)
        if remat:
            x = checkpoint(layer, _layer(params, i), x, layer_seed,
                           use_reentrant=False)
        else:
            x = layer(_layer(params, i), x, layer_seed)
    return x


def bert_mlm_loss_fn(config: BertConfig, dtype=torch.bfloat16,
                     remat: bool = False, deterministic: bool = False,
                     sparsity_config=None):
    """Engine-contract MLM loss. batch: ``input_ids`` (B, S), ``labels``
    (B, S) with -100 = not masked (ignored), optional ``attention_mask``
    and ``token_type_ids`` (B, S); ``seed``: the step's int32 dropout
    seed; ``sparsity_config``: block-sparse core attention, as in
    :func:`bert_encoder`."""
    def loss_fn(params, batch, seed=None):
        x = bert_encoder(params, config, batch["input_ids"],
                         attention_mask=batch.get("attention_mask"),
                         token_type_ids=batch.get("token_type_ids"),
                         seed=seed, deterministic=deterministic,
                         dtype=dtype, remat=remat,
                         sparsity_config=sparsity_config)
        # MLM head: dense + GELU + LN, then decode against the tied
        # embeddings with bf16 operands and fp32 sums
        mh = x @ params["mlm_dense"]["w"].to(dtype) + \
            params["mlm_dense"]["b"].to(dtype)
        mh = _ln(F.gelu(mh), params["mlm_ln"])
        logits = matmul_bf16_accum_fp32(mh, params["tok_emb"]) + \
            params["mlm_bias"]
        labels = batch["labels"].long()
        mask = labels != -100
        logp = torch.log_softmax(logits, dim=-1)
        ll = logp.gather(-1, torch.where(mask, labels, 0)[..., None])[..., 0]
        denom = torch.clamp(mask.sum(), min=1)
        return -torch.where(mask, ll, 0.0).sum() / denom
    return loss_fn
