"""Sparse self-attention modules (the port of
``deepspeed_tpu/ops/sparse_attention/sparse_self_attention.py``).

- :class:`SparseSelfAttention`: block-sparse attention with a
  SparsityConfig-driven layout, cached per (config, sequence length);
- :class:`BertSparseSelfAttention`: the BERT self-attention block with a
  sparse core, an ``nn.Module`` holding the query, key and value
  projections (from ``generator`` or a JAX parameter tree);
- :class:`SparseAttentionUtils`: position-table extension, padding to
  the block size, and the BERT encoder with sparse core attention.

The core runs ``blocksparse.block_sparse_attention``: the masked flash
kernels K1-K3, or with an ``attn_mask`` the row-run kernels K8-K10, on
CUDA tensors; their plain versions on CPU tensors.
"""

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.ops.sparse_attention.blocksparse import (
    block_sparse_attention)
from deepspeed_tpu_torch.ops.sparse_attention.sparsity_config import (
    FixedSparsityConfig, SparsityConfig)

__all__ = ["SparseSelfAttention", "BertSparseSelfAttention",
           "init_bert_sparse_self_attention_params", "SparseAttentionUtils"]


class SparseSelfAttention:
    """Applies block-sparse attention with a SparsityConfig-driven layout.

    forward(query, key, value, rpe=None, key_padding_mask=None,
    attn_mask=None) with q/k/v of shape (B, H, S, D), key_padding_mask
    (B, S), attn_mask (S, S); scaling = head_dim ** -0.5 and the add/mul
    mask modes of the reference."""

    _layout_cache: Dict[Any, np.ndarray] = {}

    def __init__(self, sparsity_config: Optional[SparsityConfig] = None,
                 key_padding_mask_mode: str = "add",
                 attn_mask_mode: str = "mul"):
        self.sparsity_config = sparsity_config or FixedSparsityConfig(
            num_heads=4)
        self.key_padding_mask_mode = key_padding_mask_mode
        self.attn_mask_mode = attn_mask_mode

    def get_layout(self, seq_len: int) -> np.ndarray:
        key = self.sparsity_config.layout_cache_key() + (seq_len,)
        if key not in SparseSelfAttention._layout_cache:
            SparseSelfAttention._layout_cache[key] = \
                self.sparsity_config.make_layout(seq_len)
        return SparseSelfAttention._layout_cache[key]

    def __call__(self, query, key, value, rpe=None, key_padding_mask=None,
                 attn_mask=None, **kw):
        B, H, S, D = query.shape
        if query.shape != key.shape or key.shape != value.shape:
            raise NotImplementedError(
                "only self-attention (q/k/v same shape) is supported")
        return block_sparse_attention(
            query, key, value, self.get_layout(S),
            sm_scale=float(D) ** -0.5,
            key_padding_mask=key_padding_mask,
            key_padding_mask_mode=self.key_padding_mask_mode,
            attn_mask=attn_mask, attn_mask_mode=self.attn_mask_mode,
            rpe=rpe, **kw)

    forward = __call__


def init_bert_sparse_self_attention_params(
        hidden_size: int, generator: torch.Generator,
        initializer_range: float = 0.02) -> Dict[str, Any]:
    """Query, key and value projections ``{"w": (hidden, hidden), "b":
    (hidden,)}`` in fp32 on the generator's device (``x @ w + b``), with
    the JAX init's distributions; the numbers differ from
    ``jax.random``'s."""
    dev = generator.device

    def lin():
        return {"w": torch.randn((hidden_size, hidden_size),
                                 generator=generator, device=dev,
                                 dtype=torch.float32) * initializer_range,
                "b": torch.zeros((hidden_size,), dtype=torch.float32,
                                 device=dev)}
    return {"query": lin(), "key": lin(), "value": lin()}


class BertSparseSelfAttention(torch.nn.Module):
    """BERT-style self-attention block with a sparse core. ``config``
    needs hidden_size and num_attention_heads (or num_heads, as in
    ``BertConfig``). The projections are ``nn.Parameter``s named
    ``query.w``, ``query.b``, ``key.w``, ... from ``initial_params`` (a
    JAX tree as numpy arrays, or tensors) or
    :func:`init_bert_sparse_self_attention_params` with ``generator``
    (default: seeded 0)."""

    def __init__(self, config,
                 sparsity_config: Optional[SparsityConfig] = None,
                 generator: Optional[torch.Generator] = None,
                 initial_params: Optional[Dict[str, Any]] = None):
        super().__init__()
        hidden = config.hidden_size
        heads = getattr(config, "num_attention_heads",
                        getattr(config, "num_heads", None))
        if heads is None:
            raise ValueError(
                "config must define num_attention_heads (or num_heads)")
        if hidden % heads != 0:
            raise ValueError(
                f"hidden size {hidden} not a multiple of heads {heads}")
        self.num_attention_heads = heads
        self.attention_head_size = hidden // heads
        self.hidden_size = hidden
        self.sparse_self_attention = SparseSelfAttention(
            sparsity_config or FixedSparsityConfig(num_heads=heads))
        if initial_params is None:
            initial_params = init_bert_sparse_self_attention_params(
                hidden, generator or torch.Generator().manual_seed(0),
                getattr(config, "initializer_range", 0.02))
        for name in ("query", "key", "value"):
            self.add_module(name, torch.nn.ParameterDict({
                p: torch.nn.Parameter(torch.as_tensor(
                    np.array(t) if not isinstance(t, torch.Tensor)
                    else t).detach().to(torch.float32).clone())
                for p, t in initial_params[name].items()}))

    def _split_heads(self, x):
        B, S, _ = x.shape
        return x.reshape(B, S, self.num_attention_heads,
                         self.attention_head_size).transpose(1, 2)

    def forward(self, hidden_states, attention_mask=None):
        """hidden_states (B, S, hidden); attention_mask (B, S) key
        padding in the core's ``key_padding_mask_mode`` (default 'add').
        Returns (B, S, hidden) in hidden_states' dtype."""
        dtype = hidden_states.dtype

        def proj(p):
            return hidden_states @ p["w"].to(dtype) + p["b"].to(dtype)
        q = self._split_heads(proj(self.query))
        k = self._split_heads(proj(self.key))
        v = self._split_heads(proj(self.value))
        ctx = self.sparse_self_attention(q, k, v,
                                         key_padding_mask=attention_mask)
        B, H, S, D = ctx.shape
        return ctx.transpose(1, 2).reshape(B, S, H * D)


class SparseAttentionUtils:
    """Helpers to adapt models and inputs to block-sparse attention,
    on the functional parameter dicts of ``models/bert.py``."""

    @staticmethod
    def extend_position_embedding(params: Dict[str, Any],
                                  max_position: int) -> Dict[str, Any]:
        """A new dict whose ``pos_emb`` (P, H) is tiled up to
        ``max_position`` rows."""
        pos = params["pos_emb"]
        original = pos.shape[0]
        if max_position <= original:
            raise ValueError(
                f"max_position {max_position} must exceed current table "
                f"size {original}")
        reps = -(-max_position // original)
        out = dict(params)
        out["pos_emb"] = pos.detach().repeat(reps, 1)[:max_position]
        return out

    @staticmethod
    def update_tokenizer_model_max_length(tokenizer, max_position: int):
        """Bump a (HF-style) tokenizer's max length to the extended
        position-table size."""
        tokenizer.model_max_length = max_position
        if hasattr(tokenizer, "init_kwargs"):
            tokenizer.init_kwargs["model_max_length"] = max_position
        return tokenizer

    @staticmethod
    def replace_model_self_attention_with_sparse_self_attention(
            params, config, max_position: Optional[int] = None,
            sparsity_config=None):
        """Returns ``(params, config, encoder_fn)`` where
        ``encoder_fn(params, input_ids, **kw)`` runs the BERT encoder with
        block-sparse core attention, reusing the dense QKV and output
        projections unchanged. With ``max_position`` past the config's
        table, the position table is extended first and the config says
        so."""
        from deepspeed_tpu_torch.models.bert import bert_encoder
        if sparsity_config is None:
            sparsity_config = FixedSparsityConfig(
                num_heads=getattr(config, "num_heads", 4))
        if max_position is not None and \
                max_position > config.max_position_embeddings:
            params = SparseAttentionUtils.extend_position_embedding(
                params, max_position)
            config = config._replace(max_position_embeddings=max_position)
        cfg = config

        def encoder_fn(params, input_ids, **kw):
            return bert_encoder(params, cfg, input_ids,
                                sparsity_config=sparsity_config, **kw)

        return params, config, encoder_fn

    # the reference's per-layer name: with a pluggable attention_fn the
    # per-layer and whole-model operations coincide
    replace_self_attention_layer_with_sparse_self_attention_layer = \
        replace_model_self_attention_with_sparse_self_attention

    @staticmethod
    def pad_to_block_size(block_size: int, input_ids, pad_token_id: int,
                          attention_mask=None, token_type_ids=None,
                          position_ids=None, labels=None,
                          label_pad: int = -100):
        """Right-pad sequence inputs so seq_len % block_size == 0.
        Returns (pad_len, padded tensors with None passed through)."""
        B, S = input_ids.shape
        pad_len = (-S) % block_size
        if pad_len == 0:
            return 0, input_ids, attention_mask, token_type_ids, \
                position_ids, labels

        def pad(x, value):
            if x is None:
                return None
            return F.pad(x, (0, pad_len), value=value)

        input_ids = pad(input_ids, pad_token_id)
        attention_mask = pad(attention_mask, 0)
        token_type_ids = pad(token_type_ids, 0)
        labels = pad(labels, label_pad)
        if position_ids is not None:
            position_ids = torch.cat(
                [position_ids,
                 position_ids[:, -1:].expand(B, pad_len)], dim=1)
        return pad_len, input_ids, attention_mask, token_type_ids, \
            position_ids, labels

    @staticmethod
    def unpad_sequence_output(pad_len: int, sequence_output):
        """Strip pad_to_block_size padding from the model output."""
        if pad_len == 0:
            return sequence_output
        return sequence_output[:, :-pad_len]
