"""GPT-2 (the port of ``deepspeed_tpu/models/gpt2.py``): the training
forward and loss, and the cached, paged serving path.

Parameters are a plain dict with the JAX package's tree layout:
``wte``, ``wpe``, ``ln_f`` and one ``h_{i}`` dict per block, each leaf a
``torch.Tensor`` with the JAX leaf's shape (weights are ``(in, out)``,
so a projection is ``x @ w + b`` in both packages). :func:`params_from_jax`
carries a JAX tree across through numpy, under either JAX layout.

Training: :func:`gpt2_loss_fn` is the engine's loss contract
``loss_fn(params, batch, seed)``; the trunk runs causal
:func:`~deepspeed_tpu_torch.ops.attention.flash.flash_attention` (the
masked-flash kernels K1-K3) with the hash dropouts, and the tied LM head
and cross entropy run chunk by chunk, each chunk recomputed in the
backward. As in the JAX model, matmul weights are cast to the compute
dtype at their use site; the engine hands the loss its compute-dtype
copy of the fp32 masters, as the JAX engine does.

Serving: one token of decode or a padded prompt of prefill, with K/V
written into the paged pool or the dense slot cache and attention read
back from it. Under int8-resident weights (``QuantizedParam`` leaves,
``runtime/quantized_params.py``) every weight use dequantizes per block
(:func:`_wd`, :func:`_emb_rows`), inside the serving program.

Generation: :func:`gpt2_generate` prefills the prompt through causal
flash attention (K1 on the card), capturing each layer's K/V into a
dense cache, then decodes one token a step in a Python loop over the
dense cached attention (the JAX package's ``lax.scan``).
"""

import math
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.ops.attention.flash import flash_attention
from deepspeed_tpu_torch.ops.attention.paged import (NEG_INF,
                                                     dequantize_pool,
                                                     paged_decode_attention,
                                                     quantize_kv)
from deepspeed_tpu_torch.ops.functional import (dropout, fold_seed,
                                                ieee_fp32_matmul, layer_norm)
from deepspeed_tpu_torch.runtime.quantized_params import (QuantizedParam,
                                                          dequantize_param)
from deepspeed_tpu_torch.utils.tree import tree_leaves, tree_map

__all__ = ["GPT2Config", "GPT2_SMALL", "GPT2_MEDIUM", "GPT2_LARGE",
           "GPT2_XL", "init_gpt2_params", "params_from_jax",
           "trainable_params_from_jax", "count_params", "gpt2_block",
           "gpt2_forward", "gpt2_loss_fn", "causal_cache_mask",
           "write_kv_cache", "write_paged_kv_cache", "gather_paged_kv",
           "paged_decode_ctx", "make_token_sampler", "run_decode_scan",
           "gpt2_generate"]


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
                     generator: Optional[torch.Generator],
                     device=None) -> Dict[str, Any]:
    """Random fp32 parameters with the JAX init's distributions (normal
    weights at ``initializer_range``, output projections scaled by
    ``1/sqrt(2 * num_layers)``, zero biases, unit LayerNorm gains), on
    the generator's device. The numbers differ from ``jax.random``'s;
    use :func:`params_from_jax` for the same weights in both packages.
    ``device="meta"`` (``generator`` None) gives the tree's shapes and
    dtypes without memory: a checkpoint loader's template."""
    h, inter = config.hidden_size, config.inter
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


def params_from_jax(tree) -> Dict[str, Any]:
    """Torch parameters from a JAX GPT-2 param tree whose leaves are
    numpy arrays (``np.asarray`` of each JAX leaf). Reads both JAX
    layouts — one ``h_{i}`` dict per block, or the ``scan_layers``
    stack ``h`` with a leading layer dim — and returns the ``h_{i}``
    layout. Values and dtypes are kept as they are."""
    def leaf(a):
        return torch.from_numpy(np.array(a, copy=True))

    out = {k: tree_map(leaf, v) for k, v in tree.items() if k != "h"}
    if "h" in tree:
        layers = next(tree_leaves(tree["h"])).shape[0]
        for i in range(layers):
            out[f"h_{i}"] = tree_map(lambda a, i=i: leaf(np.asarray(a)[i]),
                                     tree["h"])
    return out


def trainable_params_from_jax(tree, device) -> Dict[str, Any]:
    """:func:`params_from_jax` for training: fp32 leaf tensors on
    ``device`` with ``requires_grad``."""
    return tree_map(
        lambda t: t.to(device, torch.float32).requires_grad_(),
        params_from_jax(tree))


def count_params(params) -> int:
    return sum(int(t.numel()) for t in tree_leaves(params))


def _wd(leaf, dtype) -> torch.Tensor:
    """A weight at its use: an int8-resident leaf (``QuantizedParam``)
    dequantizes per block here, inside the program, so the resident copy
    stays int8; a dense leaf is cast."""
    if isinstance(leaf, QuantizedParam):
        return dequantize_param(leaf, dtype)
    return leaf.to(dtype)


def _emb_rows(leaf, ids: torch.Tensor, dtype) -> torch.Tensor:
    """Embedding rows of a dense or int8-resident table. A quantized
    table gathers its int8 rows and their per-block scales and
    dequantizes only those rows. Ids are clamped into the table, as a
    JAX gather clamps."""
    ids = ids.long().clamp(0, leaf.shape[0] - 1)
    if isinstance(leaf, QuantizedParam):
        q = leaf.q[ids]
        s = torch.repeat_interleave(leaf.scale[ids], leaf.block, dim=-1)
        return (q.float() * s[..., :q.shape[-1]]).to(dtype)
    return leaf[ids].to(dtype)


def gpt2_block(block_params, config: GPT2Config, x: torch.Tensor, dtype,
               attention_fn: Optional[Callable] = None,
               seed: Optional[int] = None,
               deterministic: bool = True) -> torch.Tensor:
    """One pre-LN transformer block.

    Default attention is causal :func:`flash_attention` (the masked
    kernels K1-K3), with the attention dropout inside the kernels and the
    residual dropouts outside when ``deterministic`` is False and a
    ``seed`` (this block's int32 seed) is given. ``attention_fn(q, k, v)``
    replaces it with an attention over (B, heads, S, hd) tensors: the
    serving paths pass the cache attentions of
    :func:`_paged_cache_attention` and :func:`_offset_cache_attention`.
    Weights go through :func:`_wd`, so int8-resident blocks dequantize
    at each use."""
    B, S, h = x.shape
    heads = config.num_heads
    hd = h // heads
    train = not deterministic and seed is not None
    a_in = layer_norm(x, block_params["ln_1"]["w"], block_params["ln_1"]["b"],
                      config.layer_norm_eps)
    ap = block_params["attn"]
    qkv = a_in @ _wd(ap["qkvw"], dtype) + _wd(ap["qkvb"], dtype)
    q, k, v = qkv.split(h, dim=-1)
    q = q.reshape(B, S, heads, hd).transpose(1, 2)
    k = k.reshape(B, S, heads, hd).transpose(1, 2)
    v = v.reshape(B, S, heads, hd).transpose(1, 2)
    if attention_fn is not None:
        ctx = attention_fn(q, k, v)
    else:
        drop = config.attn_dropout if train else 0.0
        ctx = flash_attention(q, k, v, causal=True, dropout_rate=drop,
                              dropout_seed=fold_seed(seed, 1) if drop > 0.0
                              else None)
    ctx = ctx.transpose(1, 2).reshape(B, S, h)
    attn_out = ctx @ _wd(ap["ow"], dtype) + _wd(ap["ob"], dtype)
    x = x + dropout(attn_out, config.resid_dropout,
                    fold_seed(seed, 0) if train else None, deterministic)

    m_in = layer_norm(x, block_params["ln_2"]["w"], block_params["ln_2"]["b"],
                      config.layer_norm_eps)
    mp = block_params["mlp"]
    hmid = m_in @ _wd(mp["fc_w"], dtype) + _wd(mp["fc_b"], dtype)
    hmid = F.gelu(hmid, approximate="tanh")
    m_out = hmid @ _wd(mp["proj_w"], dtype) + _wd(mp["proj_b"], dtype)
    return x + dropout(m_out, config.resid_dropout,
                       fold_seed(seed, 2) if train else None, deterministic)


def _embed(wte, wpe, ids, dtype):
    """Token + position embedding, summed in the tables' dtype (in fp32
    over int8-resident tables), then cast. Ids are clamped into the
    table, as a JAX gather clamps."""
    pos = torch.arange(ids.shape[1], device=ids.device)[None, :]
    if isinstance(wte, QuantizedParam) or isinstance(wpe, QuantizedParam):
        return (_emb_rows(wte, ids, torch.float32)
                + _emb_rows(wpe, pos, torch.float32)).to(dtype)
    ids = ids.long().clamp(0, wte.shape[0] - 1)
    return (wte[ids] + wpe[pos]).to(dtype)


def _checkpointed(block: Callable) -> Callable:
    """``block`` under activation checkpointing: its activations are
    recomputed in the backward instead of kept (``jax.checkpoint`` in the
    JAX models). The blocks' dropouts hash a counter under an int seed,
    so the recompute draws the same keep masks."""
    from torch.utils.checkpoint import checkpoint

    def run(*args, **kwargs):
        return checkpoint(block, *args, use_reentrant=False, **kwargs)
    return run


def _gpt2_trunk(params, config: GPT2Config, input_ids,
                seed: Optional[int] = None, deterministic: bool = True,
                dtype=torch.bfloat16, remat: bool = False) -> torch.Tensor:
    """Final hidden states (B, S, hidden) after ln_f (no LM head).
    ``seed`` is the step's int32 dropout seed (None: no dropout);
    ``remat`` checkpoints each block (:func:`_checkpointed`)."""
    x = _embed(params["wte"], params["wpe"], input_ids, dtype)
    if seed is not None:
        x = dropout(x, config.embd_dropout, fold_seed(seed, 0),
                    deterministic)
    block = _checkpointed(gpt2_block) if remat else gpt2_block
    for i in range(config.num_layers):
        x = block(params[f"h_{i}"], config, x, dtype,
                  seed=None if seed is None else fold_seed(seed, i + 1),
                  deterministic=deterministic)
    return layer_norm(x, params["ln_f"]["w"], params["ln_f"]["b"],
                      config.layer_norm_eps)


class _TiedXentChunk(torch.autograd.Function):
    """Sum over one chunk of tokens of ``w * (logsumexp(logits) -
    logits[target])`` with ``logits = x @ wte.T`` in fp32 from the
    compute-dtype operands (products of two bf16 values are exact in
    fp32, so an fp32 matmul of the widened operands with TF32 off is the
    JAX head's bf16-operand, fp32-result product). The (chunk, vocab)
    logits are recomputed in the backward instead of kept."""

    @staticmethod
    def forward(ctx, xs, w, ts, ws):
        with ieee_fp32_matmul():
            logits = xs.float() @ w.float().t()
        lse = torch.logsumexp(logits, dim=-1)
        picked = logits.gather(1, ts[:, None])[:, 0]
        ctx.save_for_backward(xs, w, ts, ws)
        return ((lse - picked) * ws).sum()

    @staticmethod
    def backward(ctx, g):
        xs, w, ts, ws = ctx.saved_tensors
        wf = w.float()
        with ieee_fp32_matmul():
            dl = torch.softmax(xs.float() @ wf.t(), dim=-1)
            rows = torch.arange(dl.shape[0], device=dl.device)
            dl[rows, ts] -= 1.0
            dl = dl * (ws * g)[:, None]
            dx = (dl @ wf).to(xs.dtype)
            dw = (dl.t() @ xs.float()).to(w.dtype)
        return dx, dw, None, None


def _tied_xent_chunked(x, wte, targets, dtype, chunk_tokens: int = 2048,
                       mean: bool = True, weights=None):
    """Tied LM head + next-token cross entropy, chunked over tokens: no
    (B*S, vocab) fp32 logits tensor is ever whole, and each chunk's
    logits are recomputed in its backward. Short inputs are padded to a
    multiple of the chunk with zero-weight tokens, as in JAX."""
    B, S, H = x.shape
    n = B * S
    xf = x.reshape(n, H)
    tf = targets.reshape(n).long()
    c = min(chunk_tokens, n)
    pad = (-n) % c
    wf = (torch.ones((n,), dtype=torch.float32, device=x.device)
          if weights is None else weights.reshape(n).float())
    if pad:
        xf = torch.cat([xf, xf.new_zeros((pad, H))])
        tf = torch.cat([tf, tf.new_zeros((pad,))])
        wf = torch.cat([wf, wf.new_zeros((pad,))])
    wte_d = wte.to(dtype)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, n + pad, c):
        total = total + _TiedXentChunk.apply(
            xf[i:i + c], wte_d, tf[i:i + c], wf[i:i + c])
    return total / n if mean else total


def gpt2_loss_fn(config: GPT2Config, dtype=torch.bfloat16,
                 remat: bool = False, deterministic: bool = False):
    """Engine-contract loss: ``batch = {"input_ids": (B, S+1) int}``,
    next-token cross entropy on the shifted ids; ``seed`` is the step's
    int32 dropout seed (None: no dropout); ``remat`` checkpoints each
    block."""
    def loss_fn(params, batch, seed):
        ids = batch["input_ids"]
        inputs, targets = ids[:, :-1], ids[:, 1:]
        x = _gpt2_trunk(params, config, inputs, seed=seed,
                        deterministic=deterministic, dtype=dtype,
                        remat=remat)
        return _tied_xent_chunked(x, params["wte"], targets, dtype)
    return loss_fn


def tied_head_weight(wte, dtype) -> torch.Tensor:
    """The LM head's weight operand: ``wte`` rounded to ``dtype`` and
    held in fp32 (see :func:`_tied_logits`). A serving engine makes it
    once rather than casting the whole embedding at every step; over an
    int8-resident table it is made inside each program, from the
    dequantized table."""
    return _wd(wte, dtype).float()


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


def write_kv_cache(cache: torch.Tensor, new: torch.Tensor,
                   cache_position: torch.Tensor) -> torch.Tensor:
    """Write ``new`` (B, heads, S, hd) into the dense cache (B, heads,
    max_len, hd) IN PLACE, row b from ``cache_position[b]`` on (each
    serving slot at its own offset). The start is clamped so the S
    positions fit, as ``lax.dynamic_update_slice`` clamps it. Returns
    ``cache``."""
    B, _, S, _ = new.shape
    start = cache_position.long().clamp(0, cache.shape[2] - S)
    t = start[:, None] + torch.arange(S, device=cache.device)[None, :]
    rows = torch.arange(B, device=cache.device)[:, None]
    cache[rows, :, t] = new.to(cache.dtype).transpose(1, 2)
    return cache


def _attend_cache(q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                  cache_position: torch.Tensor) -> torch.Tensor:
    """The plain cached attention of every serving path but the kernel:
    q (B, H, S, hd) against a (B, kv_heads, L, hd) stripe, in fp32 under
    :func:`causal_cache_mask`, group-wise (q head h reads kv head h //
    G), cast back to q's dtype."""
    B, H, S, hd = q.shape
    KH, L = kc.shape[1], kc.shape[2]
    G = H // KH
    # fold each group into its kv head's rows, so K/V never expand to
    # the full head count
    qg = q.reshape(B, KH, G * S, hd).float()
    scores = (qg @ kc.float().transpose(-1, -2)) / math.sqrt(hd)
    mask = causal_cache_mask(cache_position, S, L)[:, :, None]
    scores = torch.where(mask, scores.reshape(B, KH, G, S, L), NEG_INF)
    probs = torch.softmax(scores, dim=-1).reshape(B, KH, G * S, L)
    return (probs @ vc.float()).reshape(B, H, S, hd).to(q.dtype)


def _offset_cache_attention(kcache: torch.Tensor, vcache: torch.Tensor,
                            cache_position: torch.Tensor):
    """attention_fn for the dense cached forward of both families
    (prefill into the cache and decode alike): write this call's K/V
    into the (B, kv_heads, max_len, hd) cache at each row's offset, in
    place, then attend every query to all cache slots <= its absolute
    position, reading the whole ``max_len`` row in fp32."""
    def attn(q, k, v):
        write_kv_cache(kcache, k, cache_position)
        write_kv_cache(vcache, v, cache_position)
        return _attend_cache(q, kcache, vcache, cache_position)
    return attn


def _cached_attention(kcache: torch.Tensor, vcache: torch.Tensor,
                      pos: int):
    """The one-position decode hook of :func:`gpt2_generate`: every row
    writes and attends at the same position ``pos``."""
    B = kcache.shape[0]
    return _offset_cache_attention(
        kcache, vcache, torch.full((B,), pos, dtype=torch.int32,
                                   device=kcache.device))


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


def paged_decode_ctx(q, kpool, vpool, block_table, cache_position,
                     k_scales=None, v_scales=None):
    """The seq-1 kernel dispatch both families share: run
    :func:`~deepspeed_tpu_torch.ops.attention.paged.paged_decode_attention`
    against the (already-written) pool and restore the (B, H, 1, hd)
    context layout. ``k_scales``/``v_scales`` select the int8 pool
    arity."""
    out = paged_decode_attention(q[:, :, 0].contiguous(), kpool, vpool,
                                 block_table, cache_position,
                                 k_scales=k_scales, v_scales=v_scales)
    return out[:, :, None, :]


def _paged_cache_attention(kpool, vpool, block_table, cache_position,
                           attn_kernel: str = "gather", kscale_pool=None,
                           vscale_pool=None):
    """attention_fn for the paged cached forward of both families:
    scatter this call's K/V into the kv_heads-sized pool (in place),
    then attend. Single-query calls with ``attn_kernel="kernel"`` run
    the paged-decode kernel straight against the pool (only live pages
    are read; the q heads of a GQA group share their kv head's pages);
    everything else gathers each row's stripe and attends group-wise in
    fp32 under :func:`causal_cache_mask` — the plain path, as in the JAX
    package.

    With ``kscale_pool``/``vscale_pool`` the pool is int8: this call's
    K/V are quantized per token row (``quantize_kv``), payload and
    scales land through the same block-table scatter, and every read
    dequantizes (inside the kernel, or after the gather). The gather
    path reads back what was just written, so a prefill over an int8
    pool attends the dequantized values, not this call's K/V."""
    quantized = kscale_pool is not None

    def attn(q, k, v):
        if quantized:
            nb = kscale_pool.shape[-1]
            k, k_s = quantize_kv(k, nb)
            v, v_s = quantize_kv(v, nb)
            write_paged_kv_cache(kscale_pool, k_s, block_table,
                                 cache_position)
            write_paged_kv_cache(vscale_pool, v_s, block_table,
                                 cache_position)
        write_paged_kv_cache(kpool, k, block_table, cache_position)
        write_paged_kv_cache(vpool, v, block_table, cache_position)
        if attn_kernel == "kernel" and q.shape[2] == 1:
            return paged_decode_ctx(q, kpool, vpool, block_table,
                                    cache_position, k_scales=kscale_pool,
                                    v_scales=vscale_pool)
        kc = gather_paged_kv(kpool, block_table)
        vc = gather_paged_kv(vpool, block_table)
        if quantized:
            kc = dequantize_pool(kc, gather_paged_kv(kscale_pool,
                                                     block_table))
            vc = dequantize_pool(vc, gather_paged_kv(vscale_pool,
                                                     block_table))
        return _attend_cache(q, kc, vc, cache_position)
    return attn


def _gpt2_trunk_cached(params, config: GPT2Config, input_ids, kv_cache,
                       cache_position, dtype, block_tables,
                       paged_attn_kernel: str = "gather") -> torch.Tensor:
    """Run ``input_ids`` (B, S) through every block with attention over
    ``kv_cache``: with ``block_tables``, the paged pools ``(kc, vc)``,
    each (layers, num_pages, heads, page_size, hd), or the int8 pool's
    ``(kc, vc, kscale, vscale)``; without, the dense slot cache ``(kc,
    vc)``, each (layers, B, heads, max_len, hd). This call's K/V are
    written at each row's ``cache_position`` offset in place. Returns the
    hidden states after ``ln_f``. Serves prefill (S = padded prompt) and
    decode (S = 1) with one code path."""
    B, S = input_ids.shape
    dev = input_ids.device
    pos = cache_position.long()[:, None] + torch.arange(S, device=dev)[None, :]
    x = (_emb_rows(params["wte"], input_ids, torch.float32)
         + _emb_rows(params["wpe"], pos, torch.float32)).to(dtype)
    for i in range(config.num_layers):
        kc, vc, *scales = (c[i] for c in kv_cache)
        if block_tables is None:
            attn = _offset_cache_attention(kc, vc, cache_position)
        else:
            attn = _paged_cache_attention(kc, vc, block_tables,
                                          cache_position, paged_attn_kernel,
                                          *scales)
        x = gpt2_block(params[f"h_{i}"], config, x, dtype, attention_fn=attn)
    return layer_norm(x, params["ln_f"]["w"], params["ln_f"]["b"],
                      config.layer_norm_eps)


def gpt2_forward(params, config: GPT2Config, input_ids, dtype=torch.bfloat16,
                 kv_cache=None, cache_position=None, block_tables=None,
                 paged_attn_kernel: str = "gather",
                 seed: Optional[int] = None, deterministic: bool = True):
    """Logits (B, S, vocab) in fp32; the LM head is tied to ``wte``.

    Without ``kv_cache`` this is the training forward (causal flash
    attention, dropouts under ``seed`` unless ``deterministic``).
    Serving: ``kv_cache`` is the paged pool tree, ``(kc, vc)`` or the
    int8 pool's ``(kc, vc, kscale, vscale)``, or without
    ``block_tables`` the dense slot cache ``(kc, vc)``, updated in place
    (the same tensors come back with the logits);
    ``cache_position`` ((B,) int) is each row's first query position;
    ``block_tables`` ((B, pages_per_seq) int) maps logical pages to pool
    pages; ``paged_attn_kernel`` is ``"kernel"`` (the paged-decode kernel
    for seq-1 queries) or ``"gather"`` (the plain stripe path)."""
    if kv_cache is None:
        x = _gpt2_trunk(params, config, input_ids, seed=seed,
                        deterministic=deterministic, dtype=dtype)
        with ieee_fp32_matmul():
            return _tied_logits(x, tied_head_weight(params["wte"], dtype),
                                dtype)
    if cache_position is None:
        cache_position = torch.zeros((input_ids.shape[0],), dtype=torch.int32,
                                     device=input_ids.device)
    x = _gpt2_trunk_cached(params, config, input_ids, kv_cache,
                           cache_position, dtype, block_tables,
                           paged_attn_kernel)
    return _tied_logits(x, tied_head_weight(params["wte"], dtype),
                        dtype), kv_cache


def make_token_sampler(vocab_size: int, temperature: float, top_k: int,
                       greedy: bool):
    """The decode-step sampler of :func:`gpt2_generate` and
    ``llama_generate``: ``sample(logits, generator)`` takes the argmax
    (first index on ties), or samples ``softmax(logits / temperature)``
    restricted to the ``top_k`` largest (all when 0) with
    ``torch.multinomial`` from ``generator``. The draws are the port's
    own, reproducible for one generator state, not ``jax.random``'s."""
    eff_k = min(top_k, vocab_size)

    def sample(logits: torch.Tensor, generator) -> torch.Tensor:
        if greedy:
            return logits.argmax(dim=-1).to(torch.int32)
        t = logits.float() / max(temperature, 1e-6)
        if eff_k > 0:
            kth = torch.topk(t, eff_k, dim=-1).values[:, -1:]
            t = torch.where(t < kth, NEG_INF, t)
        return torch.multinomial(torch.softmax(t, dim=-1), 1,
                                 generator=generator)[:, 0].to(torch.int32)
    return sample


def run_decode_scan(step_logits: Callable, sample: Callable, first_tok,
                    caches, max_new_tokens: int, generator):
    """The decode loop of both generate functions:
    ``step_logits(tok, t, caches) -> (logits, caches)`` for t in
    ``range(max_new_tokens - 1)`` (``first_tok`` was sampled from the
    prefill's logits), each step's token sampled from ``generator``.
    Returns (B, max_new_tokens) int32."""
    toks = []
    tok = first_tok
    for t in range(max_new_tokens - 1):
        logits, caches = step_logits(tok, t, caches)
        toks.append(tok)
        tok = sample(logits, generator)
    return torch.stack(toks + [tok], dim=1)


def _generator_for(generator, device):
    """``generator`` as a ``torch.Generator`` on ``device``: an int is a
    seed."""
    if generator is None or isinstance(generator, torch.Generator):
        return generator
    return torch.Generator(device=device).manual_seed(int(generator))


def _generate_blocks(params, num_layers: int, dtype):
    """Each block's params with the matmul leaves cast to ``dtype`` once
    for the whole call: the operands every step would cast again."""
    from deepspeed_tpu_torch.models.llama import layer_params
    out = []
    for i in range(num_layers):
        lp = layer_params(params, i)
        out.append({k: ({n: _wd(w, dtype) for n, w in v.items()}
                        if k in ("attn", "mlp") else v)
                    for k, v in lp.items()})
    return out


def gpt2_generate(params, config: GPT2Config, prompt_ids: torch.Tensor,
                  max_new_tokens: int, generator=None,
                  temperature: float = 1.0, top_k: int = 0,
                  dtype=torch.bfloat16) -> torch.Tensor:
    """Autoregressive sampling with a dense KV cache, on the device of
    ``prompt_ids`` (B, P) int. Returns (B, P + max_new_tokens) int32.

    ``temperature=0`` or ``generator=None`` decodes greedily; else
    ``generator`` (a ``torch.Generator`` on that device, or an int seed)
    draws the samples, restricted to the ``top_k`` most likely tokens
    when ``top_k > 0``. The prefill is one forward over the prompt with
    causal :func:`flash_attention` (K1 on the card: one launch per
    layer), its K/V captured into the cache; each decoded token is one
    forward through the same :func:`gpt2_block` over the dense cached
    attention. Dense GPT-2 family only."""
    B, P = prompt_ids.shape
    if max_new_tokens <= 0:
        return prompt_ids
    L = P + max_new_tokens
    if L > config.max_position_embeddings:
        raise ValueError(f"prompt + new tokens ({L}) exceed "
                         f"max_position_embeddings "
                         f"({config.max_position_embeddings})")
    nl = config.num_layers
    for i in range(nl):
        mlp = params["h"]["mlp"] if "h" in params else \
            params[f"h_{i}"]["mlp"]
        if "fc_w" not in mlp:
            raise ValueError(
                "gpt2_generate supports the dense GPT-2 family only; "
                f"block h_{i} carries MoE expert params")
    heads = config.num_heads
    hd = config.hidden_size // heads
    greedy = generator is None or temperature == 0.0
    dev = prompt_ids.device
    generator = _generator_for(generator, dev)
    sample = make_token_sampler(config.vocab_size, temperature, top_k,
                                greedy)
    with torch.no_grad():
        blocks = _generate_blocks(params, nl, dtype)
        head_w = tied_head_weight(params["wte"], dtype)
        # prefill: one forward over the prompt, the attention hook
        # capturing each layer's K/V into the cache
        x = _embed(params["wte"], params["wpe"], prompt_ids, dtype)
        kc = torch.zeros((nl, B, heads, L, hd), dtype=dtype, device=dev)
        vc = torch.zeros_like(kc)
        for i in range(nl):
            def capture(q, k, v, i=i):
                kc[i, :, :, :P] = k
                vc[i, :, :, :P] = v
                return flash_attention(q, k, v, causal=True)
            x = gpt2_block(blocks[i], config, x, dtype,
                           attention_fn=capture)
        x = layer_norm(x, params["ln_f"]["w"], params["ln_f"]["b"],
                       config.layer_norm_eps)
        first_tok = sample(_tied_logits(x[:, -1], head_w, dtype), generator)

        def step_logits(tok, t, caches):
            kc, vc = caches
            pos = P + t                   # position of `tok` in the stream
            x = (params["wte"][tok.long()[:, None]]
                 + params["wpe"][pos][None, None]).to(dtype)
            for i in range(nl):
                x = gpt2_block(blocks[i], config, x, dtype,
                               attention_fn=_cached_attention(
                                   kc[i], vc[i], pos))
            x = layer_norm(x, params["ln_f"]["w"], params["ln_f"]["b"],
                           config.layer_norm_eps)
            return _tied_logits(x[:, 0], head_w, dtype), caches

        gen = run_decode_scan(step_logits, sample, first_tok, (kc, vc),
                              max_new_tokens, generator)
    return torch.cat([prompt_ids.to(torch.int32), gen], dim=1)
