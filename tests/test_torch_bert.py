"""The port's BERT path (deepspeed_tpu_torch/models/bert.py, the DeepSpeed
transformer layer in ops/transformer/transformer.py, and
matmul_bf16_accum_fp32 and the exact GELU of ops/functional.py) against
the JAX package on the CPU, at a tiny BERT (2 layers, hidden 32, 2 heads
of 16, FF 64, seq 32) with a padded batch.

The same parameters (made by the JAX init from a seed and carried across
through numpy) and the same numpy inputs go through both. The JAX side's
attention runs its Pallas kernels in interpret mode, with BERT's mask in
their key-mask arity; the port's runs the kernels' plain versions.
Tolerances:

- the layer, fp32: outputs atol 2e-5 (as tests/unit/test_transformer.py
  holds JAX's flash path to its einsum path), grads within 1e-4 of each
  grad's largest entry;
- the MLM loss, fp32: loss rtol 1e-5, grads within 1e-4 of each grad's
  largest entry; bf16 compute over fp32 masters: loss rtol 2e-3, and each
  grad within a relative RMS error of 2e-2, a bias grad within 5e-2: JAX's
  autodiff sums a bias grad (the transpose of the bias's broadcast) over
  the B*S rows in bf16, torch in fp32, and the v part of ``qkvb``, a sum
  with much cancellation, lands up to 3.3% apart;
- the exact GELU: 1e-6 in fp32; in bf16 the port rounds the fp32 GELU of
  the bf16 input once (bitwise), while JAX evaluates it in bf16 steps, so
  the two may differ by 2**-7 |x|;
- matmul_bf16_accum_fp32: rtol 1e-6 (the same exact products of bf16
  values, summed in fp32 in another order).

Dropout cannot draw the same masks on both sides (the JAX model splits
``jax.random`` keys per layer and per site), so the parity runs are
deterministic and the dropout path gets a seeded-determinism test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_threads  # noqa: F401  (torch threads per xdist worker)

S, B = 32, 2
TINY = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=2,
            intermediate_size=64, max_position_embeddings=S)
FP32_ATOL = 2e-5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree):
    from deepspeed_tpu_torch.utils.tree import tree_leaves
    return list(tree_leaves(tree))


def _assert_grads_close(got, want, tol):
    """Each grad within ``tol`` of its largest entry."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) <= tol * scale


BIAS_LEAVES = ("qkvb", "ob", "inter_b", "output_b", "attn_nb", "norm_b",
               "mlm_bias", "['b']")


def _assert_grads_rms(got, want_tree, tol, bias_tol):
    """Each grad within a relative RMS error of ``tol``, bias grads of
    ``bias_tol``."""
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(want_tree)[0]]
    want = jax.tree_util.tree_leaves(want_tree)
    assert len(got) == len(want)
    for path, g, w in zip(paths, got, want):
        w = np.asarray(w, np.float32)
        err = np.linalg.norm(g - w) / max(float(np.linalg.norm(w)), 1e-30)
        bias = any(path.endswith(f"{b}']") or path.endswith(b)
                   for b in BIAS_LEAVES)
        assert err <= (bias_tol if bias else tol), (path, err)


def _bert_mask(rng, lengths=(20, S)):
    """(B, S) attention mask with 1 = keep: row 0 padded from a length
    that starts inside a walk tile."""
    return (np.arange(S)[None, :] < np.asarray(lengths)[:, None]).astype(
        np.int32)


# ------------------------------------------------------------------ layer
def _layer_cfgs(pre_ln, **knobs):
    from deepspeed_tpu.ops.transformer.transformer import \
        DeepSpeedTransformerConfig as JCfg

    from deepspeed_tpu_torch.ops.transformer.transformer import \
        DeepSpeedTransformerConfig as TCfg
    kw = dict(batch_size=B, max_seq_length=S, hidden_size=32,
              intermediate_size=64, heads=2, attn_dropout_ratio=0.1,
              hidden_dropout_ratio=0.1, num_hidden_layers=2,
              initializer_range=0.02, pre_layer_norm=pre_ln, bf16=False,
              training=True, **knobs)
    return JCfg(**kw), TCfg(**kw)


def _layer_case(pre_ln, masked, seed=0, **knobs):
    from deepspeed_tpu.ops.transformer.transformer import \
        init_transformer_params
    jcfg, tcfg = _layer_cfgs(pre_ln, **knobs)
    params = _np(init_transformer_params(jcfg, jax.random.PRNGKey(seed), 0))
    rng = np.random.RandomState(seed)
    x = rng.randn(B, S, 32).astype(np.float32)
    mask = None
    if masked:
        mask = ((1.0 - _bert_mask(rng)[:, None, None, :]) * -1e9).astype(
            np.float32)
    return jcfg, tcfg, params, x, mask


def _port_layer(tcfg, params, x, mask, use_flash=True, seed=None,
                deterministic=True):
    from deepspeed_tpu_torch.ops.transformer.transformer import \
        transformer_layer_forward
    tp = {k: torch.from_numpy(v.copy()).requires_grad_()
          for k, v in params.items()}
    tx = torch.from_numpy(x).requires_grad_()
    out = transformer_layer_forward(
        tp, tcfg, tx, None if mask is None else torch.from_numpy(mask),
        seed=seed, deterministic=deterministic, use_flash=use_flash)
    keys = sorted(tp)
    grads = torch.autograd.grad(out, [tp[k] for k in keys] + [tx],
                                torch.from_numpy(_cotangent(x)))
    return out.detach().numpy(), [g.numpy() for g in grads]


def _cotangent(x):
    """A fixed random output cotangent (sum(out**2) would be flat through
    a post-LN layer's final LayerNorm, leaving its grads rounding
    noise)."""
    return np.random.RandomState(99).randn(*x.shape).astype(np.float32)


@pytest.mark.parametrize("use_flash", [True, False])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("pre_ln", [True, False])
def test_transformer_layer_matches_jax(pre_ln, masked, use_flash):
    """Pre-LN and post-LN, with and without BERT's padding mask, through
    flash_attention (the masked-flash kernels' plain versions, the mask
    in their key-mask arity) and through the einsum path: the output and
    its vjp with a random cotangent w.r.t. every parameter and the
    input."""
    from deepspeed_tpu.ops.transformer.transformer import \
        transformer_layer_forward as jfwd
    jcfg, tcfg, params, x, mask = _layer_case(pre_ln, masked)
    jm = None if mask is None else jnp.asarray(mask)
    jout, vjp = jax.vjp(
        lambda p, xx: jfwd(p, jcfg, xx, jm, deterministic=True,
                           use_flash=use_flash),
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(_cotangent(x)))
    out, grads = _port_layer(tcfg, params, x, mask, use_flash=use_flash)
    np.testing.assert_allclose(out, np.asarray(jout), atol=FP32_ATOL, rtol=0)
    _assert_grads_close(grads, [jgp[k] for k in sorted(params)] + [jgx],
                        1e-4)


@pytest.mark.parametrize("knob", ["attn_dropout_checkpoint",
                                  "gelu_checkpoint", "normalize_invertible"])
@pytest.mark.parametrize("pre_ln", [True, False])
def test_recompute_knobs_keep_the_numbers(pre_ln, knob):
    """Each recompute knob (torch.utils.checkpoint over its segment)
    changes what is saved, not the numbers: output and grads bitwise
    equal to the knob off, with the padding mask and with dropout on
    (the hash masks regenerate in the recompute), and the knob-on
    deterministic layer against JAX's with the same knob."""
    from deepspeed_tpu.ops.transformer.transformer import \
        transformer_layer_forward as jfwd
    _, base, params, x, mask = _layer_case(pre_ln, True, seed=3)
    jcfg, tcfg, *_ = _layer_case(pre_ln, True, seed=3, **{knob: True})
    for seed in (None, 11):
        want = _port_layer(base, params, x, mask, seed=seed,
                           deterministic=seed is None)
        got = _port_layer(tcfg, params, x, mask, seed=seed,
                          deterministic=seed is None)
        for a, b in zip([got[0], *got[1]], [want[0], *want[1]]):
            np.testing.assert_array_equal(a, b)
    jout = jfwd(jax.tree_util.tree_map(jnp.asarray, params), jcfg,
                jnp.asarray(x), jnp.asarray(mask), deterministic=True)
    np.testing.assert_allclose(_port_layer(tcfg, params, x, mask)[0],
                               np.asarray(jout), atol=FP32_ATOL, rtol=0)


def test_layer_dropout_is_seeded_and_module_facade():
    """With dropout on the output depends on the seed and only on it; a
    None seed turns dropout off. DeepSpeedTransformerLayer holds the 12
    parameters as nn.Parameters and calls the function."""
    from deepspeed_tpu_torch.ops.transformer.transformer import (
        DeepSpeedTransformerConfig, DeepSpeedTransformerLayer,
        transformer_layer_forward)
    _, tcfg, params, x, mask = _layer_case(True, True)
    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tx, tm = torch.from_numpy(x), torch.from_numpy(mask)
    with torch.no_grad():
        a, b, c = (transformer_layer_forward(tparams, tcfg, tx, tm, seed=s)
                   for s in (5, 5, 6))
        assert torch.equal(a, b) and not torch.equal(a, c)
        off = transformer_layer_forward(tparams, tcfg, tx, tm, seed=None)
        det = transformer_layer_forward(tparams, tcfg, tx, tm, seed=5,
                                        deterministic=True)
        assert torch.equal(off, det) and not torch.equal(off, a)
    layer = DeepSpeedTransformerLayer(tcfg, initial_params=params)
    assert sorted(n for n, _ in layer.named_parameters()) == sorted(params)
    with torch.no_grad():
        torch.testing.assert_close(layer(tx, tm, deterministic=True), off,
                                   rtol=0, atol=0)
    fresh = DeepSpeedTransformerLayer(tcfg)
    assert fresh.layer_id == layer.layer_id + 1
    assert {n: tuple(p.shape) for n, p in fresh.named_parameters()} == \
        {k: v.shape for k, v in params.items()}
    cfg = DeepSpeedTransformerConfig.from_dict(
        {"hidden_size": 16, "heads": 2, "bf16": False})
    assert cfg.intermediate_size == 64 and cfg.compute_dtype == torch.float32
    assert DeepSpeedTransformerConfig(fp16=True).compute_dtype == \
        torch.float16
    assert DeepSpeedTransformerConfig().compute_dtype == torch.bfloat16


def test_init_transformer_params_scaling():
    """Names and shapes of JAX's init; output projections scaled by
    1/sqrt(2 * num_hidden_layers) under adjust_init_range."""
    from deepspeed_tpu.ops.transformer.transformer import \
        init_transformer_params as jinit

    from deepspeed_tpu_torch.ops.transformer.transformer import \
        init_transformer_params
    jcfg, tcfg = _layer_cfgs(True)
    tcfg.hidden_size, tcfg.intermediate_size = 256, 512
    jp = jinit(jcfg, jax.random.PRNGKey(0))
    tp = init_transformer_params(tcfg, torch.Generator().manual_seed(0))
    assert sorted(tp) == sorted(jp)
    assert tp["ow"].shape == (256, 256) and tp["inter_w"].shape == (256, 512)
    assert tp["qkvw"].std().item() == pytest.approx(0.02, rel=0.02)
    assert tp["ow"].std().item() == pytest.approx(0.01, rel=0.02)
    assert float(tp["norm_w"].min()) == 1.0 and float(tp["qkvb"].abs().max()) \
        == 0.0


# --------------------------------------------------------------- functional
def test_exact_gelu_matches_jax():
    from torch.nn import functional as F
    x = np.random.RandomState(0).randn(4, 257).astype(np.float32) * 3
    want = np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=False))
    np.testing.assert_allclose(F.gelu(torch.from_numpy(x)).numpy(), want,
                               atol=1e-6, rtol=0)
    xb = torch.from_numpy(x).bfloat16()
    gb = F.gelu(xb)
    assert torch.equal(gb, F.gelu(xb.float()).bfloat16())
    wb = np.asarray(jax.nn.gelu(jnp.asarray(x).astype(jnp.bfloat16),
                                approximate=False).astype(jnp.float32))
    xf = xb.float().numpy()
    assert (np.abs(gb.float().numpy() - wb) <= 2.0 ** -7 * np.abs(xf)
            + 1e-6).all()


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_matmul_bf16_accum_fp32_matches_jax(dtype):
    """Forward and the custom backward: bf16-rounded operands, fp32 sums,
    fp32 result; dx in x's dtype, dw in w's."""
    from deepspeed_tpu.ops.functional import matmul_bf16_accum_fp32 as jmm

    from deepspeed_tpu_torch.ops.functional import matmul_bf16_accum_fp32
    rng = np.random.RandomState(1)
    x = rng.randn(3, 5, 48).astype(np.float32)
    w = rng.randn(70, 48).astype(np.float32)
    g = rng.randn(3, 5, 70).astype(np.float32)
    jd, td = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
              else (jnp.float32, torch.float32))
    jx, jw = jnp.asarray(x).astype(jd), jnp.asarray(w)
    jout, vjp = jax.vjp(jmm, jx, jw)
    jdx, jdw = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).to(td).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    out = matmul_bf16_accum_fp32(tx, tw)
    dx, dw = torch.autograd.grad(out, (tx, tw), torch.from_numpy(g))
    assert out.dtype == torch.float32 and dx.dtype == td and \
        dw.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(dx.float().numpy(),
                               np.asarray(jdx.astype(jnp.float32)),
                               rtol=2.0 ** -7 if dtype == "bf16" else 1e-6,
                               atol=1e-5)
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), rtol=1e-6,
                               atol=1e-5)


# --------------------------------------------------------------------- BERT
def _cfgs(pre_ln=True, scan=False, **kw):
    from deepspeed_tpu.models.bert import BertConfig as JCfg

    from deepspeed_tpu_torch.models.bert import BertConfig as TCfg
    d = dict(TINY, pre_layer_norm=pre_ln, scan_layers=scan, **kw)
    return JCfg(**d), TCfg(**d)


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, TINY["vocab_size"], (B, S)).astype(np.int32)
    am = _bert_mask(rng)
    labels = np.where((rng.rand(B, S) < 0.3) & (am == 1), ids,
                      -100).astype(np.int32)
    return {"input_ids": ids, "attention_mask": am, "labels": labels,
            "token_type_ids": (rng.rand(B, S) < 0.5).astype(np.int32)}


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("pre_ln", [True, False])
@pytest.mark.parametrize("scan", [False, True])
def test_mlm_loss_and_grads_match_jax(scan, pre_ln, dtype):
    """bert_mlm_loss_fn, deterministic, on a padded batch with token
    types, through the compute-dtype cast of fp32 masters, in both
    parameter layouts: the loss and every master grad against
    jax.value_and_grad; in fp32 also bert_encoder's output."""
    from deepspeed_tpu.models import bert as jb

    from deepspeed_tpu_torch.models import bert as tb
    from deepspeed_tpu_torch.utils.tree import tree_map
    jcfg, tcfg = _cfgs(pre_ln, scan)
    jd, td = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
              else (jnp.float32, torch.float32))
    tree = jb.init_bert_params(jcfg, jax.random.PRNGKey(1))
    batch = _batch(1)
    jloss = jb.bert_mlm_loss_fn(jcfg, dtype=jd, deterministic=True)
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jloss(
        jax.tree_util.tree_map(lambda t: t.astype(jd), p),
        jax.tree_util.tree_map(jnp.asarray, batch), None)))(tree)
    params = tree_map(lambda t: t.requires_grad_(),
                      tb.bert_params_from_jax(_np(tree)))
    assert ("layers" in params) == scan
    leaves = _leaves(params)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tl = tb.bert_mlm_loss_fn(tcfg, dtype=td, deterministic=True)(
        tree_map(lambda t: t.to(td), params), tbatch, None)
    grads = [g.numpy() for g in torch.autograd.grad(tl, leaves)]
    assert tl.dtype == torch.float32
    want = jax.tree_util.tree_leaves(jg)
    if dtype == "fp32":
        np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
        _assert_grads_close(grads, want, 1e-4)
        jx = jb.bert_encoder(tree, jcfg, jnp.asarray(batch["input_ids"]),
                             jnp.asarray(batch["attention_mask"]),
                             jnp.asarray(batch["token_type_ids"]),
                             dtype=jnp.float32)
        with torch.no_grad():
            tx = tb.bert_encoder(params, tcfg, tbatch["input_ids"],
                                 tbatch["attention_mask"],
                                 tbatch["token_type_ids"],
                                 dtype=torch.float32)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx),
                                   atol=FP32_ATOL, rtol=0)
    else:
        np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=2e-3)
        _assert_grads_rms(grads, jg, 2e-2, 5e-2)


def test_params_layouts_and_init_match_jax():
    """init_bert_params makes JAX's tree (names, shapes, layout) in both
    layouts; bert_params_from_jax keeps a tree's layout and values; the
    two layouts give the same loss."""
    from deepspeed_tpu.models import bert as jb

    from deepspeed_tpu_torch.models import bert as tb
    for scan in (False, True):
        jcfg, tcfg = _cfgs(scan=scan)
        jt = jb.init_bert_params(jcfg, jax.random.PRNGKey(0))
        tt = tb.init_bert_params(tcfg, torch.Generator().manual_seed(0))
        assert jax.tree_util.tree_structure(jax.tree_util.tree_map(
            lambda _: 0, jt)) == jax.tree_util.tree_structure(
            jax.tree_util.tree_map(lambda _: 0, tt))
        assert [tuple(t.shape) for t in _leaves(tt)] == \
            [tuple(t.shape) for t in jax.tree_util.tree_leaves(jt)]
        assert tb.count_params(tt) == sum(
            x.size for x in jax.tree_util.tree_leaves(jt))
        back = tb.bert_params_from_jax(_np(jt))
        for a, b in zip(_leaves(back), jax.tree_util.tree_leaves(jt)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    flat = tb.bert_params_from_jax(_np(jb.init_bert_params(
        _cfgs()[0], jax.random.PRNGKey(2))))
    stacked = {k: v for k, v in flat.items() if not k.startswith("layer_")}
    stacked["layers"] = {k: torch.stack([flat[f"layer_{i}"][k]
                                         for i in range(2)])
                         for k in flat["layer_0"]}
    batch = {k: torch.from_numpy(v) for k, v in _batch(2).items()}
    loss = tb.bert_mlm_loss_fn(_cfgs()[1], dtype=torch.float32,
                               deterministic=True)
    with torch.no_grad():
        assert float(loss(flat, batch, None)) == float(
            loss(stacked, batch, None))
    assert tb.BERT_LARGE == tb.BertConfig(**jb.BERT_LARGE._asdict())
    assert tb.BERT_BASE == tb.BertConfig(**jb.BERT_BASE._asdict())
    jl, tl = jb.layer_config(jb.BERT_LARGE), tb.layer_config(tb.BERT_LARGE)
    assert vars(tl) == vars(jl)


def test_mlm_dropout_is_seeded_and_remat_keeps_the_numbers():
    """With dropout on the loss depends on the seed and only on it; a None
    seed turns it off; remat (a checkpoint per layer) gives the same loss
    and grads bitwise."""
    from deepspeed_tpu.models import bert as jb

    from deepspeed_tpu_torch.models import bert as tb
    jcfg, tcfg = _cfgs()
    params = tb.bert_params_from_jax(_np(jb.init_bert_params(
        jcfg, jax.random.PRNGKey(3))))
    batch = {k: torch.from_numpy(v) for k, v in _batch(3).items()}
    loss = tb.bert_mlm_loss_fn(tcfg, dtype=torch.float32)
    det = tb.bert_mlm_loss_fn(tcfg, dtype=torch.float32, deterministic=True)
    with torch.no_grad():
        a, b, c = (float(loss(params, batch, s)) for s in (-7, -7, 11))
        assert a == b and a != c
        assert float(loss(params, batch, None)) == float(
            det(params, batch, None))
    leaves = _leaves(params)
    for t in leaves:
        t.requires_grad_()
    outs = []
    for remat in (False, True):
        fn = tb.bert_mlm_loss_fn(tcfg, dtype=torch.float32, remat=remat)
        lv = fn(params, batch, 9)
        outs.append([lv.detach()] + list(torch.autograd.grad(lv, leaves)))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_sparsity_config_raises():
    """The sparsity_config route runs: over a dense layout it gives the
    dense route's loss and grads (the sparse route's 'mul' key mask puts
    -1e30 on the pads, the dense one -1e9: both give pads p = 0). It
    raises where JAX does: a sequence that is not a multiple of the
    block, and an unparsed sparse_attention dict."""
    from deepspeed_tpu_torch.models import bert as tb
    from deepspeed_tpu_torch.ops.sparse_attention import (
        DenseSparsityConfig, sparsity_config_from_dict)
    _, tcfg = _cfgs()
    params = tb.init_bert_params(tcfg, torch.Generator().manual_seed(0))
    leaves = _leaves(params)
    for t in leaves:
        t.requires_grad_()
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    outs = []
    for sc in (None, DenseSparsityConfig(num_heads=2, block=16)):
        loss = tb.bert_mlm_loss_fn(tcfg, dtype=torch.float32,
                                   deterministic=True,
                                   sparsity_config=sc)(params, batch, None)
        outs.append([loss] + list(torch.autograd.grad(loss, leaves)))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)
    with pytest.raises(ValueError, match="divisible"):
        tb.bert_mlm_loss_fn(tcfg, sparsity_config=DenseSparsityConfig(
            num_heads=2, block=24))(params, batch, None)
    with pytest.raises(ValueError, match="PARSED"):
        sparsity_config_from_dict({"mode": "bslongformer"}, num_heads=2)
