"""The port's block-sparse attention (deepspeed_tpu_torch/ops/
sparse_attention, the KIND_BAND arity of ops/attention/masked_flash.py,
the sparse route of models/bert.py and the ``sparse_attention`` config
section) against the JAX package on the CPU.

The same numpy inputs, made from a seed, go through both. The JAX side's
attention runs its Pallas kernels in interpret mode; the port's runs the
plain versions of K1-K3. Tolerances:

- layouts, parsed configs, ``detect_banded``, ``BlockMask`` walks and
  their dense expansion: equal, bitwise;
- attention, K1-K3 with BAND tiles: fp32 atol 1e-5 on ``o``, ``lse``
  and the grads (the sums run in another order); bf16 every element
  within 1e-4 + 2**-7 |want| and the tensor within a relative RMS error
  of 1e-3 (both sides round the same fp32 values to bf16, so an element
  may land one bf16 ulp apart). The plain versions with the BAND tiles
  taken as FULL fail that check;
- the attention modules, fp32: atol 1e-5;
- the MLM loss with a sparsity config (tiny BERT: 2 layers, hidden 64, 4
  heads, S 128, block 16), fp32: loss rtol 1e-5, each grad within 1e-4
  of its largest entry; bf16 compute over fp32 masters: loss rtol 2e-3,
  each grad within a relative RMS error of 2e-2 (5e-2 for bias grads,
  whose sums JAX's autodiff runs in bf16);
- 5 engine steps of a tiny ``ds_config_sparse.json`` (fp32): losses
  rtol 1e-5, final params atol 1e-4.
"""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_threads  # noqa: F401  (torch threads per xdist worker)

FP32_ATOL = 1e-5
BF16_TOL = dict(atol=1e-4, rtol=2.0**-7, rms=1e-3)
S, FB = 128, 16
REPO = pathlib.Path(__file__).resolve().parents[1]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _bf16_check(got, want, atol, rtol, rms):
    diff = np.abs(got - want)
    ratio = float((diff / (atol + rtol * np.abs(want))).max())
    rel_rms = float(np.linalg.norm(diff) / max(np.linalg.norm(want), 1e-30))
    return ratio, rel_rms, ratio <= 1.0 and rel_rms <= rms


def _assert_close(got, want, dtype):
    if dtype == "fp32":
        np.testing.assert_allclose(got, want, atol=FP32_ATOL, rtol=0)
    else:
        ratio, rel_rms, ok = _bf16_check(got, want, **BF16_TOL)
        assert ok, (ratio, rel_rms)


# ------------------------------------------------------------ configs
def _modes():
    """(mode, constructor kwargs) covering every class and its knobs."""
    return [
        ("dense", dict(block=16)),
        ("fixed", dict(block=16)),
        ("fixed", dict(block=16, different_layout_per_head=True,
                       num_local_blocks=4, num_global_blocks=1,
                       num_different_global_patterns=4)),
        ("fixed", dict(block=16, attention="unidirectional",
                       num_local_blocks=3)),
        ("fixed", dict(block=32, horizontal_global_attention=True,
                       num_local_blocks=2)),
        ("variable", dict(block=16, num_random_blocks=2,
                          local_window_blocks=[2, 3],
                          global_block_indices=[0, 5],
                          different_layout_per_head=True, seed=3)),
        ("variable", dict(block=16, global_block_indices=[1],
                          global_block_end_indices=[3],
                          attention="unidirectional")),
        ("bigbird", dict(block=16, num_random_blocks=2,
                         num_sliding_window_blocks=3, num_global_blocks=1,
                         different_layout_per_head=True, seed=5)),
        ("bslongformer", dict(block=16)),
        ("bslongformer", dict(block=16, num_sliding_window_blocks=5,
                              global_block_indices=[0, 4],
                              global_block_end_indices=[2, 6])),
    ]


def _classes(pkg):
    import importlib
    sc = importlib.import_module(f"{pkg}.ops.sparse_attention."
                                 "sparsity_config")
    return {"dense": sc.DenseSparsityConfig,
            "fixed": sc.FixedSparsityConfig,
            "variable": sc.VariableSparsityConfig,
            "bigbird": sc.BigBirdSparsityConfig,
            "bslongformer": sc.BSLongformerSparsityConfig}


@pytest.mark.parametrize("case", range(len(_modes())))
def test_layouts_match_jax(case):
    mode, kw = _modes()[case]
    jcfg = _classes("deepspeed_tpu")[mode](num_heads=4, **kw)
    tcfg = _classes("deepspeed_tpu_torch")[mode](num_heads=4, **kw)
    for seq in (128, 256):
        want, got = jcfg.make_layout(seq), tcfg.make_layout(seq)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert tcfg.layout_cache_key() == jcfg.layout_cache_key()


@pytest.mark.parametrize("mode, kw, exc", [
    ("fixed", dict(num_local_blocks=3, num_global_blocks=2), ValueError),
    ("fixed", dict(attention="sideways"), NotImplementedError),
    ("fixed", dict(attention="unidirectional",
                   horizontal_global_attention=True), ValueError),
    ("fixed", dict(num_different_global_patterns=2), ValueError),
    ("fixed", dict(different_layout_per_head=True,
                   num_different_global_patterns=5), ValueError),
    ("variable", dict(global_block_indices=[0, 2],
                      global_block_end_indices=[1]), ValueError),
    ("variable", dict(global_block_indices=[3],
                      global_block_end_indices=[2]), ValueError),
    ("bslongformer", dict(global_block_indices=[2],
                          global_block_end_indices=[2]), ValueError),
])
def test_config_errors_match_jax(mode, kw, exc):
    for pkg in ("deepspeed_tpu", "deepspeed_tpu_torch"):
        with pytest.raises(exc):
            _classes(pkg)[mode](num_heads=4, block=16, **kw)


@pytest.mark.parametrize("mode, kw", [
    ("variable", dict(num_random_blocks=20)),
    ("bigbird", dict(num_sliding_window_blocks=20)),
    ("bslongformer", dict(num_sliding_window_blocks=20)),
])
def test_layout_size_errors_match_jax(mode, kw):
    for pkg in ("deepspeed_tpu", "deepspeed_tpu_torch"):
        cfg = _classes(pkg)[mode](num_heads=2, block=16, **kw)
        with pytest.raises(ValueError):
            cfg.make_layout(128)
        with pytest.raises(ValueError, match="divisible"):
            cfg.make_layout(120)


@pytest.mark.parametrize("raw", [
    None,
    {"mode": "dense"},
    json.loads((REPO / "examples/bing_bert/ds_config_sparse.json"
                ).read_text())["sparse_attention"],
    {"mode": "fixed", "block": 32, "num_local_blocks": 8,
     "num_sliding_window_blocks": 9},
    {"mode": "variable", "num_random_blocks": 1,
     "local_window_blocks": [2, 4], "global_block_indices": [0, 3],
     "global_block_end_indices": [1, 5]},
    {"mode": "bigbird", "num_random_blocks": 1},
    {"mode": "bslongformer"},
    {},
])
def test_get_sparse_attention_matches_jax(raw):
    """The parsed section (the schema's defaults, each mode's keys only)
    and the config built from it, through DeepSpeedConfig too."""
    from deepspeed_tpu.ops.sparse_attention import \
        sparsity_config_from_dict as jfrom
    from deepspeed_tpu.runtime.config import get_sparse_attention as jget

    from deepspeed_tpu_torch.ops.sparse_attention import \
        sparsity_config_from_dict as tfrom
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
    from deepspeed_tpu_torch.runtime.config import \
        get_sparse_attention as tget
    d = {"train_batch_size": 2} if raw is None else \
        {"train_batch_size": 2, "sparse_attention": raw}
    want, got = jget(d), tget(d)
    assert got == want
    assert DeepSpeedConfig(d).sparse_attention == want
    if want is None:
        assert tfrom(got, num_heads=4) is None
        return
    jc, tc = jfrom(want, num_heads=4), tfrom(got, num_heads=4)
    assert type(tc).__name__ == type(jc).__name__
    assert vars(tc) == vars(jc)
    np.testing.assert_array_equal(tc.make_layout(256), jc.make_layout(256))


def test_config_parse_errors_match_jax():
    from deepspeed_tpu.ops.sparse_attention import \
        sparsity_config_from_dict as jfrom
    from deepspeed_tpu.runtime.config import get_sparse_attention as jget

    from deepspeed_tpu_torch.ops.sparse_attention import \
        sparsity_config_from_dict as tfrom
    from deepspeed_tpu_torch.runtime.config import \
        get_sparse_attention as tget
    for get in (jget, tget):
        with pytest.raises(NotImplementedError, match="sparsity mode"):
            get({"sparse_attention": {"mode": "strided"}})
    for build in (jfrom, tfrom):
        with pytest.raises(ValueError, match="PARSED"):
            build({"mode": "fixed"}, num_heads=4)
        with pytest.raises(ValueError, match="not in"):
            build({"mode": "strided", "block": 16}, num_heads=4)


# ------------------------------------------------------------ banded
def _band_layout(n, g_r=1, g_c=1, w=1, causal=False, heads=2):
    idx = np.arange(n)
    rb, cb = idx[:, None], idx[None, :]
    pred = (rb < g_r) | (cb < g_c) | (np.abs(rb - cb) <= w)
    if causal:
        pred &= cb <= rb
    return np.broadcast_to(pred.astype(np.int32), (heads, n, n)).copy()


def _detect_sweep():
    rng = np.random.RandomState(4)
    out = [_band_layout(n, g_r, g_c, w, c)
           for n in (1, 4, 16) for g_r, g_c in ((0, 0), (1, 1), (2, 0),
                                                (0, 3))
           for w in (0, 1, 3) for c in (False, True)]
    out += [np.ones((2, 8, 8), np.int32), np.zeros((1, 8, 8), np.int32),
            (rng.rand(2, 8, 8) < 0.5).astype(np.int32)]
    for mode, kw in _modes():
        out.append(_classes("deepspeed_tpu")[mode](num_heads=2,
                                                   **kw).make_layout(256))
    per_head = _band_layout(8)
    per_head[1, 5, 0] = 0
    return out + [per_head]


def test_detect_banded_matches_jax():
    from deepspeed_tpu.ops.sparse_attention.banded import \
        detect_banded as jdetect

    from deepspeed_tpu_torch.ops.sparse_attention.banded import \
        detect_banded as tdetect
    found = 0
    for layout in _detect_sweep():
        want, got = jdetect(layout), tdetect(layout)
        assert (got is None) == (want is None), layout
        if want is not None:
            found += 1
            assert tuple(got) == tuple(want)
    assert found > 20


def _walk_layouts():
    from deepspeed_tpu_torch.ops.sparse_attention import \
        BSLongformerSparsityConfig
    return {
        "bslongformer": BSLongformerSparsityConfig(
            num_heads=4, block=FB).make_layout(256),
        "bslongformer_w2_g2": BSLongformerSparsityConfig(
            num_heads=4, block=FB, num_sliding_window_blocks=5,
            global_block_indices=[0], global_block_end_indices=[2]
        ).make_layout(256),
        "causal_band": _band_layout(16, 1, 1, 1, True),
    }


@pytest.mark.parametrize("walk", [32, 64, 128, 0])
@pytest.mark.parametrize("name", ["bslongformer", "bslongformer_w2_g2",
                                  "causal_band"])
def test_block_mask_from_layout_matches_jax(name, walk):
    """A forced walk_block: active, kinds, band, the CSR/CSC walks and
    the dense expansion equal JAX's; the expansion reproduces the
    layout's fine bits."""
    from deepspeed_tpu.ops.attention.masked_flash import BlockMask as JBM
    from deepspeed_tpu.ops.sparse_attention.blocksparse import \
        layout_additive_mask

    from deepspeed_tpu_torch.ops.attention.masked_flash import \
        BlockMask as TBM
    layout = _walk_layouts()[name]
    jm = JBM.from_layout(layout, FB, walk_block=walk)
    tm = TBM.from_layout(layout, FB, walk_block=walk)
    np.testing.assert_array_equal(tm.active, jm.active)
    np.testing.assert_array_equal(tm.kinds, jm.kinds)
    assert tm.band == jm.band
    assert (tm.block, tm.fine_block, tm.heads, tm.has_partials) == \
        (jm.block, jm.fine_block, jm.heads, jm.has_partials)
    assert tm.describe() == jm.describe()
    for ours, theirs in zip(tm.csr() + tm.csc(), jm.csr() + jm.csc()):
        np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(tm.dense_additive(), jm.dense_additive())
    np.testing.assert_array_equal(
        tm.dense_additive() == 0.0,
        layout_additive_mask(layout, FB)[:1] == 0.0)
    assert tm.has_band == (walk != 0)


def test_from_layout_auto_walk_and_errors(monkeypatch):
    """The port's automatic tile follows JAX's rule (the fine walk unless
    a coarse tile of 128, 64 or 32 is modeled to win by more than 10%)
    with this card's costs (``walk_cost_us``; JAX's 512/256 and
    ``_iter_cost_us`` model a TPU), and JAX's errors."""
    from deepspeed_tpu.ops.attention.masked_flash import BlockMask as JBM

    from deepspeed_tpu_torch.ops.attention import masked_flash as mf
    from deepspeed_tpu_torch.ops.attention.masked_flash import \
        BlockMask as TBM
    from deepspeed_tpu_torch.ops.sparse_attention import \
        BSLongformerSparsityConfig
    layout = _walk_layouts()["bslongformer"]                 # S 256
    # K1-K3 on the tensor cores pay per computed cell alone (no cost per
    # tile or chunk): a coarse walk never computes fewer cells, so the
    # rule keeps the fine walk
    assert TBM.from_layout(layout, FB).block == FB
    assert TBM.from_layout(layout[:, :6, :6], FB).block == FB     # S 96
    assert TBM.from_layout(_band_layout(4), 128).block == 128     # fine
    # the main path's BSLongformer layout at S 2048: the fine walk
    main = BSLongformerSparsityConfig(num_heads=16, block=FB).make_layout(
        2048)
    assert TBM.from_layout(main, FB).block == FB
    wide = _walk_layouts()["bslongformer_w2_g2"]
    assert TBM.from_layout(wide, FB).block == FB
    # a floor per computed chunk (the costs fitted while K2 ran on the
    # CUDA cores) makes a coarse walk win where it saves chunks
    monkeypatch.setitem(mf.WALK_COSTS, "masked_flash",
                        (9.075e-5, 5.554e-2, 1.7606e-4))
    # a window of 3 blocks of 16: a live 32 x 32 chunk holds 2-3 kept
    # fine tiles, and a chunk of 16 costs 0.43 of one of 32: the fine walk
    assert TBM.from_layout(layout, FB).block == FB
    assert TBM.from_layout(layout[:, :6, :6], FB).block == 32     # S 96
    # a window of 5: most live chunks are full, walk 128 wins
    assert TBM.from_layout(wide, FB).block == 128
    # a cost per cell alone: a coarse walk never computes fewer cells
    monkeypatch.setitem(mf.WALK_COSTS, "masked_flash", (0.0, 0.0, 1.0))
    assert TBM.from_layout(wide, FB).block == FB
    per_head = TBM.from_layout(_modes_layout("fixed_per_head"), FB)
    assert per_head.block == FB and per_head.heads == 4
    assert per_head.band is None and not per_head.has_band
    for cls in (JBM, TBM):
        with pytest.raises(ValueError, match="banded-describable"):
            cls.from_layout(np.ones((1, 4, 4)), 16, walk_block=64)
    with pytest.raises(ValueError, match="multiple"):
        TBM.from_layout(layout, FB, walk_block=24)
    with pytest.raises(AssertionError):
        JBM.from_layout(layout, FB, walk_block=24)
    with pytest.raises(ValueError, match="band"):
        TBM(np.ones((1, 2, 2)), np.full((1, 2, 2), 2), 16, 32, 32)


def _modes_layout(name):
    from deepspeed_tpu_torch.ops.sparse_attention import \
        sparsity_config_from_dict
    if name == "fixed_per_head":
        sa = json.loads((REPO / "examples/bing_bert/ds_config_sparse.json"
                         ).read_text())["sparse_attention"]
        return sparsity_config_from_dict(sa, num_heads=4).make_layout(S)
    raise AssertionError(name)


# ------------------------------------------- K1-K3 with BAND tiles
def _qkv(rng, B, H, s, d=16, G=1):
    return [(rng.randn(*shape) * 0.5).astype(np.float32) for shape in
            ((B, H, s, d), (B, H // G, s, d), (B, H // G, s, d),
             (B, H, s, d))]


def _kpm(rng, B, s, min_len, all_pad_rows=()):
    """The sparse route's additive key mask: -1e30 on the pads ('mul')."""
    lengths = rng.randint(min_len, s + 1, size=B)
    am = (np.arange(s)[None, :] < lengths[:, None]).astype(np.float32)
    am[list(all_pad_rows)] = 0.0
    return np.where(am == 0, -1e30, 0.0).astype(np.float32)


def _jax_attention(q, k, v, do, jmask, dtype, kpm, rate=0.0, seed=0):
    """o, lse, dq, dk, dv of masked_flash_call's forward and its vjp
    rules in interpret mode, with an explicit int32 dropout seed."""
    from deepspeed_tpu.ops.attention.masked_flash import masked_flash_call
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    jq, jk, jv, jdo = (jnp.asarray(a).astype(jd) for a in (q, k, v, do))
    has_kpm = kpm is not None
    key_mask = (jnp.asarray(kpm) if has_kpm
                else jnp.zeros((q.shape[0], 1), jnp.float32))
    jseed = jnp.asarray([[seed]], jnp.int32)
    scale = 1.0 / np.sqrt(q.shape[-1])
    o, res = masked_flash_call.fwd(jq, jk, jv, key_mask, jseed, jmask,
                                   scale, True, rate, has_kpm)
    grads = masked_flash_call.bwd(jmask, scale, True, rate, has_kpm, res,
                                  jdo)[:3]
    return [np.asarray(x.astype(jnp.float32)) for x in (o, *grads)] + [
        np.asarray(res[-1]).reshape(q.shape[:3])]


def _port_attention(q, k, v, do, tmask, dtype, kpm, rate=0.0, seed=0):
    from deepspeed_tpu_torch.ops.attention.masked_flash import (
        masked_flash_attention, masked_flash_fwd)
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    args = [torch.from_numpy(a).to(td).requires_grad_() for a in (q, k, v)]
    key_mask = None if kpm is None else torch.from_numpy(kpm)
    o = masked_flash_attention(*args, tmask, key_mask=key_mask,
                               dropout_rate=rate,
                               dropout_seed=seed if rate else None)
    grads = torch.autograd.grad(o, args, torch.from_numpy(do).to(td))
    _, lse = masked_flash_fwd(*(a.detach() for a in args), tmask,
                              1.0 / np.sqrt(q.shape[-1]), rate, seed,
                              key_mask)
    return [x.detach().float().numpy() for x in (o, *grads)] + [lse.numpy()]


BAND_CASES = {
    # name: (layout, walk block, B, H, G, kpm min_len, all-pad rows, rate)
    "bslongformer_w2_g2_walk64_kpm": ("bslongformer_w2_g2", 64, 2, 2, 1,
                                      100, (), 0.0),
    "bslongformer_walk32_gqa_dropout": ("bslongformer", 32, 1, 4, 2, None,
                                        (), 0.1),
    "causal_band_walk128_all_pad_row": ("causal_band", 128, 2, 2, 1, 90,
                                        (1,), 0.0),
}


@pytest.mark.parametrize("case, dtype", [
    ("bslongformer_w2_g2_walk64_kpm", "fp32"),
    ("bslongformer_w2_g2_walk64_kpm", "bf16"),
    ("bslongformer_walk32_gqa_dropout", "fp32"),
    ("causal_band_walk128_all_pad_row", "bf16"),
])
def test_band_kernels_match_jax(case, dtype):
    """o and the grads of masked_flash_attention over coarse walks with
    KIND_BAND tiles (rows and columns with no kept cell inside walked
    tiles, a causal clip, a 'mul' key mask with a batch row of pads that
    attends to nothing, GQA, dropout) against the JAX kernels in
    interpret mode; then the control: BAND tiles taken as FULL fail."""
    from deepspeed_tpu.ops.attention.masked_flash import BlockMask as JBM

    from deepspeed_tpu_torch.ops.attention.masked_flash import (
        KIND_BAND, BlockMask as TBM)
    name, walk, B, H, G, min_len, pads, rate = BAND_CASES[case]
    layout = _walk_layouts()[name]
    s = layout.shape[1] * FB
    rng = np.random.RandomState(len(case) + (dtype == "bf16"))
    q, k, v, do = _qkv(rng, B, H, s, G=G)
    kpm = None if min_len is None else _kpm(rng, B, s, min_len, pads)
    tm = TBM.from_layout(layout, FB, walk_block=walk)
    sub = tm.active[0] & (tm.kinds[0] & KIND_BAND).astype(bool)
    keep = tm.dense_additive()[0] == 0.0
    tiles = keep.reshape(tm.nq, walk, tm.nk, walk).transpose(0, 2, 1, 3)
    # walked BAND tiles hold rows (K1, K2) or columns (K3) with no kept
    # cell: both in the window-only cases, columns under the causal clip
    empty_rows, empty_cols = ((~tiles[sub].any(axis)).any()
                              for axis in (-1, -2))
    assert empty_cols and (empty_rows or name == "causal_band")
    want = _jax_attention(q, k, v, do, JBM.from_layout(layout, FB, walk),
                          dtype, kpm, rate, seed=-77)
    got = _port_attention(q, k, v, do, tm, dtype, kpm, rate, seed=-77)
    for g, w in zip(got[:4], want[:4]):
        assert np.isfinite(g).all()
        _assert_close(g, w, dtype)
    np.testing.assert_allclose(got[4], want[4], atol=FP32_ATOL, rtol=0)
    if pads:
        assert (got[0][list(pads)] == 0).all()
    no_band = TBM(tm.active, np.zeros_like(tm.kinds), walk, s, s)
    control = _port_attention(q, k, v, do, no_band, dtype, kpm, rate,
                              seed=-77)
    for g, w in zip(control[:4], want[:4]):
        with pytest.raises(AssertionError):
            _assert_close(g, w, dtype)


# ------------------------------------------------ the sparse front end
FRONT_CASES = [
    # (mode, config kwargs, key mask mode)
    ("fixed", dict(different_layout_per_head=True, num_local_blocks=4,
                   num_different_global_patterns=2), "mul"),
    ("bslongformer", {}, "mul"),
    ("bslongformer", dict(num_sliding_window_blocks=5), "add"),
    ("bigbird", dict(num_random_blocks=1), "add"),
    ("variable", dict(num_random_blocks=1, local_window_blocks=[2]),
     "mul"),
    ("dense", {}, "add"),
]


@pytest.mark.parametrize("case", range(len(FRONT_CASES)))
def test_block_sparse_attention_matches_jax(case):
    """block_sparse_attention per mode with 'add' and 'mul' key masks,
    forward and grads, against the JAX dispatch in interpret mode."""
    from deepspeed_tpu.ops.sparse_attention import blocksparse as jbs

    from deepspeed_tpu_torch.ops.sparse_attention import blocksparse as tbs
    mode, kw, kpm_mode = FRONT_CASES[case]
    B, H = 2, 2
    layout = _classes("deepspeed_tpu_torch")[mode](
        num_heads=H, block=FB, **kw).make_layout(S)
    rng = np.random.RandomState(case)
    q, k, v, do = _qkv(rng, B, H, S)
    am = (np.arange(S)[None, :] < rng.randint(60, S + 1, B)[:, None])
    am = am.astype(np.float32) * (1.0 if kpm_mode == "mul" else -3.0)

    def jf(a, b, c):
        return jbs.block_sparse_attention(
            a, b, c, layout, key_padding_mask=jnp.asarray(am),
            key_padding_mask_mode=kpm_mode, interpret=True)
    jo, vjp = jax.vjp(jf, *(jnp.asarray(a) for a in (q, k, v)))
    want = [np.asarray(x) for x in (jo, *vjp(jnp.asarray(do)))]
    args = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o = tbs.block_sparse_attention(*args, layout,
                                   key_padding_mask=torch.from_numpy(am),
                                   key_padding_mask_mode=kpm_mode)
    got = [o.detach().numpy()] + [
        g.numpy() for g in torch.autograd.grad(o, args,
                                               torch.from_numpy(do))]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=FP32_ATOL, rtol=0)
    ref = tbs.block_sparse_attention_reference(
        *(torch.from_numpy(a) for a in (q, k, v)), layout,
        key_padding_mask=torch.from_numpy(am),
        key_padding_mask_mode=kpm_mode)
    np.testing.assert_allclose(ref.numpy(), want[0], atol=FP32_ATOL)


def test_front_end_routes(monkeypatch):
    """rpe and force_reference take the dense reference (as in JAX); a
    user attn_mask takes the row-run route ('v2', or 'v2-coarse<N>' on a
    coarse walk); planned_kernel reports the port's routes; the LUTs and
    the dense expansion equal JAX's."""
    from deepspeed_tpu.ops.sparse_attention import blocksparse as jbs

    from deepspeed_tpu_torch.ops.attention import masked_flash as mf
    from deepspeed_tpu_torch.ops.sparse_attention import blocksparse as tbs
    layout = _walk_layouts()["bslongformer"][:2, :8, :8]          # S 128
    rng = np.random.RandomState(9)
    q, k, v, _ = (torch.from_numpy(a) for a in _qkv(rng, 1, 2, S))
    rpe = torch.from_numpy(rng.randn(1, 2, S, S).astype(np.float32))
    want = jbs.block_sparse_attention_reference(
        *(jnp.asarray(t.numpy()) for t in (q, k, v)), layout,
        rpe=jnp.asarray(rpe.numpy()))
    before = mf.masked_flash_fwd.launches
    np.testing.assert_allclose(
        tbs.block_sparse_attention(q, k, v, layout, rpe=rpe).numpy(),
        np.asarray(want), atol=FP32_ATOL)
    tbs.block_sparse_attention(q, k, v, layout, force_reference=True)
    assert mf.masked_flash_fwd.launches == before
    # a user attn_mask takes the row-run kernels K8-K10, not K1-K3
    am = torch.ones(S, S).tril()
    np.testing.assert_allclose(
        tbs.block_sparse_attention(q, k, v, layout, attn_mask=am).numpy(),
        tbs.block_sparse_attention_reference(q, k, v, layout,
                                             attn_mask=am).numpy(),
        atol=FP32_ATOL)
    assert mf.masked_flash_fwd.launches == before
    assert tbs.planned_kernel(layout, FB, has_am=True) == "v2"
    monkeypatch.setattr(tbs, "_FORCE_COARSE_BLOCK", 64)
    assert tbs.planned_kernel(layout, FB, has_am=True) == "v2-coarse64"
    monkeypatch.setattr(tbs, "_FORCE_COARSE_BLOCK", None)
    assert tbs.planned_kernel(layout, FB) == "masked"
    # K1-K3 pay per computed cell: the rule keeps the fine walk, and a
    # floor per chunk (the costs fitted while K2 ran on the CUDA cores)
    # coarsens a band whose live chunks are full
    wide = _walk_layouts()["bslongformer_w2_g2"]
    assert tbs.planned_kernel(wide, FB) == "masked"
    monkeypatch.setitem(mf.WALK_COSTS, "masked_flash",
                        (9.075e-5, 5.554e-2, 1.7606e-4))
    assert tbs.planned_kernel(wide, FB) == "masked-coarse128"
    monkeypatch.undo()
    # the key mask reaches the kernels as the additive (B, S) row, not
    # pre-blocked as JAX's TPU lane rule has it; no mask, no key-mask arity
    seen = []
    real = tbs.masked_flash_attention
    monkeypatch.setattr(
        tbs, "masked_flash_attention", lambda *a, key_mask=None, **kw: (
            seen.append(None if key_mask is None else tuple(key_mask.shape))
            or real(*a, key_mask=key_mask, **kw)))
    tbs.block_sparse_attention(q, k, v, layout,
                               key_padding_mask=torch.ones(1, S),
                               key_padding_mask_mode="mul")
    tbs.block_sparse_attention(q, k, v, layout)
    assert seen == [(1, S), None]
    fixed = _modes_layout("fixed_per_head")
    assert tbs.planned_kernel(fixed, FB) == jbs.planned_kernel(
        fixed, FB, interpret=True) == "masked"
    for ours, theirs in ((tbs.build_row_luts(fixed),
                          jbs.build_row_luts(fixed)),
                         (tbs.build_col_luts(fixed),
                          jbs.build_col_luts(fixed))):
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tbs.layout_additive_mask(fixed, FB),
                                  jbs.layout_additive_mask(fixed, FB))


# ------------------------------------------------------------ modules
TINY = dict(vocab_size=97, hidden_size=64, num_layers=2, num_heads=4,
            intermediate_size=128, max_position_embeddings=S)


def _sparse_cfgs(kind, heads=4):
    from deepspeed_tpu.ops.sparse_attention import \
        sparsity_config_from_dict as jfrom
    from deepspeed_tpu.runtime.config import get_sparse_attention

    from deepspeed_tpu_torch.ops.sparse_attention import \
        sparsity_config_from_dict as tfrom
    raw = json.loads((REPO / "examples/bing_bert/ds_config_sparse.json"
                      ).read_text())
    if kind == "bslongformer":
        raw["sparse_attention"] = {"mode": "bslongformer"}
    sa = get_sparse_attention(raw)
    return jfrom(sa, num_heads=heads), tfrom(sa, num_heads=heads), raw


def test_sparse_self_attention_modules_match_jax():
    """SparseSelfAttention (its layout cache too) and
    BertSparseSelfAttention with the JAX module's parameters."""
    from deepspeed_tpu.models.bert import BertConfig as JCfg
    from deepspeed_tpu.ops.sparse_attention import (
        BertSparseSelfAttention as JBert, SparseSelfAttention as JSSA)

    from deepspeed_tpu_torch.models.bert import BertConfig as TCfg
    from deepspeed_tpu_torch.ops.sparse_attention import (
        BertSparseSelfAttention as TBert, SparseSelfAttention as TSSA)
    jsc, tsc, _ = _sparse_cfgs("bslongformer")
    rng = np.random.RandomState(11)
    q, k, v, _ = _qkv(rng, 2, 4, S)
    kpm = (np.arange(S)[None, :] < np.array([[70], [S]])).astype(np.int32)
    tssa = TSSA(tsc, key_padding_mask_mode="mul")
    assert tssa.get_layout(S) is tssa.get_layout(S)
    got = tssa(*(torch.from_numpy(a) for a in (q, k, v)),
               key_padding_mask=torch.from_numpy(kpm))
    want = JSSA(jsc, key_padding_mask_mode="mul")(
        *(jnp.asarray(a) for a in (q, k, v)),
        key_padding_mask=jnp.asarray(kpm), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=FP32_ATOL)
    with pytest.raises(NotImplementedError, match="self-attention"):
        tssa(torch.from_numpy(q), torch.from_numpy(k[:, :, :64]),
             torch.from_numpy(v[:, :, :64]))

    jmod = JBert(JCfg(**TINY), jsc)
    params = _np(jmod.init_params(jax.random.PRNGKey(2)))
    tmod = TBert(TCfg(**TINY), tsc, initial_params=params)
    assert sorted(n for n, _ in tmod.named_parameters()) == sorted(
        f"{a}.{b}" for a in ("query", "key", "value") for b in ("b", "w"))
    x = rng.randn(2, S, 64).astype(np.float32)
    am = (np.arange(S)[None, :] < np.array([[90], [S]])).astype(np.float32)
    want = jmod(params, jnp.asarray(x), jnp.asarray(am))
    got = tmod(torch.from_numpy(x), torch.from_numpy(am))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=FP32_ATOL)
    fresh = TBert(TCfg(**TINY), tsc, generator=torch.Generator())
    assert fresh.query["w"].shape == (64, 64)
    assert float(fresh.query["b"].detach().abs().sum()) == 0.0


def test_sparse_attention_utils_match_jax():
    """pad/unpad, the position table's extension, the tokenizer bump and
    the encoder surgery (which extends the table to 2 x S and runs the
    sparse encoder at that length) against JAX."""
    from deepspeed_tpu.models.bert import BertConfig as JCfg
    from deepspeed_tpu.models.bert import init_bert_params
    from deepspeed_tpu.ops.sparse_attention import \
        SparseAttentionUtils as JU

    from deepspeed_tpu_torch.models.bert import BertConfig as TCfg
    from deepspeed_tpu_torch.models.bert import bert_params_from_jax
    from deepspeed_tpu_torch.ops.sparse_attention import \
        SparseAttentionUtils as TU
    rng = np.random.RandomState(12)
    ids = rng.randint(0, 97, (2, 50)).astype(np.int32)
    extra = [np.ones_like(ids), (rng.rand(2, 50) < 0.5).astype(np.int32),
             np.tile(np.arange(50, dtype=np.int32), (2, 1)), ids.copy()]
    want = JU.pad_to_block_size(16, jnp.asarray(ids), 0,
                                *(jnp.asarray(a) for a in extra))
    got = TU.pad_to_block_size(16, torch.from_numpy(ids), 0,
                               *(torch.from_numpy(a) for a in extra))
    assert got[0] == want[0] == 14
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert TU.pad_to_block_size(25, torch.from_numpy(ids), 0)[0] == 0
    out = torch.randn(2, 64, 8)
    assert torch.equal(TU.unpad_sequence_output(14, out), out[:, :50])
    assert TU.unpad_sequence_output(0, out) is out

    class Tok:
        model_max_length = 512
        init_kwargs = {}
    tok = TU.update_tokenizer_model_max_length(Tok(), 2048)
    assert tok.model_max_length == tok.init_kwargs["model_max_length"] \
        == 2048

    jsc, tsc, _ = _sparse_cfgs("bslongformer")
    jcfg, tcfg = JCfg(**TINY), TCfg(**TINY)
    tree = _np(init_bert_params(jcfg, jax.random.PRNGKey(5)))
    with pytest.raises(ValueError, match="exceed"):
        TU.extend_position_embedding(bert_params_from_jax(tree), S)
    jp, jc, jenc = JU.replace_model_self_attention_with_sparse_self_attention(
        jax.tree_util.tree_map(jnp.asarray, tree), jcfg, max_position=2 * S,
        sparsity_config=jsc)
    tp, tc, tenc = TU.replace_model_self_attention_with_sparse_self_attention(
        bert_params_from_jax(tree), tcfg, max_position=2 * S,
        sparsity_config=tsc)
    assert tc.max_position_embeddings == jc.max_position_embeddings == 2 * S
    assert tuple(tp["pos_emb"].shape) == (2 * S, 64)
    np.testing.assert_array_equal(tp["pos_emb"].numpy(),
                                  np.asarray(jp["pos_emb"]))
    assert TU.replace_self_attention_layer_with_sparse_self_attention_layer \
        is TU.replace_model_self_attention_with_sparse_self_attention
    ids2 = rng.randint(0, 97, (1, 2 * S)).astype(np.int32)
    am2 = (np.arange(2 * S)[None, :] < 200).astype(np.int32)
    want = jax.jit(lambda p, i, a: jenc(p, i, attention_mask=a,
                                        dtype=jnp.float32))(
        jp, jnp.asarray(ids2), jnp.asarray(am2))
    got = tenc(tp, torch.from_numpy(ids2),
               attention_mask=torch.from_numpy(am2), dtype=torch.float32)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=2e-5)


# --------------------------------------------------- the MLM loss, engine
def _mlm_batch(rng, B=2, s=S, min_len=70):
    ids = rng.randint(0, TINY["vocab_size"], (B, s)).astype(np.int32)
    am = (np.arange(s)[None, :] < rng.randint(min_len, s + 1, B)[:, None]
          ).astype(np.int32)
    labels = np.where((rng.rand(B, s) < 0.3) & (am == 1), ids,
                      -100).astype(np.int32)
    return {"input_ids": ids, "attention_mask": am, "labels": labels}


BIAS_LEAVES = ("qkvb", "ob", "inter_b", "output_b", "attn_nb", "norm_b",
               "mlm_bias", "['b']")


@pytest.mark.parametrize("kind, dtype", [("fixed", "fp32"),
                                         ("bslongformer", "fp32"),
                                         ("bslongformer", "bf16")])
def test_mlm_loss_with_sparsity_config_matches_jax(kind, dtype):
    """bert_mlm_loss_fn(sparsity_config=...) on a padded batch: the
    repo's fixed per-head config (4 global patterns; in fp32, where the
    JAX side's interpret-mode compile of 4 mask heads is the slowest
    case of the file) and the BSLongformer defaults (a coarse walk with
    KIND_BAND tiles)."""
    from deepspeed_tpu.models import bert as jb

    from deepspeed_tpu_torch.models import bert as tb
    from deepspeed_tpu_torch.utils.tree import tree_leaves
    jsc, tsc, _ = _sparse_cfgs(kind)
    jcfg, tcfg = jb.BertConfig(**TINY), tb.BertConfig(**TINY)
    tree = _np(jb.init_bert_params(jcfg, jax.random.PRNGKey(1)))
    batch = _mlm_batch(np.random.RandomState(2))
    jd = jnp.float32 if dtype == "fp32" else jnp.bfloat16
    td = torch.float32 if dtype == "fp32" else torch.bfloat16
    jloss = jb.bert_mlm_loss_fn(jcfg, dtype=jd, deterministic=True,
                                sparsity_config=jsc)
    # jitted: one compile of the interpret-mode kernels, not an eager
    # dispatch of each of their operations
    jv, jg = jax.jit(jax.value_and_grad(lambda p: jloss(
        p, {k: jnp.asarray(v) for k, v in batch.items()}, None)))(
        jax.tree_util.tree_map(jnp.asarray, tree))
    params = tb.bert_params_from_jax(tree)
    leaves = list(tree_leaves(params))
    for t in leaves:
        t.requires_grad_()
    tloss = tb.bert_mlm_loss_fn(tcfg, dtype=td, deterministic=True,
                                sparsity_config=tsc)
    tv = tloss(params, {k: torch.from_numpy(v) for k, v in batch.items()},
               None)
    tg = torch.autograd.grad(tv, leaves)
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(jg)[0]]
    want = [np.asarray(w, np.float32) for w in jax.tree_util.tree_leaves(jg)]
    assert len(want) == len(tg)
    if dtype == "fp32":
        np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5)
        for g, w in zip(tg, want):
            scale = max(float(np.abs(w).max()), 1e-30)
            assert float(np.abs(g.numpy() - w).max()) <= 1e-4 * scale
    else:
        np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=2e-3)
        for path, g, w in zip(paths, tg, want):
            err = np.linalg.norm(g.numpy() - w) / max(
                float(np.linalg.norm(w)), 1e-30)
            bias = any(path.endswith(f"{b}']") or path.endswith(b)
                       for b in BIAS_LEAVES)
            assert err <= (5e-2 if bias else 2e-2), (path, err)


def test_sparse_trajectory_matches_jax_engine():
    """5 train_batch steps of examples/bing_bert/ds_config_sparse.json
    (Lamb, WarmupLR, clipping 1.0, ZeRO 1, ga 2; fixed per-head sparse
    attention at block 16) cut to micro batch 2 in fp32, on a tiny BERT,
    against the JAX engine on one device: every loss and the final
    params."""
    import deepspeed_tpu
    from deepspeed_tpu.models import bert as jb

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import bert as tb
    from deepspeed_tpu_torch.utils.tree import tree_leaves
    jsc, tsc, raw = _sparse_cfgs("fixed")
    raw.update(train_micro_batch_size_per_gpu=2, bf16={"enabled": False},
               steps_per_print=1000)
    tiny = dict(TINY, hidden_dropout=0.0, attn_dropout=0.0)
    tree = jb.init_bert_params(jb.BertConfig(**tiny), jax.random.PRNGKey(0))
    rng = np.random.RandomState(6)
    micros = [_mlm_batch(rng) for _ in range(2)] * 5
    jeng, *_ = deepspeed_tpu.initialize(
        model=jb.bert_mlm_loss_fn(jb.BertConfig(**tiny), dtype=jnp.float32,
                                  deterministic=True, sparsity_config=jsc),
        model_parameters=tree, config=dict(raw, mesh={"axes": {"data": 1}}))
    teng, *_ = deepspeed_tpu_torch.initialize(
        model=tb.bert_mlm_loss_fn(tb.BertConfig(**tiny), dtype=torch.float32,
                                  deterministic=True, sparsity_config=tsc),
        model_parameters=tb.bert_params_from_jax(_np(tree)), config=raw,
        device="cpu")
    assert teng._config.sparse_attention == raw["sparse_attention"]
    jit, tit = iter(micros), iter(micros)
    jl = [float(jeng.train_batch(jit)) for _ in range(5)]
    tl = [float(teng.train_batch(tit)) for _ in range(5)]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for t, j in zip(tree_leaves(teng.module_params),
                    jax.tree_util.tree_leaves(jeng.module_params)):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                   rtol=0, atol=1e-4)


def test_positions_past_the_table_clamp_as_in_jax():
    """Both packages' gathers clamp a position past the table to its last
    row (the sparse phases extend the table and assert it covers S)."""
    from deepspeed_tpu.models import bert as jb

    from deepspeed_tpu_torch.models import bert as tb
    small = dict(TINY, max_position_embeddings=32)
    tree = _np(jb.init_bert_params(jb.BertConfig(**small),
                                   jax.random.PRNGKey(7)))
    ids = np.random.RandomState(7).randint(0, 97, (1, 64)).astype(np.int32)
    want = jax.jit(lambda p, i: jb.bert_encoder(
        p, jb.BertConfig(**small), i, dtype=jnp.float32))(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(ids))
    got = tb.bert_encoder(tb.bert_params_from_jax(tree),
                          tb.BertConfig(**small), torch.from_numpy(ids),
                          dtype=torch.float32)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=2e-5)
