"""The port's hybrid banded + residual attention (deepspeed_tpu_torch/ops/
sparse_attention/hybrid.py) and the no-mask arity of the row-run kernels
K8-K10 (blocksparse_v2.py with ``tiles=None``, or the structural tiles of
a coarse walk) against the JAX package on the CPU.

The same numpy inputs, made from a seed, go through both. The JAX side
runs its Pallas kernels in interpret mode under ``jax.jit``
(``build_v2_impls(..., has_am=False)``, ``build_hybrid_fn``); the port
runs the plain versions. Tolerances:

- ``detect_banded_subpattern``, ``plan_hybrid``, ``hybrid_stats``: equal,
  bitwise (the residual array, the coverage float, every count);
- K8-K10 without a mask and the hybrid, fp32: atol 2e-5 (JAX's own for
  its sparse kernels; the sums run in another order, and the merge's
  exp/log1p are another library's); bf16: every element within 1e-4 +
  2**-7 |want| (one bf16 ulp) and the whole tensor within a relative RMS
  error of 1e-3.

The CUDA kernels run only on a card: their tests are marked ``cuda`` and
skip here. jax is imported inside the tests that use it: the card's
machine has none.
"""

import numpy as np
import pytest
import torch

import tests.torch_threads  # noqa: F401  (torch threads per xdist worker)

FP32_ATOL = 2e-5
BF16_TOL = dict(atol=1e-4, rtol=2.0**-7, rms=1e-3)


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


def _inputs(rng, B, H, s, d=16):
    return [(rng.randn(B, H, s, d) * 0.5).astype(np.float32)
            for _ in range(4)]


def _causal_residual(n=16, H=2, seed=11):
    """JAX's test_hybrid_matches_oracle_causal_residual layout: a causal
    band with random lower-triangle blocks per head."""
    idx = np.arange(n)
    rb, cb = idx[:, None], idx[None, :]
    pred = (((rb < 1) | (cb < 1) | (np.abs(rb - cb) <= 1)) & (cb <= rb))
    L = np.broadcast_to(pred, (H, n, n)).copy()
    rng = np.random.default_rng(seed)
    for h in range(H):
        for r in range(4, n):
            L[h, r, rng.integers(1, r - 1)] = True
    return L.astype(np.int32)


def _layouts(fb=16, s=256):
    from deepspeed_tpu_torch.ops.sparse_attention import (
        BigBirdSparsityConfig, BSLongformerSparsityConfig,
        VariableSparsityConfig)
    low = (np.random.default_rng(0).random((1, 16, 16)) < 0.5).astype(
        np.int32) | np.eye(16, dtype=np.int32)[None]
    return {
        "bigbird": BigBirdSparsityConfig(
            num_heads=2, block=fb, num_random_blocks=1,
            num_sliding_window_blocks=3, num_global_blocks=1).make_layout(s),
        "bigbird_per_head": BigBirdSparsityConfig(
            num_heads=2, block=fb, different_layout_per_head=True,
            num_random_blocks=1, seed=3).make_layout(s),
        "bigbird_more_random": BigBirdSparsityConfig(
            num_heads=2, block=fb, num_random_blocks=2,
            num_sliding_window_blocks=5, num_global_blocks=2,
            seed=7).make_layout(s),
        "causal_residual": _causal_residual(s // fb),
        "variable": VariableSparsityConfig(
            num_heads=2, block=fb, num_random_blocks=1,
            local_window_blocks=[3], global_block_indices=[0]
        ).make_layout(s),
        "bslongformer": BSLongformerSparsityConfig(
            num_heads=2, block=fb).make_layout(s),
        "low_coverage": low,
    }


# ------------------------------------------------------------ planning
@pytest.mark.parametrize("name", sorted(_layouts()))
def test_subpattern_plan_and_stats_match_jax(name):
    """detect_banded_subpattern, plan_hybrid (CPU tensors against JAX's
    interpret mode, and on the card against JAX compiled at the s8k
    BigBird geometry) and hybrid_stats equal JAX's."""
    from deepspeed_tpu.ops.sparse_attention import hybrid as jh

    from deepspeed_tpu_torch.ops.sparse_attention import hybrid as th
    layout = _layouts()[name]
    ours, theirs = (th.detect_banded_subpattern(layout),
                    jh.detect_banded_subpattern(layout))
    assert (ours is None) == (theirs is None)
    if ours is not None:
        assert tuple(ours[0]) == tuple(theirs[0])
        np.testing.assert_array_equal(ours[1], theirs[1])
        assert ours[1].dtype == theirs[1].dtype and ours[2] == theirs[2]
    ours, theirs = th.plan_hybrid(layout, 16, True), jh.plan_hybrid(
        layout, 16, True)
    assert (ours is None) == (theirs is None)
    if ours is not None:
        assert tuple(ours.params) == tuple(theirs.params)
        assert ours.blocks == theirs.blocks
        assert ours.coverage == theirs.coverage
        np.testing.assert_array_equal(ours.residual, theirs.residual)
        assert th.hybrid_stats(layout, 16, ours) == \
            jh.hybrid_stats(layout, 16, theirs)
    assert name not in ("bslongformer", "low_coverage", "variable") or \
        ours is None


def test_plan_on_the_card_at_the_s8k_geometry():
    """BigBird's defaults at block 128, S 8192 (the s8k row): both plan a
    hybrid with the same split (84.4% coverage, 928 residual blocks); the
    walk tiles are the port's rule's (JAX: its TPU table). A block the
    kernels cannot take (JAX: not a 128-multiple) declines on the card."""
    from deepspeed_tpu.ops.sparse_attention import hybrid as jh

    from deepspeed_tpu_torch.ops.sparse_attention import (
        BigBirdSparsityConfig, hybrid as th)
    from deepspeed_tpu_torch.ops.sparse_attention.banded import \
        KERNEL_BLOCKS
    layout = BigBirdSparsityConfig(num_heads=16, block=128).make_layout(8192)
    ours, theirs = th.plan_hybrid(layout, 128, False), jh.plan_hybrid(
        layout, 128, False)
    assert tuple(ours.params) == tuple(theirs.params)
    assert ours.coverage == theirs.coverage and \
        round(ours.coverage, 3) == 0.844
    assert int(ours.residual.sum()) == 928 == int(theirs.residual.sum())
    assert set(ours.blocks) <= set(KERNEL_BLOCKS)
    odd = BigBirdSparsityConfig(num_heads=2, block=8).make_layout(512)
    assert th.plan_hybrid(odd, 8, False) is None
    assert th.plan_hybrid(odd, 8, True) is not None


def test_detect_subpattern_fuzz_matches_jax():
    """JAX's fuzz of planted banded structure plus random residue: the
    port's detect_banded_subpattern equals JAX's on every trial."""
    from deepspeed_tpu.ops.sparse_attention import hybrid as jh

    from deepspeed_tpu_torch.ops.sparse_attention import hybrid as th
    rng = np.random.default_rng(42)
    detected = 0
    for _ in range(40):
        n = int(rng.integers(4, 24))
        H = int(rng.integers(1, 4))
        g_r = int(rng.integers(0, max(n // 3, 1)))
        g_c = int(rng.integers(0, max(n // 3, 1)))
        w = int(rng.integers(0, max(n // 3, 1)))
        causal = bool(rng.integers(0, 2))
        idx = np.arange(n)
        rb, cb = idx[:, None], idx[None, :]
        clip = (cb <= rb) if causal else np.ones((n, n), bool)
        pred = (((rb < g_r) | (cb < g_c) | (np.abs(rb - cb) <= w)) & clip)
        L = np.broadcast_to(pred, (H, n, n)).copy()
        for h in range(H):
            for _ in range(int(rng.integers(0, 4))):
                r = int(rng.integers(0, n))
                c = int(rng.integers(0, r + 1)) if causal \
                    else int(rng.integers(0, n))
                L[h, r, c] = True
        L = L.astype(np.int32)
        ours, theirs = (th.detect_banded_subpattern(L),
                        jh.detect_banded_subpattern(L))
        assert (ours is None) == (theirs is None)
        if ours is not None:
            detected += 1
            assert tuple(ours[0]) == tuple(theirs[0])
            np.testing.assert_array_equal(ours[1], theirs[1])
            assert ours[2] == theirs[2]
    assert detected >= 30


# ---------------------------------------- K8-K10 without a mask tile
def _jax_v2_nomask(layout, fb, coarse, q, k, v, do, kpm, dtype):
    """o, lse, dq, dk, dv of JAX's K8-K10 without a mask (has_am=False)
    in interpret mode, jitted."""
    import jax
    import jax.numpy as jnp
    from deepspeed_tpu.ops.sparse_attention.blocksparse import _block_kpm
    from deepspeed_tpu.ops.sparse_attention.blocksparse_v2 import \
        build_v2_impls
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    B, H, s, d = q.shape
    fwd, bwd = build_v2_impls(layout, fb, 1.0 / np.sqrt(d), interpret=True,
                              has_am=False, coarse_block=coarse)
    kb = _block_kpm(jnp.zeros((B, s), jnp.float32) if kpm is None
                    else jnp.asarray(kpm), fb)

    @jax.jit
    def run(q, k, v, do):
        o, lse = fwd(q, k, v, kb, None)
        return (o, lse) + bwd(q, k, v, kb, None, o, lse, do)
    out = run(*(jnp.asarray(a).astype(jd) for a in (q, k, v, do)))
    o, lse, dq, dk, dv = (np.asarray(x.astype(jnp.float32)) for x in out)
    return [o, dq, dk, dv, lse.reshape(B, H, s)]


NOMASK_CASES = [
    # (layout, coarse walk, key mask, dtype)
    ("bigbird", None, "mul", "fp32"),
    ("bigbird_per_head", None, None, "bf16"),
    ("variable", None, "add", "fp32"),
    ("bslongformer", 64, "mul", "fp32"),
    ("bigbird_more_random", 128, None, "bf16"),
    ("causal_residual", 32, "mul", "fp32"),
]


@pytest.mark.parametrize("case", range(len(NOMASK_CASES)))
def test_nomask_plain_kernels_match_jax(case):
    """K8 (o, lse), K9 (dq) and K10 (dk, dv) without a user mask as plain
    versions against JAX's ``has_am=False`` kernels in interpret mode (K9
    and K10 get JAX's o and lse): the fine walk reads no tile; a coarse
    walk streams its structural tiles, deduplicated by content
    (per_coord False) and holding bf16 values in both."""
    from deepspeed_tpu_torch.ops.sparse_attention import blocksparse_v2 as tv2
    name, coarse, mode, dtype = NOMASK_CASES[case]
    layout = _layouts(16, 128)[name] if name != "causal_residual" else \
        _causal_residual(8)
    s = layout.shape[1] * 16
    rng = np.random.RandomState(70 + case)
    B, H = 2, layout.shape[0]
    q, k, v, do = _inputs(rng, B, H, s)
    kpm = None
    if mode == "mul":
        keep = np.arange(s)[None, :] < rng.randint(s // 2, s + 1, B)[:, None]
        keep[-1] = False
        kpm = np.where(keep, 0.0, -1e30).astype(np.float32)
    elif mode == "add":
        kpm = rng.randn(B, s).astype(np.float32)
    want = _jax_v2_nomask(layout, 16, coarse, q, k, v, do, kpm, dtype)
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    tq, tk, tv, tdo = (torch.from_numpy(a).to(td) for a in (q, k, v, do))
    plan = tv2.RowRunPlan(layout, 16, coarse, per_coord=False)
    tiles = plan.structural_tiles("cpu")
    assert (tiles is None) == (coarse is None)
    if coarse is not None:
        assert sorted(set(tiles.unique().tolist())) == [
            float(torch.tensor(-1e30).bfloat16().float()), 0.0]
        assert plan.unique_tiles == tv2.build_coarse_index(
            layout, 16, coarse, per_coord=False, count_only=True)[1]
    key = None if kpm is None else torch.from_numpy(kpm)
    scale = 1.0 / np.sqrt(16)
    o, lse = tv2.blocksparse_v2_fwd(tq, tk, tv, key, tiles, plan, scale)
    grads = tv2.row_run_bwd(tq, tk, tv, key, tiles, plan, scale,
                            torch.from_numpy(want[0].copy()).to(td),
                            torch.from_numpy(want[4].copy()), tdo)
    got = [x.float().numpy() for x in (o, *grads)]
    for g, w in zip(got, want[:4]):
        assert np.isfinite(g).all()
        _assert_close(g, w, dtype)
    np.testing.assert_allclose(lse.numpy(), want[4], rtol=1e-6,
                               atol=FP32_ATOL)
    if mode == "mul":
        assert (got[0][-1] == 0).all()


def test_nomask_plan_refuses_a_user_mask():
    """A coarse walk deduplicated by content has no tile per coordinate:
    folding an attention mask into it raises; without its tiles a coarse
    walk's kernels raise too."""
    from deepspeed_tpu_torch.ops.sparse_attention import blocksparse_v2 as tv2
    layout = _layouts(16, 128)["bslongformer"]
    plan = tv2.RowRunPlan(layout, 16, 64, per_coord=False)
    with pytest.raises(ValueError, match="per_coord"):
        plan.mask_tiles(torch.zeros(128, 128))
    q = torch.zeros(1, 2, 128, 16)
    with pytest.raises(ValueError, match="mask tiles"):
        tv2.blocksparse_v2_fwd(q, q, q, None, None, plan, 0.25)


# ----------------------------------------------------------- the hybrid
HYBRID_CASES = [
    # (layout, key mask, dtype)
    ("bigbird", None, "fp32"),
    ("bigbird_per_head", None, "fp32"),
    ("bigbird_more_random", "add", "fp32"),
    ("causal_residual", None, "fp32"),
    ("bigbird", "mul", "fp32"),
    ("bigbird", None, "bf16"),
]


@pytest.mark.parametrize("case", range(len(HYBRID_CASES)))
def test_hybrid_matches_jax(case):
    """build_hybrid_fn: the output and the q/k/v grads against JAX's
    hybrid in interpret mode on the same plan (BigBird, per-head random
    blocks, a causal band with a random residue, a key mask in either
    mode (-1e9 pads in 'add'), bf16), and the port's dispatch picks it
    under USE_MASKED_FLASH = False."""
    import jax
    import jax.numpy as jnp
    from deepspeed_tpu.ops.sparse_attention import hybrid as jh

    from deepspeed_tpu_torch.ops.sparse_attention import blocksparse as tbs
    from deepspeed_tpu_torch.ops.sparse_attention import hybrid as th
    name, mode, dtype = HYBRID_CASES[case]
    layout = _layouts()[name]
    fb, s = 16, layout.shape[1] * 16
    tplan, jplan = th.plan_hybrid(layout, fb, True), jh.plan_hybrid(
        layout, fb, True)
    assert tplan is not None and jplan is not None
    rng = np.random.RandomState(80 + case)
    B, H = 2, layout.shape[0]
    q, k, v, do = _inputs(rng, B, H, s)
    kpm = np.zeros((B, s), np.float32)
    if mode == "add":
        kpm[:, s - 30:] = -1e9
    elif mode == "mul":
        kpm[0, s // 2:] = -1e30
        kpm[1] = -1e30                       # a batch row of pads
    scale = 1.0 / np.sqrt(16)
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    jf = jh.build_hybrid_fn(layout, fb, jplan, scale, interpret=True)
    kb = jnp.asarray(kpm).reshape(B, s // fb, 1, fb).transpose(0, 2, 1, 3)

    @jax.jit
    def run(a, b, c, g):
        o, vjp = jax.vjp(lambda *x: jf(*x, kb), a, b, c)
        return (o,) + vjp(g)[:3]
    want = [np.asarray(x.astype(jnp.float32)) for x in run(
        *(jnp.asarray(a).astype(jd) for a in (q, k, v, do)))]
    f = th.build_hybrid_fn(layout, fb, tplan, scale)
    assert f.kernel_kind == "hybrid"
    args = [torch.from_numpy(a).to(td).requires_grad_() for a in (q, k, v)]
    key = None if mode is None else torch.from_numpy(kpm)
    o = f(*args, key)
    got = [o.detach().float().numpy()] + [
        g.float().numpy() for g in torch.autograd.grad(
            o, args, torch.from_numpy(do).to(td))]
    for g, w in zip(got, want):
        assert np.isfinite(g).all()
        _assert_close(g, w, dtype)
    if mode == "mul":
        assert (got[0][1] == 0).all()
    saved = tbs.USE_MASKED_FLASH
    tbs.USE_MASKED_FLASH = False
    try:
        assert tbs.planned_kernel(layout, fb, cpu=True) == "hybrid"
    finally:
        tbs.USE_MASKED_FLASH = saved


# ------------------------------------------------------- on the card
CUDA_CASES = [
    # (B, H, S, D, block, layout, coarse, key mask, dtype)
    (1, 16, 8192, 64, 128, "bigbird_residual", None, None, "bf16"),
    (8, 16, 2048, 64, 16, "fixed_main", None, "mul", "bf16"),
    (8, 16, 2048, 64, 16, "fixed_main", 64, "mul", "bf16"),
    (2, 4, 512, 32, 16, "bigbird", 128, None, "fp32"),
    (2, 4, 512, 128, 32, "bigbird", None, "mul", "fp32"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CUDA_CASES)
def test_cuda_nomask_kernels_match_plain(case):
    """K8, K9 and K10 without a mask tile (and with a coarse walk's
    structural tiles) on the card against their plain versions on the
    same inputs: the hybrid's residue at the s8k BigBird geometry, the
    fixed per-head layouts of ds_config_sparse.json at S 2048, fine and
    at a forced walk of 64."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import json
    import pathlib

    from deepspeed_tpu_torch.ops.sparse_attention import (
        BigBirdSparsityConfig, blocksparse_v2 as tv2, hybrid as th,
        sparsity_config_from_dict)
    B, H, s, d, fb, name, coarse, mode, dtype = case
    if name == "fixed_main":
        raw = json.loads((pathlib.Path(__file__).resolve().parents[1] /
                          "examples/bing_bert/ds_config_sparse.json"
                          ).read_text())["sparse_attention"]
        layout = sparsity_config_from_dict(raw, num_heads=H).make_layout(s)
    else:
        layout = BigBirdSparsityConfig(num_heads=H, block=fb).make_layout(s)
        if name == "bigbird_residual":
            layout = th.plan_hybrid(layout, fb, False).residual
    plan = tv2.RowRunPlan(layout, fb, coarse, per_coord=False)
    tiles = plan.structural_tiles("cuda")
    rng = np.random.RandomState(s + d)
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    q, k, v, do = (torch.from_numpy(a).to("cuda", td)
                   for a in _inputs(rng, B, H, s, d))
    key = None
    if mode == "mul":
        keep = np.arange(s)[None, :] < rng.randint(s // 2, s + 1, B)[:, None]
        keep[-1] = False
        key = torch.from_numpy(np.where(keep, 0.0, -1e30).astype(
            np.float32)).cuda()
    scale = 1.0 / np.sqrt(d)
    o, lse = tv2.blocksparse_v2_fwd(q, k, v, key, tiles, plan, scale)
    o_p, lse_p = tv2.blocksparse_v2_fwd_plain(q, k, v, key, tiles, plan,
                                              scale)
    delta = (do.float() * o_p.float()).sum(-1)
    args = (q, k, v, do, lse_p, delta, key, tiles, plan, scale)
    got = [o, tv2.blocksparse_v2_dq(*args), *tv2.blocksparse_v2_dkv(*args)]
    torch.cuda.synchronize()
    want = [o_p, tv2.blocksparse_v2_dq_plain(*args),
            *tv2.blocksparse_v2_dkv_plain(*args)]
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        a, b = a.float().cpu().numpy(), b.float().cpu().numpy()
        if dtype == "fp32":
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-4)
        else:
            ratio, rel_rms, ok = _bf16_check(a, b, **BF16_TOL)
            assert ok, (ratio, rel_rms)
    assert float((lse - lse_p).abs().max()) <= 1e-3
