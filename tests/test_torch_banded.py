"""The port's banded block-sparse attention (deepspeed_tpu_torch/ops/
sparse_attention/banded.py, K11-K13) and the legacy dispatch of
blocksparse.py (``USE_MASKED_FLASH = False``) against the JAX package on
the CPU.

The same numpy inputs, made from a seed, go through both. The JAX side
runs its Pallas kernels K11-K13 (``build_banded_impls(...,
interpret=True)``, under ``jax.jit``) in interpret mode; the port runs
their plain versions. Every module flag is restored by a fixture.
Tolerances:

- the host arithmetic (extents, ``walk_stats``, ``pick_blocks`` on CPU
  tensors and under ``_FORCE_BLOCKS``, ``plan``, ``planned_kernel``):
  equal, bitwise;
- K11-K13 and the front end, fp32: atol 2e-5 (JAX's own for its sparse
  kernels; the sums run in another order); bf16: every element within
  1e-4 + 2**-7 |want| (one bf16 ulp: both sides round the same fp32
  values) and the whole tensor within a relative RMS error of 1e-3;
- the sparse BERT MLM loss, fp32: loss rtol 1e-5, each grad within 1e-4
  of its largest entry (``test_torch_sparse_attention.py``'s).

The CUDA kernels run only on a card: their tests are marked ``cuda`` and
skip here. jax is imported inside the tests that use it: the card's
machine has none.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

FP32_ATOL = 2e-5
BF16_TOL = dict(atol=1e-4, rtol=2.0**-7, rms=1e-3)
REPO = pathlib.Path(__file__).resolve().parents[1]


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


@pytest.fixture
def legacy():
    """Both packages' legacy dispatch (``USE_MASKED_FLASH = False``),
    every flag and ``_FORCE_BLOCKS`` restored afterwards, the function
    caches cleared before and after."""
    from deepspeed_tpu.ops.sparse_attention import banded as jb
    from deepspeed_tpu.ops.sparse_attention import blocksparse as jbs

    from deepspeed_tpu_torch.ops.sparse_attention import banded as tb
    from deepspeed_tpu_torch.ops.sparse_attention import blocksparse as tbs
    names = ("USE_MASKED_FLASH", "USE_SPLASH_V2", "USE_BANDED", "USE_HYBRID",
             "USE_COARSE", "_FORCE_COARSE_BLOCK")
    saved = [(m, n, getattr(m, n)) for m in (jbs, tbs) for n in names] + \
        [(m, "_FORCE_BLOCKS", m._FORCE_BLOCKS) for m in (jb, tb)]
    for m in (jbs, tbs):
        m._FN_CACHE.clear()
        m.USE_MASKED_FLASH = False
    yield jbs, tbs
    for m, n, value in saved:
        setattr(m, n, value)
    jbs._FN_CACHE.clear()
    tbs._FN_CACHE.clear()


def make_banded_layout(H, n, g_r, g_c, w, causal):
    idx = np.arange(n)
    rb, cb = idx[:, None], idx[None, :]
    pred = (rb < g_r) | (cb < g_c) | (np.abs(rb - cb) <= w)
    if causal:
        pred = pred & (cb <= rb)
    return np.broadcast_to(pred.astype(np.int32), (H, n, n)).copy()


# JAX's test_geometry_parity (tests/unit/test_banded_attention.py:198)
GEOMETRIES = [(1, 1, 1, False), (2, 2, 2, True), (0, 0, 1, False),
              (0, 0, 2, True), (3, 3, 1, False), (2, 0, 1, False),
              (0, 2, 1, True), (1, 1, 0, True)]


# ------------------------------------------------------ host arithmetic
@pytest.mark.parametrize("S, fb", [(512, 32), (256, 16), (8192, 128),
                                   (2048, 16)])
@pytest.mark.parametrize("geom", GEOMETRIES)
def test_host_arithmetic_matches_jax(geom, S, fb):
    """The extents, the global-row walk, walk_stats (with and without the
    active-block count) and pick_blocks on CPU tensors (JAX's interpret
    rule) equal JAX's at every tile pair the kernels take."""
    from deepspeed_tpu.ops.sparse_attention import banded as jb

    from deepspeed_tpu_torch.ops.sparse_attention import banded as tb
    g_r, g_c, w, causal = geom
    p_j, p_t = jb.BandedParams(*geom), tb.BandedParams(*geom)
    nnz = int(make_banded_layout(1, S // fb, *geom)[0].sum())
    for bq in (16, 32, 64, 128):
        for bkv in (16, 32, 64, 128):
            for ours, theirs in (
                    (tb._band_extents(S, fb, w, causal, bq, bkv),
                     jb._band_extents(S, fb, w, causal, bq, bkv)),
                    (tb._band_dkv_extents(S, fb, w, causal, bq, bkv),
                     jb._band_dkv_extents(S, fb, w, causal, bq, bkv))):
                for a, b in zip(ours, theirs):
                    np.testing.assert_array_equal(a, b)
            assert tb._gr_kv_walk(S, fb, g_r, causal, bkv) == \
                jb._gr_kv_walk(S, fb, g_r, causal, bkv)
            for n in (None, nnz):
                assert tb.walk_stats(S, fb, p_t, bq, bkv, n) == \
                    jb.walk_stats(S, fb, p_j, bq, bkv, n)
    assert tb.pick_blocks(S, fb, p_t, True) == \
        jb.pick_blocks(S, fb, p_j, True)


def test_pick_blocks_force_and_card_rule(legacy):
    """_FORCE_BLOCKS first when it divides S (JAX's), else the rule; on
    the card only tiles the kernels take, the one of least modeled cost
    (a deliberate difference: JAX reads a TPU-measured table, then a
    128-multiple heuristic of at most 256)."""
    from deepspeed_tpu.ops.sparse_attention import banded as jb

    from deepspeed_tpu_torch.ops.sparse_attention import banded as tb
    p_j, p_t = jb.BandedParams(1, 1, 1, False), tb.BandedParams(1, 1, 1,
                                                                False)
    for force in ((96, 96), (64, 128), (128, 64), (32, 32)):
        jb._FORCE_BLOCKS = tb._FORCE_BLOCKS = force
        assert tb.pick_blocks(256, 32, p_t, True) == \
            jb.pick_blocks(256, 32, p_j, True)
    tb._FORCE_BLOCKS = (256, 256)           # divides S, not a kernel tile
    assert tb.pick_blocks(512, 32, p_t, True) == (256, 256)
    got = tb.pick_blocks(512, 32, p_t, False)
    assert got != (256, 256) and set(got) <= set(tb.KERNEL_BLOCKS)
    tb._FORCE_BLOCKS = None
    costs = {(a, b): tb.walk_cost(8192, 128, p_t, a, b)
             for a in tb.KERNEL_BLOCKS for b in tb.KERNEL_BLOCKS}
    assert tb.pick_blocks(8192, 128, p_t, False) == min(costs,
                                                         key=costs.get)
    # no kernel tile divides S 200
    assert tb.pick_blocks(200, 8, p_t, False) is None
    assert tb.plan(make_banded_layout(1, 25, 1, 1, 1, False), 8,
                   False) is None


def _sweep_layouts():
    from deepspeed_tpu_torch.ops.sparse_attention import (
        BigBirdSparsityConfig, BSLongformerSparsityConfig,
        DenseSparsityConfig, FixedSparsityConfig, VariableSparsityConfig)
    out = {}
    for fb, s in ((16, 256), (32, 512)):
        out[f"dense_{fb}"] = DenseSparsityConfig(
            num_heads=2, block=fb).make_layout(s)
        out[f"fixed_{fb}"] = FixedSparsityConfig(
            num_heads=2, block=fb, num_local_blocks=4).make_layout(s)
        out[f"variable_{fb}"] = VariableSparsityConfig(
            num_heads=2, block=fb, num_random_blocks=1,
            local_window_blocks=[3]).make_layout(s)
        out[f"bslongformer_{fb}"] = BSLongformerSparsityConfig(
            num_heads=2, block=fb).make_layout(s)
        out[f"bigbird_{fb}"] = BigBirdSparsityConfig(
            num_heads=2, block=fb, num_random_blocks=1).make_layout(s)
        out[f"bigbird_per_head_{fb}"] = BigBirdSparsityConfig(
            num_heads=2, block=fb, different_layout_per_head=True,
            num_random_blocks=2).make_layout(s)
    out["pure_global"] = np.broadcast_to(
        ((np.arange(8)[:, None] < 2) | (np.arange(8)[None, :] < 2)
         ).astype(np.int32), (2, 8, 8)).copy()
    return out


FLAG_SETS = [{}, {"USE_BANDED": False}, {"USE_HYBRID": False},
             {"USE_COARSE": False}, {"USE_SPLASH_V2": False},
             {"USE_BANDED": False, "USE_COARSE": False}]


@pytest.mark.parametrize("flags", FLAG_SETS)
def test_planned_kernel_matches_jax(legacy, flags):
    """planned_kernel on CPU tensors under the flags names JAX's route in
    interpret mode for dense, fixed, Variable, BSLongformer and BigBird
    layouts, and banded.plan gives JAX's (params, tiles). The coarse
    walks differ by design (the port's candidates 128/64/32 and costs
    against JAX's 512/256): where JAX names a v2 walk, the port names the
    v2 walk its own rule picks."""
    from deepspeed_tpu.ops.sparse_attention import banded as jb

    from deepspeed_tpu_torch.ops.sparse_attention import banded as tb
    jbs, tbs = legacy
    for name, value in flags.items():
        setattr(jbs, name, value)
        setattr(tbs, name, value)
    routes = set()
    for name, layout in _sweep_layouts().items():
        fb = 256 // layout.shape[1] if name == "pure_global" else \
            int(name.rsplit("_", 1)[1])
        theirs = jbs.planned_kernel(layout, fb, interpret=True)
        ours = tbs.planned_kernel(layout, fb, cpu=True)
        if theirs.startswith("v2"):
            coarse = tbs._pick_coarse_block(layout, fb, False)
            assert ours == (f"v2-coarse{coarse}" if coarse else "v2")
        else:
            assert ours == theirs, (name, ours, theirs)
        routes.add(ours)
        pj, pt = jb.plan(layout, fb, True), tb.plan(layout, fb, True)
        assert (pj is None) == (pt is None)
        if pj is not None:
            assert tuple(pt[0]) == tuple(pj[0]) and pt[1] == pj[1]
    if not flags:
        assert {"banded", "hybrid", "v2"} <= routes
    if flags == {"USE_SPLASH_V2": False}:
        assert "v1" in routes


# ------------------------------------------- K11-K13, plain vs Pallas
def _inputs(rng, B, H, s, d=16):
    return [(rng.randn(B, H, s, d) * 0.5).astype(np.float32)
            for _ in range(4)]


def _key_mask(rng, B, s, mode):
    """None, or an additive (B, S) fp32 key mask: 'mul' -1e30 on the pads
    of random lengths, the last batch row all pads; 'add' N(0, 2)."""
    if mode is None:
        return None
    if mode == "add":
        return (rng.randn(B, s) * 2).astype(np.float32)
    keep = (np.arange(s)[None, :] < rng.randint(s // 3, s + 1, B)[:, None])
    keep[-1] = False
    return np.where(keep, 0.0, -1e30).astype(np.float32)


def _jax_banded(params, fb, blocks, q, k, v, do, kpm, dtype):
    """o, lse_band, lse_gr, dq, dk, dv of JAX's K11-K13 in interpret mode,
    jitted: fwd_impl, then bwd_impl on its o and lses."""
    import jax
    import jax.numpy as jnp
    from deepspeed_tpu.ops.sparse_attention import banded as jb
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    B, H, s, d = q.shape
    fwd, bwd = jb.build_banded_impls(H, s, fb, jb.BandedParams(*params),
                                     1.0 / np.sqrt(d), *blocks,
                                     interpret=True)
    km = jnp.zeros((B, s), jnp.float32) if kpm is None else jnp.asarray(kpm)

    @jax.jit
    def run(q, k, v, do, km):
        o, lse_b, lse_g = fwd(q, k, v, km)
        return (o, lse_b, lse_g) + bwd(q, k, v, km, o, lse_b, lse_g, do)
    out = run(*(jnp.asarray(a).astype(jd) for a in (q, k, v, do)), km)
    o, lse_b, lse_g, dq, dk, dv = (np.asarray(x.astype(jnp.float32))
                                   for x in out)
    return {"o": o, "lse_b": lse_b.reshape(B, H, -1),
            "lse_g": lse_g.reshape(B, H, -1), "dq": dq, "dk": dk, "dv": dv}


def _port_banded(params, fb, blocks, q, k, v, do, kpm, dtype, want=None):
    """The port's K11 instances (plain versions), and K12, K13 fed
    ``want``'s o and lses (its own by default)."""
    from deepspeed_tpu_torch.ops.sparse_attention import banded as tb
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    tq, tk, tv, tdo = (torch.from_numpy(a).to(td) for a in (q, k, v, do))
    B, H, s, d = q.shape
    bp = tb.BandedPlan(H, s, fb, tb.BandedParams(*params), *blocks)
    key = None if kpm is None else torch.from_numpy(kpm)
    scale = 1.0 / np.sqrt(d)
    o, lse_b, lse_g = tb.banded_fwd_impl(tq, tk, tv, key, bp, scale)
    if want is not None:
        o = torch.from_numpy(want["o"].copy()).to(td)
        lse_b = torch.from_numpy(want["lse_b"].copy())
        lse_g = torch.from_numpy(want["lse_g"].copy())
    got = {"o": o, "lse_b": lse_b, "lse_g": lse_g}
    got["dq"], got["dk"], got["dv"] = tb.banded_bwd_impl(
        tq, tk, tv, key, bp, scale, o, lse_b, lse_g, tdo)
    if want is not None:
        got["o"] = tb.banded_fwd_impl(tq, tk, tv, key, bp, scale)[0]
    return {n: x.float().numpy() for n, x in got.items()}


KERNEL_CASES = [
    # (geometry, fb, S, tiles, key mask, dtype): the eight geometries at
    # JAX's fine block and tile, then the tile shapes, then bf16
    (GEOMETRIES[0], 32, 512, (64, 64), None, "fp32"),
    (GEOMETRIES[1], 32, 512, (64, 64), "mul", "fp32"),
    (GEOMETRIES[2], 32, 512, (64, 64), "add", "fp32"),
    (GEOMETRIES[3], 32, 512, (64, 64), None, "fp32"),
    (GEOMETRIES[4], 32, 512, (64, 64), "mul", "fp32"),
    (GEOMETRIES[5], 32, 512, (64, 64), "add", "fp32"),
    (GEOMETRIES[6], 32, 512, (64, 64), "mul", "fp32"),
    (GEOMETRIES[7], 32, 512, (64, 64), None, "fp32"),
    ((1, 1, 1, False), 32, 256, (32, 32), "add", "fp32"),
    ((1, 1, 1, False), 32, 256, (64, 128), "mul", "fp32"),
    ((2, 1, 2, True), 16, 256, (128, 64), None, "fp32"),
    ((1, 1, 2, False), 16, 256, (32, 64), "mul", "bf16"),
]


@pytest.mark.parametrize("case", range(len(KERNEL_CASES)))
def test_plain_kernels_match_jax(case):
    """K11 (o, lse_band, lse_gr), K12 (dq) and K13 (dk, dv) as plain
    versions against JAX's Pallas kernels in interpret mode on the same
    inputs (K12 and K13 get JAX's o and lses): global rows only, columns
    only, band only, causal clips, a diagonal-only band, global prefixes
    wider than a tile, tiles wider than the fine block and bq != bkv,
    key masks 'add', 'mul' (with a batch row of pads: o = 0 there) and
    none."""
    geom, fb, s, blocks, mode, dtype = KERNEL_CASES[case]
    rng = np.random.RandomState(case)
    B, H = 2, 2
    q, k, v, do = _inputs(rng, B, H, s)
    kpm = _key_mask(rng, B, s, mode)
    want = _jax_banded(geom, fb, blocks, q, k, v, do, kpm, dtype)
    got = _port_banded(geom, fb, blocks, q, k, v, do, kpm, dtype, want)
    for name in ("o", "dq", "dk", "dv"):
        assert np.isfinite(got[name]).all()
        _assert_close(got[name], want[name], dtype)
    for name in ("lse_b", "lse_g"):
        assert got[name].shape == want[name].shape
        np.testing.assert_allclose(got[name], want[name], rtol=1e-6,
                                   atol=FP32_ATOL)
    if mode == "mul":
        assert (got["o"][-1] == 0).all() and (want["o"][-1] == 0).all()


def test_plain_versions_without_the_predicate_fail():
    """The control: with the keep predicate dropped (every walked cell
    kept) the plain versions fail the fp32 check against JAX on every
    output."""
    from deepspeed_tpu_torch.ops.sparse_attention import banded as tb
    geom, fb, s, blocks = (1, 1, 1, False), 32, 256, (64, 64)
    rng = np.random.RandomState(40)
    q, k, v, do = _inputs(rng, 2, 2, s)
    want = _jax_banded(geom, fb, blocks, q, k, v, do, None, "fp32")
    keep = tb.BandedPlan.keep
    try:
        tb.BandedPlan.keep = lambda self, pred, rb, cb: (rb >= 0) & (cb >= 0)
        got = _port_banded(geom, fb, blocks, q, k, v, do, None, "fp32",
                           want)
    finally:
        tb.BandedPlan.keep = keep
    for name in ("o", "dq", "dk", "dv"):
        with pytest.raises(AssertionError):
            _assert_close(got[name], want[name], "fp32")


def test_instances_and_launches():
    """The instances of each walk (JAX's: fwd/dq band and gr, dkv band,
    gc and gr, each only where its prefix exists), one wrapper call per
    instance, and the computed chunks of the BSLongformer layout of the
    s8k geometry (block 128, window 3: every kept 128 x 128 block holds
    16 chunks of 32 x 32); the backward refuses the lse of other rows."""
    from deepspeed_tpu_torch.ops.sparse_attention import (
        BSLongformerSparsityConfig, banded as tb)
    bp = tb.BandedPlan(2, 512, 32, tb.BandedParams(2, 0, 1, False), 64, 64)
    assert set(bp.instances["row"]) == {"band", "gr"}
    assert set(bp.instances["col"]) == {"band", "gr"}
    bp = tb.BandedPlan(2, 512, 32, tb.BandedParams(0, 2, 1, True), 64, 64)
    assert set(bp.instances["row"]) == {"band"}
    assert set(bp.instances["col"]) == {"band", "gc"}
    layout = BSLongformerSparsityConfig(
        num_heads=1, block=128, num_sliding_window_blocks=3).make_layout(8192)
    p = tb.detect_banded(layout)
    bp = tb.BandedPlan(1, 8192, 128, p, 128, 128)
    chunks = bp.computed_chunks()
    kept = int(layout.sum())
    assert chunks["row band"] + chunks["row gr"] == 16 * kept
    assert sum(v for n, v in chunks.items() if n.startswith("col")) == \
        16 * kept
    rng = np.random.RandomState(1)
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(rng, 1, 2, 512))
    tb.reset_launches()
    bp = tb.BandedPlan(2, 512, 32, tb.BandedParams(1, 1, 1, False), 64, 64)
    o, lse_b, lse_g = tb.banded_fwd_impl(q, k, v, None, bp, 0.25)
    tb.banded_bwd_impl(q, k, v, None, bp, 0.25, o, lse_b, lse_g, do)
    # the plain versions on CPU tensors count no launch
    assert (tb.banded_fwd.launches, tb.banded_dq.launches,
            tb.banded_dkv.launches) == (0, 0, 0)
    assert lse_g.shape == (1, 2, 64)
    # the backward takes the lse of the rows its instance reads
    delta = (do * o).sum(-1)
    with pytest.raises(ValueError, match="lse"):
        tb.banded_dkv(q, k, v, do, lse_b, delta, None, bp, "gr", 0.25)
    with pytest.raises(ValueError, match="lse"):
        tb.banded_dq(q, k, v, do, lse_g, delta, None, bp, "band", 0.25)


# ------------------------------------------------------- the front end
def _front_layout(name):
    from deepspeed_tpu_torch.ops.sparse_attention import (
        BSLongformerSparsityConfig, FixedSparsityConfig,
        VariableSparsityConfig)
    if name == "bslongformer":
        return BSLongformerSparsityConfig(num_heads=2,
                                          block=32).make_layout(256)
    if name == "causal_band":
        return make_banded_layout(2, 8, 1, 1, 1, True)
    if name == "fixed":
        return FixedSparsityConfig(num_heads=2, block=32,
                                   num_local_blocks=4).make_layout(256)
    return VariableSparsityConfig(num_heads=2, block=32, num_random_blocks=1,
                                  local_window_blocks=[3]).make_layout(256)


FRONT_CASES = [
    # (layout, key mask mode, dtype, route, forced coarse walk)
    ("bslongformer", "mul", "fp32", "banded", None),
    ("causal_band", "add", "fp32", "banded", None),
    ("bslongformer", None, "bf16", "banded", None),
    ("fixed", "add", "fp32", "v2", None),
    ("variable", "mul", "fp32", "hybrid", None),
    ("fixed", None, "fp32", "v2-coarse128", 128),
]


@pytest.mark.parametrize("case", range(len(FRONT_CASES)))
def test_block_sparse_attention_legacy_matches_jax(legacy, case):
    """block_sparse_attention under USE_MASKED_FLASH = False on both
    sides: output and q/k/v grads against JAX's dispatch in interpret
    mode, on the banded route, the v2 route (fine and coarse walks forced
    on both; a coarse walk's structural tiles hold bf16 values in both)
    and with a key mask in either mode."""
    import jax
    import jax.numpy as jnp
    jbs, tbs = legacy
    name, mode, dtype, route, coarse = FRONT_CASES[case]
    # the walk forced on both (0: the fine walk): the rules' candidates
    # differ by design
    jbs._FORCE_COARSE_BLOCK = tbs._FORCE_COARSE_BLOCK = coarse or 0
    layout = _front_layout(name)
    B, H, s = 2, 2, layout.shape[1] * 32
    assert tbs.planned_kernel(layout, 32, cpu=True) == route == \
        jbs.planned_kernel(layout, 32, interpret=True)
    rng = np.random.RandomState(60 + case)
    q, k, v, do = _inputs(rng, B, H, s)
    kw_j, kw_t = {}, {}
    if mode is not None:
        keep = (np.arange(s)[None, :] < rng.randint(s // 2, s + 1, B)[:, None])
        kpm = (keep.astype(np.float32) if mode == "mul"
               else np.where(keep, 0.0, -1e9).astype(np.float32))
        kw_j = dict(key_padding_mask=jnp.asarray(kpm),
                    key_padding_mask_mode=mode)
        kw_t = dict(key_padding_mask=torch.from_numpy(kpm),
                    key_padding_mask_mode=mode)
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    td = torch.bfloat16 if dtype == "bf16" else torch.float32

    @jax.jit
    def run(a, b, c, g):
        o, vjp = jax.vjp(lambda *x: jbs.block_sparse_attention(
            *x, layout, interpret=True, **kw_j), a, b, c)
        return (o,) + vjp(g)
    want = [np.asarray(x.astype(jnp.float32)) for x in run(
        *(jnp.asarray(a).astype(jd) for a in (q, k, v, do)))]
    args = [torch.from_numpy(a).to(td).requires_grad_() for a in (q, k, v)]
    o = tbs.block_sparse_attention(*args, layout, **kw_t)
    got = [o.detach().float().numpy()] + [
        g.float().numpy() for g in torch.autograd.grad(
            o, args, torch.from_numpy(do).to(td))]
    for g, w in zip(got, want):
        assert np.isfinite(g).all()
        _assert_close(g, w, dtype)


def test_v1_route_runs(legacy):
    """USE_SPLASH_V2 = False reaches the v1 kernels K14-K16 for a layout
    that is not banded: the fixed layout plans 'v1' in both packages, and
    the port's output, without and with an attention mask, equals JAX's
    interpret-mode kernels. A banded layout still runs K11-K13, as in
    JAX."""
    import jax.numpy as jnp
    jbs, tbs = legacy
    tbs.USE_SPLASH_V2 = jbs.USE_SPLASH_V2 = False
    fixed, band = _front_layout("fixed"), _front_layout("bslongformer")
    assert tbs.planned_kernel(fixed, 32, cpu=True) == "v1" == \
        jbs.planned_kernel(fixed, 32, interpret=True)
    rng = np.random.RandomState(70)
    q, k, v, _ = _inputs(rng, 1, 2, 256)
    am = (rng.rand(256, 256) > 0.2).astype(np.float32)
    for kw in ({}, {"attn_mask": am}):
        want = np.asarray(jbs.block_sparse_attention(
            *(jnp.asarray(a) for a in (q, k, v)), fixed, interpret=True,
            **{n: jnp.asarray(a) for n, a in kw.items()}))
        got = tbs.block_sparse_attention(
            *(torch.from_numpy(a) for a in (q, k, v)), fixed,
            **{n: torch.from_numpy(a) for n, a in kw.items()})
        _assert_close(got.numpy(), want, "fp32")
    assert tbs.planned_kernel(band, 32, cpu=True) == "banded"
    zero = torch.zeros(1, 2, 256, 16)
    assert torch.isfinite(tbs.block_sparse_attention(zero, zero, zero,
                                                     band)).all()


def test_card_rule_conditions(legacy):
    """On the card (``cpu=False``) the port asks for a block the kernels
    take where JAX asks for a 128-multiple: BSLongformer at block 16
    plans banded at a kernel tile pair, BigBird at block 16 plans the
    hybrid (JAX's compiled dispatch declines it), and a block the kernels
    cannot take (8) falls back as JAX's compiled dispatch does."""
    from deepspeed_tpu.ops.sparse_attention import banded as jb

    from deepspeed_tpu_torch.ops.sparse_attention import (
        BigBirdSparsityConfig, BSLongformerSparsityConfig,
        FixedSparsityConfig, banded as tb)
    jbs, tbs = legacy
    bert = BSLongformerSparsityConfig(num_heads=16,
                                      block=16).make_layout(2048)
    got = tb.plan(bert, 16, False)
    assert got is not None and set(got[1]) <= set(tb.KERNEL_BLOCKS)
    assert tuple(got[0]) == tuple(jb.plan(bert, 16, False)[0])
    assert tbs.planned_kernel(bert, 16) == "banded"
    odd = FixedSparsityConfig(num_heads=2, block=8,
                              num_local_blocks=4).make_layout(120)
    assert tbs.planned_kernel(odd, 8) == "masked-fallback" == \
        jbs.planned_kernel(odd, 8)
    assert tbs.planned_kernel(odd, 8, cpu=True) == "v2"
    # BigBird at block 16: the port's hybrid walks its residue on K8-K10,
    # JAX's compiled dispatch declines a block that is no 128-multiple
    bigbird = BigBirdSparsityConfig(num_heads=2, block=16).make_layout(512)
    assert tbs.planned_kernel(bigbird, 16) == "hybrid"
    assert jbs.planned_kernel(bigbird, 16) != "hybrid"


# ------------------------------------------------- sparse BERT, legacy
TINY = dict(vocab_size=97, hidden_size=64, num_layers=2, num_heads=4,
            intermediate_size=128, max_position_embeddings=128)


def test_mlm_loss_legacy_dispatch_matches_jax(legacy):
    """bert_mlm_loss_fn with the BSLongformer sparse_attention of
    ds_config_sparse.json (block 16, S 128) under USE_MASKED_FLASH = False
    on both sides, fp32, on a padded batch: the banded route, loss and
    every grad."""
    import jax
    import jax.numpy as jnp
    from deepspeed_tpu.models import bert as jb
    from deepspeed_tpu.ops.sparse_attention import \
        sparsity_config_from_dict as jfrom
    from deepspeed_tpu.runtime.config import get_sparse_attention

    from deepspeed_tpu_torch.models import bert as tb
    from deepspeed_tpu_torch.ops.sparse_attention import \
        sparsity_config_from_dict as tfrom
    from deepspeed_tpu_torch.utils.tree import tree_leaves
    jbs, tbs = legacy
    raw = json.loads((REPO / "examples/bing_bert/ds_config_sparse.json"
                      ).read_text())
    raw["sparse_attention"] = {"mode": "bslongformer"}
    sa = get_sparse_attention(raw)
    jsc, tsc = jfrom(sa, num_heads=4), tfrom(sa, num_heads=4)
    s = TINY["max_position_embeddings"]
    assert tbs.planned_kernel(tsc.make_layout(s), 16, cpu=True) == \
        "banded" == jbs.planned_kernel(jsc.make_layout(s), 16,
                                       interpret=True)
    jcfg, tcfg = jb.BertConfig(**TINY), tb.BertConfig(**TINY)
    tree = jax.tree_util.tree_map(
        np.asarray, jb.init_bert_params(jcfg, jax.random.PRNGKey(1)))
    rng = np.random.RandomState(2)
    ids = rng.randint(0, TINY["vocab_size"], (2, s)).astype(np.int32)
    am = (np.arange(s)[None, :] < np.array([[70], [s]])).astype(np.int32)
    labels = np.where((rng.rand(2, s) < 0.3) & (am == 1), ids,
                      -100).astype(np.int32)
    batch = {"input_ids": ids, "attention_mask": am, "labels": labels}
    jloss = jb.bert_mlm_loss_fn(jcfg, dtype=jnp.float32, deterministic=True,
                                sparsity_config=jsc)
    jv, jg = jax.jit(jax.value_and_grad(lambda p: jloss(
        p, {k: jnp.asarray(v) for k, v in batch.items()}, None)))(
        jax.tree_util.tree_map(jnp.asarray, tree))
    params = tb.bert_params_from_jax(tree)
    leaves = list(tree_leaves(params))
    for t in leaves:
        t.requires_grad_()
    tloss = tb.bert_mlm_loss_fn(tcfg, dtype=torch.float32,
                                deterministic=True, sparsity_config=tsc)
    tv = tloss(params, {k: torch.from_numpy(v) for k, v in batch.items()},
               None)
    tg = torch.autograd.grad(tv, leaves)
    want = [np.asarray(w, np.float32) for w in jax.tree_util.tree_leaves(jg)]
    assert len(want) == len(tg)
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5)
    for g, w in zip(tg, want):
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g.numpy() - w).max()) <= 1e-4 * scale


# ------------------------------------------------------- on the card
CUDA_CASES = [
    # (B, H, S, D, fine block, geometry, tiles, key mask, dtype, kv tiles
    # per split of K11's and K12's gr walks, q tiles per split of K13's gc
    # walk: None = the kernels' own, fwd_split / dkv_split)
    (1, 16, 8192, 64, 128, (1, 1, 1, False), None, None, "bf16", None,
     None),
    (8, 16, 2048, 64, 16, (1, 1, 1, False), None, "mul", "bf16", None,
     None),
    (2, 4, 512, 64, 32, (2, 2, 2, True), (64, 128), "add", "fp32", None,
     None),
    (2, 4, 512, 64, 32, (3, 3, 1, False), (128, 64), "mul", "bf16", None,
     None),
    (2, 4, 512, 32, 16, (0, 2, 1, True), (16, 32), None, "fp32", None,
     None),
    (2, 4, 512, 128, 32, (1, 1, 0, True), (32, 16), "mul", "bf16", None,
     None),
    # the split walks: one tile a split, uneven last splits, a causal walk
    # whose global rows and columns are wider than a tile, one warp a CTA
    # at bq != bkv, head dim 128
    (2, 4, 512, 64, 32, (1, 1, 1, False), (64, 64), "mul", "bf16", 1, 1),
    (2, 4, 512, 64, 32, (1, 1, 1, False), (32, 32), "add", "bf16", 3, 5),
    (2, 4, 512, 64, 32, (3, 3, 1, True), (64, 32), None, "bf16", 2, 3),
    (2, 4, 512, 64, 16, (2, 1, 1, False), (16, 32), "mul", "bf16", 4, 7),
    (2, 4, 512, 128, 32, (2, 3, 1, True), (128, 64), "add", "bf16", 3, 2),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CUDA_CASES)
def test_cuda_kernels_match_plain(case):
    """K11, K12 and K13 on the card, every instance, against their plain
    versions on the same inputs (K11's and K12's gr instances and K13's
    gc instance against the plain versions split as the kernels split
    them; K12 and K13 take the plain forward's lses): the s8k
    BSLongformer geometry at the rule's tiles, sparse BERT's BSLongformer
    with its key mask, JAX's geometries at asymmetric tiles, and forced
    splits of the gr and gc walks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from deepspeed_tpu_torch.ops.sparse_attention import banded as tb
    B, H, s, d, fb, geom, blocks, mode, dtype, kps, qps = case
    params = tb.BandedParams(*geom)
    blocks = blocks or tb.pick_blocks(s, fb, params, False)
    bp = tb.BandedPlan(H, s, fb, params, *blocks)
    rng = np.random.RandomState(s + d)
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    q, k, v, do = (torch.from_numpy(a).to("cuda", td)
                   for a in _inputs(rng, B, H, s, d))
    kpm = _key_mask(rng, B, s, mode)
    key = None if kpm is None else torch.from_numpy(kpm).cuda()
    scale = 1.0 / np.sqrt(d)
    lses, outs = {}, {}
    for kind in bp.instances["row"]:
        split = kps if kind == "gr" else None
        o, lse = tb.banded_fwd(q, k, v, key, bp, kind, scale,
                               kv_tiles_per_split=split)
        outs[kind], lses[kind] = tb.banded_fwd_plain(
            q, k, v, key, bp, kind, scale,
            kv_tiles_per_split=split or tb.fwd_split(q, bp, kind))
        assert float((lse - lses[kind]).abs().max()) <= 1e-3
        _check_pairs([(o, outs[kind])], dtype)
    o = outs["band"]
    if "gr" in outs:
        o = tb._add_rows(o, outs["gr"])
    delta = (do.float() * o.float()).sum(-1)
    lses["gc"] = lses["band"]
    for kind in bp.instances["row"]:
        args = (q, k, v, do, lses[kind], delta, key, bp, kind, scale)
        split = kps if kind == "gr" else None
        _check_pairs([(tb.banded_dq(*args, kv_tiles_per_split=split),
                       tb.banded_dq_plain(
                           *args, split or tb.fwd_split(q, bp, kind)))],
                     dtype)
    for kind in bp.instances["col"]:
        args = (q, k, v, do, lses[kind], delta, key, bp, kind, scale)
        split = qps if kind == "gc" else None
        _check_pairs(list(zip(tb.banded_dkv(*args, q_tiles_per_split=split),
                              tb.banded_dkv_plain(
                                  *args, split or tb.dkv_split(q, bp,
                                                               kind)))),
                     dtype)
    torch.cuda.synchronize()


def _check_pairs(pairs, dtype):
    for a, b in pairs:
        assert torch.isfinite(a).all()
        a, b = a.float().cpu().numpy(), b.float().cpu().numpy()
        if dtype == "fp32":
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-4)
        else:
            ratio, rel_rms, ok = _bf16_check(a, b, **BF16_TOL)
            assert ok, (ratio, rel_rms)
