"""K11's split global-rows walk (deepspeed_tpu_torch/ops/sparse_attention/
banded.py: ``banded_fwd_plain(kv_tiles_per_split=...)``, ``gr_split_plan``,
``fwd_split``) against the JAX package on the CPU.

On the card K11 walks its global-rows ("gr") instance in bf16 as splits of
its kv tiles, each from a fresh online-softmax state, merged in split
order. p then rounds to bf16 under its split's running max, not the whole
walk's, so the split plain version is held to JAX's one walk (its Pallas
K11 in interpret mode) at these tolerances:

- fp32: atol 2e-5 (JAX's own for its sparse kernels; the merge adds a few
  fp32 roundings);
- bf16: the whole tensor within a relative RMS error of 1e-3, as
  ``test_torch_banded.py`` holds the one walk, and every element within
  1e-4 + 2**-7 (max |v| + |want|). Each p of a split rounds to bf16 under
  another max than in the one walk, so the two roundings of a p part by
  up to two bf16 half-ulps (2**-7 of p) and o = sum p v / l by up to
  2**-7 max |v|, beside o's own rounding (2**-7 |want| covers it). One
  bf16 ulp of |want| alone is not a bound of that: measured up to 3.4 of
  it (a split of one kv tile, the causal case);
- bf16, the global rows alone (where the split acts): relative RMS error
  within 2**-7 (GR_RMS). Two independent bf16 roundings of the p part by
  2**-8 * sqrt(2/3) = 3.2e-3 of p in RMS, and o's error by about as much
  of o when v has random signs; these cases measure 1.29e-3 to 2.77e-3
  (one walk: 0). An all-zero output of those rows fails it;
- lse (fp32 on both sides): rtol 1e-6, atol 2e-5.

With ``kv_tiles_per_split=None`` the plain version is the one walk, bit for
bit. jax is imported inside the tests that use it.
"""

import numpy as np
import pytest
import torch

import tests.torch_threads  # noqa: F401  (torch threads per xdist worker)

FP32_ATOL = 2e-5
BF16_TOL = dict(atol=1e-4, rtol=2.0**-7, rms=1e-3)
GR_RMS = 2.0**-7


def _close(got, want, dtype, v_max=0.0, rms=BF16_TOL["rms"]):
    """(worst ratio to the tolerance, relative RMS error, within it);
    bf16: ``v_max`` is max |v| (the split's bound, 0 for the one walk),
    ``rms`` the relative RMS bound."""
    diff = np.abs(got - want)
    if dtype == "fp32":
        return float(diff.max() / FP32_ATOL), None, bool(
            diff.max() <= FP32_ATOL)
    ratio = float((diff / (BF16_TOL["atol"] + BF16_TOL["rtol"] *
                           (v_max + np.abs(want)))).max())
    rel_rms = float(np.linalg.norm(diff) / max(np.linalg.norm(want), 1e-30))
    return ratio, rel_rms, ratio <= 1.0 and rel_rms <= rms


def _inputs(rng, B, H, s, d=16):
    return [(rng.randn(B, H, s, d) * 0.5).astype(np.float32)
            for _ in range(3)]


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


def _jax_forward(params, fb, blocks, q, k, v, kpm, dtype):
    """o, lse_band, lse_gr of JAX's K11 in interpret mode, jitted."""
    import jax
    import jax.numpy as jnp
    from deepspeed_tpu.ops.sparse_attention import banded as jb
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    B, H, s, d = q.shape
    fwd, _ = jb.build_banded_impls(H, s, fb, jb.BandedParams(*params),
                                   1.0 / np.sqrt(d), *blocks, interpret=True)
    km = jnp.zeros((B, s), jnp.float32) if kpm is None else jnp.asarray(kpm)
    o, lse_b, lse_g = jax.jit(fwd)(
        *(jnp.asarray(a).astype(jd) for a in (q, k, v)), km)
    return (np.asarray(o.astype(jnp.float32)),
            np.asarray(lse_b).reshape(B, H, -1),
            np.asarray(lse_g).reshape(B, H, -1))


def _port(params, fb, blocks, q, k, v, kpm, dtype):
    from deepspeed_tpu_torch.ops.sparse_attention import banded as tb
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    tq, tk, tv = (torch.from_numpy(a).to(td) for a in (q, k, v))
    bp = tb.BandedPlan(q.shape[1], q.shape[2], fb, tb.BandedParams(*params),
                       *blocks)
    key = None if kpm is None else torch.from_numpy(kpm)
    return tb, bp, (tq, tk, tv, key, bp), 1.0 / np.sqrt(q.shape[-1])


def _one_walk(q, k, v, key_mask, bp, kind, sm_scale):
    """The one online-softmax walk as the plain version held it before
    the split (JAX's order, step by step)."""
    from deepspeed_tpu_torch.ops.sparse_attention import banded as tb
    B, H, S, D = q.shape
    n, steps = bp.instances["row"][kind]
    qt = tb._tiles(q, n, bp.bq).float()
    kt, vt = (x.reshape(B, H, S // bp.bkv, bp.bkv, D) for x in (k, v))
    m = torch.full((B, H, n, bp.bq), tb.NEG_INF, dtype=torch.float32)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, H, n, bp.bq, D), dtype=torch.float32)
    for j in range(steps):
        part, keep = tb._step_cells(bp, "row", kind, j, q.device)
        km = None if key_mask is None else tb._key_tiles(key_mask, bp.bkv,
                                                         part)
        s = tb._scores(qt, kt[:, :, part].float(), sm_scale, km, keep)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(s > tb.VALID_THRESH,
                        torch.exp(s - m_new[..., None]), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + \
            p.to(v.dtype).float() @ vt[:, :, part].float()
        m = m_new
    l_safe = torch.where(l == 0.0, 1.0, l)
    o = (acc / l_safe[..., None]).to(q.dtype).reshape(B, H, n * bp.bq, D)
    return o, (m + torch.log(l_safe)).reshape(B, H, n * bp.bq)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("kind", ["band", "gr"])
def test_no_split_is_the_one_walk_bitwise(kind, dtype):
    """kv_tiles_per_split=None (and the CPU wrapper, which passes it on)
    is the one walk bit for bit; so is one split of the whole walk."""
    rng = np.random.RandomState(3)
    q, k, v = _inputs(rng, 2, 2, 256)
    kpm = _key_mask(rng, 2, 256, "mul")
    tb, bp, args, scale = _port((2, 1, 1, False), 16, (32, 32), q, k, v, kpm,
                                dtype)
    want = _one_walk(*args, kind, scale)
    steps = bp.instances["row"][kind][1]
    for got in (tb.banded_fwd_plain(*args, kind, scale),
                tb.banded_fwd(*args, kind, scale),
                tb.banded_fwd_plain(*args, kind, scale,
                                    kv_tiles_per_split=steps)):
        for a, b in zip(got, want):
            assert torch.equal(a, b)


SPLIT_CASES = [
    # (geometry, fb, S, tiles, key mask, dtype): the gr walk of 8 kv
    # tiles with a batch row of pads; a causal gr walk of 3 kv tiles whose
    # global rows (96) are wider than a q tile (64); g_r of 32 rows over q
    # tiles of 16; 16 kv tiles of 16 without a key mask
    ((1, 1, 1, False), 32, 256, (32, 32), "mul", "fp32"),
    ((1, 1, 1, False), 32, 256, (32, 32), "mul", "bf16"),
    ((3, 3, 1, True), 32, 512, (64, 32), None, "fp32"),
    ((3, 3, 1, True), 32, 512, (64, 32), "add", "bf16"),
    ((2, 0, 1, False), 16, 256, (16, 32), "add", "fp32"),
    ((2, 2, 2, False), 16, 256, (32, 16), None, "bf16"),
]


@pytest.mark.parametrize("case", range(len(SPLIT_CASES)))
def test_split_walk_matches_jax(case):
    """For every split size of the gr walk (one kv tile per split, uneven
    last splits, the whole walk), the band instance's one walk plus the
    split gr walk, combined as the forward combines them, hold against
    JAX's K11 (o, lse_band, lse_gr); a batch row of pads writes o = 0
    and lse = m."""
    geom, fb, s, blocks, mode, dtype = SPLIT_CASES[case]
    rng = np.random.RandomState(100 + case)
    q, k, v = _inputs(rng, 2, 2, s)
    kpm = _key_mask(rng, 2, s, mode)
    o_j, lse_b_j, lse_g_j = _jax_forward(geom, fb, blocks, q, k, v, kpm,
                                         dtype)
    tb, bp, args, scale = _port(geom, fb, blocks, q, k, v, kpm, dtype)
    o_b, lse_b = tb.banded_fwd_plain(*args, "band", scale)
    np.testing.assert_allclose(lse_b.numpy(), lse_b_j, rtol=1e-6,
                               atol=FP32_ATOL)
    grk = bp.instances["row"]["gr"][1]
    assert grk == tb._gr_kv_walk(s, fb, geom[0], geom[3], blocks[1])
    for kps in range(1, grk + 1):
        o_g, lse_g = tb.banded_fwd_plain(*args, "gr", scale,
                                         kv_tiles_per_split=kps)
        o = tb._add_rows(o_b, o_g).float().numpy()
        assert np.isfinite(o).all()
        ratio, rel_rms, ok = _close(o, o_j, dtype, np.abs(v).max())
        assert ok, (kps, ratio, rel_rms)
        # the global rows alone, where the split acts; zeros there fail
        rows = geom[0] * fb
        gr_o, gr_j = o[:, :, :rows], o_j[:, :, :rows]
        ratio, rel_rms, ok = _close(gr_o, gr_j, dtype, np.abs(v).max(),
                                    GR_RMS)
        assert ok, ("global rows", kps, ratio, rel_rms)
        assert not _close(np.zeros_like(gr_o), gr_j, dtype, np.abs(v).max(),
                          GR_RMS)[2]
        np.testing.assert_allclose(lse_g.numpy(), lse_g_j, rtol=1e-6,
                                   atol=FP32_ATOL)
        if mode == "mul":
            # the row of pads: no key kept, o = 0 and lse = m (-1e30 plus
            # the scores' sums, below the threshold)
            assert (o[-1] == 0).all()
            assert (lse_g[-1] <= tb.VALID_THRESH).all()
            np.testing.assert_array_equal(lse_g[-1].numpy(), lse_g_j[-1])


def test_merge_without_rescaling_fails():
    """The control: the splits' partials summed without their e^(m_z - m)
    factors fail the fp32 check against JAX."""
    geom, fb, s, blocks = (1, 1, 1, False), 32, 256, (32, 32)
    rng = np.random.RandomState(7)
    q, k, v = _inputs(rng, 2, 2, s)
    o_j, _, _ = _jax_forward(geom, fb, blocks, q, k, v, None, "fp32")
    tb, bp, args, scale = _port(geom, fb, blocks, q, k, v, None, "fp32")
    tq, tk, tv, key, _ = args
    n, steps = bp.instances["row"]["gr"]
    B, H, S, D = tq.shape
    kt, vt = (x.reshape(B, H, S // bp.bkv, bp.bkv, D) for x in (tk, tv))
    parts = [tb._fwd_walk(tb._tiles(tq, n, bp.bq).float(), kt, vt, key, bp,
                          "gr", scale, range(j, min(j + 3, steps)))
             for j in range(0, steps, 3)]
    l = sum(p[1] for p in parts)
    acc = sum(p[2] for p in parts)
    o_g = (acc / torch.where(l == 0, 1.0, l)[..., None]).reshape(
        B, H, n * bp.bq, D)
    o_b, _ = tb.banded_fwd_plain(*args, "band", scale)
    o = tb._add_rows(o_b, o_g).numpy()
    assert not _close(o, o_j, "fp32")[2]
    # the same partials merged with their factors pass
    o_g, _ = tb.banded_fwd_plain(*args, "gr", scale, kv_tiles_per_split=3)
    assert _close(tb._add_rows(o_b, o_g).numpy(), o_j, "fp32")[2]


def test_gr_split_plan_at_the_main_shapes():
    """gr_split_plan's host arithmetic, pinned: at the s8k geometry (B 1,
    H 16, S 8192, BSLongformer block 128 at tiles (128, 128): 64 kv tiles,
    128 warps of rows) 8 kv tiles a split, 8 splits, 1024 warps; at sparse
    BERT's (B 8, H 16, S 2048, block 16 at tiles (16, 16): 128 kv tiles,
    128 warps) 16, 8 splits, 1024 warps; a short causal walk and a walk
    of few keys stay one split, a grid of enough warps too; fwd_split
    gives it for the bf16 gr instance only."""
    from deepspeed_tpu_torch.ops.sparse_attention import (
        BSLongformerSparsityConfig, banded as tb)
    assert tb.gr_split_plan(1, 16, 1, 128, 128, 64) == 8
    assert tb.gr_split_plan(8, 16, 1, 16, 16, 128) == 16
    assert tb.gr_split_plan(1, 16, 1, 128, 128, 1) == 1
    assert tb.gr_split_plan(1, 1, 1, 64, 64, 4) == 4      # 256 keys
    assert tb.gr_split_plan(64, 16, 1, 128, 128, 64) == 64
    for (B, S, block), (tiles, kps) in {
            (1, 8192, 128): ((128, 128), 8),
            (8, 2048, 16): ((16, 16), 16)}.items():
        layout = BSLongformerSparsityConfig(
            num_heads=16, block=block,
            num_sliding_window_blocks=3).make_layout(S)
        params, blocks = tb.plan(layout, block, False)
        assert blocks == tiles
        bp = tb.BandedPlan(16, S, block, params, *blocks)
        q = torch.empty((B, 16, S, 64), dtype=torch.bfloat16)
        assert tb.fwd_split(q, bp, "gr") == kps
        assert tb.fwd_split(q, bp, "band") is None
        assert tb.fwd_split(q.float(), bp, "gr") is None
