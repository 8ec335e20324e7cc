"""K12's split global-rows walk and K13's split global-columns walk
(deepspeed_tpu_torch/ops/sparse_attention/banded.py:
``banded_dq_plain(kv_tiles_per_split=...)``,
``banded_dkv_plain(q_tiles_per_split=...)``, ``fwd_split``, ``dkv_split``,
``walk_split_plan``) against the JAX package on the CPU.

On the card K12 walks its global-rows ("gr") instance in bf16 as splits of
its kv tiles and K13 its global-columns ("gc") instance as splits of its q
tiles; each split sums its dq (dk and dv) from zero, and the partials add
in split order before dq and dk take sm_scale. dq, dk and dv are sums with
no running max, so the split moves only the fp32 order of a sum, never a
bf16 rounding of p or ds. The split plain versions, combined as
``banded_bwd_impl`` combines the instances and fed JAX's o and lses, are
held to JAX's K12 and K13 (its Pallas kernels in interpret mode) at every
split size, at the tolerances of ``test_torch_banded.py``:

- fp32: atol 2e-5 (JAX's own for its sparse kernels);
- bf16: every element within 1e-4 + 2**-7 |want| (one bf16 ulp: both sides
  round the same fp32 values, summed in another order) and the whole
  tensor within a relative RMS error of 1e-3.

With a split of None the plain versions are the one walk, bit for bit. jax
is imported inside the tests that use it.
"""

import numpy as np
import pytest
import torch

FP32_ATOL = 2e-5
BF16_TOL = dict(atol=1e-4, rtol=2.0**-7, rms=1e-3)


def _close(got, want, dtype):
    """(worst ratio to the tolerance, relative RMS error, within it)."""
    diff = np.abs(got - want)
    if dtype == "fp32":
        return float(diff.max() / FP32_ATOL), None, bool(
            diff.max() <= FP32_ATOL)
    ratio = float((diff / (BF16_TOL["atol"] + BF16_TOL["rtol"] *
                           np.abs(want))).max())
    rel_rms = float(np.linalg.norm(diff) / max(np.linalg.norm(want), 1e-30))
    return ratio, rel_rms, ratio <= 1.0 and rel_rms <= BF16_TOL["rms"]


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


def _port(params, fb, blocks, q, k, v, do, kpm, dtype, want=None):
    """The port's module, plan and backward inputs: q, k, v, do in
    ``dtype``, the key mask, and the lses and delta of JAX's forward
    (``want``) or of the port's."""
    from deepspeed_tpu_torch.ops.sparse_attention import banded as tb
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    tq, tk, tv, tdo = (torch.from_numpy(a).to(td) for a in (q, k, v, do))
    bp = tb.BandedPlan(q.shape[1], q.shape[2], fb, tb.BandedParams(*params),
                       *blocks)
    key = None if kpm is None else torch.from_numpy(kpm)
    scale = 1.0 / np.sqrt(q.shape[-1])
    if want is None:
        o, lse_b, lse_g = tb.banded_fwd_impl(tq, tk, tv, key, bp, scale)
    else:
        o = torch.from_numpy(want["o"].copy()).to(td)
        lse_b = torch.from_numpy(want["lse_b"].copy())
        lse_g = torch.from_numpy(want["lse_g"].copy())
    delta = (tdo.float() * o.float()).sum(dim=-1)
    lses = {"band": lse_b, "gc": lse_b, "gr": lse_g}
    return tb, bp, (tq, tk, tv, tdo), key, lses, delta, scale


def _combined(tb, bp, ops, key, lses, delta, scale, kps=None, qps=None,
              memo=None):
    """dq, dk, dv of the instances combined as banded_bwd_impl combines
    them, K12's gr instance summed in splits of ``kps`` kv tiles and K13's
    gc instance in splits of ``qps`` q tiles (None: the one walk).
    ``memo``: a dict keeping the instances' outputs across calls, keyed by
    kernel, instance and split."""
    q, k, v, do = ops
    memo = {} if memo is None else memo

    def run(fn, kind, split=None):
        key_ = (fn.__name__, kind, split)
        if key_ not in memo:
            memo[key_] = fn(q, k, v, do, lses[kind], delta, key, bp, kind,
                            scale, split)
        return memo[key_]
    dq = run(tb.banded_dq_plain, "band")
    if "gr" in bp.instances["row"]:
        dq = tb._add_rows(dq, run(tb.banded_dq_plain, "gr", kps))
    dk, dv = run(tb.banded_dkv_plain, "band")
    acc_k, acc_v = dk.float().clone(), dv.float().clone()
    for kind in ("gc", "gr"):
        if kind in bp.instances["col"]:
            pk, pv = run(tb.banded_dkv_plain, kind,
                         qps if kind == "gc" else None)
            n = pk.shape[2]
            acc_k[:, :, :n] += pk.float()
            acc_v[:, :, :n] += pv.float()
    return dq, acc_k.to(k.dtype), acc_v.to(v.dtype)


def _one_walk_dq(q, k, v, do, lse, delta, key_mask, bp, kind, sm_scale):
    """K12's plain version as it stood before the split: one walk, JAX's
    order, step by step."""
    from deepspeed_tpu_torch.ops.sparse_attention import banded as tb
    B, H, S, D = q.shape
    n, steps = bp.instances["row"][kind]
    qt, dot = (tb._tiles(x, n, bp.bq).float() for x in (q, do))
    lse_t = lse.reshape(B, H, -1, bp.bq)[:, :, :n]
    dl_t = delta.reshape(B, H, S // bp.bq, bp.bq)[:, :, :n]
    kt, vt = (x.reshape(B, H, S // bp.bkv, bp.bkv, D) for x in (k, v))
    acc = torch.zeros((B, H, n, bp.bq, D), dtype=torch.float32)
    for j in range(steps):
        part, keep = tb._step_cells(bp, "row", kind, j, q.device)
        km = None if key_mask is None else tb._key_tiles(key_mask, bp.bkv,
                                                         part)
        kj = kt[:, :, part].float()
        s = tb._scores(qt, kj, sm_scale, km, keep)
        p = torch.where(s > tb.VALID_THRESH,
                        torch.exp(s - lse_t[..., None]), 0.0)
        dp = tb._dot(dot, vt[:, :, part])
        ds = p * (dp - dl_t[..., None])
        acc = acc + ds.to(k.dtype).float() @ kj
    return (acc * sm_scale).to(q.dtype).reshape(B, H, n * bp.bq, D)


def _one_walk_dkv(q, k, v, do, lse, delta, key_mask, bp, kind, sm_scale):
    """K13's plain version as it stood before the split."""
    from deepspeed_tpu_torch.ops.sparse_attention import banded as tb
    B, H, S, D = q.shape
    n, steps = bp.instances["col"][kind]
    kt, vt = (tb._tiles(x, n, bp.bkv).float() for x in (k, v))
    qt, dot = (x.reshape(B, H, S // bp.bq, bp.bq, D) for x in (q, do))
    lse_t = lse.reshape(B, H, -1, bp.bq)
    dl_t = delta.reshape(B, H, S // bp.bq, bp.bq)
    km = None if key_mask is None else tb._key_tiles(
        key_mask, bp.bkv, torch.arange(n))
    acc_k = torch.zeros((B, H, n, bp.bkv, D), dtype=torch.float32)
    acc_v = torch.zeros_like(acc_k)
    for j in range(steps):
        part, keep = tb._step_cells(bp, "col", kind, j, q.device)
        qj, doj = qt[:, :, part].float(), dot[:, :, part].float()
        s = tb._scores(qj, kt, sm_scale, km, keep)
        p = torch.where(s > tb.VALID_THRESH,
                        torch.exp(s - lse_t[:, :, part, :, None]), 0.0)
        acc_v = acc_v + p.to(do.dtype).float().transpose(-1, -2) @ doj
        dp = tb._dot(doj, vt)
        ds = p * (dp - dl_t[:, :, part, :, None])
        acc_k = acc_k + ds.to(q.dtype).float().transpose(-1, -2) @ qj
    rows = n * bp.bkv
    return ((acc_k * sm_scale).to(k.dtype).reshape(B, H, rows, D),
            acc_v.to(v.dtype).reshape(B, H, rows, D))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("walk, kind", [("row", "band"), ("row", "gr"),
                                        ("col", "band"), ("col", "gc"),
                                        ("col", "gr")])
def test_no_split_is_the_one_walk_bitwise(walk, kind, dtype):
    """A split of None (and the CPU wrapper, which passes it on) is the one
    walk bit for bit; so is one split of the whole walk."""
    rng = np.random.RandomState(3)
    q, k, v, do = _inputs(rng, 2, 2, 256)
    kpm = _key_mask(rng, 2, 256, "mul")
    tb, bp, ops, key, lses, delta, scale = _port(
        (2, 1, 1, False), 16, (32, 32), q, k, v, do, kpm, dtype)
    args = (*ops, lses[kind], delta, key, bp, kind, scale)
    steps = bp.instances[walk][kind][1]
    if walk == "row":
        want = (_one_walk_dq(*args),)
        got = [(tb.banded_dq_plain(*args),), (tb.banded_dq(*args),),
               (tb.banded_dq_plain(*args, kv_tiles_per_split=steps),)]
    else:
        want = _one_walk_dkv(*args)
        got = [tb.banded_dkv_plain(*args), tb.banded_dkv(*args),
               tb.banded_dkv_plain(*args, q_tiles_per_split=steps)]
    for outs in got:
        for a, b in zip(outs, want):
            assert torch.equal(a, b)


SPLIT_CASES = [
    # (geometry, fb, S, tiles, key mask, dtype): 8 kv tiles of gr walk and
    # 7 q tiles of gc walk with a batch row of pads; a causal gr walk of 3
    # kv tiles whose global rows (96) and columns (96) are wider than a
    # tile (64 rows, 32 keys); g_r and g_c of 32 over q tiles of 16 (14 q
    # tiles of gc walk); two gc kv tiles of 16 without a key mask
    ((1, 1, 1, False), 32, 256, (32, 32), "mul", "fp32"),
    ((1, 1, 1, False), 32, 256, (32, 32), "mul", "bf16"),
    ((3, 3, 1, True), 32, 512, (64, 32), None, "fp32"),
    ((3, 3, 1, True), 32, 512, (64, 32), "add", "bf16"),
    ((2, 2, 1, False), 16, 256, (16, 32), "add", "fp32"),
    ((2, 2, 2, False), 16, 256, (32, 16), None, "bf16"),
]


@pytest.mark.parametrize("case", range(len(SPLIT_CASES)))
def test_split_backward_matches_jax(case):
    """For every split size of K12's gr walk (one kv tile a split, uneven
    last splits, the whole walk) and of K13's gc walk, the instances
    combined as the backward combines them hold against JAX's K12 and
    K13 on JAX's o and lses; a batch row of pads gives dq = 0 there."""
    geom, fb, s, blocks, mode, dtype = SPLIT_CASES[case]
    rng = np.random.RandomState(200 + case)
    q, k, v, do = _inputs(rng, 2, 2, s)
    kpm = _key_mask(rng, 2, s, mode)
    want = _jax_banded(geom, fb, blocks, q, k, v, do, kpm, dtype)
    tb, bp, ops, key, lses, delta, scale = _port(
        geom, fb, blocks, q, k, v, do, kpm, dtype, want)
    grk = bp.instances["row"]["gr"][1]
    gcq = bp.instances["col"]["gc"][1]
    assert grk == tb._gr_kv_walk(s, fb, geom[0], geom[3], blocks[1])
    assert gcq == s // blocks[0] - (geom[0] * fb) // blocks[0]
    memo = {}
    for kps in range(1, max(grk, gcq) + 1):
        got = _combined(tb, bp, ops, key, lses, delta, scale,
                        min(kps, grk), min(kps, gcq), memo)
        for name, x in zip(("dq", "dk", "dv"), got):
            x = x.float().numpy()
            assert np.isfinite(x).all()
            ratio, rel_rms, ok = _close(x, want[name], dtype)
            assert ok, (name, kps, ratio, rel_rms)
        if mode == "mul":
            # the row of pads: every p is 0, so dq is 0 there
            assert (got[0][-1] == 0).all()


def test_merge_that_drops_or_repeats_a_split_fails():
    """The control: K12's gr partials and K13's gc partials merged with
    the last split dropped, or with a split added twice, fail the fp32
    check against JAX; the same partials merged in order pass."""
    geom, fb, s, blocks = (1, 1, 1, False), 32, 256, (32, 32)
    rng = np.random.RandomState(7)
    q, k, v, do = _inputs(rng, 2, 2, s)
    want = _jax_banded(geom, fb, blocks, q, k, v, do, None, "fp32")
    tb, bp, ops, key, lses, delta, scale = _port(
        geom, fb, blocks, q, k, v, do, None, "fp32", want)
    merge = tb._split_sum

    def bad(drop):
        def sum_(walk, steps, per):
            if per is None:
                return merge(walk, steps, per)
            parts = [walk(range(j, min(j + per, steps)))
                     for j in range(0, steps, per)]
            parts = parts[:-1] if drop else parts + parts[:1]
            one = isinstance(parts[0], torch.Tensor)
            acc = [torch.zeros_like(x)
                   for x in ((parts[0],) if one else parts[0])]
            for part in parts:
                acc = [a + x for a, x in zip(acc, (part,) if one else part)]
            return acc[0] if one else tuple(acc)
        return sum_
    try:
        for drop in (True, False):
            tb._split_sum = bad(drop)
            got = _combined(tb, bp, ops, key, lses, delta, scale, 3, 3)
            for name, x in zip(("dq", "dk", "dv"), got):
                assert not _close(x.numpy(), want[name], "fp32")[2], \
                    (name, drop)
    finally:
        tb._split_sum = merge
    got = _combined(tb, bp, ops, key, lses, delta, scale, 3, 3)
    for name, x in zip(("dq", "dk", "dv"), got):
        assert _close(x.numpy(), want[name], "fp32")[2], name


def test_split_plans_at_the_main_shapes():
    """The plans' host arithmetic, pinned. At the s8k geometry (B 1, H 16,
    S 8192, BSLongformer block 128 at tiles (128, 128)): K12's gr walk of
    64 kv tiles in splits of 8 (K11's: one shape), K13's gc walk of 63 q
    tiles in splits of 8 (8 splits, 1024 warps of 16 key rows). At sparse
    BERT's (B 8, H 16, S 2048, block 16 at tiles (16, 16)): 16 of 128 kv
    tiles and 16 of 127 q tiles. Other instances, fp32 and a grid of
    enough warps walk one split; a split is forced only where the kernel
    splits, and never below 1."""
    from deepspeed_tpu_torch.ops.sparse_attention import (
        BSLongformerSparsityConfig, banded as tb)
    # K13's gc walk: (batch, heads, GT * bkv key rows, bq, q tiles)
    assert tb.walk_split_plan(1, 16, 128, 128, 63) == 8
    assert tb.walk_split_plan(8, 16, 16, 16, 127) == 16
    assert tb.walk_split_plan(64, 16, 128, 128, 63) == 63
    assert tb.walk_split_plan(1, 1, 64, 64, 3) == 3      # 192 queries
    assert tb.walk_split_plan(1, 16, 128, 128, 64) == \
        tb.gr_split_plan(1, 16, 1, 128, 128, 64) == 8
    for (B, S, block), (tiles, kps, qps, gcq) in {
            (1, 8192, 128): ((128, 128), 8, 8, 63),
            (8, 2048, 16): ((16, 16), 16, 16, 127)}.items():
        layout = BSLongformerSparsityConfig(
            num_heads=16, block=block,
            num_sliding_window_blocks=3).make_layout(S)
        params, blocks = tb.plan(layout, block, False)
        assert blocks == tiles
        bp = tb.BandedPlan(16, S, block, params, *blocks)
        assert bp.instances["col"]["gc"] == (1, gcq)
        q = torch.empty((B, 16, S, 64), dtype=torch.bfloat16)
        assert tb.fwd_split(q, bp, "gr") == kps
        assert tb.dkv_split(q, bp, "gc") == qps
        assert tb.fwd_split(q, bp, "band") is None
        for kind in ("band", "gr"):
            assert tb.dkv_split(q, bp, kind) is None
        assert tb.fwd_split(q.float(), bp, "gr") is None
        assert tb.dkv_split(q.float(), bp, "gc") is None
        assert tb._tiles_per_split(qps, None, q, "gc", "dk/dv", "n",
                                   gcq) == qps
        assert tb._tiles_per_split(qps, 500, q, "gc", "dk/dv", "n",
                                   gcq) == gcq
        with pytest.raises(ValueError, match="not split"):
            tb._tiles_per_split(None, 2, q, "band", "dq", "n", 9)
        with pytest.raises(ValueError, match=">= 1"):
            tb._tiles_per_split(kps, 0, q, "gr", "dq", "n", 9)


@pytest.mark.parametrize("operand", ["q", "k", "v", "do", "key_mask"])
def test_bf16_backward_refuses_misaligned_operands(operand):
    """K12's and K13's tensor-core bodies load 16-byte rows (q, k, v, do)
    and 8-byte pairs of the key mask: a bf16 call whose operand starts off
    those boundaries raises before any launch, an aligned one and fp32
    pass."""
    from deepspeed_tpu_torch.ops.sparse_attention.banded import \
        _check_bwd_aligned
    shape, n = (1, 2, 32, 16), 2 * 32 * 16

    def operands(dtype, off=None):
        ts = {name: torch.zeros(n + 8, dtype=dtype)[:n].view(shape)
              for name in ("q", "k", "v", "do")}
        ts["key_mask"] = torch.zeros(33)[:32].view(1, 32)
        if off is not None:
            base = torch.zeros(n + 8, dtype=ts[off].dtype)
            ts[off] = base[1:1 + ts[off].numel()].view(ts[off].shape) \
                if ts[off].dtype == torch.float32 else \
                base[4:4 + n].view(shape)
        return ts

    _check_bwd_aligned(**operands(torch.bfloat16))
    _check_bwd_aligned(**operands(torch.float32, operand))
    with pytest.raises(ValueError, match=f"{operand} aligned"):
        _check_bwd_aligned(**operands(torch.bfloat16, operand))
