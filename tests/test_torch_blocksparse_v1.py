"""The port's v1 block-sparse attention (K14-K16 of deepspeed_tpu_torch/
ops/sparse_attention/blocksparse.py, the route ``USE_SPLASH_V2 = False``
takes) against the JAX package on the CPU.

The same numpy inputs, made from a seed, go through both. The JAX side
runs its per-triple Pallas kernels K14-K16 in interpret mode through
``block_sparse_attention`` under ``USE_SPLASH_V2 = False`` (and, without
a user attention mask, ``USE_MASKED_FLASH = False`` and ``USE_BANDED =
False``, which ``bench.py``'s s8k fallback sets); the port runs their
plain versions. Every flag is restored by a fixture. Tolerances:

- ``build_triples``: equal, bitwise, every array;
- K14-K16 and the front end, fp32: atol 2e-5 (JAX's own for its sparse
  kernels; the sums run in another order); bf16: every element within
  1e-4 + 2**-7 |want| (one bf16 ulp: both sides round the same fp32
  values, p before P.V and ds before its products) and the whole tensor
  within a relative RMS error of 1e-3;
- the port's v1 against its row-run kernels K8-K10 (the mirror of JAX's
  ``test_masked_path_v2_matches_v1``): JAX's tolerance, o atol 1e-5 +
  rtol 1e-5, grads atol 5e-5 + rtol 5e-4;
- the sparse BERT MLM loss, fp32: loss rtol 1e-5, each grad within 1e-4
  of its largest entry.

The CUDA kernels run only on a card: their tests are marked ``cuda`` and
skip here. jax is imported inside the tests that use it: the card's
machine has none.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

import tests.torch_threads  # noqa: F401  (torch threads per xdist worker)

FP32_ATOL = 2e-5
BF16_TOL = dict(atol=1e-4, rtol=2.0**-7, rms=1e-3)
V2_TOL = dict(o=(1e-5, 1e-5), grads=(5e-5, 5e-4))
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


FLAGS = ("USE_MASKED_FLASH", "USE_SPLASH_V2", "USE_BANDED", "USE_HYBRID",
         "USE_COARSE", "_FORCE_COARSE_BLOCK")


@pytest.fixture
def v1():
    """Both packages under ``USE_SPLASH_V2 = False``, every flag restored
    afterwards, the function caches cleared before and after. Yields a
    function that sets further flags on both."""
    from deepspeed_tpu.ops.sparse_attention import blocksparse as jbs

    from deepspeed_tpu_torch.ops.sparse_attention import blocksparse as tbs
    saved = [(m, n, getattr(m, n)) for m in (jbs, tbs) for n in FLAGS]

    def set_flags(**flags):
        for m in (jbs, tbs):
            for n, value in flags.items():
                setattr(m, n, value)
            m._FN_CACHE.clear()
    set_flags(USE_SPLASH_V2=False)
    yield set_flags
    for m, n, value in saved:
        setattr(m, n, value)
    jbs._FN_CACHE.clear()
    tbs._FN_CACHE.clear()


def _layouts(s=128, fb=16):
    """Layout families (H 2) keyed by name: fixed with a pattern per
    head, Variable, BSLongformer, BigBird, dense, and a per-head layout
    with an empty block row (head 0) and an empty block column (head
    1)."""
    from deepspeed_tpu_torch.ops.sparse_attention import (
        BigBirdSparsityConfig, BSLongformerSparsityConfig,
        DenseSparsityConfig, FixedSparsityConfig, VariableSparsityConfig)
    n = s // fb
    empty = (np.random.RandomState(4).rand(2, n, n) < 0.4).astype(np.int32)
    empty[0, 3 % n] = 0
    empty[1, :, 5 % n] = 0
    return {
        "fixed_per_head": FixedSparsityConfig(
            num_heads=2, block=fb, num_local_blocks=2,
            different_layout_per_head=True,
            num_different_global_patterns=2).make_layout(s),
        "variable": VariableSparsityConfig(
            num_heads=2, block=fb, num_random_blocks=1,
            local_window_blocks=[2]).make_layout(s),
        "bslongformer": BSLongformerSparsityConfig(
            num_heads=2, block=fb).make_layout(s),
        "bigbird": BigBirdSparsityConfig(
            num_heads=2, block=fb, num_random_blocks=1).make_layout(s),
        "dense": DenseSparsityConfig(num_heads=2, block=fb).make_layout(s),
        "empty_row_and_column": empty,
    }


# ------------------------------------------------------------ builders
@pytest.mark.parametrize("name", ["fixed_per_head", "variable",
                                  "bslongformer", "bigbird", "dense",
                                  "empty_row_and_column"])
@pytest.mark.parametrize("fb", [16, 32])
def test_build_triples_matches_jax(name, fb):
    """build_triples of the layout and of its transpose (the column walk)
    equals JAX's, every array, and the plan's walks are its CSR."""
    from deepspeed_tpu.ops.sparse_attention import blocksparse as jbs

    from deepspeed_tpu_torch.ops.sparse_attention import blocksparse as tbs
    layout = _layouts(256, fb)[name] if name != "empty_row_and_column" \
        else _layouts(128, 16)[name]
    lt = np.ascontiguousarray(layout.transpose(0, 2, 1))
    for lay in (layout, lt):
        ours, theirs = tbs.build_triples(lay), jbs.build_triples(lay)
        assert len(ours) == len(theirs) == 5
        for a, b in zip(ours, theirs):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    plan = tbs.TriplePlan(layout, fb)
    H, nq, nk = layout.shape
    for (offs, partner, valid), lay in ((plan.rows, layout),
                                        (plan.cols, lt)):
        assert len(offs) == H * lay.shape[1] + 1
        cnt = lay.reshape(-1, lay.shape[2]).sum(-1)
        np.testing.assert_array_equal(np.diff(offs), np.maximum(cnt, 1))
        np.testing.assert_array_equal(valid[offs[:-1]], cnt > 0)
        assert int(valid.sum()) == int(layout.sum())
    if name == "empty_row_and_column":
        assert (plan.rows[2] == 0).any() and (plan.cols[2] == 0).any()


# ------------------------------------ K14-K16 through the front end
def _inputs(rng, B, H, s, d=16):
    return [(rng.randn(B, H, s, d) * 0.5).astype(np.float32)
            for _ in range(4)]


def _key_mask(rng, B, s, mode):
    """None, or a (B, S) key mask in ``mode``: 'mul' keeps random
    lengths (the last batch row all pads), 'add' 0 or -1e9 on the
    pads."""
    if mode is None:
        return None
    keep = (np.arange(s)[None, :] < rng.randint(s // 2, s + 1, B)[:, None])
    keep[-1] = False
    return (keep.astype(np.float32) if mode == "mul"
            else np.where(keep, 0.0, -1e9).astype(np.float32))


def _attn_mask(rng, s, mode):
    """None, or an (S, S) mask in ``mode``: 'mul' keeps 80% and drops
    every key of rows 3 and 40; 'add' N(0, 1) values, -1e4 where 'mul'
    drops."""
    if mode is None:
        return None
    keep = (rng.rand(s, s) > 0.2).astype(np.float32)
    keep[[3, 40]] = 0.0
    if mode == "mul":
        return keep
    return np.where(keep == 0, -1e4, rng.randn(s, s)).astype(np.float32)


def _run_both(jbs, tbs, layout, q, k, v, do, kpm, kpm_mode, am, am_mode,
              dtype):
    """o, dq, dk, dv of both packages' block_sparse_attention (JAX under
    jax.vjp, in interpret mode), as fp32 numpy."""
    import jax
    import jax.numpy as jnp
    kw_j, kw_t = {}, {}
    if kpm is not None:
        kw_j.update(key_padding_mask=jnp.asarray(kpm),
                    key_padding_mask_mode=kpm_mode)
        kw_t.update(key_padding_mask=torch.from_numpy(kpm),
                    key_padding_mask_mode=kpm_mode)
    if am is not None:
        kw_j.update(attn_mask=jnp.asarray(am), attn_mask_mode=am_mode)
        kw_t.update(attn_mask=torch.from_numpy(am), attn_mask_mode=am_mode)
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
    return got, want


V1_CASES = [
    # (layout, S, block, key mask mode, attention mask mode, dtype)
    ("fixed_per_head", 128, 16, "mul", "mul", "fp32"),
    ("fixed_per_head", 128, 16, "mul", "mul", "bf16"),
    ("bigbird", 128, 16, "add", "add", "fp32"),
    ("empty_row_and_column", 128, 16, None, "mul", "fp32"),
    ("dense", 64, 16, None, "add", "bf16"),
    ("variable", 256, 32, "mul", None, "fp32"),
    ("bslongformer", 256, 32, None, None, "bf16"),
    ("empty_row_and_column", 128, 16, "add", None, "fp32"),
]


@pytest.mark.parametrize("case", range(len(V1_CASES)))
def test_v1_route_matches_jax(v1, case):
    """block_sparse_attention under USE_SPLASH_V2 = False on both sides
    (without an attention mask also USE_MASKED_FLASH = False and
    USE_BANDED = False): both plan 'v1'; the output and the q/k/v grads
    of the port's plain K14-K16 against JAX's interpret-mode kernels, in
    both arities, with the key mask in 'mul', 'add' or none and the
    attention mask in 'mul' or 'add'. Rows with no valid key give
    o = 0."""
    import jax.numpy as jnp  # noqa: F401  (jax on the CPU before use)
    from deepspeed_tpu.ops.sparse_attention import blocksparse as jbs

    from deepspeed_tpu_torch.ops.sparse_attention import blocksparse as tbs
    name, s, fb, kpm_mode, am_mode, dtype = V1_CASES[case]
    if am_mode is None:
        v1(USE_MASKED_FLASH=False, USE_BANDED=False)
    layout = _layouts(s, fb)[name]
    has_am = am_mode is not None
    assert tbs.planned_kernel(layout, fb, has_am, cpu=True) == "v1" == \
        jbs.planned_kernel(layout, fb, has_am, interpret=True)
    rng = np.random.RandomState(30 + case)
    B = 2
    q, k, v, do = _inputs(rng, B, 2, s)
    kpm = _key_mask(rng, B, s, kpm_mode)
    am = _attn_mask(rng, s, am_mode)
    got, want = _run_both(jbs, tbs, layout, q, k, v, do, kpm, kpm_mode, am,
                          am_mode, dtype)
    for g, w in zip(got, want):
        assert np.isfinite(g).all()
        _assert_close(g, w, dtype)
    if kpm_mode == "mul":
        assert (got[0][-1] == 0).all() and (want[0][-1] == 0).all()
    if am_mode == "mul":
        assert (got[0][:, :, [3, 40]] == 0).all()


def test_empty_rows_and_the_v1_threshold(v1):
    """An empty block row writes o = 0 and lse = NEG_INF (-1e30) exactly
    on the plain K14, its column's dk = dv = 0 on K16, and the output
    equals JAX's; a row whose only unmasked keys sit at -5e28 ('add') has
    p = 0 under v1's threshold of -1e28 (o = 0 in both packages), where
    the row-run kernels' -1e29 would keep them."""
    import jax.numpy as jnp  # noqa: F401
    from deepspeed_tpu.ops.sparse_attention import blocksparse as jbs

    from deepspeed_tpu_torch.ops.sparse_attention import blocksparse as tbs
    from deepspeed_tpu_torch.ops.sparse_attention import blocksparse_v2 as v2
    layout = _layouts()["empty_row_and_column"]
    s, fb, row = 128, 16, 70
    rng = np.random.RandomState(9)
    q, k, v, do = _inputs(rng, 2, 2, s)
    am = rng.randn(s, s).astype(np.float32)
    am[row] = -1e30
    keys = np.nonzero(np.kron(layout[0, row // fb], np.ones(fb)))[0][:3]
    am[row, keys] = -5e28
    got, want = _run_both(jbs, tbs, layout, q, k, v, do, None, None, am,
                          "add", "fp32")
    for g, w in zip(got, want):
        _assert_close(g, w, "fp32")
    assert (got[0][:, 0, row] == 0).all() and (want[0][:, 0, row] == 0).all()
    plan = tbs.TriplePlan(layout, fb)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    am_t = torch.from_numpy(am)
    o, lse = tbs.bs_fwd_plain(tq, tk, tv, None, am_t, plan, 0.25)
    assert (o[:, 0, 3 * fb:4 * fb] == 0).all()
    assert (lse[:, 0, 3 * fb:4 * fb] == -1e30).all()
    assert (lse[:, 0, row] <= tbs.VALID_THRESH).all()
    delta = (tdo * o).sum(-1)
    dk, dv = tbs.bs_dkv_plain(tq, tk, tv, tdo, lse, delta, None, am_t, plan,
                              0.25)
    assert (dk[:, 1, 5 * fb:6 * fb] == 0).all()
    assert (dv[:, 1, 5 * fb:6 * fb] == 0).all()
    # the row-run kernels' threshold keeps the -5e28 keys of that row
    rp = v2.RowRunPlan(layout, fb)
    o2, _ = v2.blocksparse_v2_fwd_plain(tq, tk, tv, None, rp.mask_tiles(am_t),
                                        rp, 0.25)
    assert (o2[:, 0, row] != 0).any()


@pytest.mark.parametrize("dtype, body", [(torch.bfloat16, "mma"),
                                         (torch.float32, "fma")])
def test_forward_body_by_dtype(dtype, body):
    """K14 names the body a dtype runs: bf16 on K1's tensor-core forward
    body (csrc/mma_fwd.cuh), fp32 on the CUDA cores; ``reset_launches``
    zeroes its counts by body."""
    from deepspeed_tpu_torch.ops.attention.masked_flash import _count_body
    from deepspeed_tpu_torch.ops.sparse_attention import blocksparse as tbs
    assert tbs.FWD_BODIES[dtype] == body
    saved = dict(tbs.bs_fwd.bodies)
    try:
        _count_body(tbs.bs_fwd, dtype, tbs.FWD_BODIES)
        _count_body(tbs.bs_fwd, dtype, tbs.FWD_BODIES)
        assert tbs.bs_fwd.bodies[body] == saved.get(body, 0) + 2
        tbs.reset_launches()
        assert tbs.bs_fwd.bodies == {}
    finally:
        tbs.bs_fwd.bodies = saved


@pytest.mark.parametrize("operand", ["q", "k", "v", "key_mask",
                                     "attn_mask"])
def test_bf16_forward_refuses_misaligned_operands(operand):
    """K14's tensor-core body loads 16-byte rows (q, k, v) and 8-byte
    pairs of the key mask and the (S, S) attention mask: a bf16 call
    whose operand starts off those boundaries raises before any launch,
    an aligned one and fp32 pass."""
    from deepspeed_tpu_torch.ops.sparse_attention.blocksparse import \
        _v1_check_fwd_aligned
    shape, n = (1, 2, 32, 16), 2 * 32 * 16

    def operands(dtype, off=None):
        ts = {name: torch.zeros(n + 8, dtype=dtype)[:n].view(shape)
              for name in ("q", "k", "v")}
        ts["key_mask"] = torch.zeros(33)[:32].view(1, 32)
        ts["attn_mask"] = torch.zeros(32 * 32 + 2)[:1024].view(32, 32)
        if off is not None:
            base = torch.zeros(n + 8, dtype=ts[off].dtype)
            ts[off] = base[1:1 + ts[off].numel()].view(ts[off].shape) \
                if ts[off].dtype == torch.float32 else \
                base[4:4 + n].view(shape)
        return ts

    _v1_check_fwd_aligned(**operands(torch.bfloat16))
    _v1_check_fwd_aligned(**operands(torch.float32, operand))
    with pytest.raises(ValueError, match=f"{operand} aligned"):
        _v1_check_fwd_aligned(**operands(torch.bfloat16, operand))


@pytest.mark.parametrize("dtype, body", [(torch.bfloat16, "mma"),
                                         (torch.float32, "fma")])
@pytest.mark.parametrize("kernel, table", [("bs_dq", "DQ_BODIES"),
                                           ("bs_dkv", "DKV_BODIES")])
def test_backward_body_by_dtype(kernel, table, dtype, body):
    """K15 and K16 name the body a dtype runs: bf16 on K2's and K3's
    tensor-core bodies (csrc/mma_dq.cuh, csrc/mma_dkv.cuh), fp32 on the
    CUDA cores; ``reset_launches`` zeroes the counts by body of all three
    kernels."""
    from deepspeed_tpu_torch.ops.attention.masked_flash import _count_body
    from deepspeed_tpu_torch.ops.sparse_attention import blocksparse as tbs
    bodies, wrapper = getattr(tbs, table), getattr(tbs, kernel)
    assert bodies[dtype] == body
    saved = {n: dict(getattr(tbs, n).bodies)
             for n in ("bs_fwd", "bs_dq", "bs_dkv")}
    try:
        _count_body(wrapper, dtype, bodies)
        _count_body(wrapper, dtype, bodies)
        _count_body(tbs.bs_fwd, dtype, tbs.FWD_BODIES)
        assert wrapper.bodies[body] == saved[kernel].get(body, 0) + 2
        tbs.reset_launches()
        assert [tbs.bs_fwd.bodies, tbs.bs_dq.bodies, tbs.bs_dkv.bodies] == \
            [{}, {}, {}]
    finally:
        for n, b in saved.items():
            getattr(tbs, n).bodies = b


@pytest.mark.parametrize("operand", ["q", "k", "v", "do", "key_mask",
                                     "attn_mask"])
def test_bf16_backward_refuses_misaligned_operands(operand):
    """K15's and K16's tensor-core bodies load 16-byte rows (q, k, v, do)
    and 8-byte pairs of the key mask and the (S, S) attention mask: a
    bf16 call whose operand starts off those boundaries raises before any
    launch, an aligned one and fp32 pass."""
    from deepspeed_tpu_torch.ops.sparse_attention.blocksparse import \
        _v1_check_bwd_aligned
    shape, n = (1, 2, 32, 16), 2 * 32 * 16

    def operands(dtype, off=None):
        ts = {name: torch.zeros(n + 8, dtype=dtype)[:n].view(shape)
              for name in ("q", "k", "v", "do")}
        ts["key_mask"] = torch.zeros(33)[:32].view(1, 32)
        ts["attn_mask"] = torch.zeros(32 * 32 + 2)[:1024].view(32, 32)
        if off is not None:
            base = torch.zeros(n + 8, dtype=ts[off].dtype)
            ts[off] = base[1:1 + ts[off].numel()].view(ts[off].shape) \
                if ts[off].dtype == torch.float32 else \
                base[4:4 + n].view(shape)
        return ts

    _v1_check_bwd_aligned(**operands(torch.bfloat16))
    _v1_check_bwd_aligned(**operands(torch.float32, operand))
    with pytest.raises(ValueError, match=f"{operand} aligned"):
        _v1_check_bwd_aligned(**operands(torch.bfloat16, operand))


def test_v1_matches_v2(v1):
    """The port's mirror of JAX's test_masked_path_v2_matches_v1: the
    BSLongformer layout under a 'mul' attention mask, output and grads of
    the v1 route (K14-K16) against the default one (K8-K10), the port
    alone, at JAX's tolerance."""
    from deepspeed_tpu_torch.ops.sparse_attention import (
        BSLongformerSparsityConfig, block_sparse_attention)
    from deepspeed_tpu_torch.ops.sparse_attention import blocksparse as tbs
    B, H, s, d = 1, 2, 64, 16
    layout = BSLongformerSparsityConfig(num_heads=H, block=16).make_layout(s)
    rng = np.random.RandomState(7)
    q, k, v = (torch.from_numpy(a) for a in _inputs(rng, B, H, s, d)[:3])
    am = torch.from_numpy((np.random.RandomState(3).rand(s, s) > 0.2)
                          .astype(np.float32))

    def run(use_v2):
        v1(USE_SPLASH_V2=use_v2)
        assert tbs.planned_kernel(layout, 16, has_am=True).startswith(
            "v2" if use_v2 else "v1")
        args = [t.clone().requires_grad_() for t in (q, k, v)]
        o = block_sparse_attention(*args, layout, attn_mask=am,
                                   attn_mask_mode="mul")
        return [o.detach()] + list(torch.autograd.grad((o ** 2).sum(), args))
    new, old = run(True), run(False)
    np.testing.assert_allclose(new[0].numpy(), old[0].numpy(),
                               atol=V2_TOL["o"][0], rtol=V2_TOL["o"][1])
    for a, b in zip(new[1:], old[1:]):
        np.testing.assert_allclose(a.numpy(), b.numpy(),
                                   atol=V2_TOL["grads"][0],
                                   rtol=V2_TOL["grads"][1])


def test_masks_take_no_gradient_and_wrappers_count_only_launches(v1):
    """The key mask and the attention mask get zero grads, as JAX's vjp
    returns; on CPU tensors the wrappers run the plain versions and count
    no launch; shapes the kernels and plain versions cannot take
    raise."""
    from deepspeed_tpu_torch.ops.sparse_attention import blocksparse as tbs
    rng = np.random.RandomState(3)
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(rng, 1, 2, 64))
    layout = _layouts(64, 16)["fixed_per_head"]
    am = torch.from_numpy(rng.randn(64, 64).astype(np.float32)
                          ).requires_grad_()
    kpm = torch.zeros(1, 64, requires_grad=True)
    tbs.reset_launches()
    o = tbs.block_sparse_attention(q, k, v, layout, attn_mask=am,
                                   attn_mask_mode="add",
                                   key_padding_mask=kpm)
    g_am, g_kpm = torch.autograd.grad(o.sum(), (am, kpm))
    assert (g_am == 0).all() and (g_kpm == 0).all()
    assert [w.launches for w in (tbs.bs_fwd, tbs.bs_dq, tbs.bs_dkv)] == \
        [0, 0, 0]
    assert tbs.v1_arity(kpm, am) == "am kpm"
    assert tbs.v1_arity(None, None) == "plain"
    plan = tbs.TriplePlan(layout, 16)
    with pytest.raises(ValueError, match="heads"):
        tbs.bs_fwd(q[:, :1], k[:, :1], v[:, :1], None, None, plan, 0.25)
    with pytest.raises(ValueError, match="attention mask"):
        tbs.bs_fwd(q, k, v, None, am.detach()[:32], plan, 0.25)


# ------------------------------------------------- sparse BERT on v1
TINY = dict(vocab_size=97, hidden_size=64, num_layers=2, num_heads=4,
            intermediate_size=128, max_position_embeddings=128)


def test_mlm_loss_v1_matches_jax(v1):
    """bert_mlm_loss_fn with the fixed sparse_attention of
    ds_config_sparse.json (block 16, S 128) under USE_MASKED_FLASH =
    False and USE_SPLASH_V2 = False on both sides (the legacy dispatch on
    a layout that is not banded: K14-K16 with BERT's key mask), fp32, on
    a padded batch: loss and every grad."""
    import jax
    import jax.numpy as jnp
    from deepspeed_tpu.models import bert as jb
    from deepspeed_tpu.ops.sparse_attention import blocksparse as jbs
    from deepspeed_tpu.ops.sparse_attention import \
        sparsity_config_from_dict as jfrom
    from deepspeed_tpu.runtime.config import get_sparse_attention

    from deepspeed_tpu_torch.models import bert as tb
    from deepspeed_tpu_torch.ops.sparse_attention import blocksparse as tbs
    from deepspeed_tpu_torch.ops.sparse_attention import \
        sparsity_config_from_dict as tfrom
    from deepspeed_tpu_torch.utils.tree import tree_leaves
    v1(USE_MASKED_FLASH=False)
    raw = json.loads((REPO / "examples/bing_bert/ds_config_sparse.json"
                      ).read_text())
    sa = get_sparse_attention(raw)
    jsc, tsc = jfrom(sa, num_heads=4), tfrom(sa, num_heads=4)
    s = TINY["max_position_embeddings"]
    assert tbs.planned_kernel(tsc.make_layout(s), 16, cpu=True) == "v1" == \
        jbs.planned_kernel(jsc.make_layout(s), 16, interpret=True)
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
    # (B, H, S, D, layout, block, key mask, attention mask, dtype)
    (8, 16, 2048, 64, "fixed_main", 16, "mul", "mul", "bf16"),  # path 1
    (8, 16, 2048, 64, "fixed_main", 16, "mul", None, "bf16"),   # path 2
    (1, 16, 8192, 64, "bslongformer", 128, None, None, "bf16"),  # path 3
    (2, 4, 512, 64, "empty_row_and_column", 32, "add", "add", "fp32"),
    (2, 4, 512, 32, "bigbird", 64, None, "mul", "bf16"),
    (2, 4, 512, 128, "fixed_main", 16, "add", None, "fp32"),
    # K14's tensor-core body: blocks 16-128, head dims 64, 72, 128, each
    # mask alone and both, an empty block row, a row whose only keys sit
    # at -5e28 ("far": p = 0 under -1e28, so o = 0 and lse = -5e28)
    (2, 4, 512, 72, "bslongformer", 32, "mul", "mul", "bf16"),
    (2, 4, 512, 128, "bigbird", 128, None, "add", "bf16"),
    (2, 4, 512, 64, "empty_row_and_column", 64, "add", None, "bf16"),
    (2, 4, 512, 64, "fixed_main", 16, "mul", "far", "bf16"),
    (2, 4, 512, 72, "empty_row_and_column", 16, None, "mul", "bf16"),
    # K15's and K16's tensor-core bodies under an 'add' mask of finite
    # values with the -5e28 row, at block 64 (two chunks a tile)
    (2, 4, 512, 128, "bslongformer", 64, "add", "far", "bf16"),
]


def _cuda_layout(name, H, s, fb):
    from deepspeed_tpu_torch.ops.sparse_attention import (
        BigBirdSparsityConfig, BSLongformerSparsityConfig,
        sparsity_config_from_dict)
    if name == "fixed_main":
        raw = json.loads((REPO / "examples/bing_bert/ds_config_sparse.json"
                          ).read_text())["sparse_attention"]
        return sparsity_config_from_dict(raw, num_heads=H).make_layout(s)
    if name == "bigbird":
        return BigBirdSparsityConfig(num_heads=H, block=fb).make_layout(s)
    if name == "bslongformer":
        return BSLongformerSparsityConfig(
            num_heads=H, block=fb, num_sliding_window_blocks=3
        ).make_layout(s)
    n = s // fb
    lay = (np.random.RandomState(4).rand(H, n, n) < 0.4).astype(np.int32)
    lay[0, 3] = 0
    lay[1, :, 5] = 0
    return lay


@pytest.mark.cuda
@pytest.mark.parametrize("case", CUDA_CASES)
def test_cuda_kernels_match_plain(case):
    """K14, K15 and K16 on the card against their plain versions on the
    same inputs (K15 and K16 take the plain forward's lse), one launch
    each counted under its arity: the three paths' shapes and S 512 cases
    with an empty block row and column, blocks 16-128, fp32; each kernel
    runs its tensor-core body in bf16, its CUDA-core body in fp32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from deepspeed_tpu_torch.ops.sparse_attention import blocksparse as tbs
    B, H, s, d, name, fb, kpm_mode, am_mode, dtype = case
    rng = np.random.RandomState(s + d)
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    q, k, v, do = (torch.from_numpy(a).to("cuda", td)
                   for a in _inputs(rng, B, H, s, d))
    layout = _cuda_layout(name, H, s, fb)
    kpm = _key_mask(rng, B, s, kpm_mode)
    am = _attn_mask(rng, s, "add" if am_mode == "far" else am_mode)
    far = 70                       # "far": its walked keys sit at -5e28
    if am_mode == "far":
        am[far] = -1e30
        am[far, np.nonzero(np.kron(layout[0, far // fb],
                                   np.ones(fb)))[0][:3]] = -5e28
    key = None if kpm is None else tbs._to_additive(
        torch.from_numpy(kpm), kpm_mode).cuda()
    amt = None if am is None else tbs._to_additive(
        torch.from_numpy(am), "add" if am_mode == "far" else am_mode).cuda()
    plan = tbs.TriplePlan(layout, fb)
    scale = 1.0 / np.sqrt(d)
    tbs.reset_launches()
    o, lse = tbs.bs_fwd(q, k, v, key, amt, plan, scale)
    o_p, lse_p = tbs.bs_fwd_plain(q, k, v, key, amt, plan, scale)
    delta = (do.float() * o_p.float()).sum(-1)
    args = (q, k, v, do, lse_p, delta, key, amt, plan, scale)
    got = [o, tbs.bs_dq(*args), *tbs.bs_dkv(*args)]
    torch.cuda.synchronize()
    arity = tbs.v1_arity(key, amt)
    assert [w.arities for w in (tbs.bs_fwd, tbs.bs_dq, tbs.bs_dkv)] == \
        [{arity: 1}] * 3
    want = [o_p, tbs.bs_dq_plain(*args), *tbs.bs_dkv_plain(*args)]
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        a, b = a.float().cpu().numpy(), b.float().cpu().numpy()
        if dtype == "fp32":
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-4)
        else:
            ratio, rel_rms, ok = _bf16_check(a, b, **BF16_TOL)
            assert ok, (ratio, rel_rms)
    assert torch.equal(lse == -1e30, lse_p == -1e30)
    assert float((lse - lse_p).abs().max()) <= 1e-3
    assert [tbs.bs_fwd.bodies, tbs.bs_dq.bodies, tbs.bs_dkv.bodies] == [
        {tbs.FWD_BODIES[td]: 1}, {tbs.DQ_BODIES[td]: 1},
        {tbs.DKV_BODIES[td]: 1}]
    if name == "empty_row_and_column":
        assert (o[:, 0, 3 * fb:4 * fb] == 0).all()
        assert (lse[:, 0, 3 * fb:4 * fb] == -1e30).all()
    if am_mode == "far":
        assert (o[0, 0, far] == 0).all()
        assert (lse[0, 0, far] == np.float32(-5e28)).all()
