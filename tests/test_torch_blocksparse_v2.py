"""The port's row-run block-sparse attention (deepspeed_tpu_torch/ops/
sparse_attention/blocksparse_v2.py, the ``attn_mask`` route of
blocksparse.py, and ops.py) against the JAX package on the CPU.

The same numpy inputs, made from a seed, go through both. The JAX side
runs its Pallas kernels K8-K10 (``build_v2_impls(..., interpret=True,
has_am=True)``) in interpret mode; the port runs their plain versions.
Tolerances:

- ``build_row_runs``, ``build_am_index``, ``build_coarse_index``: equal,
  bitwise, every array;
- K8-K10 and the front end, fp32: atol 2e-5 (JAX's own for its kernels,
  ``tests/unit/test_sparse_attention.py``; the sums run in another order);
  bf16: every element within 1e-4 + 2**-7 |want| (one bf16 ulp: both sides
  round the same fp32 values, p before P.V and ds before its products)
  and the whole tensor within a relative RMS error of 1e-3;
- a coarse walk against the fine walk: JAX's
  ``test_coarse_walk_matches_fine`` tolerance, o atol 1e-5 + rtol 1e-5,
  grads atol 5e-5 + rtol 5e-4 (the online softmax groups its sums per
  coarse tile);
- ``MatMul`` and ``Softmax``: atol 2e-5 (2e-4 for ``dds``, JAX's).

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
COARSE_TOL = dict(o=(1e-5, 1e-5), grads=(5e-5, 5e-4))
FB = 16


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


def _layouts():
    """Layout families (H 2, S 128, block 16) keyed by name: fixed with a
    pattern per head, BigBird, BSLongformer, variable, and a per-head
    layout with empty block rows and columns."""
    from deepspeed_tpu_torch.ops.sparse_attention import (
        BigBirdSparsityConfig, BSLongformerSparsityConfig,
        FixedSparsityConfig, VariableSparsityConfig)
    s = 128
    empty = (np.random.RandomState(4).rand(2, 8, 8) < 0.4).astype(np.int32)
    empty[:, 3] = 0
    empty[0, :, 5] = 0
    return {
        "fixed_per_head": FixedSparsityConfig(
            num_heads=2, block=FB, num_local_blocks=2,
            different_layout_per_head=True,
            num_different_global_patterns=2).make_layout(s),
        "bigbird": BigBirdSparsityConfig(
            num_heads=2, block=FB, num_random_blocks=1).make_layout(s),
        "bslongformer": BSLongformerSparsityConfig(
            num_heads=2, block=FB).make_layout(s),
        "variable": VariableSparsityConfig(
            num_heads=2, block=FB, num_random_blocks=1,
            local_window_blocks=[2]).make_layout(s),
        "empty_rows": empty,
    }


# ------------------------------------------------------------ builders
@pytest.mark.parametrize("name", ["fixed_per_head", "bigbird",
                                  "bslongformer", "variable", "empty_rows"])
def test_builders_match_jax(name):
    """build_row_runs (rows and columns), build_am_index and
    build_coarse_index (walks 32, 64, 128; per_coord both ways;
    count_only) equal JAX's, every array."""
    from deepspeed_tpu.ops.sparse_attention import blocksparse_v2 as jv2

    from deepspeed_tpu_torch.ops.sparse_attention import blocksparse_v2 as tv2
    layout = _layouts()[name]
    lt = np.ascontiguousarray(layout.transpose(0, 2, 1))
    if name == "empty_rows":
        assert (tv2.build_row_runs(layout)[2] == 0).any()
        assert (tv2.build_row_runs(lt)[2] == 0).any()
    pairs = [(tv2.build_row_runs(layout), jv2.build_row_runs(layout)),
             (tv2.build_row_runs(lt), jv2.build_row_runs(lt)),
             (tv2.build_am_index(layout), jv2.build_am_index(layout))]
    for cb in (32, 64, 128):
        for per_coord in (False, True):
            pairs.append((tv2.build_coarse_index(layout, FB, cb, per_coord),
                          jv2.build_coarse_index(layout, FB, cb, per_coord)))
            assert tv2.build_coarse_index(layout, FB, cb, per_coord,
                                          count_only=True) == \
                jv2.build_coarse_index(layout, FB, cb, per_coord,
                                       count_only=True)
    for ours, theirs in pairs:
        assert len(ours) == len(theirs)
        for a, b in zip(ours, theirs):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_builders_of_an_empty_layout_match_jax():
    from deepspeed_tpu.ops.sparse_attention import blocksparse_v2 as jv2

    from deepspeed_tpu_torch.ops.sparse_attention import blocksparse_v2 as tv2
    layout = np.zeros((2, 4, 4), np.int32)
    for ours, theirs in ((tv2.build_row_runs(layout),
                          jv2.build_row_runs(layout)),
                         (tv2.build_am_index(layout),
                          jv2.build_am_index(layout)),
                         (tv2.build_coarse_index(layout, FB, 32, True),
                          jv2.build_coarse_index(layout, FB, 32, True))):
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a, b)


# ------------------------------------------- K8-K10, plain vs Pallas
def _inputs(rng, B, H, s, d=16):
    return [(rng.randn(B, H, s, d) * 0.5).astype(np.float32)
            for _ in range(4)]


def _masks(rng, B, s, mode, pad_row=True):
    """A (B, S) additive key mask ('mul': -1e30 on pads, a batch row of
    pads when ``pad_row``) and an (S, S) attention mask in ``mode``:
    'mul' keeps 80% of cells and drops every key of rows 3 and 40; 'add'
    holds finite values, -1e4 where 'mul' drops."""
    lengths = rng.randint(s // 2, s + 1, size=B)
    keep = (np.arange(s)[None, :] < lengths[:, None]).astype(np.float32)
    if pad_row:
        keep[-1] = 0.0
    kpm = np.where(keep == 0, -1e30, 0.0).astype(np.float32)
    am = (rng.rand(s, s) > 0.2).astype(np.float32)
    am[[3, 40]] = 0.0
    if mode == "add":
        am = np.where(am == 0, -1e4,
                      rng.randn(s, s).astype(np.float32)).astype(np.float32)
    return kpm, am


def _jax_v2(layout, coarse, q, k, v, do, kpm, am_add, dtype):
    """o, lse, dq, dk, dv of JAX's K8-K10 in interpret mode: fwd_impl,
    then bwd_impl on its o and lse."""
    import jax.numpy as jnp
    from deepspeed_tpu.ops.sparse_attention.blocksparse import (_block_am,
                                                                _block_kpm)
    from deepspeed_tpu.ops.sparse_attention.blocksparse_v2 import \
        build_v2_impls
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    jq, jk, jv, jdo = (jnp.asarray(a).astype(jd) for a in (q, k, v, do))
    B, H, s, d = q.shape
    fwd, bwd = build_v2_impls(layout, FB, 1.0 / np.sqrt(d), interpret=True,
                              has_am=True, coarse_block=coarse)
    kb = _block_kpm(jnp.asarray(kpm), FB)
    ab = _block_am(jnp.asarray(am_add), FB)
    o, lse = fwd(jq, jk, jv, kb, ab)
    dq, dk, dv = bwd(jq, jk, jv, kb, ab, o, lse, jdo)
    return [np.asarray(x.astype(jnp.float32)) for x in (o, dq, dk, dv)] + [
        np.asarray(lse).reshape(B, H, s)]


def _port_v2(layout, coarse, q, k, v, do, kpm, am_add, dtype, o=None,
             lse=None):
    """o, lse of the port's K8 (plain version), and dq, dk, dv of K9 and
    K10 fed ``o`` and ``lse`` (K8's own by default)."""
    from deepspeed_tpu_torch.ops.sparse_attention import blocksparse_v2 as tv2
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    tq, tk, tv, tdo = (torch.from_numpy(a).to(td) for a in (q, k, v, do))
    plan = tv2.RowRunPlan(layout, FB, coarse)
    tiles = plan.mask_tiles(torch.from_numpy(am_add))
    key = torch.from_numpy(kpm)
    scale = 1.0 / np.sqrt(q.shape[-1])
    o_k, lse_k = tv2.blocksparse_v2_fwd(tq, tk, tv, key, tiles, plan, scale)
    o_in = o_k if o is None else torch.from_numpy(o.copy()).to(td)
    lse_in = lse_k if lse is None else torch.from_numpy(lse.copy())
    delta = (tdo.float() * o_in.float()).sum(-1)
    args = (tq, tk, tv, tdo, lse_in, delta, key, tiles, plan, scale)
    dq = tv2.blocksparse_v2_dq(*args)
    dk, dv = tv2.blocksparse_v2_dkv(*args)
    return [x.float().numpy() for x in (o_k, dq, dk, dv)] + [lse_k.numpy()]


V2_CASES = [
    # (layout, coarse walk, mask mode, dtype)
    ("fixed_per_head", None, "mul", "fp32"),
    ("fixed_per_head", None, "mul", "bf16"),
    ("bigbird", None, "add", "fp32"),
    ("empty_rows", None, "mul", "fp32"),
    ("bslongformer", 64, "mul", "fp32"),
    ("fixed_per_head", 32, "add", "bf16"),
    ("variable", 128, "mul", "bf16"),
]


@pytest.mark.parametrize("case", range(len(V2_CASES)))
def test_plain_kernels_match_jax(case):
    """K8 (o, lse), K9 (dq) and K10 (dk, dv) as plain versions against
    JAX's Pallas kernels in interpret mode, on the same inputs (K9 and K10
    get JAX's o and lse), fine and coarse walks, 'mul' and 'add' masks, a
    key mask with a batch row of pads and mask rows that drop every key:
    those rows give o = 0 and lse = m on both sides."""
    name, coarse, mode, dtype = V2_CASES[case]
    layout = _layouts()[name]
    rng = np.random.RandomState(case)
    B, H, s = 2, 2, 128
    q, k, v, do = _inputs(rng, B, H, s)
    kpm, am = _masks(rng, B, s, mode)
    am_add = np.where(am == 0, -1e30, 0.0).astype(np.float32) \
        if mode == "mul" else am
    want = _jax_v2(layout, coarse, q, k, v, do, kpm, am_add, dtype)
    got = _port_v2(layout, coarse, q, k, v, do, kpm, am_add, dtype,
                   o=want[0], lse=want[4])
    for g, w in zip(got[:4], want[:4]):
        assert np.isfinite(g).all()
        _assert_close(g, w, dtype)
    np.testing.assert_allclose(got[4], want[4], rtol=1e-6,
                               atol=FP32_ATOL)
    if mode == "mul":
        # the pad row and the rows whose every key is dropped: o = 0
        assert (got[0][-1] == 0).all() and (want[0][-1] == 0).all()
        assert (got[0][:, :, [3, 40]] == 0).all()


@pytest.mark.parametrize("coarse", [32, 64, 128])
def test_coarse_walk_matches_fine(coarse):
    """A coarse walk (the fine structure and the user mask folded into
    per-coordinate tiles) against the fine walk, the port alone."""
    layout = _layouts()["bslongformer"]
    rng = np.random.RandomState(coarse)
    q, k, v, do = _inputs(rng, 2, 2, 128)
    kpm, am = _masks(rng, 2, 128, "mul")
    am_add = np.where(am == 0, -1e30, 0.0).astype(np.float32)
    c = _port_v2(layout, coarse, q, k, v, do, kpm, am_add, "fp32")
    f = _port_v2(layout, None, q, k, v, do, kpm, am_add, "fp32")
    np.testing.assert_allclose(c[0], f[0], atol=COARSE_TOL["o"][0],
                               rtol=COARSE_TOL["o"][1])
    for a, b in zip(c[1:4], f[1:4]):
        np.testing.assert_allclose(a, b, atol=COARSE_TOL["grads"][0],
                                   rtol=COARSE_TOL["grads"][1])


def test_plain_versions_without_the_mask_tiles_fail():
    """The control: the plain versions with the mask tiles left out (all
    zero) fail the fp32 check against JAX on every output."""
    layout = _layouts()["fixed_per_head"]
    rng = np.random.RandomState(11)
    q, k, v, do = _inputs(rng, 2, 2, 128)
    kpm, am = _masks(rng, 2, 128, "mul", pad_row=False)
    am_add = np.where(am == 0, -1e30, 0.0).astype(np.float32)
    want = _jax_v2(layout, None, q, k, v, do, kpm, am_add, "fp32")
    got = _port_v2(layout, None, q, k, v, do, kpm,
                   np.zeros_like(am_add), "fp32", o=want[0], lse=want[4])
    for g, w in zip(got[:4], want[:4]):
        with pytest.raises(AssertionError):
            _assert_close(g, w, "fp32")


def test_plain_k8_keeps_a_row_at_minus_5e28():
    """K8's threshold is -1e29: a row whose only unmasked keys sit at
    -5e28 ('add') attends over them, in the port's plain K8 as in JAX's
    interpret-mode K8 (o != 0, lse = -5e28 in both), where K14's -1e28
    gives p = 0 (test_torch_blocksparse_v1.py)."""
    layout = _layouts()["fixed_per_head"]
    rng = np.random.RandomState(12)
    B, H, s, row = 2, 2, 128, 70
    q, k, v, do = _inputs(rng, B, H, s)
    kpm = np.zeros((B, s), np.float32)
    am = rng.randn(s, s).astype(np.float32)
    am[row] = -1e30
    keys = np.nonzero(np.kron(layout[0, row // FB], np.ones(FB)))[0][:3]
    am[row, keys] = -5e28
    want = _jax_v2(layout, None, q, k, v, do, kpm, am, "fp32")
    got = _port_v2(layout, None, q, k, v, do, kpm, am, "fp32",
                   o=want[0], lse=want[4])
    for g, w in zip(got[:4], want[:4]):
        _assert_close(g, w, "fp32")
    np.testing.assert_allclose(got[4], want[4], rtol=1e-6, atol=FP32_ATOL)
    assert (got[0][:, 0, row] != 0).any() and (want[0][:, 0, row] != 0).any()
    assert (got[4][:, 0, row] == np.float32(-5e28)).all()


@pytest.mark.parametrize("dtype, body", [(torch.bfloat16, "mma"),
                                         (torch.float32, "fma")])
def test_forward_body_by_dtype(dtype, body):
    """K8 names the body a dtype runs: bf16 on K1's tensor-core forward
    body (csrc/mma_fwd.cuh), fp32 on the CUDA cores; ``reset_launches``
    zeroes its counts by body."""
    from deepspeed_tpu_torch.ops.attention.masked_flash import _count_body
    from deepspeed_tpu_torch.ops.sparse_attention import blocksparse_v2 as tv2
    assert tv2.FWD_BODIES[dtype] == body
    wrapper = tv2.blocksparse_v2_fwd
    saved = dict(wrapper.bodies)
    try:
        _count_body(wrapper, dtype, tv2.FWD_BODIES)
        _count_body(wrapper, dtype, tv2.FWD_BODIES)
        assert wrapper.bodies[body] == saved.get(body, 0) + 2
        tv2.reset_launches()
        assert wrapper.bodies == {}
    finally:
        wrapper.bodies = saved


@pytest.mark.parametrize("operand", ["q", "k", "v", "key_mask", "tiles"])
def test_bf16_forward_refuses_misaligned_operands(operand):
    """K8's tensor-core body loads 16-byte rows (q, k, v) and 8-byte
    pairs of the key mask and the mask tiles: a bf16 call whose operand
    starts off those boundaries raises before any launch, an aligned one
    and fp32 pass."""
    from deepspeed_tpu_torch.ops.sparse_attention.blocksparse_v2 import \
        _check_fwd_aligned
    shape, n = (1, 2, 32, 16), 2 * 32 * 16

    def operands(dtype, off=None):
        ts = {name: torch.zeros(n + 8, dtype=dtype)[:n].view(shape)
              for name in ("q", "k", "v")}
        ts["key_mask"] = torch.zeros(33)[:32].view(1, 32)
        ts["tiles"] = torch.zeros(2 * 16 * 16 + 2)[:512].view(2, 16, 16)
        if off is not None:
            base = torch.zeros(n + 8, dtype=ts[off].dtype)
            ts[off] = base[1:1 + ts[off].numel()].view(ts[off].shape) \
                if ts[off].dtype == torch.float32 else \
                base[4:4 + n].view(shape)
        return ts

    _check_fwd_aligned(**operands(torch.bfloat16))
    _check_fwd_aligned(**operands(torch.float32, operand))
    with pytest.raises(ValueError, match=f"{operand} aligned"):
        _check_fwd_aligned(**operands(torch.bfloat16, operand))


def _body_by_dtype(kernel, table, dtype, body):
    """``kernel`` of K9/K10 names the body ``dtype`` runs by ``table``;
    ``reset_launches`` zeroes the counts by body of all three kernels."""
    from deepspeed_tpu_torch.ops.attention.masked_flash import _count_body
    from deepspeed_tpu_torch.ops.sparse_attention import blocksparse_v2 as tv2
    bodies, wrapper = getattr(tv2, table), getattr(tv2, kernel)
    assert bodies[dtype] == body
    names = ("blocksparse_v2_fwd", "blocksparse_v2_dq", "blocksparse_v2_dkv")
    saved = {n: dict(getattr(tv2, n).bodies) for n in names}
    try:
        _count_body(wrapper, dtype, bodies)
        _count_body(wrapper, dtype, bodies)
        _count_body(tv2.blocksparse_v2_fwd, dtype, tv2.FWD_BODIES)
        assert wrapper.bodies[body] == saved[kernel].get(body, 0) + 2
        tv2.reset_launches()
        assert [getattr(tv2, n).bodies for n in names] == [{}, {}, {}]
    finally:
        for n, b in saved.items():
            getattr(tv2, n).bodies = b


@pytest.mark.parametrize("dtype, body", [(torch.bfloat16, "mma"),
                                         (torch.float32, "fma")])
def test_dq_body_by_dtype(dtype, body):
    """K9 names the body a dtype runs: bf16 on K2's tensor-core dq body
    (csrc/mma_dq.cuh), fp32 on the CUDA cores; ``reset_launches`` zeroes
    the counts by body of K8-K10."""
    _body_by_dtype("blocksparse_v2_dq", "DQ_BODIES", dtype, body)


@pytest.mark.parametrize("dtype, body", [(torch.bfloat16, "mma"),
                                         (torch.float32, "fma")])
def test_dkv_body_by_dtype(dtype, body):
    """K10 names the body a dtype runs: bf16 on K3's tensor-core dk/dv
    body (csrc/mma_dkv.cuh), fp32 on the CUDA cores; ``reset_launches``
    zeroes the counts by body of K8-K10."""
    _body_by_dtype("blocksparse_v2_dkv", "DKV_BODIES", dtype, body)


@pytest.mark.parametrize("operand", ["q", "k", "v", "do", "key_mask",
                                     "tiles"])
def test_bf16_backward_refuses_misaligned_operands(operand):
    """K9's and K10's tensor-core bodies load 16-byte rows (q, k, v, do)
    and 8-byte pairs of the key mask and the mask tiles: a bf16 call
    whose operand starts off those boundaries raises before any launch,
    an aligned one and fp32 pass."""
    from deepspeed_tpu_torch.ops.sparse_attention.blocksparse_v2 import \
        _check_bwd_aligned
    shape, n = (1, 2, 32, 16), 2 * 32 * 16

    def operands(dtype, off=None):
        ts = {name: torch.zeros(n + 8, dtype=dtype)[:n].view(shape)
              for name in ("q", "k", "v", "do")}
        ts["key_mask"] = torch.zeros(33)[:32].view(1, 32)
        ts["tiles"] = torch.zeros(2 * 16 * 16 + 2)[:512].view(2, 16, 16)
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


def test_backward_tally_argument():
    """K9's and K10's ``tally`` is None or one int64 on q's device: any
    other dtype, size or device raises before a launch; the CPU path
    runs the plain versions, which count no cell, and leaves it as it
    was."""
    from deepspeed_tpu_torch.ops.sparse_attention import blocksparse_v2 as tv2
    q = torch.zeros(1, 2, 32, 16)
    tv2._check_tally(None, q)
    tv2._check_tally(torch.zeros(1, dtype=torch.int64), q)
    for bad in (torch.zeros(1, dtype=torch.int32),
                torch.zeros(2, dtype=torch.int64),
                torch.zeros(1, dtype=torch.int64, device="meta")):
        with pytest.raises(ValueError, match="a tally is one int64"):
            tv2._check_tally(bad, q)
    layout = _layouts()["fixed_per_head"][:, :2, :2]
    rng = np.random.RandomState(9)
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(rng, 1, 2, 32, 16))
    plan = tv2.RowRunPlan(layout, FB)
    lse = torch.zeros(1, 2, 32)
    tally = torch.full((1,), 7, dtype=torch.int64)
    args = (q, k, v, do, lse, lse, None, None, plan, 0.25)
    dq = tv2.blocksparse_v2_dq(*args, tally=tally)
    dk, dv = tv2.blocksparse_v2_dkv(*args, tally=tally)
    torch.testing.assert_close(dq, tv2.blocksparse_v2_dq_plain(*args))
    for got, want in zip((dk, dv), tv2.blocksparse_v2_dkv_plain(*args)):
        torch.testing.assert_close(got, want)
    assert int(tally) == 7


# ------------------------------------------------------- the front end
FRONT_CASES = [
    # (mode, config kwargs, attn mask kind, key mask mode, dtype)
    ("bigbird", {}, "causal_mul", None, "fp32"),       # test_kernel_attn_mask_mul
    ("bslongformer", {}, "random_mul", "add", "fp32"),  # ..._gradients_with_masks
    ("fixed", dict(different_layout_per_head=True, num_local_blocks=2,
                   num_different_global_patterns=2), "random_add", "mul",
     "fp32"),
    ("fixed", dict(different_layout_per_head=True, num_local_blocks=2,
                   num_different_global_patterns=2), "random_mul", "mul",
     "bf16"),
]


def _front_masks(rng, kind, kpm_mode, B, s):
    if kind == "causal_mul":
        am, mode = np.tril(np.ones((s, s), np.float32)), "mul"
    elif kind == "random_mul":
        am, mode = (rng.rand(s, s) > 0.2).astype(np.float32), "mul"
    else:
        am, mode = rng.randn(s, s).astype(np.float32), "add"
    kpm = None
    if kpm_mode is not None:
        keep = np.arange(s)[None, :] < rng.randint(s // 2, s + 1,
                                                     B)[:, None]
        kpm = (keep.astype(np.float32) if kpm_mode == "mul"
               else np.where(keep, 0.0, -1e9).astype(np.float32))
    return am, mode, kpm


def _front_case(case, force=None):
    """FRONT_CASES[case] through block_sparse_attention: the port's output
    and q/k/v grads, JAX's dispatch in interpret mode on the same inputs,
    and the port's dense reference in fp32 on the same (rounded) inputs.
    ``force``: None, both rules pick their walk; else both walk it (0:
    the fine walk)."""
    import jax
    import jax.numpy as jnp
    from deepspeed_tpu.ops.sparse_attention import blocksparse as jbs

    from deepspeed_tpu_torch.ops.sparse_attention import blocksparse as tbs
    from deepspeed_tpu_torch.ops.sparse_attention import sparsity_config as sc
    mode, kw, am_kind, kpm_mode, dtype = FRONT_CASES[case]
    classes = {"bigbird": sc.BigBirdSparsityConfig,
               "bslongformer": sc.BSLongformerSparsityConfig,
               "fixed": sc.FixedSparsityConfig}
    B, H, s = 2, 2, 128
    layout = classes[mode](num_heads=H, block=FB, **kw).make_layout(s)
    rng = np.random.RandomState(20 + case)
    q, k, v, do = _inputs(rng, B, H, s)
    am, am_mode, kpm = _front_masks(rng, am_kind, kpm_mode, B, s)
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    kw_j = dict(attn_mask=jnp.asarray(am), attn_mask_mode=am_mode)
    kw_t = dict(attn_mask=torch.from_numpy(am), attn_mask_mode=am_mode)
    if kpm is not None:
        kw_j.update(key_padding_mask=jnp.asarray(kpm),
                    key_padding_mask_mode=kpm_mode)
        kw_t.update(key_padding_mask=torch.from_numpy(kpm),
                    key_padding_mask_mode=kpm_mode)

    def jf(a, b, c):
        return jbs.block_sparse_attention(a, b, c, layout, interpret=True,
                                          **kw_j)
    old = (jbs._FORCE_COARSE_BLOCK, tbs._FORCE_COARSE_BLOCK)
    jbs._FORCE_COARSE_BLOCK = tbs._FORCE_COARSE_BLOCK = force
    try:
        jo, vjp = jax.vjp(jf, *(jnp.asarray(a).astype(jd)
                                for a in (q, k, v)))
        want = [np.asarray(x.astype(jnp.float32))
                for x in (jo, *vjp(jnp.asarray(do).astype(jd)))]
        args = [torch.from_numpy(a).to(td).requires_grad_()
                for a in (q, k, v)]
        o = tbs.block_sparse_attention(*args, layout, **kw_t)
        got = [o.detach().float().numpy()] + [
            g.float().numpy() for g in torch.autograd.grad(
                o, args, torch.from_numpy(do).to(td))]
    finally:
        jbs._FORCE_COARSE_BLOCK, tbs._FORCE_COARSE_BLOCK = old
    args = [torch.from_numpy(a).to(td).float().requires_grad_()
            for a in (q, k, v)]
    o = tbs.block_sparse_attention_reference(*args, layout, **kw_t)
    ref = [o.detach().numpy()] + [g.numpy() for g in torch.autograd.grad(
        o, args, torch.from_numpy(do).to(td).float())]
    return got, want, ref, dtype


@pytest.mark.parametrize("case", range(len(FRONT_CASES)))
def test_block_sparse_attention_with_attn_mask_matches_jax(case):
    """block_sparse_attention with an (S, S) attention mask (and a key
    mask): output and q/k/v grads against JAX's dispatch in interpret
    mode (its v2 route, coarse by its own rule) and the port's dense
    reference."""
    got, want, ref, dtype = _front_case(case)
    for g, w in zip(got, want):
        assert np.isfinite(g).all()
        _assert_close(g, w, dtype)
    if dtype == "fp32":
        np.testing.assert_allclose(ref[0], got[0], atol=FP32_ATOL)


# a bf16 output's rms error against the fp32 dense reference: its own
# rounding (2^-9 relative) and the bf16 inputs' products
BF16_REF_RMS = 2.0**-8


@pytest.mark.parametrize("force", [0, 128])
def test_bf16_walks_match_jax_and_dense_reference(force):
    """FRONT_CASES' bf16 case at the fine walk and at a walk of 128 (one
    tile per head): each agrees with JAX's dispatch forced to the same
    walk, and lands within BF16_REF_RMS of the fp32 dense reference. The
    two walks round other fp32 values to bf16 and differ from each other
    beyond BF16_TOL, so the automatic comparison above holds only while
    the port's rule walks this layout as JAX's does (fine)."""
    case = next(i for i, c in enumerate(FRONT_CASES) if c[-1] == "bf16")
    got, want, ref, _ = _front_case(case, force)
    for g, w, r in zip(got, want, ref):
        assert np.isfinite(g).all()
        _assert_close(g, w, "bf16")
        assert np.linalg.norm(g - r) / np.linalg.norm(r) <= BF16_REF_RMS


def test_sparse_self_attention_with_attn_mask_matches_jax():
    """SparseSelfAttention with a key mask and an attention mask (its
    'mul' default), output and grads against JAX's module."""
    import jax
    import jax.numpy as jnp
    from deepspeed_tpu.ops.sparse_attention import (
        BigBirdSparsityConfig as JCfg, SparseSelfAttention as JSSA)

    from deepspeed_tpu_torch.ops.sparse_attention import (
        BigBirdSparsityConfig as TCfg, SparseSelfAttention as TSSA)
    B, H, s = 2, 2, 128
    rng = np.random.RandomState(7)
    q, k, v, do = _inputs(rng, B, H, s)
    kpm = (np.arange(s)[None, :] < np.array([[90], [128]])).astype(
        np.float32)
    am = (rng.rand(s, s) > 0.3).astype(np.float32)
    jm = JSSA(JCfg(num_heads=H, block=FB), key_padding_mask_mode="mul")
    tm = TSSA(TCfg(num_heads=H, block=FB), key_padding_mask_mode="mul")
    assert tm.attn_mask_mode == jm.attn_mask_mode == "mul"

    def jf(a, b, c):
        return jm(a, b, c, key_padding_mask=jnp.asarray(kpm),
                  attn_mask=jnp.asarray(am))
    jo, vjp = jax.vjp(jf, *(jnp.asarray(a) for a in (q, k, v)))
    want = [np.asarray(x) for x in (jo, *vjp(jnp.asarray(do)))]
    args = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o = tm(*args, key_padding_mask=torch.from_numpy(kpm),
           attn_mask=torch.from_numpy(am))
    got = [o.detach().numpy()] + [g.numpy() for g in torch.autograd.grad(
        o, args, torch.from_numpy(do))]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=FP32_ATOL, rtol=0)


def test_attn_mask_takes_no_gradient():
    """The key mask and the attention mask get zero grads, as JAX's vjp
    returns."""
    from deepspeed_tpu_torch.ops.sparse_attention import (
        FixedSparsityConfig, block_sparse_attention)
    rng = np.random.RandomState(3)
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(rng, 1, 2, 64))
    layout = FixedSparsityConfig(num_heads=2, block=FB).make_layout(64)
    am = torch.from_numpy(rng.randn(64, 64).astype(np.float32)
                          ).requires_grad_()
    kpm = torch.zeros(1, 64, requires_grad=True)
    o = block_sparse_attention(q, k, v, layout, attn_mask=am,
                               attn_mask_mode="add", key_padding_mask=kpm)
    g_am, g_kpm = torch.autograd.grad(o.sum(), (am, kpm))
    assert (g_am == 0).all() and (g_kpm == 0).all()


# ------------------------------------------------ the coarse-walk rule
@pytest.mark.parametrize("force, want", [(0, "v2"), (128, "v2-coarse128"),
                                         (None, None)])
def test_planned_kernel_matches_jax(force, want):
    """planned_kernel(has_am=True): the forced walks name JAX's routes;
    the automatic one is the v2 family in both, with the port's own
    candidates (128, 64, 32 against JAX's 512, 256) and costs."""
    from deepspeed_tpu.ops.sparse_attention import blocksparse as jbs

    from deepspeed_tpu_torch.ops.sparse_attention import blocksparse as tbs
    for layout in _layouts().values():
        old = (jbs._FORCE_COARSE_BLOCK, tbs._FORCE_COARSE_BLOCK)
        jbs._FORCE_COARSE_BLOCK = tbs._FORCE_COARSE_BLOCK = force
        try:
            ours = tbs.planned_kernel(layout, FB, has_am=True)
            theirs = jbs.planned_kernel(layout, FB, has_am=True,
                                        interpret=True)
        finally:
            jbs._FORCE_COARSE_BLOCK, tbs._FORCE_COARSE_BLOCK = old
        if want is not None:
            assert ours == theirs == want
        else:
            assert ours.startswith("v2") and theirs.startswith("v2")
            cb = tbs._pick_coarse_block(layout, FB, True)
            assert ours == (f"v2-coarse{cb}" if cb else "v2")


def test_no_dense_reference_fallback():
    """Where JAX's compiled dispatch sends a user mask to its O(S^2) dense
    reference (a block it cannot stream and no coarse walk that divides
    S), the port keeps the row-run route: the kernels take walk blocks
    16-128, and a walk they cannot take raises on the card."""
    from deepspeed_tpu.ops.sparse_attention import blocksparse as jbs

    from deepspeed_tpu_torch.ops.sparse_attention import blocksparse as tbs
    from deepspeed_tpu_torch.ops.sparse_attention import \
        FixedSparsityConfig
    layout = FixedSparsityConfig(num_heads=2, block=FB).make_layout(192)
    assert jbs.planned_kernel(layout, FB, has_am=True) == \
        "reference-fallback"
    assert tbs.planned_kernel(layout, FB, has_am=True).startswith("v2")
    rng = np.random.RandomState(2)
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(rng, 1, 2, 192))
    am = torch.from_numpy((rng.rand(192, 192) > 0.3).astype(np.float32))
    np.testing.assert_allclose(
        tbs.block_sparse_attention(q, k, v, layout, attn_mask=am).numpy(),
        tbs.block_sparse_attention_reference(q, k, v, layout,
                                             attn_mask=am).numpy(),
        atol=FP32_ATOL)


def test_pick_coarse_block_model(monkeypatch):
    """The port's _pick_coarse_block (JAX's test_pick_coarse_block_model):
    a coarse walk only on a modeled win of more than 10%, the force flag,
    the tile budget, and S that no candidate divides."""
    from deepspeed_tpu_torch.ops.attention import masked_flash as mf
    from deepspeed_tpu_torch.ops.sparse_attention import blocksparse as tbs
    from deepspeed_tpu_torch.ops.sparse_attention import (
        BSLongformerSparsityConfig, DenseSparsityConfig, FixedSparsityConfig,
        sparsity_config_from_dict)
    # a dense layout: a coarse walk computes the fine walk's cells in
    # fewer chunks, and with K8-K10's fitted costs (a small floor per
    # chunk) that wins by more than 10% at 128; a band of 15 blocks, whose
    # coarse tiles hold dropped cells, does not
    wide = DenseSparsityConfig(num_heads=2, block=FB).make_layout(512)
    assert tbs._pick_coarse_block(wide, FB, True) == 128
    band = BSLongformerSparsityConfig(
        num_heads=2, block=FB, num_sliding_window_blocks=15).make_layout(512)
    assert tbs._pick_coarse_block(band, FB, True) is None
    # a cost per cell alone: a coarse walk computes at least the fine
    # walk's cells, no win
    monkeypatch.setitem(mf.WALK_COSTS, "blocksparse_v2", (0.0, 0.0, 1.0))
    assert tbs._pick_coarse_block(wide, FB, True) is None
    # the walk of 32 modeled at 0.95 and at 0.85 of the fine walk's cost:
    # only a win of more than 10% coarsens
    fine = int(np.count_nonzero(wide))
    nnz_c, _ = tbs.build_coarse_index(wide, FB, 32, per_coord=True,
                                      count_only=True)
    monkeypatch.setattr(tbs, "COARSE_WALK_BLOCKS", (32,))
    for ratio, want in ((0.95, None), (0.85, 32)):
        # fine: fine * (p + 256), coarse: nnz_c * (p + 1024)
        p = (1024 * nnz_c - ratio * 256 * fine) / (ratio * fine - nnz_c)
        assert p > 0
        monkeypatch.setitem(mf.WALK_COSTS, "blocksparse_v2", (0.0, p, 1.0))
        assert tbs._pick_coarse_block(wide, FB, True) == want
    monkeypatch.undo()

    monkeypatch.setattr(tbs, "_FORCE_COARSE_BLOCK", 0)
    assert tbs._pick_coarse_block(wide, FB, True) is None
    monkeypatch.setattr(tbs, "_FORCE_COARSE_BLOCK", 64)
    assert tbs._pick_coarse_block(wide, FB, True) == 64
    monkeypatch.setattr(tbs, "_FORCE_COARSE_BLOCK", 256)
    with pytest.raises(ValueError, match="_FORCE_COARSE_BLOCK"):
        tbs._pick_coarse_block(wide, FB, True)
    monkeypatch.undo()
    # S 48 (3 blocks) divides by no candidate
    assert tbs._pick_coarse_block(wide[:, :3, :3], FB, True) is None
    monkeypatch.setattr(tbs, "_COARSE_TILE_BUDGET", 0)
    assert tbs._pick_coarse_block(wide, FB, True) is None
    monkeypatch.undo()
    # a fine block the kernels cannot take: any admitted coarse walk
    odd = FixedSparsityConfig(num_heads=2, block=8).make_layout(256)
    assert tbs._pick_coarse_block(odd, 8, True) is not None
    # the main path: the fixed per-head layouts of ds_config_sparse.json
    # at S 2048; per coordinate the walk of 128 keeps its unique tiles
    # inside the budget (16 heads x 256 coordinates of 64 KiB at most)
    import json
    import pathlib
    raw = json.loads((pathlib.Path(__file__).resolve().parents[1] /
                      "examples/bing_bert/ds_config_sparse.json"
                      ).read_text())["sparse_attention"]
    main = sparsity_config_from_dict(raw, num_heads=16).make_layout(2048)
    for cb in (32, 64, 128):
        _, n_unique = tbs.build_coarse_index(main, FB, cb, per_coord=True,
                                             count_only=True)
        assert n_unique * cb * cb * 4 <= tbs._COARSE_TILE_BUDGET
    assert tbs.planned_kernel(main, FB, has_am=True) == MAIN_PATH_ROUTE


# the route the fitted rule takes at the main path's shape (PERF.md)
MAIN_PATH_ROUTE = "v2"


# ------------------------------------------------- MatMul and Softmax
def _ops_setup(seed=0, B=2, H=2, s=64, D=16, blk=16):
    from deepspeed_tpu_torch.ops.sparse_attention import \
        BSLongformerSparsityConfig
    layout = BSLongformerSparsityConfig(
        num_heads=H, block=blk, num_sliding_window_blocks=3).make_layout(s)
    rng = np.random.RandomState(seed)
    return layout, _inputs(rng, B, H, s, D)[:3], rng


@pytest.mark.parametrize("mode, trans_a, trans_b", [
    ("sdd", False, True), ("sdd", False, False), ("sdd", True, True),
    ("dsd", False, False), ("dsd", True, False), ("dsd", False, True),
    ("dds", False, False), ("dds", False, True), ("dds", True, False)])
def test_matmul_matches_jax(mode, trans_a, trans_b):
    """MatMul in each mode and transposition, the compressed
    (B, nnz, blk, blk) operand in np.nonzero order, against JAX's."""
    import jax.numpy as jnp
    from deepspeed_tpu.ops.sparse_attention import MatMul as JMatMul

    from deepspeed_tpu_torch.ops.sparse_attention import MatMul as TMatMul
    layout, (q, k, _), rng = _ops_setup(seed=len(mode) + trans_a +
                                        2 * trans_b)
    B, H, s, D = q.shape
    nnz = int(layout.sum())
    sparse = rng.randn(B, nnz, FB, FB).astype(np.float32)
    if mode == "sdd":
        a = q if not trans_a else np.swapaxes(q, -1, -2).copy()
        b = k if trans_b else np.swapaxes(k, -1, -2).copy()
    elif mode == "dsd":
        a, b = sparse, (k if not trans_b else np.swapaxes(k, -1, -2).copy())
    else:
        a = rng.randn(B, H, 24, s).astype(np.float32)
        if trans_a:
            a = np.swapaxes(a, -1, -2).copy()
        b = sparse
    want = JMatMul(layout, FB, mode, trans_a=trans_a, trans_b=trans_b)(
        jnp.asarray(a), jnp.asarray(b))
    got = TMatMul(layout, FB, mode, trans_a=trans_a, trans_b=trans_b)(
        torch.from_numpy(a), torch.from_numpy(b))
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=2e-4 if mode == "dds" else FP32_ATOL,
                               rtol=0)


@pytest.mark.parametrize("kpm_mode, am_mode, with_rpe", [
    (None, None, False), ("add", "add", True), ("mul", "mul", False),
    ("mul", "add", True), ("add", "mul", False)])
def test_softmax_matches_jax(kpm_mode, am_mode, with_rpe):
    """Softmax over the compressed scores with rpe, a key mask and an
    attention mask in both modes ('add' by default, unlike
    block_sparse_attention), against JAX's; and the reference's
    composition sdd -> softmax -> dsd against the dense reference."""
    import jax.numpy as jnp
    from deepspeed_tpu.ops.sparse_attention import Softmax as JSoftmax

    from deepspeed_tpu_torch.ops.sparse_attention import (
        MatMul, Softmax, block_sparse_attention_reference)
    layout, (q, k, v), rng = _ops_setup(seed=5)
    B, H, s, D = q.shape
    nnz = int(layout.sum())
    x = rng.randn(B, nnz, FB, FB).astype(np.float32)
    kw_j, kw_t = {}, {}
    if with_rpe:
        rpe = rng.randn(B, nnz, FB, FB).astype(np.float32)
        kw_j["rpe"], kw_t["rpe"] = jnp.asarray(rpe), torch.from_numpy(rpe)
    if kpm_mode is not None:
        kpm = (rng.rand(B, s) > 0.25).astype(np.float32)
        if kpm_mode == "add":
            kpm = np.where(kpm == 0, -1e4, 0.0).astype(np.float32)
        kw_j.update(key_padding_mask=jnp.asarray(kpm),
                    key_padding_mask_mode=kpm_mode)
        kw_t.update(key_padding_mask=torch.from_numpy(kpm),
                    key_padding_mask_mode=kpm_mode)
    if am_mode is not None:
        am = (rng.rand(s, s) > 0.2).astype(np.float32)
        am[7] = 0.0                                  # a row with no key
        if am_mode == "add":
            am = np.where(am == 0, -1e30, 0.5).astype(np.float32)
        kw_j.update(attn_mask=jnp.asarray(am), attn_mask_mode=am_mode)
        kw_t.update(attn_mask=torch.from_numpy(am), attn_mask_mode=am_mode)
    want = JSoftmax(layout, FB)(jnp.asarray(x), scale=0.3, **kw_j)
    got = Softmax(layout, FB)(torch.from_numpy(x), scale=0.3, **kw_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=FP32_ATOL, rtol=0)
    if kpm_mode is None and am_mode is None and not with_rpe:
        tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
        scores = MatMul(layout, FB, "sdd", trans_b=True)(tq, tk)
        probs = Softmax(layout, FB)(scores, scale=float(D) ** -0.5)
        out = MatMul(layout, FB, "dsd")(probs, tv)
        ref = block_sparse_attention_reference(tq, tk, tv, layout)
        np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=FP32_ATOL)


def test_ops_errors_match_jax():
    from deepspeed_tpu.ops.sparse_attention import MatMul as JMatMul

    from deepspeed_tpu_torch.ops.sparse_attention import MatMul as TMatMul
    layout = np.ones((1, 2, 2), np.int32)
    for cls in (JMatMul, TMatMul):
        with pytest.raises(NotImplementedError, match="sdd, dsd, dds"):
            cls(layout, FB, "ddd")


# ------------------------------------------------------- on the card
CUDA_CASES = [
    # (B, H, S, D, layout, coarse, mask mode, key mask, dtype); mask mode
    # None: no tile at the fine walk, the structural tiles on a coarse
    # one; "far": 'add' with one row whose only keys sit at -5e28
    (8, 16, 2048, 64, "fixed_main", None, "mul", True, "bf16"),  # main path
    (2, 4, 512, 64, "fixed_main", 64, "mul", True, "bf16"),
    (2, 4, 512, 64, "bigbird", None, "add", True, "bf16"),
    (2, 4, 512, 32, "bslongformer", 128, "mul", True, "fp32"),
    (2, 4, 512, 128, "fixed_main", 32, "add", True, "fp32"),
    # K8's tensor-core body: walks 16-128, head dims 64, 72, 128, each
    # mask alone and both, structural tiles, empty block rows, the -5e28
    # row
    (2, 4, 512, 72, "fixed_main", 32, "mul", True, "bf16"),
    (2, 4, 512, 72, "bigbird", 128, "add", True, "bf16"),
    (2, 4, 512, 128, "bslongformer", None, "mul", False, "bf16"),
    (2, 4, 512, 64, "fixed_main", None, None, True, "bf16"),
    (2, 4, 512, 128, "bslongformer", 64, None, False, "bf16"),
    (2, 4, 512, 72, "empty_rows", None, "mul", True, "bf16"),
    (2, 4, 512, 64, "fixed_main", None, "far", True, "bf16"),
    # K9's and K10's tensor-core bodies: an empty block column as well as
    # empty rows (K10's empty CSC walk), and a walk of 128 whose two CTAs
    # share each tile (tr0, tc0 = 64) under an 'add' mask and the key
    # mask at head dim 128
    (2, 4, 512, 64, "empty_rows_cols", None, "mul", True, "bf16"),
    (2, 4, 512, 128, "bigbird", 128, "add", True, "bf16"),
]


def _cuda_layout(name, H, s):
    import json
    import pathlib

    from deepspeed_tpu_torch.ops.sparse_attention import (
        BigBirdSparsityConfig, BSLongformerSparsityConfig,
        sparsity_config_from_dict)
    if name == "fixed_main":
        raw = json.loads((pathlib.Path(__file__).resolve().parents[1] /
                          "examples/bing_bert/ds_config_sparse.json"
                          ).read_text())["sparse_attention"]
        return sparsity_config_from_dict(raw, num_heads=H).make_layout(s)
    if name == "bigbird":
        return BigBirdSparsityConfig(num_heads=H, block=FB).make_layout(s)
    if name == "bslongformer":
        return BSLongformerSparsityConfig(num_heads=H,
                                          block=FB).make_layout(s)
    n = s // FB                    # "empty_rows": block rows 3 and 9 empty
    if name == "empty_rows":
        lay = (np.random.RandomState(4).rand(H, n, n) < 0.3).astype(np.int32)
        lay[:, [3, 9]] = 0
        return lay
    # "empty_rows_cols": block rows 3 and 9 and block columns 5 and 20
    lay = (np.random.RandomState(5).rand(H, n, n) < 0.3).astype(np.int32)
    lay[:, [3, 9]] = 0
    lay[:, :, [5, 20]] = 0
    return lay


@pytest.mark.cuda
@pytest.mark.parametrize("case", CUDA_CASES)
def test_cuda_kernels_match_plain(case):
    """K8, K9 and K10 on the card against their plain versions on the
    same inputs (K9 and K10 take the plain forward's lse), with a key
    mask holding a batch row of pads and mask rows that drop every key;
    each runs its tensor-core body in bf16, its CUDA-core body in fp32;
    an empty block row's dq and an empty block column's dk and dv are
    0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from deepspeed_tpu_torch.ops.sparse_attention import blocksparse_v2 as tv2
    B, H, s, d, name, coarse, mode, with_kpm, dtype = case
    rng = np.random.RandomState(s + d)
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    q, k, v, do = (torch.from_numpy(a).to("cuda", td)
                   for a in _inputs(rng, B, H, s, d))
    layout = _cuda_layout(name, H, s)
    kpm, am = _masks(rng, B, s, "mul" if mode == "far" else mode or "mul")
    am_add = np.where(am == 0, -1e30, 0.0).astype(np.float32) \
        if mode == "mul" else am
    far = 70                       # "far": its walked keys sit at -5e28
    if mode == "far":
        am_add = rng.randn(s, s).astype(np.float32)
        am_add[far] = -1e30
        am_add[far, np.nonzero(np.kron(layout[0, far // FB],
                                       np.ones(FB)))[0][:3]] = -5e28
    plan = tv2.RowRunPlan(layout, FB, coarse)
    tiles = (plan.structural_tiles("cuda") if mode is None
             else plan.mask_tiles(torch.from_numpy(am_add).cuda()))
    key = torch.from_numpy(kpm).cuda() if with_kpm else None
    scale = 1.0 / np.sqrt(d)
    tv2.reset_launches()
    before = [w.launches for w in (tv2.blocksparse_v2_fwd,
                                   tv2.blocksparse_v2_dq,
                                   tv2.blocksparse_v2_dkv)]
    o, lse = tv2.blocksparse_v2_fwd(q, k, v, key, tiles, plan, scale)
    o_p, lse_p = tv2.blocksparse_v2_fwd_plain(q, k, v, key, tiles, plan,
                                              scale)
    delta = (do.float() * o_p.float()).sum(-1)
    args = (q, k, v, do, lse_p, delta, key, tiles, plan, scale)
    got = [o, tv2.blocksparse_v2_dq(*args), *tv2.blocksparse_v2_dkv(*args)]
    torch.cuda.synchronize()
    assert [w.launches for w in (tv2.blocksparse_v2_fwd,
                                 tv2.blocksparse_v2_dq,
                                 tv2.blocksparse_v2_dkv)] == \
        [n + 1 for n in before]
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
    assert torch.equal(lse.isfinite(), lse_p.isfinite())
    assert float((lse - lse_p).abs().max()) <= 1e-3
    assert tv2.blocksparse_v2_fwd.bodies == {tv2.FWD_BODIES[td]: 1}
    assert tv2.blocksparse_v2_dq.bodies == {tv2.DQ_BODIES[td]: 1}
    assert tv2.blocksparse_v2_dkv.bodies == {tv2.DKV_BODIES[td]: 1}
    for h in range(H):
        for r in np.nonzero(~layout[h].any(axis=1))[0]:
            assert (got[1][:, h, r * FB:(r + 1) * FB] == 0).all()
        for c in np.nonzero(~layout[h].any(axis=0))[0]:
            assert (got[2][:, h, c * FB:(c + 1) * FB] == 0).all()
            assert (got[3][:, h, c * FB:(c + 1) * FB] == 0).all()
    if with_kpm:
        assert (o[-1] == 0).all()
    if name == "empty_rows":
        assert (o[:, :, 3 * FB:4 * FB] == 0).all()
        assert (lse[:, :, 3 * FB:4 * FB] == -1e30).all()
    if mode == "far":
        assert (o[0, 0, far] != 0).any()
        assert (lse[0, 0, far] == np.float32(-5e28)).all()
