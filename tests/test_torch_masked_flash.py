"""The port's masked flash attention (deepspeed_tpu_torch/ops/attention/
masked_flash.py and flash.py) against the JAX package's Pallas kernels
K1-K3 (deepspeed_tpu/ops/attention/masked_flash.py) run in interpret
mode on the CPU.

The same numpy inputs, made from a seed, go through both. Tolerances:

- fp32: atol 1e-5 (the sums run in another order);
- bf16: every element within 1e-4 + 2**-7 |want| (both sides round the
  same fp32 values to bf16 -- p before P.V, ds before its products, the
  outputs -- so an element may land one bf16 ulp apart), and the whole
  tensor within a relative RMS error of 1e-3. The plain versions with
  the rounding of p and ds left out fail that check on every output
  (``test_bf16_check_pins_the_rounding_of_p_and_ds``).

Dropout is held bit for bit at the mask level, and through the kernels
with the same int32 seed on both sides (negative seeds included).

The additive key-padding arity (``has_kpm``) is held the same way, with
BERT's mask: 0 on real keys, -1e9 on pads that start inside a walk tile,
and in one case a batch row whose keys are all pads (it attends
uniformly over all keys, in JAX as in the port).

The CUDA kernels run only on a card: their tests are marked ``cuda`` and
skip here.
"""

import functools

import numpy as np
import pytest
import torch

import tests.torch_threads  # noqa: F401  (torch threads per xdist worker)

FP32_ATOL = 1e-5
BF16_TOL = dict(atol=1e-4, rtol=2.0**-7, rms=1e-3)
S, D, BLOCK = 64, 16, 16


def _bf16_check(got, want, atol, rtol, rms):
    """(worst |got - want| / (atol + rtol |want|), relative RMS error,
    whether both are within bounds)."""
    diff = np.abs(got - want)
    ratio = float((diff / (atol + rtol * np.abs(want))).max())
    rel_rms = float(np.linalg.norm(diff) / max(np.linalg.norm(want), 1e-30))
    return ratio, rel_rms, ratio <= 1.0 and rel_rms <= rms


def _jax_mask(kind, s=S, block=BLOCK, layout=None):
    from deepspeed_tpu.ops.attention.masked_flash import BlockMask
    if kind == "dense":
        return BlockMask.dense(s, s, block)
    if kind == "causal":
        return BlockMask.causal(s, block)
    return BlockMask.from_layout(layout, block)


def _port_mask(kind, s=S, block=BLOCK, layout=None):
    from deepspeed_tpu_torch.ops.attention.masked_flash import BlockMask
    if kind == "dense":
        return BlockMask.dense(s, s, block)
    if kind == "causal":
        return BlockMask.causal(s, block)
    return BlockMask.from_layout(layout, block)


def _random_layout(rng, heads=2, nb=4):
    """A per-head layout no band describes (the JAX package walks it at
    the fine block too), with an empty block row in head 0."""
    layout = rng.rand(heads, nb, nb) < 0.5
    layout[:, :, 0] = True
    layout[0, 2] = False
    return layout.astype(np.int64)


@pytest.mark.parametrize("kind", ["dense", "causal", "layout"])
def test_block_mask_walks_match_jax(kind):
    layout = _random_layout(np.random.RandomState(1))
    jm = _jax_mask(kind, layout=layout)
    tm = _port_mask(kind, layout=layout)
    assert (tm.heads, tm.nq, tm.nk, tm.nnz, tm.block) == \
        (jm.heads, jm.nq, jm.nk, jm.nnz, jm.block)
    for ours, theirs in zip(tm.csr() + tm.csc(), jm.csr() + jm.csc()):
        np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(tm.dense_additive(), jm.dense_additive())


def test_cost_model_matches_jax():
    from deepspeed_tpu.ops.attention.masked_flash import \
        masked_flash_cost as jax_cost

    from deepspeed_tpu_torch.ops.attention.masked_flash import \
        masked_flash_cost
    for bwd in (False, True):
        assert masked_flash_cost(_port_mask("causal"), 2, 4, 16,
                                 backward=bwd) == \
            jax_cost(_jax_mask("causal"), 2, 4, 16, backward=bwd)


@pytest.mark.parametrize("seed", [0, 7, -1, -(2**31), 2**31 - 1])
def test_dropout_hashes_bitwise_equal_jax(seed):
    import jax.numpy as jnp
    from deepspeed_tpu.ops import functional as jf
    from deepspeed_tpu.ops.attention import flash as jflash

    from deepspeed_tpu_torch.ops import functional as tf
    from deepspeed_tpu_torch.ops.attention import flash as tflash
    for rate in (0.1, 0.5):
        want = np.asarray(jflash.dropout_mask_reference(
            jnp.asarray(seed, jnp.int32), 2, 3, 24, 40, rate))
        got = tflash.dropout_mask_reference(seed, 2, 3, 24, 40, rate)
        np.testing.assert_array_equal(got.numpy(), want)
        seed32 = jnp.asarray(seed, jnp.int32).astype(jnp.uint32)
        want = np.asarray(jf._hash_keep_mask(seed32, 5000, rate))
        np.testing.assert_array_equal(
            tf._hash_keep_mask(seed, 5000, rate).numpy(), want)


def test_one_round_hash_knob(monkeypatch):
    """flash._HASH_FINAL_ROUNDS = 1 (the JAX package's A/B knob) gives
    JAX's one-round bits in the plain hash; the kernels' wrappers, whose
    hash has the two-round finalizer only, refuse it when dropout is on,
    on the CPU as on a card."""
    import jax.numpy as jnp
    from deepspeed_tpu.ops.attention import flash as jflash

    from deepspeed_tpu_torch.ops.attention import flash as tflash
    from deepspeed_tpu_torch.ops.attention import masked_flash as mf
    monkeypatch.setattr(jflash, "_HASH_FINAL_ROUNDS", 1)
    monkeypatch.setattr(tflash, "_HASH_FINAL_ROUNDS", 1)
    want = np.asarray(jflash.dropout_mask_reference(
        jnp.asarray(-5, jnp.int32), 2, 3, 24, 40, 0.3))
    got = tflash.dropout_mask_reference(-5, 2, 3, 24, 40, 0.3).numpy()
    np.testing.assert_array_equal(got, want)
    q = torch.zeros(1, 2, 32, 16)
    mask = mf.BlockMask.causal(32, 16)
    for call in (lambda: mf.masked_flash_fwd(q, q, q, mask, 0.25, 0.1, 3),
                 lambda: mf.masked_flash_dq(q, q, q, q, q[..., 0], q[..., 0],
                                            mask, 0.25, 0.1, 3),
                 lambda: mf.masked_flash_dkv(q, q, q, q, q[..., 0],
                                             q[..., 0], mask, 0.25, 0.1, 3)):
        with pytest.raises(NotImplementedError, match="_HASH_FINAL_ROUNDS"):
            call()
    o, _ = mf.masked_flash_fwd(q, q, q, mask, 0.25, 0.0, 3)   # no hash
    assert (o == 0).all()


def test_elementwise_dropout_matches_jax_mask():
    import jax.numpy as jnp
    from deepspeed_tpu.ops import functional as jf

    from deepspeed_tpu_torch.ops.functional import dropout
    x = np.random.RandomState(2).randn(4, 33).astype(np.float32)
    got = dropout(torch.from_numpy(x), 0.25, -12345, False).numpy()
    keep = np.asarray(jf._hash_keep_mask(
        jnp.asarray(-12345, jnp.int32).astype(jnp.uint32), x.size, 0.25))
    np.testing.assert_allclose(got, np.where(keep.reshape(x.shape),
                                             x / 0.75, 0.0), rtol=1e-7)
    assert dropout(torch.from_numpy(x), 0.25, None, False) is not None
    np.testing.assert_array_equal(
        dropout(torch.from_numpy(x), 0.25, 3, True).numpy(), x)


def _inputs(rng, G, dtype, B=1, H=2, s=S, d=D):
    arrs = [rng.randn(B, H, s, d), rng.randn(B, H // G, s, d),
            rng.randn(B, H // G, s, d), rng.randn(B, H, s, d)]
    return [a.astype(np.float32) * 0.5 for a in arrs]


@functools.lru_cache(maxsize=None)
def _jax_case(kind, G, rate, dtype):
    """The JAX side of one grid case, computed once per test session."""
    rng = np.random.RandomState(G * 10 + int(rate * 10))
    q, k, v, do = _inputs(rng, G, dtype)
    seed = -987654321 if rate else 0
    # walk block 32: two tiles per block row, so the online softmax
    # carries across tiles (block 16, four tiles, is held below)
    want = _jax_run(q, k, v, do, _jax_mask(kind, block=32), rate, seed,
                    dtype)
    return (q, k, v, do, seed), want


def _jax_run(q, k, v, do, jmask, rate, seed, dtype, key_mask=None):
    """K1's o and lse, then dq/dk/dv through masked_flash_call's own vjp
    rules (what jax.vjp runs), in interpret mode, in one jit; with a
    (B, Sk) ``key_mask`` the kernels' has_kpm arity."""
    import jax
    import jax.numpy as jnp
    from deepspeed_tpu.ops.attention.masked_flash import masked_flash_call
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    jq, jk, jv, jdo = (jnp.asarray(a).astype(jd) for a in (q, k, v, do))
    has_kpm = key_mask is not None
    kpm = (jnp.asarray(key_mask) if has_kpm
           else jnp.zeros((q.shape[0], 1), jnp.float32))
    jseed = jnp.asarray([[seed]], jnp.int32)
    scale = 1.0 / np.sqrt(q.shape[-1])

    @jax.jit
    def run(jq, jk, jv, jdo):
        o, res = masked_flash_call.fwd(jq, jk, jv, kpm, jseed, jmask, scale,
                                       True, rate, has_kpm)
        grads = masked_flash_call.bwd(jmask, scale, True, rate, has_kpm,
                                      res, jdo)
        return o, res[-1], grads[:3]
    o, lse, grads = run(jq, jk, jv, jdo)
    f32 = [np.asarray(x.astype(jnp.float32)) for x in (o, *grads)]
    return f32[0], np.asarray(lse).reshape(q.shape[:3]), f32[1:]


def _port_run(q, k, v, do, tmask, rate, seed, dtype, key_mask=None):
    from deepspeed_tpu_torch.ops.attention.masked_flash import (
        masked_flash_attention, masked_flash_fwd)
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    tq, tk, tv = (torch.from_numpy(a).to(td).requires_grad_()
                  for a in (q, k, v))
    kpm = None if key_mask is None else torch.from_numpy(key_mask)
    scale = 1.0 / np.sqrt(q.shape[-1])
    _, lse = masked_flash_fwd(tq.detach(), tk.detach(), tv.detach(), tmask,
                              scale, rate, seed, kpm)
    o = masked_flash_attention(tq, tk, tv, tmask, key_mask=kpm,
                               dropout_rate=rate, dropout_seed=seed)
    grads = torch.autograd.grad(o, (tq, tk, tv),
                                torch.from_numpy(do).to(td))
    return (o.detach().float().numpy(), lse.numpy(),
            [g.float().numpy() for g in grads])


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("kind", ["dense", "causal"])
def test_kernels_and_grads_match_jax(kind, G, rate, dtype):
    """K1's o and lse, and dq/dk/dv through the autograd Function (the
    plain versions of K2 and K3 on the CPU), against masked_flash_call
    and its vjp."""
    (q, k, v, do, seed), want = _jax_case(kind, G, rate, dtype)
    got = _port_run(q, k, v, do, _port_mask(kind, block=32), rate, seed,
                    dtype)
    # lse is fp32 on both sides
    np.testing.assert_allclose(got[1], want[1], atol=FP32_ATOL, rtol=0)
    for g, w in zip([got[0], *got[2]], [want[0], *want[2]]):
        if dtype == "fp32":
            np.testing.assert_allclose(g, w, atol=FP32_ATOL, rtol=0)
        else:
            ratio, rel_rms, ok = _bf16_check(g, w, **BF16_TOL)
            assert ok, (ratio, rel_rms)


def _bert_key_mask(rng, batch, s, min_len, all_pad_rows=()):
    """BERT's additive key mask as (B, Sk) fp32: each row's real length
    drawn from [min_len, s] (pads start inside a tile), -1e9 on the
    pads, every key a pad in ``all_pad_rows``."""
    lengths = rng.randint(min_len, s + 1, size=batch)
    am = (np.arange(s)[None, :] < lengths[:, None]).astype(np.float32)
    am[list(all_pad_rows)] = 0.0
    return ((1.0 - am) * -1e9).astype(np.float32)


def _assert_matches(got, want, dtype):
    np.testing.assert_allclose(got[1], want[1], atol=FP32_ATOL, rtol=0)
    for g, w in zip([got[0], *got[2]], [want[0], *want[2]]):
        if dtype == "fp32":
            np.testing.assert_allclose(g, w, atol=FP32_ATOL, rtol=0)
        else:
            ratio, rel_rms, ok = _bf16_check(g, w, **BF16_TOL)
            assert ok, (ratio, rel_rms)


@pytest.mark.parametrize("kind,G,rate,dtype", [
    ("dense", 1, 0.0, "fp32"), ("dense", 1, 0.1, "bf16"),
    ("dense", 2, 0.1, "fp32"), ("causal", 1, 0.0, "bf16"),
    ("causal", 2, 0.1, "bf16"), ("causal", 2, 0.0, "fp32")])
def test_key_mask_kernels_and_grads_match_jax(kind, G, rate, dtype):
    """The has_kpm arity: K1's o and lse, and dq/dk/dv through the
    autograd Function, against masked_flash_call(has_kpm=True) and its
    vjp, with BERT's -1e9 pads starting inside the walk tiles (walk
    block 32, two tiles per block row), GQA, dropout and a causal mask
    under the key mask."""
    rng = np.random.RandomState(40 + G * 10 + int(rate * 10))
    q, k, v, do = _inputs(rng, G, dtype, B=2)
    kpm = _bert_key_mask(rng, 2, S, 20)
    seed = -135792468 if rate else 0
    want = _jax_run(q, k, v, do, _jax_mask(kind, block=32), rate, seed,
                    dtype, key_mask=kpm)
    got = _port_run(q, k, v, do, _port_mask(kind, block=32), rate, seed,
                    dtype, key_mask=kpm)
    _assert_matches(got, want, dtype)
    # the mask matters: without it the port's o moves far from JAX's
    plain = _port_run(q, k, v, do, _port_mask(kind, block=32), rate, seed,
                      dtype)
    assert np.abs(plain[0] - want[0]).max() > 1e-2


def test_key_mask_all_padded_row_attends_uniformly():
    """A batch row whose keys are all pads: every score rounds to about
    -1e9 (the fp32 ulp there is 64), above VALID_THRESH, so the row
    attends uniformly over all keys, in JAX as in the port; the other
    row only over its real keys. Forward and grads against JAX."""
    rng = np.random.RandomState(47)
    q, k, v, do = _inputs(rng, 1, "fp32", B=2)
    kpm = _bert_key_mask(rng, 2, S, 20, all_pad_rows=(1,))
    want = _jax_run(q, k, v, do, _jax_mask("dense", block=16), 0.0, 0,
                    "fp32", key_mask=kpm)
    got = _port_run(q, k, v, do, _port_mask("dense", block=16), 0.0, 0,
                    "fp32", key_mask=kpm)
    _assert_matches(got, want, "fp32")
    uniform = np.broadcast_to(v[1].mean(axis=1, keepdims=True), v[1].shape)
    np.testing.assert_allclose(got[0][1], uniform, atol=FP32_ATOL, rtol=0)
    n_real = int((kpm[0] == 0).sum())
    np.testing.assert_allclose(
        got[0][0], np.asarray(torch.softmax(
            torch.from_numpy(q[0] @ k[0, :, :n_real].swapaxes(-1, -2)
                             / np.sqrt(D)), -1).numpy() @ v[0, :, :n_real]),
        atol=FP32_ATOL, rtol=0)


def test_key_mask_cotangent_is_zero():
    """The key mask takes no gradient: a zero one where it is asked for
    (JAX's vjp returns zeros), none otherwise."""
    from deepspeed_tpu_torch.ops.attention.masked_flash import \
        masked_flash_attention
    rng = np.random.RandomState(48)
    q, k, v, _ = (torch.from_numpy(a).requires_grad_()
                  for a in _inputs(rng, 1, "fp32", B=2))
    kpm = torch.from_numpy(_bert_key_mask(rng, 2, S, 20)).requires_grad_()
    mask = _port_mask("dense")
    o = masked_flash_attention(q, k, v, mask, key_mask=kpm)
    g_kpm, g_q = torch.autograd.grad(o.sum(), (kpm, q))
    assert g_kpm.shape == kpm.shape and float(g_kpm.abs().max()) == 0.0
    assert float(g_q.abs().max()) > 0.0
    o = masked_flash_attention(q, k, v, mask, key_mask=kpm.detach())
    assert torch.autograd.grad(o.sum(), q)[0].shape == q.shape


def test_flash_attention_key_mask_matches_jax():
    """The front end with a (B, 1, 1, Sk) BERT mask (the route
    transformer_layer_forward takes) against JAX's flash_attention,
    forward and grads, at a sequence the kernels walk and at one they do
    not (seq % 16 != 0, the reference path)."""
    import jax
    import jax.numpy as jnp

    from deepspeed_tpu.ops.attention.flash import \
        flash_attention as jax_flash

    from deepspeed_tpu_torch.ops.attention.flash import flash_attention
    for s in (48, 40):
        rng = np.random.RandomState(49 + s)
        q, k, v, do = _inputs(rng, 1, "fp32", B=2, H=2, s=s)
        kpm = _bert_key_mask(rng, 2, s, 10)[:, None, None, :]
        jo, vjp = jax.vjp(lambda a, b, c: jax_flash(
            a, b, c, mask=jnp.asarray(kpm), interpret=True),
            *(jnp.asarray(a) for a in (q, k, v)))
        jg = vjp(jnp.asarray(do))
        tq, tk, tv = (torch.from_numpy(a).requires_grad_()
                      for a in (q, k, v))
        to = flash_attention(tq, tk, tv, mask=torch.from_numpy(kpm))
        tg = torch.autograd.grad(to, (tq, tk, tv), torch.from_numpy(do))
        np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo),
                                   atol=FP32_ATOL, rtol=0)
        for a, b in zip(tg, jg):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       atol=FP32_ATOL, rtol=0)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("G", [1, 2])
def test_bf16_check_pins_the_rounding_of_p_and_ds(G, rate):
    """The control: the plain versions run on fp32 copies of the bf16
    inputs, which leaves out the rounding of p to V's dtype before P.V
    and of ds to K/Q's dtype before its products (the outputs are still
    rounded to bf16, and the backward takes JAX's own lse and delta).
    Against JAX's bf16 kernels that fails the bf16 check on o and dv
    (p) and on dq and dk (ds), so the check holds those roundings."""
    from deepspeed_tpu_torch.ops.attention import masked_flash as mf
    (q, k, v, do, seed), want = _jax_case("causal", G, rate, "bf16")
    mask = _port_mask("causal", block=32)
    scale = 1.0 / np.sqrt(D)
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16).float()
                   for a in (q, k, v, do))
    o, _ = mf.masked_flash_fwd_plain(q, k, v, mask, scale, rate, seed)
    lse = torch.tensor(want[1])
    delta = (do * torch.tensor(want[0])).sum(-1)
    dq = mf.masked_flash_dq_plain(q, k, v, do, lse, delta, mask, scale,
                                  rate, seed)
    dk, dv = mf.masked_flash_dkv_plain(q, k, v, do, lse, delta, mask, scale,
                                       rate, seed)
    for name, g, w in zip(("o", "dq", "dk", "dv"), (o, dq, dk, dv),
                          (want[0], *want[2])):
        ratio, rel_rms, ok = _bf16_check(g.to(torch.bfloat16).float().numpy(),
                                         w, **BF16_TOL)
        assert not ok, (name, ratio, rel_rms)


def test_rows_with_no_valid_entry():
    """A per-head layout with an empty block row: o = 0 and lse = NEG_INF
    there, zero grads into it, and everything else as JAX computes it."""
    from deepspeed_tpu_torch.ops.attention.flash import NEG_INF
    layout = _random_layout(np.random.RandomState(3))
    rng = np.random.RandomState(4)
    q, k, v, do = _inputs(rng, 1, "fp32")
    want = _jax_run(q, k, v, do, _jax_mask("layout", layout=layout), 0.0,
                    0, "fp32")
    got = _port_run(q, k, v, do, _port_mask("layout", layout=layout), 0.0,
                    0, "fp32")
    rows = slice(2 * BLOCK, 3 * BLOCK)
    assert (got[0][0, 0, rows] == 0).all()
    assert (got[1][0, 0, rows] == NEG_INF).all()
    assert (got[2][0][0, 0, rows] == 0).all()
    assert np.isfinite(got[0]).all()
    np.testing.assert_allclose(got[0], want[0], atol=FP32_ATOL, rtol=0)
    np.testing.assert_allclose(got[1], want[1], atol=FP32_ATOL, rtol=0)
    for g, w in zip(got[2], want[2]):
        np.testing.assert_allclose(g, w, atol=FP32_ATOL, rtol=0)


def test_plain_matches_dense_oracle_with_dropout():
    """The plain versions against the dense reference (same hash mask),
    forward and grads, GQA and a negative seed."""
    from deepspeed_tpu_torch.ops.attention.masked_flash import (
        BlockMask, masked_flash_attention, masked_flash_reference)
    rng = np.random.RandomState(5)
    q, k, v, do = (torch.from_numpy(a).requires_grad_()
                   for a in _inputs(rng, 2, "fp32", B=2, H=4, s=48))
    mask = BlockMask.causal(48, 16)
    outs = [f(q, k, v, mask, dropout_rate=0.2, dropout_seed=-3)
            for f in (masked_flash_attention, masked_flash_reference)]
    torch.testing.assert_close(outs[0], outs[1], atol=FP32_ATOL, rtol=0)
    gs = [torch.autograd.grad(o, (q, k, v), do.detach()) for o in outs]
    for a, b in zip(*gs):
        torch.testing.assert_close(a, b, atol=FP32_ATOL, rtol=0)


def test_flash_attention_causal_matches_jax():
    """The front end's default route (walk block 16 at seq 48) against
    JAX's flash_attention, forward and grads."""
    import jax
    import jax.numpy as jnp

    from deepspeed_tpu.ops.attention.flash import \
        flash_attention as jax_flash

    from deepspeed_tpu_torch.ops.attention.flash import flash_attention
    rng = np.random.RandomState(6)
    q, k, v, do = _inputs(rng, 1, "fp32", H=2, s=48)
    jo, vjp = jax.vjp(lambda a, b, c: jax_flash(a, b, c, causal=True,
                                                interpret=True),
                      *(jnp.asarray(a) for a in (q, k, v)))
    jg = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    to = flash_attention(tq, tk, tv, causal=True)
    tg = torch.autograd.grad(to, (tq, tk, tv), torch.from_numpy(do))
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo),
                               atol=FP32_ATOL, rtol=0)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=FP32_ATOL,
                                   rtol=0)


def test_routing(monkeypatch):
    """seq % 16 != 0 takes the reference path; the masked route runs the
    masked kernels, with a (B, 1, 1, Sk) key-padding mask too; the legacy
    route (kernel="flash", or causal with seq_q != seq_k) reaches the
    K5-K7 wrappers and not K1-K3; KIND_BAND tiles run."""
    from deepspeed_tpu_torch.ops.attention import flash as tflash
    from deepspeed_tpu_torch.ops.attention import masked_flash as mf
    rng = np.random.RandomState(7)
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(rng, 1, "fp32",
                                                       s=24))
    calls = []
    real = mf.masked_flash_attention
    monkeypatch.setattr(mf, "masked_flash_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    out = tflash.flash_attention(q, k, v, causal=True)
    torch.testing.assert_close(out, tflash.attention_reference(
        q, k, v, causal=True), atol=0, rtol=0)
    assert calls == []
    q2, k2, v2, _ = (torch.from_numpy(a) for a in _inputs(rng, 1, "fp32"))
    tflash.flash_attention(q2, k2, v2, causal=True)
    assert calls == [1]
    legacy = []
    real_fwd = tflash.flash_fwd
    monkeypatch.setattr(tflash, "flash_fwd", lambda *a, **kw: legacy.append(
        a[0].shape[2:3] + a[1].shape[2:3]) or real_fwd(*a, **kw))
    for kw in (dict(kernel="flash"), dict(kernel="flash", causal=True)):
        torch.testing.assert_close(
            tflash.flash_attention(q2, k2, v2, **kw),
            tflash.attention_reference(q2, k2, v2, causal=bool(kw.get(
                "causal"))), atol=FP32_ATOL, rtol=0)
    torch.testing.assert_close(
        tflash.flash_attention(q2, k2[:, :, :32], v2[:, :, :32],
                               causal=True),
        tflash.attention_reference(q2, k2[:, :, :32], v2[:, :, :32],
                                   causal=True), atol=FP32_ATOL, rtol=0)
    assert legacy == [(S, S), (S, S), (S, 32)]
    assert calls == [1]
    tflash.flash_attention(q2, k2, v2, causal=True)     # "masked", sq == sk
    assert calls == [1, 1] and len(legacy) == 3
    tflash.flash_attention(q2, k2, v2, mask=torch.zeros(1, 1, 1, S))
    assert calls == [1, 1, 1]
    with pytest.raises(ValueError, match="key mask"):
        mf.masked_flash_fwd(q2, k2, v2, mf.BlockMask.dense(S, S, 16), 0.25,
                            key_mask=torch.zeros(1, S, dtype=torch.float64))
    # KIND_BAND tiles run (their plain versions here) with the band's
    # fine structure; a layout no band describes cannot take a coarse
    # walk; a user attention mask runs the row-run kernels K8-K10 (their
    # plain versions here), not K1-K3
    band = mf.BlockMask(np.ones((1, 4, 4)), np.full((1, 4, 4), 2), 16, S, S,
                        band=(16, 1, 0, 0, False))
    torch.testing.assert_close(
        mf.masked_flash_attention(q2, k2, v2, band),
        mf.masked_flash_reference(q2, k2, v2, band), atol=FP32_ATOL, rtol=0)
    assert not (band.dense_additive() == 0).all()
    with pytest.raises(ValueError, match="banded-describable"):
        mf.BlockMask.from_layout(np.ones((1, 4, 4)), 16, walk_block=64)
    from deepspeed_tpu_torch.ops.sparse_attention import (
        block_sparse_attention, block_sparse_attention_reference)
    am = torch.ones(S, S).tril()
    torch.testing.assert_close(
        block_sparse_attention(q2, k2, v2, np.ones((2, 4, 4), np.int32),
                               attn_mask=am),
        block_sparse_attention_reference(q2, k2, v2,
                                         np.ones((2, 4, 4), np.int32),
                                         attn_mask=am),
        atol=FP32_ATOL, rtol=0)
    with pytest.raises(ValueError, match="dropout_seed"):
        tflash.flash_attention(q2, k2, v2, causal=True, dropout_rate=0.1)


@pytest.mark.parametrize("dtype, body", [(torch.bfloat16, "mma"),
                                         (torch.float32, "fma")])
def test_forward_body_by_dtype(dtype, body):
    """K1 and K5 name the body a dtype runs: bf16 on the tensor cores,
    fp32 on the CUDA cores; ``reset_launches`` zeroes their counts by
    body."""
    from deepspeed_tpu_torch.ops.attention import flash as tf
    from deepspeed_tpu_torch.ops.attention import masked_flash as mf
    assert mf.FWD_BODIES[dtype] == body
    for wrapper, reset in ((mf.masked_flash_fwd, mf.reset_launches),
                           (tf.flash_fwd, tf.reset_launches)):
        saved = dict(wrapper.bodies)
        try:
            mf._count_body(wrapper, dtype)
            mf._count_body(wrapper, dtype)
            assert wrapper.bodies[body] == saved.get(body, 0) + 2
            reset()
            assert wrapper.bodies == {}
        finally:
            wrapper.bodies = saved


@pytest.mark.parametrize("dtype, body", [(torch.bfloat16, "mma"),
                                         (torch.float32, "fma")])
def test_dkv_body_by_dtype(dtype, body):
    """K3 and K7 name the body a dtype runs: bf16 on the tensor cores
    (csrc/mma_dkv.cuh), fp32 on the CUDA cores; ``reset_launches``
    zeroes their counts by body."""
    from deepspeed_tpu_torch.ops.attention import flash as tf
    from deepspeed_tpu_torch.ops.attention import masked_flash as mf
    assert mf.DKV_BODIES[dtype] == body
    for wrapper, reset in ((mf.masked_flash_dkv, mf.reset_launches),
                           (tf.flash_dkv, tf.reset_launches)):
        saved = dict(wrapper.bodies)
        try:
            mf._count_body(wrapper, dtype, mf.DKV_BODIES)
            mf._count_body(wrapper, dtype, mf.DKV_BODIES)
            assert wrapper.bodies[body] == saved.get(body, 0) + 2
            reset()
            assert wrapper.bodies == {}
        finally:
            wrapper.bodies = saved


@pytest.mark.parametrize("dtype, body", [(torch.bfloat16, "mma"),
                                         (torch.float32, "fma")])
def test_dq_body_by_dtype(dtype, body):
    """K2 and K6 name the body a dtype runs: bf16 on the tensor cores
    (csrc/mma_dq.cuh), fp32 on the CUDA cores; ``reset_launches``
    zeroes their counts by body."""
    from deepspeed_tpu_torch.ops.attention import flash as tf
    from deepspeed_tpu_torch.ops.attention import masked_flash as mf
    assert mf.DQ_BODIES[dtype] == body
    for wrapper, reset in ((mf.masked_flash_dq, mf.reset_launches),
                           (tf.flash_dq, tf.reset_launches)):
        saved = dict(wrapper.bodies)
        try:
            mf._count_body(wrapper, dtype, mf.DQ_BODIES)
            mf._count_body(wrapper, dtype, mf.DQ_BODIES)
            assert wrapper.bodies[body] == saved.get(body, 0) + 2
            reset()
            assert wrapper.bodies == {}
        finally:
            wrapper.bodies = saved


@pytest.mark.parametrize("operand", ["q", "k", "v", "key_mask"])
def test_bf16_forward_refuses_misaligned_operands(operand):
    """The tensor-core forward body loads 16-byte rows (q, k, v) and
    8-byte key-mask pairs: a bf16 view that starts off those boundaries
    raises before any launch, an aligned one and fp32 pass."""
    from deepspeed_tpu_torch.ops.attention.masked_flash import \
        _check_fwd_aligned
    shape, n = (1, 2, 32, 16), 2 * 32 * 16

    def operands(dtype, off=None):
        ts = {name: torch.zeros(n + 8, dtype=dtype)[:n].view(shape)
              for name in ("q", "k", "v")}
        ts["key_mask"] = torch.zeros(33)[:32].view(1, 32)
        if off is not None:
            base = torch.zeros(n + 8, dtype=ts[off].dtype)
            if off == "key_mask":
                ts[off] = base[1:33].view(1, 32)
            else:
                ts[off] = base[4:4 + n].view(shape)
        return ts

    _check_fwd_aligned(**operands(torch.bfloat16))
    _check_fwd_aligned(**operands(torch.float32, operand))
    with pytest.raises(ValueError, match=f"{operand} aligned"):
        _check_fwd_aligned(**operands(torch.bfloat16, operand))


def _bwd_operands(dtype, off=None):
    """q, k, v, do and a key mask, each at an aligned start, or the one
    named ``off`` started off its boundary (4 elements, or one fp32 for
    the key mask's 8-byte pairs)."""
    shape, n = (1, 2, 32, 16), 2 * 32 * 16
    ts = {name: torch.zeros(n + 8, dtype=dtype)[:n].view(shape)
          for name in ("q", "k", "v", "do")}
    ts["key_mask"] = torch.zeros(33)[:32].view(1, 32)
    if off is not None:
        base = torch.zeros(n + 8, dtype=ts[off].dtype)
        if off == "key_mask":
            ts[off] = base[1:33].view(1, 32)
        else:
            ts[off] = base[4:4 + n].view(shape)
    return ts


@pytest.mark.parametrize("operand", ["q", "k", "v", "do", "key_mask"])
def test_bf16_dq_refuses_misaligned_operands(operand):
    """K2's tensor-core dq body loads 16-byte rows (q, k, v, do) and
    8-byte key-mask pairs: a bf16 view that starts off those boundaries
    raises before any launch, an aligned one and fp32 pass."""
    from deepspeed_tpu_torch.ops.attention.masked_flash import \
        _check_dq_aligned
    _check_dq_aligned(**_bwd_operands(torch.bfloat16))
    _check_dq_aligned(**_bwd_operands(torch.float32, operand))
    with pytest.raises(ValueError, match=f"{operand} aligned"):
        _check_dq_aligned(**_bwd_operands(torch.bfloat16, operand))


@pytest.mark.parametrize("operand", ["q", "k", "v", "do", "key_mask"])
def test_bf16_dkv_refuses_misaligned_operands(operand):
    """K3's tensor-core dk/dv body loads 16-byte rows (q, k, v, do) and
    8-byte key-mask pairs: a bf16 view that starts off those boundaries
    raises before any launch, an aligned one and fp32 pass."""
    from deepspeed_tpu_torch.ops.attention.masked_flash import \
        _check_dkv_aligned
    _check_dkv_aligned(**_bwd_operands(torch.bfloat16))
    _check_dkv_aligned(**_bwd_operands(torch.float32, operand))
    with pytest.raises(ValueError, match=f"{operand} aligned"):
        _check_dkv_aligned(**_bwd_operands(torch.bfloat16, operand))


@pytest.mark.cuda
@pytest.mark.parametrize("operand", ["q", "k", "v", "do", "key_mask"])
def test_cuda_dq_and_dkv_wrappers_refuse_misaligned_operands(operand):
    """masked_flash_dq and masked_flash_dkv themselves, on the card: a
    misaligned bf16 operand raises and launches nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from deepspeed_tpu_torch.ops.attention import masked_flash as mf
    ts = {n: t.cuda() for n, t in _bwd_operands(torch.bfloat16).items()}
    base = torch.zeros(ts[operand].numel() + 8, dtype=ts[operand].dtype,
                       device="cuda")
    step = 1 if operand == "key_mask" else 4
    ts[operand] = base[step:step + ts[operand].numel()].view(
        ts[operand].shape)
    q = ts["q"]
    lse = torch.zeros(q.shape[:3], device="cuda")
    mask = mf.BlockMask.causal(q.shape[2], 16)
    args = (ts["q"], ts["k"], ts["v"], ts["do"], lse, torch.zeros_like(lse),
            mask, 0.25)
    before = (mf.masked_flash_dq.launches, mf.masked_flash_dkv.launches)
    for wrapper in (mf.masked_flash_dq, mf.masked_flash_dkv):
        with pytest.raises(ValueError, match=f"{operand} aligned"):
            wrapper(*args, key_mask=ts["key_mask"])
    assert (mf.masked_flash_dq.launches,
            mf.masked_flash_dkv.launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    # (B, H, Hkv, S, D, mask, block, dtype, rate)
    (8, 16, 16, 1024, 64, "causal", 128, "bf16", 0.0),  # GPT-2 345M train
    (8, 16, 16, 1024, 64, "causal", 128, "bf16", 0.1),
    (2, 8, 8, 512, 64, "dense", 64, "bf16", 0.0),
    (2, 16, 4, 256, 128, "causal", 128, "bf16", 0.1),    # GQA, widest head
    (2, 4, 2, 128, 24, "causal", 32, "fp32", 0.1),       # fp32, odd head dim
    (2, 4, 4, 128, 32, "layout", 16, "fp32", 0.0),       # per-head, empty rows
])
def test_cuda_kernels_match_plain(case):
    """K1, K2 and K3 on the card against their plain versions on the same
    inputs (the backward kernels take the plain forward's lse)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from deepspeed_tpu_torch.ops.attention import masked_flash as mf
    B, H, Hkv, s, d, kind, block, dtype, rate = case
    rng = np.random.RandomState(s + d)
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    q, k, v, do = (torch.from_numpy(a).to("cuda", td) for a in
                   _inputs(rng, H // Hkv, dtype, B=B, H=H, s=s, d=d))
    layout = (_random_layout(rng, heads=H, nb=s // block)
              if kind == "layout" else None)
    mask = _port_mask(kind, s=s, block=block, layout=layout)
    scale, seed = 1.0 / np.sqrt(d), -42
    before = (mf.masked_flash_fwd.launches, mf.masked_flash_dq.launches,
              mf.masked_flash_dkv.launches)
    body = mf.DKV_BODIES[td]
    dkv_before = mf.masked_flash_dkv.bodies.get(body, 0)
    o, lse = mf.masked_flash_fwd(q, k, v, mask, scale, rate, seed)
    o_p, lse_p = mf.masked_flash_fwd_plain(q, k, v, mask, scale, rate, seed)
    delta = (do.float() * o_p.float()).sum(-1)
    args = (q, k, v, do, lse_p, delta, mask, scale, rate, seed)
    got = [o, mf.masked_flash_dq(*args), *mf.masked_flash_dkv(*args)]
    torch.cuda.synchronize()
    assert (mf.masked_flash_fwd.launches, mf.masked_flash_dq.launches,
            mf.masked_flash_dkv.launches) == tuple(n + 1 for n in before)
    assert mf.masked_flash_dkv.bodies.get(body, 0) == dkv_before + 1
    want = [o_p, mf.masked_flash_dq_plain(*args),
            *mf.masked_flash_dkv_plain(*args)]
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        a, b = a.float().cpu().numpy(), b.float().cpu().numpy()
        if dtype == "fp32":
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-4)
        else:
            ratio, rel_rms, ok = _bf16_check(a, b, **BF16_TOL)
            assert ok, (ratio, rel_rms)
    assert float((lse - lse_p).abs().max()) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    # (B, H, Hkv, S, D, mask, walk block, rate, key mask)
    (2, 8, 8, 512, 64, "causal", 16, 0.0, False),
    (2, 8, 8, 512, 64, "causal", 32, 0.1, False),
    (2, 8, 8, 512, 64, "layout", 64, 0.0, True),     # per-head, empty rows
    (2, 8, 8, 512, 64, "dense", 128, 0.1, True),
    (2, 16, 4, 512, 64, "causal", 128, 0.0, False),  # GQA, G 4
    (2, 8, 8, 256, 32, "causal", 64, 0.0, False),    # head dim 32
    (2, 8, 8, 256, 128, "dense", 128, 0.1, True),    # head dim 128
    (2, 8, 8, 256, 72, "causal", 32, 0.0, True),     # 72: not a multiple of 16
    (2, 8, 8, 256, 40, "layout", 16, 0.1, False),    # 40: the zero tail
])
def test_cuda_fwd_tensor_core_body_matches_plain(case):
    """K1's bf16 launches run the tensor-core body (csrc/mma_fwd.cuh) at
    every walk block, GQA, head dims 32 to 128 (also not multiples of the
    mma's depth of 16), dropout and the key mask, and equal the plain
    version; each counts under body "mma"."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from deepspeed_tpu_torch.ops.attention import masked_flash as mf
    B, H, Hkv, s, d, kind, block, rate, km = case
    rng = np.random.RandomState(s + d + block)
    q, k, v, _ = (torch.from_numpy(a).to("cuda", torch.bfloat16) for a in
                  _inputs(rng, H // Hkv, "bf16", B=B, H=H, s=s, d=d))
    layout = (_random_layout(rng, heads=H, nb=s // block)
              if kind == "layout" else None)
    mask = _port_mask(kind, s=s, block=block, layout=layout)
    kpm = (torch.from_numpy(_bert_key_mask(rng, B, s, s // 2, (1,))).cuda()
           if km else None)
    scale, seed = 1.0 / np.sqrt(d), 1234
    before = mf.masked_flash_fwd.bodies.get("mma", 0)
    o, lse = mf.masked_flash_fwd(q, k, v, mask, scale, rate, seed, kpm)
    o_p, lse_p = mf.masked_flash_fwd_plain(q, k, v, mask, scale, rate, seed,
                                           kpm)
    torch.cuda.synchronize()
    assert mf.masked_flash_fwd.bodies.get("mma", 0) == before + 1
    assert torch.isfinite(o).all()
    ratio, rel_rms, ok = _bf16_check(o.float().cpu().numpy(),
                                     o_p.float().cpu().numpy(), **BF16_TOL)
    assert ok, (ratio, rel_rms)
    assert float((lse - lse_p).abs().max()) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    # (B, H, Hkv, S, D, mask, walk block, rate, key mask)
    (2, 8, 8, 512, 64, "causal", 16, 0.1, False),
    (2, 8, 8, 512, 72, "causal", 32, 0.0, False),    # 72: not a multiple of 16
    (2, 8, 8, 512, 32, "causal", 64, 0.1, True),     # head dim 32
    (2, 16, 4, 512, 40, "causal", 128, 0.0, False),  # GQA, G 4; 40: zero tail
    (2, 8, 8, 256, 128, "layout", 16, 0.1, True),    # per-head, empty rows
])
def test_cuda_dkv_tensor_core_body_matches_plain(case):
    """K3's bf16 launches run the tensor-core dk/dv body
    (csrc/mma_dkv.cuh) at every walk block, GQA (fp32 per-q-head
    partials), head dims 32 to 128, dropout and the key mask, and equal
    the plain version; each counts under body "mma"."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from deepspeed_tpu_torch.ops.attention import masked_flash as mf
    B, H, Hkv, s, d, kind, block, rate, km = case
    rng = np.random.RandomState(s + d + block + 1)
    q, k, v, do = (torch.from_numpy(a).to("cuda", torch.bfloat16) for a in
                   _inputs(rng, H // Hkv, "bf16", B=B, H=H, s=s, d=d))
    layout = (_random_layout(rng, heads=H, nb=s // block)
              if kind == "layout" else None)
    mask = _port_mask(kind, s=s, block=block, layout=layout)
    kpm = (torch.from_numpy(_bert_key_mask(rng, B, s, s // 2, (1,))).cuda()
           if km else None)
    scale, seed = 1.0 / np.sqrt(d), 2468
    o_p, lse_p = mf.masked_flash_fwd_plain(q, k, v, mask, scale, rate, seed,
                                           kpm)
    delta = (do.float() * o_p.float()).sum(-1)
    args = (q, k, v, do, lse_p, delta, mask, scale, rate, seed, kpm)
    before = mf.masked_flash_dkv.bodies.get("mma", 0)
    got = mf.masked_flash_dkv(*args)
    torch.cuda.synchronize()
    assert mf.masked_flash_dkv.bodies.get("mma", 0) == before + 1
    for a, b in zip(got, mf.masked_flash_dkv_plain(*args)):
        assert torch.isfinite(a).all()
        ratio, rel_rms, ok = _bf16_check(a.float().cpu().numpy(),
                                         b.float().cpu().numpy(),
                                         **BF16_TOL)
        assert ok, (ratio, rel_rms)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    # (B, H, Hkv, S, D, mask, walk block, rate, key mask)
    (2, 8, 8, 512, 64, "causal", 16, 0.1, False),
    (2, 8, 8, 512, 72, "causal", 32, 0.0, True),     # 72: not a multiple of 16
    (2, 8, 8, 512, 32, "causal", 64, 0.1, True),     # head dim 32
    (2, 16, 4, 512, 40, "causal", 128, 0.1, False),  # GQA, G 4; 40: zero tail
    (2, 16, 4, 512, 64, "dense", 128, 0.0, True),    # GQA, G 4, key mask
    (2, 8, 8, 256, 128, "layout", 16, 0.1, True),    # per-head, empty rows
    (2, 8, 8, 256, 96, "layout", 64, 0.0, False),    # head dim 96
])
def test_cuda_dq_tensor_core_body_matches_plain(case):
    """K2's bf16 launches run the tensor-core dq body (csrc/mma_dq.cuh)
    at every walk block, GQA, head dims 32 to 128 (also not multiples of
    the mma's depth of 16), dropout and the key mask, and equal the plain
    version; each counts under body "mma"."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from deepspeed_tpu_torch.ops.attention import masked_flash as mf
    B, H, Hkv, s, d, kind, block, rate, km = case
    rng = np.random.RandomState(s + d + block + 2)
    q, k, v, do = (torch.from_numpy(a).to("cuda", torch.bfloat16) for a in
                   _inputs(rng, H // Hkv, "bf16", B=B, H=H, s=s, d=d))
    layout = (_random_layout(rng, heads=H, nb=s // block)
              if kind == "layout" else None)
    mask = _port_mask(kind, s=s, block=block, layout=layout)
    kpm = (torch.from_numpy(_bert_key_mask(rng, B, s, s // 2, (1,))).cuda()
           if km else None)
    scale, seed = 1.0 / np.sqrt(d), 1357
    o_p, lse_p = mf.masked_flash_fwd_plain(q, k, v, mask, scale, rate, seed,
                                           kpm)
    delta = (do.float() * o_p.float()).sum(-1)
    args = (q, k, v, do, lse_p, delta, mask, scale, rate, seed, kpm)
    before = mf.masked_flash_dq.bodies.get("mma", 0)
    got = mf.masked_flash_dq(*args)
    torch.cuda.synchronize()
    assert mf.masked_flash_dq.bodies.get("mma", 0) == before + 1
    assert torch.isfinite(got).all()
    ratio, rel_rms, ok = _bf16_check(
        got.float().cpu().numpy(),
        mf.masked_flash_dq_plain(*args).float().cpu().numpy(), **BF16_TOL)
    assert ok, (ratio, rel_rms)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    # (B, H, Hkv, S, D, mask, block, dtype, rate, min_len, all-pad rows)
    (8, 16, 16, 128, 64, "dense", 128, "bf16", 0.0, 64, ()),   # BERT-large
    (8, 16, 16, 128, 64, "dense", 128, "bf16", 0.1, 64, ()),
    (2, 16, 16, 512, 64, "dense", 128, "bf16", 0.1, 256, (1,)),
    (2, 16, 4, 256, 128, "causal", 128, "bf16", 0.1, 100, ()),  # GQA
    (2, 4, 2, 128, 24, "dense", 64, "fp32", 0.1, 30, (0,)),
])
def test_cuda_key_mask_kernels_match_plain(case):
    """The has_kpm arity of K1, K2 and K3 on the card against their plain
    versions on the same inputs; launches count under the key-mask
    arity."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from deepspeed_tpu_torch.ops.attention import masked_flash as mf
    B, H, Hkv, s, d, kind, block, dtype, rate, min_len, pads = case
    rng = np.random.RandomState(s + d + 1)
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    q, k, v, do = (torch.from_numpy(a).to("cuda", td) for a in
                   _inputs(rng, H // Hkv, dtype, B=B, H=H, s=s, d=d))
    kpm = torch.from_numpy(_bert_key_mask(rng, B, s, min_len, pads)).cuda()
    mask = _port_mask(kind, s=s, block=block)
    scale, seed = 1.0 / np.sqrt(d), 77
    kernels = (mf.masked_flash_fwd, mf.masked_flash_dq, mf.masked_flash_dkv)
    name = mf.arity(kpm, mask)
    assert name.startswith("kpm ")
    before = [f.arities.get(name, 0) for f in kernels]
    body = mf.DKV_BODIES[td]
    dkv_before = mf.masked_flash_dkv.bodies.get(body, 0)
    o, lse = mf.masked_flash_fwd(q, k, v, mask, scale, rate, seed, kpm)
    o_p, lse_p = mf.masked_flash_fwd_plain(q, k, v, mask, scale, rate, seed,
                                           kpm)
    delta = (do.float() * o_p.float()).sum(-1)
    args = (q, k, v, do, lse_p, delta, mask, scale, rate, seed, kpm)
    got = [o, mf.masked_flash_dq(*args), *mf.masked_flash_dkv(*args)]
    torch.cuda.synchronize()
    assert [f.arities.get(name, 0) for f in kernels] == \
        [n + 1 for n in before]
    assert mf.masked_flash_dkv.bodies.get(body, 0) == dkv_before + 1
    want = [o_p, mf.masked_flash_dq_plain(*args),
            *mf.masked_flash_dkv_plain(*args)]
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        a, b = a.float().cpu().numpy(), b.float().cpu().numpy()
        if dtype == "fp32":
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-4)
        else:
            ratio, rel_rms, ok = _bf16_check(a, b, **BF16_TOL)
            assert ok, (ratio, rel_rms)
    assert float((lse - lse_p).abs().max()) <= 1e-3


def _band_mask(s, walk, causal=False):
    """The BSLongformer defaults' layout at block 16 (global block 0, a
    window of 3 blocks), or that band clipped causally, as a BlockMask
    over a coarse walk with KIND_BAND tiles."""
    from deepspeed_tpu_torch.ops.attention.masked_flash import BlockMask
    n = s // 16
    idx = np.arange(n)
    rb, cb = idx[:, None], idx[None, :]
    keep = (rb < 1) | (cb < 1) | (np.abs(rb - cb) <= 1)
    if causal:
        keep &= cb <= rb
    mask = BlockMask.from_layout(keep[None].astype(np.int32), 16,
                                 walk_block=walk)
    # detect_banded may describe the clipped band with a longer global
    # row prefix (rows 0-2 keep all their causal cells)
    assert mask.has_band and mask.band[:2] == (16, 1)
    assert mask.band[4] is causal
    return mask


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    # (B, H, S, D, walk, causal, dtype, rate, min_len, all-pad rows)
    (8, 16, 2048, 64, 128, False, "bf16", 0.0, 1024, ()),  # BERT-large
    (2, 16, 2048, 64, 64, False, "bf16", 0.1, 1024, ()),
    (2, 4, 512, 64, 32, False, "fp32", 0.1, 200, (1,)),
    (2, 8, 512, 64, 64, True, "bf16", 0.0, None, ()),       # causal clip
])
def test_cuda_band_kernels_match_plain(case):
    """The KIND_BAND arity of K1, K2 and K3 on the card against their
    plain versions on the same inputs, with the sparse route's 'mul' key
    mask (-1e30 on the pads); launches count under the band arity."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from deepspeed_tpu_torch.ops.attention import masked_flash as mf
    B, H, s, d, walk, causal, dtype, rate, min_len, pads = case
    rng = np.random.RandomState(s + walk)
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    q, k, v, do = (torch.from_numpy(a).to("cuda", td) for a in
                   _inputs(rng, 1, dtype, B=B, H=H, s=s, d=d))
    kpm = None
    if min_len is not None:
        add = _bert_key_mask(rng, B, s, min_len, pads)
        kpm = torch.from_numpy(np.where(add < 0, -1e30, 0.0).astype(
            np.float32)).cuda()
    mask = _band_mask(s, walk, causal)
    scale, seed = 1.0 / np.sqrt(d), 5
    kernels = (mf.masked_flash_fwd, mf.masked_flash_dq, mf.masked_flash_dkv)
    name = mf.arity(kpm, mask)
    assert "band" in name
    before = [f.arities.get(name, 0) for f in kernels]
    body = mf.DKV_BODIES[td]
    dkv_before = mf.masked_flash_dkv.bodies.get(body, 0)
    o, lse = mf.masked_flash_fwd(q, k, v, mask, scale, rate, seed, kpm)
    o_p, lse_p = mf.masked_flash_fwd_plain(q, k, v, mask, scale, rate, seed,
                                           kpm)
    delta = (do.float() * o_p.float()).sum(-1)
    args = (q, k, v, do, lse_p, delta, mask, scale, rate, seed, kpm)
    got = [o, mf.masked_flash_dq(*args), *mf.masked_flash_dkv(*args)]
    torch.cuda.synchronize()
    assert [f.arities.get(name, 0) for f in kernels] == \
        [n + 1 for n in before]
    assert mf.masked_flash_dkv.bodies.get(body, 0) == dkv_before + 1
    want = [o_p, mf.masked_flash_dq_plain(*args),
            *mf.masked_flash_dkv_plain(*args)]
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        a, b = a.float().cpu().numpy(), b.float().cpu().numpy()
        if dtype == "fp32":
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-4)
        else:
            ratio, rel_rms, ok = _bf16_check(a, b, **BF16_TOL)
            assert ok, (ratio, rel_rms)
    assert float((lse - lse_p).abs().max()) <= 1e-3
    if pads:
        assert (o[list(pads)] == 0).all()


def _row_offset_case(device, dtype, B=4, H=2, s=64, d=32, rows=(2, 4)):
    """K1-K3 on rows ``rows`` of a dropout batch, with ``bh0 = row0 * H``,
    against the same kernels on the whole batch, cut to those rows: a
    data-parallel rank draws its rows' masks of the global batch."""
    from deepspeed_tpu_torch.ops.attention import masked_flash as mf
    rng = np.random.RandomState(5)
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    q, k, v, do = (torch.from_numpy(a).to(device, td) for a in
                   _inputs(rng, 1, dtype, B=B, H=H, s=s, d=d))
    mask = _port_mask("causal", s=s, block=32)
    scale, seed, rate = 1.0 / np.sqrt(d), 1234, 0.2
    r0, r1 = rows

    def run(q, k, v, do, bh0):
        o, lse = mf.masked_flash_fwd(q, k, v, mask, scale, rate, seed,
                                     bh0=bh0)
        delta = (do.float() * o.float()).sum(-1)
        args = (q, k, v, do, lse, delta, mask, scale, rate, seed)
        return [o, lse, mf.masked_flash_dq(*args, bh0=bh0),
                *mf.masked_flash_dkv(*args, bh0=bh0)]
    whole = run(q, k, v, do, 0)
    part = run(q[r0:r1], k[r0:r1], v[r0:r1], do[r0:r1], r0 * H)
    local = run(q[r0:r1], k[r0:r1], v[r0:r1], do[r0:r1], 0)
    for w, p in zip(whole, part):
        assert torch.equal(w[r0:r1], p)
    # without the offset a rank would draw the first rows' masks
    assert not torch.equal(whole[0][r0:r1], local[0])


def test_row_offset_draws_the_global_rows():
    _row_offset_case("cpu", "fp32")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
def test_cuda_row_offset_draws_the_global_rows(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    _row_offset_case("cuda", dtype, B=4, H=16, s=1024, d=64)
