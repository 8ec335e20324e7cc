"""The port's legacy dense flash route (deepspeed_tpu_torch/ops/attention/
flash.py: ``set_attention_options(kernel="flash")``, the kernels K5-K7
and their plain versions) against the JAX package's Pallas kernels K5-K7
(deepspeed_tpu/ops/attention/flash.py ``_fwd_kernel``, ``_bwd_dq_kernel``,
``_bwd_dkv_kernel``) run in interpret mode on the CPU.

The same numpy inputs, made from a seed, go through both, with the same
tiles on both sides through each package's ``_FORCE_BLOCKS`` and the
same int32 dropout seed (JAX's, drawn from its key). Tolerances:

- fp32: atol 2e-5 (JAX's own for its kernels; the sums run in another
  order);
- bf16: every element within 1e-4 + 2**-7 |want| (both sides round the
  same fp32 values to bf16 -- p before P.V, pd and ds before their
  products, the outputs -- so an element may land one bf16 ulp apart),
  and the whole tensor within a relative RMS error of 1e-3.

One deliberate difference is pinned: causal attention with seq_q > seq_k,
where JAX's walk runs past the key blocks that exist; the port caps it
and equals ``attention_reference``.

The CUDA kernels run only on a card: their tests are marked ``cuda`` and
skip here.
"""

import numpy as np
import pytest
import torch

import tests.torch_threads  # noqa: F401  (torch threads per xdist worker)

FP32_ATOL = 2e-5
BF16_TOL = dict(atol=1e-4, rtol=2.0**-7, rms=1e-3)
D = 16


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


def _inputs(rng, B, H, G, sq, sk, d=D):
    arrs = [rng.randn(B, H, sq, d), rng.randn(B, H // G, sk, d),
            rng.randn(B, H // G, sk, d), rng.randn(B, H, sq, d)]
    return [a.astype(np.float32) * 0.5 for a in arrs]


def _key_mask(rng, B, sk, all_pad_rows=()):
    """BERT's additive mask, (B, 1, 1, Sk): -1e9 on the pads, which start
    inside a tile; every key a pad in ``all_pad_rows``."""
    lengths = rng.randint(sk // 3, sk + 1, size=B)
    am = (np.arange(sk)[None, :] < lengths[:, None]).astype(np.float32)
    am[list(all_pad_rows)] = 0.0
    return ((1.0 - am) * -1e9).astype(np.float32)[:, None, None, :]


def _jax_seed(rate):
    """The int32 seed JAX's flash_attention derives from its key."""
    import jax
    from deepspeed_tpu.ops.attention import flash as jf
    if not rate:
        return 0
    return int(np.asarray(jf.dropout_seed_from_rng(
        jax.random.PRNGKey(11))).reshape(()))


def _jax_kernels(q, k, v, do, mask, causal, rate, seed, blocks, dtype):
    """JAX's K5 (o, lse), then K6 and K7 (dq, dk, dv) through _flash_bwd,
    in interpret mode, at the tiles ``blocks``."""
    import jax.numpy as jnp
    from deepspeed_tpu.ops.attention import flash as jf
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    jq, jk, jv, jdo = (jnp.asarray(a).astype(jd) for a in (q, k, v, do))
    jm = None if mask is None else jnp.asarray(mask)
    jseed = jnp.asarray([[seed]], jnp.int32)
    scale = 1.0 / np.sqrt(q.shape[-1])
    saved = jf._FORCE_BLOCKS
    jf._FORCE_BLOCKS = blocks
    try:
        o, lse = jf._flash_fwd(jq, jk, jv, jm, causal, scale, True,
                               dropout_rate=rate, seed=jseed)
        dq, dk, dv, _ = jf._flash_bwd((jq, jk, jv, jm, jseed, o, lse), jdo,
                                      causal, scale, True, dropout_rate=rate)
    finally:
        jf._FORCE_BLOCKS = saved
    return [np.asarray(jnp.asarray(x).astype(jnp.float32))
            for x in (o, lse, dq, dk, dv)]


@pytest.fixture
def legacy_route():
    """``kernel="flash"`` on the port's side, restored after."""
    from deepspeed_tpu_torch.ops.attention import flash as tf
    old = tf.set_attention_options(kernel="flash")
    try:
        yield tf
    finally:
        tf.set_attention_options(kernel=old.kernel)


CASES = [
    # (name, B, H, G, sq, sk, causal, key mask, rate, dtype, (bq, bk))
    ("full", 1, 2, 1, 64, 64, False, False, 0.0, "fp32", (32, 16)),
    ("full_dropout", 1, 2, 1, 64, 64, False, False, 0.1, "bf16", (16, 32)),
    ("causal", 1, 2, 1, 64, 64, True, False, 0.0, "bf16", (32, 16)),
    ("causal_gqa2_dropout", 1, 4, 2, 64, 64, True, False, 0.1, "fp32",
     (16, 32)),
    ("causal_gqa4", 1, 4, 4, 64, 64, True, False, 0.0, "bf16", (32, 16)),
    ("key_mask_all_pad_row_dropout", 2, 2, 1, 64, 64, False, True, 0.1,
     "bf16", (32, 16)),
    ("key_mask_causal_gqa2", 2, 4, 2, 64, 64, True, True, 0.0, "fp32",
     (16, 16)),
    ("causal_sq_lt_sk_dropout", 1, 2, 1, 32, 64, True, False, 0.1, "fp32",
     (16, 32)),
    ("causal_sq_lt_sk_gqa2", 1, 4, 2, 48, 96, True, False, 0.0, "bf16",
     (16, 32)),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_kernels_and_front_end_match_jax(case, legacy_route):
    """o and lse of the plain K5, dq of the plain K6, dk and dv of the
    plain K7 (fed the plain K5's lse and delta), and o and the grads of
    flash_attention through the autograd Function, against JAX's
    interpret-mode kernels at the same tiles."""
    tf = legacy_route
    name, B, H, G, sq, sk, causal, km, rate, dtype, blocks = case
    rng = np.random.RandomState(len(name) + sq + sk)
    q, k, v, do = _inputs(rng, B, H, G, sq, sk)
    mask = _key_mask(rng, B, sk, all_pad_rows=(1,) if B > 1 and not causal
                     else ()) if km else None
    seed = _jax_seed(rate)
    want = _jax_kernels(q, k, v, do, mask, causal, rate, seed, blocks, dtype)
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    tq, tk, tv, tdo = (torch.from_numpy(a).to(td) for a in (q, k, v, do))
    key_mask = None if mask is None else torch.from_numpy(mask).reshape(
        B, sk)
    scale = 1.0 / np.sqrt(D)
    o, lse = tf.flash_fwd_plain(tq, tk, tv, causal, scale, rate, seed,
                                key_mask, blocks)
    delta = (tdo.float() * o.float()).sum(-1)
    bwd = (tq, tk, tv, tdo, lse, delta, causal, scale, rate, seed, key_mask,
           blocks)
    got = [o, lse, tf.flash_dq_plain(*bwd), *tf.flash_dkv_plain(*bwd)]
    np.testing.assert_allclose(got[1].numpy(), want[1], atol=FP32_ATOL,
                               rtol=0)
    for g, w in zip(got[:1] + got[2:], want[:1] + want[2:]):
        _assert_close(g.float().numpy(), w, dtype)
    # the front end, through the wrappers (the plain versions on the CPU)
    saved = tf._FORCE_BLOCKS
    tf._FORCE_BLOCKS = blocks
    try:
        before = tf.flash_fwd.launches
        leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
        out = tf.flash_attention(
            *leaves, mask=None if mask is None else torch.from_numpy(mask),
            causal=causal, dropout_rate=rate,
            dropout_seed=seed if rate else None)
        grads = torch.autograd.grad(out, leaves, tdo)
    finally:
        tf._FORCE_BLOCKS = saved
    assert tf.flash_fwd.launches == before      # CPU tensors: no launch
    for g, w in zip([out.detach(), *grads], want[:1] + want[2:]):
        _assert_close(g.float().numpy(), w, dtype)
    if causal and sq < sk:      # keys no query reaches take no gradient
        assert (grads[1][:, :, sq:] == 0).all()
        assert (grads[2][:, :, sq:] == 0).all()


def test_causal_sq_gt_sk_equals_reference_not_jax(legacy_route):
    """The deliberate difference: causal with seq_q > seq_k. JAX's K5/K6
    walk ceil((qb * bq + bq) / bk) key blocks, past the seq_k / bk that
    exist (interpret mode repeats the last key block); the port caps the
    walk and equals attention_reference, forward and grads, while JAX's
    interpret-mode kernels do not."""
    tf = legacy_route
    rng = np.random.RandomState(5)
    q, k, v, do = _inputs(rng, 1, 2, 1, 64, 32)
    blocks = (16, 16)
    want = _jax_kernels(q, k, v, do, None, True, 0.0, 0, blocks, "fp32")
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    saved = tf._FORCE_BLOCKS
    tf._FORCE_BLOCKS = blocks
    try:
        out = tf.flash_attention(*leaves, causal=True)
    finally:
        tf._FORCE_BLOCKS = saved
    ref = tf.attention_reference(*leaves, causal=True)
    g_out = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    g_ref = torch.autograd.grad(ref, leaves, torch.from_numpy(do))
    for a, b in zip([out, *g_out], [ref, *g_ref]):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=FP32_ATOL, rtol=0)
    assert np.abs(want[0] - ref.detach().numpy()).max() > 0.1


def test_options(monkeypatch):
    """The default comes from DSTPU_ATTENTION_KERNEL; set_attention_options
    returns the previous options; an unknown kernel raises; a per-call
    ``kernel`` overrides the options."""
    from deepspeed_tpu_torch.ops.attention import (get_attention_options,
                                                   set_attention_options)
    from deepspeed_tpu_torch.ops.attention import flash as tf
    monkeypatch.setenv("DSTPU_ATTENTION_KERNEL", "flash")
    assert tf.AttentionOptions().kernel == "flash"
    monkeypatch.delenv("DSTPU_ATTENTION_KERNEL")
    assert tf.AttentionOptions().kernel == "masked"
    with pytest.raises(ValueError, match="attention kernel"):
        tf.AttentionOptions(kernel="splash")
    first = get_attention_options()
    old = set_attention_options(kernel="reference")
    try:
        assert old is first
        assert get_attention_options().kernel == "reference"
        assert set_attention_options(kernel="flash").kernel == "reference"
        with pytest.raises(ValueError, match="attention kernel"):
            set_attention_options(kernel="pallas")
    finally:
        set_attention_options(kernel=old.kernel)
    assert get_attention_options().kernel == first.kernel
    q = torch.zeros(1, 1, 32, 8)
    calls = []
    monkeypatch.setattr(tf, "flash_call",
                        lambda *a, **kw: calls.append(a) or q)
    tf.flash_attention(q, q, q, kernel="flash")
    assert len(calls) == 1
    with pytest.raises(ValueError, match="kernel must be"):
        tf.flash_attention(q, q, q, kernel="splash")


def test_reference_option_matches_jax_and_is_ignored_when_long(monkeypatch):
    """kernel="reference": attention_reference with bf16 operands and fp32
    sums (mxu_bf16), as JAX computes it; force_reference gets the fp32
    oracle; at seq >= STREAM_THRESHOLD the option is ignored with one log
    line and the legacy kernels run."""
    import jax.numpy as jnp
    from deepspeed_tpu.ops.attention import flash as jf

    from deepspeed_tpu_torch.ops.attention import flash as tf
    from deepspeed_tpu_torch.utils import logging as tlog
    rng = np.random.RandomState(9)
    q, k, v, _ = _inputs(rng, 2, 2, 1, 48, 48)
    mask = _key_mask(rng, 2, 48)
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    for mxu in (True, False):
        want = np.asarray(jf.attention_reference(
            jq, jk, jv, mask=jnp.asarray(mask), causal=True,
            mxu_bf16=mxu).astype(jnp.float32))
        got = tf.attention_reference(tq, tk, tv, mask=torch.from_numpy(mask),
                                     causal=True, mxu_bf16=mxu)
        _assert_close(got.float().numpy(), want, "bf16")
    jold = jf.set_attention_options(kernel="reference")
    told = tf.set_attention_options(kernel="reference")
    try:
        want = np.asarray(jf.flash_attention(jq, jk, jv, causal=True).astype(
            jnp.float32))
        got = tf.flash_attention(tq, tk, tv, causal=True)
        _assert_close(got.float().numpy(), want, "bf16")
        torch.testing.assert_close(got, tf.attention_reference(
            tq, tk, tv, causal=True, mxu_bf16=True), atol=0, rtol=0)
        torch.testing.assert_close(
            tf.flash_attention(tq, tk, tv, causal=True,
                               force_reference=True),
            tf.attention_reference(tq, tk, tv, causal=True), atol=0, rtol=0)
        lines, calls = [], []
        monkeypatch.setattr(tlog.logger, "warning", lines.append)
        tlog.reset_once_logging()
        long_q = torch.zeros(1, 1, tf.STREAM_THRESHOLD, 8)
        monkeypatch.setattr(tf, "flash_call",
                            lambda *a, **kw: calls.append(a) or long_q)
        for _ in range(2):
            tf.flash_attention(long_q, long_q, long_q, causal=True)
        assert len(calls) == 2
        assert len(lines) == 1 and "kernel='reference' ignored" in lines[0]
    finally:
        jf.set_attention_options(kernel=jold.kernel)
        tf.set_attention_options(kernel=told.kernel)


def test_block_rules(monkeypatch):
    """For CPU tensors the tiles are JAX's heuristic (its answer without
    the TPU-measured table); on the card each length takes the widest of
    the kernels' tiles 128, 64, 32, 16 that divides it; _FORCE_BLOCKS
    overrides both."""
    from deepspeed_tpu.ops.attention import flash as jf

    from deepspeed_tpu_torch.ops.attention import flash as tf
    monkeypatch.setattr(jf, "_BLOCK_TABLE", {})
    for sq, sk in [(16, 16), (48, 80), (64, 32), (128, 512), (1024, 1024),
                   (1024, 512), (4096, 4096), (8192, 8192), (8192, 4096),
                   (8208, 8192), (16384, 16384), (96, 2048), (768, 1536)]:
        assert tf._pick_blocks(sq, sk, "cpu") == \
            jf._pick_blocks(sq, sk, 64, 1), (sq, sk)
    for sq, sk, want in [(1024, 1024, (128, 128)), (8192, 8192, (128, 128)),
                         (128, 128, (128, 128)), (512, 1024, (128, 128)),
                         (48, 80, (16, 16)), (96, 64, (32, 64)),
                         (64, 192, (64, 64))]:
        assert tf._pick_blocks(sq, sk, "cuda") == want
    monkeypatch.setattr(tf, "_FORCE_BLOCKS", (32, 16))
    assert tf._pick_blocks(1024, 512, "cuda") == (32, 16)
    assert tf._pick_blocks(1024, 512, "cpu") == (32, 16)
    z = torch.zeros(1, 1, 48, 8)
    with pytest.raises(ValueError, match="do not divide"):
        tf.flash_fwd(z[:, :, :40], z, z, False, 1.0)


def test_no_pad_to_128_branch(legacy_route, monkeypatch):
    """JAX pads a sequence at or beyond STREAM_THRESHOLD that is not a
    multiple of 128 (its DMA lanes need 128) before its kernels; the
    port's kernels stage through shared memory at any multiple of 16, so
    the legacy route takes such a sequence as it is, at tiles of 16 on
    the card."""
    tf = legacy_route
    calls = []
    monkeypatch.setattr(tf, "flash_call",
                        lambda q, k, v, *a: calls.append(
                            (q.shape[2], k.shape[2])) or q)
    q = torch.zeros(1, 1, tf.STREAM_THRESHOLD + 16, 8)
    assert tf.flash_attention(q, q, q, causal=True) is q
    assert calls == [(tf.STREAM_THRESHOLD + 16,) * 2]
    assert tf._pick_blocks(q.shape[2], q.shape[2], "cuda") == (16, 16)


def test_key_mask_takes_a_zero_gradient(legacy_route):
    """The key mask takes no gradient on the legacy route: a zero one
    where it is asked for (JAX's vjp returns zeros)."""
    tf = legacy_route
    rng = np.random.RandomState(12)
    q, k, v, _ = (torch.from_numpy(a).requires_grad_()
                  for a in _inputs(rng, 2, 2, 1, 32, 32))
    mask = torch.from_numpy(_key_mask(rng, 2, 32)).requires_grad_()
    out = tf.flash_attention(q, k, v, mask=mask)
    g_mask, g_q = torch.autograd.grad(out.sum(), (mask, q))
    assert g_mask.shape == mask.shape and float(g_mask.abs().max()) == 0.0
    assert float(g_q.abs().max()) > 0.0


def test_gpt2_loss_and_grads_under_the_knob_match_jax():
    """A tiny GPT-2 (2 layers, hidden 64, 2 heads, seq 64) with
    set_attention_options(kernel="flash") on both sides, at tiles
    (32, 16): the loss and every grad in fp32 against jax.value_and_grad
    with JAX's interpret-mode K5-K7 (loss rtol 1e-5, grads within 1e-4 of
    each grad's largest entry, as in test_torch_training.py)."""
    import jax
    import jax.numpy as jnp
    from deepspeed_tpu.models import gpt2 as jg
    from deepspeed_tpu.ops.attention import flash as jf

    from deepspeed_tpu_torch.models import gpt2 as tg
    from deepspeed_tpu_torch.ops.attention import flash as tf
    from deepspeed_tpu_torch.utils.tree import tree_leaves
    model = dict(vocab_size=128, max_position_embeddings=64, hidden_size=64,
                 num_layers=2, num_heads=2, embd_dropout=0.0,
                 attn_dropout=0.0, resid_dropout=0.0)
    tree = jg.init_gpt2_params(jg.GPT2Config(**model), jax.random.PRNGKey(2))
    ids = np.random.RandomState(3).randint(0, 128, (2, 65)).astype(np.int32)
    blocks = (32, 16)
    jold, told = (m.set_attention_options(kernel="flash") for m in (jf, tf))
    jf._FORCE_BLOCKS = tf._FORCE_BLOCKS = blocks
    tf.reset_launches()
    try:
        jloss = jg.gpt2_loss_fn(jg.GPT2Config(**model), dtype=jnp.float32,
                                deterministic=True)
        jl, jgr = jax.value_and_grad(lambda p: jloss(
            p, {"input_ids": jnp.asarray(ids)}, None))(tree)
        params = tg.trainable_params_from_jax(
            jax.tree_util.tree_map(np.array, tree), "cpu")
        leaves = list(tree_leaves(params))
        tl = tg.gpt2_loss_fn(tg.GPT2Config(**model), dtype=torch.float32,
                             deterministic=True)(
            params, {"input_ids": torch.from_numpy(ids)}, None)
        grads = torch.autograd.grad(tl, leaves)
    finally:
        jf._FORCE_BLOCKS = tf._FORCE_BLOCKS = None
        jf.set_attention_options(kernel=jold.kernel)
        tf.set_attention_options(kernel=told.kernel)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    want = jax.tree_util.tree_leaves(jgr)
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        w = np.asarray(w, np.float32)
        assert float(np.abs(g.numpy() - w).max()) <= \
            1e-4 * max(float(np.abs(w).max()), 1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    # (B, H, Hkv, sq, sk, D, causal, key mask, rate, dtype)
    (8, 16, 16, 1024, 1024, 64, True, False, 0.0, "bf16"),   # GPT-2 345M
    (8, 16, 16, 1024, 1024, 64, True, False, 0.1, "bf16"),
    (8, 16, 16, 128, 128, 64, False, True, 0.1, "bf16"),     # BERT-large
    (2, 32, 8, 1024, 1024, 64, True, False, 0.0, "bf16"),    # LLAMA_1B GQA
    (2, 4, 4, 512, 1024, 64, True, False, 0.1, "fp32"),      # sq < sk
    (2, 4, 2, 1024, 512, 64, True, True, 0.0, "bf16"),       # sq > sk
    (2, 4, 4, 96, 160, 24, False, True, 0.0, "fp32"),        # tiles 32, 32
])
def test_cuda_kernels_match_plain(case):
    """K5, K6 and K7 on the card against their plain versions on the same
    inputs (the backward kernels take the plain forward's lse); each
    launch counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from deepspeed_tpu_torch.ops.attention import flash as tf
    B, H, Hkv, sq, sk, d, causal, km, rate, dtype = case
    rng = np.random.RandomState(sq + sk + d)
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    q, k, v, do = (torch.from_numpy(a).to("cuda", td) for a in
                   _inputs(rng, B, H, H // Hkv, sq, sk, d))
    key_mask = None
    if km:
        key_mask = torch.from_numpy(_key_mask(rng, B, sk, (0,))).reshape(
            B, sk).cuda()
    scale, seed = 1.0 / np.sqrt(d), -42
    kernels = (tf.flash_fwd, tf.flash_dq, tf.flash_dkv)
    before = [f.launches for f in kernels]
    from deepspeed_tpu_torch.ops.attention.masked_flash import DKV_BODIES
    body = DKV_BODIES[td]
    dkv_before = tf.flash_dkv.bodies.get(body, 0)
    o, lse = tf.flash_fwd(q, k, v, causal, scale, rate, seed, key_mask)
    o_p, lse_p = tf.flash_fwd_plain(q, k, v, causal, scale, rate, seed,
                                    key_mask)
    delta = (do.float() * o_p.float()).sum(-1)
    args = (q, k, v, do, lse_p, delta, causal, scale, rate, seed, key_mask)
    got = [o, tf.flash_dq(*args), *tf.flash_dkv(*args)]
    torch.cuda.synchronize()
    assert [f.launches for f in kernels] == [n + 1 for n in before]
    assert tf.flash_dkv.bodies.get(body, 0) == dkv_before + 1
    want = [o_p, tf.flash_dq_plain(*args), *tf.flash_dkv_plain(*args)]
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
    # (B, H, Hkv, sq, sk, D, causal, key mask, rate, (bq, bk))
    (2, 8, 8, 512, 512, 64, True, False, 0.0, (64, 128)),    # bq < bk
    (2, 8, 8, 512, 512, 64, True, False, 0.1, (128, 32)),    # bq > bk
    (2, 8, 8, 256, 512, 64, False, True, 0.0, (16, 64)),     # sq < sk
    (2, 8, 4, 512, 256, 128, True, False, 0.1, (128, 64)),   # sq > sk, GQA
    (2, 8, 2, 384, 384, 40, True, True, 0.1, (128, 128)),    # head dim 40
    (2, 4, 4, 256, 256, 72, False, False, 0.0, (32, 16)),    # head dim 72
    (2, 4, 4, 256, 256, 32, True, False, 0.0, (64, 64)),     # head dim 32
])
def test_cuda_fwd_tensor_core_body_matches_plain(case):
    """K5's bf16 launches run K1's tensor-core body over rectangular
    tiles (bq != bk), seq_q != seq_k, GQA, head dims 32 to 128 (40 and 72
    are not multiples of the mma's depth of 16), dropout and the key mask,
    and equal the plain version at the same tiles; each counts under body
    "mma"."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from deepspeed_tpu_torch.ops.attention import flash as tf
    B, H, Hkv, sq, sk, d, causal, km, rate, blocks = case
    rng = np.random.RandomState(sq + sk + d + blocks[0])
    q, k, v, _ = (torch.from_numpy(a).to("cuda", torch.bfloat16) for a in
                  _inputs(rng, B, H, H // Hkv, sq, sk, d))
    key_mask = None
    if km:
        key_mask = torch.from_numpy(_key_mask(rng, B, sk, (0,))).reshape(
            B, sk).cuda()
    scale, seed = 1.0 / np.sqrt(d), 4321
    before = tf.flash_fwd.bodies.get("mma", 0)
    o, lse = tf.flash_fwd(q, k, v, causal, scale, rate, seed, key_mask,
                          blocks)
    o_p, lse_p = tf.flash_fwd_plain(q, k, v, causal, scale, rate, seed,
                                    key_mask, blocks)
    torch.cuda.synchronize()
    assert tf.flash_fwd.bodies.get("mma", 0) == before + 1
    assert torch.isfinite(o).all()
    _assert_close(o.float().cpu().numpy(), o_p.float().cpu().numpy(),
                  "bf16")
    assert float((lse - lse_p).abs().max()) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    # (B, H, Hkv, sq, sk, D, causal, key mask, rate, (bq, bk))
    (2, 8, 8, 320, 1024, 64, True, False, 0.1, (64, 128)),   # sq < sk
    (2, 8, 2, 1024, 160, 40, False, True, 0.0, (128, 32)),   # GQA 4, hd 40
    (2, 8, 8, 208, 208, 32, True, False, 0.1, (16, 16)),     # tiles of 16
    (2, 16, 4, 512, 512, 128, True, False, 0.1, (128, 128)),  # hd 128, GQA
    (2, 4, 4, 256, 256, 72, False, True, 0.0, (32, 64)),     # head dim 72
    (2, 8, 4, 512, 256, 64, True, False, 0.0, (128, 64)),    # sq > sk
])
def test_cuda_dkv_tensor_core_body_matches_plain(case):
    """K7's bf16 launches run K3's tensor-core dk/dv body over the query
    tiles from JAX's first_qb on: rectangular tiles, seq_q != seq_k (the
    keys no query reaches get dk = dv = 0), GQA, head dims 32 to 128,
    dropout and the key mask; they equal the plain version at the same
    tiles and count under body "mma"."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from deepspeed_tpu_torch.ops.attention import flash as tf
    B, H, Hkv, sq, sk, d, causal, km, rate, blocks = case
    rng = np.random.RandomState(sq + sk + d + blocks[1])
    q, k, v, do = (torch.from_numpy(a).to("cuda", torch.bfloat16) for a in
                   _inputs(rng, B, H, H // Hkv, sq, sk, d))
    key_mask = None
    if km:
        key_mask = torch.from_numpy(_key_mask(rng, B, sk, (0,))).reshape(
            B, sk).cuda()
    scale, seed = 1.0 / np.sqrt(d), 8642
    o_p, lse_p = tf.flash_fwd_plain(q, k, v, causal, scale, rate, seed,
                                    key_mask, blocks)
    delta = (do.float() * o_p.float()).sum(-1)
    args = (q, k, v, do, lse_p, delta, causal, scale, rate, seed, key_mask,
            blocks)
    before = tf.flash_dkv.bodies.get("mma", 0)
    dk, dv = tf.flash_dkv(*args)
    torch.cuda.synchronize()
    assert tf.flash_dkv.bodies.get("mma", 0) == before + 1
    for a, b in zip((dk, dv), tf.flash_dkv_plain(*args)):
        assert torch.isfinite(a).all()
        _assert_close(a.float().cpu().numpy(), b.float().cpu().numpy(),
                      "bf16")
    if causal and sq < sk:
        assert (dk[:, :, sq:] == 0).all() and (dv[:, :, sq:] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    # (B, H, Hkv, sq, sk, D, causal, key mask, rate, (bq, bk))
    (2, 8, 8, 320, 1024, 64, True, False, 0.1, (64, 128)),   # sq < sk
    (2, 8, 2, 1024, 160, 40, False, True, 0.0, (128, 32)),   # GQA 4, hd 40
    (2, 8, 8, 208, 208, 32, True, False, 0.1, (16, 16)),     # tiles of 16
    (2, 16, 4, 512, 512, 128, True, False, 0.1, (128, 128)),  # hd 128, GQA
    (2, 4, 4, 256, 256, 72, False, True, 0.0, (32, 64)),     # head dim 72
    (2, 8, 4, 512, 256, 64, True, True, 0.0, (128, 64)),     # sq > sk
])
def test_cuda_dq_tensor_core_body_matches_plain(case):
    """K6's bf16 launches run K2's tensor-core dq body over K5's capped
    walk of key tiles: rectangular tiles, seq_q != seq_k, GQA, head dims
    32 to 128, dropout and the key mask; they equal the plain version at
    the same tiles and count under body "mma"."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from deepspeed_tpu_torch.ops.attention import flash as tf
    B, H, Hkv, sq, sk, d, causal, km, rate, blocks = case
    rng = np.random.RandomState(sq + sk + d + blocks[0] + 1)
    q, k, v, do = (torch.from_numpy(a).to("cuda", torch.bfloat16) for a in
                   _inputs(rng, B, H, H // Hkv, sq, sk, d))
    key_mask = None
    if km:
        key_mask = torch.from_numpy(_key_mask(rng, B, sk, (0,))).reshape(
            B, sk).cuda()
    scale, seed = 1.0 / np.sqrt(d), 9753
    o_p, lse_p = tf.flash_fwd_plain(q, k, v, causal, scale, rate, seed,
                                    key_mask, blocks)
    delta = (do.float() * o_p.float()).sum(-1)
    args = (q, k, v, do, lse_p, delta, causal, scale, rate, seed, key_mask,
            blocks)
    before = tf.flash_dq.bodies.get("mma", 0)
    dq = tf.flash_dq(*args)
    torch.cuda.synchronize()
    assert tf.flash_dq.bodies.get("mma", 0) == before + 1
    assert torch.isfinite(dq).all()
    _assert_close(dq.float().cpu().numpy(),
                  tf.flash_dq_plain(*args).float().cpu().numpy(), "bf16")


@pytest.mark.parametrize("operand", ["q", "k", "v", "do", "key_mask"])
def test_bf16_dq_refuses_misaligned_operands(operand):
    """K2's and K6's tensor-core dq body loads 16-byte rows (q, k, v, do)
    and 8-byte key-mask pairs: a bf16 view that starts off those
    boundaries raises before any launch, an aligned one and fp32 pass."""
    from deepspeed_tpu_torch.ops.attention.masked_flash import \
        _check_dq_aligned
    shape, n = (1, 2, 32, 16), 2 * 32 * 16

    def operands(dtype, off=None):
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

    _check_dq_aligned(**operands(torch.bfloat16))
    _check_dq_aligned(**operands(torch.float32, operand))
    with pytest.raises(ValueError, match=f"{operand} aligned"):
        _check_dq_aligned(**operands(torch.bfloat16, operand))


@pytest.mark.parametrize("operand", ["q", "k", "v", "do", "key_mask"])
def test_bf16_dkv_refuses_misaligned_operands(operand):
    """K3's and K7's tensor-core dk/dv body loads 16-byte rows (q, k, v,
    do) and 8-byte key-mask pairs: a bf16 view that starts off those
    boundaries raises before any launch, an aligned one and fp32 pass."""
    from deepspeed_tpu_torch.ops.attention.masked_flash import \
        _check_dkv_aligned
    shape, n = (1, 2, 32, 16), 2 * 32 * 16

    def operands(dtype, off=None):
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

    _check_dkv_aligned(**operands(torch.bfloat16))
    _check_dkv_aligned(**operands(torch.float32, operand))
    with pytest.raises(ValueError, match=f"{operand} aligned"):
        _check_dkv_aligned(**operands(torch.bfloat16, operand))
