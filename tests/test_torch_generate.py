"""``gpt2_generate`` and ``llama_generate`` of the port against the JAX
package on the CPU, and the dense cached attention under them.

- greedy generation gives JAX's tokens token for token, for GPT-2 (both
  layouts) and Llama (GQA), in fp32;
- the dense cache's prefill and decode logits through ``gpt2_forward`` /
  ``llama_forward`` (no block tables) equal JAX's within its own
  ``atol`` 2e-4, and the caches they write agree;
- greedy generation equals the argmax over a full forward at every step;
- sampled generation is reproducible from one seed, stays inside the top
  k, and refuses what JAX refuses (a MoE block, a sequence past the
  table);
- ``make_token_sampler`` is greedy at temperature 0, and the prefill goes
  through ``flash_attention`` once per layer (K1 on the card);
- the serving engine over the dense slot cache (``paged_kv.enabled:
  false``) serves the JAX dense engine's greedy tokens with its warmup
  program count, dispatches and ``quantization`` section (int8-resident
  weights too), and the paged engine's tokens, greedy and sampled.

The sampled draws are the port's own (``torch.multinomial`` from a
``torch.Generator``), not ``jax.random``'s: a deliberate difference, so
sampled runs are compared with themselves, not with JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_threads  # noqa: F401  (torch threads per xdist worker)

ATOL = 2e-4        # the JAX suite's own dense-cache tolerance
LLAMA_TINY = dict(vocab_size=512, hidden_size=64, num_layers=4,
                  num_heads=4, num_kv_heads=2, max_position_embeddings=128)


def _gpt2(scan=False, vocab=97, layers=2):
    from deepspeed_tpu.models.gpt2 import GPT2Config, init_gpt2_params

    from deepspeed_tpu_torch.models.gpt2 import GPT2Config as TConfig
    from deepspeed_tpu_torch.models.gpt2 import params_from_jax
    cfg = GPT2Config(vocab_size=vocab, max_position_embeddings=64,
                     hidden_size=32, num_layers=layers, num_heads=4,
                     embd_dropout=0.0, attn_dropout=0.0, resid_dropout=0.0,
                     scan_layers=scan)
    params = init_gpt2_params(cfg, jax.random.PRNGKey(1))
    return cfg, params, TConfig(**cfg._asdict()), params_from_jax(
        jax.tree_util.tree_map(np.asarray, params))


def _llama():
    from deepspeed_tpu.models.llama import LlamaConfig, init_llama_params

    from deepspeed_tpu_torch.models.llama import LlamaConfig as TConfig
    from deepspeed_tpu_torch.models.llama import llama_params_from_jax
    cfg = LlamaConfig(**LLAMA_TINY)
    params = init_llama_params(cfg, jax.random.PRNGKey(4))
    return cfg, params, TConfig(**cfg._asdict()), llama_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params))


def _prompt(B, P, vocab, seed):
    return np.random.RandomState(seed).randint(0, vocab, (B, P)).astype(
        np.int32)


@pytest.mark.parametrize("scan", [False, True])
def test_gpt2_generate_greedy_matches_jax(scan):
    from deepspeed_tpu.models.gpt2 import gpt2_generate as jax_generate

    from deepspeed_tpu_torch.models.gpt2 import gpt2_generate
    cfg, params, tcfg, tparams = _gpt2(scan=scan)
    prompt = _prompt(3, 7, 97, 0)
    want = np.asarray(jax_generate(params, cfg, jnp.asarray(prompt), 9,
                                   dtype=jnp.float32))
    got = gpt2_generate(tparams, tcfg, torch.from_numpy(prompt), 9,
                        dtype=torch.float32)
    assert got.dtype == torch.int32 and got.shape == (3, 16)
    np.testing.assert_array_equal(got.numpy(), want)


def test_llama_generate_greedy_matches_jax():
    from deepspeed_tpu.models.llama import llama_generate as jax_generate

    from deepspeed_tpu_torch.models.llama import llama_generate
    cfg, params, tcfg, tparams = _llama()
    prompt = _prompt(2, 9, 512, 1)
    want = np.asarray(jax_generate(params, cfg, jnp.asarray(prompt), 8,
                                   dtype=jnp.float32))
    got = llama_generate(tparams, tcfg, torch.from_numpy(prompt), 8,
                         dtype=torch.float32)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_greedy_generate_equals_full_forward_argmax(family):
    """Each generated token is the argmax of a full no-cache forward over
    the sequence so far (the port against itself)."""
    if family == "gpt2":
        from deepspeed_tpu_torch.models.gpt2 import (gpt2_forward as fwd,
                                                     gpt2_generate as gen)
        _, _, tcfg, tparams = _gpt2()
    else:
        from deepspeed_tpu_torch.models.llama import (llama_forward as fwd,
                                                      llama_generate as gen)
        _, _, tcfg, tparams = _llama()
    prompt = torch.from_numpy(_prompt(2, 5, 97, 5))
    out = gen(tparams, tcfg, prompt, 6, dtype=torch.float32)
    seq = prompt
    for t in range(6):
        with torch.no_grad():
            logits = fwd(tparams, tcfg, seq, dtype=torch.float32)
        nxt = logits[:, -1].argmax(-1).to(torch.int32)
        np.testing.assert_array_equal(out[:, 5 + t].numpy(), nxt.numpy())
        seq = torch.cat([seq, nxt[:, None]], dim=1)


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_dense_cache_prefill_and_decode_match_jax(family):
    """One dense-cache prefill (two rows from position 0, written into a
    fresh cache) and one seq-1 decode at per-row positions, through the
    forward without block tables: logits within 2e-4 of JAX's, the
    caches the same."""
    if family == "gpt2":
        from deepspeed_tpu.models.gpt2 import gpt2_forward as jfwd

        from deepspeed_tpu_torch.models.gpt2 import gpt2_forward as tfwd
        cfg, params, tcfg, tparams = _gpt2()
        kvh, hd = cfg.num_heads, cfg.hidden_size // cfg.num_heads
    else:
        from deepspeed_tpu.models.llama import llama_forward as jfwd

        from deepspeed_tpu_torch.models.llama import llama_forward as tfwd
        cfg, params, tcfg, tparams = _llama()
        kvh, hd = cfg.kv_heads, cfg.head_dim
    B, L, S = 2, 24, 6
    shape = (cfg.num_layers, B, kvh, L, hd)
    ids = _prompt(B, S, cfg.vocab_size, 2)
    jcache = (jnp.zeros(shape, jnp.float32), jnp.zeros(shape, jnp.float32))
    tcache = (torch.zeros(shape), torch.zeros(shape))
    zero = np.zeros((B,), np.int32)
    jl, jcache = jfwd(params, cfg, jnp.asarray(ids), dtype=jnp.float32,
                      kv_cache=jcache, cache_position=jnp.asarray(zero))
    with torch.no_grad():
        tl, tcache = tfwd(tparams, tcfg, torch.from_numpy(ids),
                          dtype=torch.float32, kv_cache=tcache,
                          cache_position=torch.from_numpy(zero))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    pos = np.array([S, S - 2], np.int32)       # row 1 overwrites its tail
    tok = ids[:, :1] + 1
    jl, jcache = jfwd(params, cfg, jnp.asarray(tok), dtype=jnp.float32,
                      kv_cache=jcache, cache_position=jnp.asarray(pos))
    with torch.no_grad():
        tl, tcache = tfwd(tparams, tcfg, torch.from_numpy(tok),
                          dtype=torch.float32, kv_cache=tcache,
                          cache_position=torch.from_numpy(pos))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    for j, t in zip(jcache, tcache):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL,
                                   rtol=0)


def test_write_kv_cache_clamps_like_dynamic_update_slice():
    from deepspeed_tpu.models.gpt2 import write_kv_cache as jwrite

    from deepspeed_tpu_torch.models.gpt2 import write_kv_cache
    rs = np.random.RandomState(0)
    cache = rs.randn(3, 2, 8, 4).astype(np.float32)
    new = rs.randn(3, 2, 3, 4).astype(np.float32)
    pos = np.array([0, 4, 7], np.int32)      # 7 + 3 > 8: clamped to 5
    want = np.asarray(jwrite(jnp.asarray(cache), jnp.asarray(new),
                             jnp.asarray(pos)))
    got = write_kv_cache(torch.from_numpy(cache.copy()),
                         torch.from_numpy(new), torch.from_numpy(pos))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_sampled_generate_is_reproducible_inside_top_k(family):
    from deepspeed_tpu_torch.models.gpt2 import make_token_sampler
    if family == "gpt2":
        from deepspeed_tpu_torch.models.gpt2 import gpt2_generate as gen
        _, _, tcfg, tparams = _gpt2()
    else:
        from deepspeed_tpu_torch.models.llama import llama_generate as gen
        _, _, tcfg, tparams = _llama()
    prompt = torch.from_numpy(_prompt(2, 4, 97, 3))
    a = gen(tparams, tcfg, prompt, 8, generator=7, temperature=0.8,
            top_k=5, dtype=torch.float32)
    b = gen(tparams, tcfg, prompt, 8,
            generator=torch.Generator().manual_seed(7), temperature=0.8,
            top_k=5, dtype=torch.float32)
    c = gen(tparams, tcfg, prompt, 8, generator=8, temperature=0.8,
            top_k=5, dtype=torch.float32)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert not torch.equal(a, c)
    assert 0 <= int(a.min()) and int(a.max()) < tcfg.vocab_size
    # every draw lies in the top 5 of its step's logits
    sample = make_token_sampler(tcfg.vocab_size, 0.8, 5, greedy=False)
    logits = torch.randn(64, tcfg.vocab_size,
                         generator=torch.Generator().manual_seed(0))
    draws = sample(logits, torch.Generator().manual_seed(1))
    top = torch.topk(logits, 5, dim=-1).indices
    assert bool((top == draws[:, None].long()).any(dim=-1).all())
    greedy = make_token_sampler(tcfg.vocab_size, 0.0, 5, greedy=True)
    assert torch.equal(greedy(logits, None), logits.argmax(-1).int())


def test_generate_edge_cases_like_jax():
    from deepspeed_tpu_torch.models.gpt2 import gpt2_generate
    _, _, tcfg, tparams = _gpt2()
    prompt = torch.tensor([[1, 2, 3]], dtype=torch.int32)
    assert torch.equal(gpt2_generate(tparams, tcfg, prompt, 0), prompt)
    out = gpt2_generate(tparams, tcfg, prompt, 2, generator=0,
                        top_k=10**6, dtype=torch.float32)
    assert out.shape == (1, 5)
    with pytest.raises(ValueError, match="max_position_embeddings"):
        gpt2_generate(tparams, tcfg, prompt, 62, dtype=torch.float32)
    moe = {k: v for k, v in tparams.items()}
    moe["h_1"] = dict(tparams["h_1"], mlp={"router": torch.zeros(32, 2)})
    with pytest.raises(ValueError, match="dense GPT-2 family"):
        gpt2_generate(moe, tcfg, prompt, 2)


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_prefill_runs_flash_attention_once_per_layer(family, monkeypatch):
    """The prefill is one causal ``flash_attention`` call per layer (K1
    on the card) and the decode steps make none."""
    from deepspeed_tpu_torch.models import gpt2 as g
    from deepspeed_tpu_torch.models import llama as lm
    calls = []
    real = g.flash_attention

    def counted(q, k, v, causal=False, **kw):
        calls.append((tuple(q.shape), causal))
        return real(q, k, v, causal=causal, **kw)
    monkeypatch.setattr(g, "flash_attention", counted)
    monkeypatch.setattr(lm, "flash_attention", counted)
    if family == "gpt2":
        _, _, tcfg, tparams = _gpt2()
        g.gpt2_generate(tparams, tcfg, torch.zeros((2, 8), dtype=torch.int32),
                        5, dtype=torch.float32)
    else:
        _, _, tcfg, tparams = _llama()
        lm.llama_generate(tparams, tcfg,
                          torch.zeros((2, 8), dtype=torch.int32), 5,
                          dtype=torch.float32)
    assert len(calls) == tcfg.num_layers
    assert all(causal and shape[2] == 8 for shape, causal in calls)


# ------------------------------------------- the engine's dense slot cache
DENSE_INF = {"max_batch_size": 3, "prompt_buckets": [4, 8],
             "batch_buckets": [1, 2], "max_seq_len": 32,
             "max_new_tokens": 4, "paged_kv": {"enabled": False}}


def _tiny(family):
    """The serving suite's tiny GPT-2 / Llama (vocab 61, 2 layers)."""
    from tests.unit.test_inference import tiny_gpt2, tiny_llama

    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, params_from_jax
    from deepspeed_tpu_torch.models.llama import LlamaConfig
    cfg, params = tiny_gpt2() if family == "gpt2" else tiny_llama()
    tcls = GPT2Config if family == "gpt2" else LlamaConfig
    return cfg, params, tcls(**cfg._asdict()), params_from_jax(
        jax.tree_util.tree_map(np.asarray, params))


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_dense_cache_engine_matches_jax(family):
    """``paged_kv.enabled: false``: greedy tokens, the warmup program
    count, the per-program dispatches and builds and the quantization
    section of ``debug_state`` equal the JAX dense engine's, under
    continuous batching (8 requests over 3 slots: slots are reused and
    pad rows write the scratch row)."""
    from deepspeed_tpu.inference import InferenceEngine as JaxEngine

    from deepspeed_tpu_torch.inference import InferenceEngine
    cfg, params, tcfg, tparams = _tiny(family)
    prompts = [np.random.RandomState(7).randint(1, 61, (n,)).tolist()
               for n in (3, 5, 7, 2, 8, 4, 6, 1)]
    states = []
    for eng in (JaxEngine(cfg, params, DENSE_INF, dtype=jnp.float32),
                InferenceEngine(tcfg, tparams, DENSE_INF,
                                dtype=torch.float32, device="cpu")):
        warm = eng.warmup()
        out = eng.generate(prompts, max_new_tokens=4, temperature=0.0)
        st = eng.debug_state()
        states.append((out, warm, eng.steady_state_recompiles,
                       {n: (d["dispatches"], d["compiles"])
                        for n, d in st["programs"].items()},
                       st["quantization"], st["page_pool"]))
        eng.close()
    assert states[1] == states[0]
    out, warm, rc, programs, quant, pool = states[1]
    assert rc == 0 and pool is None and programs["decode"][1] == 1
    assert quant["kv_dtype"] == "float32" and quant["kv_quant_block"] == 0


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_dense_cache_engine_equals_paged(family):
    """The dense engine serves the paged engine's greedy tokens on a
    workload whose dense footprint exceeds the small page pool."""
    from deepspeed_tpu_torch.inference import InferenceEngine
    _, _, tcfg, tparams = _tiny(family)
    prompts = [np.random.RandomState(7).randint(1, 61, (n,)).tolist()
               for n in (3, 5, 7, 2, 8, 4, 6, 1)]
    dense = InferenceEngine(tcfg, tparams, DENSE_INF, dtype=torch.float32,
                            device="cpu")
    paged = InferenceEngine(tcfg, tparams,
                            dict(DENSE_INF, paged_kv={"page_size": 4,
                                                      "num_pages": 12}),
                            dtype=torch.float32, device="cpu")
    ref = dense.generate(prompts, max_new_tokens=4, temperature=0.0)
    assert paged.generate(prompts, max_new_tokens=4, temperature=0.0) == ref
    assert dense._kv_bpt == pytest.approx(
        2 * tcfg.num_layers * (tcfg.hidden_size if family == "gpt2" else
                               tcfg.kv_heads * tcfg.head_dim) * 4)


def test_dense_sampling_equals_paged():
    """The port's sampled rows take each position's own generator, so the
    dense stream equals the paged one (as JAX's fold_in schedule does)."""
    from deepspeed_tpu_torch.inference import InferenceEngine
    _, _, tcfg, tparams = _tiny("gpt2")
    prompts = [[1, 2, 3], [4, 5], [6, 7, 8, 9]]
    kw = dict(max_new_tokens=5, temperature=0.8, seeds=[7, 8, 9])
    dense = InferenceEngine(tcfg, tparams, DENSE_INF, dtype=torch.float32,
                            device="cpu")
    paged = InferenceEngine(tcfg, tparams,
                            dict(DENSE_INF, paged_kv={"page_size": 4,
                                                      "num_pages": 16}),
                            dtype=torch.float32, device="cpu")
    assert paged.generate(prompts, **kw) == dense.generate(prompts, **kw)


def test_dense_cache_with_int8_weights_matches_jax():
    from deepspeed_tpu.inference import InferenceEngine as JaxEngine

    from deepspeed_tpu_torch.inference import InferenceEngine
    cfg, params, tcfg, tparams = _tiny("llama")
    ic = dict(DENSE_INF, quantize_weights="int8")
    prompts = [[1, 2, 3], [4, 5, 6, 7, 8], [9] * 7]
    jeng = JaxEngine(cfg, params, ic, dtype=jnp.float32)
    eng = InferenceEngine(tcfg, tparams, ic, dtype=torch.float32,
                          device="cpu")
    assert eng.warmup() == jeng.warmup()
    assert eng.generate(prompts, max_new_tokens=5, temperature=0.0) == \
        jeng.generate(prompts, max_new_tokens=5, temperature=0.0)
    assert eng.debug_state()["quantization"] == \
        jeng.debug_state()["quantization"]
