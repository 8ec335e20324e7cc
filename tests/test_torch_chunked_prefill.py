"""Chunked prefill in the port's serving engine (the chunk phase and its
init, ``deepspeed_tpu_torch/inference/engine.py``) against the JAX
package on the CPU.

- greedy tokens equal JAX's chunked engine for the tiny GPT-2 and Llama,
  with a long prompt past every prompt bucket, a prefix-sharing sibling
  of it (prefix-cache reuse) and repetition, with and without
  speculative decoding, and over the int8 pool; each JAX engine is built
  once per module;
- a prompt past the largest bucket is rejected with chunking off and
  served with it on; a prompt beyond ``max_seq_len`` is rejected even
  with chunking, as in JAX;
- ``steady_state_recompiles`` stays 0 under mixed long and short churn;
- the chunk warmup plan and the warmup program count equal JAX's, also
  where the chunk width is a prompt bucket (that chunk is the prefill
  program, as one jit serves both in JAX);
- ``Serve/chunk_dispatches`` and the ``serve_prefill_chunk`` trail rows
  carry JAX's tags and keys.
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_threads  # noqa: F401  (torch threads per xdist worker)

LONG = [1, 2, 3, 4] * 5                       # 20 tokens
PROMPTS = [LONG, [5, 6, 7], LONG[:8] + [9, 10], [8, 9, 8, 9, 8, 9]]
CHUNKED_INF = {"max_batch_size": 3, "prompt_buckets": [4],
               "batch_buckets": [2], "max_seq_len": 32,
               "max_new_tokens": 6,
               "paged_kv": {"page_size": 4, "num_pages": 24},
               "chunked_prefill": {"enabled": True, "chunk_tokens": 8}}
WHOLE_INF = dict(CHUNKED_INF, prompt_buckets=[4, 24],
                 chunked_prefill={"enabled": False})
SPEC = {"spec_decode": {"enabled": True, "k": 4}}
INT8 = {"paged_kv": {"page_size": 4, "num_pages": 24, "kv_dtype": "int8",
                     "kv_quant_block": 4}}
VARIANTS = {"plain": {}, "spec": SPEC, "int8": INT8}


def _family(name):
    """(JAX config, JAX params, port config, port params)."""
    if name == "gpt2":
        from deepspeed_tpu.models.gpt2 import GPT2Config, init_gpt2_params

        from deepspeed_tpu_torch.models.gpt2 import GPT2Config as TConfig
        from deepspeed_tpu_torch.models.gpt2 import params_from_jax
        cfg = GPT2Config(vocab_size=61, max_position_embeddings=32,
                         hidden_size=32, num_layers=2, num_heads=4,
                         embd_dropout=0.0, attn_dropout=0.0,
                         resid_dropout=0.0)
        params = init_gpt2_params(cfg, jax.random.PRNGKey(3))
        conv = params_from_jax
    else:
        from deepspeed_tpu.models.llama import LlamaConfig, init_llama_params

        from deepspeed_tpu_torch.models.llama import LlamaConfig as TConfig
        from deepspeed_tpu_torch.models.llama import llama_params_from_jax
        cfg = LlamaConfig(vocab_size=61, hidden_size=32, num_layers=2,
                          num_heads=4, num_kv_heads=2,
                          max_position_embeddings=32)
        params = init_llama_params(cfg, jax.random.PRNGKey(4))
        conv = llama_params_from_jax
    return cfg, params, TConfig(**cfg._asdict()), conv(
        jax.tree_util.tree_map(np.asarray, params))


def _port(name, icfg, **kw):
    from deepspeed_tpu_torch import InferenceEngine
    _, _, tcfg, tparams = _family(name)
    return InferenceEngine(tcfg, tparams, icfg, dtype=torch.float32,
                           device="cpu", **kw)


def _serve(eng, prompts=PROMPTS):
    warm = eng.warmup()
    outs = eng.generate(prompts, max_new_tokens=6, temperature=0.0)
    return outs, warm, eng.steady_state_recompiles, eng.debug_state()


@pytest.fixture(scope="module")
def jax_chunked():
    """JAX's chunked engine per (family, variant)."""
    from deepspeed_tpu.inference import InferenceEngine
    runs = {}
    for name in ("gpt2", "llama"):
        cfg, params, _, _ = _family(name)
        for var, extra in VARIANTS.items():
            if name == "llama" and var == "int8":
                continue
            eng = InferenceEngine(cfg, params, dict(CHUNKED_INF, **extra),
                                  dtype=jnp.float32)
            outs, warm, rc, state = _serve(eng)
            runs[name, var] = (outs, warm, rc, state["chunked_prefill"])
            eng.close()
    return runs


@pytest.mark.parametrize("name,var", [("gpt2", "plain"), ("gpt2", "spec"),
                                      ("gpt2", "int8"), ("llama", "plain"),
                                      ("llama", "spec")])
def test_chunked_tokens_match_jax(jax_chunked, name, var):
    """The same greedy tokens, warmup program count and chunk ledger as
    JAX's chunked engine; the long prompt went through chunk dispatches
    and its prefix-sharing sibling hit the prefix cache."""
    want, warm, rc, ck = jax_chunked[name, var]
    eng = _port(name, dict(CHUNKED_INF, **VARIANTS[var]))
    got, twarm, trc, state = _serve(eng)
    assert got == want
    assert twarm == warm and trc == rc == 0
    assert state["chunked_prefill"] == ck
    assert ck["dispatches"] > 0 and ck["chunking_slots"] == 0
    assert state["programs"]["chunk"]["dispatches"] == ck["dispatches"] + 1
    assert state["page_pool"]["prefix_cache"]["hit_requests"] >= 1
    if var == "spec":
        assert state["programs"]["verify"]["dispatches"] > 1


@pytest.mark.parametrize("name", ["gpt2", "llama"])
def test_chunked_equals_whole_prompt_prefill(name):
    """The port chunked and the port prefilling whole prompts (a ladder
    tall enough for LONG) give the same tokens: each final chunk samples
    at the position a whole-prompt prefill samples at."""
    got = _serve(_port(name, dict(CHUNKED_INF, **SPEC)))[0]
    assert got == _serve(_port(name, dict(WHOLE_INF, **SPEC)))[0]


def test_long_prompt_rejected_without_chunking_served_with_it():
    from deepspeed_tpu_torch.inference import Request
    over = list(range(1, 27))                 # 26 > bucket 24
    eng = _port("gpt2", WHOLE_INF)
    eng.warmup()
    uid = eng.submit(Request(prompt=over, max_new_tokens=6,
                             temperature=0.0, seed=0))
    mine = [f for f in eng.run() if f.uid == uid]
    assert len(mine) == 1 and mine[0].finish_reason == "reject_too_long"
    assert mine[0].tokens == [] and mine[0].ttft_ms is None
    outs = eng.generate([over, [5, 6, 7]], max_new_tokens=6,
                        temperature=0.0)
    assert outs[0] == over and len(outs[1]) == 3 + 6
    outs, _, rc, state = _serve(_port("gpt2", CHUNKED_INF), [over])
    assert outs[0][:26] == over and len(outs[0]) == 26 + 6
    assert rc == 0
    ck = state["chunked_prefill"]
    assert ck["dispatches"] == math.ceil(26 / 8)
    assert (ck["chunking_slots"], ck["cp_shards"]) == (0, 1)
    assert ck["cp_reason"] == "cp_threshold_tokens unset"


def test_beyond_max_len_rejected_even_with_chunking():
    from deepspeed_tpu_torch.inference import Request
    eng = _port("gpt2", CHUNKED_INF)
    uid = eng.submit(Request(prompt=list(range(1, 31)),
                             max_new_tokens=6))           # 30 + 6 > 32
    fins = eng.step()
    assert [f.uid for f in fins] == [uid]
    assert fins[0].finish_reason == "reject_too_long"


def test_zero_recompiles_under_mixed_churn():
    """Waves of long and short prompts landing while earlier ones still
    decode: after warmup not one program is built."""
    from deepspeed_tpu_torch.inference import Request
    eng = _port("gpt2", dict(CHUNKED_INF, **SPEC))
    assert eng.steady_state_recompiles == -1
    eng.warmup()
    rng = np.random.RandomState(9)
    waves = [[rng.randint(1, 61, (n,)).tolist() for n in lens]
             for lens in ((20, 3), (11, 2, 17), (26,), (5, 22))]
    finished = 0
    pending = list(waves)
    while pending or not eng.scheduler.idle():
        if pending:
            for p in pending.pop(0):
                eng.submit(Request(prompt=p, max_new_tokens=4,
                                   temperature=0.0, seed=0))
        finished += len(eng.step())
    assert finished == sum(len(w) for w in waves)
    assert eng.steady_state_recompiles == 0
    assert eng.dispatches["chunk"] > 2


@pytest.mark.parametrize("buckets,chunk", [([4], 8), ([4, 8], 8)])
def test_chunk_warmup_plan_and_program_count_like_jax(buckets, chunk):
    """``chunk_warmup_plan`` gives JAX's shapes, and warmup builds as many
    programs as JAX compiles: one chunk per batch bucket, none where the
    chunk width is already a prompt bucket."""
    from deepspeed_tpu.inference import InferenceEngine
    from deepspeed_tpu.inference.buckets import chunk_warmup_plan as jplan

    from deepspeed_tpu_torch.inference.buckets import chunk_warmup_plan
    for bbs, ct in (([1, 2], 8), ([1, 2], 0), ([2], 16), ([1, 4, 8], 3)):
        assert chunk_warmup_plan(bbs, ct) == jplan(bbs, ct)
    icfg = dict(CHUNKED_INF, prompt_buckets=buckets, batch_buckets=[1, 2],
                chunked_prefill={"enabled": True, "chunk_tokens": chunk})
    cfg, params, _, _ = _family("gpt2")
    want = InferenceEngine(cfg, params, icfg, dtype=jnp.float32).warmup()
    eng = _port("gpt2", icfg)
    assert eng.warmup() == want
    assert eng.debug_state()["programs"]["chunk"]["compiles"] == (
        0 if chunk in buckets else 2)


def test_chunk_trail_rows_and_tags_like_jax(tmp_path):
    """One ``serve_prefill_chunk`` row per chunk with JAX's keys, ordinals
    0..k-1 and monotone cum_ms; ``Serve/chunk_dispatches`` rows with
    JAX's tag and values; the finish row carries the chunk count."""
    from deepspeed_tpu.inference import InferenceEngine, Request
    from deepspeed_tpu.utils import monitor as jmonitor

    from deepspeed_tpu_torch.inference import Request as TRequest
    from deepspeed_tpu_torch.utils import monitor
    assert monitor.TAG_SERVE_CHUNK_DISPATCHES == \
        jmonitor.TAG_SERVE_CHUNK_DISPATCHES
    cfg, params, _, _ = _family("gpt2")
    obs = {"serve": {"sample_rate": 1.0}}
    rows = {}
    for side, d in (("jax", tmp_path / "j"), ("port", tmp_path / "t")):
        icfg = dict(CHUNKED_INF, events_dir=str(d))
        if side == "jax":
            eng = InferenceEngine(cfg, params, icfg, dtype=jnp.float32,
                                  observability_config=obs)
            req = Request
        else:
            eng = _port("gpt2", icfg, observability_config=obs)
            req = TRequest
        eng.warmup()
        uid = eng.submit(req(prompt=LONG, max_new_tokens=4,
                             temperature=0.0, seed=0))
        eng.run()
        eng.close()
        got = [json.loads(line) for line in open(d / "events.jsonl")]
        rows[side] = (uid, got)
    k = math.ceil(len(LONG) / 8)
    shape = {}
    for side, (uid, got) in rows.items():
        chunks = [r for r in got if r.get("event") == "serve_prefill_chunk"
                  and r.get("uid") == uid]
        assert [c["chunk"] for c in chunks] == list(range(k))
        assert sum(c["tokens"] for c in chunks) == len(LONG)
        cums = [c["cum_ms"] for c in chunks]
        assert cums == sorted(cums)
        fin = next(r for r in got if r.get("event") == "serve_finish"
                   and r.get("uid") == uid)
        assert fin["chunks"] == k
        counts = [r["value"] for r in got
                  if r.get("tag") == "Serve/chunk_dispatches"]
        # the JAX engine's compile tracker also writes "compile" rows:
        # the port builds programs, it compiles nothing
        shape[side] = (sorted(chunks[0]), counts,
                       sorted({r["event"] for r in got if "event" in r}
                              - {"compile"}))
    assert shape["port"] == shape["jax"]
    assert shape["port"][1] == list(range(1, k + 1))
