"""Speculative decoding in the port's serving engine
(``deepspeed_tpu_torch/inference/draft.py``, the verify program and the
spec branch of the decode phase) against the JAX package on the CPU,
and the engine's program set (``inference/programs.py``).

- the drafters propose what JAX's propose on seeded histories, and
  refuse the same configurations;
- with speculation on, greedy tokens, the ``slo.spec`` proposed and
  accepted counts and the warmup program count equal the JAX engine's
  on one workload (continuous batching, a shared full-page prefix,
  periodic prompts the n-gram drafter predicts), for the tiny GPT-2 and
  ``LLAMA_TINY``, over the fp32 and the int8 pool; each JAX engine is
  built once per module;
- the port's sampled rows with speculation equal its own spec-off run
  (each sample's generator is seeded by its position);
- ``set_speculation`` toggles drafting and is a no-op returning False on
  an engine built without it; ``Serve/spec_accept_rate`` is written;
- ``steady_state_recompiles`` is -1 before warmup and 0 after it under
  churn, and counts a program first built after warmup.

The ``cuda`` cases replay each program kind (prefill, decode, verify,
chunk) on the card against its eager run from a copy of the same pool:
logits of the live rows and the pool past the null page bitwise equal.
They skip here.
"""

import copy
import json

import numpy as np
import pytest
import torch

import tests.torch_threads  # noqa: F401  (torch threads per xdist worker)

# examples/llama/train.py's LLAMA_TINY; jax is imported inside the tests
# that use it, so the cuda cases collect on a machine without it
LLAMA_TINY = dict(vocab_size=512, hidden_size=64, num_layers=4,
                  num_heads=4, num_kv_heads=2, max_position_embeddings=128)
TINY_INF = {"max_batch_size": 3, "prompt_buckets": [4, 8, 16, 24],
            "batch_buckets": [1, 2], "max_seq_len": 48,
            "max_new_tokens": 8}
SPEC = {"spec_decode": {"enabled": True, "k": 4}}
# continuous batching + prefix reuse + draftable repetition: two
# requests share a full 16-token page, two are periodic (the n-gram
# drafter's best case), the rest arbitrary (draft stalls ride along)
SHARED = list(range(1, 17))
WORKLOAD = [SHARED + [20, 21], SHARED + [30, 31, 32], [5, 6, 7] * 4,
            [9, 10] * 5, [40, 41, 42], [50, 51, 52, 53, 54]]
POOLS = {"fp": {}, "int8": {"paged_kv": {"kv_dtype": "int8",
                                         "kv_quant_block": 4}}}
# the serving plane on: the tracer keeps the slo.spec ledger
OBS = {"serve": {"enabled": True}}
# LLAMA_TINY's random weights never continue a pattern of its history, so
# the n-gram drafter never proposes for it: Llama drafts through
# spec_decode.method "callable", from a greedy reference run
CALLABLE = {"spec_decode": {"enabled": True, "k": 4, "method": "callable"}}


def _oracle(outs):
    """A draft_fn proposing the continuation of ``outs`` (reference
    sequences) that extends the history, with every third proposal of a
    run made wrong, so verify dispatches accept some drafts and reject
    the rest."""
    def draft(history, k):
        h = list(history)
        for out in outs:
            if out[:len(h)] == h:
                cont = list(out[len(h):len(h) + k])
                if len(cont) >= 3:
                    cont[2] = (cont[2] + 1) % 61
                return cont
        return []
    return draft


def _spec(name, runs):
    """(inference config section, engine kwargs) of ``name``'s
    speculation."""
    if name == "gpt2":
        return SPEC, {}
    return CALLABLE, {"draft_fn": _oracle(runs["llama_greedy"])}


def _family(name):
    """(JAX config, JAX params, port config, port params)."""
    import jax
    if name == "gpt2":
        from deepspeed_tpu.models.gpt2 import GPT2Config, init_gpt2_params

        from deepspeed_tpu_torch.models.gpt2 import GPT2Config as TConfig
        from deepspeed_tpu_torch.models.gpt2 import params_from_jax
        cfg = GPT2Config(vocab_size=61, max_position_embeddings=64,
                         hidden_size=32, num_layers=2, num_heads=4,
                         embd_dropout=0.0, attn_dropout=0.0,
                         resid_dropout=0.0)
        params = init_gpt2_params(cfg, jax.random.PRNGKey(3))
        conv = params_from_jax
    else:
        from deepspeed_tpu.models.llama import LlamaConfig, init_llama_params

        from deepspeed_tpu_torch.models.llama import LlamaConfig as TConfig
        from deepspeed_tpu_torch.models.llama import llama_params_from_jax
        cfg = LlamaConfig(**LLAMA_TINY)
        params = init_llama_params(cfg, jax.random.PRNGKey(4))
        conv = llama_params_from_jax
    return cfg, params, TConfig(**cfg._asdict()), conv(
        jax.tree_util.tree_map(np.asarray, params))


def _serve(eng, request_cls, prompts=WORKLOAD, max_new=8, temperature=0.0,
           top_seed=0):
    """Warm up, submit, run: (outputs by submission order, the finished
    requests, warmup's program count)."""
    warm = eng.warmup()
    uids = [eng.submit(request_cls(prompt=list(p), max_new_tokens=max_new,
                                   temperature=temperature,
                                   seed=top_seed + i))
            for i, p in enumerate(prompts)]
    fins = {f.uid: f for f in eng.run()}
    return ([fins[u].prompt + fins[u].tokens for u in uids],
            [fins[u] for u in uids], warm)


@pytest.fixture(scope="module")
def jax_spec_runs():
    """The JAX engine with speculation, once per (family, pool)."""
    import jax.numpy as jnp
    from deepspeed_tpu.inference import InferenceEngine, Request
    cfg, params, _, _ = _family("llama")
    eng = InferenceEngine(cfg, params, TINY_INF, dtype=jnp.float32)
    runs = {"llama_greedy": _serve(eng, Request)[0]}
    eng.close()
    for name in ("gpt2", "llama"):
        cfg, params, _, _ = _family(name)
        spec, kw = _spec(name, runs)
        for pool, extra in POOLS.items():
            eng = InferenceEngine(cfg, params,
                                  dict(TINY_INF, **spec, **extra),
                                  dtype=jnp.float32,
                                  observability_config=OBS, **kw)
            outs, fins, warm = _serve(eng, Request)
            runs[name, pool] = {
                "outs": outs, "warm": warm,
                "rc": eng.steady_state_recompiles,
                "spec": eng.debug_state()["slo"]["spec"],
                "ledger": [(f.draft_proposed, f.draft_accepted)
                           for f in fins]}
            eng.close()
    return runs


def _port_engine(name, extra, **kw):
    from deepspeed_tpu_torch import InferenceEngine
    _, _, tcfg, tparams = _family(name)
    return InferenceEngine(tcfg, tparams, dict(TINY_INF, **extra),
                           dtype=torch.float32, device="cpu", **kw)


# ------------------------------------------------------------ drafters
DRAFTERS = [dict(k=4, ngram_min=1, ngram_max=3), dict(k=2, ngram_min=1,
                                                      ngram_max=1),
            dict(k=6, ngram_min=2, ngram_max=4), dict(k=1, ngram_min=3,
                                                      ngram_max=3)]


@pytest.mark.parametrize("kw", DRAFTERS)
@pytest.mark.parametrize("seed", range(3))
def test_ngram_drafter_proposes_like_jax(kw, seed):
    """Seeded histories over a small alphabet (so suffixes recur), with
    and without a cap below k: the same proposals, empty ones included."""
    from deepspeed_tpu.inference.draft import NGramDrafter as JaxDrafter

    from deepspeed_tpu_torch.inference.draft import NGramDrafter
    rng = np.random.RandomState(seed)
    ours, theirs = NGramDrafter(**kw), JaxDrafter(**kw)
    empty = 0
    for _ in range(60):
        h = rng.randint(0, 5, size=rng.randint(0, 40)).tolist()
        for cap in (None, 1, kw["k"] + 2):
            got = ours.propose(h, cap)
            assert got == theirs.propose(h, cap)
            empty += not got
    assert 0 < empty < 180


def test_callable_drafter_and_make_drafter_like_jax():
    from deepspeed_tpu.inference import draft as jdraft

    from deepspeed_tpu_torch.inference import draft
    fn = lambda h, k: [t + 1 for t in h[-k:]] + [99] * 3
    for k, cap in ((3, None), (3, 2), (2, 5)):
        h = list(range(10))
        assert draft.CallableDrafter(fn, k=k).propose(h, cap) == \
            jdraft.CallableDrafter(fn, k=k).propose(h, cap)
    assert draft.make_drafter({"enabled": False}) is None
    d = draft.make_drafter({"enabled": True, "k": 3, "ngram_max": 2})
    assert (type(d).__name__, d.k, d.ngram_min, d.ngram_max) == \
        ("NGramDrafter", 3, 1, 2)
    for spec, fn_, exc in (({"enabled": True, "method": "callable"}, None,
                            ValueError),
                           ({"enabled": True, "method": "beam"}, None,
                            ValueError),
                           ({"enabled": True, "k": 0}, None, ValueError)):
        with pytest.raises(exc) as jerr:
            jdraft.make_drafter(spec, fn_)
        with pytest.raises(exc) as terr:
            draft.make_drafter(spec, fn_)
        assert str(terr.value) == str(jerr.value)


# ------------------------------------------------------ engine vs JAX
@pytest.mark.parametrize("pool", list(POOLS))
@pytest.mark.parametrize("name", ["gpt2", "llama"])
def test_spec_engine_matches_jax(jax_spec_runs, name, pool):
    """Greedy tokens, each request's draft ledger, the ``slo.spec``
    counts and the warmup program count equal the JAX engine's; no
    program is built after warmup."""
    from deepspeed_tpu_torch.inference import Request
    ref = jax_spec_runs[name, pool]
    spec, kw = _spec(name, jax_spec_runs)
    eng = _port_engine(name, dict(spec, **POOLS[pool]),
                       observability_config=OBS, **kw)
    outs, fins, warm = _serve(eng, Request)
    assert outs == ref["outs"]
    assert [(f.draft_proposed, f.draft_accepted) for f in fins] == \
        ref["ledger"]
    state = eng.debug_state()
    assert state["slo"]["spec"] == ref["spec"]
    assert 0 < ref["spec"]["accepted"] < ref["spec"]["proposed"]
    assert warm == ref["warm"] == 4 * 2 + 1 + 1
    assert eng.steady_state_recompiles == ref["rc"] == 0
    progs = state["programs"]
    assert progs["verify"]["dispatches"] > 0
    assert progs["verify"]["compiles"] == 1
    assert state["spec_decode"] == {
        "k": 4, "verify_widths": [5],
        "drafter": "NGramDrafter" if name == "gpt2" else "CallableDrafter"}


@pytest.mark.parametrize("name", ["gpt2", "llama"])
def test_spec_greedy_equals_spec_off(jax_spec_runs, name):
    """Speculation changes the dispatches, not the tokens: the port's
    greedy outputs with it equal the port's without it, and the
    scheduler's token count holds only kept tokens."""
    from deepspeed_tpu_torch.inference import Request
    runs = {}
    spec, kw = _spec(name, jax_spec_runs)
    for label, extra, kw_ in (("off", {}, {}), ("on", spec, kw)):
        eng = _port_engine(name, extra, **kw_)
        outs, _, _ = _serve(eng, Request)
        runs[label] = (outs, eng.scheduler.total_tokens,
                       dict(eng.dispatches))
    assert runs["on"][0] == runs["off"][0]
    assert runs["on"][1] == runs["off"][1] == sum(
        len(o) - len(p) for o, p in zip(runs["on"][0], WORKLOAD))
    assert runs["on"][2]["decode"] + runs["on"][2]["verify"] < \
        runs["off"][2]["decode"]


def test_sampled_rows_with_speculation_equal_spec_off():
    """Rows at temperature 0.8 under top-k 5: each sample's generator is
    seeded by (request seed, position of the sampled token), and a
    verify dispatch samples each position as the plain decode would, so
    the outputs with speculation equal those without it."""
    from deepspeed_tpu_torch.inference import Request
    outs = []
    for extra in ({"top_k": 5}, dict(SPEC, top_k=5)):
        eng = _port_engine("gpt2", extra)
        got, _, _ = _serve(eng, Request, temperature=0.8, top_seed=11)
        outs.append(got)
    assert outs[0] == outs[1]
    assert outs[0] != _serve(_port_engine("gpt2", {}), Request)[0]


def test_set_speculation_toggles_drafting():
    from deepspeed_tpu_torch.inference import Request
    eng = _port_engine("gpt2", SPEC)
    assert eng.set_speculation(False) is True
    assert eng.scheduler.spec_k == 0
    outs, _, _ = _serve(eng, Request)
    assert eng.dispatches["verify"] == 1          # warmup's only
    assert eng.set_speculation(True) is True
    assert eng.scheduler.spec_k == 4
    assert _serve(eng, Request)[0] == outs
    assert eng.dispatches["verify"] > 1
    assert eng.steady_state_recompiles == 0
    plain = _port_engine("gpt2", {})
    assert plain.set_speculation(True) is False
    assert plain.scheduler.spec_k == 0 and "verify" not in plain.dispatches


def test_spec_accept_rate_is_written(tmp_path):
    """``Serve/spec_accept_rate`` (JAX's tag) lands in events.jsonl after
    each verify dispatch with proposals, within [0, 1]; the trail's
    spec-window rows and defer reasons keep JAX's keys."""
    from deepspeed_tpu.utils import monitor as jmonitor

    from deepspeed_tpu_torch.inference import Request
    from deepspeed_tpu_torch.inference.tracing import DEFER_REASONS
    from deepspeed_tpu_torch.utils import monitor
    assert monitor.TAG_SERVE_SPEC_ACCEPT == jmonitor.TAG_SERVE_SPEC_ACCEPT
    eng = _port_engine(
        "gpt2", dict(SPEC, events_dir=str(tmp_path)),
        observability_config={"serve": {"enabled": True,
                                        "sample_rate": 0.25}})
    _serve(eng, Request)
    eng.close()
    rows = [json.loads(line) for line in open(tmp_path / "events.jsonl")]
    rates = [r["value"] for r in rows
             if r.get("tag") == "Serve/spec_accept_rate"]
    assert rates and all(0.0 <= v <= 1.0 for v in rates)
    assert max(rates) > 0
    windows = [r for r in rows if r.get("event") == "serve_spec_window"]
    assert windows and all({"proposed", "accepted", "dispatches",
                            "accept_rate"} <= set(r) for r in windows)
    reasons = {r["reason"] for r in rows if r.get("event") == "serve_defer"}
    assert "draft_stall" in reasons and reasons <= set(DEFER_REASONS)
    warm = [r for r in rows if r.get("event") == "serve_warmup"]
    assert warm[0]["programs"] == 10 and warm[0]["verify_widths"] == [5]


def test_recompiles_minus_one_before_warmup_zero_under_churn():
    """Waves of requests landing while earlier ones decode: after
    warmup not one program is built; a shape outside the set counts."""
    from deepspeed_tpu_torch.inference import Request
    eng = _port_engine("gpt2", SPEC)
    assert eng.steady_state_recompiles == -1
    assert eng.debug_state()["steady_state_recompiles"] == -1
    assert eng.warmup() == len(eng.programs) == 10
    rng = np.random.RandomState(9)
    waves = [[rng.randint(1, 61, (n,)).tolist() for n in lens]
             for lens in ((20, 3), (11, 2, 17), (24,), (5, 22, 7))]
    waves[1].append([3, 4] * 6)
    finished = 0
    pending = list(waves)
    while pending or not eng.scheduler.idle():
        if pending:
            for p in pending.pop(0):
                eng.submit(Request(prompt=p, max_new_tokens=6,
                                   temperature=0.0, seed=0))
        finished += len(eng.step())
    assert finished == sum(len(w) for w in waves)
    assert eng.steady_state_recompiles == 0
    assert eng.dispatches["verify"] > 1
    rows = eng._rows
    eng.programs.dispatch(("decode", 2), eng._decode_paged_impl,
                          {"toks": np.zeros((rows,), np.int32),
                           "positions": np.zeros((rows,), np.int32),
                           "tables": np.zeros((rows, 2), np.int32)})
    assert eng.steady_state_recompiles == 1
    assert eng.debug_state()["program_set"]["decode/2"]["dispatches"] == 1


# ------------------------------------------------------ on the card
@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["prefill", "decode", "verify", "chunk"])
@pytest.mark.parametrize("pool", list(POOLS))
def test_cuda_graph_replay_equals_eager(kind, pool):
    """One dispatch of each program kind on live serving state
    (chip_smoke's ``_live_cases``) replayed from its CUDA graph against
    the same program run eagerly from a copy of the pool as it was: the
    live rows' logits and the pool past the null page (pad rows write
    there in any order) bitwise equal; the paged-decode launches counted
    through the replay equal the eager run's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: graphs capture on the card")
    import chip_smoke
    from deepspeed_tpu_torch import InferenceEngine
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, init_gpt2_params
    from deepspeed_tpu_torch.ops.attention.paged import \
        paged_decode_attention as k4
    cfg = GPT2Config(vocab_size=61, max_position_embeddings=256,
                     hidden_size=64, num_layers=2, num_heads=4)
    params = init_gpt2_params(cfg, torch.Generator().manual_seed(0))
    pk = dict(copy.deepcopy(POOLS[pool]).get("paged_kv", {}), page_size=8,
              decode_page_buckets=[8])
    icfg = dict(SPEC, max_batch_size=4, prompt_buckets=[8, 32],
                batch_buckets=[1, 2], max_seq_len=256, paged_kv=pk,
                chunked_prefill={"enabled": True, "chunk_tokens": 16})
    eng = InferenceEngine(cfg, params, icfg, dtype=torch.bfloat16,
                          device="cuda")
    eng.warmup()
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, 61, size=n).tolist() for n in (30, 7, 20)]
    cases = [c for c in chip_smoke._live_cases(eng, prompts)
             if c[0][0] == kind]
    assert cases
    for key, host, live in cases:
        prog = eng.programs.programs[key]
        pool0 = [c.clone() for c in eng._cache]
        before = (k4.launches, k4.launches_int8)
        got = eng.programs.dispatch(key, prog.body, host).clone()
        graph_k4 = (k4.launches - before[0], k4.launches_int8 - before[1])
        pool_g = [c.clone() for c in eng._cache]
        for c, c0 in zip(eng._cache, pool0):
            c.copy_(c0)
        before = (k4.launches, k4.launches_int8)
        want = eng.programs.run_eager(key, host)
        eager_k4 = (k4.launches - before[0], k4.launches_int8 - before[1])
        assert torch.equal(got[live], want[live])
        for a, b in zip(pool_g, eng._cache):
            assert torch.equal(a[:, 1:], b[:, 1:])
        assert graph_k4 == eager_k4
        assert sum(graph_k4) == (cfg.num_layers if kind == "decode" else 0)
        assert prog.graph is not None and prog.replays >= 1
    assert eng.steady_state_recompiles == 0
