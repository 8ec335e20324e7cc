"""Disaggregated prefill/decode in the port's serving engine
(``deepspeed_tpu_torch/inference/disagg.py``, the claim phase, separate
pools and the handoff programs) against the JAX package on the CPU.

- the host half (handoff queue, dispatch trace, pricing) behaves as
  JAX's on the same call sequences, and imports neither torch nor jax;
- the port's ``LinkModel`` prices as JAX's default ``LinkModel``;
- over a shared pool, over separate pools and with speculation on
  separate pools, greedy tokens equal the JAX engine's token for token,
  for the tiny GPT-2 and ``LLAMA_TINY``, with the same warmup program
  count (``handoff_export`` and ``handoff_import`` included), the same
  per-program dispatch and build counts, the same dispatch trace, the
  same ``disagg`` section of ``debug_state`` (less its wall-time means)
  and the same ``serve_handoff`` ledger rows (less their times); every
  handoff is claimed, only the live prompt pages move, both pools drain
  exactly and no decode waits behind a prefill;
- ``cancel`` of a request whose handoff waits empties the queue and
  counts it ``dropped``, as in JAX;
- a chunked engine keeps the dispatch trace, with JAX's rows.

Each JAX engine is built once per module.
"""

import ast
import json
import pathlib

import numpy as np
import pytest
import torch

import tests.torch_threads  # noqa: F401  (torch threads per xdist worker)

REPO = pathlib.Path(__file__).resolve().parents[1]
LLAMA_TINY = dict(vocab_size=512, hidden_size=64, num_layers=4,
                  num_heads=4, num_kv_heads=2, max_position_embeddings=128)
TINY_INF = {"max_batch_size": 3, "prompt_buckets": [4, 8, 16, 24],
            "batch_buckets": [1, 2], "max_seq_len": 48,
            "max_new_tokens": 8}
SHARED = list(range(1, 17))                  # one full 16-token page
WORKLOAD = [SHARED + [20, 21], SHARED + [30, 31, 32], [5, 6, 7] * 4,
            [9, 10] * 5, [40, 41, 42], [50, 51, 52, 53, 54]]
DISAGG = {"disagg": {"enabled": True}}
SEP = {"disagg": {"enabled": True, "separate_pools": True}}
VARIANTS = {"base": {}, "disagg": DISAGG, "sep": SEP, "both": SEP}
# the wall-clock fields of the handoff ledger, left out of the comparison
TIMES = ("queue_ms", "transfer_ms", "handoff_ms", "t", "ts", "wall_ms")


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
    else:
        from deepspeed_tpu.models.llama import LlamaConfig, init_llama_params

        from deepspeed_tpu_torch.models.llama import LlamaConfig as TConfig
        from deepspeed_tpu_torch.models.llama import \
            llama_params_from_jax as params_from_jax
        cfg = LlamaConfig(**LLAMA_TINY)
        params = init_llama_params(cfg, jax.random.PRNGKey(4))
    return cfg, params, TConfig(**cfg._asdict()), params_from_jax(
        jax.tree_util.tree_map(np.asarray, params))


def _oracle(outs, vocab):
    """A draft_fn proposing the continuation of a reference run, every
    third proposal made wrong (``LLAMA_TINY``'s random weights give the
    n-gram drafter nothing to propose)."""
    def draft(history, k):
        h = list(history)
        for out in outs:
            if out[:len(h)] == h:
                cont = list(out[len(h):len(h) + k])
                if len(cont) >= 3:
                    cont[2] = (cont[2] + 1) % vocab
                return cont
        return []
    return draft


def _extra(name, variant, base_outs):
    """(inference config, engine kwargs) of one variant."""
    ic = dict(TINY_INF, **VARIANTS[variant])
    kw = {}
    if variant == "both":
        if name == "gpt2":
            ic["spec_decode"] = {"enabled": True, "k": 4}
        else:
            ic["spec_decode"] = {"enabled": True, "k": 4,
                                 "method": "callable"}
            kw["draft_fn"] = _oracle(base_outs, LLAMA_TINY["vocab_size"])
    return ic, kw


def _trail(events_dir, first_uid):
    """The ``serve_handoff`` rows less their times, each uid as its
    request's submission index (uids count on across a process's
    engines)."""
    rows = [json.loads(line)
            for line in open(pathlib.Path(events_dir) / "events.jsonl")]
    return [{k: (v - first_uid if k == "uid" else v)
             for k, v in r.items() if k not in TIMES}
            for r in rows if r.get("event") == "serve_handoff"]


def _run(engine_cls, request_cls, cfg, params, ic, kw, events_dir, **ekw):
    eng = engine_cls(cfg, params, dict(ic, events_dir=str(events_dir)),
                     observability_config={"serve": {"enabled": True}},
                     **kw, **ekw)
    warm = eng.warmup()
    uids = [eng.submit(request_cls(prompt=list(p), max_new_tokens=8,
                                   temperature=0.0, seed=0))
            for p in WORKLOAD]
    fins = {f.uid: f for f in eng.run()}
    state = eng.debug_state()
    out = {"outs": [fins[u].prompt + fins[u].tokens for u in uids],
           "warm": warm, "rc": eng.steady_state_recompiles,
           "state": state,
           "trace": (eng._dispatch_trace.rows()
                     if eng._dispatch_trace is not None else None),
           "programs": {n: (d["dispatches"], d["compiles"])
                        for n, d in state["programs"].items()}}
    eng.close()
    out["trail"] = _trail(events_dir, uids[0])
    return out


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """Each variant on the JAX engine, once per family."""
    import jax.numpy as jnp
    from deepspeed_tpu.inference import InferenceEngine, Request
    runs = {}
    for name in ("gpt2", "llama"):
        cfg, params, _, _ = _family(name)
        for variant in VARIANTS:
            base = runs.get((name, "base"), {}).get("outs")
            ic, kw = _extra(name, variant, base)
            runs[(name, variant)] = _run(
                InferenceEngine, Request, cfg, params, ic, kw,
                tmp_path_factory.mktemp(f"jax_{name}_{variant}"),
                dtype=jnp.float32)
    return runs


@pytest.mark.parametrize("variant", ["disagg", "sep", "both"])
@pytest.mark.parametrize("name", ["gpt2", "llama"])
def test_disagg_engine_matches_jax(jax_runs, name, variant, tmp_path):
    from deepspeed_tpu_torch.inference import InferenceEngine, Request
    _, _, tcfg, tparams = _family(name)
    want = jax_runs[(name, variant)]
    ic, kw = _extra(name, variant, jax_runs[(name, "base")]["outs"])
    got = _run(InferenceEngine, Request, tcfg, tparams, ic, kw, tmp_path,
               dtype=torch.float32, device="cpu")
    # greedy tokens: JAX's, and the non-disagg engine's
    assert got["outs"] == want["outs"] == jax_runs[(name, "base")]["outs"]
    assert got["warm"] == want["warm"]
    assert got["rc"] == want["rc"] == 0
    assert got["programs"] == want["programs"]
    if variant != "disagg":
        assert got["programs"]["handoff_export"][1] == 1
        assert got["programs"]["handoff_import"][1] == 1
    assert got["trace"] == want["trace"]
    dg, jdg = got["state"]["disagg"], want["state"]["disagg"]
    for h in (dg["handoff"], jdg["handoff"]):
        h.pop("queue_ms_mean")
        h.pop("transfer_ms_mean")
    assert dg == jdg
    assert got["trail"] == want["trail"]
    assert len(got["trail"]) == len(WORKLOAD)
    # every handoff claimed; the decode pool (and the prefill pool)
    # drained exactly; no decode waited behind a prefill
    assert dg["queue"]["depth"] == 0 and dg["queue"]["dropped"] == 0
    assert dg["queue"]["handoffs"] == len(WORKLOAD)
    assert dg["decode_first_fraction"] in (None, 1.0)
    assert got["state"]["page_pool"]["pages_in_use"] == 0
    if variant == "disagg":
        assert {r["mode"] for r in got["trail"]} == {"shared_pool"}
        assert dg["handoff"]["pages_moved"] == 0
    else:
        from deepspeed_tpu_torch.inference.kv_cache import pages_for
        assert {r["mode"] for r in got["trail"]} == {"migrate"}
        assert dg["prefill_pool"]["pages_in_use"] == 0
        assert dg["handoff"]["pages_moved"] == sum(
            pages_for(len(p), 16) for p in WORKLOAD)
        assert dg["handoff"]["bytes_moved"] > 0


def test_some_step_mixed_decode_and_prefill(jax_runs):
    """The decode-first pin measured something: at least one traced
    step of the JAX runs ran both phases (the port's traces equal
    them)."""
    assert any(jax_runs[(n, v)]["state"]["disagg"]["decode_first_fraction"]
               == 1.0 for n in ("gpt2", "llama")
               for v in ("disagg", "sep", "both"))


@pytest.mark.parametrize("variant", ["disagg", "sep"])
def test_cancel_in_the_handoff_queue_counts_dropped(variant):
    import jax.numpy as jnp
    from deepspeed_tpu.inference import InferenceEngine as JaxEngine
    from deepspeed_tpu.inference import Request as JaxRequest

    from deepspeed_tpu_torch.inference import InferenceEngine, Request
    cfg, params, tcfg, tparams = _family("gpt2")
    ic = dict(TINY_INF, **VARIANTS[variant])
    states = []
    for cls, req, c, p, kw in (
            (JaxEngine, JaxRequest, cfg, params, {"dtype": jnp.float32}),
            (InferenceEngine, Request, tcfg, tparams,
             {"dtype": torch.float32, "device": "cpu"})):
        eng = cls(c, p, ic, **kw)
        eng.warmup()
        uids = [eng.submit(req(prompt=list(w), max_new_tokens=6,
                               temperature=0.0, seed=0))
                for w in WORKLOAD[:3]]
        eng.step()                  # prefilled: the handoffs wait
        before = eng.debug_state()["disagg"]["queue"]
        fin = eng.cancel(uids[1])
        assert fin is not None and fin.ttft_ms is None
        after = eng.debug_state()["disagg"]["queue"]
        assert eng.cancel(10**6) is None
        rest = eng.run()
        states.append((before, after,
                       sorted(f.uid - uids[0] for f in rest),
                       eng.debug_state()["disagg"]["queue"],
                       eng.scheduler.allocator.pages_in_use))
        eng.close()
    assert states[0] == states[1]
    before, after, _, end, in_use = states[1]
    assert after["depth"] == before["depth"] - 1
    assert after["dropped"] == 1 and end["depth"] == 0 and in_use == 0


def test_chunked_engine_keeps_the_dispatch_trace():
    import jax.numpy as jnp
    from deepspeed_tpu.inference import InferenceEngine as JaxEngine

    from deepspeed_tpu_torch.inference import InferenceEngine
    cfg, params, tcfg, tparams = _family("gpt2")
    ic = dict(TINY_INF, chunked_prefill={"enabled": True,
                                         "chunk_tokens": 8})
    prompts = [list(range(1, 40)), [5, 6, 7], list(range(3, 33))]
    rows = []
    for cls, c, p, kw in ((JaxEngine, cfg, params, {"dtype": jnp.float32}),
                          (InferenceEngine, tcfg, tparams,
                           {"dtype": torch.float32, "device": "cpu"})):
        eng = cls(c, p, ic, **kw)
        eng.warmup()
        out = eng.generate(prompts, max_new_tokens=4, temperature=0.0)
        rows.append((out, eng._dispatch_trace.rows()))
        eng.close()
    assert rows[0] == rows[1]
    kinds = [k for _, k in rows[1][1]]
    assert "chunk" in kinds and "decode" in kinds


def test_disagg_module_imports_neither_torch_nor_jax():
    tree = ast.parse((REPO / "deepspeed_tpu_torch/inference/disagg.py")
                     .read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    assert not names & {"torch", "jax", "jaxlib", "deepspeed_tpu",
                        "numpy"}


def _queue_script(mod):
    """One call sequence over a handoff queue with a fake clock: pushes,
    a bounced claim, a pop, a drop; returns what the queue reports."""
    now = [10.0]
    q = mod.HandoffQueue(clock=lambda: now[0])
    rec = mod.HandoffRecord
    q.push(rec(uid=1, slot=0, first_token=5, live_pages=2,
               prompt_tokens=20, t_ready=9.0))
    q.push(rec(uid=2, slot=1, first_token=6, live_pages=1,
               prompt_tokens=3, t_ready=9.5))
    a, b = q.drain()
    waits = [q.claimed(a)]
    q.requeue(b)
    q.push(rec(uid=3, slot=2, first_token=7, live_pages=1,
               prompt_tokens=4, t_ready=9.75))
    b2, c = q.drain()
    order = [b2.uid, c.uid]
    q.push(b2)
    q.push(c)
    q.dropped(q.pop(3))
    now[0] = 11.0
    waits.append(q.claimed(q.drain()[0]))
    return (waits, order, b.attempts, q.pop(99), q.debug_state(), len(q))


def _trace_script(mod):
    t = mod.DispatchTrace(cap=6)
    for step, kinds in enumerate([("handoff", "verify", "prefill"),
                                  ("decode", "prefill"),
                                  ("prefill", "decode"),
                                  ("decode", "chunk", "prefill"),
                                  ("decode",)]):
        for k in kinds:
            t.record(step, k)
    full = mod.DispatchTrace()
    full.record(0, "decode")
    full.record(0, "decode")
    return (t.rows(), t.total, t.decode_first_fraction(),
            full.decode_first_fraction())


def _stats_script(mod):
    s = mod.HandoffStats()
    before = s.snapshot()
    s.record(1.5, 0.25, 2, 4096)
    s.record(0.5, 0.75, 1, 2048)
    return before, s.snapshot()


@pytest.mark.parametrize("script", [_queue_script, _trace_script,
                                    _stats_script])
def test_host_bookkeeping_like_jax(script):
    from deepspeed_tpu.inference import disagg as jax_disagg

    from deepspeed_tpu_torch.inference import disagg
    assert script(disagg) == script(jax_disagg)


def test_price_handoff_and_link_model_like_jax():
    from deepspeed_tpu.inference.disagg import price_handoff as jprice
    from deepspeed_tpu.runtime.comm_autotune import LinkModel as JLink

    from deepspeed_tpu_torch.inference.disagg import price_handoff
    from deepspeed_tpu_torch.inference.engine import LinkModel
    for axis in ("intra", "inter"):
        assert LinkModel().bytes_per_us(axis) == JLink().bytes_per_us(axis)
        assert LinkModel().latency_us(axis) == JLink().latency_us(axis)
        for pages, hops in ((0, 1), (3, 0), (2, 1), (7, 2)):
            assert price_handoff(pages, 65536, LinkModel(), axis, hops) \
                == jprice(pages, 65536, JLink(), axis, hops)
    assert price_handoff(2, 1000, LinkModel(), "intra") == pytest.approx(
        1e-3 + 2000 / (75e9 / 8 / 1e6) / 1e3)


def test_migration_record_like_jax():
    from deepspeed_tpu.inference.disagg import MigrationRecord as JRec

    from deepspeed_tpu_torch.inference.disagg import MigrationRecord
    kw = dict(uid=4, prompt=[1, 2], max_new_tokens=3, temperature=0.0,
              seed=1, eos_id=None, priority=0, position=3, pending_tok=9,
              tokens=[9], live_pages=1, page_bytes=64, ttft_ms=1.0,
              queue_wait_ms=0.5, elapsed_ms=2.0,
              kslab=np.zeros((2, 1, 2, 4, 8), np.float32),
              vslab=np.zeros((2, 1, 2, 4, 8), np.float32))
    a, b = MigrationRecord(**kw), JRec(**kw)
    assert a.to_header() == b.to_header() and a.nbytes == b.nbytes == 1024
