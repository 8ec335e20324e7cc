"""The port's serving fleet in process (``deepspeed_tpu_torch/inference/
fleet.py``) against the JAX package's ``FleetRouter`` on the CPU.

- Both routers front three warmed tiny GPT-2 engines in fp32 (the port's
  params are the JAX params, ``params_from_jax``), migration armed, and
  take the same request stream: prefix-affinity routing, an injected
  ``serve.dispatch`` fault, a double drain of replica 1 (its in-flight
  requests migrate alive), a swap to a JAX-written tag, then requests
  that meet the shed ladder's second rung. They give equal tokens,
  routing choices, shed decisions, router rows (kinds and fields, less
  the times) and ``debug_state`` keys; every uid answers once and no
  replica builds a program after warmup.
- The shed ladder and the routing policy run on fake engines through
  both routers: equal decisions.
- A swap onto int8-resident replicas keeps them int8-resident and serves
  the tag's tokens; a ``serve.swap_load`` fault mid-swap rolls one
  replica back and leaves it serving.
- The fleet section, the fleet's scalar tags and the shed vocabulary
  equal JAX's.

The JAX engines are built once per module.
"""

import json
import os

import numpy as np
import pytest
import torch

import tests.torch_threads  # noqa: F401  (torch threads per xdist worker)

MCFG = dict(vocab_size=61, max_position_embeddings=64, hidden_size=32,
            num_layers=2, num_heads=4, embd_dropout=0.0, attn_dropout=0.0,
            resid_dropout=0.0)
INF = {"max_batch_size": 3, "prompt_buckets": [4, 8, 16, 24],
       "batch_buckets": [1, 2], "max_seq_len": 48, "max_new_tokens": 8}
NEW_TOKENS = 8
_rng = np.random.RandomState(5)
SHARED = _rng.randint(1, 61, (16,)).tolist()     # one full page
FIRST = [SHARED + [3, 4], _rng.randint(1, 61, (9,)).tolist(),
         SHARED + [7], _rng.randint(1, 61, (12,)).tolist(),
         _rng.randint(1, 61, (4,)).tolist(), SHARED + [9, 10, 11]]
SECOND = [_rng.randint(1, 61, (n,)).tolist() for n in (5, 13, 6, 8, 10, 7)]
# the ladder's second rung as soon as two TTFTs are in: every time is
# above the budget, so the decisions do not depend on the clock
SHED = {"enabled": True, "ttft_budget_ms": 1e-6, "min_samples": 2,
        "shed_below_priority": 1, "degrade_factor": 1.0,
        "degrade_max_new": 4}
FAULT_UID = 103
# wall-clock fields, left out of the comparison
TIMES = ("t", "route_ms", "transfer_ms", "p95_ttft_ms", "wall_ms")


class _Events:
    def __init__(self):
        self.rows = []

    def add_event(self, kind, **fields):
        self.rows.append({"event": kind, **fields})

    def flush(self):
        pass


def _strip(x):
    if isinstance(x, dict):
        return {k: _strip(v) for k, v in x.items() if k not in TIMES}
    if isinstance(x, list):
        return [_strip(v) for v in x]
    return x


def _keys(x):
    """The key structure of a nested dict (lists by their first item)."""
    if isinstance(x, dict):
        return {k: _keys(v) for k, v in x.items()}
    if isinstance(x, list) and x and isinstance(x[0], dict):
        return [_keys(x[0])]
    return None


def _save_tag(root, tag, params, step):
    from deepspeed_tpu.runtime import checkpoint as ckptlib
    d = os.path.join(root, tag)
    os.makedirs(d, exist_ok=True)
    ckptlib.save_tree_sharded(d, "model_states", params)
    with open(os.path.join(d, "meta.json"), "w") as f:
        json.dump({"global_step": step}, f)
    ckptlib.write_commit_marker(d)
    ckptlib.write_latest(root, tag)
    return d


def _packages():
    """Per package: (InferenceEngine, FleetRouter, Request, fault,
    engine kwargs)."""
    import jax.numpy as jnp

    from deepspeed_tpu.inference import FleetRouter as JRouter
    from deepspeed_tpu.inference import InferenceEngine as JEngine
    from deepspeed_tpu.inference import Request as JRequest
    from deepspeed_tpu.runtime import fault as jfault

    from deepspeed_tpu_torch.inference import (FleetRouter, InferenceEngine,
                                               Request)
    from deepspeed_tpu_torch.runtime import fault
    return {"jax": (JEngine, JRouter, JRequest, jfault,
                    dict(dtype=jnp.float32)),
            "port": (InferenceEngine, FleetRouter, Request, fault,
                     dict(dtype=torch.float32, device="cpu"))}


def _scenario(pkg, cfg, params, ckroot):
    Engine, Router, Request, flt, kw = pkg
    engines = []
    for _ in range(3):
        eng = Engine(cfg, params, dict(INF), **kw)
        eng.warmup()
        eng.warm_migration()
        engines.append(eng)
    ev = _Events()
    router = Router(engines, {"replicas": 3, "routing": "prefix_affinity",
                              "slo_shed": SHED}, writer=ev)
    flt.arm("serve.dispatch", exc=OSError("injected"), times=1,
            filter=lambda replica, uid: uid == FAULT_UID)
    try:
        uids = [router.submit(Request(prompt=p, max_new_tokens=NEW_TOKENS,
                                      temperature=0.0, seed=i,
                                      priority=1, uid=100 + i))
                for i, p in enumerate(FIRST)]
        fins = router.step()
        router.drain(1, reason="manual")
        router.drain(1, reason="manual")          # a no-op
        fins += router.step()
        fins += router.step()
        swap = router.swap_weights(ckroot, tag="global_step2")
        uids += [router.submit(Request(prompt=p, max_new_tokens=NEW_TOKENS,
                                       temperature=0.0, seed=10 + i,
                                       priority=i % 2, uid=200 + i))
                 for i, p in enumerate(SECOND)]
        fins += router.run()
        out = {"uids": uids, "swap": swap,
               "fins": {f.uid: (list(f.tokens), f.finish_reason,
                                f.weight_version) for f in fins},
               "n_fins": len(fins), "debug": router.debug_state(),
               "recompiles": [e.steady_state_recompiles for e in engines],
               "reroutes": router.total_reroutes,
               "migrated": router.total_migrated}
        router.close()
    finally:
        flt.reset()
    out["rows"] = ev.rows
    return out


@pytest.fixture(scope="module")
def fleets(tmp_path_factory):
    import jax

    from deepspeed_tpu.models.gpt2 import GPT2Config, init_gpt2_params

    from deepspeed_tpu_torch.models.gpt2 import GPT2Config as TConfig
    from deepspeed_tpu_torch.models.gpt2 import params_from_jax
    cfg = GPT2Config(**MCFG)
    p1 = init_gpt2_params(cfg, jax.random.PRNGKey(3))
    p2 = init_gpt2_params(cfg, jax.random.PRNGKey(7))
    ckroot = str(tmp_path_factory.mktemp("fleet_tags"))
    _save_tag(ckroot, "global_step1", p1, 1)
    _save_tag(ckroot, "global_step2", p2, 2)
    pk = _packages()
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, p1))
    return {"jax": _scenario(pk["jax"], cfg, p1, ckroot),
            "port": _scenario(pk["port"], TConfig(**MCFG), tparams,
                              ckroot)}


def _router_rows(run, kind=None):
    return [_strip(r) for r in run["rows"]
            if kind is None or r["event"] == kind]


def test_every_uid_answers_once_and_nothing_builds(fleets):
    for run in fleets.values():
        assert run["n_fins"] == len(run["uids"]) == len(run["fins"])
        assert sorted(run["fins"]) == sorted(run["uids"])
        assert run["recompiles"] == [0, 0, 0]
        assert run["reroutes"] == 1
        assert run["migrated"] >= 1
    assert fleets["port"]["swap"] == {0: "global_step2", 2: "global_step2"}


def test_tokens_and_versions_equal_jax(fleets):
    jax_fins, port_fins = fleets["jax"]["fins"], fleets["port"]["fins"]
    assert port_fins == jax_fins
    reasons = {f[1] for f in port_fins.values()}
    assert {"length", "shed_slo"} <= reasons


def test_routing_choices_equal_jax(fleets):
    route = {k: [(r["uid"], r["replica"], r["trace_id"], r["hop"])
                 for r in run["rows"] if r["event"] == "fleet_dispatch"]
             for k, run in fleets.items()}
    assert route["port"] == route["jax"]
    assert FAULT_UID in [u for u, *_ in route["port"]]


def test_shed_decisions_equal_jax(fleets):
    port = _router_rows(fleets["port"], "fleet_shed")
    assert port == _router_rows(fleets["jax"], "fleet_shed")
    assert {r["reason"] for r in port} == {"shed_slo", "degrade_max_new"}
    assert fleets["port"]["debug"]["shed"] == \
        fleets["jax"]["debug"]["shed"]


def test_router_rows_equal_jax_less_times(fleets):
    port, ref = _router_rows(fleets["port"]), _router_rows(fleets["jax"])
    assert [r["event"] for r in port] == [r["event"] for r in ref]
    assert port == ref
    kinds = {r["event"] for r in port}
    assert {"fleet_dispatch", "fleet_drain", "serve_migration",
            "fleet_swap_push", "fleet_shed", "fleet_state",
            "fleet_replica_state"} <= kinds
    begins = [r for r in port if r["event"] == "fleet_drain"
              and r["phase"] == "begin"]
    assert len(begins) == 1          # the second drain was a no-op


def test_debug_state_keys_equal_jax(fleets):
    port, ref = fleets["port"]["debug"], fleets["jax"]["debug"]
    assert _keys(port) == _keys(ref)
    assert _strip(port) == _strip(ref)


# ------------------------------------------------------- fake engines
class _FakeSched:
    def __init__(self):
        self.queue = []
        self.total_tokens = 0
        self.occupancy = 0.0

    @property
    def queue_depth(self):
        return len(self.queue)

    def active_slots(self):
        return []

    def idle(self):
        return not self.queue


def _fake_engine(pkg, ttft_samples=(), prefix_hits=0):
    """The engine's host surface without a device, built on one
    package's Histogram and FinishedRequest."""
    if pkg == "jax":
        from deepspeed_tpu.inference import FinishedRequest
        from deepspeed_tpu.utils.monitor import Histogram
    else:
        from deepspeed_tpu_torch.inference import FinishedRequest
        from deepspeed_tpu_torch.utils.monitor import Histogram

    class Fake:
        def __init__(self):
            self.scheduler = _FakeSched()
            self.received = []
            self.spec_on = True
            self.monitor = None
            self._log = None
            self.steady_state_recompiles = 0
            tracer = type("T", (), {})()
            tracer.slo_ttft_ms = 100.0
            tracer.hist = {"ttft_ms": Histogram()}
            for v in ttft_samples:
                tracer.hist["ttft_ms"].record(v)
            self._tracer = tracer
            if prefix_hits:
                alloc = type("A", (), {})()
                alloc.match_prefix = lambda p, n=prefix_hits: ([], n)
                self.scheduler.admit_allocator = alloc

        def submit(self, req):
            self.scheduler.queue.append(req)
            self.received.append(req)
            return req.uid

        def step(self):
            fins = [FinishedRequest(
                uid=r.uid, prompt=list(r.prompt),
                tokens=[1] * r.max_new_tokens, finish_reason="length",
                ttft_ms=1.0, latency_ms=1.0) for r in self.scheduler.queue]
            self.scheduler.queue = []
            self.scheduler.total_tokens += sum(len(f.tokens) for f in fins)
            return fins

        def cancel(self, uid, reason="evicted"):
            for i, r in enumerate(self.scheduler.queue):
                if r.uid == uid:
                    del self.scheduler.queue[i]
                    return FinishedRequest(
                        uid=uid, prompt=list(r.prompt), tokens=[],
                        finish_reason=reason, ttft_ms=None, latency_ms=0.0)
            return None

        def set_speculation(self, on):
            self.spec_on = bool(on)
            return True
    return Fake()


def _ladder_case(case, pkg):
    """One shed-ladder or routing case on fake engines: what the router
    decided, as plain values."""
    _, Router, Request, _, _ = _packages()[pkg]
    ev = _Events()

    def req(uid, prompt=(1, 2, 3), priority=0, max_new=8):
        return Request(prompt=list(prompt), max_new_tokens=max_new,
                       temperature=0.0, priority=priority, uid=uid)

    def fakes(*samples, **kw):
        return [_fake_engine(pkg, s, **kw) for s in samples]

    if case == "healthy":
        engines = fakes([1.0, 2.0], [1.0])
        slo = dict(enabled=True, ttft_budget_ms=1000.0, min_samples=1)
        reqs = [req(1)]
    elif case == "rung1":
        engines = fakes([50.0, 60.0], [55.0])
        slo = dict(enabled=True, ttft_budget_ms=10.0, min_samples=1,
                   shed_below_priority=1, degrade_factor=100.0)
        reqs = [req(1, priority=0), req(2, priority=1)]
    elif case == "rung2":
        engines = fakes([50.0, 60.0], [55.0])
        slo = dict(enabled=True, ttft_budget_ms=10.0, min_samples=1,
                   shed_below_priority=1, degrade_factor=1.5,
                   degrade_max_new=4)
        reqs = [req(1, priority=1, max_new=40), req(2, priority=0)]
    elif case == "capacity":
        engines, slo, reqs = fakes((), ()), {}, [req(1)]
    elif case == "least_loaded":
        engines, slo = fakes((), ()), {}
        engines[0].scheduler.queue = [req(90), req(91)]
        reqs = [req(1)]
    elif case == "prefix_affinity":
        engines = [_fake_engine(pkg), _fake_engine(pkg, prefix_hits=16)]
        slo, reqs = {}, [req(1, prompt=range(1, 20))]
    else:                                  # drain_redistributes
        engines, slo = fakes((), ()), {}
        reqs = [req(1), req(2)]
    cfg = {"replicas": len(engines)}
    if slo:
        cfg["slo_shed"] = slo
    if case == "prefix_affinity":
        cfg["routing"] = "prefix_affinity"
    router = Router(engines, cfg, writer=ev)
    if case == "capacity":
        router.drain(0, reason="test")
        router.drain(1, reason="test")
        router.step()
    if case == "drain_redistributes":
        engines[1].scheduler.queue = [req(80), req(81), req(82)]
    level = router.shed_level()
    for r in reqs:
        router.submit(r)
    if case == "drain_redistributes":
        engines[1].scheduler.queue = []
        router.drain(0, reason="manual")
    fins = sorted((f.uid, f.finish_reason, len(f.tokens))
                  for f in router.run())
    return {"level": level, "fins": fins,
            "received": [[(r.uid, r.max_new_tokens) for r in e.received]
                         for e in engines],
            "spec_on": [e.spec_on for e in engines],
            "shed": (router.total_shed, dict(router.shed_by_reason),
                     dict(router.shed_by_priority), router.total_degraded),
            "redistributed": router.total_redistributed,
            "rows": [_strip(r) for r in ev.rows]}


LADDER_EXPECT = {
    "healthy": lambda o: o["level"] == 0 and o["fins"] == [(1, "length", 8)],
    "rung1": lambda o: o["level"] == 1 and o["fins"] == [
        (1, "shed_slo", 0), (2, "length", 8)],
    "rung2": lambda o: o["level"] == 2 and o["fins"] == [
        (1, "length", 4), (2, "shed_slo", 0)] and not any(o["spec_on"]),
    "capacity": lambda o: o["fins"] == [(1, "shed_capacity", 0)],
    "least_loaded": lambda o: o["received"] == [[], [(1, 8)]],
    "prefix_affinity": lambda o: o["received"] == [[], [(1, 8)]],
    "drain_redistributes": lambda o: o["redistributed"] == 2 and
    o["received"][0] == [(1, 8), (2, 8)] and o["fins"] == [
        (1, "length", 8), (2, "length", 8)],
}


@pytest.mark.parametrize("case", sorted(LADDER_EXPECT))
def test_shed_ladder_and_routing_on_fake_engines_like_jax(case):
    port, ref = _ladder_case(case, "port"), _ladder_case(case, "jax")
    assert port == ref
    assert LADDER_EXPECT[case](port), port


# ------------------------------------------------------------- swaps
def _port_tags(root):
    """Two committed tags written by the port: (tag 1 params, tag 2
    params)."""
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, init_gpt2_params
    from deepspeed_tpu_torch.runtime import checkpoint as ckptlib
    cfg = GPT2Config(**MCFG)
    out = []
    for step, seed in ((1, 3), (2, 7)):
        p = init_gpt2_params(cfg, torch.Generator().manual_seed(seed))
        d = os.path.join(root, f"global_step{step}")
        os.makedirs(d, exist_ok=True)
        ckptlib.save_tree_sharded(d, "model_states", p)
        with open(os.path.join(d, "meta.json"), "w") as f:
            json.dump({"global_step": step}, f)
        ckptlib.write_commit_marker(d)
        ckptlib.write_latest(root, f"global_step{step}")
        out.append(p)
    return cfg, out


def _reqs(Request, base):
    return [Request(prompt=p, max_new_tokens=NEW_TOKENS, temperature=0.0,
                    seed=i, uid=base + i) for i, p in enumerate(FIRST)]


def test_swap_onto_int8_resident_replicas(tmp_path):
    from deepspeed_tpu_torch.inference import (FleetRouter, InferenceEngine,
                                               Request)
    from deepspeed_tpu_torch.runtime.quantized_params import \
        is_quantized_tree
    cfg, (p1, p2) = _port_tags(str(tmp_path))
    qinf = dict(INF, quantize_weights="int8", paged_kv={"kv_dtype": "int8"})

    def make(params):
        eng = InferenceEngine(cfg, params, dict(qinf), dtype=torch.float32,
                              device="cpu")
        eng.warmup()
        return eng

    def single(params, base):
        eng = make(params)
        for r in _reqs(Request, base):
            eng.submit(r)
        return {f.uid - base: f.tokens for f in eng.run()}

    ref1, ref2 = single(p1, 300), single(p2, 400)
    assert ref1 != ref2
    engines = [make(p1) for _ in range(2)]
    router = FleetRouter(engines, {"replicas": 2})
    for r in _reqs(Request, 500):
        router.submit(r)
    fins = router.step()
    assert router.swap_weights(str(tmp_path), tag="global_step1") == \
        {0: "global_step1", 1: "global_step1"}
    fins += router.run()
    assert {f.uid - 500: f.tokens for f in fins} == ref1
    for r in _reqs(Request, 600):
        router.submit(r)
    assert router.swap_weights(str(tmp_path)) == \
        {0: "global_step2", 1: "global_step2"}
    fins = router.run()
    assert {f.uid - 600: f.tokens for f in fins} == ref2
    assert {f.weight_version for f in fins} == {"global_step2"}
    for eng in engines:
        assert is_quantized_tree(eng.params)
        assert eng.steady_state_recompiles == 0
    router.close()


def test_mid_swap_fault_rolls_back(tmp_path):
    from deepspeed_tpu_torch.inference import (FleetRouter, InferenceEngine,
                                               Request)
    from deepspeed_tpu_torch.runtime import fault
    cfg, (p1, _) = _port_tags(str(tmp_path))
    engines = []
    for _ in range(2):
        eng = InferenceEngine(cfg, p1, dict(INF), dtype=torch.float32,
                              device="cpu")
        eng.warmup()
        engines.append(eng)
    before = {k: v.clone() for k, v in engines[0].params["h_0"][
        "attn"].items()}
    ev = _Events()
    router = FleetRouter(engines, {"replicas": 2}, writer=ev)
    fault.arm("serve.swap_load", exc=OSError("injected"), times=1)
    try:
        res = router.swap_weights(str(tmp_path), tag="global_step2")
    finally:
        fault.reset()
    assert res == {0: None, 1: "global_step2"}
    assert engines[0].weight_version == "initial"
    assert all(torch.equal(v, engines[0].params["h_0"]["attn"][k])
               for k, v in before.items())
    push = [r for r in ev.rows if r["event"] == "fleet_swap_push"]
    assert push[0]["rolled_back"] == [0]
    for r in _reqs(Request, 700):
        router.submit(r)
    fins = router.run()
    assert len(fins) == len(FIRST)
    assert {r.status for r in router.replicas} == {"live"}
    assert {f.weight_version for f in fins} <= {"initial", "global_step2"}
    router.close()


# ------------------------------------------------- config and registry
@pytest.mark.parametrize("fleet", [
    {}, {"replicas": 3, "routing": "prefix_affinity",
         "slo_shed": {"enabled": True, "ttft_budget_ms": 50},
         "process_mode": {"enabled": True, "max_restarts": 1},
         "autoscale": {"enabled": True, "max_replicas": 4}},
    {"replicas": 0}, {"routing": "round_robin"},
    {"slo_shed": {"degrade_factor": 0.5}},
    {"process_mode": {"rpc_timeout_s": 0}},
    {"autoscale": {"min_replicas": 3, "max_replicas": 2}},
])
def test_fleet_config_like_jax(fleet):
    import copy

    from deepspeed_tpu.inference.fleet import \
        _normalize_fleet_config as jnorm

    from deepspeed_tpu_torch.inference.fleet import _normalize_fleet_config
    try:
        ref = jnorm(copy.deepcopy(fleet))
    except Exception as e:            # the JAX error the port must repeat
        with pytest.raises(Exception) as err:
            _normalize_fleet_config(copy.deepcopy(fleet))
        assert str(err.value) == str(e)
        return
    assert _normalize_fleet_config(copy.deepcopy(fleet)) == ref


def test_fleet_tags_and_shed_vocabulary_like_jax():
    from deepspeed_tpu.inference.tracing import SHED_REASONS as JSHED
    from deepspeed_tpu.utils import monitor as jm

    from deepspeed_tpu_torch.inference.tracing import SHED_REASONS
    from deepspeed_tpu_torch.utils import monitor as m
    for tag in ("TAG_SERVE_SHED_RATE", "TAG_SERVE_FLEET_QDEPTH",
                "TAG_SERVE_WEIGHT_VERSION", "TAG_SERVE_MIGRATIONS",
                "TAG_SERVE_REPLICA_RESTARTS", "TAG_HEALTH_ALERTS"):
        assert getattr(m, tag) == getattr(jm, tag)
    assert SHED_REASONS == JSHED


def test_router_writes_the_fleet_scalars(tmp_path):
    """The router's telemetry write lands the four fleet scalars in the
    engine's events.jsonl under JAX's tags."""
    from deepspeed_tpu_torch.inference import FleetRouter, InferenceEngine
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, init_gpt2_params
    from deepspeed_tpu_torch.utils.monitor import TensorBoardMonitor
    cfg = GPT2Config(**MCFG)
    params = init_gpt2_params(cfg, torch.Generator().manual_seed(3))
    mon = TensorBoardMonitor(enabled=True, output_path=str(tmp_path / "tb"))
    eng = InferenceEngine(cfg, params, dict(INF, events_dir=str(tmp_path)),
                          dtype=torch.float32, device="cpu", monitor=mon)
    eng.warmup()
    router = FleetRouter([eng], {"replicas": 1})
    router.run()
    router.close()
    rows = [json.loads(line) for line in
            open(tmp_path / "events.jsonl") if line.strip()]
    tags = {r.get("tag") for r in rows}
    assert {"Serve/shed_rate", "Serve/fleet_queue_depth",
            "Serve/migrations", "Serve/replica_restarts"} <= tags


def test_engine_owns_its_params(tmp_path):
    """``swap_params`` copies into the engine's own tensors: the caller's
    tree and a sibling engine built from the same tree keep their
    values (JAX's swap rebinds immutable arrays, so neither can change
    there either)."""
    from deepspeed_tpu_torch.inference import InferenceEngine
    from deepspeed_tpu_torch.utils.tree import tree_leaves
    cfg, (p1, p2) = _port_tags(str(tmp_path))
    before = [t.clone() for t in tree_leaves(p1)]
    a, b = (InferenceEngine(cfg, p1, dict(INF), dtype=torch.float32,
                            device="cpu") for _ in range(2))
    a.swap_params(str(tmp_path), tag="global_step2")
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(p1), before))
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(b.params),
                                                 before))
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a.params),
                                                 tree_leaves(p2)))
