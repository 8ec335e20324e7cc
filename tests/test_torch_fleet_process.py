"""The port's process-boundary fleet (``deepspeed_tpu_torch/inference/
{rpc,replica_worker,fleet}.py``) on the CPU.

- The frames, the array codec (bf16 included) and the request and
  migration wires are byte-equal to the JAX package's, both ways, over
  a ``socket.socketpair``; the port needs no ``ml_dtypes`` for bf16.
- ``RpcClient``: a transient transport fault is retried with exponential
  backoff, a timeout or a dead peer never; a remote error keeps the
  channel; ``ServerExit`` replies, then stops the server.
- The router's restart policy over fake processes: 85 and 87 relaunch,
  1, 143 and None give up, the restart budget runs out, deathbed exports
  resume on a survivor, a flight file is salvaged (a torn one is not),
  a double drain is one episode, autoscale keeps its hysteresis.
- One module-scoped run of three port children on the CPU, loading a
  JAX-written tag through ``checkpoint_dir``: child 0, kill-armed, exits
  85 mid-decode, its deathbed exports resume on a survivor and it
  relaunches under a new pid; then child 1 is drained twice and its
  in-flight requests migrate. Every uid answers once; greedy tokens
  equal the JAX single engine's and sampled ones the port's single
  engine's; the flight file is salvaged; ``tools/obs_report.py --fleet``
  merges the router's and the replicas' logs into one Chrome trace.
- A spec without ``"device": "cpu"`` raises on a host without a card.
"""

import importlib.util
import json
import os
import socket
import threading

import numpy as np
import pytest
import torch

import tests.torch_threads  # noqa: F401  (torch threads per xdist worker)
from deepspeed_tpu_torch.inference import disagg, rpc
from deepspeed_tpu_torch.inference.rpc import (ReplicaDeadError, RpcClient,
                                               RpcRemoteError, RpcServer,
                                               RpcTimeoutError,
                                               RpcTransportError, ServerExit)
from deepspeed_tpu_torch.runtime import fault

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MCFG = {"vocab_size": 61, "max_position_embeddings": 64,
        "hidden_size": 32, "num_layers": 2, "num_heads": 4,
        "embd_dropout": 0.0, "attn_dropout": 0.0, "resid_dropout": 0.0}
ICFG = {"max_batch_size": 2, "prompt_buckets": [8, 16],
        "batch_buckets": [1, 2], "max_seq_len": 48}


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _raw(send, *args):
    """The bytes one ``send_frame`` call puts on the wire."""
    a, b = socket.socketpair()
    try:
        send(a, *args)
        a.shutdown(socket.SHUT_WR)
        out = b""
        while True:
            chunk = b.recv(1 << 16)
            if not chunk:
                return out
            out += chunk
    finally:
        a.close()
        b.close()


def _pair(tensors):
    """The same arrays as port tensors and as JAX numpy arrays (bf16 as
    an ml_dtypes array)."""
    import ml_dtypes
    out = []
    for t in tensors:
        if t.dtype == torch.bfloat16:
            n = t.float().numpy().astype(ml_dtypes.bfloat16)
        else:
            n = t.numpy()
        out.append(n)
    return out


def _slabs(dtype, pages=2, int8=False):
    g = torch.Generator().manual_seed(pages)
    shape = (2, pages, 2, 4, 4)
    if int8:
        k = torch.randint(-127, 128, shape, generator=g, dtype=torch.int8)
        s = torch.rand((2, pages, 2, 4, 1), generator=g)
        return k, k.flip(0), s, s + 1.0
    k = torch.randn(shape, generator=g).to(dtype)
    return k, -k, None, None


def _record(mod, slabs, uid=7, pages=2):
    k, v, ks, vs = slabs
    return mod.MigrationRecord(
        uid=uid, prompt=[1, 2, 3], max_new_tokens=8, temperature=0.5,
        seed=11, eos_id=None, priority=1, position=5, pending_tok=42,
        tokens=[42, 17], live_pages=pages, page_bytes=64, ttft_ms=1.5,
        queue_wait_ms=0.25, elapsed_ms=3.0, trace_id="f1-000001", hop=1,
        kslab=k, vslab=v, kscale_slab=ks, vscale_slab=vs)


# ------------------------------------------------------------ the wire
FRAMES = [({"method": "step", "params": {}}, b""),
          ({"ok": True, "result": {"state": {"pid": 3, "uids": [1, 2]},
                                   "x": 1.5, "s": "naïve"}}, b"\x00\x01slab"),
          ({"ok": False, "error": {"kind": "remote", "message": "boom"}},
           b"")]


@pytest.mark.parametrize("frame", range(len(FRAMES)))
def test_frames_byte_equal_to_jax_both_ways(frame):
    from deepspeed_tpu.inference import rpc as jrpc
    header, payload = FRAMES[frame]
    ours = _raw(rpc.send_frame, header, payload)
    assert ours == _raw(jrpc.send_frame, header, payload)
    for send, recv in ((rpc.send_frame, jrpc.recv_frame),
                       (jrpc.send_frame, rpc.recv_frame)):
        a, b = socket.socketpair()
        try:
            send(a, header, payload)
            assert recv(b) == (header, payload)
        finally:
            a.close()
            b.close()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8, torch.int32])
def test_array_codec_byte_equal_to_jax_both_ways(dtype):
    from deepspeed_tpu.inference import rpc as jrpc
    g = torch.Generator().manual_seed(0)
    tensors = [(torch.randn((3, 5), generator=g) * 50).to(dtype),
               torch.arange(4).to(dtype).reshape(2, 2)]
    metas, blob = rpc.encode_arrays(tensors)
    jmetas, jblob = jrpc.encode_arrays(_pair(tensors))
    assert (metas, blob) == (jmetas, jblob)
    for got, want in zip(rpc.decode_arrays(jmetas, jblob), tensors):
        assert got.dtype == want.dtype and torch.equal(got, want)
    for got, want in zip(jrpc.decode_arrays(metas, blob), _pair(tensors)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_migration_wire_byte_equal_to_jax_both_ways(kind):
    from deepspeed_tpu.inference import disagg as jdisagg
    from deepspeed_tpu.inference import rpc as jrpc
    slabs = _slabs(getattr(torch, kind) if kind != "int8" else None,
                   int8=kind == "int8")
    rec = _record(disagg, slabs)
    jslabs = [None if s is None else _pair([s])[0] for s in slabs]
    jrec = _record(jdisagg, jslabs)
    head, payload = rpc.migration_to_wire(rec)
    assert (head, payload) == jrpc.migration_to_wire(jrec)
    back = rpc.migration_from_wire(*jrpc.migration_to_wire(jrec))
    for got, want in zip((back.kslab, back.vslab, back.kscale_slab,
                          back.vscale_slab), slabs):
        assert (got is None) == (want is None)
        if want is not None:
            assert got.dtype == want.dtype and torch.equal(got, want)
    assert back.to_header() == rec.to_header()
    assert back.nbytes == rec.nbytes == jrec.nbytes
    jback = jrpc.migration_from_wire(head, payload)
    assert jback.to_header() == jrec.to_header()
    np.testing.assert_array_equal(jback.kslab, jslabs[0])


def test_request_wire_and_deathbed_concatenation_like_jax():
    from deepspeed_tpu.inference import Request as JRequest
    from deepspeed_tpu.inference import rpc as jrpc
    from deepspeed_tpu_torch.inference import Request
    req = Request(prompt=[5, 6, 7], max_new_tokens=9, temperature=0.3,
                  seed=123, priority=2, uid=77, trace_id="f2-00000a", hop=2)
    jreq = JRequest(prompt=[5, 6, 7], max_new_tokens=9, temperature=0.3,
                    seed=123, priority=2, uid=77, trace_id="f2-00000a",
                    hop=2)
    assert rpc.request_to_wire(req) == jrpc.request_to_wire(jreq)
    back = rpc.request_from_wire(jrpc.request_to_wire(jreq))
    assert (back.uid, back.seed, back.priority, back.hop) == (77, 123, 2, 2)
    r1 = _record(disagg, _slabs(torch.bfloat16, pages=1), uid=1, pages=1)
    r2 = _record(disagg, _slabs(torch.bfloat16, pages=3), uid=2, pages=3)
    (h1, p1), (h2, p2) = rpc.migration_to_wire(r1), \
        rpc.migration_to_wire(r2)
    out = rpc.decode_migrations([h1, h2], p1 + p2)
    assert [r.uid for r in out] == [1, 2]
    assert torch.equal(out[1].vslab, r2.vslab)
    jout = jrpc.decode_migrations([h1, h2], p1 + p2)
    assert [r.live_pages for r in jout] == [1, 3]


def test_frame_errors_are_the_taxonomy():
    a, b = socket.socketpair()
    a.close()
    with pytest.raises(ReplicaDeadError):
        rpc.recv_frame(b)
    b.close()
    a, b = socket.socketpair()
    try:
        a.sendall(b"\xff" * 8)          # an absurd length prefix
        with pytest.raises(RpcTransportError):
            rpc.recv_frame(b)
    finally:
        a.close()
        b.close()


# ----------------------------------------------------------- the client
def _serve_in_thread(dispatch):
    a, b = socket.socketpair()
    t = threading.Thread(target=lambda: RpcServer(b).serve(dispatch),
                         daemon=True)
    t.start()
    return a, b, t


def test_client_roundtrip_remote_error_and_server_exit():
    def dispatch(method, params, payload):
        if method == "bad":
            raise ValueError("handler exploded")
        if method == "shutdown":
            raise ServerExit(result={"bye": True}, payload=b"last")
        return {"echo": method, "n": params.get("n", 0) + 1}, payload * 2
    a, b, t = _serve_in_thread(dispatch)
    try:
        c = RpcClient(a, timeout_s=10.0)
        assert c.call("ping", {"n": 1}, b"xy") == (
            {"echo": "ping", "n": 2}, b"xyxy")
        with pytest.raises(RpcRemoteError) as err:
            c.call("bad")
        assert err.value.kind == "remote"
        assert c.call("good")[0] == {"echo": "good", "n": 1}
        assert c.call("shutdown") == ({"bye": True}, b"last")
        t.join(timeout=5.0)
        assert not t.is_alive()
    finally:
        a.close()
        b.close()


def test_transport_fault_retried_with_exponential_backoff():
    a, b, _ = _serve_in_thread(lambda m, p, x: ({"served": True}, b""))
    sleeps = []
    try:
        fault.arm("rpc.transport", exc=OSError("injected flake"), times=2)
        c = RpcClient(a, timeout_s=10.0, retries=2, backoff_s=0.05,
                      sleep=sleeps.append)
        assert c.call("step")[0] == {"served": True}
        assert c.retried == 2 and sleeps == [0.05, 0.1]
        fault.reset()
        fault.arm("rpc.transport", exc=OSError("flake"), times=99)
        c = RpcClient(a, timeout_s=10.0, retries=1, backoff_s=0.0,
                      sleep=lambda s: None)
        with pytest.raises(RpcTransportError):
            c.call("step")
        assert c.retried == 1
    finally:
        fault.reset()
        a.close()
        b.close()


@pytest.mark.parametrize("point,err", [("rpc.timeout", RpcTimeoutError),
                                       ("rpc.replica_dead",
                                        ReplicaDeadError)])
def test_timeout_and_death_are_never_retried(point, err):
    a, b = socket.socketpair()
    sleeps = []
    try:
        fault.arm(point, exc=fault.InjectedCrash(point), times=9)
        c = RpcClient(a, timeout_s=10.0, retries=5, backoff_s=0.1,
                      sleep=sleeps.append)
        with pytest.raises(err) as e:
            c.call("step")
        assert e.value.kind == point.split(".", 1)[1]
        assert e.value.method == "step"
        assert sleeps == [] and c.retried == 0
        assert fault.get_injector().fired(point) == 1
    finally:
        fault.reset()
        a.close()
        b.close()


def test_real_deadline_is_timeout_error():
    a, b = socket.socketpair()           # nobody replies
    try:
        c = RpcClient(a, timeout_s=0.05, retries=3, sleep=lambda s: None)
        with pytest.raises(RpcTimeoutError):
            c.call("step")
        assert c.retried == 0
    finally:
        a.close()
        b.close()


# ---------------------------------------------- the restart policy
class _Events:
    def __init__(self):
        self.rows = []

    def add_event(self, kind, **fields):
        self.rows.append({"event": kind, **fields})

    def of(self, kind):
        return [r for r in self.rows if r["event"] == kind]


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


class _FakeProc:
    """The ReplicaProcess surface the router supervises: dies on command
    with a deathbed ReplicaDeadError, then answers poll_exit, orphans
    and relaunch."""

    def __init__(self, exit_code=85, relaunch_ok=True, can_migrate=False):
        self.scheduler = _FakeSched()
        self.exit_code = exit_code
        self.relaunch_ok = relaunch_ok
        self.can_migrate = can_migrate
        self.die_next_step = False
        self.deathbed_exports = []
        self.relaunches = 0
        self.imported = []
        self.flight_path = None
        self.pid = 4242
        self.monitor = None
        self._log = None
        self.steady_state_recompiles = 0
        self.weight_version = "initial"
        self.weight_ordinal = 0

    def submit(self, req):
        self.scheduler.queue.append(req)
        return req.uid

    def step(self):
        from deepspeed_tpu_torch.inference import FinishedRequest
        if self.die_next_step:
            self.die_next_step = False
            gone = {r.uid for r in self.deathbed_exports}
            self.scheduler.queue = [r for r in self.scheduler.queue
                                    if r.uid not in gone]
            raise ReplicaDeadError("fake child died",
                                   exports=list(self.deathbed_exports),
                                   reason="kill")
        fins = [FinishedRequest(uid=r.uid, prompt=list(r.prompt),
                                tokens=[1] * r.max_new_tokens,
                                finish_reason="length", ttft_ms=1.0,
                                latency_ms=1.0)
                for r in self.scheduler.queue]
        self.scheduler.queue = []
        return fins

    def cancel(self, uid, reason="evicted"):
        from deepspeed_tpu_torch.inference import FinishedRequest
        for i, r in enumerate(self.scheduler.queue):
            if r.uid == uid:
                del self.scheduler.queue[i]
                return FinishedRequest(uid=uid, prompt=list(r.prompt),
                                       tokens=[], finish_reason=reason,
                                       ttft_ms=None, latency_ms=0.0)
        return None

    def set_speculation(self, on):
        return False

    def poll_exit(self, timeout_s=10.0):
        return self.exit_code

    def orphans(self):
        return list(self.scheduler.queue)

    def relaunch(self):
        if not self.relaunch_ok:
            raise OSError("spawn failed")
        self.relaunches += 1
        self.scheduler = _FakeSched()

    def import_request(self, rec):
        if not self.can_migrate:
            return None
        from deepspeed_tpu_torch.inference import Request
        self.imported.append(rec)
        self.scheduler.queue.append(Request(
            prompt=list(rec.prompt), max_new_tokens=rec.max_new_tokens,
            temperature=rec.temperature, seed=rec.seed, eos_id=rec.eos_id,
            priority=rec.priority, uid=rec.uid))
        return len(self.imported) - 1


def _req(uid, max_new=4):
    from deepspeed_tpu_torch.inference import Request
    return Request(prompt=[1, 2, 3], max_new_tokens=max_new,
                   temperature=0.0, seed=0, uid=uid)


def _router(engines, fleet_config=None, **kw):
    from deepspeed_tpu_torch.inference import FleetRouter
    ev = _Events()
    return FleetRouter(engines, fleet_config or {}, writer=ev, **kw), ev


@pytest.mark.parametrize("code,decision", [(85, "restarted"),
                                           (87, "restarted"),
                                           (1, "give_up"), (143, "give_up"),
                                           (None, "give_up")])
def test_death_goes_through_the_restart_policy(code, decision):
    dying, survivor = _FakeProc(exit_code=code), _FakeProc()
    router, ev = _router([dying, survivor],
                         {"process_mode": {"max_restarts": 1,
                                           "restart_backoff_s": 0.5}},
                         sleep=lambda s: None)
    uids = [router.submit(_req(u)) for u in range(4)]
    dying.die_next_step = True
    fins = router.run()
    assert sorted(f.uid for f in fins) == sorted(uids)    # none dropped
    r0 = router.replicas[0]
    assert r0.last_exit_code == code
    assert ev.of("fleet_replica_death")[0]["exit_code"] == code
    restart = ev.of("fleet_replica_restart")[0]
    assert restart["decision"] == decision
    if decision == "restarted":
        assert r0.status == "live" and dying.relaunches == 1
        assert restart["backoff_s"] == pytest.approx(0.5)
        more = [router.submit(_req(u)) for u in (10, 11)]
        assert sorted(f.uid for f in router.run()) == more
    else:
        assert r0.status == "retired" and dying.relaunches == 0


def test_restart_budget_exhausts():
    dying = _FakeProc(exit_code=85)
    router, ev = _router([dying, _FakeProc()],
                         {"process_mode": {"max_restarts": 0}})
    router.submit(_req(0))
    dying.die_next_step = True
    router.run()
    assert router.replicas[0].status == "retired"
    assert ev.of("fleet_replica_restart")[0]["decision"] == "exhausted"


def test_deathbed_exports_resume_on_survivor():
    rec = _record(disagg, _slabs(torch.float32), uid=5)
    dying = _FakeProc(exit_code=85, relaunch_ok=False)
    dying.deathbed_exports = [rec]
    survivor = _FakeProc(can_migrate=True)
    router, ev = _router([dying, survivor],
                         {"process_mode": {"max_restarts": 1,
                                           "restart_backoff_s": 0.0}})
    router.submit(_req(5))
    dying.die_next_step = True
    fins = router.run()
    assert [r.uid for r in survivor.imported] == [5]
    assert router.total_migrated == 1
    assert router.migration_bytes == rec.nbytes
    assert [f.uid for f in fins] == [5]
    mig = ev.of("serve_migration")
    assert mig[0]["uid"] == 5 and mig[0]["dst"] == 1
    assert mig[0]["priced_ms"] > 0
    assert (router.replicas[0].migrations_out,
            router.replicas[1].migrations_in) == (1, 1)
    assert router.replicas[0].status == "retired"
    assert ev.of("fleet_replica_restart")[0]["decision"] == "failed"


@pytest.mark.parametrize("torn", [False, True])
def test_flight_recorder_salvaged(tmp_path, torn):
    flight = tmp_path / "flight_serve.json"
    flight.write_text('{"trigger": "repl' if torn else json.dumps(
        {"trigger": "replica_death", "pid": 999, "reason": "kill",
         "rows": [{"event": "heartbeat"}] * 3}))
    dying = _FakeProc(exit_code=1)
    dying.flight_path = str(flight)
    router, ev = _router([dying, _FakeProc()])
    router.submit(_req(0))
    dying.die_next_step = True
    router.run()
    sal = ev.of("fleet_flight_salvage")
    if torn:
        assert router.total_salvaged == 0 and not sal
    else:
        assert router.total_salvaged == 1
        assert (sal[0]["replica"], sal[0]["trigger"], sal[0]["dead_pid"],
                sal[0]["rows"]) == (0, "replica_death", 999, 3)


def test_double_drain_is_one_episode():
    router, ev = _router([_FakeProc(), _FakeProc()])
    uids = [router.submit(_req(u)) for u in range(4)]
    router.drain(0, reason="manual")
    router.drain(0, reason="manual")
    fins = router.run()
    assert sorted(f.uid for f in fins) == sorted(uids)
    assert len(fins) == len(uids)
    assert len([r for r in ev.of("fleet_drain")
                if r["phase"] == "begin"]) == 1
    assert router.replicas[0].status == "retired"


ASC = {"enabled": True, "min_replicas": 1, "max_replicas": 3,
       "scale_up_patience": 2, "scale_down_patience": 3,
       "cooldown_steps": 0}


def test_autoscale_up_with_patience_and_down_never_below_min():
    spawned = []

    def factory(idx):
        spawned.append(idx)
        return _FakeProc()
    router, ev = _router([_FakeProc()], {"autoscale": dict(ASC)},
                         replica_factory=factory)
    router.shed_level = lambda: 1
    router.step()
    assert spawned == []
    router.step()
    assert spawned == [1] and len(router.replicas) == 2
    router.shed_level = lambda: 0
    for _ in range(20):
        router.step()
    assert len([r for r in router.replicas if r.status == "live"]) == 1
    assert [r["action"] for r in ev.of("fleet_autoscale")] == ["up", "down"]


def test_autoscale_cooldown_spaces_actions():
    asc = dict(ASC, cooldown_steps=5, scale_up_patience=1, max_replicas=4)
    router, ev = _router([_FakeProc()], {"autoscale": asc},
                         replica_factory=lambda i: _FakeProc())
    router.shed_level = lambda: 1
    for _ in range(6):
        router.step()
    assert len(ev.of("fleet_autoscale")) == 1


def test_a_cuda_child_without_a_card_raises(monkeypatch):
    from deepspeed_tpu_torch.inference import replica_worker
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = {"family": "gpt2", "model_config": MCFG, "init_seed": 3,
            "dtype": "float32", "inference": ICFG}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        replica_worker._build_engine(spec)


# ------------------------------------------------ children on the CPU
def _mixed_requests(Request, uids):
    """Half greedy, half sampled at 0.7 with per-request seeds; i % 4 in
    (1, 2) sampled, so each replica of a least-loaded pair holds both
    kinds and the migrated ones include sampled requests."""
    return [Request(prompt=[1 + u, 2, 3, 4, (5 + u) % 61], max_new_tokens=8,
                    temperature=0.7 if i % 4 in (1, 2) else 0.0,
                    seed=100 + u, uid=u) for i, u in enumerate(uids)]


def _single(engine, Request, groups):
    engine.warmup()
    out = {}
    for uids in groups:
        for r in _mixed_requests(Request, uids):
            engine.submit(r)
        out.update({f.uid: tuple(f.tokens) for f in engine.run()})
    engine.close()
    return out


@pytest.fixture(scope="module")
def proc_fleet_run(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from deepspeed_tpu.inference import InferenceEngine as JEngine
    from deepspeed_tpu.inference import Request as JRequest
    from deepspeed_tpu.models.gpt2 import GPT2Config as JConfig
    from deepspeed_tpu.models.gpt2 import init_gpt2_params
    from deepspeed_tpu.runtime import checkpoint as jckpt

    from deepspeed_tpu_torch.inference import InferenceEngine, Request
    from deepspeed_tpu_torch.inference.fleet import (FleetRouter,
                                                     launch_replica_processes)
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config
    from deepspeed_tpu_torch.utils.health import HealthPlane
    from deepspeed_tpu_torch.utils.monitor import _JsonlWriter

    groups = (range(4), range(10, 14))
    jcfg = JConfig(**MCFG)
    params = init_gpt2_params(jcfg, jax.random.PRNGKey(3))
    ckdir = str(tmp_path_factory.mktemp("jax_tag"))
    tag = os.path.join(ckdir, "global_step1")
    os.makedirs(tag)
    jckpt.save_tree_sharded(tag, "model_states", params)
    with open(os.path.join(tag, "meta.json"), "w") as f:
        json.dump({"global_step": 1}, f)
    jckpt.write_commit_marker(tag)
    jckpt.write_latest(ckdir, "global_step1")
    jax_base = _single(JEngine(jcfg, params, dict(ICFG), dtype=jnp.float32),
                       JRequest, groups)
    port_base = _single(InferenceEngine.from_checkpoint(
        ckdir, GPT2Config(**MCFG), tag="global_step1",
        inference_config=dict(ICFG), dtype=torch.float32, device="cpu"),
        Request, groups)

    fdir = str(tmp_path_factory.mktemp("flights"))
    evdir = str(tmp_path_factory.mktemp("router_events"))
    rbase = str(tmp_path_factory.mktemp("replica_events"))
    hdir = str(tmp_path_factory.mktemp("router_health"))
    env = {"OMP_NUM_THREADS": "1"}
    spec = {"family": "gpt2", "model_config": MCFG, "checkpoint_dir": ckdir,
            "tag": "global_step1", "dtype": "float32", "device": "cpu",
            "inference": ICFG}

    def obs(i):
        return {"observability": {
            "enabled": True, "serve": {"enabled": True},
            "health": {"enabled": True, "flight_path":
                       os.path.join(fdir, f"flight_r{i}.json")}},
            "inference": dict(ICFG, events_dir=os.path.join(rbase, f"r{i}"))}
    reps = launch_replica_processes(
        spec, 3, env_by_replica={0: dict(env, DSTPU_FAULT_ARM=
                                         "serve.replica_kill:crash:1"),
                                 1: env, 2: env},
        spec_by_replica={i: obs(i) for i in range(3)})
    writer = _JsonlWriter(evdir)
    hp = HealthPlane({"enabled": True, "stall_timeout_s": 300.0},
                     events_dir=hdir)
    router = FleetRouter(
        reps, {"process_mode": {"enabled": True, "max_restarts": 1,
                                "restart_backoff_s": 0.0}},
        writer=writer, health=hp)
    out = {"evdir": evdir, "fdir": fdir, "jax_base": jax_base,
           "port_base": port_base,
           "rdirs": [os.path.join(rbase, f"r{i}") for i in range(3)]}
    try:
        out["pid0_before"] = reps[0].pid
        # the kill fires once: the relaunched child comes up unarmed
        reps[0]._env.pop("DSTPU_FAULT_ARM", None)
        out["uids_a"] = [router.submit(r)
                         for r in _mixed_requests(Request, groups[0])]
        out["fins_a"] = [(f.uid, tuple(f.tokens), f.finish_reason)
                         for f in router.run()]
        out["migrated_a"] = router.total_migrated
        out["r0"] = (router.replicas[0].status,
                     router.replicas[0].last_exit_code,
                     router.replicas[0].restarts)
        out["pid0_after"] = reps[0].pid
        out["uids_b"] = [router.submit(r)
                         for r in _mixed_requests(Request, groups[1])]
        fins_b = list(router.step())
        router.drain(1, reason="manual")
        router.drain(1, reason="manual")          # a no-op
        fins_b += router.run()
        out["fins_b"] = [(f.uid, tuple(f.tokens), f.finish_reason)
                         for f in fins_b]
        out["migrated_b"] = router.total_migrated
        out["migration_bytes"] = router.migration_bytes
        out["recompiles"] = [r.steady_state_recompiles for r in reps]
        out["statuses"] = [r.status for r in router.replicas]
        out["restarts"] = router.total_restarts
        out["salvaged"] = router.total_salvaged
        out["debug"] = router.debug_state()
    finally:
        router.close()
        writer.close()
        hp.close()
    out["exit_codes"] = [r._proc.returncode for r in reps]
    out["events"] = [json.loads(line) for line in
                     open(os.path.join(evdir, "events.jsonl"))
                     if line.strip()]
    return out


def _check_tokens(run, fins, uids):
    got = {u: t for u, t, _ in fins}
    assert sorted(got) == sorted(uids) and len(fins) == len(uids)
    for i, u in enumerate(uids):
        want = run["port_base"] if i % 4 in (1, 2) else run["jax_base"]
        assert got[u] == want[u], (u, got[u], want[u])


def test_killed_child_exits_85_and_relaunches(proc_fleet_run):
    status, code, restarts = proc_fleet_run["r0"]
    assert (status, code, restarts) == ("live", 85, 1)
    assert proc_fleet_run["restarts"] == 1
    assert proc_fleet_run["pid0_after"] != proc_fleet_run["pid0_before"]
    # every child left through the shutdown call, the relaunched one too
    assert proc_fleet_run["exit_codes"] == [0, 0, 0]


def test_kill_mid_decode_resumes_exports_on_survivor(proc_fleet_run):
    assert proc_fleet_run["migrated_a"] >= 1
    _check_tokens(proc_fleet_run, proc_fleet_run["fins_a"],
                  proc_fleet_run["uids_a"])
    deaths = [r for r in proc_fleet_run["events"]
              if r.get("event") == "fleet_replica_death"]
    assert deaths[0]["replica"] == 0 and deaths[0]["exports"] >= 1


def test_double_drain_migrates_in_flight(proc_fleet_run):
    assert proc_fleet_run["migrated_b"] > proc_fleet_run["migrated_a"]
    _check_tokens(proc_fleet_run, proc_fleet_run["fins_b"],
                  proc_fleet_run["uids_b"])
    assert proc_fleet_run["statuses"][1] == "retired"
    begins = [r for r in proc_fleet_run["events"]
              if r.get("event") == "fleet_drain"
              and r.get("phase") == "begin" and r.get("replica") == 1]
    assert len(begins) == 1
    assert proc_fleet_run["recompiles"] == [0, 0, 0]


def test_flight_file_salvaged_into_router_trail(proc_fleet_run):
    assert proc_fleet_run["salvaged"] == 1
    sal = [r for r in proc_fleet_run["events"]
           if r.get("event") == "fleet_flight_salvage"]
    assert sal[0]["replica"] == 0 and sal[0]["trigger"] == "replica_death"
    with open(os.path.join(proc_fleet_run["fdir"], "flight_r0.json")) as f:
        flight = json.load(f)
    assert flight["trigger"] == "replica_death"
    assert flight["reason"].startswith("InjectedCrash")
    assert flight["exports"] >= 1


def test_obs_report_reads_the_process_fleet(proc_fleet_run):
    obs_report = _load_tool("obs_report")
    s = obs_report.summarize(proc_fleet_run["evdir"])
    proc = s["serving"]["fleet"]["process"]
    assert proc["migrations"]["count"] == proc_fleet_run["migrated_b"]
    assert proc["migrations"]["bytes"] == proc_fleet_run["migration_bytes"]
    assert (proc["restarts"], proc["deaths"], proc["salvaged_flights"]) \
        == (1, 1, 1)
    dbg = proc_fleet_run["debug"]
    assert dbg["migrations"]["total"] == proc_fleet_run["migrated_b"]
    assert {r["replica"] for r in proc_fleet_run["events"]
            if r.get("event") == "clock_sync"} == {0, 1, 2}


def test_obs_report_fleet_merges_one_chrome_trace(proc_fleet_run, tmp_path):
    obs_report = _load_tool("obs_report")
    s = obs_report.summarize_fleet(
        [proc_fleet_run["evdir"]] + proc_fleet_run["rdirs"])
    assert set(s["clock_offsets"]) == {"0", "1", "2"}
    assert s["missing_replica_logs"] == []
    migrated = [r for r in s["requests"] if r["migrations"]
                and any("migrate_out" in h for h in r["hops"])]
    assert migrated
    hops = migrated[0]["hops"]
    assert "migrate_out" in hops[0] and "migrate_in" in hops[-1]
    assert "finish" in hops[-1]
    assert hops[-1]["replica"] != hops[0]["replica"]
    out = str(tmp_path / "fleet_trace.json")
    assert obs_report.main(["--fleet", proc_fleet_run["evdir"],
                            *proc_fleet_run["rdirs"],
                            "--trace-out", out]) == 0
    with open(out) as f:
        trace = json.load(f)
    names = {e["args"]["name"] for e in trace["traceEvents"]
             if e.get("ph") == "M"}
    assert "router" in names and any(n.startswith("replica ")
                                     for n in names)
    assert any(e.get("ph") == "X" for e in trace["traceEvents"])
