"""The port's health plane and preemption plumbing against the JAX
package on the CPU (``deepspeed_tpu_torch/utils/health.py``,
``runtime/elastic.py``, ``runtime/fault.py``'s env arming and
``launcher/runner.py``'s restart policy).

- ``FlightRecorder`` dumps, ``load_flight`` (a torn file gives None),
  ``Watchdog`` trip rows, ``NumericHealth`` alerts and the phase and
  reason vocabularies equal JAX's.
- ``PreemptionGuard``, ``Preempted``, ``request_preemption`` and
  ``restart_count`` behave as JAX's.
- ``arm_from_env`` arms the same points and raises JAX's errors.
- ``restart_eligible`` answers as JAX's for 85, 87, 1, 143 and None.
- The serving engine's plane (a fault of the port, now closed): an
  engine with ``observability.health.enabled`` has a plane, beats JAX's
  phases in JAX's order (prefill, decode, handoff_claim, chunk_prefill)
  and writes JAX's ``flight_dump`` row.
- A process whose watchdog trips with ``on_stall: "exit"`` exits 87.
"""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

import tests.torch_threads  # noqa: F401  (torch threads per xdist worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# wall-clock and process fields, left out of the comparison
TIMES = ("t", "time_unix", "pid", "silent_s", "flight", "stacks",
         "flight_path", "elapsed_ms", "latency_ms", "ttft_ms",
         "queue_wait_ms", "wall_ms", "value", "step")


def _strip(x):
    if isinstance(x, dict):
        return {k: _strip(v) for k, v in x.items() if k not in TIMES}
    if isinstance(x, list):
        return [_strip(v) for v in x]
    return x


def _mods():
    from deepspeed_tpu.utils import health as jhealth

    from deepspeed_tpu_torch.utils import health
    return {"jax": jhealth, "port": health}


class _Mirror:
    def __init__(self):
        self.rows = []

    def add_scalar(self, tag, value, step):
        self.rows.append({"tag": tag, "value": value, "step": step})

    def add_event(self, kind, **fields):
        self.rows.append({"event": kind, **fields})

    def flush(self):
        pass

    def close(self):
        pass


class _Monitor:
    def __init__(self):
        self.mirror = _Mirror()
        self.scalars = []

    def write_scalar(self, tag, value, step):
        self.scalars.append((tag, value, step))


def test_vocabularies_and_exit_codes_equal_jax():
    from deepspeed_tpu.launcher import runner as jrunner
    from deepspeed_tpu.runtime import elastic as jelastic

    from deepspeed_tpu_torch.launcher import runner
    from deepspeed_tpu_torch.runtime import elastic
    m = _mods()
    for name in ("HEALTH_PHASES", "HEALTH_REASONS", "STALL_EXIT_CODE"):
        assert getattr(m["port"], name) == getattr(m["jax"], name)
    assert elastic.RESUMABLE_EXIT_CODE == jelastic.RESUMABLE_EXIT_CODE == 85
    assert elastic.RESTART_COUNT_ENV == jelastic.RESTART_COUNT_ENV
    assert runner.RESTARTABLE_EXIT_CODES == jrunner.RESTARTABLE_EXIT_CODES


@pytest.mark.parametrize("rc", [85, 87, 1, 143, None, 0])
def test_restart_eligible_like_jax(rc):
    from deepspeed_tpu.launcher.runner import restart_eligible as jre

    from deepspeed_tpu_torch.launcher.runner import restart_eligible
    assert restart_eligible(rc) == jre(rc)


def test_flight_recorder_dump_and_load_like_jax(tmp_path):
    out = {}
    for pkg, h in _mods().items():
        path = str(tmp_path / f"{pkg}.json")
        rec = h.FlightRecorder(path, ring_events=3)
        mon = _Monitor()
        rec.tap(mon)
        for i in range(5):
            mon.mirror.add_scalar("Serve/x", float(i), i)
        mon.mirror.add_event("serve_finish", uid=4)
        assert rec.dump("manual", extra={"reason": "test"}) == path
        rec.untap()
        assert isinstance(mon.mirror, _Mirror)       # the tap came off
        out[pkg] = (h.load_flight(path), mon.mirror.rows)
        torn = tmp_path / f"{pkg}_torn.json"
        torn.write_text('{"trigger": "wat')
        assert h.load_flight(str(torn)) is None
        assert h.load_flight(str(tmp_path / "missing.json")) is None
        assert h.load_flight(None) is None
    assert _strip(out["port"][0]) == _strip(out["jax"][0])
    assert out["port"][0]["ring_events"] == 3
    assert len(out["port"][0]["rows"]) == 3
    assert out["port"][1] == out["jax"][1]


def test_watchdog_trip_rows_like_jax(tmp_path):
    rows = {}
    for pkg, h in _mods().items():
        mon = _Monitor()
        hp = h.HealthPlane({"enabled": True, "stall_timeout_s": 0.2,
                            "on_stall": "warn",
                            "flight_path": str(tmp_path / f"{pkg}.json")},
                           monitor=mon, component="serve")
        try:
            hp.heartbeat("rpc_call", detail="replica 2")
            deadline = time.monotonic() + 20.0
            while hp.watchdog.trips == 0 and time.monotonic() < deadline:
                time.sleep(0.05)
        finally:
            hp.close()
        assert hp.watchdog.trips >= 1
        stall = [r for r in mon.mirror.rows
                 if r.get("event") == "stall_detected"][0]
        flight = h.load_flight(stall["flight"])
        rows[pkg] = (stall, flight)
        with pytest.raises(ValueError, match="unknown heartbeat phase"):
            hp.heartbeat("no_such_phase")
    (ps, pf), (js, jf) = rows["port"], rows["jax"]
    assert _strip(ps) == _strip(js)
    assert (ps["phase"], ps["detail"]) == ("rpc_call", "replica 2")
    assert pf["trigger"] == jf["trigger"] == "watchdog"
    assert set(pf) == set(jf) and set(pf["stall"]) == set(jf["stall"])
    assert pf["stall"]["phase"] == "rpc_call"


def test_numeric_health_alerts_like_jax():
    stream = [1.0, 1.1, 0.9, 1.0] * 4 + [50.0, 1.0, float("nan")] * 1 + \
        [float("nan")] * 3 + [1.0]
    out = {}
    for pkg, h in _mods().items():
        mon = _Monitor()
        hp = h.HealthPlane({"enabled": True, "detectors": {
            "spike_window": 16, "nonfinite_streak": 3,
            "grad_norm_max": 10.0, "scale_collapse_below": 2.0,
            "recompile_storm_count": 2, "recompile_storm_window": 4}},
            monitor=mon)
        for step, loss in enumerate(stream):
            hp.observe_loss(loss, step)
            hp.observe_grad_norm(5.0 if step % 7 else 20.0, step)
            hp.observe_loss_scale(1.0 if step == 9 else 1024.0, step)
            hp.observe_recompiles(float(step // 5), step)
        hp.close()
        alerts = [_strip(r) for r in mon.mirror.rows
                  if r.get("event") == "health"]
        out[pkg] = (alerts, hp.alerts_total, mon.scalars,
                    dict(hp.detectors.alerts_by_reason))
    assert out["port"] == out["jax"]
    assert {a["reason"] for a in out["port"][0]} >= {
        "loss_spike", "nan_loss", "grad_norm_explosion",
        "loss_scale_collapse"}


def test_preemption_guard_like_jax():
    from deepspeed_tpu.runtime import elastic as jelastic

    from deepspeed_tpu_torch.runtime import elastic
    for el in (elastic, jelastic):
        g = el.PreemptionGuard()
        assert g.install() and not g.preempted
        assert el.request_preemption("software test") >= 1
        assert g.preempted and g.reason == "software test"
        g.trigger("second")                   # the first reason stays
        assert g.reason == "software test"
        g.clear()
        assert not g.preempted and g.reason is None
        g.uninstall()
        assert not g.installed
        e = el.Preempted(step=3, tag="t3", reason="SIGTERM")
        assert isinstance(e, SystemExit) and e.code == 85
        assert el.restart_count({"DSTPU_RESTART_COUNT": "2"}) == 2
        assert el.restart_count({"DSTPU_RESTART_COUNT": "x"}) == 0
        assert el.restart_count({}) == 0
    assert str(elastic.Preempted(step=3, tag="t3", reason="SIGTERM")) == \
        str(jelastic.Preempted(step=3, tag="t3", reason="SIGTERM"))


def test_sigterm_flags_the_guard_like_jax():
    import signal

    from deepspeed_tpu.runtime import elastic as jelastic

    from deepspeed_tpu_torch.runtime import elastic
    for el in (elastic, jelastic):
        with el.PreemptionGuard() as g:
            os.kill(os.getpid(), signal.SIGTERM)
            deadline = time.monotonic() + 5.0
            while not g.preempted and time.monotonic() < deadline:
                time.sleep(0.01)
            assert g.reason == "SIGTERM"


@pytest.mark.parametrize("spec", [
    "serve.replica_kill:crash:1",
    "serve.dispatch:oserror:2,rpc.transport:crash",
    "serve.swap_load:crash:0",
    "bad", "x:explode",
])
def test_arm_from_env_like_jax(spec):
    from deepspeed_tpu.runtime import fault as jfault

    from deepspeed_tpu_torch.runtime import fault
    env = {"DSTPU_FAULT_ARM": spec}
    try:
        ref = jfault.arm_from_env(env)
    except ValueError as e:
        with pytest.raises(ValueError) as err:
            fault.arm_from_env(env)
        assert str(err.value) == str(e)
        return
    finally:
        jfault.reset()
    try:
        assert fault.arm_from_env(env) == ref
        for point in ref:
            with pytest.raises((fault.InjectedCrash, OSError)):
                fault.fire(point, uid=1)
    finally:
        fault.reset()


def test_arm_from_env_once_file(tmp_path):
    from deepspeed_tpu_torch.runtime import fault
    once = tmp_path / "once"
    once.write_text("")
    env = {"DSTPU_FAULT_ARM": f"serve.dispatch:crash@{once}"}
    try:
        assert fault.arm_from_env(env) == ["serve.dispatch"]
        with pytest.raises(fault.InjectedCrash):
            fault.fire("serve.dispatch")
        assert not once.exists()                # the first fire used it
        fault.reset()
        assert fault.arm_from_env(env) == []    # a later process: unarmed
    finally:
        fault.reset()


# -------------------------------------- the serving engine's plane
def _engine_phases(pkg, events_dir):
    """A health-enabled disaggregated engine (shared pool) of each
    package serving the same requests: the phases it beat, in order, and
    its flight_dump row."""
    import jax
    import numpy as np

    from deepspeed_tpu.models.gpt2 import GPT2Config, init_gpt2_params
    cfg = GPT2Config(vocab_size=61, max_position_embeddings=64,
                     hidden_size=32, num_layers=2, num_heads=4,
                     embd_dropout=0.0, attn_dropout=0.0, resid_dropout=0.0)
    params = init_gpt2_params(cfg, jax.random.PRNGKey(3))
    icfg = {"max_batch_size": 2, "prompt_buckets": [8, 16],
            "batch_buckets": [1, 2], "max_seq_len": 48,
            "events_dir": events_dir, "disagg": {"enabled": True},
            "chunked_prefill": {"enabled": True, "chunk_tokens": 8}}
    obs = {"health": {"enabled": True, "stall_timeout_s": 60.0}}
    if pkg == "jax":
        import jax.numpy as jnp

        from deepspeed_tpu.inference import InferenceEngine, Request
        eng = InferenceEngine(cfg, params, icfg, dtype=jnp.float32,
                              observability_config=obs)
    else:
        from deepspeed_tpu_torch.inference import InferenceEngine, Request
        from deepspeed_tpu_torch.models.gpt2 import GPT2Config as TConfig
        from deepspeed_tpu_torch.models.gpt2 import params_from_jax
        eng = InferenceEngine(
            TConfig(**cfg._asdict()),
            params_from_jax(jax.tree_util.tree_map(np.asarray, params)),
            icfg, dtype=torch.float32, device="cpu",
            observability_config=obs)
    assert eng.health.enabled and eng.health.watchdog is not None
    phases = []
    beat = eng.health.heartbeat

    def record(phase, detail=None):
        phases.append(phase)
        beat(phase, detail)
    eng.health.heartbeat = record
    eng.warmup()
    for i, p in enumerate([[1, 2, 3], list(range(1, 22)), [4, 5]]):
        eng.submit(Request(prompt=p, max_new_tokens=3, temperature=0.0,
                           seed=i, uid=50 + i))
    tokens = {f.uid: f.tokens for f in eng.run()}
    flight = eng.health.dump("manual", reason="test")
    eng.close()
    rows = [json.loads(line) for line in
            open(os.path.join(events_dir, "events.jsonl")) if line.strip()]
    dump = [r for r in rows if r.get("event") == "flight_dump"]
    return phases, tokens, dump, flight


def test_serving_engine_beats_jax_phases_and_writes_health_rows(tmp_path):
    jax_run = _engine_phases("jax", str(tmp_path / "jax"))
    port_run = _engine_phases("port", str(tmp_path / "port"))
    assert port_run[0] == jax_run[0]
    assert {"prefill", "decode", "handoff_claim",
            "chunk_prefill"} <= set(port_run[0])
    assert port_run[1] == jax_run[1]
    assert _strip(port_run[2]) == _strip(jax_run[2])
    assert port_run[2][0]["component"] == "serve"
    assert os.path.basename(port_run[3]) == "flight_serve.json"
    with open(port_run[3]) as f:
        payload = json.load(f)
    assert payload["trigger"] == "manual" and payload["rows"]


def test_health_off_by_default_and_closed_with_the_engine():
    from deepspeed_tpu_torch.inference import InferenceEngine
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, init_gpt2_params
    cfg = GPT2Config(vocab_size=61, max_position_embeddings=64,
                     hidden_size=32, num_layers=2, num_heads=4)
    params = init_gpt2_params(cfg, torch.Generator().manual_seed(0))
    icfg = {"max_batch_size": 2, "prompt_buckets": [8],
            "batch_buckets": [1], "max_seq_len": 16}
    eng = InferenceEngine(cfg, params, icfg, dtype=torch.float32,
                          device="cpu")
    assert not eng.health.enabled and eng.health.watchdog is None
    eng.health.heartbeat("decode")          # a no-op when off
    eng.close()
    eng = InferenceEngine(cfg, params, icfg, dtype=torch.float32,
                          device="cpu", observability_config={
                              "health": {"enabled": True,
                                         "stall_timeout_s": 30.0}})
    hook = sys.excepthook
    watchdog = eng.health.watchdog
    eng.close()
    assert watchdog._thread is None        # the watchdog stopped
    assert sys.excepthook is not hook      # its hook came off
    with pytest.raises(Exception, match="on_stall"):
        InferenceEngine(cfg, params, icfg, dtype=torch.float32,
                        device="cpu", observability_config={
                            "health": {"enabled": True,
                                       "on_stall": "abort"}})


def test_on_stall_exit_exits_87(tmp_path):
    flight = str(tmp_path / "flight.json")
    code = ("import time\n"
            "from deepspeed_tpu_torch.utils.health import HealthPlane\n"
            "hp = HealthPlane({'enabled': True, 'stall_timeout_s': 0.3, "
            f"'on_stall': 'exit', 'flight_path': {flight!r}}}, "
            "component='serve')\n"
            "hp.heartbeat('decode')\n"
            "time.sleep(60)\n")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          timeout=120, capture_output=True, text=True)
    assert proc.returncode == 87, proc.stderr[-2000:]
    with open(flight) as f:
        payload = json.load(f)
    assert payload["trigger"] == "watchdog"
    assert payload["stall"]["phase"] == "decode"
    assert payload["stall"]["component"] == "serve"
    assert payload["stacks"]
