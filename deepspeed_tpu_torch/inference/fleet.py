"""The serving fleet (the port of ``deepspeed_tpu/inference/fleet.py``):
a multi-replica router over engines in this process or in child
processes.

One engine is one failure domain: a SIGTERM, a hot queue or a weight
push takes the whole service down. :class:`FleetRouter` fronts N
:class:`~.engine.InferenceEngine` replicas (built by the caller; this
module makes no device state) and keeps the service answering, correctly
and within its SLO, while single replicas are preempted, overloaded or
upgraded. On one card the replicas share the device: in-process
replicas share its context, replica children each hold their own.

**Routing and SLO shedding.** Requests route ``least_loaded`` (queue
depth plus active slots) or ``prefix_affinity`` (the replica whose
prefix cache already covers the most prompt tokens, ties broken by
load) off each engine's host-side state, with no device sync. When the
fleet's p95 TTFT (the serve tracers' histograms) passes
``slo_shed.ttft_budget_ms`` the shed ladder engages:

    rung 1 (p95 > budget)          reject requests below the
                                   ``shed_below_priority`` tier
                                   ("shed_slo": a zero-token answer,
                                   never a drop)
    rung 2 (p95 > budget x factor) also cap admitted requests'
                                   max_new_tokens ("degrade_max_new")
                                   and switch speculation off fleet-wide
                                   ("degrade_spec_off"; the plain decode
                                   program is already warm)

Every shed decision lands in the serve trail (``fleet_shed`` rows) with
a reason from :data:`~.tracing.SHED_REASONS`.

**Replica drain.** Each replica carries a
:class:`~deepspeed_tpu_torch.runtime.elastic.PreemptionGuard`; a SIGTERM
(or ``request_preemption``, or :meth:`FleetRouter.drain`) flips it and
the router reacts at its next step: the replica takes no new work, its
queued requests are cancelled ("drain") and resubmitted, as the same
``Request`` objects with the same uids and seeds, to surviving replicas,
and its in-flight requests migrate alive when both sides warmed the
migration programs (else they finish where they are). When its last slot
empties the replica retires (``fleet_drain`` rows bracket the episode).

**Live weight swap.** :meth:`FleetRouter.swap_weights` pushes a
committed checkpoint tag into every running replica between steps via
``engine.swap_params`` (in place, atomic or rolled back per replica);
every ``FinishedRequest`` carries the ``weight_version`` that produced
it.

**Process mode.** :class:`ReplicaProcess` is a duck-typed engine proxy
over the :mod:`~.rpc` channel to one ``replica_worker`` child, so the
routing, shed, drain and swap semantics carry over unchanged, with three
legs only a process boundary gives: (1) live KV migration: a draining
or dying replica exports each in-flight request's live pages (the
``migrate_export`` program), ships them through the channel (priced by
``engine.LinkModel``, a ``serve_migration`` row), and the importing
replica resumes decode at the same position through ``migrate_import``;
(2) a supervised lifecycle: a dead child's exit code goes through the
launcher's restart policy (``launcher/runner.restart_eligible``: 85 and
87 relaunch, anything else gives up), its queued requests redistribute
and its flight recorder is salvaged into the router's trail
(``fleet_flight_salvage``); (3) goodput-driven autoscale: sustained
rung-1 shedding spawns a replica, sustained idleness drains one
(hysteresis and cooldown, never below ``min_replicas``, never a dropped
request).

Host code only: the router drives engines through their host surface,
so its policy runs in microseconds and cannot perturb a program.
"""

import itertools
import json
import os
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, replace
from typing import (Any, Callable, Dict, List, Optional, Sequence,
                    Tuple)

from deepspeed_tpu_torch.inference import rpc
from deepspeed_tpu_torch.inference.disagg import price_handoff
from deepspeed_tpu_torch.inference.rpc import ReplicaDeadError, RpcError
from deepspeed_tpu_torch.inference.scheduler import FinishedRequest, Request
from deepspeed_tpu_torch.launcher.runner import restart_eligible
from deepspeed_tpu_torch.runtime import fault
from deepspeed_tpu_torch.runtime.config import get_inference_config
from deepspeed_tpu_torch.runtime.elastic import PreemptionGuard
from deepspeed_tpu_torch.utils.health import load_flight
from deepspeed_tpu_torch.utils.logging import logger

__all__ = ["FleetRouter", "ReplicaHandle", "ReplicaProcess",
           "launch_replica_processes"]

#: replica lifecycle (one-way): live -> draining -> retired
LIVE, DRAINING, RETIRED = "live", "draining", "retired"

#: the directory that holds this package (a replica child's PYTHONPATH)
_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _normalize_fleet_config(fleet_config) -> Dict[str, Any]:
    """Run a raw ``inference.fleet`` section through the config parser
    (defaults and DeepSpeedConfigError checks: one grammar, no
    router-private dialect)."""
    return get_inference_config(
        {"inference": {"fleet": dict(fleet_config or {})}})["fleet"]


@dataclass
class ReplicaHandle:
    """The router's per-replica bookkeeping around one engine."""
    idx: int
    engine: Any
    guard: PreemptionGuard
    status: str = LIVE
    drain_reason: Optional[str] = None
    dispatch_faults: int = 0     # serve.dispatch injections survived
    routed: int = 0              # requests this replica received
    # process-mode lifecycle + migration ledger
    restarts: int = 0            # supervised relaunches so far
    last_exit_code: Optional[int] = None
    migrations_in: int = 0       # live requests imported here
    migrations_out: int = 0      # live requests exported away
    migration_bytes: int = 0     # slab bytes shipped out
    migration_priced_ms: float = 0.0   # LinkModel-priced wire cost

    # ------------------------------------------------- host-side reads
    def load(self) -> int:
        """Routing load metric: waiting + in-flight requests."""
        sched = self.engine.scheduler
        return sched.queue_depth + len(sched.active_slots())

    def prefix_tokens(self, prompt: Sequence[int]) -> int:
        """Prompt tokens this replica's prefix cache already holds."""
        alloc = getattr(self.engine.scheduler, "admit_allocator", None)
        if alloc is None or not hasattr(alloc, "match_prefix"):
            return 0
        _pages, tokens = alloc.match_prefix(list(prompt))
        return int(tokens)

    def handoff_depth(self) -> int:
        q = getattr(self.engine, "_handoff_q", None)
        return len(q) if q is not None else 0

    def idle(self) -> bool:
        return self.engine.scheduler.idle() and self.handoff_depth() == 0

    def active_uids(self) -> List[int]:
        """In-flight request uids (the migration candidates on drain).
        Process proxies keep a synced list; in-process engines read
        the live slots."""
        sched = self.engine.scheduler
        uids = getattr(sched, "active_uids", None)
        if uids is not None:
            return list(uids() if callable(uids) else uids)
        return [sched.slots[s].request.uid
                for s in sched.active_slots()]

    def process_snapshot(self) -> Dict[str, Any]:
        """One ``fleet_replica_state`` row: per-replica process health
        + migration ledger (obs_report's fleet process table)."""
        return {
            "replica": self.idx,
            "status": self.status,
            "pid": getattr(self.engine, "pid", None) or os.getpid(),
            "restarts": self.restarts,
            "last_exit_code": self.last_exit_code,
            "migrations_in": self.migrations_in,
            "migrations_out": self.migrations_out,
            "migration_bytes": self.migration_bytes,
            "migration_priced_ms": round(self.migration_priced_ms, 4),
        }

    def snapshot(self) -> Dict[str, Any]:
        """One row of the ``fleet_state`` event / ``debug_state()``."""
        sched = self.engine.scheduler
        alloc = getattr(sched, "allocator", None)
        return {
            "replica": self.idx,
            "status": self.status,
            "queue_depth": sched.queue_depth,
            "active_slots": len(sched.active_slots()),
            "occupancy": round(sched.occupancy, 4),
            "pages_in_use": (alloc.pages_in_use if alloc is not None
                             else None),
            "weight_version": getattr(self.engine, "weight_version",
                                      None),
            "weight_ordinal": getattr(self.engine, "weight_ordinal", 0),
            "steady_state_recompiles": getattr(
                self.engine, "steady_state_recompiles", None),
            "routed": self.routed,
            "dispatch_faults": self.dispatch_faults,
            "drain_reason": self.drain_reason,
        }


class _ProcScheduler:
    """Router-side mirror of a child replica's scheduler surface,
    refreshed from the ``state`` snapshot every RPC reply carries.
    Exposes exactly what the router reads for routing/drain decisions
    (``queue``/``queue_depth``/``active_slots()``/``occupancy``/
    ``total_tokens``/``idle()``/``allocator.pages_in_use``) with ZERO
    extra round trips — state piggybacks on calls already in flight."""

    class _Alloc:
        def __init__(self):
            self.pages_in_use: Optional[int] = None

    def __init__(self):
        self.queue: List[Request] = []
        self.active_uids: List[int] = []
        self.mid_decode_uids: List[int] = []
        self.occupancy = 0.0
        self.total_tokens = 0
        self._idle = True
        self.allocator = _ProcScheduler._Alloc()

    @property
    def queue_depth(self) -> int:
        return len(self.queue)

    def active_slots(self) -> List[int]:
        # across the process boundary uids stand in for slot ids; the
        # router only counts these or maps them back to uids
        return list(self.active_uids)

    def idle(self) -> bool:
        return self._idle and not self.queue


class ReplicaProcess:
    """Duck-typed engine proxy over one RPC channel to a
    ``replica_worker`` child. Presents the engine host surface the
    router drives (``submit/step/cancel/scheduler/swap_params/
    set_speculation/export_request/import_request/weight_version``) so
    :class:`FleetRouter`'s routing/shed/drain/swap semantics are
    IDENTICAL for in-process and child-process replicas — plus the
    lifecycle only a process boundary buys: :meth:`poll_exit` (the
    child's exit code feeds the launcher restart policy),
    :meth:`relaunch` (supervised restart into a fresh child), and
    deathbed handling (a ``dying`` reply surfaces as
    :class:`~.rpc.ReplicaDeadError` carrying migration exports).

    ``spec`` is the replica_worker spec grammar (model_config,
    init_seed or checkpoint_dir, inference, observability, dtype).
    Requests submitted here are kept router-side too (``_requests``)
    so a death can redistribute them — same objects, same uids, same
    seeds."""

    def __init__(self, spec: Dict[str, Any], *, name: str = "replica",
                 rpc_timeout_s: float = 120.0, rpc_retries: int = 2,
                 rpc_backoff_s: float = 0.05,
                 ready_timeout_s: float = 300.0,
                 env: Optional[Dict[str, str]] = None,
                 python: Optional[str] = None,
                 log_path: Optional[str] = None):
        self.spec = dict(spec)
        self.name = name
        self._timeout_s = float(rpc_timeout_s)
        self._retries = int(rpc_retries)
        self._backoff_s = float(rpc_backoff_s)
        self._ready_timeout_s = float(ready_timeout_s)
        self._env = dict(env or {})
        self._python = python or sys.executable
        self._log_path = log_path
        self.scheduler = _ProcScheduler()
        #: router-side copies of everything the child holds (queued +
        #: in-flight), keyed by uid — the redistribution source on death
        self._requests: Dict[int, Request] = {}
        self.pid: Optional[int] = None
        self.flight_path: Optional[str] = None
        self.weight_version: Optional[str] = "initial"
        self.weight_ordinal = 0
        self.steady_state_recompiles = -1
        self.total_dispatches: Optional[int] = None
        self._can_migrate = False
        self.last_state: Dict[str, Any] = {}
        self._proc: Optional[subprocess.Popen] = None
        self._client: Optional[rpc.RpcClient] = None
        self._srv = None
        self._spec_path: Optional[str] = None
        self._log_file = None
        self._dead = True

    # -------------------------------------------------------- lifecycle
    def start(self) -> None:
        """Spawn the child (cheap — the expensive engine build runs in
        the child while the parent does other work; pair with
        :meth:`wait_ready`, possibly after starting siblings)."""
        srv, port = rpc.listen_local()
        self._srv = srv
        fd, path = tempfile.mkstemp(prefix=f"replica_{self.name}_",
                                    suffix=".json")
        with os.fdopen(fd, "w") as f:
            json.dump(self.spec, f)
        self._spec_path = path
        if self._log_path:
            self._log_file = open(self._log_path, "ab")
            out = self._log_file
        else:
            out = subprocess.DEVNULL
        env = {**os.environ, **self._env}
        # the child imports this package from the same checkout
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_CHECKOUT, env.get("PYTHONPATH")) if p)
        # fork + exec at once: the child starts clean and makes its own
        # CUDA context, whatever this process holds
        self._proc = subprocess.Popen(
            [self._python, "-m",
             "deepspeed_tpu_torch.inference.replica_worker",
             "--port", str(port), "--spec", path,
             "--connect_timeout_s", str(self._ready_timeout_s)],
            env=env, stdout=out, stderr=subprocess.STDOUT)

    def wait_ready(self) -> None:
        """Block until the child's ready frame (or its build failure).
        Raises :class:`~.rpc.ReplicaDeadError` if it never connects."""
        srv, self._srv = self._srv, None
        if srv is None:
            raise RuntimeError(f"replica {self.name}: start() first")
        srv.settimeout(self._ready_timeout_s)
        try:
            conn, _addr = srv.accept()
        except OSError as e:
            raise ReplicaDeadError(
                f"replica {self.name}: child never connected "
                f"({e!r})") from e
        finally:
            srv.close()
        conn.settimeout(self._ready_timeout_s)
        ready, _payload = rpc.recv_frame(conn)
        if not ready.get("ok"):
            err = (ready.get("error") or {}).get("message", "?")
            self.poll_exit()
            raise ReplicaDeadError(
                f"replica {self.name}: engine build failed: {err}")
        hello = ready["result"]
        self.pid = hello.get("pid")
        self.flight_path = hello.get("flight_path")
        self._client = rpc.RpcClient(
            conn, timeout_s=self._timeout_s, retries=self._retries,
            backoff_s=self._backoff_s, name=self.name)
        self._dead = False
        self._sync(hello.get("state") or {})
        logger.info(f"replica {self.name}: child pid {self.pid} ready "
                    f"(flight={self.flight_path})")

    def relaunch(self) -> None:
        """Supervised restart: fresh child, fresh engine, empty state.
        The caller (router) re-dispatches whatever the dead child held."""
        if self._proc is not None and self._proc.poll() is None:
            raise RuntimeError(
                f"replica {self.name}: relaunch while child alive")
        if self._client is not None:
            self._client.close()
            self._client = None
        self.scheduler = _ProcScheduler()
        self._requests = {}
        self.weight_version = "initial"
        self.weight_ordinal = 0
        self.steady_state_recompiles = -1
        self.total_dispatches = None
        self._can_migrate = False
        self.start()
        self.wait_ready()

    def poll_exit(self, timeout_s: float = 10.0) -> Optional[int]:
        """Reap the child; returns its exit code (None if still up)."""
        if self._proc is None:
            return None
        try:
            return self._proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            return None

    def close(self) -> None:
        if self._client is not None and not self._dead:
            try:
                self._client.call("shutdown", timeout_s=30.0)
            except RpcError:
                pass
            self._dead = True
        if self._client is not None:
            self._client.close()
            self._client = None
        if self._proc is not None:
            try:
                self._proc.wait(timeout=30.0)
            except subprocess.TimeoutExpired:
                self._proc.kill()
                self._proc.wait(timeout=10.0)
        if self._log_file is not None:
            self._log_file.close()
            self._log_file = None
        if self._spec_path:
            try:
                os.unlink(self._spec_path)
            except OSError:
                pass
            self._spec_path = None

    # ------------------------------------------------------- rpc plumbing
    def _sync(self, state: Dict[str, Any]) -> None:
        # the child's whole snapshot as last received (its dispatch and
        # kernel-launch counts, its peak device memory)
        self.last_state = dict(state)
        sched = self.scheduler
        sched.active_uids = list(state.get("active_uids") or [])
        sched.mid_decode_uids = list(state.get("mid_decode_uids") or [])
        sched.occupancy = float(state.get("occupancy") or 0.0)
        sched.total_tokens = int(state.get("total_tokens") or 0)
        sched._idle = bool(state.get("idle", True))
        sched.allocator.pages_in_use = state.get("pages_in_use")
        sched.queue = [self._requests[u]
                       for u in (state.get("queued_uids") or [])
                       if u in self._requests]
        self.weight_version = state.get("weight_version",
                                        self.weight_version)
        self.weight_ordinal = state.get("weight_ordinal",
                                        self.weight_ordinal)
        self.steady_state_recompiles = state.get(
            "steady_state_recompiles", self.steady_state_recompiles)
        if state.get("dispatches") is not None:
            self.total_dispatches = int(state["dispatches"])
        self._can_migrate = bool(state.get("can_migrate", False))

    def _call(self, method: str, params: Optional[Dict] = None,
              payload: bytes = b"",
              timeout_s: Optional[float] = None) -> Tuple[Any, bytes]:
        if self._dead or self._client is None:
            raise ReplicaDeadError(
                f"replica {self.name}: channel already dead",
                method=method)
        try:
            res, out = self._client.call(method, params, payload,
                                         timeout_s=timeout_s)
        except ReplicaDeadError:
            self._dead = True
            raise
        if isinstance(res, dict) and res.get("dying"):
            # the deathbed frame: last reply on this channel, carrying
            # every in-flight request's live pages + the queued backlog
            self._dead = True
            exports = rpc.decode_migrations(res.get("exports") or [],
                                            out)
            for rec in exports:
                # exported requests answer through migration (or its
                # resubmit fallback), NOT through orphans() — exactly
                # one FinishedRequest per uid
                self._requests.pop(rec.uid, None)
            err = ReplicaDeadError(
                f"replica {self.name}: died during {method} "
                f"({res.get('reason')})", method=method,
                exports=exports, reason=res.get("reason"))
            raise err
        if isinstance(res, dict) and "state" in res:
            self._sync(res["state"])
        return res, out

    # ---------------------------------------------- engine host surface
    def submit(self, request: Request) -> int:
        self._requests[request.uid] = request
        try:
            self._call("submit",
                       {"request": rpc.request_to_wire(request)})
        except RpcError:
            self._requests.pop(request.uid, None)
            raise
        return request.uid

    def cancel(self, uid: int,
               reason: str = "evicted") -> Optional[FinishedRequest]:
        res, _ = self._call("cancel", {"uid": uid, "reason": reason})
        self._requests.pop(uid, None)
        fin = res.get("fin")
        return None if fin is None else FinishedRequest(**fin)

    def step(self) -> List[FinishedRequest]:
        res, _ = self._call("step")
        fins = [FinishedRequest(**d) for d in res.get("fins") or []]
        for f in fins:
            self._requests.pop(f.uid, None)
        return fins

    def export_request(self, uid: int):
        res, payload = self._call("export_request", {"uid": uid})
        head = res.get("header")
        if head is None:
            return None
        self._requests.pop(uid, None)
        return rpc.migration_from_wire(head, payload)

    def import_request(self, rec) -> Optional[int]:
        head, payload = rpc.migration_to_wire(rec)
        res, _ = self._call("import_request", {"header": head},
                            payload=payload)
        sid = res.get("slot")
        if sid is not None:
            # track the resumed request router-side like any other
            self._requests[rec.uid] = rpc.request_from_wire({
                "prompt": rec.prompt,
                "max_new_tokens": rec.max_new_tokens,
                "temperature": rec.temperature, "seed": rec.seed,
                "eos_id": rec.eos_id, "priority": rec.priority,
                "uid": rec.uid})
        return sid

    def swap_params(self, load_dir, tag=None,
                    verify_integrity: bool = True) -> str:
        res, _ = self._call("swap_params",
                            {"load_dir": str(load_dir), "tag": tag,
                             "verify_integrity": verify_integrity})
        return res["weight_version"]

    def set_speculation(self, on: bool) -> bool:
        try:
            res, _ = self._call("set_speculation", {"on": bool(on)})
        except RpcError:
            return False
        return bool(res.get("changed"))

    def clock_ping(self, samples: int = 3) -> Dict[str, float]:
        """Estimate the child's wall-clock offset against this process
        (midpoint method): the child replies with its ``time.time()``;
        we bracket the call with our own ``t0``/``t1`` and take
        ``offset = t_child - (t0 + t1) / 2``, true to within
        ``uncertainty = (t1 - t0) / 2`` (the reply can have landed
        anywhere inside the round trip). Of ``samples`` exchanges the
        minimum-RTT one wins — it carries the tightest bound. The
        router records the result as a ``clock_sync`` event row so
        offline log merging (``obs_report --fleet``) can align replica
        timelines without trusting any single wall clock."""
        best: Optional[Tuple[float, float]] = None
        for _ in range(max(1, int(samples))):
            t0 = time.time()
            res, _ = self._call("clock_ping", {})
            t1 = time.time()
            rtt = t1 - t0
            offset = float(res["t_child"]) - (t0 + t1) / 2.0
            if best is None or rtt < best[1]:
                best = (offset, rtt)
        return {"offset_s": best[0], "uncertainty_s": best[1] / 2.0,
                "rtt_s": best[1]}

    @property
    def can_migrate(self) -> bool:
        return self._can_migrate and not self._dead

    def orphans(self) -> List[Request]:
        """Requests the dead child still owed answers for (queued +
        any in-flight the deathbed could not export) — the router
        redistributes these with the same uids and seeds."""
        return list(self._requests.values())


def launch_replica_processes(spec: Dict[str, Any], count: int, *,
                             fleet_config: Optional[Dict] = None,
                             env_by_replica: Optional[
                                 Dict[int, Dict[str, str]]] = None,
                             spec_by_replica: Optional[
                                 Dict[int, Dict[str, Any]]] = None,
                             python: Optional[str] = None,
                             log_dir: Optional[str] = None
                             ) -> List[ReplicaProcess]:
    """Spawn ``count`` replica children in parallel (all ``start()``
    first, so their engine builds overlap, then ``wait_ready()`` each)
    and return the proxies — ready to hand to :class:`FleetRouter`.
    ``env_by_replica`` injects per-child env vars (the kill tests arm
    ``DSTPU_FAULT_ARM`` in exactly one child this way);
    ``spec_by_replica`` shallow-merges per-child spec overrides (e.g.
    a distinct ``observability.health.flight_path`` per child, so the
    black boxes don't clobber each other)."""
    pm = _normalize_fleet_config(fleet_config)["process_mode"]
    reps = []
    for i in range(count):
        merged = {**spec, **(spec_by_replica or {}).get(i, {})}
        # stamp the fleet identity into the child's serve-tracer config
        # (unless the caller already picked one): every event row the
        # child writes carries ``replica_id``, so the offline fleet
        # merger attributes rows without trusting directory names
        obs = dict(merged.get("observability") or {})
        srv = dict(obs.get("serve") or {})
        srv.setdefault("replica_id", i)
        obs["serve"] = srv
        merged["observability"] = obs
        reps.append(ReplicaProcess(
            merged, name=f"r{i}",
            rpc_timeout_s=pm["rpc_timeout_s"],
            rpc_retries=pm["rpc_retries"],
            rpc_backoff_s=pm["rpc_backoff_s"],
            ready_timeout_s=pm["ready_timeout_s"],
            env=(env_by_replica or {}).get(i),
            python=python,
            log_path=(os.path.join(log_dir, f"replica_{i}.log")
                      if log_dir else None)))
    try:
        for r in reps:
            r.start()
        for r in reps:
            r.wait_ready()
    except BaseException:
        for r in reps:
            try:
                r.close()
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass
        raise
    return reps


class FleetRouter:
    """Route requests across N in-process engine replicas; shed by
    SLO, drain through preemptions, swap weights live.

    ``engines`` are already-warmed :class:`~.engine.InferenceEngine`
    instances (duck-typed: anything with the engine's host surface —
    ``submit/step/cancel/scheduler/swap_params/set_speculation``).
    ``fleet_config`` is a raw ``inference.fleet`` dict (normalized and
    validated through ``runtime/config.py``). Telemetry reuses the
    first engine's monitor and events.jsonl writer unless overridden —
    the fleet trail interleaves with the per-request serve trail, one
    timeline per run.

    Drive it like an engine: ``submit`` then ``run`` (or ``step`` in a
    serving loop). ``run`` returns exactly one :class:`FinishedRequest`
    per submitted uid — shed requests get a synthesized zero-token
    response (``finish_reason`` from the pinned shed vocabulary), never
    a dropped uid.
    """

    #: fleet_state event / scalar cadence (router steps)
    _STATE_EVERY = 16
    #: periodic clock re-sync cadence (router steps) — cheap (one
    #: tiny RPC per replica) but offsets drift slowly, so sparse
    _CLOCK_SYNC_EVERY = 256

    def __init__(self, engines: Sequence[Any], fleet_config=None,
                 monitor=None, writer=None,
                 install_signal_handlers: bool = False,
                 clock=time.perf_counter,
                 replica_factory: Optional[Callable[[int], Any]] = None,
                 sleep: Callable[[float], None] = time.sleep,
                 health=None):
        if not engines:
            raise ValueError("FleetRouter needs at least one engine")
        self.cfg = _normalize_fleet_config(fleet_config)
        self._clock = clock
        self._sleep = sleep
        # autoscale's spawn hook: (replica_idx) -> engine-like. For a
        # process fleet this respawns a ReplicaProcess; in-process
        # tests hand in a lambda.
        self._factory = replica_factory
        self.replicas = [ReplicaHandle(i, e, PreemptionGuard())
                         for i, e in enumerate(engines)]
        if install_signal_handlers:
            # chain-installed: a real SIGTERM reaches the last guard —
            # ONE replica drains, the fleet keeps serving (the process-
            # level analog of a preempted pod). Software triggers
            # (drain()/request_preemption) don't need handlers.
            for r in self.replicas:
                r.guard.install()
        self.monitor = monitor if monitor is not None else \
            getattr(engines[0], "monitor", None)
        self._log = writer if writer is not None else \
            getattr(engines[0], "_log", None)
        # env-armed serve-plane faults (DSTPU_FAULT_ARM) — latched
        # no-op when another component already armed this process
        fault.arm_from_env()
        # health plane: the router beats the FIRST replica's watchdog
        # once per scheduling round (duck-typed like monitor/_log — a
        # fleet of stubs without one simply has no fleet heartbeat).
        # Process replicas have no in-process .health, so a process-
        # mode router passes its OWN HealthPlane via the kwarg — the
        # rpc_call beats then name which replica a hung wait was on.
        self.health = health if health is not None else \
            getattr(engines[0], "health", None)
        # distributed tracing: the router mints every trace id (one
        # per client request, monotonic — no RNG, no wall clock in the
        # id itself, so traced runs stay bitwise-reproducible)
        self._trace_seq = itertools.count()
        self._trace_prefix = f"f{os.getpid():x}"
        self._steps = 0
        self._pending: List[FinishedRequest] = []
        # ladder + ledger
        self.total_submitted = 0
        self.total_shed = 0
        self.shed_by_reason: Dict[str, int] = {}
        self.shed_by_priority: Dict[int, int] = {}
        self.total_degraded = 0
        self.total_redistributed = 0
        self.total_reroutes = 0
        # process-mode robustness ledger
        self.total_migrated = 0          # live requests moved alive
        self.migration_bytes = 0         # slab bytes shipped
        self.migration_priced_ms = 0.0   # LinkModel-priced wire time
        self.total_restarts = 0          # supervised relaunches
        self.total_salvaged = 0          # dead-child flight recorders
        # autoscale hysteresis state
        self._shed_streak = 0
        self._idle_streak = 0
        self._as_cooldown = 0
        self._mig_link = None            # lazy LinkModel (pricing)
        self._spec_degraded = False
        sh = self.cfg["slo_shed"]
        self._budget_ms = sh["ttft_budget_ms"]
        if self._budget_ms is None:
            # fall back to the serve SLO the tracers already enforce
            tr = getattr(engines[0], "_tracer", None)
            self._budget_ms = float(getattr(tr, "slo_ttft_ms", 2000.0))
        logger.info(
            f"fleet router: {len(self.replicas)} replicas, "
            f"routing={self.cfg['routing']}, slo_shed="
            f"{'on' if sh['enabled'] else 'off'} "
            f"(p95 TTFT budget {self._budget_ms:.0f} ms)")
        # initial clock alignment (process replicas only — in-process
        # engines share our clock, offset is definitionally zero)
        self._sync_clocks()

    # ---------------------------------------------------------- events
    def _event(self, kind: str, **fields) -> None:
        if self._log is not None:
            self._log.add_event(kind, **fields)

    def _beat_rpc(self, r: "ReplicaHandle") -> None:
        """Heartbeat the ``rpc_call`` phase before a blocking wait on a
        process replica, naming WHICH replica — a watchdog trip during
        a hung RPC then reads ``rpc_call (replica 2)``, not a generic
        fleet stall. In-process engines don't block on a wire, so the
        beat is skipped (phase attribution stays precise)."""
        if self.health is not None and \
                hasattr(r.engine, "poll_exit"):
            self.health.heartbeat("rpc_call",
                                  detail=f"replica {r.idx}")

    # ------------------------------------------------- clock alignment
    def _sync_clocks(self) -> None:
        """Estimate every process replica's wall-clock offset (midpoint
        method: ``offset = t_child - (t0 + t1)/2``, uncertainty =
        half the best RTT) and record a ``clock_sync`` trail row per
        replica. The offline fleet merger (obs_report --fleet) uses the
        latest row per replica to place that replica's event rows on
        the router's timeline; the uncertainty bounds how much apparent
        reordering is attributable to clock skew vs. a real anomaly."""
        for r in self.replicas:
            if r.status != LIVE:
                continue
            ping = getattr(r.engine, "clock_ping", None)
            if ping is None:
                continue
            self._beat_rpc(r)
            try:
                est = ping()
            except (RpcError, OSError, ReplicaDeadError) as e:
                logger.warning(f"fleet clock sync: replica {r.idx} "
                               f"ping failed ({e!r}); skipping")
                continue
            self._event("clock_sync", replica=r.idx,
                        offset_ms=round(est["offset_s"] * 1e3, 4),
                        uncertainty_ms=round(
                            est["uncertainty_s"] * 1e3, 4),
                        rtt_ms=round(est["rtt_s"] * 1e3, 4))

    # ------------------------------------------------------ shed ladder
    def _ttft_stats(self):
        """Aggregate (samples, worst p95) over serving replicas — the
        goodput histograms the tracers already keep."""
        count, p95 = 0, None
        for r in self.replicas:
            if r.status == RETIRED:
                continue
            tr = getattr(r.engine, "_tracer", None)
            if tr is None:
                continue
            h = tr.hist.get("ttft_ms")
            if h is None or not h.count:
                continue
            count += h.count
            v = h.percentile(0.95)
            if v is not None:
                p95 = v if p95 is None else max(p95, v)
        return count, p95

    def shed_level(self) -> int:
        """0 = healthy, 1 = shed rung (reject low tiers), 2 = degrade
        rung (cap max_new + speculation off)."""
        sh = self.cfg["slo_shed"]
        if not sh["enabled"]:
            return 0
        count, p95 = self._ttft_stats()
        if p95 is None or count < sh["min_samples"]:
            return 0
        if p95 > self._budget_ms * sh["degrade_factor"]:
            return 2
        if p95 > self._budget_ms:
            return 1
        return 0

    def _shed(self, req: Request, reason: str,
              **extra) -> FinishedRequest:
        """Synthesize the rejection response: the client gets exactly
        one FinishedRequest per uid — a shed is a (zero-token) answer,
        never a dropped request."""
        prio = getattr(req, "priority", 0)
        self.total_shed += 1
        self.shed_by_reason[reason] = \
            self.shed_by_reason.get(reason, 0) + 1
        self.shed_by_priority[prio] = \
            self.shed_by_priority.get(prio, 0) + 1
        self._event("fleet_shed", uid=req.uid, reason=reason,
                    priority=prio, **extra)
        fin = FinishedRequest(uid=req.uid, prompt=list(req.prompt),
                              tokens=[], finish_reason=reason,
                              ttft_ms=None, latency_ms=0.0)
        self._pending.append(fin)
        return fin

    def _apply_spec_degrade(self, level: int) -> None:
        want = level >= 2
        if want == self._spec_degraded:
            return
        changed = 0
        for r in self.replicas:
            if r.status == RETIRED:
                continue
            if getattr(r.engine, "set_speculation",
                       lambda on: False)(not want):
                changed += 1
        self._spec_degraded = want
        if changed:
            self._event("fleet_shed", reason="degrade_spec_off",
                        enabled=want, replicas=changed)

    # ---------------------------------------------------------- routing
    def _ranked(self, req: Optional[Request]) -> List[ReplicaHandle]:
        """Live replicas, best dispatch target first."""
        live = [r for r in self.replicas if r.status == LIVE]
        if self.cfg["routing"] == "prefix_affinity" and req is not None:
            return sorted(live, key=lambda r: (-r.prefix_tokens(
                req.prompt), r.load(), r.idx))
        return sorted(live, key=lambda r: (r.load(), r.idx))

    def _dispatch(self, req: Request) -> Optional[ReplicaHandle]:
        """Hand ``req`` to the best live replica; a transient
        ``serve.dispatch`` fault reroutes to the next-best instead of
        dropping. None = no replica accepted (caller sheds)."""
        t0 = self._clock()
        for r in self._ranked(req):
            try:
                fault.fire("serve.dispatch", replica=r.idx, uid=req.uid)
                self._beat_rpc(r)
                r.engine.submit(req)
            except ReplicaDeadError as e:
                # a process replica died under us: run the full death
                # protocol (salvage/migrate/redistribute/relaunch) now,
                # then keep looking for a home for THIS request
                self._on_replica_death(r, e)
                self.total_reroutes += 1
                continue
            except (fault.InjectedCrash, OSError, RpcError) as e:
                r.dispatch_faults += 1
                self.total_reroutes += 1
                logger.warning(f"fleet dispatch fault on replica "
                               f"{r.idx} (uid {req.uid}): {e!r}; "
                               f"rerouting")
                continue
            r.routed += 1
            # the trace spine: every placement writes one row tying
            # (trace_id, hop) to a replica, with the router-side route
            # cost. The fleet merger anchors each request's timeline
            # here — rpc_wire = replica's serve_submit.t (aligned)
            # minus this row's t.
            self._event("fleet_dispatch", uid=req.uid,
                        trace_id=getattr(req, "trace_id", None),
                        hop=getattr(req, "hop", 0), replica=r.idx,
                        route_ms=round((self._clock() - t0) * 1e3, 4))
            return r
        return None

    # ----------------------------------------------------------- submit
    def submit(self, request: Request) -> int:
        """Admit (or shed) one request; returns its uid either way —
        the response arrives through :meth:`step`/:meth:`run`."""
        self.total_submitted += 1
        # mint the trace context at the fleet's front door: one id per
        # client request, hop 0. Already-stamped requests (a caller
        # propagating an upstream trace) keep their id.
        if getattr(request, "trace_id", None) is None:
            request.trace_id = \
                f"{self._trace_prefix}-{next(self._trace_seq):06x}"
            request.hop = 0
        prio = getattr(request, "priority", 0)
        level = self.shed_level()
        self._apply_spec_degrade(level)
        sh = self.cfg["slo_shed"]
        if level >= 1 and prio < sh["shed_below_priority"]:
            _count, p95 = self._ttft_stats()
            self._shed(request, "shed_slo", p95_ttft_ms=p95,
                       budget_ms=self._budget_ms, level=level)
            return request.uid
        if level >= 2 and sh["degrade_max_new"] > 0 and \
                request.max_new_tokens > sh["degrade_max_new"]:
            # replace() preserves uid/seed — only the budget shrinks
            request = replace(request,
                              max_new_tokens=sh["degrade_max_new"])
            self.total_degraded += 1
            self._event("fleet_shed", uid=request.uid,
                        reason="degrade_max_new", priority=prio,
                        max_new_tokens=request.max_new_tokens)
        if self._dispatch(request) is None:
            self._shed(request, "shed_capacity",
                       live=[r.idx for r in self.replicas
                             if r.status == LIVE])
        return request.uid

    # ------------------------------------------------------------ drain
    def drain(self, replica: int, reason: str = "manual") -> None:
        """Software-preempt one replica (the SIGTERM-equivalent). The
        actual drain runs at the next :meth:`step`. Idempotent: a
        second drain of an already-draining (or retired) replica is a
        no-op — the episode must not restart, requests must not be
        redistributed twice."""
        r = self.replicas[replica]
        if r.status != LIVE:
            logger.info(f"fleet drain: replica {replica} already "
                        f"{r.status}; ignoring duplicate drain")
            return
        r.guard.trigger(reason)

    def _begin_drain(self, r: ReplicaHandle) -> None:
        if r.status != LIVE:
            return  # idempotency backstop (double trigger in one step)
        r.status = DRAINING
        r.drain_reason = r.guard.reason or "preempted"
        survivors = [s for s in self.replicas if s.status == LIVE]
        queued = list(r.engine.scheduler.queue)
        in_flight = len(r.engine.scheduler.active_slots())
        self._event("fleet_drain", phase="begin", replica=r.idx,
                    reason=r.drain_reason, queued=len(queued),
                    in_flight=in_flight,
                    survivors=[s.idx for s in survivors])
        logger.info(
            f"fleet drain: replica {r.idx} ({r.drain_reason}) — "
            f"{in_flight} in flight finish here, {len(queued)} queued "
            f"redistribute over {len(survivors)} survivors")
        if survivors and queued:
            for req in queued:
                # the cancel's serve_evict row (reason "drain") is
                # drain bookkeeping, not the client's answer —
                # _collect drops it; the SAME Request object (uid,
                # seed, budget) goes to a survivor, whose prefix cache
                # re-prefills it
                r.engine.cancel(req.uid, reason="drain")
                self.total_redistributed += 1
                if self._dispatch(req) is None:
                    self._shed(req, "shed_capacity",
                               drained_from=r.idx)
        if survivors:
            # in-flight requests: ship their live KV pages to a
            # survivor so decode resumes at the same cache_position —
            # no re-prefill, bitwise-identical outputs. Falls back to
            # finish-in-place when either side can't migrate.
            self._migrate_active(r)

    # -------------------------------------------------- live migration
    def _price_migration(self, rec) -> float:
        """LinkModel-priced wire cost of one migration (the disagg
        handoff price model, inter-host axis; ``engine.LinkModel`` holds
        the defaults of the JAX package's link model)."""
        try:
            if self._mig_link is None:
                from deepspeed_tpu_torch.inference.engine import LinkModel
                self._mig_link = LinkModel()
            return price_handoff(rec.live_pages, rec.page_bytes,
                                 self._mig_link, axis="inter")
        except Exception:  # noqa: BLE001 — pricing is advisory
            return 0.0

    def _place_migration(self, rec, source: ReplicaHandle) -> bool:
        """Import one exported request into the best live replica that
        can. True = resumed somewhere (``serve_migration`` trail row);
        False = the caller falls back to a full resubmit."""
        for t in self._ranked(None):
            if t is source or not getattr(t.engine, "can_migrate",
                                          False):
                continue
            t0 = self._clock()
            try:
                self._beat_rpc(t)
                sid = t.engine.import_request(rec)
            except (RpcError, OSError) as e:
                logger.warning(f"fleet migration: import of uid "
                               f"{rec.uid} into replica {t.idx} "
                               f"failed ({e!r})")
                continue
            if sid is None:
                continue  # target full or geometry mismatch; try next
            transfer_ms = (self._clock() - t0) * 1e3
            priced_ms = self._price_migration(rec)
            self.total_migrated += 1
            self.migration_bytes += rec.nbytes
            self.migration_priced_ms += priced_ms
            source.migrations_out += 1
            source.migration_bytes += rec.nbytes
            source.migration_priced_ms += priced_ms
            t.migrations_in += 1
            t.routed += 1
            self._event("serve_migration", uid=rec.uid,
                        trace_id=getattr(rec, "trace_id", None),
                        hop=getattr(rec, "hop", 0),
                        src=source.idx, dst=t.idx,
                        pages=rec.live_pages, nbytes=rec.nbytes,
                        position=rec.position,
                        transfer_ms=round(transfer_ms, 3),
                        priced_ms=round(priced_ms, 4))
            logger.info(
                f"fleet migration: uid {rec.uid} "
                f"{source.idx} -> {t.idx} ({rec.live_pages} pages, "
                f"{rec.nbytes} B, resumes at position {rec.position})")
            return True
        return False

    def _resubmit_record(self, rec, source: ReplicaHandle) -> None:
        """Migration fallback: rebuild the original Request (same uid,
        same seed — deterministic sampling gives the same answer, just
        re-decoded from a fresh prefill) and dispatch it."""
        req = Request(prompt=list(rec.prompt),
                      max_new_tokens=rec.max_new_tokens,
                      temperature=rec.temperature, seed=rec.seed,
                      eos_id=rec.eos_id, priority=rec.priority,
                      uid=rec.uid,
                      # resubmit is still a hop of the SAME trace —
                      # lineage survives even the fallback path
                      trace_id=getattr(rec, "trace_id", None),
                      hop=int(getattr(rec, "hop", 0)) + 1)
        self.total_redistributed += 1
        if self._dispatch(req) is None:
            self._shed(req, "shed_capacity", drained_from=source.idx)

    def _migrate_active(self, r: ReplicaHandle) -> None:
        """Move every in-flight request off ``r`` alive. Requires both
        sides warmed for migration (``engine.warm_migration``);
        otherwise in-flight work finishes where it is (in-process
        drain keeps its finish-in-place semantics)."""
        if not getattr(r.engine, "can_migrate", False):
            return
        for uid in r.active_uids():
            try:
                self._beat_rpc(r)
                rec = r.engine.export_request(uid)
            except (RpcError, OSError) as e:
                logger.warning(f"fleet migration: export of uid {uid} "
                               f"from replica {r.idx} failed ({e!r})")
                continue
            if rec is None:
                continue  # not exportable (no pending token yet)
            if not self._place_migration(rec, r):
                self._resubmit_record(rec, r)

    # ------------------------------------------------------------- step
    def _collect(self, fins: List[FinishedRequest]
                 ) -> List[FinishedRequest]:
        # "drain"/"migrate" evictions are router bookkeeping (the
        # request answers elsewhere), not the client's response
        return [f for f in fins
                if f.finish_reason not in ("drain", "migrate")]

    def step(self) -> List[FinishedRequest]:
        """One fleet scheduling round: react to preemptions, advance
        every serving replica one engine step, retire empty drains.
        Returns the requests that finished (shed responses included)."""
        out: List[FinishedRequest] = []
        out.extend(self._pending)
        self._pending = []
        if self.health is not None:
            self.health.heartbeat("fleet_step")
        for r in self.replicas:
            if r.status == RETIRED:
                continue
            try:
                # the per-replica preemption probe: a raised injection
                # preempts THIS replica (the env grammar's targeted
                # form); the "preempt" action instead flags installed
                # guards, exactly like a real SIGTERM
                fault.fire("serve.replica_preempt", replica=r.idx)
            except (fault.InjectedCrash, OSError) as e:
                r.guard.trigger(f"fault:{type(e).__name__}")
            if r.status == LIVE and r.guard.preempted:
                self._begin_drain(r)
        for r in self.replicas:
            if r.status == RETIRED:
                continue
            if not r.idle():
                try:
                    self._beat_rpc(r)
                    out.extend(self._collect(r.engine.step()))
                except ReplicaDeadError as e:
                    self._on_replica_death(r, e)
                    continue
            if r.status == DRAINING and r.idle():
                r.status = RETIRED
                self._event("fleet_drain", phase="complete",
                            replica=r.idx, reason=r.drain_reason)
                logger.info(f"fleet drain: replica {r.idx} retired")
        self._apply_spec_degrade(self.shed_level())
        self._autoscale_tick()
        self._steps += 1
        if self._steps % self._STATE_EVERY == 0:
            self._write_telemetry()
        if self._steps % self._CLOCK_SYNC_EVERY == 0:
            self._sync_clocks()
        return out

    # ------------------------------------------------ death supervision
    def _on_replica_death(self, r: ReplicaHandle,
                          err: ReplicaDeadError) -> None:
        """A replica's channel died mid-step. In order: mark it gone,
        salvage its flight recorder, resume its exported in-flight
        requests on survivors (live pages, bitwise-preserving),
        redistribute everything else it owed (same uids/seeds), then
        maybe relaunch it under the launcher's restart policy."""
        r.status = RETIRED
        reason = getattr(err, "reason", None) or str(err)
        r.drain_reason = f"died:{reason}"
        poll = getattr(r.engine, "poll_exit", None)
        code = poll() if poll is not None else None
        r.last_exit_code = code
        exports = list(getattr(err, "exports", None) or [])
        self._event("fleet_replica_death", replica=r.idx,
                    reason=reason, exit_code=code,
                    exports=len(exports))
        logger.warning(
            f"fleet: replica {r.idx} died ({reason}, exit={code}); "
            f"{len(exports)} in-flight exports to place")
        # 1) the black box: the dead child's flight_serve.json becomes
        #    a row in OUR trail — the postmortem survives the process
        flight_path = getattr(r.engine, "flight_path", None)
        flight = load_flight(flight_path) if flight_path else None
        if flight is not None:
            self.total_salvaged += 1
            self._event(
                "fleet_flight_salvage", replica=r.idx,
                flight=str(flight_path),
                trigger=flight.get("trigger"),
                dead_pid=flight.get("pid"),
                dead_reason=flight.get("reason"),
                rows=len(flight.get("rows") or []))
            logger.info(f"fleet: salvaged flight recorder of replica "
                        f"{r.idx} ({flight_path})")
        # 2) deathbed exports: resume each on a survivor at the same
        #    cache_position; full resubmit only if no one can import
        for rec in exports:
            if not self._place_migration(rec, r):
                self._resubmit_record(rec, r)
        # 3) everything else the dead child owed (queued backlog +
        #    in-flight it could not export): redistribute
        orphans = getattr(r.engine, "orphans", None)
        for req in (orphans() if orphans is not None else []):
            self.total_redistributed += 1
            if self._dispatch(req) is None:
                self._shed(req, "shed_capacity", drained_from=r.idx)
        # 4) supervised relaunch — the launcher's restart policy
        #    decides (85/87 restart-eligible, anything else gives up)
        self._maybe_relaunch(r, code)

    def _maybe_relaunch(self, r: ReplicaHandle,
                        code: Optional[int]) -> None:
        relaunch = getattr(r.engine, "relaunch", None)
        if relaunch is None:
            return
        pm = self.cfg["process_mode"]
        if not restart_eligible(code):
            self._event("fleet_replica_restart", replica=r.idx,
                        decision="give_up", exit_code=code)
            logger.warning(f"fleet: replica {r.idx} exit code {code} "
                           f"not restart-eligible; staying retired")
            return
        if r.restarts >= pm["max_restarts"]:
            self._event("fleet_replica_restart", replica=r.idx,
                        decision="exhausted", exit_code=code,
                        restarts=r.restarts)
            logger.warning(f"fleet: replica {r.idx} restart budget "
                           f"exhausted ({r.restarts})")
            return
        delay = pm["restart_backoff_s"] * (2 ** r.restarts)
        if delay > 0:
            self._sleep(delay)
        try:
            relaunch()
        except Exception as e:  # noqa: BLE001 — a failed relaunch retires
            self._event("fleet_replica_restart", replica=r.idx,
                        decision="failed", exit_code=code,
                        error=f"{type(e).__name__}: {e}")
            logger.warning(
                f"fleet: replica {r.idx} relaunch failed ({e!r})")
            return
        r.restarts += 1
        r.status = LIVE
        r.drain_reason = None
        r.guard = PreemptionGuard()
        self.total_restarts += 1
        self._event("fleet_replica_restart", replica=r.idx,
                    decision="restarted", exit_code=code,
                    restarts=r.restarts, backoff_s=delay,
                    pid=getattr(r.engine, "pid", None))
        logger.info(f"fleet: replica {r.idx} relaunched "
                    f"(restart {r.restarts}, backoff {delay:g}s)")
        # the fresh child is a fresh clock — re-estimate its offset so
        # post-restart rows still align on the merged timeline
        self._sync_clocks()

    # -------------------------------------------------------- autoscale
    def _autoscale_tick(self) -> None:
        """Goodput-driven fleet sizing, evaluated once per router step:
        sustained rung-1+ shedding spawns a replica (needs the
        ``replica_factory`` hook), sustained idleness drains the
        least-loaded one via live migration. Hysteresis (patience
        streaks) + cooldown keep it from flapping; never below
        ``min_replicas``, never above ``max_replicas``, never a
        dropped request."""
        asc = self.cfg["autoscale"]
        if not asc["enabled"]:
            return
        if self._as_cooldown > 0:
            self._as_cooldown -= 1
            return
        live = [r for r in self.replicas if r.status == LIVE]
        busy = self.fleet_queue_depth() > 0 or any(
            len(r.engine.scheduler.active_slots()) > 0 for r in live)
        if self.shed_level() >= 1:
            self._shed_streak += 1
        else:
            self._shed_streak = 0
        self._idle_streak = 0 if busy else self._idle_streak + 1
        if (self._shed_streak >= asc["scale_up_patience"]
                and len(live) < asc["max_replicas"]
                and self._factory is not None):
            idx = len(self.replicas)
            try:
                engine = self._factory(idx)
            except Exception as e:  # noqa: BLE001 — spawn can flake
                logger.warning(f"fleet autoscale: spawn failed ({e!r})")
                self._shed_streak = 0
                return
            self.replicas.append(
                ReplicaHandle(idx, engine, PreemptionGuard()))
            self._event("fleet_autoscale", action="up", replica=idx,
                        live=len(live) + 1,
                        shed_streak=self._shed_streak)
            logger.info(f"fleet autoscale: spawned replica {idx} "
                        f"(shed streak {self._shed_streak})")
            self._shed_streak = 0
            self._as_cooldown = asc["cooldown_steps"]
            return
        if (self._idle_streak >= asc["scale_down_patience"]
                and len(live) > asc["min_replicas"]):
            # least-loaded; ties retire the newest replica first
            victim = min(live, key=lambda r: (r.load(), -r.idx))
            self._event("fleet_autoscale", action="down",
                        replica=victim.idx, live=len(live) - 1,
                        idle_streak=self._idle_streak)
            logger.info(f"fleet autoscale: draining replica "
                        f"{victim.idx} (idle streak "
                        f"{self._idle_streak})")
            victim.guard.trigger("autoscale")
            self._idle_streak = 0
            self._as_cooldown = asc["cooldown_steps"]

    def idle(self) -> bool:
        return not self._pending and all(
            r.status == RETIRED or r.idle() for r in self.replicas)

    def run(self) -> List[FinishedRequest]:
        """Serve until every admitted request has answered (the fleet
        analog of ``engine.run``; responses in completion order)."""
        out: List[FinishedRequest] = []
        while not self.idle():
            out.extend(self.step())
        out.extend(self._pending)
        self._pending = []
        self._write_telemetry()
        return out

    # ------------------------------------------------ live weight swap
    def swap_weights(self, load_dir: str, tag: Optional[str] = None
                     ) -> Dict[int, Optional[str]]:
        """Push a committed checkpoint tag into every serving replica
        between dispatches. Per replica atomic-or-rollback: a failed
        load (bad tag, I/O flake, injected ``serve.swap_load``) leaves
        THAT replica serving its old weights and still live — the
        result maps replica -> new version (None = rolled back)."""
        verify = self.cfg["swap"]["verify_integrity"]
        results: Dict[int, Optional[str]] = {}
        for r in self.replicas:
            if r.status == RETIRED:
                continue
            try:
                results[r.idx] = r.engine.swap_params(
                    load_dir, tag=tag, verify_integrity=verify)
            except Exception as e:
                results[r.idx] = None
                logger.warning(
                    f"fleet swap: replica {r.idx} rolled back "
                    f"({e!r}); still serving "
                    f"{getattr(r.engine, 'weight_version', '?')}")
        self._event("fleet_swap_push", load_dir=str(load_dir), tag=tag,
                    versions={str(k): v for k, v in results.items()},
                    rolled_back=[k for k, v in results.items()
                                 if v is None])
        return results

    # -------------------------------------------------------- telemetry
    @property
    def shed_rate(self) -> float:
        return (self.total_shed / self.total_submitted
                if self.total_submitted else 0.0)

    def fleet_queue_depth(self) -> int:
        return sum(r.engine.scheduler.queue_depth for r in self.replicas
                   if r.status != RETIRED)

    def debug_state(self) -> Dict[str, Any]:
        """Host-only fleet introspection (mirrors the periodic
        ``fleet_state`` event row obs_report renders)."""
        count, p95 = self._ttft_stats()
        return {
            "routing": self.cfg["routing"],
            "steps": self._steps,
            "replicas": [r.snapshot() for r in self.replicas],
            "fleet_queue_depth": self.fleet_queue_depth(),
            "submitted": self.total_submitted,
            "shed": {"total": self.total_shed,
                     "rate": round(self.shed_rate, 4),
                     "by_reason": dict(self.shed_by_reason),
                     "by_priority": {str(k): v for k, v in
                                     self.shed_by_priority.items()},
                     "degraded": self.total_degraded,
                     "spec_degraded": self._spec_degraded,
                     "level": self.shed_level()},
            "slo": {"p95_ttft_ms": p95, "samples": count,
                    "budget_ms": self._budget_ms},
            "redistributed": self.total_redistributed,
            "reroutes": self.total_reroutes,
            "migrations": {"total": self.total_migrated,
                           "bytes": self.migration_bytes,
                           "priced_ms": round(self.migration_priced_ms,
                                              4)},
            "restarts": self.total_restarts,
            "salvaged_flights": self.total_salvaged,
        }

    def _write_telemetry(self) -> None:
        self._event("fleet_state", step=self._steps,
                    **self.debug_state())
        for r in self.replicas:
            # one per-replica process-health row (pid, restarts, exit
            # code, migration ledger) — obs_report's fleet table
            self._event("fleet_replica_state", step=self._steps,
                        **r.process_snapshot())
        if self.monitor is None or not hasattr(
                self.monitor, "write_serving_metrics"):
            return
        tokens = sum(r.engine.scheduler.total_tokens
                     for r in self.replicas)
        self.monitor.write_serving_metrics(
            shed_rate=self.shed_rate,
            fleet_queue_depth=self.fleet_queue_depth(),
            migrations=self.total_migrated,
            replica_restarts=self.total_restarts,
            tokens=tokens)

    # ---------------------------------------------------------- cleanup
    def close(self) -> None:
        """Uninstall guards and close every engine (final ``fleet_state``
        first, so the run report sees the fleet's last shape)."""
        self._write_telemetry()
        for r in self.replicas:
            r.guard.uninstall()
            close = getattr(r.engine, "close", None)
            if close is not None:
                close()
        self._log = None
