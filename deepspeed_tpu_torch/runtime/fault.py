"""Fault injection for checkpoint durability (the port of the part of
``deepspeed_tpu/runtime/fault.py`` that checkpoints need).

Production code calls ``fire("<point>")`` at named fault points, a no-op
unless a test armed that point; tests arm points to simulate torn
writes, a crash after a shard, transient ``OSError`` flakes and flipped
bits, then prove that a resume survives. The points, with the JAX
package's names:

- ``io_write``                : inside every atomic file write, before any
                                bytes reach the disk (arm with ``OSError``
                                for a transient flake; retried)
- ``ckpt.snapshot``           : at the start of every save: kill here and
                                nothing of the save exists on disk
- ``ckpt.after_shard``        : after one tree's shard files are written
                                (ctx: ``name``)
- ``ckpt.before_marker``      : all shards and meta written, COMMITTED not
- ``ckpt.before_rename``      : COMMITTED written, the staging dir not yet
                                renamed
- ``ckpt.latest_tmp_written`` : ``latest.tmp`` durable, ``os.replace`` not
                                yet run: the torn-pointer window
- ``serve.swap_load``         : in ``InferenceEngine.swap_params``, after
                                the tag's pre-flight and before the load
- ``serve.replica_preempt``   : once per live replica per router step
                                (ctx: ``replica``): a raised injection
                                preempts that replica
- ``serve.dispatch``          : in the router's dispatch of one request to
                                its chosen replica (ctx: ``replica``,
                                ``uid``): the request is rerouted
- ``rpc.transport``           : at the top of every RPC call attempt
                                (ctx: ``method``, ``name``): surfaces as
                                ``RpcTransportError``, retried
- ``rpc.timeout``             : same site, surfaces as ``RpcTimeoutError``
- ``rpc.replica_dead``        : same site, surfaces as ``ReplicaDeadError``
- ``serve.replica_kill``      : in the replica worker's step handler, only
                                while a request is mid-decode (ctx:
                                ``pid``): ``crash`` runs the deathbed
                                (export live pages, dump the flight
                                recorder, exit 85)

``retry_io`` retries ``OSError`` with exponential backoff, never
``InjectedCrash``: a simulated process death must kill the save.

Env-armed injections (``DSTPU_FAULT_ARM``): a relaunched process, which
no in-process test can reach, arms itself from its environment (a
replica worker at start, a fleet router at construction). Grammar
(comma-separated)::

    point:action[:times][@once_file]

with actions ``crash`` (raise InjectedCrash), ``oserror`` (raise
OSError), ``sigterm`` (deliver a real SIGTERM to this process),
``preempt`` (flag the installed PreemptionGuards through
``elastic.request_preemption``) and ``stall`` (sleep
``DSTPU_FAULT_STALL_S`` seconds, default 30, inside the fault point,
wedging the caller past the health watchdog's timeout). ``@once_file``
makes the arm one-shot across processes: the spec arms only while the
file exists and the first fire deletes it.
"""

import os
import time
import zlib
from typing import Any, Callable, Dict, List, Optional

__all__ = ["InjectedCrash", "FaultInjector", "get_injector", "fire", "arm",
           "reset", "retry_io", "flip_byte", "truncate_file", "crc32_file",
           "arm_from_env", "ENV_ARM"]

ENV_ARM = "DSTPU_FAULT_ARM"


class InjectedCrash(Exception):
    """Simulated process death at a named fault point. Not an
    ``OSError``, so the retry wrapper never swallows it."""


class FaultInjector:
    """Registry of armed fault points. ``arm(point, ...)`` installs an
    action; ``fire(point, **ctx)`` is a no-op unless that point is armed.
    An armed point fires at most ``times`` times (None: unlimited), and
    only when ``filter(**ctx)`` (if given) is truthy."""

    def __init__(self):
        self._arms: Dict[str, Dict[str, Any]] = {}

    def arm(self, point: str, *, exc: Optional[BaseException] = None,
            times: Optional[int] = 1,
            callback: Optional[Callable[..., None]] = None,
            filter: Optional[Callable[..., bool]] = None) -> None:
        """Arm ``point`` to raise ``exc`` (class or instance) and/or run
        ``callback(**ctx)`` the next ``times`` matching fires."""
        if exc is None and callback is None:
            raise ValueError("arm() needs exc and/or callback")
        self._arms[point] = {"exc": exc, "times": times, "fired": 0,
                             "callback": callback, "filter": filter}

    def fire(self, point: str, **ctx) -> None:
        spec = self._arms.get(point)
        if spec is None:
            return
        if spec["times"] is not None and spec["fired"] >= spec["times"]:
            return
        if spec["filter"] is not None and not spec["filter"](**ctx):
            return
        spec["fired"] += 1
        if spec["callback"] is not None:
            spec["callback"](**ctx)
        exc = spec["exc"]
        if exc is not None:
            raise exc if isinstance(exc, BaseException) else exc()

    def fired(self, point: str) -> int:
        """How many times an armed point has fired."""
        spec = self._arms.get(point)
        return 0 if spec is None else spec["fired"]

    def reset(self) -> None:
        self._arms.clear()


_INJECTOR = FaultInjector()


def get_injector() -> FaultInjector:
    return _INJECTOR


def fire(point: str, **ctx) -> None:
    """Production-side hook: a no-op unless a test armed ``point``."""
    _INJECTOR.fire(point, **ctx)


def arm(point: str, **kw) -> None:
    _INJECTOR.arm(point, **kw)


def reset() -> None:
    _INJECTOR.reset()


def retry_io(fn: Callable[[], Any], *, retries: int = 3,
             backoff: float = 0.05,
             sleep: Callable[[float], None] = time.sleep) -> Any:
    """Run ``fn``, retrying a transient ``OSError`` with exponential
    backoff; ``retries`` counts the attempts after the first.
    ``InjectedCrash`` (and any other exception) propagates at once."""
    attempt = 0
    while True:
        try:
            return fn()
        except InjectedCrash:
            raise
        except OSError:
            if attempt >= retries:
                raise
            sleep(backoff * (2 ** attempt))
            attempt += 1


# ---------------------------------------------------------------------
# env-armed injections: fault a process reachable only by its environment
# ---------------------------------------------------------------------

def _env_action(name: str, point: str) -> Callable[..., None]:
    if name == "crash":
        def act(**ctx):
            raise InjectedCrash(point)
    elif name == "oserror":
        def act(**ctx):
            raise OSError(f"injected transient failure at {point}")
    elif name == "sigterm":
        def act(**ctx):
            import signal
            os.kill(os.getpid(), signal.SIGTERM)
    elif name == "preempt":
        def act(**ctx):
            from deepspeed_tpu_torch.runtime import elastic
            elastic.request_preemption(f"env-armed fault at {point}")
    elif name == "stall":
        def act(**ctx):
            # wedge the caller itself (not a side thread): the health
            # watchdog must see a silent step loop
            time.sleep(float(os.environ.get("DSTPU_FAULT_STALL_S",
                                            "30")))
    else:
        raise ValueError(
            f"{ENV_ARM}: unknown action {name!r} (want crash | oserror "
            f"| sigterm | preempt | stall)")
    return act


# the process-wide latch of the no-argument call: arming is per process,
# not per component (a second arming would reset the fired count and
# turn a `times:1` spec into once per component). reset() keeps it.
_ENV_ARMED = False


def arm_from_env(env=None) -> List[str]:
    """Arm fault points from ``DSTPU_FAULT_ARM`` (module docstring).

    With ``env=None`` (the production call) it arms at most once per
    process. Returns the points armed (empty when the variable is unset
    or the process already armed). A malformed spec raises
    ``ValueError``: a silently ignored arm would let a fault test pass
    without its fault."""
    global _ENV_ARMED
    if env is None:
        if _ENV_ARMED:
            return []
        _ENV_ARMED = True
    env = os.environ if env is None else env
    raw = env.get(ENV_ARM, "").strip()
    if not raw:
        return []
    armed: List[str] = []
    for spec in raw.split(","):
        spec = spec.strip()
        if not spec:
            continue
        once_file = None
        if "@" in spec:
            spec, once_file = spec.split("@", 1)
        parts = spec.split(":")
        if len(parts) < 2:
            raise ValueError(
                f"{ENV_ARM}: bad spec {spec!r} (want "
                "point:action[:times][@once_file])")
        point, action = parts[0], parts[1]
        times = int(parts[2]) if len(parts) > 2 else 1
        if once_file is not None and not os.path.exists(once_file):
            continue  # one-shot already used by an earlier process
        act = _env_action(action, point)

        def callback(_act=act, _once=once_file, **ctx):
            if _once is not None:
                try:
                    os.remove(_once)
                except OSError:
                    pass
            _act(**ctx)

        _INJECTOR.arm(point, callback=callback,
                      times=None if times <= 0 else times)
        armed.append(point)
    return armed


def crc32_file(path: str, chunk_bytes: int = 1 << 20) -> int:
    """Streaming CRC32 of a file's bytes (the COMMITTED marker's
    per-file checksum)."""
    crc = 0
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk_bytes)
            if not block:
                break
            crc = zlib.crc32(block, crc)
    return crc & 0xFFFFFFFF


def flip_byte(path: str, offset: Optional[int] = None) -> int:
    """XOR one byte in place (default: the middle of the file), silent
    media corruption. Returns the offset flipped."""
    size = os.path.getsize(path)
    if size == 0:
        raise ValueError(f"cannot flip a byte of empty file {path}")
    if offset is None:
        offset = size // 2
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0xFF]))
    return offset


def truncate_file(path: str, keep_bytes: Optional[int] = None) -> None:
    """Cut a file short (default: to half), a torn write."""
    size = os.path.getsize(path)
    if keep_bytes is None:
        keep_bytes = size // 2
    with open(path, "r+b") as f:
        f.truncate(keep_bytes)
