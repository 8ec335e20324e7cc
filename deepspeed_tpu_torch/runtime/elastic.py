"""Preemption plumbing (the port of ``deepspeed_tpu/runtime/elastic.py``):
signal capture, the graceful-drain contract and the resumable exit code
a supervisor keys on.

- :class:`PreemptionGuard` installs SIGTERM/SIGINT handlers that only
  *flag* the preemption; the work in flight always finishes. Whoever
  owns the guard checks the flag at its own boundary (a serving replica
  at its next step) and drains there.
- :class:`Preempted` subclasses ``SystemExit`` carrying
  :data:`RESUMABLE_EXIT_CODE`, so an unhandled drain exits the process
  with the code the supervisor restarts on, while a caller can still
  catch it.
- :func:`request_preemption` is the software trigger: it flags every
  installed guard without a real signal, which is what makes the drain
  path testable in-process and drivable from ``fault.py``'s env-armed
  injections across a real process boundary.

Standard library only: ``launcher/runner.py`` reads
:data:`RESUMABLE_EXIT_CODE`, and the module must be importable inside a
signal handler's context without touching the device.
"""

import os
import signal
import threading
from typing import Optional, Tuple

__all__ = [
    "RESUMABLE_EXIT_CODE", "RESTART_COUNT_ENV", "Preempted",
    "PreemptionGuard", "request_preemption", "restart_count",
]

# Distinguished "preempted after a clean drain, relaunch me" exit code.
# Anything else nonzero is a genuine failure the supervisor gives up on.
# 85 collides with no shell or POSIX convention (1/2 generic, 126/127
# exec errors, 128+N killed by a signal): an *uncaught* SIGTERM exits
# 143, so the supervisor can tell a drained preemption from a kill that
# outran the drain.
RESUMABLE_EXIT_CODE = 85

# The supervisor exports the attempt number to the relaunched process.
RESTART_COUNT_ENV = "DSTPU_RESTART_COUNT"

DEFAULT_SIGNALS = (signal.SIGTERM, signal.SIGINT)


class Preempted(SystemExit):
    """Raised at a step boundary after a graceful preemption drain.

    Subclasses ``SystemExit`` with :data:`RESUMABLE_EXIT_CODE`, so the
    default outcome of a drain is a process exit the supervisor
    recognizes as resumable; ``step``/``tag``/``reason`` let a catching
    caller see what was committed before the exit.
    """

    def __init__(self, step: Optional[int] = None,
                 tag: Optional[str] = None, reason: str = "signal"):
        super().__init__(RESUMABLE_EXIT_CODE)
        self.step = step
        self.tag = tag
        self.reason = reason

    def __str__(self):
        return (f"preempted ({self.reason}) at step {self.step}; "
                f"checkpoint tag={self.tag!r}; exit "
                f"{RESUMABLE_EXIT_CODE}")


# guards that see a software-triggered preemption
# (request_preemption / fault.py's "preempt" env action)
_GUARDS_LOCK = threading.Lock()
_INSTALLED_GUARDS = []


class PreemptionGuard:
    """Latches a preemption request (signal or software) for its owner
    to act on at the next step boundary.

    The handler does nothing but set a flag: the drain runs in ordinary
    code, never inside the handler. ``install()`` replaces the previous
    handlers and remembers them; ``uninstall()`` restores them, so a
    guard never outlives its owner.
    """

    def __init__(self, signals: Tuple = DEFAULT_SIGNALS):
        self.signals = tuple(signals)
        self._event = threading.Event()
        self._reason: Optional[str] = None
        self._prev = {}
        self.installed = False

    # ------------------------------------------------------------ state
    @property
    def preempted(self) -> bool:
        return self._event.is_set()

    @property
    def reason(self) -> Optional[str]:
        return self._reason

    def trigger(self, reason: str = "software") -> None:
        """Flag a preemption without a real signal."""
        if self._reason is None:
            self._reason = reason
        self._event.set()

    def clear(self) -> None:
        self._event.clear()
        self._reason = None

    # ---------------------------------------------------- signal wiring
    def _handler(self, signum, frame):
        del frame
        try:
            name = signal.Signals(signum).name
        except ValueError:
            name = f"signal {signum}"
        self.trigger(name)

    def install(self) -> bool:
        """Install the signal handlers; returns False (the guard still
        works through :meth:`trigger`) when not on the main thread, where
        CPython refuses ``signal.signal``."""
        if self.installed:
            return True
        try:
            for s in self.signals:
                self._prev[s] = signal.signal(s, self._handler)
        except ValueError:
            # not the main thread: roll back any handler already set;
            # the software trigger still works
            for s, prev in self._prev.items():
                try:
                    signal.signal(s, prev)
                except ValueError:
                    pass
            self._prev.clear()
            with _GUARDS_LOCK:
                if self not in _INSTALLED_GUARDS:
                    _INSTALLED_GUARDS.append(self)
            return False
        self.installed = True
        with _GUARDS_LOCK:
            if self not in _INSTALLED_GUARDS:
                _INSTALLED_GUARDS.append(self)
        return True

    def uninstall(self) -> None:
        if self.installed:
            for s, prev in self._prev.items():
                try:
                    signal.signal(s, prev)
                except (ValueError, OSError):
                    pass
            self._prev.clear()
            self.installed = False
        with _GUARDS_LOCK:
            if self in _INSTALLED_GUARDS:
                _INSTALLED_GUARDS.remove(self)

    def __enter__(self):
        self.install()
        return self

    def __exit__(self, *exc):
        self.uninstall()
        return False


def request_preemption(reason: str = "software") -> int:
    """Software preemption trigger: flag every installed guard (no real
    signal involved). Returns how many guards were flagged. ``fault.py``'s
    ``preempt`` env action calls it, so a relaunched subprocess can be
    preempted deterministically."""
    with _GUARDS_LOCK:
        guards = list(_INSTALLED_GUARDS)
    for g in guards:
        g.trigger(reason)
    return len(guards)


def restart_count(env=None) -> int:
    """The supervisor-exported restart attempt number (0 on a first
    launch or outside a supervisor)."""
    env = os.environ if env is None else env
    try:
        return max(0, int(env.get(RESTART_COUNT_ENV, "0")))
    except (TypeError, ValueError):
        return 0
