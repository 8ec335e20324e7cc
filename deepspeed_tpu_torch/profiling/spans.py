"""Structured trace spans: one context manager, two sinks (the port of
``deepspeed_tpu/profiling/spans.py``).

``trace_span("serve/decode")`` emits
- a ``torch.profiler.record_function`` range — the span shows up inside
  a captured ``torch.profiler`` trace, on the host timeline above the
  kernels it launched; and
- a Chrome-trace JSON "complete" event into a
  :class:`ChromeTraceRecorder` — loadable in ``chrome://tracing`` /
  Perfetto without capturing a profiler trace.

The recorder is host wall-clock only (no device sync): spans measure
dispatch-side phase structure unless the wrapped code synchronises.
"""

import json
import os
import threading
import time
from contextlib import contextmanager
from typing import List, Optional

from torch.profiler import record_function

__all__ = ["ChromeTraceRecorder", "trace_span"]


class ChromeTraceRecorder:
    """Accumulates Chrome-trace 'X' (complete) events; ``dump(path)``
    writes the standard ``{"traceEvents": [...]}`` container.

    The buffer is bounded (``max_events``, oldest dropped first, with a
    count of what was shed) so a multi-day run cannot grow host memory
    without limit."""

    def __init__(self, max_events: int = 100_000):
        self.events: List[dict] = []
        self.max_events = int(max_events)
        self.dropped = 0
        self._lock = threading.Lock()
        self._origin = time.perf_counter()
        self._lanes: set = set()

    def _append(self, *evs: dict) -> None:
        """Append under the lock, then shed past ``max_events`` (oldest
        first, count kept in ``dropped``)."""
        with self._lock:
            self.events.extend(evs)
            if len(self.events) > self.max_events:
                shed = len(self.events) - self.max_events
                del self.events[:shed]
                self.dropped += shed

    def add(self, name: str, t0: float, t1: float, **extra) -> None:
        ev = {"name": name, "ph": "X", "cat": "deepspeed_tpu",
              "ts": (t0 - self._origin) * 1e6,       # chrome wants µs
              "dur": max(t1 - t0, 0.0) * 1e6,
              "pid": os.getpid(), "tid": threading.get_ident()}
        if extra:
            ev["args"] = extra
        self._append(ev)

    # the lane-id memo only suppresses duplicate thread_name metadata
    # rows; past this many distinct lanes it resets
    _LANES_CAP = 10_000

    def add_lane(self, lane: int, lane_name: str, name: str,
                 t0: float, t1: float, **extra) -> None:
        """A complete event on a NAMED virtual lane (``tid = lane``)
        instead of the calling thread — the serving tracer draws each
        request's phases on its own per-request lane. The first event on
        a lane also emits the ``thread_name`` metadata row."""
        lane = int(lane)
        ev = {"name": name, "ph": "X", "cat": "deepspeed_tpu/serve",
              "ts": (t0 - self._origin) * 1e6,
              "dur": max(t1 - t0, 0.0) * 1e6,
              "pid": os.getpid(), "tid": lane}
        if extra:
            ev["args"] = extra
        if lane not in self._lanes:
            if len(self._lanes) >= self._LANES_CAP:
                self._lanes.clear()
            self._lanes.add(lane)
            self._append(
                {"name": "thread_name", "ph": "M",
                 "pid": os.getpid(), "tid": lane,
                 "args": {"name": lane_name}}, ev)
        else:
            self._append(ev)

    def dump(self, path: str) -> str:
        with self._lock:
            payload = {"traceEvents": list(self.events),
                       "displayTimeUnit": "ms"}
            if self.dropped:
                payload["otherData"] = {
                    "dropped_events": self.dropped,
                    "note": "oldest events shed by the bounded buffer"}
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)  # readable mid-run, never half-written
        return path


@contextmanager
def trace_span(name: str, recorder: Optional[ChromeTraceRecorder] = None,
               **extra):
    """Context manager wrapping a phase in both sinks (the recorder only
    when one is given)."""
    t0 = time.perf_counter()
    try:
        with record_function(name):
            yield
    finally:
        if recorder is not None:
            recorder.add(name, t0, time.perf_counter(), **extra)
