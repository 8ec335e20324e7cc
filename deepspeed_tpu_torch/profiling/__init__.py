"""Profiling and telemetry for training (the port of
``deepspeed_tpu/profiling/__init__.py``).

One opt-in config section (``observability: {}``) wires three probes
through the engine:

- **FLOPs/MFU** (:mod:`.flops`): one micro-step counted under
  ``FlopCounterMode``, the attention kernels adding their walked cells,
  and MFU against a peak registry;
- **memory watermarks** (:mod:`.memory`): the CUDA allocator's bytes at
  step boundaries, with per-step deltas and a run peak (host RSS off the
  card);
- **trace spans** (:mod:`.spans`): ``trace_span("forward")`` shows in a
  ``torch.profiler`` trace and in a standalone Chrome-trace JSON.

Everything lands as ``(tag, value, step)`` scalars on the monitor and in
the JSONL event log (``events.jsonl``) that ``tools/obs_report.py``
reads, with the JAX package's tag strings; the x-axis is cumulative
samples.

Deliberate differences from the JAX package: there is no
``CompileTracker`` (eager PyTorch compiles nothing), so no ``compile`` or
``compile_summary`` events and no ``Observability/recompiles``,
``compile_ms_total`` or ``dispatches`` scalars; and no
``Observability/bytes_accessed`` (no torch counterpart of XLA's byte
count).
"""

import os
from typing import Any, Dict, Optional, Tuple

from deepspeed_tpu_torch.profiling.flops import (FlopsProfile, compute_mfu,
                                                 format_profile,
                                                 peak_flops_per_device,
                                                 profile_step)
from deepspeed_tpu_torch.profiling.memory import (MemoryWatermark,
                                                  memory_snapshot)
from deepspeed_tpu_torch.profiling.spans import (ChromeTraceRecorder,
                                                 trace_span)
from deepspeed_tpu_torch.utils.logging import log_dist, logger

__all__ = [
    "Observer", "FlopsProfile", "MemoryWatermark", "memory_snapshot",
    "ChromeTraceRecorder", "trace_span", "compute_mfu",
    "peak_flops_per_device", "profile_step",
]

# scalar tags (the JAX package's strings, which tools/obs_report.py reads)
TAG_FLOPS = "Observability/flops_per_step"
TAG_MFU = "Observability/mfu"
TAG_MEM_IN_USE = "Memory/bytes_in_use"
TAG_MEM_PEAK = "Memory/peak_bytes_in_use"
TAG_MEM_DELTA = "Memory/step_delta_bytes"
TAG_HOST_SYNCS = "Observability/host_syncs"
TAG_HOST_GAP = "Observability/host_gap_ms"


class Observer:
    """Engine-facing facade over the probes.

    Construction is cheap and always succeeds; when ``enabled`` is False
    every method is a no-op or a passthrough, so the engine wires it
    unconditionally.
    Instrumentation failures degrade to warnings: observability never
    takes down a training step."""

    def __init__(self, cfg: Dict[str, Any], monitor=None, device=None,
                 num_devices: Optional[int] = None):
        self.cfg = cfg
        self.monitor = monitor
        self.enabled = bool(cfg.get("enabled"))
        self._device = device
        self._num_devices = num_devices or 1
        self._log = None
        self.memory: Optional[MemoryWatermark] = None
        self.recorder: Optional[ChromeTraceRecorder] = None
        self.flops_profiles: Dict[str, FlopsProfile] = {}
        self._pending_profile: Optional[FlopsProfile] = None
        self._closed = False
        if not self.enabled:
            return

        events_dir = cfg.get("events_dir") or "/tmp/deepspeed_tpu_obs"
        try:
            from deepspeed_tpu_torch.utils.monitor import _JsonlWriter
            self._log = _JsonlWriter(
                events_dir, max_mb=cfg.get("events_max_mb", 0) or 0)
        except Exception as e:
            logger.warning(f"observability: event log unavailable "
                           f"({e}); scalars go to the monitor only")
        # every monitor scalar (loss, lr, step time) goes into the event
        # log too, so obs_report sees one record even with tensorboard off
        if self.monitor is not None and self._log is not None:
            self.monitor.mirror = self._log
        if cfg.get("memory_watermarks", True):
            self.memory = MemoryWatermark(device)
        self.recorder = ChromeTraceRecorder()
        self._chrome_path = cfg.get("chrome_trace_path") or None
        self._chrome_last_dump = 0.0  # monotonic secs; 0 = never dumped
        # the engine has no shutdown hook; close() (idempotent) writes the
        # final chrome trace at interpreter exit
        import atexit
        atexit.register(self.close)
        log_dist(f"observability: enabled (events -> "
                 f"{os.path.join(events_dir, 'events.jsonl')})", ranks=[0])

    # ------------------------------------------------------------ sinks
    def scalar(self, tag: str, value, step: int) -> None:
        """One (tag, value, step) record to monitor + event log."""
        if not self.enabled:
            return
        if self.monitor is not None:
            self.monitor.write_scalar(tag, value, step)
        elif self._log is not None:
            self._log.add_scalar(tag, value, step)

    def event(self, kind: str, **fields) -> None:
        """One structured (non-scalar) event row in the JSONL log."""
        if self._log is not None:
            self._log.add_event(kind, **fields)

    # ------------------------------------------------------------ probes
    def span(self, name: str, **extra):
        """Phase span: a ``torch.profiler`` range always, a Chrome-trace
        event when enabled."""
        return trace_span(name, recorder=self.recorder, **extra)

    def wants_flops_profile(self, name: str) -> bool:
        return (self.enabled and bool(self.cfg.get("flops_profiler", True))
                and name not in self.flops_profiles)

    def maybe_profile_flops(self, name: str, fn, args: Tuple = ()):
        """Run ``fn(*args)``, counting its FLOPs the first time ``name``
        is asked for (:func:`profile_step`). Returns ``fn``'s result; the
        scalar and the ``flops_profile`` event follow from
        :meth:`record_flops`, once the step's samples are known."""
        if not self.wants_flops_profile(name):
            return fn(*args)
        try:
            result, prof = profile_step(fn, args, name=name,
                                        device=self._device,
                                        num_devices=self._num_devices)
        except Exception as e:
            logger.warning(f"observability: counting the FLOPs of {name!r} "
                           f"failed ({e!r}); MFU will not be reported")
            # sentinel so we don't retry (and re-fail) every step
            self.flops_profiles[name] = FlopsProfile(
                name=name, flops=0.0, peak_flops_per_device=0.0,
                device_kind="?", num_devices=0)
            self._pending_profile = None
            return fn(*args)
        self.flops_profiles[name] = prof
        self._pending_profile = prof
        return result

    def record_flops(self, samples: int) -> None:
        """Write the newest profile's scalar and event (once)."""
        prof, self._pending_profile = self._pending_profile, None
        if prof is None:
            return
        if prof.uncounted:
            logger.warning(f"observability: kernels {prof.uncounted} "
                           "cannot count their walks; no FLOPs and no MFU "
                           "are reported")
        else:
            self.scalar(TAG_FLOPS, prof.flops, samples)
        self.event("flops_profile", fn=prof.name, flops=prof.flops,
                   peak_flops_per_device=prof.peak_flops_per_device,
                   device_kind=prof.device_kind,
                   num_devices=prof.num_devices,
                   kernel_flops=prof.kernel_flops,
                   uncounted=list(prof.uncounted),
                   source="FlopCounterMode + kernel walks",
                   profile_ms=round(prof.profile_ms or 0.0, 3))
        log_dist(format_profile(prof), ranks=[0])

    # --------------------------------------------------------- per step
    def mfu(self, step_time_ms: Optional[float],
            micro_steps_per_step: int = 1) -> Optional[float]:
        """Model FLOPs utilization for one step time, from the profiled
        micro-step, or None when either is missing. The engine calls this
        at telemetry-flush barriers with the window-averaged step
        time."""
        if not self.enabled or not step_time_ms:
            return None
        prof = self.flops_profiles.get("micro_step")
        if prof is None or prof.flops <= 0:
            return None
        return compute_mfu(prof.flops * max(micro_steps_per_step, 1),
                           step_time_ms / 1e3,
                           prof.peak_flops_per_device)

    def write_mfu(self, step_time_ms: Optional[float], samples: int,
                  micro_steps_per_step: int = 1) -> Optional[float]:
        """Compute and emit the MFU scalar for one honest step time."""
        mfu = self.mfu(step_time_ms, micro_steps_per_step)
        if mfu is not None:
            self.scalar(TAG_MFU, mfu, samples)
        return mfu

    def on_step(self, samples: int, host_gap_ms: Optional[float] = None,
                host_syncs: Optional[int] = None) -> None:
        """Step-boundary emission: the host overhead counters, memory
        watermarks; the Chrome trace refreshed on disk. (Step time and
        MFU come at flush barriers: :meth:`write_mfu`.)"""
        if not self.enabled:
            return
        if host_gap_ms is not None:
            self.scalar(TAG_HOST_GAP, host_gap_ms, samples)
        if host_syncs is not None:
            self.scalar(TAG_HOST_SYNCS, host_syncs, samples)
        if self.memory is not None:
            snap = self.memory.sample("step")
            if snap is not None:
                self.scalar(TAG_MEM_IN_USE, snap["bytes_in_use"], samples)
                self.scalar(TAG_MEM_PEAK, self.memory.peak_bytes, samples)
                self.scalar(TAG_MEM_DELTA, snap["delta_bytes"], samples)
        if self._chrome_path and self.recorder is not None:
            # throttled: rewriting the whole trace JSON is O(buffered
            # events): once early (so the file exists mid-run), then at
            # most every few seconds; close() writes the final state
            import time as _time
            now = _time.monotonic()
            if self._chrome_last_dump == 0.0 or \
                    now - self._chrome_last_dump > 5.0:
                try:
                    self.recorder.dump(self._chrome_path)
                    self._chrome_last_dump = now
                except Exception:
                    pass
        if self._log is not None:
            self._log.flush()

    def close(self) -> None:
        if self._closed or not self.enabled:
            return
        self._closed = True
        # drop the atexit pin, which would otherwise keep the engine (and
        # its tensors on the card) alive for the whole process
        import atexit
        try:
            atexit.unregister(self.close)
        except Exception:
            pass
        if self._chrome_path and self.recorder is not None:
            try:
                self.recorder.dump(self._chrome_path)
            except Exception:
                pass
        if self.monitor is not None and \
                getattr(self.monitor, "mirror", None) is self._log:
            self.monitor.mirror = None
        if self._log is not None:
            self._log.close()
            self._log = None
