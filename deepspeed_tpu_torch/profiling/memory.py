"""Device-memory watermark sampling (the port of
``deepspeed_tpu/profiling/memory.py``).

On a CUDA device a sample reads the caching allocator's counters
(``torch.cuda.memory_stats``: the bytes allocated now, and their peak
since the last ``reset_peak_memory_stats``); elsewhere it falls back to
the host process's RSS, labeled ``source: "host"``, as the JAX package
does on backends without allocator stats. Sampling is a host call with
no device sync, so the engine can take a watermark at every step
boundary; :class:`MemoryWatermark` keeps the run peak and the change
since the previous sample.
"""

import os
from typing import Dict, Optional

import torch

__all__ = ["memory_snapshot", "MemoryWatermark"]

_PAGE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096


def _host_rss_bytes() -> Optional[int]:
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * _PAGE
    except Exception:
        return None


def _host_peak_rss_bytes() -> Optional[int]:
    try:
        import resource
        ru = resource.getrusage(resource.RUSAGE_SELF)
        return int(ru.ru_maxrss) * 1024  # linux reports KiB
    except Exception:
        return None


def _cuda_stats(device) -> Optional[Dict]:
    """The allocator's current and peak allocated bytes on ``device``
    (a CUDA device, or None for the current one when CUDA is in use);
    None off the card or before CUDA is initialised."""
    if device is not None and torch.device(device).type != "cuda":
        return None
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return None
    stats = torch.cuda.memory_stats(device)
    if "allocated_bytes.all.current" not in stats:
        return None
    return {"bytes_in_use": int(stats["allocated_bytes.all.current"]),
            "peak_bytes_in_use": int(stats["allocated_bytes.all.peak"]),
            "source": "device"}


def memory_snapshot(device=None) -> Optional[Dict]:
    """``{"bytes_in_use", "peak_bytes_in_use", "source"}`` for one
    device, the host-RSS fallback off the card. None only when neither
    source is readable."""
    try:
        stats = _cuda_stats(device)
    except Exception:
        stats = None
    if stats:
        return stats
    rss = _host_rss_bytes()
    peak = _host_peak_rss_bytes()
    if rss is None and peak is None:
        return None
    return {"bytes_in_use": int(rss or peak or 0),
            "peak_bytes_in_use": int(peak or rss or 0),
            "source": "host"}


class MemoryWatermark:
    """Stateful watermark tracking over :func:`memory_snapshot`.

    ``sample(phase)`` returns the snapshot extended with
    ``delta_bytes`` (bytes_in_use change since the previous sample, any
    phase) and maintains ``peak_bytes`` across the run."""

    def __init__(self, device=None):
        self._device = device
        self.last: Optional[Dict] = None
        self.peak_bytes: int = 0

    def sample(self, phase: str = "step") -> Optional[Dict]:
        snap = memory_snapshot(self._device)
        if snap is None:
            return None
        prev = self.last
        snap = dict(snap)
        snap["phase"] = phase
        snap["delta_bytes"] = (snap["bytes_in_use"] - prev["bytes_in_use"]
                               if prev else 0)
        self.peak_bytes = max(self.peak_bytes, snap["peak_bytes_in_use"],
                              snap["bytes_in_use"])
        self.last = snap
        return snap
