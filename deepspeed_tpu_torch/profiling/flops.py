"""FLOPs / MFU profiler (the port of ``deepspeed_tpu/profiling/flops.py``).

The JAX package reads the compiled step's count from XLA's
``cost_analysis``. Eager PyTorch compiles nothing, so :func:`profile_step`
runs one micro-step, forward and backward, under
``torch.utils.flop_counter.FlopCounterMode`` instead. That counter sees
aten ops only: the matmuls of the model, of its backward and of any
recomputation under activation checkpointing. The port's attention
kernels are ctypes calls inside ``autograd.Function``s, which it cannot
see, so each kernel wrapper adds its own count (:func:`counted_flops`):
the products of the cells its walk computes (a causal tile's lower
triangle, a band tile's kept cells, never a dense S x S), two FLOPs each.
While a wrapper runs, the counter is paused, so the plain PyTorch
versions that run for CPU tensors are not counted twice. A wrapper that
cannot count its walk reports itself uncounted, and then the profile
has no total (:attr:`FlopsProfile.flops` is 0 and ``uncounted`` names
it) rather than one that leaves it out.

Elementwise work (norms, softmax outside the kernels, the optimizer) is
not counted; ``cost_analysis`` counts it. Bytes accessed have no torch
counterpart and are not counted.

MFU is reported against a small peak registry: the H100's dense bf16
peak, and a nominal CPU fallback so CPU runs still produce a
well-defined fraction.
"""

import contextlib
import functools
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

__all__ = [
    "FlopsProfile", "PEAK_FLOPS_REGISTRY", "CPU_FALLBACK_PEAK_FLOPS",
    "peak_flops_per_device", "profile_step", "compute_mfu",
    "format_profile", "counted_flops", "uncounted", "count_flops",
    "FlopTally",
]

# Peak dense bf16 FLOP/s per card, matched by substring on the lowercased
# device name: the H100 SXM's 989 TFLOP/s (NVIDIA's H100 datasheet,
# without sparsity).
PEAK_FLOPS_REGISTRY = (
    ("h100", 989e12),
)
# Nominal placeholder so MFU stays a well-defined positive fraction on
# the CPU. Deliberately NOT a measured CPU peak: CPU MFU values are only
# meaningful relative to each other within one run.
CPU_FALLBACK_PEAK_FLOPS = 1e11


class FlopsProfile(NamedTuple):
    """One micro-step's count. ``flops`` is per device per invocation
    (0 when a kernel could not count its walk: see ``uncounted``);
    ``kernel_flops`` the share each attention kernel added."""
    name: str
    flops: float
    peak_flops_per_device: float
    device_kind: str
    num_devices: int
    profile_ms: Optional[float] = None
    kernel_flops: Optional[Dict[str, float]] = None
    uncounted: Tuple[str, ...] = ()


def _device_kind(device) -> str:
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if torch.cuda.is_available() else torch.device("cpu"))
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def peak_flops_per_device(device=None, kind: Optional[str] = None):
    """``(peak_flops, label)`` for a torch device (the current CUDA
    device when None and a card is present, else the CPU), or for a
    device name ``kind`` as ``torch.cuda.get_device_name`` gives it.
    Unknown devices fall back to the CPU placeholder with a
    ``+nominal-peak`` label so reports cannot silently claim a real
    MFU."""
    if kind is None:
        kind = _device_kind(device)
    low = kind.lower()
    for needle, peak in PEAK_FLOPS_REGISTRY:
        if needle in low:
            return peak, kind
    return CPU_FALLBACK_PEAK_FLOPS, f"{kind}+nominal-peak"


# --------------------------------------------------------------------- #
# the kernels' own counts
# --------------------------------------------------------------------- #
_TALLIES = []        # active FlopTally objects
_PAUSED = [0]        # > 0 while a counted kernel wrapper runs


class FlopTally:
    """What the kernel wrappers add while it is active: FLOPs by kernel,
    and the kernels that could not count."""

    def __init__(self):
        self.by_kernel: Dict[str, float] = {}
        self.uncounted = set()

    def add(self, name: str, flops: Optional[float]):
        if flops is None:
            self.uncounted.add(name)
        else:
            self.by_kernel[name] = self.by_kernel.get(name, 0.0) + flops

    @property
    def total(self) -> float:
        return float(sum(self.by_kernel.values()))

    def __enter__(self):
        _TALLIES.append(self)
        return self

    def __exit__(self, *exc):
        _TALLIES.remove(self)
        return False


def counted_flops(name: str, flops_fn: Callable[..., Optional[float]]):
    """Decorator for a kernel wrapper: while a :class:`FlopTally` is
    active, each call adds ``flops_fn(*args, **kwargs)`` (None: the
    walk cannot be counted) under ``name``, and the aten ops inside the
    call (the plain version, on the CPU) go uncounted. With no tally
    active the call costs one list check."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _TALLIES:
                return fn(*args, **kwargs)
            flops = flops_fn(*args, **kwargs)
            for t in _TALLIES:
                t.add(name, None if flops is None else float(flops))
            _PAUSED[0] += 1
            try:
                return fn(*args, **kwargs)
            finally:
                _PAUSED[0] -= 1
        return wrapper
    return deco


def uncounted(*args, **kwargs) -> None:
    """The count of a kernel whose walk this module cannot count yet (the
    block-sparse kernels K8-K16): a profile that reaches one has no
    total."""
    return None


def _counter_mode():
    """A FlopCounterMode that skips what runs inside a counted kernel
    wrapper (imported here: the flop counter pulls in torch internals
    the rest of the package never needs)."""
    from torch.utils.flop_counter import FlopCounterMode

    class _KernelAwareCounter(FlopCounterMode):
        def _count_flops(self, func_packet, out, args, kwargs):
            if _PAUSED[0]:
                return out
            return super()._count_flops(func_packet, out, args, kwargs)

    return _KernelAwareCounter(display=False)


@contextlib.contextmanager
def count_flops():
    """Count what runs inside the block: yields a dict that holds, on
    exit, ``"aten"`` (FlopCounterMode's total), ``"kernels"`` (the
    wrappers' :class:`FlopTally`) and ``"total"`` (their sum, 0 when a
    kernel was uncounted)."""
    out = {}
    counter = _counter_mode()
    with FlopTally() as tally, counter:
        yield out
    out["aten"] = float(counter.get_total_flops())
    out["kernels"] = tally
    out["total"] = 0.0 if tally.uncounted else out["aten"] + tally.total


def profile_step(fn, args=(), name: str = "micro_step", device=None,
                 num_devices: int = 1):
    """Run ``fn(*args)`` (one micro-step, forward and backward) under the
    counter. Returns ``(fn's result, FlopsProfile)``."""
    import time
    t0 = time.perf_counter()
    with count_flops() as c:
        result = fn(*args)
    dt_ms = (time.perf_counter() - t0) * 1e3
    peak, kind = peak_flops_per_device(device)
    tally = c["kernels"]
    return result, FlopsProfile(
        name=name, flops=c["total"],
        peak_flops_per_device=peak, device_kind=kind,
        num_devices=num_devices, profile_ms=dt_ms,
        kernel_flops=dict(tally.by_kernel),
        uncounted=tuple(sorted(tally.uncounted)))


def compute_mfu(flops_per_step: float, step_time_s: float,
                peak_flops: float) -> float:
    """Model FLOPs utilization: achieved FLOP/s over peak."""
    if step_time_s <= 0 or peak_flops <= 0:
        return 0.0
    return flops_per_step / step_time_s / peak_flops


def format_profile(profile: FlopsProfile,
                   step_time_ms: Optional[float] = None) -> str:
    """Reference-flops_profiler-style block, logged once per program."""
    lines = [
        f"flops profiler: {profile.name}",
        f"  device               : {profile.device_kind} "
        f"x{profile.num_devices} "
        f"(peak {profile.peak_flops_per_device / 1e12:.1f} TFLOP/s/dev)",
        f"  flops per step/dev   : {profile.flops / 1e9:.3f} GFLOP",
        "  bytes accessed/dev   : not counted",
    ]
    for k, v in sorted((profile.kernel_flops or {}).items()):
        lines.append(f"  of which {k:<12}: {v / 1e9:.3f} GFLOP")
    if profile.uncounted:
        lines.append(f"  uncounted kernels    : "
                     f"{', '.join(profile.uncounted)} (no total)")
    if profile.profile_ms is not None:
        lines.append(f"  counted step         : "
                     f"{profile.profile_ms:.0f} ms")
    if step_time_ms:
        mfu = compute_mfu(profile.flops, step_time_ms / 1e3,
                          profile.peak_flops_per_device)
        lines.append(f"  step time            : {step_time_ms:.2f} ms")
        lines.append(f"  MFU                  : {mfu * 100:.2f}%")
    return "\n".join(lines)
