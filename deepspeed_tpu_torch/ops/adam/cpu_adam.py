"""ZeRO-Offload CPU Adam, Python side (the port of
``deepspeed_tpu/ops/adam/cpu_adam.py``, after the reference's
``deepspeed/ops/adam/cpu_adam.py:8``).

The native kernel is the repo's ``csrc/adam/cpu_adam.cpp`` (AVX-512 or
AVX2 with FMA, chosen at run time, and OpenMP), built as it stands with
``csrc/Makefile``'s flags into ``deepspeed_tpu_torch/.build/`` at first
use (``ops/_build.build_host``) and bound through its C ABI with ctypes
(``ds_adam_create``, ``ds_adam_step``, ``ds_adam_simd_width``,
``ds_adam_destroy``). The optimizer owns host fp32 masters and moments
(flat numpy leaves); ``step(grads)`` runs the SIMD update and returns the
updated params, as bf16 CPU tensors ready for one H2D copy when
``bf16_out`` (the analogue of the reference's fp16 copy-back).

Where the JAX package steps in numpy when the library cannot be built or
loaded, the port has no fallback: a failed build or load raises.
"""

import ctypes
import os
import threading
import weakref
from typing import Any, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.utils.tree import (tree_leaves, tree_map,
                                            tree_unflatten)

__all__ = ["DeepSpeedCPUAdam", "load_library", "SOURCE"]

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
#: the C++ source, used unchanged
SOURCE = os.path.join(os.path.dirname(_PKG), "csrc", "adam", "cpu_adam.cpp")

_LIBS = {}
_LIB_LOCK = threading.Lock()


def load_library(source: Optional[str] = None) -> ctypes.CDLL:
    """The native Adam library built from ``source`` (default
    :data:`SOURCE`), its C ABI declared. Raises when the build or the
    load fails."""
    from deepspeed_tpu_torch.ops import _build
    source = SOURCE if source is None else source
    with _LIB_LOCK:
        lib = _LIBS.get(source)
        if lib is not None:
            return lib
        lib = ctypes.CDLL(_build.build_host(source))
        lib.ds_adam_create.argtypes = [
            ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int]
        lib.ds_adam_create.restype = ctypes.c_int
        lib.ds_adam_step.argtypes = [
            ctypes.c_int, ctypes.c_longlong, ctypes.c_float,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_longlong, ctypes.c_void_p]
        lib.ds_adam_step.restype = ctypes.c_int
        lib.ds_adam_simd_width.argtypes = []
        lib.ds_adam_simd_width.restype = ctypes.c_int
        lib.ds_adam_destroy.argtypes = [ctypes.c_int]
        lib.ds_adam_destroy.restype = ctypes.c_int
        _LIBS[source] = lib
        return lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _host_f32(x) -> np.ndarray:
    """A leaf as a flat contiguous fp32 numpy array (a view where it can
    be: a CPU fp32 tensor or array)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.device.type != "cpu" or x.dtype != torch.float32:
            x = x.to("cpu", torch.float32)
        x = x.numpy()
    return np.ascontiguousarray(np.asarray(x, dtype=np.float32).ravel())


class DeepSpeedCPUAdam:
    """Host Adam over flat fp32 numpy leaves (reference ``cpu_adam.py:8``).
    Construct with the parameter tree (host copies are made), call
    :meth:`step` with the grad tree (CPU tensors or numpy), read back
    :attr:`master_params` or ``step``'s output. With ``pin_memory`` the
    bf16 output lives in page-locked buffers, for an asynchronous H2D
    copy; ``step`` reuses them, so its bf16 output is valid until the
    next ``step``."""

    _next_id = 0

    def __init__(self, model_params: Any, lr: float = 1e-3,
                 betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, bias_correction: bool = True,
                 adamw_mode: bool = True, amsgrad: bool = False,
                 pin_memory: bool = False):
        if amsgrad:
            raise ValueError("amsgrad not supported (reference "
                             "cpu_adam.py:29)")
        self.lr = lr
        self.betas = tuple(betas)
        self.eps = eps
        self.weight_decay = weight_decay
        self.bias_correction = bias_correction
        self.adamw_mode = adamw_mode
        # the tree's structure only: the caller's tensors are not kept
        self._like = tree_map(lambda _: 0, model_params)
        leaves = list(tree_leaves(model_params))
        self._shapes = [tuple(x.shape) for x in leaves]
        # explicit copies: the native kernel writes through raw pointers
        self.master_params = [_host_f32(x).copy() for x in leaves]
        self.exp_avg = [np.zeros_like(p) for p in self.master_params]
        self.exp_avg_sq = [np.zeros_like(p) for p in self.master_params]
        self.step_count = 0
        self._pin = bool(pin_memory)
        self._out16 = None

        self.opt_id = DeepSpeedCPUAdam._next_id
        DeepSpeedCPUAdam._next_id += 1
        self._lib = load_library()
        self._register()
        # free the native registry entry when this optimizer dies
        weakref.finalize(self, self._lib.ds_adam_destroy, self.opt_id)

    def _register(self):
        self._lib.ds_adam_create(
            self.opt_id, ctypes.c_float(self.lr),
            ctypes.c_float(self.betas[0]), ctypes.c_float(self.betas[1]),
            ctypes.c_float(self.eps), ctypes.c_float(self.weight_decay),
            int(self.adamw_mode), int(self.bias_correction))

    @property
    def uses_native_kernel(self) -> bool:
        """Always True: the port has no numpy fallback."""
        return True

    def simd_width(self) -> int:
        """Floats per SIMD lane group the kernel runs with: 16 (AVX-512),
        8 (AVX2) or 1 (scalar)."""
        return int(self._lib.ds_adam_simd_width())

    def omp_threads(self) -> int:
        """The OpenMP threads the kernel's loop runs on (the library's
        ``omp_get_max_threads``)."""
        fn = self._lib.omp_get_max_threads
        fn.restype = ctypes.c_int
        return int(fn())

    def step(self, grads: Any, lr: Optional[float] = None,
             bf16_out: bool = False, beta1: Optional[float] = None):
        """One Adam step over every leaf. Returns the updated parameter
        tree: bf16 CPU tensors when ``bf16_out`` (the H2D payload, rounded
        to nearest even by the kernel), else fp32 tensors viewing the
        masters. ``beta1`` overrides the momentum (OneCycle's
        ``cycle_momentum``): the native side keeps only a config, so it is
        registered again with the new beta1."""
        lr = self.lr if lr is None else float(lr)
        if beta1 is not None and float(beta1) != self.betas[0]:
            self.betas = (float(beta1), self.betas[1])
            self._register()
        if bf16_out and self._out16 is None:
            self._out16 = [torch.empty(p.size, dtype=torch.bfloat16,
                                       pin_memory=self._pin)
                           for p in self.master_params]
        self.step_count += 1
        g_leaves = list(tree_leaves(grads))
        if len(g_leaves) != len(self.master_params):
            raise ValueError(f"{len(g_leaves)} grad leaves for "
                             f"{len(self.master_params)} params")
        outs = []
        for i, g in enumerate(g_leaves):
            g = _host_f32(g)
            n = self.master_params[i].size
            if g.size != n:
                raise ValueError(f"grad leaf {i}: {g.size} != {n}")
            out = self._out16[i] if bf16_out else None
            rc = self._lib.ds_adam_step(
                self.opt_id, self.step_count, ctypes.c_float(lr),
                _fptr(self.master_params[i]), _fptr(g),
                _fptr(self.exp_avg[i]), _fptr(self.exp_avg_sq[i]), n,
                ctypes.c_void_p(out.data_ptr()) if out is not None else None)
            if rc != 0:
                raise RuntimeError(f"native adam step failed rc={rc}")
            outs.append(out.view(self._shapes[i]) if out is not None else
                        torch.from_numpy(self.master_params[i])
                        .view(self._shapes[i]))
        return tree_unflatten(self._like, outs)

    # -- state I/O for checkpointing ------------------------------------ #
    def state_dict(self):
        return {"step": self.step_count,
                "master_params": [p.copy() for p in self.master_params],
                "exp_avg": [m.copy() for m in self.exp_avg],
                "exp_avg_sq": [v.copy() for v in self.exp_avg_sq]}

    def load_state_dict(self, sd):
        self.step_count = int(sd["step"])
        for dst, src in zip(self.master_params, sd["master_params"]):
            np.copyto(dst, _host_f32(src))
        for dst, src in zip(self.exp_avg, sd["exp_avg"]):
            np.copyto(dst, _host_f32(src))
        for dst, src in zip(self.exp_avg_sq, sd["exp_avg_sq"]):
            np.copyto(dst, _host_f32(src))
