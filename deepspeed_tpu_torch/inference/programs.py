"""The serving engine's fixed program set (the port's counterpart of the
JAX engine's ``_wrap_program`` jits and their ``CompileTracker``).

One :class:`Program` per key: ``("prefill", batch_bucket,
prompt_bucket)``, ``("decode", table_width)``, ``("verify", width)`` and
``("chunk", batch_bucket, chunk_tokens)``. A program owns static input
tensors on the engine's device (ids or tokens, lengths, positions, block
tables), the static output its body returns (the logits of the rows the
engine samples) and, on a CUDA device, one ``torch.cuda.CUDAGraph``:

- every graph of a set shares one memory pool and one capture stream;
- a program is built the first time its key is dispatched: its body runs
  once eagerly on the capture stream (cuBLAS, the nvcc-built kernels and
  the paged-decode kernel's arrival counters are initialised there),
  then the body is captured;
- a dispatch copies the host arrays into the static inputs (from pinned
  host buffers) and replays the graph. A capture or a replay that fails
  raises: there is no eager fallback on the card.

On a CPU device the same object runs the body eagerly, with the same
keys and counters. :attr:`ProgramSet.steady_state_recompiles` counts the
keys first seen after :meth:`ProgramSet.mark_warm`, as the JAX engine's
tracker counts compiles after ``warmup``.

The paged-decode kernel's launch counters
(``paged_decode_attention.launches`` / ``launches_int8``) count launches
on the card: each graph records the launches its capture made, takes
them back (a capture launches nothing) and adds them at every replay.

The graphs share their pool, so a replay may reuse memory an earlier
graph's body used in flight; each program's output tensor stays its own
while the set holds it, but it is overwritten by the program's next
dispatch: read it (or copy it) before that.
"""

import gc
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.ops.attention import paged

__all__ = ["Program", "ProgramSet", "key_name"]

Key = Tuple[Any, ...]


def key_name(key: Key) -> str:
    """A key as one string (``"prefill/8/256"``), for logs and JSON."""
    return "/".join(str(k) for k in key)


def _k4_counts() -> Tuple[int, int]:
    f = paged.paged_decode_attention
    return f.launches, f.launches_int8


def _add_k4(dense: int, int8: int) -> None:
    f = paged.paged_decode_attention
    f.launches += dense
    f.launches_int8 += int8


class Program:
    """One program of the set: its body, static inputs and output, and on
    the card its graph and the paged-decode launches the graph holds."""

    def __init__(self, key: Key, body: Callable[..., torch.Tensor],
                 inputs: Dict[str, torch.Tensor],
                 pinned: Optional[Dict[str, torch.Tensor]]):
        self.key = key
        self.body = body
        self.inputs = inputs
        self.pinned = pinned
        self.copied = None          # event after the last host->device copy
        self.out: Optional[torch.Tensor] = None
        self.graph = None
        self.k4 = (0, 0)            # (dense, int8) launches per replay
        self.dispatches = 0
        self.replays = 0

    def load(self, host: Dict[str, np.ndarray]) -> None:
        """Copy ``host`` into the static inputs (through the pinned
        buffers on the card, after the previous copy out of them
        ended)."""
        if self.pinned is None:
            for name, arr in host.items():
                self.inputs[name].copy_(torch.from_numpy(arr))
            return
        if self.copied is not None:
            self.copied.synchronize()
        for name, arr in host.items():
            self.pinned[name].numpy()[...] = arr
            self.inputs[name].copy_(self.pinned[name], non_blocking=True)
        if self.copied is None:
            self.copied = torch.cuda.Event()
        self.copied.record()

    def run_body(self) -> torch.Tensor:
        return self.body(**self.inputs)


class ProgramSet:
    """The programs of one engine, by key, on ``device``."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.on_cuda = self.device.type == "cuda"
        self.programs: Dict[Key, Program] = {}
        self._warm: Optional[int] = None
        self._pool = None
        self._stream = None

    # ------------------------------------------------------------ keys
    def __len__(self) -> int:
        return len(self.programs)

    def mark_warm(self) -> int:
        """Close the warm set; returns its size."""
        self._warm = len(self.programs)
        return self._warm

    @property
    def steady_state_recompiles(self) -> int:
        """Programs first built after :meth:`mark_warm` (0 is the serving
        contract); -1 before it."""
        if self._warm is None:
            return -1
        return len(self.programs) - self._warm

    # -------------------------------------------------------- dispatch
    def dispatch(self, key: Key, body: Callable[..., torch.Tensor],
                 host: Dict[str, np.ndarray]) -> torch.Tensor:
        """Run program ``key`` on ``host``'s arrays, building it (with
        ``body``, whose keyword arguments are ``host``'s names) the first
        time. Returns the program's static output."""
        prog = self.programs.get(key)
        if prog is None:
            prog = self._build(key, body, host)
        prog.load(host)
        prog.dispatches += 1
        if not self.on_cuda:
            prog.out = prog.run_body()
            return prog.out
        if prog.graph is None:
            self._capture(prog)
        self._replay(prog)
        return prog.out

    def run_eager(self, key: Key, host: Dict[str, np.ndarray]
                  ) -> torch.Tensor:
        """Program ``key``'s body run eagerly on ``host``'s arrays on the
        current stream, outside the dispatch counts: the reference a
        replay is held against. Returns a fresh output tensor."""
        prog = self.programs[key]
        prog.load(host)
        return prog.run_body()

    def _build(self, key, body, host) -> Program:
        inputs, pinned = {}, None
        for name, arr in host.items():
            t = torch.from_numpy(np.ascontiguousarray(arr))
            inputs[name] = torch.empty(t.shape, dtype=t.dtype,
                                       device=self.device)
        if self.on_cuda:
            pinned = {name: torch.empty(t.shape, dtype=t.dtype,
                                        pin_memory=True)
                      for name, t in inputs.items()}
        prog = Program(key, body, inputs, pinned)
        self.programs[key] = prog
        return prog

    def _capture(self, prog: Program) -> None:
        """One eager pass of the body on the capture stream, then its
        capture into the shared pool. The eager pass writes what the
        replay after it writes again (the same values at the same pool
        positions). The cyclic garbage collector is off during the
        capture: a collection there could free an older engine's graph,
        and destroying a graph while a stream captures invalidates the
        capture (``torch.cuda.graph`` collects before it begins)."""
        dev = self.device
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
            self._pool = torch.cuda.graph_pool_handle()
        cur = torch.cuda.current_stream(dev)
        self._stream.wait_stream(cur)
        with torch.cuda.stream(self._stream):
            prog.run_body()
        cur.wait_stream(self._stream)
        before = _k4_counts()
        graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self._pool,
                                  stream=self._stream):
                prog.out = prog.run_body()
        finally:
            if collecting:
                gc.enable()
        after = _k4_counts()
        prog.k4 = (after[0] - before[0], after[1] - before[1])
        _add_k4(-prog.k4[0], -prog.k4[1])      # the capture launched none
        prog.graph = graph

    def _replay(self, prog: Program) -> None:
        prog.graph.replay()
        prog.replays += 1
        _add_k4(*prog.k4)

    # ------------------------------------------------------- reporting
    def count(self, kind: str) -> int:
        """Programs of one kind (the first element of their keys)."""
        return sum(1 for k in self.programs if k[0] == kind)

    def debug_state(self) -> Dict[str, Dict[str, Any]]:
        """Per program: dispatches, graph replays, whether a graph holds
        it, and the paged-decode launches each replay adds."""
        return {key_name(k): {"dispatches": p.dispatches,
                              "replays": p.replays,
                              "graph": p.graph is not None,
                              "k4_launches_per_replay": sum(p.k4)}
                for k, p in sorted(self.programs.items(),
                                   key=lambda kv: key_name(kv[0]))}
