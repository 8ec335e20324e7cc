"""DeepSpeedEngine, the training runtime (the port of
``deepspeed_tpu/runtime/engine.py``, reduced to one device).

Same facade and contract as the JAX engine:

- the model is a loss function ``loss_fn(params, batch[, seed]) -> loss |
  (loss, aux)`` and ``model_parameters`` its initial parameter tree (a
  dict of tensors or numpy arrays);
- ``train_batch`` runs one full batch of ``gradient_accumulation_steps``
  micro batches and applies the optimizer at the boundary;
  ``forward``/``backward``/``step`` are the same step in three calls;
- grads of each micro batch are divided by the accumulation steps and
  summed in fp32; clipping scales them by
  ``min(1, gradient_clipping / (norm + 1e-6))``;
- the lr schedule comes from the config's ``scheduler`` section (or the
  caller's ``lr_scheduler``, any object with ``lr_at(step)``): each
  update takes ``lr_at(global_step)`` read before the step counts, and
  a schedule that cycles momentum hands ``mom_at(global_step)`` to the
  optimizer as beta1, as the JAX engine does;
- the engine joins the launcher's process group (``init_distributed``)
  and builds the mesh of ``mesh.axes`` over it (``parallel/mesh.py``);
  ``dp_world_size`` is the mesh's data size, and rank ``r`` takes rows
  ``[r * micro, (r + 1) * micro)`` of each global micro batch it is
  handed (the global batch is ``micro * dp`` rows, as JAX's
  ``data_sharding`` splits it), its dropouts drawing those rows' masks;
- ZeRO (``runtime/zero/sharding.py``): stage 0 all-reduces the window's
  grads to their mean; over more than one data rank, stages 1 and 2 keep
  the compute-dtype params for the forward and, apart, this rank's shard
  of the fp32 masters and the optimizer state (JAX's
  ``leaf_partition_spec`` leaf for leaf), reduce-scatter the grads (stage
  2: each micro step, into a sharded accumulator), update the shard and
  all-gather the compute-dtype params; leaves no rule shards are
  all-reduced. Clipping takes one global norm. The reported loss is the
  mean over ranks. At one data rank, with a group or without, stages 1
  and 2 take stage 0's step, which trains bitwise the same in less
  device memory;
- ZeRO-Offload (``cpu_offload``): the device holds the compute-dtype
  params only; the grads go to pinned host memory (in the compute dtype
  at ga 1, with no accumulator; the fp32 accumulator at ga > 1), the
  host's C++ Adam (``ops/adam/cpu_adam.py``) updates this rank's fp32
  master shard and its moments, and the new params come back in one
  H2D copy (then an all-gather). With ``overlap_comm`` a worker thread
  runs the host Adam while the next window computes, one window behind:
  window ``k + 1`` computes with the params of update ``k - 1``;
  :meth:`synchronize` (and save, load, eval, close) applies the pending
  update.

Where the JAX engine threads a ``jax.random`` key, this engine owns a
``torch.Generator`` and draws one int32 seed per micro batch from it;
the loss derives its dropout seeds from that. With ``bf16`` the params
stay fp32 masters: each micro batch the engine hands the loss a bf16 copy
made through a differentiable cast (the JAX engine's ``_cast_for_loss``),
so the grads arrive in fp32 through autograd. Optimizer updates are in
place. Entry points run on the current CUDA device unless the caller
passes ``device="cpu"``; without a card and without ``device`` they
raise.

Telemetry follows the JAX engine: a ``tensorboard`` section opens the
monitor, ``observability.enabled`` the :class:`Observer` (spans, the
micro-step's FLOP count, memory watermarks, events.jsonl). Loss, lr and
loss scale are queued per step and written at flush barriers (every
``steps_per_print`` steps, at the ring cap, on :meth:`last_loss`,
:meth:`eval_batch` and :meth:`close`); a barrier at a step boundary
synchronises the card and writes each step of the window the window's
wall time over its steps (the first step of a run, which builds the
kernels, keeps its own time), with samples/s and MFU.

Checkpoints follow the JAX engine's protocol and layout
(``runtime/checkpoint.py``): :meth:`save_checkpoint` stages a tag, seals
it with the ``COMMITTED`` marker, renames it into place and repoints
``latest``; :meth:`load_checkpoint` verifies a tag before it restores
it, and with no tag falls back to the newest committed one that
verifies. A tag of either package loads in the other. The trace window
(``observability.trace``, or the legacy ``profiler`` section) records a
``torch.profiler`` trace of the steps ``[start_step, start_step +
num_steps)`` into a Chrome trace under ``output_path``.

Not ported yet: ZeRO stage 3, fp16 and loss scaling, pipeline, tensor
and sequence parallelism, the async checkpoint writer and the preemption
drain, the async pipeline and the health plane.
"""

import atexit
import inspect
import math
import os
import shutil
import time
import weakref
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from deepspeed_tpu_torch import distributed as ds_dist
from deepspeed_tpu_torch.ops.functional import batch_rows
from deepspeed_tpu_torch.ops.optimizers import (Lamb, Optimizer,
                                                build_optimizer)
from deepspeed_tpu_torch.parallel.mesh import (build_mesh, data_axis_size,
                                               data_rank, data_sharding)
from deepspeed_tpu_torch.profiling import Observer
from deepspeed_tpu_torch.runtime import checkpoint as ckpt
from deepspeed_tpu_torch.runtime import fault
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.dataloader import (DeepSpeedDataLoader,
                                                    RepeatingLoader,
                                                    to_device)
from deepspeed_tpu_torch.runtime.lr_schedules import build_lr_schedule
from deepspeed_tpu_torch.runtime.zero.sharding import ZeroPartition
from deepspeed_tpu_torch.utils.logging import log_dist, logger
from deepspeed_tpu_torch.utils.monitor import TensorBoardMonitor
from deepspeed_tpu_torch.utils.timer import (SynchronizedWallClockTimer,
                                             ThroughputTimer)
from deepspeed_tpu_torch.utils.tree import (tree_leaves, tree_map,
                                            tree_unflatten)


class LossScaleState(NamedTuple):
    """The JAX engine's loss-scale group, which a checkpoint carries as
    ``loss_scale/{scale,good_steps,hysteresis}``."""
    scale: Any
    good_steps: Any
    hysteresis: Any


# what the JAX engine's static scaler of 1.0 holds for bf16 and fp32 (the
# port has no loss scaling): written into every tag, checked on load
STATIC_LOSS_SCALE = LossScaleState(np.float32(1.0), np.int32(0),
                                   np.int32(1))
# meta.json key of the port's own generator state (JAX reads "rng")
TORCH_RNG_KEY = "torch_rng_state"


def resolve_device(device) -> torch.device:
    """``device`` as given, else the current CUDA device. Never drifts to
    the CPU on its own: with no card and no explicit device it raises."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "DeepSpeedEngine runs on CUDA and no CUDA device is available; "
            "pass device='cpu' to train on the CPU with the kernels' plain "
            "versions")
    return torch.device("cuda", torch.cuda.current_device())


class DeepSpeedEngine:

    def __init__(self, args=None, model: Callable = None,
                 optimizer: Optional[Optimizer] = None,
                 model_parameters: Any = None, training_data=None,
                 lr_scheduler=None, collate_fn=None, config: Any = None,
                 config_params: Any = None, seed: int = 0, device=None):
        if model is None:
            raise ValueError("deepspeed_tpu_torch.initialize requires a "
                             "model (loss fn)")
        if model_parameters is None:
            raise ValueError("deepspeed_tpu_torch.initialize requires "
                             "model_parameters (the initial param tree)")
        raw = config if config is not None else config_params
        if raw is None and args is not None and \
                getattr(args, "deepspeed_config", None):
            raw = args.deepspeed_config
        if raw is None:
            raise ValueError("a DeepSpeed config (dict or path) is required")
        # the group first: on the card it binds this process to device
        # LOCAL_RANK, which the default device then resolves to
        ds_dist.init_distributed(device=device)
        self.device = resolve_device(device)
        # the config first (its refusals name what is not ported), at the
        # group's size: every axis but the data axes must be 1, so the
        # mesh's data size is the world's
        world = (torch.distributed.get_world_size()
                 if ds_dist.is_initialized() else 1)
        self._config = DeepSpeedConfig(raw, world_size=world)
        mesh_axes = (self._config._param_dict.get("mesh") or {}).get("axes")
        self.mesh = build_mesh(mesh_axes, self.device.type)
        self.dp_world_size = data_axis_size(self.mesh)
        self.dp_rank = data_rank(self.mesh)
        self._rows = data_sharding(self.mesh)
        self.lr_scheduler = lr_scheduler if lr_scheduler is not None else \
            build_lr_schedule(self._config.scheduler_name,
                              self._config.scheduler_params)

        # -- precision: fp32 masters, compute in bf16 or fp32 --
        self.fp16_enabled = False
        self.bf16_enabled = bool(self._config.bf16_enabled)
        self.compute_dtype = torch.bfloat16 if self.bf16_enabled else None

        # -- loss fn --
        self._loss_fn = model
        try:
            n_args = len(inspect.signature(model).parameters)
        except (TypeError, ValueError):
            n_args = None
        self._loss_takes_rng = n_args == 3

        # -- ZeRO and offload --
        self.zero_stage = self._config.zero_optimization_stage
        zc = self._config.zero_config
        self.zero_cpu_offload = bool(self.zero_stage >= 1 and zc.cpu_offload)
        self._offload_overlap = bool(self.zero_cpu_offload and
                                     zc.overlap_comm)
        self.gradient_accumulation_steps = \
            self._config.gradient_accumulation_steps
        # offload at ga 1: the grads leave the micro step in the compute
        # dtype and no accumulator is made
        self._offload_direct = (self.zero_cpu_offload and
                                self.gradient_accumulation_steps == 1)
        # ZeRO 1-2 over more than one data rank, and offload: compute-dtype
        # params for the forward, this rank's fp32 master shard (on the
        # device, or the host's with offload) apart. At one data rank there
        # is nothing to shard, and stage 0's step (fp32 params cast per
        # forward) trains bitwise the same without a second, compute-dtype
        # copy of the params on the device: ZeRO 1-2 take it there
        self._sharded = self.zero_cpu_offload or \
            (self.zero_stage >= 1 and self.dp_world_size > 1)
        leaves = list(tree_leaves(model_parameters))
        self._part = None
        if self._sharded or ds_dist.is_initialized():
            self._part = ZeroPartition(
                [tuple(np.shape(t)) for t in leaves], self.dp_world_size,
                self.dp_rank, self.zero_stage if self._sharded else 0)
        # stage 2 reduce-scatters each micro step into a sharded
        # accumulator (the direct offload path reduces once, in fp32)
        self._scatter_per_micro = (self._sharded and self.zero_stage >= 2
                                   and not self._offload_direct)

        # -- optimizer + state --
        if self.zero_cpu_offload:
            if optimizer is not None:
                raise ValueError("client optimizers are unsupported with "
                                 "cpu_offload")
            name = (self._config.optimizer_name or "adam").lower()
            if "adam" not in name or "onebit" in name or "8bit" in name:
                raise ValueError(
                    "ZeRO-Offload requires a plain Adam-family optimizer "
                    f"(the reference drives DeepSpeedCPUAdam), got {name}")
        self.optimizer = optimizer if optimizer is not None else \
            build_optimizer(self._config.optimizer_name,
                            self._config.optimizer_params)
        if isinstance(self.optimizer, Lamb) and self._sharded:
            # its trust ratios take the whole leaves' norms
            self.optimizer.leaf_norms = self._part.leaf_norms
        if self._sharded:
            self._init_sharded(leaves, model_parameters)
        else:
            # an explicit copy: the engine updates its masters in place
            # and must not write through to the caller's tensors
            self.params = tree_map(
                lambda t: torch.as_tensor(t).detach().to(
                    self.device, torch.float32).clone().requires_grad_(),
                model_parameters)
            self.master = None
            self.opt_state = self.optimizer.init(self.params)
        self.accum_grads = None
        if self.gradient_accumulation_steps > 1:
            if self._scatter_per_micro:
                self.accum_grads = [
                    torch.zeros(self._part.shard_shape(i),
                                dtype=torch.float32, device=self.device)
                    for i in range(len(leaves))]
            else:
                self.accum_grads = [
                    torch.zeros(p.shape, dtype=torch.float32,
                                device=self.device)
                    for p in tree_leaves(self.params)]
        self.gradient_clipping = self._config.gradient_clipping
        self._generator = torch.Generator().manual_seed(seed)
        self._ckpt_cfg = self._config.checkpoint_config
        self._profiler_cfg = self._config.profiler_config
        self._profiler = None        # the open trace window
        self._trace_first = None     # its first step
        self.trace_path = None       # the last window's Chrome trace

        # -- data --
        self.training_dataloader = None
        if training_data is not None:
            self.training_dataloader = self.deepspeed_io(
                training_data, collate_fn=collate_fn)
        self._train_iter = None

        # -- bookkeeping --
        self.timers = SynchronizedWallClockTimer()
        self.tput_timer = ThroughputTimer(
            batch_size=self.train_micro_batch_size_per_gpu() *
            self.gradient_accumulation_steps,
            num_workers=self.dp_world_size,
            steps_per_output=self._config.steps_per_print)
        self.wall_clock_breakdown_enabled = self._config.wall_clock_breakdown
        self.global_step = 0
        self.micro_step = 0
        self._host_micro_step = 0
        self._cached_grads = None
        self._cached_loss = None
        self._pending_grads = None
        self._last_loss = None
        self.skipped_steps = 0           # offload updates skipped (inf/nan)
        # ZeRO-Offload: the update in flight (overlap_comm), its worker,
        # the pinned grad staging, and the last boundary's host times
        self._offload_pending = None
        self._offload_pool = (ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="ds-offload")
            if self._offload_overlap else None)
        self._host_grads = self._host_grads32 = None
        self._warned_stale_params = False
        self.offload_stats = {}

        # -- telemetry: the monitor, then the Observer that mirrors it --
        self.monitor = TensorBoardMonitor(
            enabled=self._config.tensorboard_enabled,
            output_path=self._config.tensorboard_output_path,
            job_name=self._config.tensorboard_job_name)
        self.summary_writer = self.monitor.writer
        self.observability = Observer(
            self._config.observability_config, monitor=self.monitor,
            device=self.device, num_devices=self.dp_world_size)
        self._monitor_ring = []          # queued loss/lr records
        self._window_anchor = None       # flush-to-flush wall-clock base
        self._last_step_time_ms = None   # host time of the last step
        self._host_gap_ms = None         # of it, outside the step's work
        self._host_sync_count = 0        # forced syncs by telemetry
        # the ring's tail at process exit; the hook holds a weakref only,
        # and is registered after the Observer's, so (LIFO) it runs while
        # the event log is open
        self_ref = weakref.ref(self)

        def _exit_flush(ref=self_ref):
            eng = ref()
            if eng is not None and eng._monitor_ring:
                try:
                    eng._flush_monitor()
                except Exception:
                    pass

        self._atexit_flush_hook = _exit_flush
        atexit.register(_exit_flush)
        mesh = dict(zip(self.mesh.mesh_dim_names, self.mesh.shape))
        log_dist(f"DeepSpeedEngine initialized: device={self.device} "
                 f"mesh={mesh} "
                 f"zero_stage={self.zero_stage} "
                 f"cpu_offload={self.zero_cpu_offload} "
                 f"dtype={self.compute_dtype or torch.float32} "
                 f"grad_acc={self.gradient_accumulation_steps}", ranks=[0])

    def _init_sharded(self, leaves, model_parameters):
        """The sharded state: full compute-dtype params for the forward
        (each a leaf that takes a grad), and this rank's fp32 master shard
        of every leaf with the optimizer state over the shards, on the
        device, or in the host optimizer with offload."""
        dtype = self.compute_dtype or torch.float32
        full = [torch.as_tensor(t).detach().to(self.device, torch.float32)
                for t in leaves]
        shards = [self._part.shard(i, t) for i, t in enumerate(full)]
        self.params = tree_unflatten(model_parameters, [
            t.to(dtype).requires_grad_() if t.dtype != dtype
            else t.clone().requires_grad_() for t in full])
        del full
        if self.zero_cpu_offload:
            from deepspeed_tpu_torch.ops.adam import DeepSpeedCPUAdam
            p = dict(self._config.optimizer_params or {})
            self.optimizer = DeepSpeedCPUAdam(
                shards, lr=p.get("lr", 1e-3),
                betas=tuple(p.get("betas", (0.9, 0.999))),
                eps=p.get("eps", 1e-8),
                weight_decay=p.get("weight_decay", 0.0),
                adamw_mode=p.get("adam_w_mode", True),
                bias_correction=p.get("bias_correction", True),
                pin_memory=self.device.type == "cuda")
            self.master = None
            self.opt_state = ()
        else:
            self.master = shards
            self.opt_state = self.optimizer.init(self.master)

    # ------------------------------------------------------------------ #
    # config accessors
    # ------------------------------------------------------------------ #
    def train_batch_size(self):
        return self._config.train_batch_size

    def train_micro_batch_size_per_gpu(self):
        return self._config.train_micro_batch_size_per_gpu

    def steps_per_print(self):
        return self._config.steps_per_print

    def zero_optimization_stage(self):
        return self.zero_stage

    def get_lr(self):
        return [float(self._lr_at(self.global_step))]

    def get_mom(self):
        """The scheduled momentum, else the optimizer's beta1."""
        mom = self._mom_at(self.global_step)
        if mom is not None:
            return [float(mom)]
        return [float(getattr(self.optimizer, "b1", 0.0))]

    def _lr_at(self, step: int) -> float:
        if self.lr_scheduler is not None:
            return float(self.lr_scheduler.lr_at(step))
        return float(self.optimizer.lr)

    def _mom_at(self, step: int):
        """The schedule's momentum (OneCycle with ``cycle_momentum``),
        else None."""
        sch = self.lr_scheduler
        if sch is not None and getattr(sch, "cycle_momentum", False) and \
                hasattr(sch, "mom_at"):
            return float(sch.mom_at(step))
        return None

    @property
    def global_steps(self) -> int:
        return self.global_step

    @property
    def module_params(self):
        """The params the forward reads: the fp32 masters, or with ZeRO
        1-2 over more than one data rank and with offload the
        compute-dtype params. With ``overlap_comm`` offload an update may
        still be in flight, and they are one window stale: that warns once
        (call :meth:`synchronize` first, as save and eval do)."""
        if self._offload_pending is not None and \
                not self._warned_stale_params:
            self._warned_stale_params = True
            logger.warning(
                "module_params read with an overlapped ZeRO-Offload "
                "update still in flight: values are one window stale; "
                "call engine.synchronize() first for settled weights")
        return self.params

    def is_gradient_accumulation_boundary(self):
        """True while processing the last micro batch of the window."""
        return ((self._host_micro_step + 1) %
                self.gradient_accumulation_steps == 0)

    def deepspeed_io(self, dataset, batch_size=None, collate_fn=None):
        """A loader over global micro batches (micro batch x dp, of which
        each rank takes its rows), on the engine's device."""
        if batch_size is None:
            batch_size = (self.train_micro_batch_size_per_gpu() *
                          self.dp_world_size)
        return DeepSpeedDataLoader(dataset, batch_size=batch_size,
                                   device=self.device,
                                   collate_fn=collate_fn)

    # ------------------------------------------------------------------ #
    # the step
    # ------------------------------------------------------------------ #
    def _next_seed(self) -> int:
        """One int32 dropout seed per micro batch, from the engine's
        generator."""
        return int(torch.randint(-(2**31), 2**31 - 1, (1,),
                                 generator=self._generator))

    def _cast_for_loss(self, params):
        """fp32 masters -> compute dtype, differentiably (identity in
        fp32, and for the sharded params, which are in it already)."""
        if self.compute_dtype is None:
            return params
        return tree_map(lambda p: p.to(self.compute_dtype), params)

    def _call_loss(self, params, batch, seed):
        out = (self._loss_fn(params, batch, seed) if self._loss_takes_rng
               else self._loss_fn(params, batch))
        return out[0] if isinstance(out, tuple) else out

    def _compute_loss_and_grads(self, batch, seed):
        """One micro batch: the loss and the grads of
        ``loss / gradient_accumulation_steps`` w.r.t. the params, in
        sorted-leaf order (fp32; in the compute dtype on the direct
        offload path). The first call of an observed run counts its
        FLOPs."""
        return self.observability.maybe_profile_flops(
            "micro_step", self._micro_step, (batch, seed))

    def _local_batch(self, batch):
        """This rank's rows of a global micro batch, on the device."""
        return to_device(self._rows.take(batch), self.device)

    def _micro_step(self, batch, seed):
        batch = to_device(batch, self.device)
        with self.observability.span("forward"), \
                batch_rows(self._rows.index * self._local_rows(batch)):
            loss = self._call_loss(self._cast_for_loss(self.params), batch,
                                   seed)
        scaled = loss.float() / self.gradient_accumulation_steps
        leaves = list(tree_leaves(self.params))
        with self.observability.span("backward"):
            grads = torch.autograd.grad(scaled, leaves, allow_unused=True)
        # the direct offload path keeps the compute dtype: the grads cross
        # to the host as they are
        want = (self.compute_dtype or torch.float32) \
            if self._offload_direct else torch.float32
        grads = [torch.zeros_like(p, dtype=want) if g is None
                 else g.to(want) for p, g in zip(leaves, grads)]
        return loss.detach(), grads

    @staticmethod
    def _local_rows(batch) -> int:
        """The rows of a micro batch on this rank (its leading dim)."""
        for leaf in tree_leaves(batch):
            if getattr(leaf, "ndim", 0):
                return int(leaf.shape[0])
        return 0

    def _global_mean(self, loss):
        """A rank's loss averaged over the data-parallel ranks: the loss
        of the global batch."""
        if self.dp_world_size == 1:
            return loss
        out = loss.detach().float().clone()
        self._part.all_reduce_(out)
        return out / self.dp_world_size

    def _accumulate(self, grads):
        if self._scatter_per_micro:      # ZeRO 2: the grads' shards only
            grads = [self._part.reduce_scatter(i, g)
                     for i, g in enumerate(grads)]
        if self.accum_grads is None:
            self._pending_grads = grads
        else:
            torch._foreach_add_(self.accum_grads, grads)
        self.micro_step += 1

    def _window_grads(self):
        """The window's grads (accumulated, or the last micro step's):
        this rank's shard of each leaf (all of a replicated one), averaged
        over the ranks."""
        grads = (self.accum_grads if self.accum_grads is not None
                 else self._pending_grads)
        if grads is None:
            raise RuntimeError("step() must follow backward()")
        part, dp = self._part, self.dp_world_size
        if part is None:
            return grads
        if not self._scatter_per_micro:
            # the direct offload path reduces in fp32, then casts back
            grads = [part.reduce_scatter(i, g.float() if dp > 1 else g)
                     for i, g in enumerate(grads)]
        if dp > 1:
            grads = torch._foreach_div(grads, float(dp))
            if self._offload_direct and self.compute_dtype is not None:
                grads = [g.to(self.compute_dtype) for g in grads]
        return grads

    def _reset_window(self):
        if self.accum_grads is not None:
            torch._foreach_zero_(self.accum_grads)
        self._pending_grads = None
        self.micro_step = 0

    @torch.no_grad()
    def _apply_update(self):
        """Optimizer boundary: reduce, clip, update in place (then gather
        the params of the shards), reset the window."""
        grads = self._window_grads()
        if self.gradient_clipping > 0:
            sq = (self._part.sq_norm(grads) if self._sharded
                  else sum(torch.sum(g * g) for g in grads))
            clip = torch.clamp(self.gradient_clipping /
                               (torch.sqrt(sq) + 1e-6), max=1.0)
            grads = torch._foreach_mul(grads, clip)
        mom = self._mom_at(self.global_step)
        kw = {} if mom is None else {"momentum": mom}
        lr = self._lr_at(self.global_step)
        if self._sharded:
            self.master, self.opt_state = self.optimizer.update(
                grads, self.opt_state, self.master, lr=lr, **kw)
            for i, (p, m) in enumerate(zip(tree_leaves(self.params),
                                           self.master)):
                self._part.all_gather(i, m.to(p.dtype), p)
        else:
            self.params, self.opt_state = self.optimizer.update(
                tree_unflatten(self.params, grads), self.opt_state,
                self.params, lr=lr, **kw)
        self._reset_window()
        self.global_step += 1

    # -- ZeRO-Offload: the boundary in three parts, so that the host Adam
    # -- can overlap the next window's device work (the JAX engine's
    # -- _host_grad_snapshot / _host_optimize / _apply_host_result)
    @torch.no_grad()
    def _host_grad_snapshot(self):
        """The window's grad shards (averaged over the ranks) copied into
        pinned host buffers, with their global squared norm in fp64 (one
        scalar read; shards summed over the ranks, a replicated leaf once);
        the accumulator reset. Returns ``(host grads, squared norm)``."""
        grads = self._window_grads()
        sq = float(self._part.sq_norm(grads, torch.float64)) \
            if self.gradient_clipping > 0 else 0.0
        self._sync()                 # the device's work of the window ends
        t0 = time.perf_counter()
        if self._host_grads is None:
            pin = self.device.type == "cuda"
            self._host_grads = [torch.empty(g.numel(), dtype=g.dtype,
                                            pin_memory=pin) for g in grads]
        for h, g in zip(self._host_grads, grads):
            h.copy_(g.reshape(-1), non_blocking=True)
        self._sync()
        self.offload_stats["d2h_ms"] = (time.perf_counter() - t0) * 1e3
        self._reset_window()
        return self._host_grads, sq

    def _host_optimize(self, host_grads, sq, lr, mom=None):
        """Overflow check, clipping and the C++ SIMD Adam on this rank's
        host fp32 master shard (reference stage2.py:1418-1431). Touches
        host memory only, so it may run beside the device's next window.
        Returns ``(new params, overflow)``."""
        if not math.isfinite(sq):
            return None, True
        t0 = time.perf_counter()
        if host_grads[0].dtype != torch.float32:
            # widened into buffers made once: a fresh 4-bytes-a-param
            # tensor each step would pay its page faults every step
            if self._host_grads32 is None:
                self._host_grads32 = [torch.empty(g.numel()) for g in
                                      host_grads]
            for w, g in zip(self._host_grads32, host_grads):
                w.copy_(g)
            host_grads = self._host_grads32
        grads = host_grads
        if self.gradient_clipping > 0:
            clip = min(1.0, self.gradient_clipping / (math.sqrt(sq) + 1e-6))
            if clip < 1.0:
                torch._foreach_mul_(grads, float(np.float32(clip)))
        t1 = time.perf_counter()
        use_bf16 = self.compute_dtype == torch.bfloat16
        new = self.optimizer.step(grads, lr=lr, bf16_out=use_bf16, beta1=mom)
        # host clocks: the grads widened and clipped, then the C++ Adam
        self.offload_stats["prep_ms"] = (t1 - t0) * 1e3
        self.offload_stats["adam_ms"] = (time.perf_counter() - t1) * 1e3
        return new, False

    @torch.no_grad()
    def _apply_host_result(self, new_params, overflow):
        """The updated shards' H2D copy (from pinned memory, bf16 with
        bf16 compute) into the device params, all-gathered; the step
        counters."""
        if overflow:
            self.skipped_steps += 1
            return
        for i, (p, h) in enumerate(zip(tree_leaves(self.params),
                                       new_params)):
            shard = h.to(self.device, p.dtype, non_blocking=True).view(
                self._part.shard_shape(i))
            self._part.all_gather(i, shard, p)
        self.global_step += 1

    def _host_apply_update(self):
        """The synchronous offload boundary: snapshot, Adam, H2D."""
        grads, sq = self._host_grad_snapshot()
        mom = self._mom_at(self.global_step)
        self._apply_host_result(*self._host_optimize(
            grads, sq, self._lr_at(self.global_step), mom))

    def _host_apply_update_overlapped(self):
        """The overlapped boundary (``overlap_comm``): apply the previous
        window's pending update, snapshot this window's grads, and hand
        them to the worker thread, whose host Adam then runs beside the
        next window's device work: updates land one window late."""
        self._offload_drain()
        grads, sq = self._host_grad_snapshot()
        mom = self._mom_at(self.global_step)
        self._offload_pending = self._offload_pool.submit(
            self._host_optimize, grads, sq, self._lr_at(self.global_step),
            mom)

    def _offload_drain(self):
        if self._offload_pending is not None:
            pending, self._offload_pending = self._offload_pending, None
            self._apply_host_result(*pending.result())

    def synchronize(self):
        """Apply an overlapped offload update still in flight (no-op
        otherwise). Call before reading params outside the engine."""
        self._offload_drain()

    def _boundary(self):
        """The optimizer boundary of the configured path."""
        if not self.zero_cpu_offload:
            self._apply_update()
        elif self._offload_overlap:
            self._host_apply_update_overlapped()
        else:
            self._host_apply_update()

    def forward(self, batch):
        """Loss of one micro batch. As in the JAX engine, the backward
        pass runs here and its grads are cached for :meth:`backward`."""
        if self.wall_clock_breakdown_enabled:
            self.timers("forward").start()
        loss, self._cached_grads = self._compute_loss_and_grads(
            self._local_batch(batch), self._next_seed())
        self._cached_loss = self._global_mean(loss)
        if self.wall_clock_breakdown_enabled:
            self.timers("forward").stop()
        return self._cached_loss

    __call__ = forward

    def backward(self, loss=None):
        """Accumulate the grads cached by :meth:`forward`."""
        if self._cached_grads is None:
            raise RuntimeError("backward() must follow forward() on the "
                               "same micro batch")
        if self.wall_clock_breakdown_enabled:
            self.timers("backward").start()
        grads, self._cached_grads = self._cached_grads, None
        self._accumulate(grads)
        if self.wall_clock_breakdown_enabled:
            self.timers("backward").stop()
        return loss

    def step(self):
        """Apply the optimizer at the accumulation boundary."""
        if self.wall_clock_breakdown_enabled:
            self.timers("step").start()
        if self.is_gradient_accumulation_boundary():
            if self.accum_grads is None and self._pending_grads is None:
                raise RuntimeError("step() must follow backward()")
            with self.observability.span("step"):
                self._boundary()
            self._report_progress()
            self._write_monitor(self._cached_loss)
        self._host_micro_step += 1
        if self.wall_clock_breakdown_enabled:
            self.timers("step").stop()
            self.timers.log(["forward", "backward", "step"],
                            memory_breakdown=self._config.memory_breakdown)

    def _ensure_train_iter(self):
        if self.training_dataloader is None:
            raise ValueError("train_batch() without data_iter requires "
                             "training_data")
        if self._train_iter is None:
            self._train_iter = iter(RepeatingLoader(self.training_dataloader))
        return self._train_iter

    def train_batch(self, data_iter=None):
        """One full batch: ``gradient_accumulation_steps`` micro batches
        from ``data_iter`` (default: the training data), then the update.
        Returns the mean loss as a device scalar (``float`` of it, or
        :meth:`last_loss`, syncs)."""
        if data_iter is None:
            data_iter = self._ensure_train_iter()
        self._maybe_profile_step()
        if self._profiler is not None:
            with torch.profiler.record_function(
                    f"train_batch#{self.global_step}"):
                return self._train_batch(data_iter)
        return self._train_batch(data_iter)

    def _train_batch(self, data_iter):
        self.tput_timer.start()
        t_step0 = time.perf_counter()
        if self._window_anchor is None:
            # the telemetry window opens at the first step after a
            # (re)anchor, so flush-time averages never include idle time
            self._window_anchor = t_step0
        t_work = 0.0
        total = None
        with self.observability.span("train_batch"):
            for _ in range(self.gradient_accumulation_steps):
                with self.observability.span("data"):
                    batch = self._local_batch(next(data_iter))
                t0 = time.perf_counter()
                loss, grads = self._compute_loss_and_grads(
                    batch, self._next_seed())
                self._accumulate(grads)
                t_work += time.perf_counter() - t0
                total = loss if total is None else total + loss
            t0 = time.perf_counter()
            with self.observability.span("step"):
                self._boundary()
            t_work += time.perf_counter() - t0
        self.tput_timer.stop()
        if self.global_step == 1 and (self.monitor.enabled
                                      or self.observability.enabled):
            # the run's first step builds the kernels and counts its
            # FLOPs: one sync makes its time its own (_flush_monitor)
            t0 = time.perf_counter()
            self._sync()
            t_work += time.perf_counter() - t0
        # otherwise host time per dispatch, not device time: used for
        # the host gap only
        self._last_step_time_ms = (time.perf_counter() - t_step0) * 1e3
        self._host_gap_ms = max(self._last_step_time_ms - t_work * 1e3, 0.0)
        self._host_micro_step += self.gradient_accumulation_steps
        self._report_progress()
        self._last_loss = self._global_mean(
            total / self.gradient_accumulation_steps)
        self._write_monitor(self._last_loss)
        return self._last_loss

    def last_loss(self):
        """Python float of the latest ``train_batch`` mean loss (a sync
        point, which also flushes the telemetry ring); None before the
        first step."""
        if self._last_loss is None:
            return None
        if self._monitor_ring:
            self._flush_monitor()
        else:
            self._host_sync_count += 1
        return float(self._last_loss)

    def loss_scale(self) -> float:
        """1.0: bf16 and fp32 train unscaled (fp16 is not ported)."""
        return 1.0

    def close(self):
        """Apply an offload update in flight and stop its worker, stop an
        open trace window, flush the telemetry ring and seal the
        Observer's event log (idempotent)."""
        self._offload_drain()
        if self._offload_pool is not None:
            self._offload_pool.shutdown()
        if self._profiler is not None:
            self._stop_trace()
        if self._monitor_ring:
            self._flush_monitor()
        atexit.unregister(self._atexit_flush_hook)
        self.observability.close()

    @torch.no_grad()
    def eval_batch(self, batch):
        """Loss without grads or update, with no dropout (seed None). A
        single batch, or an iterator of micro batches drained up to the
        accumulation window (mean loss)."""
        if hasattr(batch, "__next__"):
            micros = []
            for _ in range(self.gradient_accumulation_steps):
                try:
                    micros.append(next(batch))
                except StopIteration:
                    break
        else:
            micros = [batch]
        if not micros:
            raise ValueError("eval_batch: empty micro-batch iterator")
        self._offload_drain()
        if self._monitor_ring:
            self._flush_monitor()   # eval is an explicit sync point
        total = None
        for m in micros:
            loss = self._call_loss(self._cast_for_loss(self.params),
                                   self._local_batch(m), None)
            total = loss if total is None else total + loss
        return self._global_mean(total / len(micros))

    # past this many unflushed steps the ring flushes whatever
    # steps_per_print says (the JAX engine's cap)
    _MONITOR_RING_CAP = 512

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _write_monitor(self, loss):
        """The step's telemetry, with the JAX engine's x-axis (cumulative
        samples): the loss is queued and written at the next flush
        barrier; the host counters and memory watermarks now."""
        if not (self.monitor.enabled or self.observability.enabled):
            return
        samples = self.global_step * self.train_batch_size()
        self.observability.record_flops(samples)
        self._monitor_ring.append(
            {"samples": samples, "host_step": self.global_step,
             "loss": loss, "raw_step_ms": self._last_step_time_ms})
        if (self.global_step % self._config.steps_per_print == 0
                or len(self._monitor_ring) >= self._MONITOR_RING_CAP):
            self._flush_monitor(at_step_boundary=True)
        self.observability.on_step(samples, host_gap_ms=self._host_gap_ms,
                                   host_syncs=self._host_sync_count)

    def _flush_monitor(self, at_step_boundary: bool = False):
        """Write the queued loss/lr records after synchronising the card,
        and at a step boundary the window's step time, samples/s and MFU:
        the wall time since the previous boundary over the window's
        steps, which is the card's step time however far the host ran
        ahead. The run's first step (kernel builds, allocator growth, the
        FLOP count; synchronised at its end) keeps its own time and
        leaves the average: the JAX engine pins its compiles to their
        step the same way. An out-of-band flush (last_loss, eval, close)
        writes no step time: arbitrary idle time may have passed."""
        ring, self._monitor_ring = self._monitor_ring, []
        if not ring:
            return
        self._host_sync_count += 1
        self._sync()
        avg_ms = first_ms = None
        if at_step_boundary:
            now = time.perf_counter()
            if self._window_anchor is not None:
                window_ms = (now - self._window_anchor) * 1e3
                if ring[0]["host_step"] == 1 and len(ring) > 1:
                    first_ms = ring[0]["raw_step_ms"]
                avg_ms = max(window_ms - (first_ms or 0.0), 0.0) / \
                    (len(ring) - (first_ms is not None))
            self._window_anchor = now
        else:
            self._window_anchor = None   # re-anchor at the next step
        scale = self.loss_scale()
        for rec in ring:
            self.monitor.write_train_metrics(
                loss=(float(rec["loss"]) if rec["loss"] is not None
                      else None),
                lr=self._lr_at(rec["host_step"]), loss_scale=scale,
                samples=rec["samples"], flush=False)
            if avg_ms is not None:
                step_ms = (first_ms if rec["host_step"] == 1 and first_ms
                           is not None else avg_ms)
                self.monitor.write_timer_values(
                    {"step_time_ms": step_ms}, rec["samples"])
                if step_ms > 0:
                    self.monitor.write_scalar(
                        "Train/Samples/samples_per_sec",
                        self.train_batch_size() / (step_ms / 1e3),
                        rec["samples"])
        self.observability.write_mfu(
            avg_ms, ring[-1]["samples"],
            micro_steps_per_step=self.gradient_accumulation_steps)
        self.monitor.flush()

    def _report_progress(self):
        step = self.global_step
        if step > 0 and step % self._config.steps_per_print == 0:
            log_dist(f"step={step} lr={self.get_lr()[0]:.3e}", ranks=[0])

    # ------------------------------------------------------------------ #
    # the trace window (the JAX engine's _maybe_profile_step)
    # ------------------------------------------------------------------ #
    def _maybe_profile_step(self):
        """Open a ``torch.profiler`` window at ``start_step`` and close it
        at ``start_step + num_steps``, at the top of ``train_batch`` as the
        JAX engine does; each step inside it is labelled
        ``train_batch#<global_step>``."""
        cfg = self._profiler_cfg
        if not cfg["enabled"]:
            return
        step = self.global_step
        start = int(cfg["start_step"])
        stop = start + int(cfg["num_steps"])
        if self._profiler is None and step == start:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._profiler = torch.profiler.profile(activities=acts)
            self._profiler.start()
            self._trace_first = step
            log_dist(f"profiler: trace started at step {step} -> "
                     f"{cfg['output_path']}", ranks=[0])
        elif self._profiler is not None and step >= stop:
            self._stop_trace()

    def _stop_trace(self):
        """Close the window and write its Chrome trace under
        ``output_path`` (``trace_path``)."""
        self._sync()
        prof, self._profiler = self._profiler, None
        prof.stop()
        out = self._profiler_cfg["output_path"]
        os.makedirs(out, exist_ok=True)
        self.trace_path = os.path.join(
            out, f"train_steps_{self._trace_first}-{self.global_step - 1}"
            ".pt.trace.json")
        prof.export_chrome_trace(self.trace_path)
        log_dist(f"profiler: trace stopped at step {self.global_step} -> "
                 f"{self.trace_path}", ranks=[0])

    # ------------------------------------------------------------------ #
    # checkpoints (the JAX engine's save_checkpoint / load_checkpoint)
    # ------------------------------------------------------------------ #
    def _optim_tree(self, opt_state=None) -> Dict[str, Any]:
        """The ``optim_states`` group: the optimizer state with its step
        as the JAX engine's int32, and the loss-scale constants."""
        opt_state = self.opt_state if opt_state is None else opt_state
        if hasattr(opt_state, "_fields") and "step" in opt_state._fields:
            opt_state = opt_state._replace(step=np.int32(opt_state.step))
        return {"opt_state": opt_state, "loss_scale": STATIC_LOSS_SCALE}

    def _rng_words(self):
        """Two uint32 words for ``meta["rng"]`` (the JAX engine's key
        layout), drawn from a copy of the generator so that saving does
        not move the port's own stream."""
        g = torch.Generator()
        g.set_state(self._generator.get_state())
        return [int(w) for w in torch.randint(0, 2**32, (2,), generator=g,
                                               dtype=torch.int64)]

    def save_checkpoint(self, save_dir: str, tag: Optional[str] = None,
                        client_state: Optional[Dict] = None,
                        async_: Optional[bool] = None):
        """Atomic-commit save, blocking: the shards land in
        ``<tag>.tmp/``, the ``COMMITTED`` marker (every file's size and
        CRC32) seals it, the directory is renamed to its tag, then
        ``latest`` is repointed. A crash at any point leaves the previous
        checkpoint intact or the new one committed. ``tag`` defaults to
        ``global_step<N>``. Returns the tag's directory."""
        if async_ or self._ckpt_cfg["async_save"]:
            raise NotImplementedError(
                "save_checkpoint(async_=True) needs the async checkpoint "
                "writer, not ported to deepspeed_tpu_torch yet (ROADMAP "
                "Queue 1 item 15)")
        self._offload_drain()
        if self._monitor_ring:
            self._flush_monitor()   # a save is a sync point
        ckpt.set_retry_policy(self._ckpt_cfg["io_retries"],
                              self._ckpt_cfg["io_retry_backoff"])
        t0 = time.time()
        snap_model, snap_optim, cpu_arrays, meta = \
            self._snapshot_train_state(client_state)
        if tag is None:
            tag = f"global_step{meta['global_step']}"
        snapshot_ms = (time.time() - t0) * 1000.0
        samples = self.global_step * self.train_batch_size()
        self.monitor.write_elastic_metrics(
            snapshot_ms=snapshot_ms, pending_saves=0, samples=samples,
            flush=False)
        # rank 0 writes the whole arrays, between two barriers: the state
        # is gathered before, the tag committed after
        self._barrier()
        try:
            if self.dp_rank != 0:
                return os.path.join(save_dir, tag)
            return self._write_checkpoint_job(save_dir, tag, snap_model,
                                              snap_optim, meta, samples,
                                              cpu_arrays)
        finally:
            self._barrier()

    def _snapshot_train_state(self, client_state=None):
        """The trees and meta a checkpoint carries, at the step boundary,
        as whole arrays: the live tensors pass straight through (the JAX
        engine's ``copy=False`` path of a blocking save; each leaf is
        copied to the host as its shard is written), and a sharded
        state is all-gathered first (every rank takes part). With offload
        also the host masters and moments, JAX's
        ``cpu_optim_states.npz`` arrays."""
        fault.fire("ckpt.snapshot")
        model, optim, cpu_arrays = self.params, self._optim_tree(), None
        if self.zero_cpu_offload:
            sd = self.optimizer.state_dict()
            cpu_arrays = {"step": np.asarray(sd["step"])}
            for key, arrays in (("mp", sd["master_params"]),
                                ("m", sd["exp_avg"]),
                                ("v", sd["exp_avg_sq"])):
                cpu_arrays.update({f"{key}_{i}": self._gather_host(i, a)
                                   for i, a in enumerate(arrays)})
        elif self._sharded:
            def whole(shards):
                return tree_unflatten(self.params, [
                    self._part.gather_full(i, t)
                    for i, t in enumerate(tree_leaves(shards))])
            model = whole(self.master)
            optim = self._optim_tree(self.opt_state._replace(
                exp_avg=whole(self.opt_state.exp_avg),
                exp_avg_sq=whole(self.opt_state.exp_avg_sq)))
        meta = {
            "global_step": int(self.global_step),
            "micro_step": int(self.micro_step),
            "skipped_steps": int(self.skipped_steps),
            "rng": self._rng_words(),
            "lr_scheduler": (self.lr_scheduler.state_dict()
                             if self.lr_scheduler is not None and
                             hasattr(self.lr_scheduler, "state_dict")
                             else None),
            "dp_world_size": self.dp_world_size,
            "zero_stage": self.zero_stage,
            "client_state": client_state or {},
            TORCH_RNG_KEY: self._generator.get_state().numpy()
            .tobytes().hex(),
        }
        return model, optim, cpu_arrays, meta

    def _gather_host(self, i: int, flat: np.ndarray) -> np.ndarray:
        """Leaf ``i``'s host shard (flat fp32) gathered into the whole
        leaf, flat."""
        if self.dp_world_size == 1:
            return flat
        shard = torch.from_numpy(flat).to(self.device).view(
            self._part.shard_shape(i))
        return self._part.gather_full(i, shard).cpu().numpy().ravel()

    def _barrier(self):
        if self.dp_world_size > 1:
            torch.distributed.barrier()

    def _write_checkpoint_job(self, save_dir, tag, snap_model, snap_optim,
                              meta, samples, cpu_arrays=None):
        """The stage/commit protocol, with the JAX engine's order and
        fault points."""
        t0 = time.time()
        final_dir = os.path.join(save_dir, tag)
        tmp_dir = final_dir + ckpt.TMP_SUFFIX
        if os.path.isdir(tmp_dir):      # staging left by a crashed save
            shutil.rmtree(tmp_dir)
        os.makedirs(tmp_dir, exist_ok=True)
        ckpt.save_tree_sharded(tmp_dir, "model_states", snap_model)
        fault.fire("ckpt.after_shard", name="model_states", dir=tmp_dir)
        ckpt.save_tree_sharded(tmp_dir, "optim_states", snap_optim)
        fault.fire("ckpt.after_shard", name="optim_states", dir=tmp_dir)
        if cpu_arrays is not None:
            ckpt._atomic_write_bytes(
                os.path.join(tmp_dir, "cpu_optim_states.npz"),
                ckpt._npz_bytes(cpu_arrays))
        self._save_checkpoint_extras(tmp_dir)
        ckpt.write_meta(tmp_dir, meta)
        fault.fire("ckpt.before_marker", dir=tmp_dir)
        ckpt.write_commit_marker(tmp_dir, process_count=1)
        fault.fire("ckpt.before_rename", dir=tmp_dir)
        # re-saving a tag: the old committed copy is renamed aside, not
        # deleted, so a crash between the two renames leaves
        # '<tag>.old', which list_tags still offers
        old_dir = final_dir + ckpt.OLD_SUFFIX
        if os.path.isdir(final_dir):
            if os.path.isdir(old_dir):
                shutil.rmtree(old_dir)
            os.rename(final_dir, old_dir)
        os.replace(tmp_dir, final_dir)
        ckpt._fsync_dir(save_dir)
        if os.path.isdir(old_dir):
            shutil.rmtree(old_dir)
        ckpt.write_latest(save_dir, tag)
        keep_n = int(self._ckpt_cfg["keep_n"] or 0)
        if keep_n > 0:
            dropped = ckpt.gc_old_tags(save_dir, keep_n)
            if dropped:
                log_dist(f"checkpoint retention (keep_n={keep_n}): "
                         f"removed {dropped}", ranks=[0])
        write_ms = (time.time() - t0) * 1000.0
        self.monitor.write_elastic_metrics(
            write_ms=write_ms, pending_saves=0, samples=samples,
            flush=False)
        self.monitor.write_checkpoint_event(
            action="save", ok=True, duration_ms=write_ms, samples=samples)
        log_dist(f"saved checkpoint {final_dir} "
                 f"(committed in {write_ms:.0f}ms)", ranks=[0])
        return final_dir

    def wait_pending_saves(self):
        """The JAX engine's async-save barrier. Saves here are blocking,
        so there is never one pending: it returns."""

    def _save_checkpoint_extras(self, ckpt_dir: str) -> None:
        """Subclass hook: files written here, into the staging dir, are
        sealed by the COMMITTED marker with the shards."""

    def load_checkpoint(self, load_dir: str, tag: Optional[str] = None,
                        load_optimizer_states: bool = True,
                        load_lr_scheduler_states: bool = True,
                        verify_integrity: Optional[bool] = None):
        """Verified load with fallback. An explicit ``tag`` must verify
        (marker, sizes and CRC32 unless ``verify_integrity=False``) or
        this raises; with ``tag=None`` the newest committed tag that
        verifies and loads is restored, a ``fallback`` row written for
        each tag skipped. Returns ``(tag_dir, client_state)``, or
        ``(None, {})`` when nothing loaded."""
        self._offload_drain()
        if self._monitor_ring:
            self._flush_monitor()
        ckpt.set_retry_policy(self._ckpt_cfg["io_retries"],
                              self._ckpt_cfg["io_retry_backoff"])
        t0 = time.time()
        if verify_integrity is None:
            verify_integrity = bool(self._ckpt_cfg["verify_checksums"])
        samples = self.global_step * self.train_batch_size()

        def loaded(ckpt_dir, result):
            self.monitor.write_checkpoint_event(
                action="load", ok=True,
                duration_ms=(time.time() - t0) * 1000.0, samples=samples)
            self._record_resume(ckpt_dir)
            return result

        if tag is not None:
            ckpt_dir = os.path.join(load_dir, tag)
            ok, problems = ckpt.verify_checkpoint_dir(
                ckpt_dir, check_crc=verify_integrity)
            if not ok:
                raise RuntimeError(
                    f"checkpoint {ckpt_dir} failed integrity verification: "
                    f"{'; '.join(problems)}")
            return loaded(ckpt_dir, self._load_checkpoint_dir(
                ckpt_dir, load_optimizer_states, load_lr_scheduler_states))

        latest = ckpt.read_latest(load_dir)
        candidates = ckpt.candidate_tags(load_dir)
        if not candidates:
            logger.warning(f"no loadable checkpoint tags in {load_dir}; "
                           "nothing loaded")
            return None, {}
        for cand in candidates:
            cand_dir = os.path.join(load_dir, cand)
            ok, problems = ckpt.verify_checkpoint_dir(
                cand_dir, check_crc=verify_integrity)
            if not ok:
                logger.warning(
                    f"skipping checkpoint {cand_dir}: "
                    f"{'; '.join(problems)}; falling back to an older tag")
                self.monitor.write_checkpoint_event(
                    action="fallback", ok=False, samples=samples)
                continue
            try:
                result = self._load_checkpoint_dir(
                    cand_dir, load_optimizer_states,
                    load_lr_scheduler_states)
            except fault.InjectedCrash:
                raise
            except Exception as e:
                logger.warning(f"failed to load checkpoint {cand_dir} "
                               f"({e!r}); falling back to an older tag")
                self.monitor.write_checkpoint_event(
                    action="fallback", ok=False, samples=samples)
                continue
            if latest is not None and cand != latest:
                logger.warning(
                    f"'latest' names {latest!r} but the newest committed "
                    f"and verified checkpoint is {cand!r}; resumed from it "
                    "(torn pointer or interrupted save)")
            return loaded(cand_dir, result)
        logger.warning(f"no committed and verified checkpoint in "
                       f"{load_dir}; nothing loaded")
        return None, {}

    def _record_resume(self, ckpt_dir: str) -> None:
        """The ``resume`` event row and the restart-count scalar after a
        restore (restarts stay 0: no supervisor relaunches the port)."""
        samples = self.global_step * self.train_batch_size()
        self.observability.event(
            "resume", step=self.global_step,
            tag=os.path.basename(ckpt_dir), restarts=0,
            preempted=ckpt.is_preemption_tag(ckpt_dir))
        self.monitor.write_elastic_metrics(restarts=0, samples=samples)

    def _ckpt_templates(self):
        """The templates a tag's ``model_states`` and ``optim_states`` load
        into, whole-leaf: the live trees, or for a sharded state their
        shapes on the ``meta`` device."""
        if not self._sharded or self.zero_cpu_offload:
            return self.params, self._optim_tree()

        def full():
            return tree_map(lambda p: torch.empty(
                p.shape, dtype=torch.float32, device="meta"), self.params)
        return full(), self._optim_tree(self.opt_state._replace(
            exp_avg=full(), exp_avg_sq=full()))

    def _load_device_state(self, loaded, opt):
        """The masters (this rank's shards when sharded; the live params
        were copied already) and the moments from whole loaded leaves;
        fresh moments at step 0 without ``opt``."""
        st = self.opt_state
        moments = [list(tree_leaves(st.exp_avg)),
                   list(tree_leaves(st.exp_avg_sq))]
        if self._sharded:
            for i, t in enumerate(loaded):
                self.master[i].copy_(self._part.shard(
                    i, t.to(self.device, torch.float32)))
        if opt is None:
            for dst in moments:
                torch._foreach_zero_(dst)
            self.opt_state = st._replace(step=0)
            return
        src = opt["opt_state"]
        for dst, tree in zip(moments, (src.exp_avg, src.exp_avg_sq)):
            for i, (d, t) in enumerate(zip(dst, tree_leaves(tree))):
                t = t.to(self.device)
                d.copy_(self._part.shard(i, t) if self._sharded else t)
        self.opt_state = st._replace(step=int(src.step))

    def _load_host_state(self, loaded, cpu_state):
        """The host optimizer's shards from the tag's
        ``cpu_optim_states.npz``; without it (``load_optimizer_states=
        False``) the masters re-seeded from the loaded weights, as the
        JAX engine does."""
        opt = self.optimizer

        def shard(i, flat):
            t = torch.from_numpy(np.ascontiguousarray(flat, np.float32)
                                 ).view(self._part.shapes[i])
            return self._part.shard(i, t).numpy().ravel()
        if cpu_state is None:
            for i, t in enumerate(loaded):
                np.copyto(opt.master_params[i],
                          shard(i, t.float().numpy().ravel()))
            return
        n = len(opt.master_params)
        opt.load_state_dict({
            "step": int(cpu_state["step"]),
            **{name: [shard(i, cpu_state[f"{key}_{i}"]) for i in range(n)]
               for name, key in (("master_params", "mp"), ("exp_avg", "m"),
                                 ("exp_avg_sq", "v"))}})

    def _load_checkpoint_dir(self, ckpt_dir: str,
                             load_optimizer_states: bool = True,
                             load_lr_scheduler_states: bool = True):
        """Restore the engine from one verified tag directory. Everything
        is read and checked on the host first, so a tag that fails leaves
        the engine as it was; then the params and moments are copied into
        the engine's live tensors, which the optimizer updates in place."""
        meta = ckpt.read_meta(ckpt_dir)
        missing = [k for k in ("global_step", "micro_step",
                               "skipped_steps", "rng") if k not in meta]
        if missing:
            raise KeyError(f"meta.json in {ckpt_dir} missing {missing}")
        if int(meta["skipped_steps"]):
            raise ValueError(
                f"checkpoint {ckpt_dir} skipped {meta['skipped_steps']} "
                "steps on overflow: an fp16 run, which the port does not "
                "train")
        words = np.asarray(meta["rng"], dtype=np.uint32)
        sharded = ckpt.sharded_exists(ckpt_dir, "model_states")

        def load(name, template):
            if sharded:
                return ckpt.load_tree_sharded(ckpt_dir, name, template)
            return ckpt.load_tree(os.path.join(ckpt_dir, f"{name}.npz"),
                                  template)
        model_tmpl, optim_tmpl = self._ckpt_templates()
        params = load("model_states", model_tmpl)
        opt = cpu_state = None
        if load_optimizer_states:
            opt = load("optim_states", optim_tmpl)
            got = tuple(float(v) for v in opt["loss_scale"])
            if got != tuple(float(v) for v in STATIC_LOSS_SCALE):
                raise ValueError(
                    f"checkpoint {ckpt_dir} holds loss_scale {got}, not the "
                    f"static scale of bf16 and fp32 {STATIC_LOSS_SCALE}: "
                    "loss scaling (fp16) is not ported")
            if self.zero_cpu_offload:
                cpu_path = os.path.join(ckpt_dir, "cpu_optim_states.npz")
                if not os.path.exists(cpu_path):
                    # without the host masters the first offload step
                    # would overwrite the loaded weights with init-time
                    # params: fail loudly instead
                    raise FileNotFoundError(
                        f"{cpu_path} missing: checkpoint was not saved by "
                        "a cpu_offload run. Re-save with offload enabled, "
                        "or pass load_optimizer_states=False and accept a "
                        "fresh optimizer (master params will be re-seeded "
                        "from the loaded model weights).")
                with np.load(cpu_path) as z:
                    cpu_state = {k: z[k] for k in z.files}
        saved_dp = meta.get("dp_world_size")
        if saved_dp is not None and saved_dp != self.dp_world_size:
            logger.warning(
                f"checkpoint {ckpt_dir} was saved at dp_world_size="
                f"{saved_dp}, resuming at {self.dp_world_size} (elastic "
                "repartition)")
        saved_stage = meta.get("zero_stage")
        if saved_stage is not None and saved_stage != self.zero_stage:
            logger.warning(f"checkpoint {ckpt_dir} was saved at "
                           f"zero_stage={saved_stage}, resuming at "
                           f"{self.zero_stage}")

        # -- from here on the engine changes --
        live = list(tree_leaves(self.params))
        loaded = list(tree_leaves(params))
        with torch.no_grad():
            torch._foreach_copy_(live, [t.to(self.device, p.dtype)
                                        for p, t in zip(live, loaded)])
            if self.zero_cpu_offload:
                self._load_host_state(loaded, cpu_state)
            else:
                self._load_device_state(loaded, opt)
            if self.accum_grads is not None:
                torch._foreach_zero_(self.accum_grads)
        self._pending_grads = self._cached_grads = None
        if load_lr_scheduler_states and self.lr_scheduler is not None and \
                meta.get("lr_scheduler") is not None and \
                hasattr(self.lr_scheduler, "load_state_dict"):
            self.lr_scheduler.load_state_dict(meta["lr_scheduler"])
        if TORCH_RNG_KEY in meta:
            self._generator.set_state(torch.frombuffer(
                bytearray.fromhex(meta[TORCH_RNG_KEY]), dtype=torch.uint8))
        else:   # a JAX tag: the generator is seeded from the key's words
            self._generator.manual_seed(
                (int(words[0]) << 32) | int(words[1]))
        self.global_step = int(meta["global_step"])
        self.micro_step = int(meta["micro_step"])
        self._host_micro_step = (self.global_step *
                                 self.gradient_accumulation_steps +
                                 self.micro_step)
        self._window_anchor = None
        log_dist(f"loaded checkpoint {ckpt_dir} (step={self.global_step}, "
                 f"saved at dp={saved_dp}, now dp={self.dp_world_size})",
                 ranks=[0])
        return ckpt_dir, meta.get("client_state", {})
