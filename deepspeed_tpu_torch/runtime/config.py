"""Config parsing (the port of ``deepspeed_tpu/runtime/config.py``,
``config_utils.py`` and ``zero/config.py``): the training keys of
:class:`DeepSpeedConfig` (the batch triangle, ``bf16``, ``fp16``,
``optimizer``, ``scheduler``, ``gradient_clipping``,
``zero_optimization.stage``, ``steps_per_print``,
``sparse_attention``, ``tensorboard``, the training ``observability``
switch), ``get_inference_config`` and the serving part of
``get_observability_config``. The same dict resolves to the same fields
and raises the same errors as the JAX package. ZeRO stages 0-2 (over
the ``data`` axis, or ``data_inter`` x ``data_intra``, of any size) and
ZeRO-Offload (``cpu_offload``, with ``overlap_comm``) are taken. Settings
whose runtime is not ported yet (stage 3, 1-bit Adam, pipeline, fp16, a
``pipe``, ``model``, ``seq`` or ``expert`` mesh axis above 1, the
training ``observability`` switch ``health.enabled``, and the
``checkpoint`` section's ``async_save`` and ``drain_on_preemption``)
raise ``NotImplementedError`` naming them; ``tensorboard``,
``observability.enabled``, the trace window (``observability.trace`` or
the legacy ``profiler``) and ``observability.serve`` are accepted. The
``checkpoint`` section is read by :func:`get_checkpoint_config` with the
JAX package's checks (its ``supervisor`` is checked and left to a
launcher). Before those refusals the values of
``bf16.stochastic_rounding``, ``quantized_comm`` (and its legacy alias
``compressed_allreduce``), ``comm_autotune``, ``async_pipeline`` and the
training ``observability`` keys get the JAX
package's checks and its ``DeepSpeedConfigError``, though the port runs
none of those sections yet.
"""

import collections
import json
from typing import Optional

from deepspeed_tpu_torch.runtime import constants as C


class DeepSpeedConfigError(Exception):
    pass


# the mesh axes of data parallelism: any size trains (ZeRO over them)
_DATA_AXES = ("data", "data_inter", "data_intra")


def get_scalar_param(param_dict, param_name, param_default_value):
    if param_dict is None:
        return param_default_value
    return param_dict.get(param_name, param_default_value)


def dict_raise_error_on_duplicate_keys(ordered_pairs):
    """json ``object_pairs_hook`` that rejects duplicate keys."""
    d = dict((k, v) for k, v in ordered_pairs)
    if len(d) != len(ordered_pairs):
        counter = collections.Counter(k for k, _ in ordered_pairs)
        keys = [k for k, v in counter.items() if v > 1]
        raise ValueError(
            "Duplicate keys in DeepSpeed-TPU config: {}".format(keys))
    return d


def _sub(param_dict, key):
    return param_dict[key] if key in param_dict else None


def get_train_micro_batch_size_per_gpu(param_dict):
    v = get_scalar_param(param_dict, C.TRAIN_MICRO_BATCH_SIZE_PER_GPU, None)
    if v is None:
        v = get_scalar_param(param_dict, C.TRAIN_MICRO_BATCH_SIZE_PER_CHIP,
                             C.TRAIN_MICRO_BATCH_SIZE_PER_GPU_DEFAULT)
    return v


def get_optimizer_name(param_dict):
    if C.OPTIMIZER in param_dict and C.TYPE in param_dict[C.OPTIMIZER]:
        return param_dict[C.OPTIMIZER][C.TYPE]
    return C.OPTIMIZER_TYPE_DEFAULT


def get_optimizer_params(param_dict):
    if get_optimizer_name(param_dict) is not None and \
            C.OPTIMIZER_PARAMS in param_dict[C.OPTIMIZER]:
        return param_dict[C.OPTIMIZER][C.OPTIMIZER_PARAMS]
    return None


def get_scheduler_name(param_dict):
    if C.SCHEDULER in param_dict and C.TYPE in param_dict[C.SCHEDULER]:
        return param_dict[C.SCHEDULER][C.TYPE]
    return C.SCHEDULER_TYPE_DEFAULT


def get_scheduler_params(param_dict):
    if get_scheduler_name(param_dict) is not None and \
            C.SCHEDULER_PARAMS in param_dict[C.SCHEDULER]:
        return param_dict[C.SCHEDULER][C.SCHEDULER_PARAMS]
    return None


# each sparse_attention mode's keys beside mode, block and
# different_layout_per_head, and every key's schema default
_SPARSE_MODE_KEYS = {
    C.SPARSE_DENSE_MODE: (),
    C.SPARSE_FIXED_MODE: (C.SPARSE_NUM_LOCAL_BLOCKS,
                          C.SPARSE_NUM_GLOBAL_BLOCKS,
                          C.SPARSE_ATTENTION_TYPE,
                          C.SPARSE_HORIZONTAL_GLOBAL_ATTENTION,
                          C.SPARSE_NUM_DIFFERENT_GLOBAL_PATTERNS),
    C.SPARSE_VARIABLE_MODE: (C.SPARSE_NUM_RANDOM_BLOCKS,
                             C.SPARSE_LOCAL_WINDOW_BLOCKS,
                             C.SPARSE_GLOBAL_BLOCK_INDICES,
                             C.SPARSE_GLOBAL_BLOCK_END_INDICES,
                             C.SPARSE_ATTENTION_TYPE,
                             C.SPARSE_HORIZONTAL_GLOBAL_ATTENTION),
    C.SPARSE_BIGBIRD_MODE: (C.SPARSE_NUM_RANDOM_BLOCKS,
                            C.SPARSE_NUM_SLIDING_WINDOW_BLOCKS,
                            C.SPARSE_NUM_GLOBAL_BLOCKS),
    C.SPARSE_BSLONGFORMER_MODE: (C.SPARSE_NUM_SLIDING_WINDOW_BLOCKS,
                                 C.SPARSE_GLOBAL_BLOCK_INDICES,
                                 C.SPARSE_GLOBAL_BLOCK_END_INDICES),
}
_SPARSE_DEFAULTS = {
    C.SPARSE_BLOCK: C.SPARSE_BLOCK_DEFAULT,
    C.SPARSE_DIFFERENT_LAYOUT_PER_HEAD:
        C.SPARSE_DIFFERENT_LAYOUT_PER_HEAD_DEFAULT,
    C.SPARSE_NUM_LOCAL_BLOCKS: C.SPARSE_NUM_LOCAL_BLOCKS_DEFAULT,
    C.SPARSE_NUM_GLOBAL_BLOCKS: C.SPARSE_NUM_GLOBAL_BLOCKS_DEFAULT,
    C.SPARSE_ATTENTION_TYPE: C.SPARSE_ATTENTION_TYPE_DEFAULT,
    C.SPARSE_HORIZONTAL_GLOBAL_ATTENTION:
        C.SPARSE_HORIZONTAL_GLOBAL_ATTENTION_DEFAULT,
    C.SPARSE_NUM_DIFFERENT_GLOBAL_PATTERNS:
        C.SPARSE_NUM_DIFFERENT_GLOBAL_PATTERNS_DEFAULT,
    C.SPARSE_NUM_RANDOM_BLOCKS: C.SPARSE_NUM_RANDOM_BLOCKS_DEFAULT,
    C.SPARSE_LOCAL_WINDOW_BLOCKS: C.SPARSE_LOCAL_WINDOW_BLOCKS_DEFAULT,
    C.SPARSE_GLOBAL_BLOCK_INDICES: C.SPARSE_GLOBAL_BLOCK_INDICES_DEFAULT,
    C.SPARSE_GLOBAL_BLOCK_END_INDICES:
        C.SPARSE_GLOBAL_BLOCK_END_INDICES_DEFAULT,
    C.SPARSE_NUM_SLIDING_WINDOW_BLOCKS:
        C.SPARSE_NUM_SLIDING_WINDOW_BLOCKS_DEFAULT,
}


def get_sparse_attention(param_dict):
    """Parse the ``sparse_attention`` sub-config: the mode, the JSON
    schema's defaults (block 16) and the keys of that mode only; None
    without the section."""
    if C.SPARSE_ATTENTION not in param_dict:
        return None
    sparsity = param_dict[C.SPARSE_ATTENTION]
    mode = get_scalar_param(sparsity, C.SPARSE_MODE, C.SPARSE_MODE_DEFAULT)
    if mode not in _SPARSE_MODE_KEYS:
        raise NotImplementedError(
            f"Given sparsity mode, {mode}, has not been implemented yet!")
    keys = (C.SPARSE_BLOCK, C.SPARSE_DIFFERENT_LAYOUT_PER_HEAD,
            *_SPARSE_MODE_KEYS[mode])
    return {C.SPARSE_MODE: mode,
            **{k: get_scalar_param(sparsity, k, _SPARSE_DEFAULTS[k])
               for k in keys}}


def get_quantized_comm_config(param_dict):
    """The ``quantized_comm`` section, with the legacy
    ``compressed_allreduce: {enabled, block}`` seeding its defaults (an
    explicit ``quantized_comm`` key wins). ``hierarchical: true`` is
    refused: the intra-slice size is a topology fact."""
    legacy = param_dict.get(C.COMPRESSED_ALLREDUCE, {})
    sub = param_dict.get(C.QUANTIZED_COMM, {})
    hierarchical = sub.get(C.QUANTIZED_COMM_HIERARCHICAL,
                           C.QUANTIZED_COMM_HIERARCHICAL_DEFAULT)
    if hierarchical is True:
        raise DeepSpeedConfigError(
            "quantized_comm.hierarchical must be the intra-slice size "
            "(an int >= 2), not true — the split is a topology fact the "
            "engine cannot guess")
    return {
        "enabled": sub.get(
            C.QUANTIZED_COMM_ENABLED,
            legacy.get(C.COMPRESSED_ALLREDUCE_ENABLED,
                       C.QUANTIZED_COMM_ENABLED_DEFAULT)),
        "algo": sub.get(C.QUANTIZED_COMM_ALGO,
                        C.QUANTIZED_COMM_ALGO_DEFAULT),
        "block": sub.get(
            C.QUANTIZED_COMM_BLOCK,
            legacy.get(C.COMPRESSED_ALLREDUCE_BLOCK,
                       C.QUANTIZED_COMM_BLOCK_DEFAULT)),
        "hierarchical": int(hierarchical or 0),
        "quantize_weights": sub.get(
            C.QUANTIZED_COMM_QUANTIZE_WEIGHTS,
            C.QUANTIZED_COMM_QUANTIZE_WEIGHTS_DEFAULT),
        "secondary_partition": sub.get(
            C.QUANTIZED_COMM_SECONDARY_PARTITION,
            C.QUANTIZED_COMM_SECONDARY_PARTITION_DEFAULT),
    }


def get_comm_autotune_config(param_dict):
    """The ``comm_autotune`` section. JSON 0/1 for ``overlap`` mean
    false/true; a value that does not coerce gets the section's error."""
    sub = param_dict.get(C.COMM_AUTOTUNE, {})
    overlap = sub.get(C.COMM_AUTOTUNE_OVERLAP,
                      C.COMM_AUTOTUNE_OVERLAP_DEFAULT)
    if isinstance(overlap, int) and not isinstance(overlap, bool):
        overlap = bool(overlap)
    try:
        return {
            "enabled": sub.get(C.COMM_AUTOTUNE_ENABLED,
                               C.COMM_AUTOTUNE_ENABLED_DEFAULT),
            "overlap": overlap,
            "calibrate": sub.get(C.COMM_AUTOTUNE_CALIBRATE,
                                 C.COMM_AUTOTUNE_CALIBRATE_DEFAULT),
            "intra_size": int(sub.get(C.COMM_AUTOTUNE_INTRA_SIZE,
                                      C.COMM_AUTOTUNE_INTRA_SIZE_DEFAULT)
                              or 0),
            "intra_gbps": float(sub.get(C.COMM_AUTOTUNE_INTRA_GBPS,
                                        C.COMM_AUTOTUNE_INTRA_GBPS_DEFAULT)),
            "inter_gbps": float(sub.get(C.COMM_AUTOTUNE_INTER_GBPS,
                                        C.COMM_AUTOTUNE_INTER_GBPS_DEFAULT)),
            "intra_latency_us": float(sub.get(
                C.COMM_AUTOTUNE_INTRA_LATENCY_US,
                C.COMM_AUTOTUNE_INTRA_LATENCY_US_DEFAULT)),
            "inter_latency_us": float(sub.get(
                C.COMM_AUTOTUNE_INTER_LATENCY_US,
                C.COMM_AUTOTUNE_INTER_LATENCY_US_DEFAULT)),
            "block_candidates": list(sub.get(
                C.COMM_AUTOTUNE_BLOCK_CANDIDATES,
                C.COMM_AUTOTUNE_BLOCK_CANDIDATES_DEFAULT)),
        }
    except (TypeError, ValueError) as e:
        raise DeepSpeedConfigError(
            f"comm_autotune: malformed value ({e}); intra_size and "
            "latencies/bandwidths must be numbers, block_candidates a "
            "list of ints")


def get_async_pipeline_config(param_dict):
    """The ``async_pipeline`` section: every knob has its default."""
    sub = param_dict.get(C.ASYNC_PIPELINE, {})
    return {
        "fused_accumulation": sub.get(C.ASYNC_FUSED_ACCUMULATION,
                                      C.ASYNC_FUSED_ACCUMULATION_DEFAULT),
        "prefetch_depth": sub.get(C.ASYNC_PREFETCH_DEPTH,
                                  C.ASYNC_PREFETCH_DEPTH_DEFAULT),
        "sync_loss_every_step": sub.get(
            C.ASYNC_SYNC_LOSS_EVERY_STEP,
            C.ASYNC_SYNC_LOSS_EVERY_STEP_DEFAULT),
    }


def _health_config(sub):
    """``observability.health``, with the JAX package's checks."""
    hl = sub.get(C.OBS_HEALTH, {}) or {}
    det = hl.get(C.OBS_HEALTH_DETECTORS, {}) or {}
    health = {
        "enabled": bool(hl.get(C.OBS_HEALTH_ENABLED,
                               C.OBS_HEALTH_ENABLED_DEFAULT)),
        "ring_events": int(hl.get(C.OBS_HEALTH_RING_EVENTS,
                                  C.OBS_HEALTH_RING_EVENTS_DEFAULT)),
        "stall_timeout_s": float(hl.get(
            C.OBS_HEALTH_STALL_TIMEOUT_S,
            C.OBS_HEALTH_STALL_TIMEOUT_S_DEFAULT)),
        "on_stall": str(hl.get(C.OBS_HEALTH_ON_STALL,
                               C.OBS_HEALTH_ON_STALL_DEFAULT)),
        "flight_path": str(hl.get(C.OBS_HEALTH_FLIGHT_PATH,
                                  C.OBS_HEALTH_FLIGHT_PATH_DEFAULT)),
        "detectors": {
            "enabled": bool(det.get(C.OBS_HEALTH_DET_ENABLED,
                                    C.OBS_HEALTH_DET_ENABLED_DEFAULT)),
            "nonfinite_streak": int(det.get(
                C.OBS_HEALTH_DET_NONFINITE_STREAK,
                C.OBS_HEALTH_DET_NONFINITE_STREAK_DEFAULT)),
            "spike_zscore": float(det.get(
                C.OBS_HEALTH_DET_SPIKE_ZSCORE,
                C.OBS_HEALTH_DET_SPIKE_ZSCORE_DEFAULT)),
            "spike_window": int(det.get(
                C.OBS_HEALTH_DET_SPIKE_WINDOW,
                C.OBS_HEALTH_DET_SPIKE_WINDOW_DEFAULT)),
            "grad_norm_max": float(det.get(
                C.OBS_HEALTH_DET_GRAD_NORM_MAX,
                C.OBS_HEALTH_DET_GRAD_NORM_MAX_DEFAULT)),
            "scale_collapse_below": float(det.get(
                C.OBS_HEALTH_DET_SCALE_COLLAPSE_BELOW,
                C.OBS_HEALTH_DET_SCALE_COLLAPSE_BELOW_DEFAULT)),
            "recompile_storm_count": int(det.get(
                C.OBS_HEALTH_DET_RECOMPILE_STORM_COUNT,
                C.OBS_HEALTH_DET_RECOMPILE_STORM_COUNT_DEFAULT)),
            "recompile_storm_window": int(det.get(
                C.OBS_HEALTH_DET_RECOMPILE_STORM_WINDOW,
                C.OBS_HEALTH_DET_RECOMPILE_STORM_WINDOW_DEFAULT)),
        },
    }
    if health["ring_events"] < 1:
        raise DeepSpeedConfigError(
            "observability.health.ring_events must be >= 1, got "
            f"{health['ring_events']}")
    if health["stall_timeout_s"] < 0:
        raise DeepSpeedConfigError(
            "observability.health.stall_timeout_s must be >= 0 (0 "
            f"disables the watchdog), got {health['stall_timeout_s']}")
    if health["on_stall"] not in ("warn", "exit"):
        raise DeepSpeedConfigError(
            "observability.health.on_stall must be 'warn' or 'exit', "
            f"got {health['on_stall']!r}")
    _det = health["detectors"]
    if _det["nonfinite_streak"] < 1 or _det["spike_window"] < 2 or \
            _det["recompile_storm_count"] < 1 or \
            _det["recompile_storm_window"] < 1:
        raise DeepSpeedConfigError(
            "observability.health.detectors window/streak/count knobs "
            f"must be positive, got {_det}")
    if _det["spike_zscore"] <= 0 or _det["grad_norm_max"] <= 0 or \
            _det["scale_collapse_below"] <= 0:
        raise DeepSpeedConfigError(
            "observability.health.detectors thresholds must be > 0, "
            f"got {_det}")
    return health


def get_training_observability_config(param_dict):
    """The training part of the ``observability`` section: the switch,
    ``events_dir``, the profiler knobs, ``health`` and the ``trace``
    window, with the legacy top-level ``profiler`` section seeding
    ``trace`` (an explicit ``observability.trace`` key wins)."""
    legacy_trace = param_dict.get(C.PROFILER, {})
    sub = param_dict.get(C.OBSERVABILITY, {})
    tr = sub.get(C.OBS_TRACE, {})

    def trace_key(key, default):
        return tr.get(key, legacy_trace.get(key, default))
    return {
        "enabled": sub.get(C.OBS_ENABLED, C.OBS_ENABLED_DEFAULT),
        "events_dir": sub.get(C.OBS_EVENTS_DIR, C.OBS_EVENTS_DIR_DEFAULT),
        "flops_profiler": sub.get(C.OBS_FLOPS_PROFILER,
                                  C.OBS_FLOPS_PROFILER_DEFAULT),
        "memory_watermarks": sub.get(C.OBS_MEMORY_WATERMARKS,
                                     C.OBS_MEMORY_WATERMARKS_DEFAULT),
        "recompile_warn_after": sub.get(C.OBS_RECOMPILE_WARN_AFTER,
                                        C.OBS_RECOMPILE_WARN_AFTER_DEFAULT),
        "chrome_trace_path": sub.get(C.OBS_CHROME_TRACE_PATH,
                                     C.OBS_CHROME_TRACE_PATH_DEFAULT),
        "events_max_mb": float(sub.get(C.OBS_EVENTS_MAX_MB,
                                       C.OBS_EVENTS_MAX_MB_DEFAULT)),
        "health": _health_config(sub),
        "trace": {
            "enabled": trace_key(C.PROFILER_ENABLED,
                                 C.PROFILER_ENABLED_DEFAULT),
            "output_path": trace_key(C.PROFILER_OUTPUT_PATH,
                                     C.PROFILER_OUTPUT_PATH_DEFAULT),
            "start_step": trace_key(C.PROFILER_START_STEP,
                                    C.PROFILER_START_STEP_DEFAULT),
            "num_steps": trace_key(C.PROFILER_NUM_STEPS,
                                   C.PROFILER_NUM_STEPS_DEFAULT),
        },
    }


def get_checkpoint_config(param_dict):
    """The ``checkpoint`` section: atomic commit, verification, retention
    and I/O retries (``runtime/checkpoint.py``), with the JAX package's
    three checks. ``async_save`` and ``drain_on_preemption`` parse here
    and are refused by :class:`DeepSpeedConfig`; ``supervisor`` is the
    launcher's, checked and not used by the engine."""
    sub = param_dict.get(C.CHECKPOINT, {})
    sup = sub.get(C.CHECKPOINT_SUPERVISOR, {}) or {}
    cfg = {
        "verify_checksums": sub.get(C.CHECKPOINT_VERIFY_CHECKSUMS,
                                    C.CHECKPOINT_VERIFY_CHECKSUMS_DEFAULT),
        "keep_n": sub.get(C.CHECKPOINT_KEEP_N, C.CHECKPOINT_KEEP_N_DEFAULT),
        "io_retries": sub.get(C.CHECKPOINT_IO_RETRIES,
                              C.CHECKPOINT_IO_RETRIES_DEFAULT),
        "io_retry_backoff": sub.get(C.CHECKPOINT_IO_RETRY_BACKOFF,
                                    C.CHECKPOINT_IO_RETRY_BACKOFF_DEFAULT),
        "async_save": bool(sub.get(C.CHECKPOINT_ASYNC_SAVE,
                                   C.CHECKPOINT_ASYNC_SAVE_DEFAULT)),
        "drain_on_preemption": bool(sub.get(
            C.CHECKPOINT_DRAIN_ON_PREEMPTION,
            C.CHECKPOINT_DRAIN_ON_PREEMPTION_DEFAULT)),
        "save_dir": sub.get(C.CHECKPOINT_SAVE_DIR,
                            C.CHECKPOINT_SAVE_DIR_DEFAULT),
        "supervisor": {
            "max_restarts": int(sup.get(
                C.CHECKPOINT_SUPERVISOR_MAX_RESTARTS,
                C.CHECKPOINT_SUPERVISOR_MAX_RESTARTS_DEFAULT)),
            "backoff": float(sup.get(
                C.CHECKPOINT_SUPERVISOR_BACKOFF,
                C.CHECKPOINT_SUPERVISOR_BACKOFF_DEFAULT)),
        },
    }
    if cfg["supervisor"]["max_restarts"] < 0:
        raise DeepSpeedConfigError(
            "checkpoint.supervisor.max_restarts must be >= 0, got "
            f"{cfg['supervisor']['max_restarts']}")
    if cfg["supervisor"]["backoff"] < 0:
        raise DeepSpeedConfigError(
            "checkpoint.supervisor.backoff must be >= 0, got "
            f"{cfg['supervisor']['backoff']}")
    if cfg["save_dir"] is not None and not isinstance(cfg["save_dir"], str):
        raise DeepSpeedConfigError(
            "checkpoint.save_dir must be a path string or null")
    return cfg


class DeepSpeedZeroConfig:
    """The ``zero_optimization`` section's stage, offload switch and
    ``overlap_comm`` (the legacy boolean form means stage 1)."""

    def __init__(self, param_dict):
        sub = param_dict.get(C.ZERO_OPTIMIZATION, {})
        if isinstance(sub, bool):
            sub = {C.ZERO_OPTIMIZATION_STAGE: 1 if sub else 0}
        self.stage = get_scalar_param(sub, C.ZERO_OPTIMIZATION_STAGE,
                                      C.ZERO_OPTIMIZATION_STAGE_DEFAULT)
        self.cpu_offload = get_scalar_param(
            sub, C.ZERO_OPTIMIZATION_CPU_OFFLOAD,
            C.ZERO_OPTIMIZATION_CPU_OFFLOAD_DEFAULT)
        self.overlap_comm = get_scalar_param(
            sub, C.ZERO_OPTIMIZATION_OVERLAP_COMM,
            C.ZERO_OPTIMIZATION_OVERLAP_COMM_DEFAULT)


class DeepSpeedConfig:
    """Parsed view of the training config. ``world_size`` is the
    data-parallel degree the batch triangle resolves against (the
    engine passes its mesh's data size)."""

    def __init__(self, json_file_or_dict, world_size: Optional[int] = None):
        if isinstance(json_file_or_dict, dict):
            self._param_dict = json_file_or_dict
        else:
            with open(json_file_or_dict, "r") as f:
                self._param_dict = json.load(
                    f, object_pairs_hook=dict_raise_error_on_duplicate_keys)
        self.world_size = 1 if world_size is None else int(world_size)
        self._initialize_params(self._param_dict)
        self._set_batch_related_parameters()
        self._batch_assertion()
        self._do_error_check()

    def _initialize_params(self, d):
        self.train_batch_size = get_scalar_param(
            d, C.TRAIN_BATCH_SIZE, C.TRAIN_BATCH_SIZE_DEFAULT)
        self.train_micro_batch_size_per_gpu = \
            get_train_micro_batch_size_per_gpu(d)
        self.gradient_accumulation_steps = get_scalar_param(
            d, C.GRADIENT_ACCUMULATION_STEPS,
            C.GRADIENT_ACCUMULATION_STEPS_DEFAULT)
        self.steps_per_print = get_scalar_param(d, C.STEPS_PER_PRINT,
                                                C.STEPS_PER_PRINT_DEFAULT)
        self.zero_config = DeepSpeedZeroConfig(d)
        self.zero_optimization_stage = self.zero_config.stage
        self.gradient_clipping = get_scalar_param(
            d, C.GRADIENT_CLIPPING, C.GRADIENT_CLIPPING_DEFAULT)
        self.fp16_enabled = get_scalar_param(
            _sub(d, C.FP16), C.FP16_ENABLED, C.FP16_ENABLED_DEFAULT)
        self.bf16_enabled = get_scalar_param(
            _sub(d, C.BF16), C.BF16_ENABLED, C.BF16_ENABLED_DEFAULT)
        self.bf16_master_weights = get_scalar_param(
            _sub(d, C.BF16), C.BF16_MASTER_WEIGHTS,
            C.BF16_MASTER_WEIGHTS_DEFAULT)
        self.bf16_stochastic_rounding = get_scalar_param(
            _sub(d, C.BF16), C.BF16_STOCHASTIC_ROUNDING,
            C.BF16_STOCHASTIC_ROUNDING_DEFAULT)
        self.sparse_gradients_enabled = get_scalar_param(
            d, C.SPARSE_GRADIENTS, C.SPARSE_GRADIENTS_DEFAULT)
        self.optimizer_name = get_optimizer_name(d)
        if self.optimizer_name is not None and \
                self.optimizer_name.lower() in C.DEEPSPEED_OPTIMIZERS:
            self.optimizer_name = self.optimizer_name.lower()
        self.optimizer_params = get_optimizer_params(d)
        self.scheduler_name = get_scheduler_name(d)
        self.scheduler_params = get_scheduler_params(d)
        self.wall_clock_breakdown = get_scalar_param(
            d, C.WALL_CLOCK_BREAKDOWN, C.WALL_CLOCK_BREAKDOWN_DEFAULT)
        self.memory_breakdown = get_scalar_param(
            d, C.MEMORY_BREAKDOWN, C.MEMORY_BREAKDOWN_DEFAULT)
        self.sparse_attention = get_sparse_attention(d)
        self.quantized_comm_config = get_quantized_comm_config(d)
        self.comm_autotune_config = get_comm_autotune_config(d)
        self.async_pipeline_config = get_async_pipeline_config(d)
        self.observability_config = get_training_observability_config(d)
        self.profiler_config = self.observability_config["trace"]
        self.checkpoint_config = get_checkpoint_config(d)
        tb = _sub(d, C.TENSORBOARD)
        self.tensorboard_enabled = get_scalar_param(
            tb, C.TENSORBOARD_ENABLED, C.TENSORBOARD_ENABLED_DEFAULT)
        self.tensorboard_output_path = get_scalar_param(
            tb, C.TENSORBOARD_OUTPUT_PATH, C.TENSORBOARD_OUTPUT_PATH_DEFAULT)
        self.tensorboard_job_name = get_scalar_param(
            tb, C.TENSORBOARD_JOB_NAME, C.TENSORBOARD_JOB_NAME_DEFAULT)

    def _set_batch_related_parameters(self):
        """Solve the batch triangle from the keys given."""
        train_batch = self.train_batch_size
        micro_batch = self.train_micro_batch_size_per_gpu
        grad_acc = self.gradient_accumulation_steps
        if all(x is not None for x in [train_batch, micro_batch, grad_acc]):
            return
        elif train_batch is not None and micro_batch is not None:
            grad_acc = train_batch // micro_batch
            grad_acc //= self.world_size
            self.gradient_accumulation_steps = grad_acc
        elif train_batch is not None and grad_acc is not None:
            micro_batch = train_batch // self.world_size
            micro_batch //= grad_acc
            self.train_micro_batch_size_per_gpu = micro_batch
        elif micro_batch is not None and grad_acc is not None:
            self.train_batch_size = micro_batch * grad_acc * self.world_size
        elif train_batch is not None:
            self.gradient_accumulation_steps = 1
            self.train_micro_batch_size_per_gpu = \
                train_batch // self.world_size
        elif micro_batch is not None:
            self.train_batch_size = micro_batch * self.world_size
            self.gradient_accumulation_steps = 1
        else:
            raise DeepSpeedConfigError(
                "Either train_batch_size or train_micro_batch_size_per_gpu "
                "needs to be provided")

    def _batch_assertion(self):
        train_batch = self.train_batch_size
        micro_batch = self.train_micro_batch_size_per_gpu
        grad_acc = self.gradient_accumulation_steps
        if not (train_batch > 0 and micro_batch > 0 and grad_acc > 0):
            raise DeepSpeedConfigError(
                f"batch sizes must be > 0: train_batch_size {train_batch}, "
                f"micro batch {micro_batch}, grad acc {grad_acc}")
        if train_batch != micro_batch * grad_acc * self.world_size:
            raise DeepSpeedConfigError(
                f"Check batch related parameters. train_batch_size is not "
                f"equal to micro_batch_per_gpu * gradient_acc_step * "
                f"world_size {train_batch} != {micro_batch} * {grad_acc} * "
                f"{self.world_size}")

    def _do_error_check(self):
        if self.fp16_enabled and self.bf16_enabled:
            raise DeepSpeedConfigError(
                "fp16 and bf16 cannot both be enabled; pick one")
        self._value_checks()
        unported = []
        stage = self.zero_optimization_stage
        if stage > 2:
            unported.append(f"zero_optimization.stage {stage} (ZeRO stage 3, "
                            "ROADMAP Queue 1 item 18)")
        if self.optimizer_name and "onebit" in \
                self.optimizer_name.lower().replace("_", ""):
            unported.append(f"optimizer {self.optimizer_name} (1-bit Adam)")
        if C.PIPELINE in self._param_dict:
            unported.append("pipeline (ROADMAP Queue 1 item 14)")
        obs = self.observability_config
        if obs["health"]["enabled"]:
            unported.append("observability.health.enabled (the flight "
                            "recorder and watchdog, ROADMAP Queue 1 item "
                            "15)")
        axes = (self._param_dict.get(C.MESH) or {}).get(C.MESH_AXES) or {}
        wide = {a: n for a, n in axes.items()
                if n not in (1, -1) and a not in _DATA_AXES}
        if wide:
            unported.append(f"mesh.axes {wide} (pipeline and tensor, "
                            "sequence or expert parallelism, ROADMAP Queue 1 "
                            "items 14 and 16)")
        ck = self.checkpoint_config
        if ck["async_save"]:
            unported.append("checkpoint.async_save (the async checkpoint "
                            "writer, ROADMAP Queue 1 item 15)")
        if ck["drain_on_preemption"]:
            unported.append("checkpoint.drain_on_preemption (the "
                            "preemption drain, ROADMAP Queue 1 item 15)")
        if self.fp16_enabled:
            unported.append("fp16.enabled (fp16 and loss scaling)")
        if not self.bf16_master_weights:
            unported.append("bf16.master_weights=false (stochastic "
                            "rounding)")
        if unported:
            raise NotImplementedError(
                "not ported to deepspeed_tpu_torch yet: "
                + ", ".join(unported))

    def _value_checks(self):
        """The JAX package's value checks (deepspeed_tpu/runtime/config.py
        ``_do_error_check``), run before the refusals of what is not
        ported, so a bad value gets its DeepSpeedConfigError."""
        if not self.bf16_master_weights:
            if not self.bf16_enabled:
                raise DeepSpeedConfigError(
                    "bf16.master_weights=false requires bf16.enabled=true "
                    "(params are held in bf16 end-to-end)")
            if not self.bf16_stochastic_rounding:
                raise DeepSpeedConfigError(
                    "bf16.master_weights=false requires "
                    "bf16.stochastic_rounding=true: RNE-cast bf16 updates "
                    "silently drop sub-ulp steps (set it explicitly to "
                    "acknowledge the rounding-mode change)")
        if self.bf16_stochastic_rounding and not self.bf16_enabled:
            raise DeepSpeedConfigError(
                "bf16.stochastic_rounding=true requires bf16.enabled=true")
        if not self.bf16_master_weights and \
                self.zero_optimization_stage > 0 and \
                self.zero_config.cpu_offload:
            raise DeepSpeedConfigError(
                "bf16.master_weights=false contradicts ZeRO-Offload: the "
                "offloaded host fp32 copy IS a master copy (drop one of "
                "the two)")
        qc = self.quantized_comm_config
        if qc["algo"] not in C.QUANTIZED_ALGOS:
            raise DeepSpeedConfigError(
                f"quantized_comm.algo must be one of {C.QUANTIZED_ALGOS}, "
                f"got {qc['algo']!r}")
        if qc["block"] < 8:
            raise DeepSpeedConfigError(
                f"quantized_comm.block must be >= 8, got {qc['block']}")
        if qc["hierarchical"] == 1 or qc["hierarchical"] < 0:
            raise DeepSpeedConfigError(
                "quantized_comm.hierarchical must be 0 (off) or the "
                f"intra-slice size >= 2, got {qc['hierarchical']}")
        if qc["secondary_partition"] and not qc["hierarchical"]:
            raise DeepSpeedConfigError(
                "quantized_comm.secondary_partition (hpZ) needs "
                "quantized_comm.hierarchical >= 2: the secondary shard IS "
                "the intra-slice copy")
        if qc["enabled"] and qc["hierarchical"]:
            if qc["algo"] != "twohop":
                raise DeepSpeedConfigError(
                    "quantized_comm.hierarchical requires algo='twohop' "
                    f"(got {qc['algo']!r}: the legacy allgather exchange "
                    "has no 2D form)")
            if self.sparse_gradients_enabled:
                raise DeepSpeedConfigError(
                    "quantized_comm.hierarchical does not compose with "
                    "sparse_gradients (the CSR exchange is written "
                    "against the flat 'data' axis)")
            if self.optimizer_name and \
                    "onebit" in self.optimizer_name.lower().replace("_", ""):
                raise DeepSpeedConfigError(
                    "quantized_comm.hierarchical does not compose with "
                    "OnebitAdam (its compressed exchange is written "
                    "against the flat 'data' axis)")
        ca = self.comm_autotune_config
        if ca["overlap"] not in (True, False, "auto"):
            raise DeepSpeedConfigError(
                "comm_autotune.overlap must be true, false or \"auto\", "
                f"got {ca['overlap']!r}")
        if ca["intra_size"] == 1 or ca["intra_size"] < 0:
            raise DeepSpeedConfigError(
                "comm_autotune.intra_size must be 0 (infer) or the "
                f"fast-wire extent >= 2, got {ca['intra_size']}")
        if ca["intra_gbps"] <= 0 or ca["inter_gbps"] <= 0:
            raise DeepSpeedConfigError(
                "comm_autotune bandwidths must be > 0 GBit/s, got "
                f"intra={ca['intra_gbps']} inter={ca['inter_gbps']}")
        if ca["intra_latency_us"] < 0 or ca["inter_latency_us"] < 0:
            raise DeepSpeedConfigError(
                "comm_autotune latencies must be >= 0 us")
        if not ca["block_candidates"] or \
                any(int(b) < 8 for b in ca["block_candidates"]):
            raise DeepSpeedConfigError(
                "comm_autotune.block_candidates must be a non-empty "
                f"list of ints >= 8, got {ca['block_candidates']}")
        ap = self.async_pipeline_config
        if not isinstance(ap["prefetch_depth"], int) or \
                ap["prefetch_depth"] < 0:
            raise DeepSpeedConfigError(
                "async_pipeline.prefetch_depth must be an int >= 0 "
                f"(0 disables prefetching), got {ap['prefetch_depth']!r}")
        obs = self.observability_config
        if int(obs["recompile_warn_after"]) < 0:
            raise DeepSpeedConfigError(
                "observability.recompile_warn_after must be >= 0, got "
                f"{obs['recompile_warn_after']}")
        if obs["enabled"] and not isinstance(obs["events_dir"], str):
            raise DeepSpeedConfigError(
                "observability.events_dir must be a path string, got "
                f"{type(obs['events_dir']).__name__}")
        if obs["trace"]["enabled"] and int(obs["trace"]["num_steps"]) < 1:
            raise DeepSpeedConfigError(
                "observability.trace.num_steps must be >= 1 when the "
                "trace window is enabled")


def get_observability_config(param_dict):
    """The serving part of the ``observability`` section: the ``serve``
    sub-section (request trail, SLO thresholds, sampling, rotation,
    replica id), the top-level ``events_max_mb`` rotation cap it
    inherits, ``chrome_trace_path`` and ``health`` (the serving engine's
    flight recorder and watchdog)."""
    sub = param_dict.get(C.OBSERVABILITY, {})
    srv = sub.get(C.OBS_SERVE, {}) or {}
    slo = srv.get(C.OBS_SERVE_SLO, {}) or {}
    events_max_mb = sub.get(C.OBS_EVENTS_MAX_MB,
                            C.OBS_EVENTS_MAX_MB_DEFAULT)
    serve_max_mb = srv.get(C.OBS_SERVE_EVENTS_MAX_MB,
                           C.OBS_SERVE_EVENTS_MAX_MB_DEFAULT)
    serve = {
        "enabled": bool(srv.get(C.OBS_SERVE_ENABLED,
                                C.OBS_SERVE_ENABLED_DEFAULT)),
        "slo": {
            "ttft_ms": float(slo.get(C.OBS_SERVE_SLO_TTFT_MS,
                                     C.OBS_SERVE_SLO_TTFT_MS_DEFAULT)),
            "tbt_ms": float(slo.get(C.OBS_SERVE_SLO_TBT_MS,
                                    C.OBS_SERVE_SLO_TBT_MS_DEFAULT)),
        },
        "sample_rate": float(srv.get(C.OBS_SERVE_SAMPLE_RATE,
                                     C.OBS_SERVE_SAMPLE_RATE_DEFAULT)),
        # serving events log inherits the top-level rotation cap
        # unless overridden inside the serve section
        "events_max_mb": float(events_max_mb if serve_max_mb is None
                               else serve_max_mb),
        "replica_id": srv.get(C.OBS_SERVE_REPLICA_ID,
                              C.OBS_SERVE_REPLICA_ID_DEFAULT),
    }
    # validated here (not only in DeepSpeedConfig) because the
    # inference engine parses this section standalone
    if serve["sample_rate"] < 0 or serve["sample_rate"] > 1:
        raise DeepSpeedConfigError(
            f"observability.serve.sample_rate must be in [0, 1], got "
            f"{serve['sample_rate']}")
    if serve["slo"]["ttft_ms"] <= 0 or serve["slo"]["tbt_ms"] <= 0:
        raise DeepSpeedConfigError(
            "observability.serve.slo thresholds must be > 0, got "
            f"{serve['slo']}")
    if float(events_max_mb) < 0:
        raise DeepSpeedConfigError(
            "observability.events_max_mb must be >= 0 (0 disables "
            "rotation)")
    if serve["events_max_mb"] < 0:
        raise DeepSpeedConfigError(
            "observability.serve.events_max_mb must be >= 0 (0 disables "
            "rotation)")
    if serve["replica_id"] is not None:
        serve["replica_id"] = int(serve["replica_id"])
        if serve["replica_id"] < 0:
            raise DeepSpeedConfigError(
                "observability.serve.replica_id must be >= 0, got "
                f"{serve['replica_id']}")

    return {
        "events_max_mb": float(events_max_mb),
        "chrome_trace_path": sub.get(C.OBS_CHROME_TRACE_PATH,
                                     C.OBS_CHROME_TRACE_PATH_DEFAULT),
        "serve": serve,
        "health": _health_config(sub),
    }


def _norm_quantize_weights(v):
    """``inference.quantize_weights``: False | "bf16" | "int8". True is
    a back-compat alias for "bf16" (the historical wire-only behavior);
    the normalized value is what the engine branches on."""
    if isinstance(v, str):
        low = v.lower()
        if low in ("bf16", "int8"):
            return low
        raise DeepSpeedConfigError(
            f"inference.quantize_weights must be false, true (alias for "
            f"'bf16'), 'bf16', or 'int8', got {v!r}")
    return "bf16" if v else False


def get_inference_config(param_dict):
    """Serving-engine knobs (deepspeed_tpu/inference/; docs/inference.md).
    Bucket lists are validated up front — a malformed bucket table would
    otherwise surface as silent steady-state recompiles, the exact
    failure mode the buckets exist to prevent."""
    from deepspeed_tpu_torch.inference.buckets import validate_buckets
    sub = param_dict.get(C.INFERENCE, {})
    cfg = {
        "max_batch_size": int(sub.get(C.INF_MAX_BATCH_SIZE,
                                      C.INF_MAX_BATCH_SIZE_DEFAULT)),
        "prompt_buckets": list(sub.get(C.INF_PROMPT_BUCKETS,
                                       C.INF_PROMPT_BUCKETS_DEFAULT)),
        "batch_buckets": list(sub.get(C.INF_BATCH_BUCKETS,
                                      C.INF_BATCH_BUCKETS_DEFAULT)),
        "max_seq_len": int(sub.get(C.INF_MAX_SEQ_LEN,
                                   C.INF_MAX_SEQ_LEN_DEFAULT)),
        "max_new_tokens": int(sub.get(C.INF_MAX_NEW_TOKENS,
                                      C.INF_MAX_NEW_TOKENS_DEFAULT)),
        "temperature": float(sub.get(C.INF_TEMPERATURE,
                                     C.INF_TEMPERATURE_DEFAULT)),
        "top_k": int(sub.get(C.INF_TOP_K, C.INF_TOP_K_DEFAULT)),
        "eos_token_id": sub.get(C.INF_EOS_TOKEN_ID,
                                C.INF_EOS_TOKEN_ID_DEFAULT),
        "events_dir": sub.get(C.INF_EVENTS_DIR, C.INF_EVENTS_DIR_DEFAULT),
        "quantize_weights": _norm_quantize_weights(
            sub.get(C.INF_QUANTIZE_WEIGHTS,
                    C.INF_QUANTIZE_WEIGHTS_DEFAULT)),
        "quantize_block": int(sub.get(C.INF_QUANTIZE_BLOCK,
                                      C.INF_QUANTIZE_BLOCK_DEFAULT)),
        "admit_lookahead": int(sub.get(C.INF_ADMIT_LOOKAHEAD,
                                       C.INF_ADMIT_LOOKAHEAD_DEFAULT)),
    }
    pk = sub.get(C.INF_PAGED_KV, {}) or {}
    cfg["paged_kv"] = {
        "enabled": bool(pk.get(C.INF_PAGED_ENABLED,
                               C.INF_PAGED_ENABLED_DEFAULT)),
        "page_size": int(pk.get(C.INF_PAGED_PAGE_SIZE,
                                C.INF_PAGED_PAGE_SIZE_DEFAULT)),
        "num_pages": int(pk.get(C.INF_PAGED_NUM_PAGES,
                                C.INF_PAGED_NUM_PAGES_DEFAULT)),
        "prefix_cache": bool(pk.get(C.INF_PAGED_PREFIX_CACHE,
                                    C.INF_PAGED_PREFIX_CACHE_DEFAULT)),
        "attn_kernel": str(pk.get(C.INF_PAGED_ATTN_KERNEL,
                                  C.INF_PAGED_ATTN_KERNEL_DEFAULT)),
        "decode_page_buckets": list(pk.get(
            C.INF_PAGED_DECODE_PAGE_BUCKETS,
            C.INF_PAGED_DECODE_PAGE_BUCKETS_DEFAULT)),
        "kv_dtype": pk.get(C.INF_PAGED_KV_DTYPE,
                           C.INF_PAGED_KV_DTYPE_DEFAULT),
        "kv_quant_block": int(pk.get(C.INF_PAGED_KV_QUANT_BLOCK,
                                     C.INF_PAGED_KV_QUANT_BLOCK_DEFAULT)),
    }
    mesh_sub = sub.get(C.INF_MESH, {}) or {}
    cfg["mesh"] = {"axes": dict(mesh_sub.get(C.INF_MESH_AXES, {}) or {})}
    ck = sub.get(C.INF_CHUNKED_PREFILL, {}) or {}
    cfg["chunked_prefill"] = {
        "enabled": bool(ck.get(C.INF_CHUNK_ENABLED,
                               C.INF_CHUNK_ENABLED_DEFAULT)),
        "chunk_tokens": int(ck.get(C.INF_CHUNK_TOKENS,
                                   C.INF_CHUNK_TOKENS_DEFAULT)),
        "cp_threshold_tokens": int(ck.get(
            C.INF_CHUNK_CP_THRESHOLD,
            C.INF_CHUNK_CP_THRESHOLD_DEFAULT)),
    }
    sd = sub.get(C.INF_SPEC_DECODE, {}) or {}
    cfg["spec_decode"] = {
        "enabled": bool(sd.get(C.INF_SPEC_ENABLED,
                               C.INF_SPEC_ENABLED_DEFAULT)),
        "k": int(sd.get(C.INF_SPEC_K, C.INF_SPEC_K_DEFAULT)),
        "method": str(sd.get(C.INF_SPEC_METHOD,
                             C.INF_SPEC_METHOD_DEFAULT)),
        "ngram_min": int(sd.get(C.INF_SPEC_NGRAM_MIN,
                                C.INF_SPEC_NGRAM_MIN_DEFAULT)),
        "ngram_max": int(sd.get(C.INF_SPEC_NGRAM_MAX,
                                C.INF_SPEC_NGRAM_MAX_DEFAULT)),
        "verify_widths": list(sd.get(C.INF_SPEC_VERIFY_WIDTHS,
                                     C.INF_SPEC_VERIFY_WIDTHS_DEFAULT)),
    }
    dg = sub.get(C.INF_DISAGG, {}) or {}
    dg_mesh = dg.get(C.INF_DISAGG_DECODE_MESH, {}) or {}
    cfg["disagg"] = {
        "enabled": bool(dg.get(C.INF_DISAGG_ENABLED,
                               C.INF_DISAGG_ENABLED_DEFAULT)),
        "separate_pools": dg.get(C.INF_DISAGG_SEPARATE_POOLS,
                                 C.INF_DISAGG_SEPARATE_POOLS_DEFAULT),
        "prefill_pages": int(dg.get(C.INF_DISAGG_PREFILL_PAGES,
                                    C.INF_DISAGG_PREFILL_PAGES_DEFAULT)),
        "decode_mesh": {"axes": dict(
            dg_mesh.get(C.INF_MESH_AXES, {}) or {})},
    }
    fl = sub.get(C.INF_FLEET, {}) or {}
    shed = fl.get(C.INF_FLEET_SLO_SHED, {}) or {}
    swap = fl.get(C.INF_FLEET_SWAP, {}) or {}
    pm = fl.get(C.INF_FLEET_PROCESS_MODE, {}) or {}
    ascale = fl.get(C.INF_FLEET_AUTOSCALE, {}) or {}
    budget = shed.get(C.INF_FLEET_SHED_TTFT_BUDGET_MS,
                      C.INF_FLEET_SHED_TTFT_BUDGET_MS_DEFAULT)
    cfg["fleet"] = {
        "replicas": int(fl.get(C.INF_FLEET_REPLICAS,
                               C.INF_FLEET_REPLICAS_DEFAULT)),
        "routing": str(fl.get(C.INF_FLEET_ROUTING,
                              C.INF_FLEET_ROUTING_DEFAULT)),
        "slo_shed": {
            "enabled": bool(shed.get(C.INF_FLEET_SHED_ENABLED,
                                     C.INF_FLEET_SHED_ENABLED_DEFAULT)),
            "ttft_budget_ms": (float(budget) if budget is not None
                               else None),
            "min_samples": int(shed.get(
                C.INF_FLEET_SHED_MIN_SAMPLES,
                C.INF_FLEET_SHED_MIN_SAMPLES_DEFAULT)),
            "shed_below_priority": int(shed.get(
                C.INF_FLEET_SHED_BELOW_PRIORITY,
                C.INF_FLEET_SHED_BELOW_PRIORITY_DEFAULT)),
            "degrade_factor": float(shed.get(
                C.INF_FLEET_SHED_DEGRADE_FACTOR,
                C.INF_FLEET_SHED_DEGRADE_FACTOR_DEFAULT)),
            "degrade_max_new": int(shed.get(
                C.INF_FLEET_SHED_DEGRADE_MAX_NEW,
                C.INF_FLEET_SHED_DEGRADE_MAX_NEW_DEFAULT)),
        },
        "swap": {
            "verify_integrity": bool(swap.get(
                C.INF_FLEET_SWAP_VERIFY_INTEGRITY,
                C.INF_FLEET_SWAP_VERIFY_INTEGRITY_DEFAULT)),
        },
        "process_mode": {
            "enabled": bool(pm.get(C.INF_FLEET_PM_ENABLED,
                                   C.INF_FLEET_PM_ENABLED_DEFAULT)),
            "rpc_timeout_s": float(pm.get(
                C.INF_FLEET_PM_RPC_TIMEOUT_S,
                C.INF_FLEET_PM_RPC_TIMEOUT_S_DEFAULT)),
            "rpc_retries": int(pm.get(
                C.INF_FLEET_PM_RPC_RETRIES,
                C.INF_FLEET_PM_RPC_RETRIES_DEFAULT)),
            "rpc_backoff_s": float(pm.get(
                C.INF_FLEET_PM_RPC_BACKOFF_S,
                C.INF_FLEET_PM_RPC_BACKOFF_S_DEFAULT)),
            "max_restarts": int(pm.get(
                C.INF_FLEET_PM_MAX_RESTARTS,
                C.INF_FLEET_PM_MAX_RESTARTS_DEFAULT)),
            "restart_backoff_s": float(pm.get(
                C.INF_FLEET_PM_RESTART_BACKOFF_S,
                C.INF_FLEET_PM_RESTART_BACKOFF_S_DEFAULT)),
            "ready_timeout_s": float(pm.get(
                C.INF_FLEET_PM_READY_TIMEOUT_S,
                C.INF_FLEET_PM_READY_TIMEOUT_S_DEFAULT)),
        },
        "autoscale": {
            "enabled": bool(ascale.get(
                C.INF_FLEET_AS_ENABLED,
                C.INF_FLEET_AS_ENABLED_DEFAULT)),
            "min_replicas": int(ascale.get(
                C.INF_FLEET_AS_MIN_REPLICAS,
                C.INF_FLEET_AS_MIN_REPLICAS_DEFAULT)),
            "max_replicas": int(ascale.get(
                C.INF_FLEET_AS_MAX_REPLICAS,
                C.INF_FLEET_AS_MAX_REPLICAS_DEFAULT)),
            "scale_up_patience": int(ascale.get(
                C.INF_FLEET_AS_UP_PATIENCE,
                C.INF_FLEET_AS_UP_PATIENCE_DEFAULT)),
            "scale_down_patience": int(ascale.get(
                C.INF_FLEET_AS_DOWN_PATIENCE,
                C.INF_FLEET_AS_DOWN_PATIENCE_DEFAULT)),
            "cooldown_steps": int(ascale.get(
                C.INF_FLEET_AS_COOLDOWN_STEPS,
                C.INF_FLEET_AS_COOLDOWN_STEPS_DEFAULT)),
        },
    }
    try:
        cfg["prompt_buckets"] = list(validate_buckets(
            cfg["prompt_buckets"], "inference.prompt_buckets"))
        cfg["batch_buckets"] = list(validate_buckets(
            cfg["batch_buckets"], "inference.batch_buckets"))
    except ValueError as e:
        raise DeepSpeedConfigError(str(e))
    if cfg["max_batch_size"] < 1:
        raise DeepSpeedConfigError(
            f"inference.max_batch_size must be >= 1, got "
            f"{cfg['max_batch_size']}")
    if max(cfg["batch_buckets"]) > cfg["max_batch_size"]:
        raise DeepSpeedConfigError(
            f"inference.batch_buckets max ({max(cfg['batch_buckets'])}) "
            f"exceeds max_batch_size ({cfg['max_batch_size']})")
    if max(cfg["prompt_buckets"]) > cfg["max_seq_len"]:
        raise DeepSpeedConfigError(
            f"inference.prompt_buckets max ({max(cfg['prompt_buckets'])}) "
            f"exceeds max_seq_len ({cfg['max_seq_len']})")
    if cfg["max_new_tokens"] < 1 or cfg["top_k"] < 0 or \
            cfg["quantize_block"] < 8:
        raise DeepSpeedConfigError(
            "inference: max_new_tokens >= 1, top_k >= 0 and "
            "quantize_block >= 8 required")
    if cfg["admit_lookahead"] < 0:
        raise DeepSpeedConfigError(
            f"inference.admit_lookahead must be >= 0, got "
            f"{cfg['admit_lookahead']}")
    pkc = cfg["paged_kv"]
    if pkc["page_size"] < 1 or pkc["page_size"] > cfg["max_seq_len"]:
        raise DeepSpeedConfigError(
            f"inference.paged_kv.page_size must be in [1, max_seq_len], "
            f"got {pkc['page_size']}")
    if pkc["num_pages"] < 0 or pkc["num_pages"] == 1:
        # 0 = auto-size; an explicit pool needs >= 2 (null + 1 usable)
        raise DeepSpeedConfigError(
            f"inference.paged_kv.num_pages must be 0 (auto) or >= 2, "
            f"got {pkc['num_pages']}")
    if pkc["attn_kernel"] not in ("pallas", "gather"):
        raise DeepSpeedConfigError(
            f"inference.paged_kv.attn_kernel must be 'pallas' or "
            f"'gather', got {pkc['attn_kernel']!r}")
    if pkc["decode_page_buckets"]:
        try:
            pkc["decode_page_buckets"] = list(validate_buckets(
                pkc["decode_page_buckets"],
                "inference.paged_kv.decode_page_buckets"))
        except ValueError as e:
            raise DeepSpeedConfigError(str(e))
    if pkc["kv_dtype"] is not None:
        pkc["kv_dtype"] = str(pkc["kv_dtype"]).lower()
        if pkc["kv_dtype"] not in ("bf16", "int8"):
            raise DeepSpeedConfigError(
                f"inference.paged_kv.kv_dtype must be null (engine "
                f"dtype), 'bf16', or 'int8', got {pkc['kv_dtype']!r}")
    if pkc["kv_quant_block"] < 0:
        raise DeepSpeedConfigError(
            f"inference.paged_kv.kv_quant_block must be >= 0 (0 = one "
            f"scale per token row), got {pkc['kv_quant_block']}")
    if pkc["kv_quant_block"] and pkc["kv_dtype"] != "int8":
        raise DeepSpeedConfigError(
            "inference.paged_kv.kv_quant_block requires "
            "kv_dtype: 'int8'")
    for where, axes in (("inference.mesh", cfg["mesh"]["axes"]),
                        ("inference.disagg.decode_mesh",
                         cfg["disagg"]["decode_mesh"]["axes"])):
        for name, size in axes.items():
            if name != "model":
                # the serving programs shard params/cache over the
                # 'model' axis only today; an unknown axis would
                # otherwise surface as an opaque jax resource error
                # deep in engine init
                raise DeepSpeedConfigError(
                    f"{where}.axes supports only the 'model' "
                    f"(tensor-parallel) axis, got {name!r}")
            if not isinstance(size, int) or size < 1:
                raise DeepSpeedConfigError(
                    f"{where}.axes entries must be positive ints, "
                    f"got {name}={size!r}")
    ckc = cfg["chunked_prefill"]
    if ckc["enabled"] and not pkc["enabled"]:
        raise DeepSpeedConfigError(
            "inference.chunked_prefill requires paged_kv.enabled (a "
            "chunk is cache_position advancing over the slot's pages)")
    if ckc["enabled"] and (ckc["chunk_tokens"] < 1
                           or ckc["chunk_tokens"] > cfg["max_seq_len"]):
        raise DeepSpeedConfigError(
            f"inference.chunked_prefill.chunk_tokens must be in "
            f"[1, max_seq_len], got {ckc['chunk_tokens']}")
    if ckc["cp_threshold_tokens"] < 0:
        raise DeepSpeedConfigError(
            f"inference.chunked_prefill.cp_threshold_tokens must be "
            f">= 0 (0 = context-parallel off), got "
            f"{ckc['cp_threshold_tokens']}")
    sdc = cfg["spec_decode"]
    if sdc["enabled"] and not pkc["enabled"]:
        raise DeepSpeedConfigError(
            "inference.spec_decode requires paged_kv.enabled (rollback "
            "is a block-table/position edit on the page pool)")
    if sdc["k"] < 1 or sdc["k"] >= cfg["max_seq_len"]:
        raise DeepSpeedConfigError(
            f"inference.spec_decode.k must be in [1, max_seq_len), got "
            f"{sdc['k']}")
    if sdc["method"] not in ("ngram", "callable"):
        raise DeepSpeedConfigError(
            f"inference.spec_decode.method must be 'ngram' or "
            f"'callable', got {sdc['method']!r}")
    if sdc["ngram_min"] < 1 or sdc["ngram_max"] < sdc["ngram_min"]:
        raise DeepSpeedConfigError(
            "inference.spec_decode: 1 <= ngram_min <= ngram_max "
            f"required, got [{sdc['ngram_min']}, {sdc['ngram_max']}]")
    if sdc["verify_widths"]:
        try:
            sdc["verify_widths"] = list(validate_buckets(
                sdc["verify_widths"],
                "inference.spec_decode.verify_widths"))
        except ValueError as e:
            raise DeepSpeedConfigError(str(e))
        if min(sdc["verify_widths"]) < 2:
            # width 1 IS the plain decode program; a verify program
            # only exists to check >= 1 draft token in one dispatch
            raise DeepSpeedConfigError(
                "inference.spec_decode.verify_widths entries must be "
                ">= 2 (width 1 is the plain decode program)")
    dgc = cfg["disagg"]
    if dgc["enabled"] and not pkc["enabled"]:
        raise DeepSpeedConfigError(
            "inference.disagg requires paged_kv.enabled (the handoff "
            "transfers page ownership between worker loops)")
    if dgc["separate_pools"] is not None:
        dgc["separate_pools"] = bool(dgc["separate_pools"])
    if dgc["prefill_pages"] < 0 or dgc["prefill_pages"] == 1:
        raise DeepSpeedConfigError(
            f"inference.disagg.prefill_pages must be 0 (auto) or >= 2, "
            f"got {dgc['prefill_pages']}")
    if dgc["decode_mesh"]["axes"] and not dgc["enabled"]:
        raise DeepSpeedConfigError(
            "inference.disagg.decode_mesh.axes set but disagg.enabled "
            "is false")
    flc = cfg["fleet"]
    if flc["replicas"] < 1:
        raise DeepSpeedConfigError(
            f"inference.fleet.replicas must be >= 1, got "
            f"{flc['replicas']}")
    if flc["routing"] not in C.INF_FLEET_ROUTING_CHOICES:
        raise DeepSpeedConfigError(
            f"inference.fleet.routing must be one of "
            f"{list(C.INF_FLEET_ROUTING_CHOICES)}, got "
            f"{flc['routing']!r}")
    shc = flc["slo_shed"]
    if shc["ttft_budget_ms"] is not None and shc["ttft_budget_ms"] <= 0:
        raise DeepSpeedConfigError(
            f"inference.fleet.slo_shed.ttft_budget_ms must be > 0 (or "
            f"null for the serve SLO), got {shc['ttft_budget_ms']}")
    if shc["min_samples"] < 1 or shc["shed_below_priority"] < 0 or \
            shc["degrade_max_new"] < 0:
        raise DeepSpeedConfigError(
            "inference.fleet.slo_shed: min_samples >= 1, "
            "shed_below_priority >= 0 and degrade_max_new >= 0 required")
    if shc["degrade_factor"] < 1.0:
        raise DeepSpeedConfigError(
            f"inference.fleet.slo_shed.degrade_factor must be >= 1.0 "
            f"(the degrade rung engages above the shed rung), got "
            f"{shc['degrade_factor']}")
    pmc = flc["process_mode"]
    if pmc["rpc_timeout_s"] <= 0 or pmc["ready_timeout_s"] <= 0:
        raise DeepSpeedConfigError(
            f"inference.fleet.process_mode: rpc_timeout_s and "
            f"ready_timeout_s must be > 0, got "
            f"{pmc['rpc_timeout_s']}/{pmc['ready_timeout_s']}")
    if pmc["rpc_retries"] < 0 or pmc["rpc_backoff_s"] < 0 or \
            pmc["max_restarts"] < 0 or pmc["restart_backoff_s"] < 0:
        raise DeepSpeedConfigError(
            "inference.fleet.process_mode: rpc_retries, rpc_backoff_s, "
            "max_restarts and restart_backoff_s must be >= 0")
    asc = flc["autoscale"]
    if asc["min_replicas"] < 1:
        raise DeepSpeedConfigError(
            f"inference.fleet.autoscale.min_replicas must be >= 1, got "
            f"{asc['min_replicas']}")
    if asc["max_replicas"] < asc["min_replicas"]:
        raise DeepSpeedConfigError(
            f"inference.fleet.autoscale.max_replicas must be >= "
            f"min_replicas ({asc['min_replicas']}), got "
            f"{asc['max_replicas']}")
    if asc["scale_up_patience"] < 1 or asc["scale_down_patience"] < 1:
        raise DeepSpeedConfigError(
            "inference.fleet.autoscale: scale_up_patience and "
            "scale_down_patience must be >= 1 (hysteresis — a single "
            "hot or idle step must never flap the fleet)")
    if asc["cooldown_steps"] < 0:
        raise DeepSpeedConfigError(
            f"inference.fleet.autoscale.cooldown_steps must be >= 0, "
            f"got {asc['cooldown_steps']}")
    return cfg
