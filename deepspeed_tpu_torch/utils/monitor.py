"""Metrics monitor (the port of ``deepspeed_tpu/utils/monitor.py``): the
training writers (loss, lr, loss scale and timer values under
``Train/Samples/*``), the checkpoint ones (save, load and fallback rows,
the snapshot and write times under ``Checkpoint/*``) and the serving
ones (``Serve/*``).

Keeps the JAX package's tags and its events.jsonl schema — scalar rows
``{"tag", "value", "step"}``, structured rows ``{"event", ..., "t"}`` —
so ``tools/obs_report.py`` reads a port run unchanged. The comm writers
are not ported yet.
"""

import json
import math
import os
import socket
import time
from typing import Dict, Optional

from deepspeed_tpu_torch.utils.logging import logger

__all__ = ["TensorBoardMonitor", "get_summary_writer", "Histogram"]

# serving telemetry tags (x-axis = cumulative generated tokens); the
# strings are the JAX package's, which tools/obs_report.py mirrors
TAG_SERVE_TTFT = "Serve/ttft_ms"                    # per admitted request
TAG_SERVE_TOKEN_LATENCY = "Serve/token_latency_ms"  # per decode dispatch
TAG_SERVE_TPS = "Serve/tokens_per_sec"              # cumulative rate
TAG_SERVE_QUEUE_DEPTH = "Serve/queue_depth"         # waiting requests
TAG_SERVE_OCCUPANCY = "Serve/batch_occupancy"       # active / total slots
TAG_SERVE_KV_PAGES = "Serve/kv_pages_in_use"        # paged pool occupancy
TAG_SERVE_TOKENS_IN_FLIGHT = "Serve/tokens_in_flight"  # live cache tokens
TAG_SERVE_PREFIX_HIT = "Serve/prefix_hit_rate"      # prompt tokens reused
TAG_SERVE_DECODE_ATTN = "Serve/decode_attn_path"    # 1 = paged decode
#                                                     kernel, 0 = gather
TAG_SERVE_QUEUE_WAIT = "Serve/queue_wait_ms"        # per admitted request
TAG_SERVE_TBT = "Serve/tbt_ms"                      # per decode dispatch
TAG_SERVE_SLO = "Serve/slo_attainment"              # finished-in-SLO frac
TAG_SERVE_GOODPUT = "Serve/goodput_tokens_per_s"    # within-SLO tokens/s
# static pool cost per token of KV capacity (an int8 pool lands near half
# the bf16 figure) and the offline quantized-vs-fp max logit error probe
# (InferenceEngine.record_quant_logit_err)
TAG_SERVE_KV_POOL_BPT = "Serve/kv_pool_bytes_per_token"
TAG_SERVE_QUANT_LOGIT_ERR = "Serve/quant_logit_err"
TAG_SERVE_TBT_MAX = "Serve/tbt_max_ms"              # per decode dispatch
TAG_SERVE_WEIGHT_VERSION = "Serve/weight_version"   # committed swap
#                                                     ordinal
TAG_SERVE_SPEC_ACCEPT = "Serve/spec_accept_rate"    # accepted/proposed
TAG_SERVE_CHUNK_DISPATCHES = "Serve/chunk_dispatches"  # cumulative
TAG_SERVE_HANDOFF = "Serve/handoff_ms"              # per claimed handoff
#                                                     (queue + transfer)
# checkpoint tags (x-axis = cumulative samples)
TAG_CKPT_SNAPSHOT_MS = "Checkpoint/snapshot_ms"     # state capture
TAG_CKPT_WRITE_MS = "Checkpoint/write_ms"           # stage/commit protocol
TAG_CKPT_PENDING = "Checkpoint/pending_saves"       # async writer backlog
TAG_CKPT_RESTARTS = "Checkpoint/restarts"           # supervisor relaunches
# the serving fleet (inference/fleet.py): the shed ladder's rate, the
# summed replica queues, live KV migrations and supervised relaunches
TAG_SERVE_SHED_RATE = "Serve/shed_rate"             # shed / submitted
TAG_SERVE_FLEET_QDEPTH = "Serve/fleet_queue_depth"  # sum of replica queues
TAG_SERVE_MIGRATIONS = "Serve/migrations"           # live requests moved
TAG_SERVE_REPLICA_RESTARTS = "Serve/replica_restarts"  # supervised
# the health plane (utils/health.py): cumulative numeric-anomaly alerts
TAG_HEALTH_ALERTS = "Health/alerts"                 # cumulative alerts


class Histogram:
    """Bounded log-bucketed latency histogram (the serving-plane
    percentile sink).

    Keeps geometrically-spaced buckets instead of every sample — memory
    is bounded by the value range, so a serving daemon can record
    millions of requests without growing the host heap. Percentiles are
    approximate: relative error is one bucket width
    (``10^(1/bins_per_decade)`` — ~7.5% at the default 32/decade).
    Exact ``min``, ``max``, ``count`` and ``sum`` ride along.
    """

    def __init__(self, bins_per_decade: int = 32, floor: float = 1e-3):
        self.bins_per_decade = int(bins_per_decade)
        self.floor = float(floor)       # values below land in bucket 0
        self._buckets: Dict[int, int] = {}
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def _bucket(self, v: float) -> int:
        if v <= self.floor:
            return 0
        return 1 + int(math.log10(v / self.floor) * self.bins_per_decade)

    def _bucket_value(self, b: int) -> float:
        if b == 0:
            return self.floor
        # geometric midpoint of the bucket's span
        return self.floor * 10.0 ** ((b - 0.5) / self.bins_per_decade)

    def record(self, v) -> None:
        v = float(v)
        if not math.isfinite(v):
            return
        b = self._bucket(v)
        self._buckets[b] = self._buckets.get(b, 0) + 1
        self.count += 1
        self.sum += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)

    @property
    def mean(self) -> Optional[float]:
        return self.sum / self.count if self.count else None

    def percentile(self, q: float) -> Optional[float]:
        """Approximate q-quantile (q in [0, 1]); exact at the
        extremes (q=0 -> min, q=1 -> max)."""
        if not self.count:
            return None
        if q <= 0:
            return self.min
        if q >= 1:
            return self.max
        rank = q * (self.count - 1)
        seen = 0
        for b in sorted(self._buckets):
            seen += self._buckets[b]
            if seen > rank:
                # clamp the bucket estimate into the exact bounds
                return min(max(self._bucket_value(b), self.min), self.max)
        return self.max

    def snapshot(self) -> dict:
        """The report-facing summary (rounded; JSON-friendly)."""
        r = (lambda v: round(v, 3) if v is not None else None)
        return {"count": self.count, "mean": r(self.mean),
                "p50": r(self.percentile(0.50)),
                "p95": r(self.percentile(0.95)),
                "p99": r(self.percentile(0.99)),
                "min": r(self.min), "max": r(self.max)}


class _JsonlWriter:
    """SummaryWriter look-alike: one JSON object per record.

    Line-buffered, so every record hits the OS the moment it is written.
    Scalar rows are ``{"tag": str, "value": float, "step": int}``;
    structured rows carry ``{"event": str, ...}``. ``max_mb`` > 0 turns
    on size-based rotation to ``events.jsonl.<seq>``.
    """

    def __init__(self, log_dir: str, max_mb: float = 0.0):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "events.jsonl")
        self.max_bytes = int(float(max_mb or 0.0) * 2 ** 20)
        self._seq = 1 + max(
            (int(n.rsplit(".", 1)[1])
             for n in os.listdir(log_dir)
             if n.startswith("events.jsonl.")
             and n.rsplit(".", 1)[1].isdigit()), default=0)
        self._open()

    def _open(self):
        self._f = open(self.path, "a", buffering=1)
        self._bytes = self._f.tell()        # append mode: current size

    def _write_line(self, line: str):
        self._f.write(line)
        self._bytes += len(line)
        if self.max_bytes and self._bytes >= self.max_bytes:
            self._rotate()

    def _rotate(self):
        self._f.close()
        os.replace(self.path, f"{self.path}.{self._seq}")
        self._seq += 1
        self._open()

    def add_scalar(self, tag, value, step):
        if self._f is None:
            return
        self._write_line(json.dumps(
            {"tag": str(tag), "value": float(value), "step": int(step)})
            + "\n")

    def add_event(self, kind, **fields):
        """One structured (non-scalar) record, stamped with ``t`` —
        wall-clock epoch seconds — unless the caller supplied one."""
        if self._f is None:
            return
        row = {"event": str(kind)}
        row.update(fields)
        row.setdefault("t", round(time.time(), 6))
        self._write_line(json.dumps(row, default=str) + "\n")

    def flush(self):
        if self._f is not None:
            self._f.flush()

    def close(self):
        # getattr: __del__ also runs on a writer whose __init__ raised
        if getattr(self, "_f", None) is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):
        self.close()


def _make_writer(log_dir: str):
    """torch SummaryWriter, or the JSONL writer when tensorboard is not
    installed."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError as e:
        logger.warning(f"tensorboard unavailable ({e}); falling back to "
                       f"JSONL event log in {log_dir}")
        return _JsonlWriter(log_dir)
    return SummaryWriter(log_dir=log_dir)


def get_summary_writer(name: str = "DeepSpeedTPUJobName",
                       base: str = os.path.join(os.path.expanduser("~"),
                                                "tensorboard")):
    """Build a SummaryWriter under
    ``<base>/<infra job id>/logs/<name>_<host>``."""
    infra_job_id = os.environ.get("DLWS_JOB_ID") or \
        os.environ.get("DLTS_JOB_ID") or "unknown-job-id"
    return _make_writer(os.path.join(base, infra_job_id, "logs",
                                     name + "_" + socket.gethostname()))


class TensorBoardMonitor:
    """Engine-facing wrapper: no-ops unless enabled and on rank 0.

    ``mirror`` (optional) receives a copy of every scalar — typically a
    :class:`_JsonlWriter` — so one ``events.jsonl`` records the run even
    with the tensorboard writer disabled.
    """

    def __init__(self, enabled: bool, output_path: Optional[str] = None,
                 job_name: Optional[str] = None, rank: int = 0):
        self.enabled = bool(enabled) and rank == 0
        self.writer = None
        self.mirror = None
        if self.enabled:
            if output_path:
                self.writer = _make_writer(os.path.join(
                    output_path, job_name or "DeepSpeedTPUJobName"))
            else:
                self.writer = get_summary_writer(
                    name=job_name or "DeepSpeedTPUJobName")

    def _writes(self) -> bool:
        return self.writer is not None or self.mirror is not None

    def write_scalar(self, tag: str, value, step: int):
        if self.writer is not None:
            self.writer.add_scalar(tag, float(value), int(step))
        if self.mirror is not None:
            self.mirror.add_scalar(tag, float(value), int(step))

    def write_train_metrics(self, *, loss=None, lr=None, loss_scale=None,
                            samples: int = 0, flush: bool = True):
        """The per-step training scalars; the x-axis is cumulative
        samples. ``flush=False`` lets the engine's telemetry ring write a
        window of records and flush once at the end."""
        if not self._writes():
            return
        if loss is not None:
            self.write_scalar("Train/Samples/train_loss", loss, samples)
        if lr is not None:
            self.write_scalar("Train/Samples/lr", lr, samples)
        if loss_scale is not None:
            self.write_scalar("Train/Samples/loss_scale", loss_scale,
                              samples)
        if flush:
            self.flush()

    def write_timer_values(self, timer_values: dict, samples: int = 0):
        """Per-timer milliseconds, one ``Train/Samples/<name>`` scalar
        each."""
        if not self._writes():
            return
        for name, ms in timer_values.items():
            self.write_scalar(f"Train/Samples/{name}", ms, samples)
        self.flush()

    def write_checkpoint_event(self, *, action: str, ok: bool = True,
                               duration_ms=None, samples: int = 0):
        """A checkpoint ``save``/``load`` (with its duration) or a
        ``fallback`` (a tag skipped as uncommitted or corrupt), on the
        samples x-axis of the loss."""
        if not self._writes():
            return
        if duration_ms is not None:
            self.write_scalar(f"Train/Samples/checkpoint_{action}_ms",
                              duration_ms, samples)
        self.write_scalar(f"Train/Samples/checkpoint_{action}_ok",
                          1.0 if ok else 0.0, samples)
        self.flush()

    def write_elastic_metrics(self, *, snapshot_ms=None, write_ms=None,
                              pending_saves=None, restarts=None,
                              samples: int = 0, flush: bool = True):
        """A save's snapshot and write times, the async writer's backlog
        (0: saves are blocking) and the restart count (0: no supervisor
        relaunches the port), on the samples x-axis."""
        if not self._writes():
            return
        for tag, value in ((TAG_CKPT_SNAPSHOT_MS, snapshot_ms),
                           (TAG_CKPT_WRITE_MS, write_ms),
                           (TAG_CKPT_PENDING, pending_saves),
                           (TAG_CKPT_RESTARTS, restarts)):
            if value is not None:
                self.write_scalar(tag, value, samples)
        if flush:
            self.flush()

    def write_serving_metrics(self, *, ttft_ms=None, token_latency_ms=None,
                              tokens_per_sec=None, queue_depth=None,
                              batch_occupancy=None, kv_pages_in_use=None,
                              tokens_in_flight=None, prefix_hit_rate=None,
                              decode_attn_path=None, queue_wait_ms=None,
                              tbt_ms=None, slo_attainment=None,
                              goodput_tokens_per_s=None,
                              kv_pool_bytes_per_token=None,
                              quant_logit_err=None, tbt_max_ms=None,
                              weight_version=None, spec_accept_rate=None,
                              chunk_dispatches=None, handoff_ms=None,
                              shed_rate=None, fleet_queue_depth=None,
                              migrations=None, replica_restarts=None,
                              tokens: int = 0,
                              flush: bool = True):
        """Serving telemetry: TTFT per admitted request, per-decode-step
        token latency, cumulative tokens/s, queue depth and slot
        occupancy, the paged-pool view (pages in use, live cache tokens,
        prefix hit rate, which decode attention ran), and the
        request-granular plane (queue wait, TBT, SLO attainment,
        goodput), the ordinal of the weights served (after a
        ``swap_params``), a verify dispatch's draft acceptance rate, the
        cumulative chunked-prefill dispatches, a claimed handoff's
        queue plus transfer time, and the fleet's shed rate, summed queue
        depth, live migrations and replica relaunches. The x-axis is
        cumulative generated tokens."""
        if not self._writes():
            return
        for tag, value in (
                (TAG_SERVE_TTFT, ttft_ms),
                (TAG_SERVE_TOKEN_LATENCY, token_latency_ms),
                (TAG_SERVE_TPS, tokens_per_sec),
                (TAG_SERVE_QUEUE_DEPTH, queue_depth),
                (TAG_SERVE_OCCUPANCY, batch_occupancy),
                (TAG_SERVE_KV_PAGES, kv_pages_in_use),
                (TAG_SERVE_TOKENS_IN_FLIGHT, tokens_in_flight),
                (TAG_SERVE_PREFIX_HIT, prefix_hit_rate),
                (TAG_SERVE_DECODE_ATTN, decode_attn_path),
                (TAG_SERVE_QUEUE_WAIT, queue_wait_ms),
                (TAG_SERVE_TBT, tbt_ms),
                (TAG_SERVE_TBT_MAX, tbt_max_ms),
                (TAG_SERVE_CHUNK_DISPATCHES, chunk_dispatches),
                (TAG_SERVE_SLO, slo_attainment),
                (TAG_SERVE_GOODPUT, goodput_tokens_per_s),
                (TAG_SERVE_SPEC_ACCEPT, spec_accept_rate),
                (TAG_SERVE_HANDOFF, handoff_ms),
                (TAG_SERVE_SHED_RATE, shed_rate),
                (TAG_SERVE_FLEET_QDEPTH, fleet_queue_depth),
                (TAG_SERVE_MIGRATIONS, migrations),
                (TAG_SERVE_REPLICA_RESTARTS, replica_restarts),
                (TAG_SERVE_KV_POOL_BPT, kv_pool_bytes_per_token),
                (TAG_SERVE_QUANT_LOGIT_ERR, quant_logit_err),
                (TAG_SERVE_WEIGHT_VERSION, weight_version)):
            if value is not None:
                self.write_scalar(tag, value, tokens)
        if flush:
            self.flush()

    def flush(self):
        if self.writer is not None:
            self.writer.flush()
        if self.mirror is not None:
            self.mirror.flush()

    def close(self):
        if self.writer is not None:
            self.writer.close()
            self.writer = None
        self.mirror = None  # owned by the observability layer, not closed
