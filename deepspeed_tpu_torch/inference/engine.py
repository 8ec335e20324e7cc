"""The inference serving engine (the port of
``deepspeed_tpu/inference/engine.py``, paged path, GPT-2 and Llama
families).

- **Paged KV cache.** A pool of ``(kv_heads, page_size, head_dim)``
  pages addressed through per-slot block tables
  (``inference/kv_cache.py``); occupancy is bounded by the tokens
  reserved in flight, and page-aligned shared prompt prefixes are
  hash-deduplicated so they are prefilled once. With
  ``paged_kv.kv_dtype: "int8"`` the pool holds int8 payload and fp32
  per-token-row scales: about half the bytes per token of a bf16 pool.
- **Paged-decode kernels.** The decode step computes attention straight
  against the pool with the hand-written CUDA kernels
  (``ops/attention/paged.py`` over ``csrc/paged_decode.cu``, one entry
  point per pool type): each row reads only its
  live pages, and the q heads of a GQA group share their kv head's.
  ``paged_kv.attn_kernel: "gather"`` selects the plain stripe-gather
  attention instead. There is no automatic fallback: where the kernel
  cannot run, the call raises.
- **Bucketed shapes, continuous batching.** Prompts pad to
  ``prompt_buckets`` and prefill batches to ``batch_buckets``; the
  host-side :class:`~.scheduler.Scheduler` admits queued requests into
  freed decode slots every step and evicts finished ones.
- **Telemetry.** TTFT, token latency, tokens/s, queue depth, occupancy
  and the pool view go through the monitor into ``events.jsonl`` with
  the JAX package's ``Serve/*`` tags; the request trail, latency
  decomposition and SLO split come from ``inference/tracing.py``.
- **Speculative decoding** (``inference.spec_decode``): a host drafter
  (``inference/draft.py``) proposes up to ``k`` tokens per slot and one
  seq-``v`` verify dispatch keeps the longest matching prefix plus one.
- **Chunked prefill** (``inference.chunked_prefill``): a prompt prefills
  in ``chunk_tokens`` slices, at most one chunk dispatch per step after
  the decode; prompts past the largest prompt bucket are served only
  this way.
- **Disaggregated prefill/decode** (``inference.disagg``): a completed
  prefill parks its first token in a handoff queue
  (``inference/disagg.py``) and the decode phase, which runs first in
  every step, claims it: a host bookkeeping move over a shared pool, or
  over separate pools an export/import of the live prompt pages (the
  ``handoff_export`` / ``handoff_import`` programs), priced by a link
  model.
- **int8-resident weights** (``inference.quantize_weights: "int8"``):
  the matmul weights and embeddings stay int8 with per-block fp32 scales
  (``runtime/quantized_params.py``) and every program dequantizes them
  at each use; ``"bf16"`` (or ``True``) quantizes only the weights
  :meth:`InferenceEngine.from_checkpoint` ships.
- **Dense slot cache** (``paged_kv.enabled: false``): one ``max_len``
  row per slot plus a scratch row, the JAX package's parity baseline.
- **From a training tag.** :meth:`InferenceEngine.from_checkpoint` serves
  the ``model_states`` group of a committed tag (of either package), and
  :meth:`InferenceEngine.swap_params` moves a running engine to a newer
  tag, atomically or not at all; ``weight_version`` names the tag served.
- **Live KV migration** (:meth:`InferenceEngine.warm_migration`): an
  in-flight request's live pages leave the decode pool through the
  ``migrate_export`` program (:meth:`InferenceEngine.export_request`) and
  enter another engine's through ``migrate_import``
  (:meth:`InferenceEngine.import_request`), which resumes decode at the
  same position; the serving fleet (``inference/fleet.py``) drives it.
- **Health plane** (``observability.health``): a flight recorder over the
  monitor's mirror and a stall watchdog beaten at each phase (prefill,
  chunk_prefill, handoff_claim, decode), ``utils/health.py``.

The programs form a fixed set (``inference/programs.py``): one per
prefill (batch bucket, prompt bucket), decode table width, verify width
and chunk batch bucket, and the two handoff programs, each captured as
a CUDA graph at :meth:`warmup` and replayed at every dispatch (the two
migration programs at :meth:`warm_migration`);
:attr:`steady_state_recompiles` counts the programs first built after
warmup, as the JAX engine counts compiles. Where the JAX engine donates
the cache to each compiled program, the port's programs update the pool
tensors in place (``models/gpt2.write_paged_kv_cache``), and a weight
swap copies into the live parameter tensors, whose addresses the graphs
hold.
A serving mesh (``inference.mesh``, ``disagg.decode_mesh``) raises
``NotImplementedError`` naming the JAX feature.
"""

import functools
import os
import time
from typing import Any, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from deepspeed_tpu_torch.inference.buckets import (chunk_warmup_plan,
                                                   pad_prompts, pick_bucket,
                                                   warmup_plan)
from deepspeed_tpu_torch.inference.disagg import (DispatchTrace,
                                                  HandoffQueue,
                                                  HandoffRecord,
                                                  HandoffStats,
                                                  MigrationRecord,
                                                  price_handoff)
from deepspeed_tpu_torch.inference.draft import make_drafter
from deepspeed_tpu_torch.inference.kv_cache import (PageAllocator,
                                                    cache_spec_for,
                                                    init_kv_cache,
                                                    init_paged_kv_cache,
                                                    kv_cache_bytes,
                                                    paged_kv_bytes,
                                                    paged_spec_for,
                                                    pages_for)
from deepspeed_tpu_torch.inference.programs import ProgramSet
from deepspeed_tpu_torch.inference.scheduler import (FinishedRequest,
                                                     Request, Scheduler)
from deepspeed_tpu_torch.inference.tracing import ServeTracer
from deepspeed_tpu_torch.models.gpt2 import (GPT2Config, _gpt2_trunk_cached,
                                             _tied_logits, init_gpt2_params,
                                             tied_head_weight)
from deepspeed_tpu_torch.models.llama import (LlamaConfig,
                                              _llama_trunk_cached,
                                              init_llama_params,
                                              rope_cos_sin)
from deepspeed_tpu_torch.ops.attention.paged import NEG_INF
from deepspeed_tpu_torch.runtime import checkpoint as ckptlib
from deepspeed_tpu_torch.runtime import fault
from deepspeed_tpu_torch.runtime.quantized_params import (
    QuantizedParam, dequantize_param_tree, is_quantized_tree,
    quantize_param_tree, quantized_tree_bytes)
from deepspeed_tpu_torch.profiling.spans import (ChromeTraceRecorder,
                                                 trace_span)
from deepspeed_tpu_torch.runtime.config import (get_inference_config,
                                                get_observability_config)
from deepspeed_tpu_torch.utils.health import HealthPlane
from deepspeed_tpu_torch.utils.logging import logger
from deepspeed_tpu_torch.utils.monitor import (TensorBoardMonitor,
                                               _JsonlWriter)

__all__ = ["InferenceEngine", "LinkModel", "qwz_distribute_params"]

# engine-local name of each decode attention path; the config keeps the
# JAX schema's values ("pallas" selects the paged-decode kernel)
_ATTN_PATHS = {"pallas": "kernel", "gather": "gather"}
# block leaves used only as matmul operands, cast at use in the JAX model
_MATMUL_LEAVES = ("attn", "mlp")


def _llama_trunk(config, max_len, device):
    """The Llama cached trunk bound to its RoPE tables, made once per
    engine at ``max_len`` rather than per dispatch."""
    return functools.partial(_llama_trunk_cached, rope=rope_cos_sin(
        max_len, config.head_dim, config.rope_theta, device=device))


# config class -> (family name, (config, max_len, device) -> cached trunk,
# the LM head's weight leaf, the param init)
_FAMILIES = {
    GPT2Config: ("gpt2", lambda config, max_len, device: _gpt2_trunk_cached,
                 "wte", init_gpt2_params),
    LlamaConfig: ("llama", _llama_trunk, "lm_head", init_llama_params),
}


def _family_of(model_config):
    for cls, entry in _FAMILIES.items():
        if isinstance(model_config, cls):
            return entry
    raise TypeError(
        f"unsupported model config {type(model_config).__name__}; "
        f"serving supports {[c.__name__ for c in _FAMILIES]}")


def _resolve_device(device) -> torch.device:
    """``device`` as given, else the current CUDA device. Never drifts to
    the CPU on its own: with no card and no explicit device it raises."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "InferenceEngine runs on CUDA and no CUDA device is available; "
            "pass device='cpu' to serve on the CPU with the kernels' plain "
            "versions")
    return torch.device("cuda", torch.cuda.current_device())


def _resolve_committed_tag(load_dir: str, tag: Optional[str],
                           verify_integrity: bool) -> str:
    """The pre-flight every serving load shares (``from_checkpoint``,
    ``swap_params``): with ``tag`` None the newest committed tag wins,
    and a corrupt, uncommitted or weightless tag is skipped with a
    warning. Returns the chosen tag's directory."""
    candidates = [tag] if tag is not None else \
        ckptlib.candidate_tags(load_dir)
    for t in candidates:
        d = os.path.join(load_dir, t)
        ok, problems = ckptlib.verify_checkpoint_dir(
            d, check_crc=verify_integrity)
        if ok and ckptlib.state_groups(d)["model_states"]:
            return d
        logger.warning(f"serving checkpoint pre-flight: skipping {d}: "
                       f"{problems or 'no model_states group'}")
    raise FileNotFoundError(
        f"no loadable committed checkpoint with model_states "
        f"under {load_dir} (tag={tag!r})")


def _refuse_unported(cfg: Dict[str, Any]) -> None:
    unported = [
        (bool(cfg["mesh"]["axes"]), "inference.mesh (tensor-parallel "
         "serving over a device mesh)"),
        (bool(cfg["disagg"]["decode_mesh"]["axes"]),
         "inference.disagg.decode_mesh (decode workers on a mesh of their "
         "own)"),
    ]
    for hit, what in unported:
        if hit:
            raise NotImplementedError(
                f"{what} is a feature of the JAX engine that the port does "
                f"not serve yet")


class LinkModel(NamedTuple):
    """The per-axis latency and bandwidth terms that price a handoff
    (``inference.disagg.price_handoff``): the defaults of the JAX
    package's ``runtime/comm_autotune.LinkModel``, which a disaggregated
    engine builds as they stand."""
    intra_gbps: float = 75.0
    inter_gbps: float = 12.5
    intra_latency_us: float = 1.0
    inter_latency_us: float = 10.0

    def bytes_per_us(self, axis: str) -> float:
        gbps = self.intra_gbps if axis == "intra" else self.inter_gbps
        return gbps * 1e9 / 8 / 1e6       # GBit/s -> bytes/us

    def latency_us(self, axis: str) -> float:
        return (self.intra_latency_us if axis == "intra"
                else self.inter_latency_us)


def qwz_distribute_params(params, block: int = 256, resident: str = "bf16"):
    """Ship params through the qwZ int8 block format: every floating
    leaf of two or more dims crosses as int8 blocks and fp32 scales.
    ``resident`` picks what the engine keeps: ``"bf16"`` dequantizes
    back to each leaf's own dtype at once (the saving is on the wire
    only), ``"int8"`` keeps the blocks and scales as the live weights
    (a tree of ``QuantizedParam`` leaves), which the programs dequantize
    at each use. 1-D leaves (biases, norms) stay dense either way."""
    qtree = quantize_param_tree(params, block)
    if resident == "int8":
        return qtree
    if resident != "bf16":
        raise ValueError(
            f"qwz_distribute_params resident must be 'bf16' or 'int8', "
            f"got {resident!r}")
    return dequantize_param_tree(qtree)


class InferenceEngine:
    """Paged bucketed prefill/decode serving of a GPT-2 or Llama model
    over a continuous-batching scheduler, from a fixed program set
    (CUDA graphs on the card). ``device`` defaults to CUDA (and raises
    without a card); pass ``device="cpu"`` to run the kernels' plain
    versions on the CPU, eagerly. ``draft_fn`` is the drafter of
    ``spec_decode.method: "callable"``."""

    def __init__(self, model_config, params, inference_config=None,
                 dtype=torch.bfloat16, monitor: Optional[Any] = None,
                 observability_config=None, device=None, draft_fn=None):
        self.family, make_trunk, head_leaf, _ = _family_of(model_config)
        self._head_leaf = head_leaf
        self.device = _resolve_device(device)
        self.model_config = model_config
        self.dtype = dtype
        cfg = get_inference_config(
            {"inference": dict(inference_config or {})})
        _refuse_unported(cfg)
        self.config = cfg
        self.obs_config = get_observability_config(
            {"observability": dict(observability_config or {})})

        self.num_slots = cfg["max_batch_size"]
        self._rows = self.num_slots + 1          # +1 scratch row
        self._scratch = self.num_slots
        max_len = min(cfg["max_seq_len"],
                      model_config.max_position_embeddings)
        if max_len < cfg["max_seq_len"]:
            logger.info(f"inference: max_seq_len clamped to the model's "
                        f"max_position_embeddings ({max_len})")
        if max(cfg["prompt_buckets"]) > max_len:
            raise ValueError(
                f"inference.prompt_buckets max "
                f"({max(cfg['prompt_buckets'])}) exceeds the effective "
                f"max_seq_len ({max_len})")
        self.max_len = max_len
        self._vocab = model_config.vocab_size
        self._top_k = min(cfg["top_k"], self._vocab)

        # ------------------------------------------ chunked prefill
        # a long prompt becomes k fixed-size chunk dispatches that
        # interleave with the decode cadence: chunk state is just the
        # cache position advancing over pages the request already owns,
        # and the chunk program is the prefill program at ids shape
        # (batch_bucket, chunk_tokens). Prompts longer than the largest
        # prompt bucket can only be served this way. Context-parallel
        # chunks need a serving mesh (inference.mesh, refused above), so
        # every chunk runs on one device.
        ck = cfg["chunked_prefill"]
        self.chunked = bool(ck["enabled"])
        self._chunk_tokens = min(int(ck["chunk_tokens"]), max_len) \
            if self.chunked else 0
        self._cp_threshold = int(ck["cp_threshold_tokens"]) \
            if self.chunked else 0
        self._cp_shards = 1
        self._cp_reason = (
            "chunked prefill off" if not self.chunked else
            "no serving mesh (inference.mesh unset)" if self._cp_threshold
            > 0 else "cp_threshold_tokens unset")
        self._chunk_dispatches = 0

        # --------------------------------------- speculative decoding
        sd = cfg["spec_decode"]
        self.spec = bool(sd["enabled"])
        self._spec_k = int(sd["k"]) if self.spec else 0
        self._verify_widths = ()
        self._drafter = None
        if self.spec:
            # one verify program per width; default a single seq-(k+1)
            # program (config validation keeps widths >= 2: width 1 is
            # the plain decode program)
            widths = tuple(int(w) for w in sd["verify_widths"]) or \
                (self._spec_k + 1,)
            self._verify_widths = tuple(sorted(set(widths)))
            self._drafter = make_drafter(sd, draft_fn)

        # -------------------------------------- int8-resident weights
        # quantize_weights: False | "bf16" (wire only: from_checkpoint
        # ships the weights quantized) | "int8" (the qwZ blocks and
        # scales stay the live weights; the programs dequantize them at
        # each use, models/gpt2._wd)
        qw = cfg["quantize_weights"]
        self.weights_resident = "int8" if qw == "int8" else (
            "bf16" if qw else "off")
        self._weight_block = int(cfg["quantize_block"])
        if qw == "int8":
            # a tree from_checkpoint already quantized passes through
            params = quantize_param_tree(params, self._weight_block)
        self.params = self._place_params(params)
        # the LM head's fp32 operand, made once over dense weights; an
        # int8-resident head is dequantized inside each program
        self._head_w = None if isinstance(self.params[head_leaf],
                                          QuantizedParam) else \
            tied_head_weight(self.params[head_leaf], dtype)
        self._trunk = make_trunk(model_config, max_len, self.device)
        # an offline quantized-vs-fp probe's max logit error, recorded by
        # record_quant_logit_err: serving itself never pays for an oracle
        self.quant_logit_err: Optional[float] = None

        # telemetry: monitor + events.jsonl, Chrome-trace lanes, and the
        # request-granular serving plane (pure host code)
        serve_obs = self.obs_config["serve"]
        self.monitor = monitor if monitor is not None else \
            TensorBoardMonitor(enabled=False)
        self._log = None
        if cfg["events_dir"]:
            self._log = _JsonlWriter(cfg["events_dir"],
                                     max_mb=serve_obs["events_max_mb"])
            if getattr(self.monitor, "mirror", None) is None:
                self.monitor.mirror = self._log
        self._recorder = None
        self._chrome_path = self.obs_config["chrome_trace_path"] or None
        if self._chrome_path:
            self._recorder = ChromeTraceRecorder()
        self._tracer = ServeTracer(serve_obs, writer=self._log,
                                   recorder=self._recorder)
        # the postmortem plane: a flight ring over the mirror and a stall
        # watchdog beaten at each phase (host threads only)
        self.health = HealthPlane(
            self.obs_config["health"], monitor=self.monitor, rank=0,
            component="serve", events_dir=cfg["events_dir"] or None)
        self._steps = 0
        self._serve_secs = 0.0
        self._state_event_every = 64       # serve_state cadence (steps)
        # per-program dispatch counts and wall seconds (host clock around
        # work that ends in a device->host copy of the sampled tokens)
        names = ["prefill", "decode"] + (["verify"] if self.spec else []) \
            + (["chunk"] if self.chunked else [])
        self.dispatches = dict.fromkeys(names, 0)
        self.dispatch_secs = dict.fromkeys(names, 0.0)
        # the fixed program set: CUDA graphs on the card, eager on the CPU
        self.programs = ProgramSet(self.device)
        self._warm_programs: Optional[int] = None
        # served prefill batches by "<batch bucket>x<prompt bucket>"
        self.prefill_shapes: Dict[str, int] = {}

        # ------------------------------------------ disaggregation
        dg = cfg["disagg"]
        self.disagg = bool(dg["enabled"])
        # a distinct decode mesh would force separate pools; it is
        # refused above, so only the config's own choice counts
        self._separate_pools = bool(self.disagg and dg["separate_pools"])
        self._handoff_q = HandoffQueue() if self.disagg else None
        self._handoff_stats = HandoffStats() if self.disagg else None
        # chunked engines keep the trace too: the TBT bound is the
        # ordering pin "at most one chunk dispatch per step, after every
        # decode of that step"
        self._dispatch_trace = DispatchTrace() \
            if (self.disagg or self.chunked) else None
        self._link = LinkModel() if self._separate_pools else None
        if self._separate_pools:
            self.dispatches.update(handoff_export=0, handoff_import=0)
            self.dispatch_secs.update(handoff_export=0.0,
                                      handoff_import=0.0)

        # ------------------------------------------------- KV cache
        pk = cfg["paged_kv"]
        self.paged = bool(pk["enabled"])
        allocator = admit_allocator = None
        self._decode_attn_path = "gather"
        self._decode_page_buckets = ()
        self.paged_spec = self.paged_spec_prefill = self.cache_spec = None
        self._cache_prefill = None
        self._page_bytes = 0
        if self.paged:
            ps = pk["page_size"]
            num_pages = pk["num_pages"] or (
                self.num_slots * pages_for(max_len, ps) + 1)
            kv_dtype = {"bf16": torch.bfloat16, "int8": torch.int8}.get(
                pk["kv_dtype"], dtype)
            self.paged_spec = paged_spec_for(
                model_config, num_pages, ps, max_len, dtype=kv_dtype,
                kv_quant_block=pk["kv_quant_block"])
            self._cache = init_paged_kv_cache(self.paged_spec, self.device)
            cache_bytes = paged_kv_bytes(self.paged_spec)
            self._page_bytes = cache_bytes // num_pages
            # static pool cost per token of capacity, scales included
            self._kv_bpt = cache_bytes / float(num_pages * ps)
            allocator = PageAllocator(num_pages, ps,
                                      prefix_cache=pk["prefix_cache"])
            if self._separate_pools:
                # the prefill side's own pool, prompts only (a request's
                # decode pages are reserved from the main pool at its
                # claim); it holds the prefix cache. Chunked prefill keeps
                # whole long prompts here until the last chunk hands off,
                # so the pool and the handoff width are sized by max_len
                max_prompt = max_len if self.chunked \
                    else max(cfg["prompt_buckets"])
                ppages = dg["prefill_pages"] or (
                    self.num_slots * pages_for(max_prompt, ps) + 1)
                self.paged_spec_prefill = paged_spec_for(
                    model_config, ppages, ps, max_prompt, dtype=kv_dtype,
                    kv_quant_block=pk["kv_quant_block"])
                self._cache_prefill = init_paged_kv_cache(
                    self.paged_spec_prefill, self.device)
                admit_allocator = PageAllocator(
                    ppages, ps, prefix_cache=pk["prefix_cache"])
                cache_bytes += paged_kv_bytes(self.paged_spec_prefill)
            self._decode_attn_path = _ATTN_PATHS[pk["attn_kernel"]]
            pps = self.paged_spec.pages_per_seq
            self._decode_page_buckets = tuple(
                int(b) for b in pk["decode_page_buckets"] if b < pps) + \
                (pps,)
        else:
            self.cache_spec = cache_spec_for(model_config, self._rows,
                                             max_len, dtype=dtype)
            self._cache = init_kv_cache(self.cache_spec, self.device)
            cache_bytes = kv_cache_bytes(self.cache_spec)
            self._kv_bpt = cache_bytes / float(self._rows * max_len)
        # pages_per_seq of the pool the prefill program scatters into
        self._prefill_pps = 0 if not self.paged else (
            self.paged_spec_prefill.pages_per_seq if self._separate_pools
            else self.paged_spec.pages_per_seq)
        # the width of one handoff migration: every live prompt page fits
        # and pad entries (0) land in the null page, so the shape stays
        # static; the slab the pages cross in is allocated once
        self._handoff_width = self._prefill_pps \
            if self._separate_pools else 0
        self._slab = None
        # the cross-replica migration programs' slab, over the decode
        # pool at the full table width: made by warm_migration()
        self._mig_width = 0
        self._mig_slab = None
        if self._separate_pools:
            self._slab = tuple(
                torch.empty((c.shape[0], self._handoff_width)
                            + tuple(c.shape[2:]), dtype=c.dtype,
                            device=self.device)
                for c in self._cache_prefill)
        self.scheduler = Scheduler(self.num_slots, cfg["prompt_buckets"],
                                   cfg["batch_buckets"], max_len,
                                   allocator=allocator,
                                   lookahead=cfg["admit_lookahead"],
                                   tracer=self._tracer,
                                   admit_allocator=admit_allocator,
                                   drafter=self._drafter,
                                   spec_k=self._spec_k,
                                   chunk_tokens=self._chunk_tokens)
        self._weight_version = "initial"
        self._weight_ordinal = 0
        self.scheduler.weight_version = self._weight_version

        if self.paged:
            logger.info(
                f"inference decode attention: {self._decode_attn_path} "
                f"(configured {pk['attn_kernel']!r}; page walk widths "
                f"{list(self._decode_page_buckets)})")
            if self._log is not None:
                self._log.add_event(
                    "decode_attn_path", path=self._decode_attn_path,
                    reason="configured", requested=pk["attn_kernel"],
                    decode_page_buckets=list(self._decode_page_buckets))
        if self.chunked and self._cp_threshold > 0:
            logger.info(f"inference context-parallel prefill: off "
                        f"({self._cp_reason}; threshold "
                        f"{self._cp_threshold} tokens)")
            if self._log is not None:
                self._log.add_event(
                    "chunked_prefill_path", chunk_tokens=self._chunk_tokens,
                    cp_shards=self._cp_shards, cp_reason=self._cp_reason,
                    cp_threshold_tokens=self._cp_threshold)
        notes = ""
        if self.spec:
            notes += (f", spec_decode k={self._spec_k} verify_widths="
                      f"{list(self._verify_widths)} "
                      f"({type(self._drafter).__name__})")
        if self.chunked:
            notes += f", chunked prefill {self._chunk_tokens} tokens"
        if self.disagg:
            notes += (", disagg (separate pools)" if self._separate_pools
                      else ", disagg (shared pool)")
        if qw:
            notes += f", weights {self.weights_resident}-resident"
        if self.paged:
            geom = (f"paged KV cache: {self.paged_spec.num_pages} pages x "
                    f"{self.paged_spec.page_size} tokens "
                    f"({cache_bytes / 2**20:.1f} MiB, {self.paged_spec.dtype}"
                    f"{' + fp32 scales' if self.paged_spec.quantized else ''}"
                    f"), prefix cache "
                    f"{'on' if pk['prefix_cache'] else 'off'}")
        else:
            geom = f"dense KV cache {cache_bytes / 2**20:.1f} MiB"
        logger.info(
            f"inference engine: {self.family} on {self.device}, "
            f"{self.num_slots} slots, max_len {max_len}, prompt buckets "
            f"{cfg['prompt_buckets']}, batch buckets {cfg['batch_buckets']}, "
            f"{geom}{notes}")

    def _place_params(self, params) -> Dict[str, Any]:
        """Params on the engine's device. The block matmul weights and
        biases are cast to the engine dtype once, here: the JAX model
        casts the same fp32 values at every use, so the operands are
        identical. Embeddings, an untied ``lm_head`` and the norm
        parameters stay as given, since the JAX model reads them in
        fp32. An int8-resident leaf (``QuantizedParam``) moves as it is:
        it is dequantized at each use. Blocks come as one ``h_{i}`` per
        block or stacked under ``h``. Every leaf is a copy the engine
        owns, even where device and dtype already match:
        :meth:`swap_params` writes into these tensors in place, and must
        reach neither the caller's tree nor another engine's."""
        def place(tree, cast):
            if isinstance(tree, dict):
                return {k: place(v, cast) for k, v in tree.items()}
            if isinstance(tree, QuantizedParam):
                return QuantizedParam(
                    tree.q.to(self.device, copy=True),
                    tree.scale.to(self.device, copy=True),
                    tree.orig_dtype, tree.block)
            t = torch.as_tensor(tree)
            return t.to(self.device, dtype=self.dtype if cast else t.dtype,
                        copy=True)
        out = {}
        for name, sub in params.items():
            if name == "h" or name.startswith("h_"):
                out[name] = {k: place(v, k in _MATMUL_LEAVES)
                             for k, v in sub.items()}
            else:
                out[name] = place(sub, False)
        return out

    # ---------------------------------------------------- device programs
    def _sample_tokens(self, logits: torch.Tensor, seeds: np.ndarray,
                       sample_pos: np.ndarray,
                       temps: np.ndarray) -> np.ndarray:
        """Per-request sampling: greedy rows (temp <= 0) take the fp32
        argmax (first index on ties, as ``jnp.argmax``); the rest sample
        ``softmax(logits / temp)`` under the engine-global top-k filter,
        from a ``torch.Generator`` seeded by (request seed, position of
        the sampled token) — deterministic per request whatever shares
        the batch, though not ``jax.random``'s bits."""
        logits = logits.float()
        out = logits.argmax(dim=-1)
        rows = np.flatnonzero(temps > 0)
        if rows.size:
            idx = torch.as_tensor(rows, device=logits.device)
            scaled = logits[idx] / torch.as_tensor(
                np.maximum(temps[rows], 1e-6)[:, None], device=logits.device)
            if self._top_k > 0:
                kth = torch.topk(scaled, self._top_k, dim=-1).values[:, -1:]
                scaled = torch.where(scaled < kth, NEG_INF, scaled)
            probs = torch.softmax(scaled, dim=-1)
            for j, r in enumerate(rows):
                gen = torch.Generator(device=logits.device)
                gen.manual_seed(hash((int(seeds[r]), int(sample_pos[r])))
                                & 0x7FFFFFFFFFFFFFFF)
                out[r] = torch.multinomial(probs[j], 1, generator=gen)[0]
        return out.cpu().numpy().astype(np.int32)

    def _head(self) -> torch.Tensor:
        """The LM head's fp32 operand: made once over dense weights,
        dequantized here, inside the program, over int8-resident ones."""
        if self._head_w is not None:
            return self._head_w
        return tied_head_weight(self.params[self._head_leaf], self.dtype)

    def _prefill_impl(self, ids, lengths, slots) -> torch.Tensor:
        """The dense prefill program's body: the padded prompt batch runs
        through the cached forward against a fresh (bucket-batch-sized)
        cache from position 0, whose rows then scatter into the slot
        cache at ``slots`` (pad rows target the scratch row). Returns
        the fp32 logits of each row's last true prompt position."""
        spec = self.cache_spec
        bb = ids.shape[0]
        shape = (spec.num_layers, bb) + spec.shape[2:]
        tmp = tuple(torch.zeros(shape, dtype=spec.dtype, device=ids.device)
                    for _ in range(2))
        x = self._trunk(self.params, self.model_config, ids, tmp,
                        torch.zeros((bb,), dtype=torch.int32,
                                    device=ids.device),
                        self.dtype, None)
        rows = slots.long()
        for c, t in zip(self._cache, tmp):
            c[:, rows] = t
        last = x[torch.arange(bb, device=ids.device), lengths.long() - 1]
        return _tied_logits(last, self._head(), self.dtype)

    def _decode_impl(self, toks, positions) -> torch.Tensor:
        """The dense decode program's body: one step over the whole slot
        table, each slot's pending token written at its own position and
        attention over its whole ``max_len`` row. Inactive rows compute
        logits the host discards. Returns (rows, vocab) fp32 logits."""
        x = self._trunk(self.params, self.model_config, toks[:, None],
                        self._cache, positions, self.dtype, None)
        return _tied_logits(x[:, 0], self._head(), self.dtype)

    def _prefill_paged_impl(self, ids, lengths, positions,
                            tables) -> torch.Tensor:
        """The prefill program's body, over its static device inputs:
        run each row's un-prefixed prompt suffix (``ids``, true lengths
        ``lengths``) through the cached forward from its ``positions``
        offset (tokens covered by shared prefix pages), scattering K/V
        into the pool through ``tables`` (pad rows carry all-null tables,
        so their writes land in the null page). Returns the fp32 logits
        of each row's last true prompt position; the LM head runs on
        those rows only. A chunk dispatch is this body at ids shape
        (batch bucket, chunk_tokens). With separate pools the prompt's
        K/V go into the prefill side's pool."""
        cache = self._cache_prefill if self._separate_pools else self._cache
        x = self._trunk(self.params, self.model_config, ids, cache,
                        positions, self.dtype, tables,
                        self._decode_attn_path)
        last = x[torch.arange(ids.shape[0], device=ids.device),
                 lengths.long() - 1]
        return _tied_logits(last, self._head(), self.dtype)

    def _decode_paged_impl(self, toks, positions, tables) -> torch.Tensor:
        """The decode program's body: one paged decode step over the full
        slot table. Each slot's pending token scatters into its page at
        its own position, then attention runs off the pool: the
        paged-decode kernel walks only each row's live pages (or the
        gather path assembles the stripe). Inactive rows carry all-null
        tables: their logits are discarded. Returns (rows, vocab) fp32
        logits."""
        x = self._trunk(self.params, self.model_config, toks[:, None],
                        self._cache, positions, self.dtype, tables,
                        self._decode_attn_path)
        return _tied_logits(x[:, 0], self._head(), self.dtype)

    def _verify_paged_impl(self, toks, positions, tables) -> torch.Tensor:
        """The verify program's body: ``toks[i] = [pending, d_1 ..
        d_{v-1}]``, each row's pending token plus its draft proposals
        (zero-padded), runs as a seq-``v`` pass through the same paged
        cached forward as decode (the gather attention, as JAX's
        ``q_len > 1`` path), writing all ``v`` positions. Returns
        ``(rows * v, vocab)`` fp32 logits: row ``i * v + j`` is what the
        plain decode would have seen after position ``positions[i] + j``.
        Rejected positions' K/V sit beyond the causal cache mask and are
        overwritten by later contiguous writes before any query attends
        them. Tables ride at full width (one program per verify
        width)."""
        B, V = toks.shape
        x = self._trunk(self.params, self.model_config, toks, self._cache,
                        positions, self.dtype, tables,
                        self._decode_attn_path)
        return _tied_logits(x.reshape(B * V, -1), self._head(), self.dtype)

    def _export_pages_impl(self, idx) -> torch.Tensor:
        """The ``handoff_export`` program's body: gather ``idx``'s pages
        (a request's live prompt pages, padded with the null page) out
        of the prefill pool into the slab, leaf by leaf, so an int8
        pool's scale pools ride along. The pool keeps serving."""
        for c, s in zip(self._cache_prefill, self._slab):
            torch.index_select(c, 1, idx.long(), out=s)
        return self._slab[0]

    def _import_pages_impl(self, idx) -> torch.Tensor:
        """The ``handoff_import`` program's body: scatter the slab into
        the decode pool at ``idx`` (pad entries land in the null page),
        in place."""
        for c, s in zip(self._cache, self._slab):
            c.index_copy_(1, idx.long(), s)
        return self._cache[0]

    def _migrate_export_impl(self, idx) -> torch.Tensor:
        """The ``migrate_export`` program's body: gather ``idx``'s pages
        (an in-flight request's live pages, padded with the null page)
        out of the decode pool into the migration slab, leaf by leaf (an
        int8 pool's scale pools ride along). The pool keeps serving."""
        for c, s in zip(self._cache, self._mig_slab):
            torch.index_select(c, 1, idx.long(), out=s)
        return self._mig_slab[0]

    def _migrate_import_impl(self, idx) -> torch.Tensor:
        """The ``migrate_import`` program's body: scatter the migration
        slab into the decode pool at ``idx``, in place, into the tensors
        whose addresses the decode graphs hold (pad entries land in the
        null page)."""
        for c, s in zip(self._cache, self._mig_slab):
            c.index_copy_(1, idx.long(), s)
        return self._cache[0]

    # ----------------------------------------------------------- serving
    def submit(self, request: Request) -> int:
        """Queue one request; returns its uid (FIFO with bounded-lookahead
        admission)."""
        return self.scheduler.submit(request)

    def cancel(self, uid: int, reason: str = "evicted"
               ) -> Optional[FinishedRequest]:
        """Evict ``uid``, queued or in flight: its pages free at once, a
        ``serve_evict`` row lands in the trail, and the returned
        FinishedRequest carries ``ttft_ms=None`` when no first token was
        released. None for an unknown or finished uid. Call between
        :meth:`step` calls. Under disaggregation a request whose prefill
        is done may wait in the handoff queue: its record is taken out
        and counted ``dropped`` first, so the queue never holds it after
        its slot is gone."""
        if self._handoff_q is not None:
            rec = self._handoff_q.pop(uid)
            if rec is not None:
                self._handoff_q.dropped(rec)
        return self.scheduler.evict(uid, reason=reason)

    # ------------------------------------------------- live KV migration
    def export_request(self, uid: int) -> Optional[MigrationRecord]:
        """Export one in-flight request's portable state: a
        :class:`~.disagg.MigrationRecord` whose slabs hold its live pages
        (CPU tensors, trimmed to the live pages), gathered by the
        ``migrate_export`` program; the request is then evicted here
        (reason "migrate", a row the router drops). None when it cannot
        leave from here: unknown uid, migration not warmed, no token
        sampled yet, or its pages still in the prefill pool. Call between
        :meth:`step` calls: the export replays after the step's programs
        on the same stream, and the slab reaches the host before this
        returns."""
        if self._mig_slab is None:
            return None
        sched = self.scheduler
        for sid in sched.active_slots():
            slot = sched.slots[sid]
            if slot.request.uid != uid:
                continue
            if slot.pending_tok is None:
                return None
            if self._separate_pools and slot.pool == "admit":
                return None
            live = min(pages_for(slot.position, self.paged_spec.page_size),
                       len(slot.pages))
            idx = np.zeros((self._mig_width,), np.int32)
            idx[:live] = slot.pages[:live]
            self._run_handoff("migrate_export", idx)
            # the wire carries the live pages, never the reservation; an
            # int8 pool exports four slabs (payload and fp32 scales)
            slabs = tuple(t[:, :live].to("cpu", copy=True)
                          for t in self._mig_slab)
            req = slot.request
            rec = MigrationRecord(
                uid=uid, prompt=list(req.prompt),
                max_new_tokens=req.max_new_tokens,
                temperature=req.temperature, seed=req.seed,
                eos_id=req.eos_id, priority=getattr(req, "priority", 0),
                position=slot.position, pending_tok=slot.pending_tok,
                tokens=list(slot.tokens), live_pages=live,
                page_bytes=self._page_bytes, ttft_ms=slot.ttft_ms,
                queue_wait_ms=slot.queue_wait_ms,
                elapsed_ms=(sched._clock() - slot.t_submit) * 1e3,
                draft_proposed=slot.draft_proposed,
                draft_accepted=slot.draft_accepted,
                weight_version=self._weight_version,
                trace_id=getattr(req, "trace_id", None),
                hop=getattr(req, "hop", 0),
                kslab=slabs[0], vslab=slabs[1],
                kscale_slab=slabs[2] if len(slabs) == 4 else None,
                vscale_slab=slabs[3] if len(slabs) == 4 else None)
            # the lineage row before the eviction below pops the trace:
            # the destination's serve_migrate_in shares its trace id
            self._tracer.on_migrate_out(uid, position=rec.position,
                                        pages=rec.live_pages,
                                        nbytes=rec.nbytes)
            sched.evict(uid, reason="migrate")
            return rec
        return None

    def import_request(self, rec: MigrationRecord) -> Optional[int]:
        """Resume a migrated request here: reserve its full-lifetime
        pages, copy its slabs into the migration slab, scatter them into
        the pool at the same logical positions (the ``migrate_import``
        program, in place) and install the slot at the same position.
        Decode continues as it would have at the source, since sampling
        draws from (seed, position) alone. Returns the slot, or None,
        with nothing allocated, when this engine cannot take it: not
        warmed, no free slot, the pool exhausted, or slabs whose geometry
        or dtype differ from this pool's (payload and scales alike)."""
        if self._mig_slab is None:
            return None
        live = int(rec.live_pages)
        slabs = [rec.kslab, rec.vslab]
        if getattr(rec, "kscale_slab", None) is not None or \
                getattr(rec, "vscale_slab", None) is not None:
            slabs += [rec.kscale_slab, rec.vscale_slab]
        if len(slabs) != len(self._cache) or live > self._mig_width or \
                any(x is None for x in slabs):
            return None      # an int8-pool record into a dense pool, or back
        for x, leaf in zip(slabs, self._cache):
            if not isinstance(x, torch.Tensor) or \
                    tuple(x.shape) != (leaf.shape[0], live) + \
                    tuple(leaf.shape[2:]) or x.dtype != leaf.dtype:
                return None
        sched = self.scheduler
        if not sched.free_slots():
            return None
        spec = self.paged_spec
        need = pages_for(len(rec.prompt) + rec.max_new_tokens,
                         spec.page_size)
        pages = sched.allocator.alloc(max(need, live))
        if pages is None:
            return None
        idx = np.zeros((self._mig_width,), np.int32)
        idx[:live] = pages[:live]
        # pad entries scatter zeros into the null page
        for dst, src in zip(self._mig_slab, slabs):
            dst.zero_()
            dst[:, :live].copy_(src)
        self._run_handoff("migrate_import", idx)
        req = Request(prompt=list(rec.prompt),
                      max_new_tokens=rec.max_new_tokens,
                      temperature=rec.temperature, seed=rec.seed,
                      eos_id=rec.eos_id, priority=rec.priority,
                      uid=rec.uid, trace_id=getattr(rec, "trace_id", None),
                      hop=int(getattr(rec, "hop", 0)) + 1)
        sid = sched.install_slot(
            req, position=rec.position, pending_tok=rec.pending_tok,
            tokens=rec.tokens, pages=pages, ttft_ms=rec.ttft_ms,
            queue_wait_ms=rec.queue_wait_ms, elapsed_ms=rec.elapsed_ms,
            draft_proposed=rec.draft_proposed,
            draft_accepted=rec.draft_accepted, pool="main")
        if sid is None:
            sched.allocator.free(pages)
            return None
        # the destination half of the lineage pair: the original trace id
        # with the hop bumped
        self._tracer.on_migrate_in(
            rec.uid, trace_id=req.trace_id, hop=req.hop,
            position=rec.position, pages=live, nbytes=rec.nbytes,
            queue_wait_ms=rec.queue_wait_ms, ttft_ms=rec.ttft_ms,
            elapsed_ms=rec.elapsed_ms, tokens=len(rec.tokens))
        if self._log is not None:
            self._log.add_event("serve_resume", uid=rec.uid, slot=sid,
                                position=rec.position, live_pages=live)
        return sid

    def _program(self, name: str, *shape):
        """(key, body) of a dispatch: a chunk at a prefill shape is that
        prefill program, as one jit serves both in the JAX engine."""
        if name == "chunk" and shape[1] in self.config["prompt_buckets"]:
            name = "prefill"
        body = {"prefill": self._prefill_paged_impl if self.paged
                else self._prefill_impl,
                "chunk": self._prefill_paged_impl,
                "decode": self._decode_paged_impl if self.paged
                else self._decode_impl,
                "verify": self._verify_paged_impl,
                "handoff_export": self._export_pages_impl,
                "handoff_import": self._import_pages_impl,
                "migrate_export": self._migrate_export_impl,
                "migrate_import": self._migrate_import_impl}[name]
        return (name,) + tuple(int(d) for d in shape), body

    def _dispatch(self, name: str, shape, host: Dict[str, np.ndarray],
                  seeds: np.ndarray, sample_pos: np.ndarray,
                  temps: np.ndarray) -> np.ndarray:
        """Run the program of ``name`` at ``shape`` on ``host``'s arrays
        and sample one token per output row (the sampling runs outside
        the program and ends in a device->host copy)."""
        t0 = time.perf_counter()
        key, body = self._program(name, *shape)
        logits = self.programs.dispatch(key, body, host)
        out = self._sample_tokens(logits, seeds, sample_pos, temps)
        self.dispatch_secs[name] += time.perf_counter() - t0
        self.dispatches[name] += 1
        return out

    def _run_handoff(self, name: str, idx: np.ndarray) -> None:
        """One dispatch of a page-moving program (``handoff_export``,
        ``handoff_import``, ``migrate_export``, ``migrate_import``) over
        the page indices ``idx``, whose length is the program's width (no
        sampling follows it)."""
        t0 = time.perf_counter()
        key, body = self._program(name, len(idx))
        self.programs.dispatch(key, body, {"idx": idx})
        self.dispatch_secs[name] += time.perf_counter() - t0
        self.dispatches[name] += 1

    def _prefill_host(self, bb: int, width: int):
        """Zeroed host inputs of a prefill or chunk dispatch of ``bb``
        rows of ``width`` tokens (lengths 1; paged: all-null tables of
        the prefill pool's width; dense: every row at the scratch slot)
        and its sampling arrays."""
        host = {"ids": np.zeros((bb, width), np.int32),
                "lengths": np.ones((bb,), np.int32)}
        if self.paged:
            host["positions"] = np.zeros((bb,), np.int32)
            host["tables"] = np.zeros((bb, self._prefill_pps), np.int32)
        else:
            host["slots"] = np.full((bb,), self._scratch, np.int32)
        return host, np.zeros((bb,), np.int64), np.zeros((bb,), np.float32)

    def _run_prefill(self, batch) -> np.ndarray:
        bb = batch.batch_bucket
        shape = f"{bb}x{batch.prompt_bucket}"
        self.prefill_shapes[shape] = self.prefill_shapes.get(shape, 0) + 1
        host, seeds, temps = self._prefill_host(bb, batch.prompt_bucket)
        for i, req in enumerate(batch.requests):
            seeds[i] = req.seed
            temps[i] = req.temperature
        if self.paged:
            suffixes = [r.prompt[pl:] for r, pl in
                        zip(batch.requests, batch.prefix_lens)]
            host["ids"], host["lengths"] = pad_prompts(
                suffixes, batch.prompt_bucket, bb)
            for i, (pl, pages) in enumerate(zip(batch.prefix_lens,
                                                batch.page_tables)):
                host["positions"][i] = pl
                host["tables"][i, :len(pages)] = pages
            sample_pos = host["positions"] + host["lengths"]
        else:
            host["ids"], host["lengths"] = pad_prompts(
                [r.prompt for r in batch.requests], batch.prompt_bucket, bb)
            host["slots"][:len(batch.slot_ids)] = batch.slot_ids
            sample_pos = host["lengths"]
        with trace_span("serve/prefill", recorder=self._recorder,
                        batch=bb, prompt=batch.prompt_bucket):
            return self._dispatch(
                "prefill", (bb, batch.prompt_bucket), host, seeds,
                sample_pos, temps)

    def _drain_request_metrics(self):
        """Per-admitted-request scalar writes (TTFT / queue wait) pulled
        off the scheduler's drain queues."""
        sched = self.scheduler
        for ttft in sched.drain_ttfts():
            self.monitor.write_serving_metrics(
                ttft_ms=ttft, tokens=sched.total_tokens, flush=False)
        for qwait in sched.drain_queue_waits():
            self.monitor.write_serving_metrics(
                queue_wait_ms=qwait, tokens=sched.total_tokens,
                flush=False)

    def _hand_off(self, sid: int, req, first: int, now: float) -> None:
        """Park a completed prefill's first token in the handoff queue:
        the decode phase claims it, so TTFT includes the handoff."""
        self._handoff_q.push(HandoffRecord(
            uid=req.uid, slot=sid, first_token=first,
            live_pages=pages_for(len(req.prompt),
                                 self.paged_spec.page_size),
            prompt_tokens=len(req.prompt), t_ready=now))

    def _prefill_phase(self, finished: List[FinishedRequest]) -> None:
        """Admission + bucketed prefill dispatches. Each first token is
        released to its request at once, or under disaggregation parked
        in the handoff queue for the decode phase to claim."""
        sched = self.scheduler
        self.health.heartbeat("prefill")
        t0 = time.perf_counter()
        for batch in sched.admit():
            t_p = time.perf_counter()
            first = self._run_prefill(batch)
            prefill_ms = (time.perf_counter() - t_p) * 1e3
            if self._dispatch_trace is not None:
                self._dispatch_trace.record(self._steps, "prefill")
            for sid, req in zip(batch.slot_ids, batch.requests):
                self._tracer.on_prefill(
                    req.uid, sid, prefill_ms, batch.prompt_bucket,
                    batch.batch_bucket, len(batch.requests))
            if self.disagg:
                now = time.perf_counter()
                for i, (sid, req) in enumerate(zip(batch.slot_ids,
                                                   batch.requests)):
                    self._hand_off(sid, req, int(first[i]), now)
            else:
                finished.extend(sched.record_tokens(
                    {sid: int(first[i])
                     for i, sid in enumerate(batch.slot_ids)}))
            self._drain_request_metrics()
        self._serve_secs += time.perf_counter() - t0

    def _chunk_phase(self, finished: List[FinishedRequest]) -> None:
        """At most one chunk dispatch per engine step, the pinned TBT
        bound: a decode dispatch never waits behind more than one
        ``chunk_tokens``-sized prefill slice, however long the prompt.
        The dispatch is the prefill program at ids shape (batch_bucket,
        chunk_tokens): ``positions`` is each slot's absolute prefilled
        offset, ``tables`` its full page list, K/V scatter straight into
        the pool. Intermediate chunks' sampled tokens are discarded on
        the host; the final chunk samples at ``positions + lengths``, the
        position a whole-prompt prefill samples at, so the first token is
        the one whole-prompt prefill would have produced."""
        if not self.chunked:
            return
        sched = self.scheduler
        cand = sched.chunk_batch(cap=max(self.config["batch_buckets"]))
        if not cand:
            return
        self.health.heartbeat("chunk_prefill")
        t0 = time.perf_counter()
        bb = pick_bucket(len(cand), self.config["batch_buckets"])
        ct = self._chunk_tokens
        host, seeds, temps = self._prefill_host(bb, ct)
        spans = []
        for i, sid in enumerate(cand):
            slot = sched.slots[sid]
            req = slot.request
            start, n = sched.chunk_span(sid)
            spans.append((sid, req, start, n,
                          (start - slot.prefix_len) // ct))
            host["ids"][i, :n] = req.prompt[start:start + n]
            host["lengths"][i] = n
            host["positions"][i] = start
            host["tables"][i, :len(slot.pages)] = slot.pages
            seeds[i] = req.seed
            temps[i] = req.temperature
        t_c = time.perf_counter()
        with trace_span("serve/chunk", recorder=self._recorder,
                        batch=bb, chunk=ct, cp_shards=1):
            first = self._dispatch("chunk", (bb, ct), host, seeds,
                                   host["positions"] + host["lengths"],
                                   temps)
        wall_ms = (time.perf_counter() - t_c) * 1e3
        if self._dispatch_trace is not None:
            self._dispatch_trace.record(self._steps, "chunk")
        self._chunk_dispatches += 1
        now = time.perf_counter()
        released: Dict[int, int] = {}
        for i, (sid, req, start, n, k) in enumerate(spans):
            self._tracer.on_prefill_chunk(req.uid, sid, k, n, wall_ms,
                                          cp_shards=1)
            if not sched.record_chunk(sid, n):
                continue                    # mid-prompt, keep chunking
            if self.disagg:
                self._hand_off(sid, req, int(first[i]), now)
            else:
                released[sid] = int(first[i])
        if released:
            finished.extend(sched.record_tokens(released))
        self.monitor.write_serving_metrics(
            chunk_dispatches=self._chunk_dispatches,
            tokens=sched.total_tokens, flush=False)
        self._drain_request_metrics()
        self._serve_secs += time.perf_counter() - t0

    def _claim_phase(self, finished: List[FinishedRequest]) -> None:
        """The decode side's intake under disaggregation: claim completed
        prefills off the handoff queue in arrival order. Over a shared
        pool the claim moves page ownership on the host only; over
        separate pools it reserves the request's lifetime pages in the
        decode pool and migrates only the live prompt pages (export,
        import, then one synchronize per claim so the measured time
        covers the copy), priced by the link model beside the measured
        time. A claim the decode pool cannot fund yet goes back to the
        front of the queue with a "handoff" defer. Each claim releases
        the request's first token."""
        sched = self.scheduler
        q = self._handoff_q
        tracer = self._tracer
        self.health.heartbeat("handoff_claim")
        t0 = time.perf_counter()
        for rec in q.drain():
            slot = sched.slots[rec.slot]
            if slot is None or slot.request.uid != rec.uid:
                q.dropped(rec)     # evicted while the handoff waited
                continue
            transfer_ms = priced = 0.0
            pages = nbytes = 0
            mode = "shared_pool"
            if self._separate_pools:
                req = slot.request
                need = pages_for(len(req.prompt) + req.max_new_tokens,
                                 self.paged_spec.page_size)
                new_pages = sched.allocator.alloc(need)
                if new_pages is None:
                    q.requeue(rec)
                    tracer.on_defer(rec.uid, "handoff")
                    continue
                mode = "migrate"
                t_m = time.perf_counter()
                src = np.zeros((self._handoff_width,), np.int32)
                dst = np.zeros((self._handoff_width,), np.int32)
                live = slot.pages[:rec.live_pages]
                src[:len(live)] = live
                dst[:len(live)] = new_pages[:len(live)]
                self._run_handoff("handoff_export", src)
                self._run_handoff("handoff_import", dst)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                transfer_ms = (time.perf_counter() - t_m) * 1e3
                pages = len(live)
                nbytes = pages * self._page_bytes
                priced = price_handoff(pages, self._page_bytes, self._link,
                                       axis="intra")
                sched.adopt_pages(rec.slot, new_pages)
                self._dispatch_trace.record(self._steps, "handoff")
            queue_ms = q.claimed(rec)
            tracer.on_handoff(rec.uid, queue_ms, transfer_ms, pages,
                              nbytes, mode, priced)
            self._handoff_stats.record(queue_ms, transfer_ms, pages, nbytes)
            self.monitor.write_serving_metrics(
                handoff_ms=queue_ms + transfer_ms,
                tokens=sched.total_tokens, flush=False)
            finished.extend(sched.record_tokens(
                {rec.slot: rec.first_token}))
            self._drain_request_metrics()
        self._serve_secs += time.perf_counter() - t0

    def _decode_phase(self, finished: List[FinishedRequest]) -> bool:
        """Advance every in-flight sequence: a plain one-token decode
        dispatch, or, with speculation and live draft proposals, one
        seq-``v`` verify dispatch that emits ``accepted + 1`` tokens per
        row. Returns whether anything dispatched."""
        sched = self.scheduler
        self.health.heartbeat("decode")
        sids, toks, poss, temps, seeds = sched.decode_state()
        if not sids:
            return False
        t0 = time.perf_counter()
        occupancy = len(sids) / self.num_slots
        toks_a = np.zeros((self._rows,), np.int32)
        poss_a = np.zeros((self._rows,), np.int32)
        temps_a = np.zeros((self._rows,), np.float32)
        seeds_a = np.zeros((self._rows,), np.int64)
        for sid, tok, pos, temp, seed in zip(sids, toks, poss, temps,
                                             seeds):
            toks_a[sid] = tok
            poss_a[sid] = pos
            temps_a[sid] = temp
            seeds_a[sid] = seed
        props: Dict[int, List[int]] = {}
        if self.spec and self.paged:
            props = sched.draft_proposals(
                cap=max(self._verify_widths) - 1)
        spec_kw = {}
        runs: Dict[int, List[int]] = {}
        draft_stats = None
        t_d = time.perf_counter()
        if props:
            dmax = max(len(p) for p in props.values())
            v = pick_bucket(dmax + 1, self._verify_widths)
            vt = np.zeros((self._rows, v), np.int32)
            vt[:, 0] = toks_a
            for sid, p in props.items():
                vt[sid, 1:1 + len(p)] = p
            # verify tables ride at full width: one program per verify
            # width, not per width x page bucket
            tables = sched.block_table_rows(
                self._rows, self.paged_spec.pages_per_seq)
            # row i's j-th sample is at the position plain decode would
            # sample it at, with that position's generator
            sample_pos = (poss_a[:, None] + 1 + np.arange(v)[None, :])
            with trace_span("serve/verify", recorder=self._recorder,
                            active=len(sids), width=v):
                out = self._dispatch(
                    "verify", (v,),
                    {"toks": vt, "positions": poss_a, "tables": tables},
                    np.repeat(seeds_a, v), sample_pos.reshape(-1),
                    np.repeat(temps_a, v)).reshape(self._rows, v)
            if self._dispatch_trace is not None:
                self._dispatch_trace.record(self._steps, "verify")
            draft_stats = {}
            proposed_total = accepted_total = 0
            for sid in sids:
                p = props.get(sid)
                if not p:
                    # rode the verify program with zero drafts: a draft
                    # stall, traced once per request
                    runs[sid] = [int(out[sid, 0])]
                    self._tracer.on_defer(sched.slots[sid].request.uid,
                                          "draft_stall")
                    continue
                m = 0
                while m < len(p) and p[m] == int(out[sid, m]):
                    m += 1
                runs[sid] = [int(t) for t in out[sid, :m + 1]]
                draft_stats[sid] = (len(p), m)
                self._tracer.on_spec(sched.slots[sid].request.uid, len(p),
                                     m)
                proposed_total += len(p)
                accepted_total += m
            if proposed_total:
                spec_kw["spec_accept_rate"] = (accepted_total
                                               / proposed_total)
        else:
            with trace_span("serve/decode", recorder=self._recorder,
                            active=len(sids)):
                if self.paged:
                    # the table width is the batch's live-page bucket:
                    # the gather path's stripe scales with tokens in
                    # flight too
                    width = pick_bucket(
                        min(sched.max_live_pages(),
                            self.paged_spec.pages_per_seq),
                        self._decode_page_buckets)
                    host = {"toks": toks_a, "positions": poss_a,
                            "tables": sched.block_table_rows(self._rows,
                                                             width)}
                else:
                    width = self.max_len
                    host = {"toks": toks_a, "positions": poss_a}
                nxt = self._dispatch("decode", (width,), host, seeds_a,
                                     poss_a + 1, temps_a)
            if self._dispatch_trace is not None:
                self._dispatch_trace.record(self._steps, "decode")
            runs = {sid: [int(nxt[sid])] for sid in sids}
            if self.spec:
                # speculation on, the drafter had nothing anywhere: the
                # whole dispatch was a plain decode
                for sid in sids:
                    self._tracer.on_defer(sched.slots[sid].request.uid,
                                          "draft_stall")
        tok_ms = (time.perf_counter() - t_d) * 1e3
        finished.extend(sched.record_token_runs(runs, draft_stats))
        self._serve_secs += time.perf_counter() - t0
        tps = (sched.total_tokens / self._serve_secs
               if self._serve_secs > 0 else 0.0)
        paged_kw = {}
        if self.paged:
            hit = sched.admit_allocator       # holds the prefix cache
            seen = hit.prefix_hit_tokens + hit.prefix_miss_tokens
            paged_kw = dict(
                kv_pages_in_use=sched.allocator.pages_in_use,
                tokens_in_flight=sched.tokens_in_flight,
                prefix_hit_rate=(hit.prefix_hit_tokens / seen
                                 if seen else 0.0),
                decode_attn_path=(1.0 if self._decode_attn_path == "kernel"
                                  else 0.0),
                kv_pool_bytes_per_token=self._kv_bpt)
        slo_kw = {}
        tracer = self._tracer
        if tracer.enabled:
            tbts = tracer.drain_step_tbts()
            if tbts:
                slo_kw["tbt_ms"] = sum(tbts) / len(tbts)
                slo_kw["tbt_max_ms"] = max(tbts)
            att = tracer.slo_attainment
            if att is not None:
                slo_kw["slo_attainment"] = att
                slo_kw["goodput_tokens_per_s"] = (
                    tracer.good_tokens / self._serve_secs
                    if self._serve_secs > 0 else 0.0)
        self.monitor.write_serving_metrics(
            token_latency_ms=tok_ms, tokens_per_sec=tps,
            queue_depth=sched.queue_depth, batch_occupancy=occupancy,
            tokens=sched.total_tokens, flush=False,
            quant_logit_err=self.quant_logit_err, **paged_kw, **slo_kw,
            **spec_kw)
        return True

    def step(self) -> List[FinishedRequest]:
        """One serving iteration: admit waiting requests into free slots
        (bucketed prefill, first token released), then advance every
        in-flight sequence one decode (or speculative verify) dispatch.
        Disaggregated, the decode side runs first (handoff claims, then
        the decode or verify dispatch) and the prefill side after it, so
        no decode dispatch waits behind a prefill dispatch (pinned by
        the dispatch trace). Chunked prefill makes every step
        decode-first and slips at most one chunk dispatch between the
        decode and admission phases: claim? -> decode -> chunk ->
        prefill. Returns requests that finished this iteration."""
        finished: List[FinishedRequest] = []
        finished.extend(self.scheduler.drain_rejects())
        if self.disagg:
            self._claim_phase(finished)
            self._decode_phase(finished)
            self._chunk_phase(finished)
            self._prefill_phase(finished)
        elif self.chunked:
            self._decode_phase(finished)
            self._chunk_phase(finished)
            self._prefill_phase(finished)
        else:
            self._prefill_phase(finished)
            self._decode_phase(finished)
        self.monitor.flush()
        self._steps += 1
        if self._log is not None and self._state_event_every and \
                self._steps % self._state_event_every == 0:
            self._log.add_event("serve_state", step=self._steps,
                                **self.debug_state())
        return finished

    def run(self) -> List[FinishedRequest]:
        """Serve until queue and slots drain; returns everything that
        finished."""
        out: List[FinishedRequest] = list(self.scheduler.drain_rejects())
        while not self.scheduler.idle():
            out.extend(self.step())
        out.extend(self.scheduler.drain_rejects())
        return out

    def generate(self, prompts: Sequence[Sequence[int]],
                 max_new_tokens: Optional[int] = None,
                 temperature: Optional[float] = None,
                 seeds: Optional[Sequence[int]] = None,
                 eos_id: Optional[int] = "__cfg__") -> List[List[int]]:
        """Batch convenience API over submit/run: serve ``prompts`` and
        return the full sequences (prompt + generated tokens) in
        submission order. Per-request knobs default to the
        ``inference:{}`` config."""
        cfg = self.config
        if eos_id == "__cfg__":
            eos_id = cfg["eos_token_id"]
        reqs = [Request(
            prompt=p,
            max_new_tokens=(max_new_tokens if max_new_tokens is not None
                            else cfg["max_new_tokens"]),
            temperature=(temperature if temperature is not None
                         else cfg["temperature"]),
            seed=(seeds[i] if seeds is not None else i),
            eos_id=eos_id) for i, p in enumerate(prompts)]
        uids = [self.submit(r) for r in reqs]
        finished = {f.uid: f for f in self.run()}
        return [finished[u].prompt + finished[u].tokens for u in uids]

    def warmup(self) -> int:
        """Build the steady-state program set against scratch state (the
        null page, or the dense cache's scratch row): one prefill per
        (batch bucket, prompt bucket), one chunk per batch bucket with
        chunked prefill, one decode per decode table width (one dense
        decode), one verify per verify width with speculation and the
        two handoff programs over separate pools. Each program runs once
        eagerly and, on the card, is captured as a CUDA graph. Must run
        while no requests are in flight; returns the number of programs,
        as the JAX engine returns its compiles. After this,
        :attr:`steady_state_recompiles` staying 0 is the serving
        contract."""
        if not self.scheduler.idle():
            raise RuntimeError("warmup with requests in flight")
        plan = [("prefill", bb, sb) for bb, sb in warmup_plan(
            self.config["batch_buckets"], self.config["prompt_buckets"])]
        if self.chunked and self.paged:
            plan += [("chunk", bb, ct) for bb, ct in chunk_warmup_plan(
                self.config["batch_buckets"], self._chunk_tokens)]
        for name, bb, width in plan:
            host, seeds, temps = self._prefill_host(bb, width)
            self._dispatch(name, (bb, width), host, seeds,
                           np.ones((bb,), np.int32), temps)
        rows = self._rows
        zeros = np.zeros((rows,), np.int32)
        greedy = (np.zeros((rows,), np.int64), zeros,
                  np.zeros((rows,), np.float32))
        if not self.paged:
            # every row at position 0: the live rows are empty at warmup
            self._dispatch("decode", (self.max_len,),
                           {"toks": zeros, "positions": zeros}, *greedy)
        for w in self._decode_page_buckets:
            self._dispatch("decode", (w,),
                           {"toks": zeros, "positions": zeros,
                            "tables": np.zeros((rows, w), np.int32)},
                           *greedy)
        for v in self._verify_widths if self.paged else ():
            pps = self.paged_spec.pages_per_seq
            self._dispatch("verify", (v,),
                           {"toks": np.zeros((rows, v), np.int32),
                            "positions": zeros,
                            "tables": np.zeros((rows, pps), np.int32)},
                           np.zeros((rows * v,), np.int64),
                           np.zeros((rows * v,), np.int32),
                           np.zeros((rows * v,), np.float32))
        if self._separate_pools:
            # both handoff programs against the null page, so the first
            # claim builds nothing on the clock
            idx = np.zeros((self._handoff_width,), np.int32)
            self._run_handoff("handoff_export", idx)
            self._run_handoff("handoff_import", idx)
        programs = self.programs.mark_warm()
        if self._log is not None:
            self._log.add_event("serve_warmup", programs=programs,
                                batch_buckets=self.config["batch_buckets"],
                                prompt_buckets=self.config["prompt_buckets"],
                                paged=self.paged,
                                verify_widths=list(self._verify_widths),
                                disagg=self.disagg,
                                chunk_tokens=self._chunk_tokens,
                                cp_shards=self._cp_shards)
        return programs

    @property
    def steady_state_recompiles(self) -> int:
        """Programs first built since :meth:`warmup` (0 is the serving
        contract: no capture on the clock); -1 before warmup ran."""
        return self.programs.steady_state_recompiles

    @property
    def can_migrate(self) -> bool:
        """True once :meth:`warm_migration` built the migration programs
        (the router's capability probe)."""
        return self._mig_slab is not None

    def warm_migration(self) -> int:
        """Build the cross-replica live-migration programs:
        ``migrate_export`` gathers an in-flight request's live pages out
        of the decode pool into a slab, ``migrate_import`` scatters a
        slab into the pool in place. They are the handoff pair's bodies
        pointed at the decode pool, at the full table width
        (``pages_per_seq``: any in-flight request fits, the shape stays
        fixed), over one slab allocated here. Both run once against the
        null page (on the card: captured as CUDA graphs). Call after
        :meth:`warmup`; the warm set is re-anchored, so
        :attr:`steady_state_recompiles` stays 0 with migration armed.
        Returns the number of programs built."""
        if not self.paged:
            raise RuntimeError("live migration requires the paged KV pool "
                               "(inference.paged_kv.enabled)")
        if self.steady_state_recompiles < 0:
            raise RuntimeError("warm_migration() before warmup()")
        if self._mig_slab is not None:
            return 0
        self._mig_width = self.paged_spec.pages_per_seq
        self._mig_slab = tuple(
            torch.empty((c.shape[0], self._mig_width) + tuple(c.shape[2:]),
                        dtype=c.dtype, device=self.device)
            for c in self._cache)
        self.dispatches.update(migrate_export=0, migrate_import=0)
        self.dispatch_secs.update(migrate_export=0.0, migrate_import=0.0)
        before = len(self.programs)
        idx = np.zeros((self._mig_width,), np.int32)
        self._run_handoff("migrate_export", idx)
        self._run_handoff("migrate_import", idx)
        built = len(self.programs) - before
        self.programs.mark_warm()
        if self._log is not None:
            self._log.add_event("serve_warm_migration", programs=built,
                                width=self._mig_width)
        return built

    def set_speculation(self, on: bool) -> bool:
        """Toggle speculative decoding without touching the program set
        (the plain decode program is part of the warmed set, so turning
        drafting off builds nothing). Returns False, and does nothing, on
        an engine built without spec_decode."""
        if not self.spec:
            return False
        self.scheduler.spec_k = self._spec_k if on else 0
        return True

    def record_quant_logit_err(self, err: float) -> None:
        """Record an offline quantized-vs-fp max-logit-error probe (a
        test or bench computes it; the serving path never pays for an
        oracle). The next decode telemetry write carries it as
        ``Serve/quant_logit_err`` and :meth:`debug_state` mirrors it for
        ``tools/obs_report.py --serve``."""
        self.quant_logit_err = float(err)

    def debug_state(self) -> Dict[str, Any]:
        """Live introspection snapshot (pure host reads): page pool
        occupancy and prefix-cache accounting, the slot table, queue
        depth by prompt bucket, per-program dispatch counts, and the
        tracer's SLO/latency histograms — the JAX engine's
        ``serve_state`` layout; a program's "compiles" are the programs
        of its kind built (graphs captured, on the card), and
        ``program_set`` lists each program's dispatches and replays."""
        sched = self.scheduler
        slots = []
        for sid in sched.active_slots():
            s = sched.slots[sid]
            slots.append({"slot": sid, "uid": s.request.uid,
                          "position": s.position,
                          "generated": len(s.tokens),
                          "prefix_tokens": s.prefix_len,
                          "pages": len(s.pages)})
        programs = {n: {"dispatches": d,
                        "compiles": self.programs.count(n),
                        "seconds": round(self.dispatch_secs[n], 6)}
                    for n, d in sorted(self.dispatches.items())}
        pool = None
        if self.paged:
            pool = sched.allocator.debug_state()
            used_tokens = pool["pages_in_use"] * pool["page_size"]
            pool["tokens_in_flight"] = sched.tokens_in_flight
            pool["internal_fragmentation"] = round(
                1.0 - sched.tokens_in_flight / used_tokens, 4) \
                if used_tokens else 0.0
            pool["decode_attn_path"] = self._decode_attn_path
        wq, wd = quantized_tree_bytes(self.params)
        kv_spec = self.paged_spec if self.paged else self.cache_spec
        quant = {
            "weights_resident": self.weights_resident,
            "weight_bytes": wq,
            "weight_bytes_dense": wd,
            "kv_dtype": str(kv_spec.dtype).replace("torch.", ""),
            "kv_quant_block": (self.paged_spec.quant_block if self.paged
                               else 0),
            "kv_pool_bytes_per_token": round(self._kv_bpt, 3),
            "quant_logit_err": self.quant_logit_err,
        }
        state = {
            "family": self.family,
            "steps": self._steps,
            "quantization": quant,
            "queue_depth": sched.queue_depth,
            "queue_by_bucket": sched.queue_by_bucket(),
            "occupancy": round(sched.occupancy, 4),
            "slots": slots,
            "programs": programs,
            "program_set": self.programs.debug_state(),
            "steady_state_recompiles": self.steady_state_recompiles,
            "prefill_shapes": dict(self.prefill_shapes),
            "page_pool": pool,
            "slo": self._tracer.snapshot(),
            "weight_version": self._weight_version,
            "weight_ordinal": self._weight_ordinal,
        }
        if self.spec:
            state["spec_decode"] = {
                "k": self._spec_k,
                "verify_widths": list(self._verify_widths),
                "drafter": type(self._drafter).__name__,
            }
        if self.disagg:
            dff = self._dispatch_trace.decode_first_fraction()
            dg = {"separate_pools": self._separate_pools,
                  "queue": self._handoff_q.debug_state(),
                  "handoff": self._handoff_stats.snapshot(),
                  "decode_first_fraction": (round(dff, 4)
                                            if dff is not None else None)}
            if self._separate_pools:
                dg["prefill_pool"] = sched.admit_allocator.debug_state()
            state["disagg"] = dg
        if self.chunked:
            state["chunked_prefill"] = {
                "chunk_tokens": self._chunk_tokens,
                "dispatches": self._chunk_dispatches,
                "chunking_slots": len(sched.chunking_slots()),
                "cp_shards": self._cp_shards,
                "cp_threshold_tokens": self._cp_threshold,
                "cp_reason": self._cp_reason,
            }
        return state

    # ----------------------------------------- checkpoint -> serving
    @property
    def weight_version(self) -> str:
        """The tag served ("initial": the constructor's params)."""
        return self._weight_version

    @property
    def weight_ordinal(self) -> int:
        """Committed swaps (the ``Serve/weight_version`` scalar: 0 is the
        weights the engine started with)."""
        return self._weight_ordinal

    @classmethod
    def from_checkpoint(cls, load_dir: str, model_config,
                        tag: Optional[str] = None, inference_config=None,
                        dtype=torch.bfloat16, monitor: Optional[Any] = None,
                        quantize_weights=None, verify_integrity: bool = True,
                        observability_config=None, device=None,
                        draft_fn=None):
        """A serving engine from a committed training tag. Loads the
        ``model_states`` group only (never the optimizer state), into a
        template made on the ``meta`` device, so the weights are held
        once on the host; the constructor casts them to ``dtype``. With
        ``tag=None`` the newest committed and verified tag wins, corrupt
        or uncommitted ones skipped. ``quantize_weights`` (default: the
        config's ``inference.quantize_weights``; ``True`` is ``"bf16"``)
        ships the weights through the qwZ int8 block format
        (:func:`qwz_distribute_params`): ``"bf16"`` dequantizes them at
        once, ``"int8"`` keeps them int8-resident."""
        cfg = get_inference_config({"inference": dict(inference_config
                                                      or {})})
        chosen = _resolve_committed_tag(load_dir, tag, verify_integrity)
        init = _family_of(model_config)[3]
        template = init(model_config, None, device="meta")
        params = ckptlib.load_params_only(chosen, template)
        if quantize_weights is None:
            quantize_weights = cfg["quantize_weights"]
        elif quantize_weights is True:
            quantize_weights = "bf16"
        if quantize_weights:
            params = qwz_distribute_params(params, cfg["quantize_block"],
                                           resident=quantize_weights)
            # the engine's view follows what shipped (an explicit
            # argument overrides the config)
            inference_config = dict(inference_config or {},
                                    quantize_weights=quantize_weights)
            logger.info(f"from_checkpoint: params distributed via qwZ int8 "
                        f"(block {cfg['quantize_block']}, resident "
                        f"{quantize_weights})")
        engine = cls(model_config, params, inference_config, dtype=dtype,
                     monitor=monitor,
                     observability_config=observability_config,
                     device=device, draft_fn=draft_fn)
        engine._weight_version = os.path.basename(chosen)
        engine.scheduler.weight_version = engine._weight_version
        if engine._log is not None:
            engine._log.add_event("serve_load", checkpoint=chosen,
                                  quantize_weights=quantize_weights or False)
        logger.info(f"inference engine loaded params from {chosen}")
        return engine

    def swap_params(self, load_dir: str, tag: Optional[str] = None,
                    verify_integrity: bool = True) -> str:
        """Move the running engine to a committed tag's weights, between
        :meth:`step` calls. The tag loads against the live params as the
        template and is placed on the device before anything is
        assigned, so a failure (a bad tag, an I/O error, the
        ``serve.swap_load`` fault point) leaves the engine serving the
        old weights. An int8-resident engine loads the tag's floating
        weights against a dense template and requantizes them into the
        same layout. Once the load succeeded, the new weights are copied
        into the live parameter tensors in place (payload and scales of
        a quantized leaf): the program set's graphs hold those tensors'
        addresses. In-flight requests switch at their next dispatch;
        their KV prefix stays valid (same geometry). Returns the new
        version (the tag's name)."""
        t0 = time.perf_counter()
        try:
            chosen = _resolve_committed_tag(load_dir, tag, verify_integrity)
            version = os.path.basename(chosen)
            fault.fire("serve.swap_load", path=chosen, version=version)
            if is_quantized_tree(self.params):
                init = _family_of(self.model_config)[3]
                loaded = quantize_param_tree(ckptlib.load_params_only(
                    chosen, init(self.model_config, None, device="meta")),
                    self._weight_block)
            else:
                loaded = ckptlib.load_params_only(chosen, self.params)
            new_params = self._place_params(loaded)
            new_head = None if self._head_w is None else \
                tied_head_weight(new_params[self._head_leaf], self.dtype)
        except BaseException as e:
            if self._log is not None:
                self._log.add_event(
                    "fleet_swap", ok=False, tag=tag, load_dir=str(load_dir),
                    error=str(e) or type(e).__name__,
                    weight_version=self._weight_version,
                    weight_ordinal=self._weight_ordinal)
            logger.warning(f"swap_params: load failed ({e!r}); still "
                           f"serving weight_version={self._weight_version}")
            raise
        # commit, in place: every dispatch from here on (a graph replay
        # included) reads the new weights
        with torch.no_grad():
            _copy_into(self.params, new_params)
            if new_head is not None:
                self._head_w.copy_(new_head)
        del new_params, new_head
        self._weight_version = version
        self._weight_ordinal += 1
        self.scheduler.weight_version = version
        wall_ms = (time.perf_counter() - t0) * 1e3
        if self._log is not None:
            self._log.add_event(
                "fleet_swap", ok=True, checkpoint=chosen,
                weight_version=version, weight_ordinal=self._weight_ordinal,
                wall_ms=round(wall_ms, 3))
        self.monitor.write_serving_metrics(
            weight_version=self._weight_ordinal,
            tokens=self.scheduler.total_tokens)
        logger.info(f"swap_params: now serving {version} (ordinal "
                    f"{self._weight_ordinal}, {wall_ms:.1f} ms)")
        return version

    def close(self):
        # health first: untapping restores the raw mirror, so the
        # identity check below still finds the engine's own writer
        self.health.close()
        if self._log is not None:
            # seal the run with a final pool/SLO snapshot
            self._log.add_event("serve_state", step=self._steps,
                                **self.debug_state())
        if self._chrome_path and self._recorder is not None:
            self._recorder.dump(self._chrome_path)
        if getattr(self.monitor, "mirror", None) is self._log:
            self.monitor.mirror = None
        if self._log is not None:
            self._log.close()
            self._log = None
        self._tracer.writer = None


def _copy_into(live, new):
    """Copy the tree ``new`` into the tree ``live`` leaf by leaf, by key
    (a quantized leaf's payload and scales alike)."""
    if isinstance(live, dict):
        for k, v in live.items():
            _copy_into(v, new[k])
    elif isinstance(live, QuantizedParam):
        live.q.copy_(new.q)
        live.scale.copy_(new.scale)
    else:
        live.copy_(new)
