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
- **From a training tag.** :meth:`InferenceEngine.from_checkpoint` serves
  the ``model_states`` group of a committed tag (of either package), and
  :meth:`InferenceEngine.swap_params` moves a running engine to a newer
  tag, atomically or not at all; ``weight_version`` names the tag served.

Where the JAX engine donates the cache to each compiled program, the
port's programs update the pool tensors in place
(``models/gpt2.write_paged_kv_cache``). PyTorch runs eagerly, so there
is no compile tracker and no recompile count; :meth:`warmup` runs every
bucket shape once. Configurations outside this slice raise
``NotImplementedError`` naming the JAX feature.
"""

import functools
import os
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from deepspeed_tpu_torch.inference.buckets import (pad_prompts, pick_bucket,
                                                   warmup_plan)
from deepspeed_tpu_torch.inference.kv_cache import (PageAllocator,
                                                    init_paged_kv_cache,
                                                    paged_kv_bytes,
                                                    paged_spec_for,
                                                    pages_for)
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
from deepspeed_tpu_torch.profiling.spans import (ChromeTraceRecorder,
                                                 trace_span)
from deepspeed_tpu_torch.runtime.config import (get_inference_config,
                                                get_observability_config)
from deepspeed_tpu_torch.utils.logging import logger
from deepspeed_tpu_torch.utils.monitor import (TensorBoardMonitor,
                                               _JsonlWriter)

__all__ = ["InferenceEngine"]

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
    pk = cfg["paged_kv"]
    unported = [
        (not pk["enabled"], "inference.paged_kv.enabled: false (the dense "
         "slot x max_len KV cache)"),
        (bool(cfg["mesh"]["axes"]), "inference.mesh (tensor-parallel "
         "serving over a device mesh)"),
        (cfg["spec_decode"]["enabled"], "inference.spec_decode "
         "(speculative decoding)"),
        (cfg["disagg"]["enabled"], "inference.disagg (disaggregated "
         "prefill/decode)"),
        (cfg["chunked_prefill"]["enabled"], "inference.chunked_prefill"),
        (bool(cfg["quantize_weights"]), "inference.quantize_weights (qwZ "
         "int8 weights)"),
    ]
    for hit, what in unported:
        if hit:
            raise NotImplementedError(
                f"{what} is a feature of the JAX engine that the port does "
                f"not serve yet")


class InferenceEngine:
    """Paged bucketed prefill/decode serving of a GPT-2 or Llama model
    over a continuous-batching scheduler. ``device`` defaults to CUDA (and
    raises without a card); pass ``device="cpu"`` to run the kernels'
    plain versions on the CPU."""

    def __init__(self, model_config, params, inference_config=None,
                 dtype=torch.bfloat16, monitor: Optional[Any] = None,
                 observability_config=None, device=None):
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
        self.params = self._place_params(params)
        self._head_w = tied_head_weight(self.params[head_leaf], dtype)
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
        self._steps = 0
        self._serve_secs = 0.0
        self._state_event_every = 64       # serve_state cadence (steps)
        # per-program dispatch counts and wall seconds (host clock around
        # work that ends in a device->host copy of the sampled tokens)
        self.dispatches = {"prefill": 0, "decode": 0}
        self.dispatch_secs = {"prefill": 0.0, "decode": 0.0}
        # served prefill batches by "<batch bucket>x<prompt bucket>"
        self.prefill_shapes: Dict[str, int] = {}

        # ------------------------------------------------- KV cache
        pk = cfg["paged_kv"]
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
        # static pool cost per token of capacity, scales included
        self._kv_bpt = cache_bytes / float(num_pages * ps)
        allocator = PageAllocator(num_pages, ps,
                                  prefix_cache=pk["prefix_cache"])
        self._decode_attn_path = _ATTN_PATHS[pk["attn_kernel"]]
        pps = self.paged_spec.pages_per_seq
        self._decode_page_buckets = tuple(
            int(b) for b in pk["decode_page_buckets"] if b < pps) + (pps,)
        self.scheduler = Scheduler(self.num_slots, cfg["prompt_buckets"],
                                   cfg["batch_buckets"], max_len,
                                   allocator=allocator,
                                   lookahead=cfg["admit_lookahead"],
                                   tracer=self._tracer)
        self._weight_version = "initial"
        self._weight_ordinal = 0
        self.scheduler.weight_version = self._weight_version

        logger.info(
            f"inference decode attention: {self._decode_attn_path} "
            f"(configured {pk['attn_kernel']!r}; page walk widths "
            f"{list(self._decode_page_buckets)})")
        if self._log is not None:
            self._log.add_event(
                "decode_attn_path", path=self._decode_attn_path,
                reason="configured", requested=pk["attn_kernel"],
                decode_page_buckets=list(self._decode_page_buckets))
        logger.info(
            f"inference engine: {self.family} on {self.device}, "
            f"{self.num_slots} slots, max_len {max_len}, prompt buckets "
            f"{cfg['prompt_buckets']}, batch buckets {cfg['batch_buckets']}, "
            f"paged KV cache: {num_pages} pages x {ps} tokens "
            f"({cache_bytes / 2**20:.1f} MiB, {kv_dtype}"
            f"{' + fp32 scales' if self.paged_spec.quantized else ''}), "
            f"prefix cache "
            f"{'on' if pk['prefix_cache'] else 'off'}")

    def _place_params(self, params) -> Dict[str, Any]:
        """Params on the engine's device. The block matmul weights and
        biases are cast to the engine dtype once, here: the JAX model
        casts the same fp32 values at every use, so the operands are
        identical. Embeddings, an untied ``lm_head`` and the norm
        parameters stay as given, since the JAX model reads them in
        fp32. Blocks come as one ``h_{i}`` per block or stacked under
        ``h``."""
        def place(tree, cast):
            if isinstance(tree, dict):
                return {k: place(v, cast) for k, v in tree.items()}
            t = torch.as_tensor(tree)
            return t.to(self.device, dtype=self.dtype) if cast else \
                t.to(self.device)
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

    def _prefill_paged_impl(self, ids, lengths, positions, tables, seeds,
                            temps) -> np.ndarray:
        """One bucketed paged prefill: run each row's un-prefixed prompt
        suffix (``ids``, true lengths ``lengths``) through the cached
        forward from its ``positions`` offset (tokens covered by shared
        prefix pages), scattering K/V into the pool through ``tables``
        (pad rows carry all-null tables, so their writes land in the
        null page). Samples each row's first token from its last true
        prompt position; the LM head runs on those rows only."""
        dev = self.device
        ids_t = torch.as_tensor(ids, device=dev)
        pos_t = torch.as_tensor(positions, device=dev)
        x = self._trunk(
            self.params, self.model_config, ids_t, self._cache, pos_t,
            self.dtype, torch.as_tensor(tables, device=dev),
            self._decode_attn_path)
        last = x[torch.arange(len(lengths), device=dev),
                 torch.as_tensor(lengths - 1, device=dev)]
        logits = _tied_logits(last, self._head_w, self.dtype)
        return self._sample_tokens(logits, seeds, positions + lengths, temps)

    def _decode_paged_impl(self, toks, positions, tables, seeds,
                           temps) -> np.ndarray:
        """One paged decode step over the full slot table: each slot's
        pending token scatters into its page at its own position, then
        attention runs off the pool — the paged-decode kernel walks only
        each row's live pages (or the gather path assembles the stripe).
        Inactive rows carry all-null tables: their output is discarded."""
        dev = self.device
        x = self._trunk(
            self.params, self.model_config,
            torch.as_tensor(toks, device=dev)[:, None], self._cache,
            torch.as_tensor(positions, device=dev), self.dtype,
            torch.as_tensor(tables, device=dev), self._decode_attn_path)
        logits = _tied_logits(x[:, 0], self._head_w, self.dtype)
        return self._sample_tokens(logits, seeds, positions + 1, temps)

    # ----------------------------------------------------------- serving
    def submit(self, request: Request) -> int:
        """Queue one request; returns its uid (FIFO with bounded-lookahead
        admission)."""
        return self.scheduler.submit(request)

    def _dispatch(self, name: str, fn, *args) -> np.ndarray:
        t0 = time.perf_counter()
        out = fn(*args)          # ends in a device->host copy
        self.dispatch_secs[name] += time.perf_counter() - t0
        self.dispatches[name] += 1
        return out

    def _run_prefill(self, batch) -> np.ndarray:
        bb = batch.batch_bucket
        shape = f"{bb}x{batch.prompt_bucket}"
        self.prefill_shapes[shape] = self.prefill_shapes.get(shape, 0) + 1
        seeds = np.zeros((bb,), np.int64)
        temps = np.zeros((bb,), np.float32)
        for i, req in enumerate(batch.requests):
            seeds[i] = req.seed
            temps[i] = req.temperature
        suffixes = [r.prompt[pl:] for r, pl in
                    zip(batch.requests, batch.prefix_lens)]
        ids, lengths = pad_prompts(suffixes, batch.prompt_bucket, bb)
        positions = np.zeros((bb,), np.int32)
        tables = np.zeros((bb, self.paged_spec.pages_per_seq), np.int32)
        for i, (pl, pages) in enumerate(zip(batch.prefix_lens,
                                            batch.page_tables)):
            positions[i] = pl
            tables[i, :len(pages)] = pages
        with trace_span("serve/prefill", recorder=self._recorder,
                        batch=bb, prompt=batch.prompt_bucket):
            return self._dispatch("prefill", self._prefill_paged_impl, ids,
                                  lengths, positions, tables, seeds, temps)

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

    def _prefill_phase(self, finished: List[FinishedRequest]) -> None:
        """Admission + bucketed prefill dispatches; each first token is
        released to its request at once."""
        sched = self.scheduler
        t0 = time.perf_counter()
        for batch in sched.admit():
            t_p = time.perf_counter()
            first = self._run_prefill(batch)
            prefill_ms = (time.perf_counter() - t_p) * 1e3
            for sid, req in zip(batch.slot_ids, batch.requests):
                self._tracer.on_prefill(
                    req.uid, sid, prefill_ms, batch.prompt_bucket,
                    batch.batch_bucket, len(batch.requests))
            finished.extend(sched.record_tokens(
                {sid: int(first[i])
                 for i, sid in enumerate(batch.slot_ids)}))
            self._drain_request_metrics()
        self._serve_secs += time.perf_counter() - t0

    def _decode_phase(self, finished: List[FinishedRequest]) -> bool:
        """Advance every in-flight sequence one token with a plain decode
        dispatch. Returns whether anything dispatched."""
        sched = self.scheduler
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
        t_d = time.perf_counter()
        with trace_span("serve/decode", recorder=self._recorder,
                        active=len(sids)):
            # the table width is the batch's live-page bucket: the gather
            # path's stripe scales with tokens in flight too
            width = pick_bucket(
                min(sched.max_live_pages(), self.paged_spec.pages_per_seq),
                self._decode_page_buckets)
            tables = sched.block_table_rows(self._rows, width)
            nxt = self._dispatch("decode", self._decode_paged_impl, toks_a,
                                 poss_a, tables, seeds_a, temps_a)
        runs = {sid: [int(nxt[sid])] for sid in sids}
        tok_ms = (time.perf_counter() - t_d) * 1e3
        finished.extend(sched.record_token_runs(runs, None))
        self._serve_secs += time.perf_counter() - t0
        tps = (sched.total_tokens / self._serve_secs
               if self._serve_secs > 0 else 0.0)
        alloc = sched.allocator
        seen = alloc.prefix_hit_tokens + alloc.prefix_miss_tokens
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
            kv_pages_in_use=alloc.pages_in_use,
            tokens_in_flight=sched.tokens_in_flight,
            prefix_hit_rate=(alloc.prefix_hit_tokens / seen
                             if seen else 0.0),
            decode_attn_path=(1.0 if self._decode_attn_path == "kernel"
                              else 0.0),
            kv_pool_bytes_per_token=self._kv_bpt,
            quant_logit_err=self.quant_logit_err, **slo_kw)
        return True

    def step(self) -> List[FinishedRequest]:
        """One serving iteration: admit waiting requests into free slots
        (bucketed prefill, first token released), then advance every
        in-flight sequence one decode dispatch. Returns requests that
        finished this iteration."""
        finished: List[FinishedRequest] = []
        finished.extend(self.scheduler.drain_rejects())
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
        """Run every steady-state shape once against scratch state (the
        null page): one prefill per (batch bucket, prompt bucket) pair
        and one decode per decode table-width bucket. Builds the kernels
        and warms the device allocator before the first request. Must
        run while no requests are in flight; returns the number of
        shapes run."""
        if not self.scheduler.idle():
            raise RuntimeError("warmup with requests in flight")
        shapes = 0
        pps = self.paged_spec.pages_per_seq
        for bb, sb in warmup_plan(self.config["batch_buckets"],
                                  self.config["prompt_buckets"]):
            self._dispatch("prefill", self._prefill_paged_impl,
                           np.zeros((bb, sb), np.int32),
                           np.ones((bb,), np.int32),
                           np.zeros((bb,), np.int32),
                           np.zeros((bb, pps), np.int32),
                           np.zeros((bb,), np.int64),
                           np.zeros((bb,), np.float32))
            shapes += 1
        rows = self._rows
        for w in self._decode_page_buckets:
            self._dispatch("decode", self._decode_paged_impl,
                           np.zeros((rows,), np.int32),
                           np.zeros((rows,), np.int32),
                           np.zeros((rows, w), np.int32),
                           np.zeros((rows,), np.int64),
                           np.zeros((rows,), np.float32))
            shapes += 1
        if self._log is not None:
            self._log.add_event("serve_warmup", programs=shapes,
                                batch_buckets=self.config["batch_buckets"],
                                prompt_buckets=self.config["prompt_buckets"],
                                paged=True)
        return shapes

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
        ``serve_state`` layout, less its compile counts."""
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
                        "seconds": round(self.dispatch_secs[n], 6)}
                    for n, d in sorted(self.dispatches.items())}
        pool = sched.allocator.debug_state()
        used_tokens = pool["pages_in_use"] * pool["page_size"]
        pool["tokens_in_flight"] = sched.tokens_in_flight
        pool["internal_fragmentation"] = round(
            1.0 - sched.tokens_in_flight / used_tokens, 4) \
            if used_tokens else 0.0
        pool["decode_attn_path"] = self._decode_attn_path
        wbytes = sum(t.numel() * t.element_size()
                     for sub in self.params.values()
                     for t in _tensors(sub))
        quant = {
            "weights_resident": "off",
            "weight_bytes": wbytes,
            "weight_bytes_dense": wbytes,
            "kv_dtype": str(self.paged_spec.dtype).replace("torch.", ""),
            "kv_quant_block": self.paged_spec.quant_block,
            "kv_pool_bytes_per_token": round(self._kv_bpt, 3),
            "quant_logit_err": self.quant_logit_err,
        }
        return {
            "family": self.family,
            "steps": self._steps,
            "quantization": quant,
            "queue_depth": sched.queue_depth,
            "queue_by_bucket": sched.queue_by_bucket(),
            "occupancy": round(sched.occupancy, 4),
            "slots": slots,
            "programs": programs,
            "prefill_shapes": dict(self.prefill_shapes),
            "page_pool": pool,
            "slo": self._tracer.snapshot(),
            "weight_version": self._weight_version,
            "weight_ordinal": self._weight_ordinal,
        }

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
                        observability_config=None, device=None):
        """A serving engine from a committed training tag. Loads the
        ``model_states`` group only (never the optimizer state), into a
        template made on the ``meta`` device, so the weights are held
        once on the host; the constructor casts them to ``dtype``. With
        ``tag=None`` the newest committed and verified tag wins, corrupt
        or uncommitted ones skipped."""
        if quantize_weights:    # the rest of the config: the constructor
            _refuse_unported(get_inference_config({"inference": dict(
                inference_config or {}, quantize_weights=quantize_weights)}))
        chosen = _resolve_committed_tag(load_dir, tag, verify_integrity)
        init = _family_of(model_config)[3]
        template = init(model_config, None, device="meta")
        params = ckptlib.load_params_only(chosen, template)
        engine = cls(model_config, params, inference_config, dtype=dtype,
                     monitor=monitor,
                     observability_config=observability_config,
                     device=device)
        engine._weight_version = os.path.basename(chosen)
        engine.scheduler.weight_version = engine._weight_version
        if engine._log is not None:
            engine._log.add_event("serve_load", checkpoint=chosen,
                                  quantize_weights=False)
        logger.info(f"inference engine loaded params from {chosen}")
        return engine

    def swap_params(self, load_dir: str, tag: Optional[str] = None,
                    verify_integrity: bool = True) -> str:
        """Move the running engine to a committed tag's weights, between
        :meth:`step` calls. The tag loads against the live params as the
        template and is placed on the device before anything is
        assigned, so a failure (a bad tag, an I/O error, the
        ``serve.swap_load`` fault point) leaves the engine serving the
        old weights. In-flight requests switch at their next dispatch;
        their KV prefix stays valid (same geometry). Returns the new
        version (the tag's name)."""
        t0 = time.perf_counter()
        try:
            chosen = _resolve_committed_tag(load_dir, tag, verify_integrity)
            version = os.path.basename(chosen)
            fault.fire("serve.swap_load", path=chosen, version=version)
            new_params = self._place_params(
                ckptlib.load_params_only(chosen, self.params))
            new_head = tied_head_weight(new_params[self._head_leaf],
                                        self.dtype)
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
        # commit: every dispatch from here on sees the new weights
        self.params, self._head_w = new_params, new_head
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


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    else:
        yield tree
