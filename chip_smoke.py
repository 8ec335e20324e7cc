#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (deepspeed_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing JSON objects one per line (any failure raises and
exits non-zero; with no CUDA device it exits 2 before printing a result):

1. device: the card as nvidia-smi names it, torch/CUDA versions; then
   every kernel of the port is built with nvcc from csrc/ for sm_90a.
2. kernels: each kernel against its plain PyTorch version on the card
   (serving shapes, GQA, fp32, cache-position edges with an all-null
   row, NaN planted past the live pages), and the kernel, plain version
   and one-library-call yardstick timed at the serving shapes (median of
   CUDA-event-timed calls, L2 flushed before each) beside the bound.
3. serving: GPT-2 345M at full width (random weights from seed 0), bf16,
   default inference config: warmup, then 16 greedy requests of 64 new
   tokens with prompts of 20-250 tokens, 8 sharing one 64-token prefix.
   Checks every output and that the paged-decode kernel ran once per
   layer per decode dispatch.
   Then a torch.profiler window over 8 decode steps: device busy and
   idle share per step, and the kernels that take the time.
4. kernel path against plain path through the model: an fp32 engine of
   the same model, one decode step from one prefilled state with the
   kernel and with the plain gather attention; logits compared.
5. the {"kernels": [...]} line, the nvidia-smi line, and last
   {"ok": true, "device": {...}}.
"""

import json
import subprocess
import sys
import time

import numpy as np

SEED = 0
NEW_TOKENS = 64
SHARED_PREFIX = 64
BF16_ATOL = 2e-3     # summation order differs; p is rounded to bf16
FP32_ATOL = 1e-5     # summation order differs
MODEL_LOGIT_ATOL = 1e-3   # fp32, 24 layers of differently ordered sums
TIMED_CALLS = 100
# by card (NVIDIA data sheets): device-memory bytes/s, dense bf16 FLOP/s
CARD_PEAKS = (("H200", 4.8e12, 989e12), ("H100 NVL", 3.9e12, 835e12),
              ("H100 PCIe", 2.0e12, 756e12), ("H100", 3.35e12, 989e12))


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def card_peaks(name: str):
    """(bytes/s, bf16 FLOP/s) of the card nvidia-smi named."""
    for key, bytes_per_s, flops in CARD_PEAKS:
        if key in name:
            return bytes_per_s, flops
    raise RuntimeError(f"no peak rates on record for {name!r}")


# ------------------------------------------------------------- kernels
def pool_case(rng, batch, kv_heads, group, hd, page_size, pages_per_seq,
              positions, null_rows=(), poison=True):
    """Numpy inputs of one paged-decode call: distinct non-null pages per
    row, NaN in every page past a row's live count."""
    num_pages = batch * pages_per_seq + 1
    kpool = rng.randn(num_pages, kv_heads, page_size, hd).astype(np.float32)
    vpool = rng.randn(num_pages, kv_heads, page_size, hd).astype(np.float32)
    q = rng.randn(batch, kv_heads * group, hd).astype(np.float32)
    tables = 1 + rng.permutation(num_pages - 1)[:batch * pages_per_seq]
    tables = tables.reshape(batch, pages_per_seq).astype(np.int32)
    pos = np.asarray(positions, np.int32)
    for b in range(batch):
        if poison and b not in null_rows:
            dead = tables[b, pos[b] // page_size + 1:]
            kpool[dead] = np.nan
            vpool[dead] = np.nan
    for b in null_rows:
        tables[b] = 0
    return q, kpool, vpool, tables, pos


def to_device(case, dtype):
    import torch
    q, kpool, vpool, tables, pos = case
    return (torch.from_numpy(q).to("cuda", dtype),
            torch.from_numpy(kpool).to("cuda", dtype),
            torch.from_numpy(vpool).to("cuda", dtype),
            torch.from_numpy(tables).cuda(), torch.from_numpy(pos).cuda())


def check_kernel(name, args, atol, null_rows=()):
    import torch
    from deepspeed_tpu_torch.ops.attention.paged import (
        paged_decode_attention, paged_decode_plain)
    out = paged_decode_attention(*args)
    torch.cuda.synchronize()
    ref = paged_decode_plain(*args)
    err = float((out.float() - ref.float()).abs().max())
    finite = bool(torch.isfinite(out).all())
    nulls_zero = all(bool((out[b] == 0).all()) for b in null_rows)
    emit({"phase": "kernel_check", "case": name,
          "dtype": str(args[0].dtype), "shape_q": list(args[0].shape),
          "shape_pool": list(args[1].shape), "max_abs_err": err,
          "atol": atol, "finite": finite, "null_rows_zero": nulls_zero})
    if not (finite and nulls_zero and err <= atol):
        raise AssertionError(f"paged decode kernel disagrees on {name}: "
                             f"err {err} (atol {atol}), finite {finite}, "
                             f"null rows zero {nulls_zero}")
    return err


def time_ms(fn, calls, flush):
    """Median ms of ``calls`` CUDA-event-timed calls after warmup, the L2
    cache flushed before each."""
    import torch
    for _ in range(3):
        fn()
    times = []
    for _ in range(calls):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def kernel_phase(smi):
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.attention.paged import (
        paged_decode_attention, paged_decode_plain)
    rng = np.random.RandomState(SEED)
    # the serving shapes: 8 slots + the scratch row (all-null), GPT-2
    # 345M heads, page 16, 64-page tables (max_seq_len 1024)
    B, KH, G, hd, ps, P = 9, 16, 1, 64, 16, 64
    pos = list(rng.randint(0, P * ps, size=B - 1)) + [0]
    serving = to_device(pool_case(rng, B, KH, G, hd, ps, P, pos,
                                  null_rows=(B - 1,)), torch.bfloat16)
    err = check_kernel("serving_shapes_bf16", serving, BF16_ATOL,
                       null_rows=(B - 1,))
    edges = [0, ps - 1, ps, ps + 1, P * ps - 1, 0]
    check_kernel("cache_position_edges_bf16",
                 to_device(pool_case(rng, 6, KH, G, hd, ps, P, edges,
                                     null_rows=(5,)), torch.bfloat16),
                 BF16_ATOL, null_rows=(5,))
    check_kernel("gqa_kh2_g4_hd128_bf16",
                 to_device(pool_case(rng, 5, 2, 4, 128, ps, 8,
                                     [3, 16, 40, 127, 64]), torch.bfloat16),
                 BF16_ATOL)
    check_kernel("fp32_page128",
                 to_device(pool_case(rng, 4, 4, 2, 64, 128, 4,
                                     [0, 127, 128, 511], null_rows=(3,)),
                           torch.float32), FP32_ATOL, null_rows=(3,))

    # timing at the serving shapes; the pool's K/V would sit in the 50 MB
    # L2 across back-to-back calls, which a decode step (23 other layers
    # between two reads of one layer's pool) never sees: flush it
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    kernel_ms = time_ms(lambda: paged_decode_attention(*serving),
                        TIMED_CALLS, flush)
    plain_ms = time_ms(lambda: paged_decode_plain(*serving), 50, flush)
    q, kpool, vpool, tables, positions = serving
    # yardstick: one SDPA call over pre-gathered contiguous stripes
    L = P * ps
    kc = kpool[tables.long()].transpose(1, 2).reshape(B, KH, L, hd)
    vc = vpool[tables.long()].transpose(1, 2).reshape(B, KH, L, hd)
    kc = torch.nan_to_num(kc).contiguous()
    vc = torch.nan_to_num(vc).contiguous()
    mask = (torch.arange(L, device="cuda")[None, :]
            <= positions.long()[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    library_ms = time_ms(
        lambda: F.scaled_dot_product_attention(q4, kc, vc, attn_mask=mask),
        TIMED_CALLS, flush)
    live = [int(p) for p, t in zip(positions.tolist(), tables.tolist())
            if t[0] != 0]
    # what the kernel must move: K and V of each live row's positions
    # 0..pos (rows past pos are never loaded), the table entries of the
    # pages it walks, q in, the output out, and the positions
    walked = sum(min(int(p) // ps + 1, P) for p in positions.tolist())
    kv_bytes = sum((p + 1) * KH * hd * 2 * 2 for p in live)
    other = 2 * q.numel() * 2 + walked * 4 + positions.numel() * 4
    # q.K and P.V: 2 * hd multiply-adds per visible token per query head
    flops = sum(4 * (p + 1) * KH * G * hd for p in live)
    bytes_per_s, flops_per_s = card_peaks(smi)
    bytes_ms = (kv_bytes + other) / bytes_per_s * 1e3
    ops_ms = flops / flops_per_s * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    row = {"phase": "kernel_timing", "kernel": "paged_decode",
           "shape": {"B": B, "H": KH * G, "KH": KH, "hd": hd,
                     "page_size": ps, "P": P, "dtype": "bf16"},
           "positions": [int(p) for p in positions.tolist()],
           "bytes": kv_bytes + other, "flops": flops, "kernel_ms": kernel_ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "bytes_bound_ms": bytes_ms, "ops_bound_ms": ops_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "achieved_gb_per_s": (kv_bytes + other) / kernel_ms / 1e6,
           "nvidia_smi": smi}
    emit(row)
    return {"max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


# ------------------------------------------------------------- serving
def make_prompts(vocab):
    """16 prompts of 20-250 tokens; 8 share one 64-token prefix. The
    lengths are chosen so that admission groups them into batches of
    both prompt buckets and of both batch buckets (serving_phase checks
    that every bucket was served)."""
    rng = np.random.RandomState(SEED)
    prefix = rng.randint(0, vocab, size=SHARED_PREFIX).tolist()
    lengths = [20, 250, 33, 90, 47, 110, 61, 130,
               76, 150, 170, 190, 205, 220, 235, 240]
    shared = {3, 5, 7, 8, 10, 12, 14, 15}
    prompts = []
    for i, n in enumerate(lengths):
        if i in shared:
            prompts.append(prefix + rng.randint(
                0, vocab, size=n - SHARED_PREFIX).tolist())
        else:
            prompts.append(rng.randint(0, vocab, size=n).tolist())
    return prompts


def serve(engine, prompts, new_tokens):
    """Warm up, serve ``prompts`` greedily until idle; return the finished
    requests by submission order and the main path's counts."""
    from deepspeed_tpu_torch.inference import Request
    from deepspeed_tpu_torch.ops.attention.paged import \
        paged_decode_attention
    engine.warmup()
    decode0 = engine.dispatches["decode"]
    secs0 = dict(engine.dispatch_secs)
    uids = [engine.submit(Request(prompt=p, max_new_tokens=new_tokens,
                                  temperature=0.0, seed=i))
            for i, p in enumerate(prompts)]
    paged_decode_attention.launches = 0
    t0 = time.perf_counter()
    done = {f.uid: f for f in engine.run()}
    wall = time.perf_counter() - t0
    counts = {"launches": paged_decode_attention.launches,
              "decode_dispatches": engine.dispatches["decode"] - decode0,
              "decode_secs": engine.dispatch_secs["decode"] - secs0["decode"],
              "prefill_secs": (engine.dispatch_secs["prefill"]
                               - secs0["prefill"]),
              "wall_secs": wall}
    return [done[u] for u in uids], counts


def serving_phase(model_config, params, device, smi):
    import torch
    from deepspeed_tpu_torch import InferenceEngine
    on_cuda = torch.device(device).type == "cuda"
    if on_cuda:
        torch.cuda.reset_peak_memory_stats()
    engine = InferenceEngine(model_config, params, {},
                             dtype=torch.bfloat16, device=device)
    prompts = make_prompts(model_config.vocab_size)
    finished, counts = serve(engine, prompts, NEW_TOKENS)
    for p, f in zip(prompts, finished):
        if f.finish_reason != "length" or len(f.tokens) != NEW_TOKENS or \
                len(f.prompt + f.tokens) != len(p) + NEW_TOKENS:
            raise AssertionError(f"request {f.uid}: {f.finish_reason}, "
                                 f"{len(f.tokens)} tokens")
        if not all(0 <= t < model_config.vocab_size for t in f.tokens):
            raise AssertionError(f"request {f.uid}: token outside vocab")
    layers = model_config.num_layers
    if counts["launches"] <= 0 or \
            counts["launches"] != counts["decode_dispatches"] * layers:
        raise AssertionError(
            f"paged decode kernel launches {counts['launches']} != decode "
            f"dispatches {counts['decode_dispatches']} x {layers} layers")
    state = engine.debug_state()
    shapes = state["prefill_shapes"]
    buckets = {s.split("x")[i] for s in shapes for i in (0, 1)}
    want = {str(b) for b in engine.config["batch_buckets"]
            + engine.config["prompt_buckets"]}
    if not want <= buckets:
        raise AssertionError(f"served prefill shapes {shapes} miss a "
                             f"bucket of {sorted(want)}")
    hits = state["page_pool"]["prefix_cache"]["hit_requests"]
    if hits < 1:
        raise AssertionError("the shared prefix never hit the prefix cache")
    ttft = [f.ttft_ms for f in finished]
    decode_tokens = sum(len(f.tokens) - 1 for f in finished)
    emit({"phase": "serving_tokens",
          "tokens": [f.tokens for f in finished]})
    row = {"phase": "serving", "model": "gpt2-345m", "dtype": "bf16",
           "requests": len(finished), "new_tokens": NEW_TOKENS,
           "prompt_lengths": [len(p) for p in prompts],
           "prefill_shapes": shapes, "prefix_hit_requests": hits,
           "decode_tokens": decode_tokens,
           "decode_tokens_per_s": decode_tokens / counts["decode_secs"],
           "ttft_ms_p50": float(np.percentile(ttft, 50)),
           "ttft_ms_p95": float(np.percentile(ttft, 95)),
           "decode_step_ms_mean": (counts["decode_secs"] * 1e3
                                   / counts["decode_dispatches"]),
           "prefill_secs": counts["prefill_secs"],
           "wall_secs": counts["wall_secs"],
           "decode_dispatches": counts["decode_dispatches"],
           "kernel_launches": counts["launches"], "nvidia_smi": smi}
    if on_cuda:
        row["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    emit(row)
    return counts["launches"], prompts, engine


def profile_phase(engine, prompts, steps=8):
    """Where a decode step's time goes, with 8 requests in flight: the
    wall time of ``steps`` decode-only steps (host clock, synchronised),
    then a torch.profiler window over ``steps`` more for the kernels'
    own device time (one stream, so kernels do not overlap; user
    annotation ranges are left out). The device idle share is what the
    kernels leave of the unprofiled wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from deepspeed_tpu_torch.inference import Request
    for i, p in enumerate(prompts[:8]):
        engine.submit(Request(prompt=p, max_new_tokens=2 * steps + 4,
                              seed=i))
    engine.step()                       # prefill + one decode
    engine.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        engine.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
    engine.run()                        # drain what is left
    kernels = [(e.key, e.self_device_time_total / 1e3 / steps,
                e.count / steps)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and e.self_device_time_total > 0]
    kernels.sort(key=lambda k: -k[1])
    busy_ms = sum(k[1] for k in kernels)
    emit({"phase": "decode_profile", "steps": steps, "rows": 8,
          "wall_ms_per_step": wall_ms,
          "device_busy_ms_per_step": busy_ms,
          "device_idle_share": 1 - busy_ms / wall_ms,
          "paged_decode_ms_per_step": sum(
              k[1] for k in kernels if "paged_decode" in k[0]),
          "kernel_launches_per_step": sum(k[2] for k in kernels),
          "top_kernels": [{"name": k[0][:80], "ms_per_step": k[1],
                           "calls_per_step": k[2]} for k in kernels[:10]]})


def model_path_phase(model_config, params, device, prompts):
    """One decode step from one prefilled state, kernel against plain
    gather attention, through the whole fp32 model."""
    import torch
    from deepspeed_tpu_torch import InferenceEngine
    from deepspeed_tpu_torch.inference import Request
    from deepspeed_tpu_torch.models.gpt2 import gpt2_forward
    engine = InferenceEngine(model_config, params, {}, dtype=torch.float32,
                             device=device)
    for i, p in enumerate(prompts[:8]):
        engine.submit(Request(prompt=p, max_new_tokens=NEW_TOKENS, seed=i))
    engine.step()                       # prefill + one decode
    sched = engine.scheduler
    sids, toks, poss, _, _ = sched.decode_state()
    rows = engine.num_slots + 1
    tok_a = np.zeros((rows, 1), np.int32)
    pos_a = np.zeros((rows,), np.int32)
    tok_a[sids, 0] = toks
    pos_a[sids] = poss
    tables = sched.block_table_rows(rows, engine.paged_spec.pages_per_seq)
    dev = engine.device
    logits = {}
    for path in ("kernel", "gather"):
        cache = tuple(c.clone() for c in engine._cache)
        out, _ = gpt2_forward(
            engine.params, model_config, torch.as_tensor(tok_a, device=dev),
            dtype=torch.float32, kv_cache=cache,
            cache_position=torch.as_tensor(pos_a, device=dev),
            block_tables=torch.as_tensor(tables, device=dev),
            paged_attn_kernel=path)
        logits[path] = out[sids, 0]
    err = float((logits["kernel"] - logits["gather"]).abs().max())
    match = float((logits["kernel"].argmax(-1)
                   == logits["gather"].argmax(-1)).float().mean())
    emit({"phase": "model_kernel_vs_plain", "dtype": "fp32",
          "rows": len(sids), "max_abs_logit_err": err,
          "atol": MODEL_LOGIT_ATOL, "argmax_match_share": match})
    if not err <= MODEL_LOGIT_ATOL:
        raise AssertionError(f"kernel path logits differ from the plain "
                             f"path by {err} (atol {MODEL_LOGIT_ATOL})")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    from deepspeed_tpu_torch.models.gpt2 import GPT2_MEDIUM, init_gpt2_params
    from deepspeed_tpu_torch.ops import _build

    # fp32 matmuls in full fp32 (no TF32), for the fp32 comparisons
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "name": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    t0 = time.perf_counter()
    built = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": sorted(built),
          "ptxas": {n: [ln.strip() for ln in log.splitlines()
                        if "registers" in ln or "spill" in ln]
                    for n, log in _build.build_logs.items()}})

    timing = kernel_phase(smi)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = init_gpt2_params(GPT2_MEDIUM, gen)
    launches, prompts, engine = serving_phase(GPT2_MEDIUM, params, "cuda",
                                              smi)
    profile_phase(engine, prompts)
    del engine
    model_path_phase(GPT2_MEDIUM, params, "cuda", prompts)

    emit({"kernels": [dict(
        name="paged_decode", route="cuda",
        source="deepspeed_tpu_torch/csrc/paged_decode.cu",
        replaces="deepspeed_tpu/ops/attention/paged.py:217",
        launches=launches, max_abs_err=timing["max_abs_err"],
        ms=timing["ms"], kernel_ms=timing["ms"],
        plain_ms=timing["plain_ms"], bound_ms=timing["bound_ms"],
        bound_by=timing["bound_by"], library_ms=timing["library_ms"])]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
