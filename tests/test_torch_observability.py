"""The port's training telemetry (deepspeed_tpu_torch/profiling: the
Observer, its FLOP/MFU and memory probes; the monitor's training
writers; the engine's flush barriers) against the JAX package on the
CPU.

The acceptance run: the tiny Llama of tests/test_torch_llama_training.py
(``LLAMA_TINY`` at seq 32) trains 3 steps in both packages under
``examples/llama/ds_config_zero2.json`` in fp32, with
``observability.enabled`` and ``steps_per_print`` 1 (a flush barrier
every step). The two event logs hold:

- the same scalar tags and event kinds, less the port's pinned
  differences: no ``compile`` / ``compile_summary`` events and no
  ``Observability/recompiles``, ``compile_ms_total`` or ``dispatches``
  scalars (eager PyTorch compiles nothing), no
  ``Observability/bytes_accessed`` (XLA's byte count has no torch
  counterpart);
- the same x-axis (cumulative samples) on every tag; the losses at fp32
  (rtol 1e-5) and the lrs (rtol 1e-6: JAX's schedule runs in fp32, the
  port's in float64);
- ``Observability/flops_per_step`` within FLOPS_RTOL of JAX's
  ``cost_analysis`` count. Measured at this size: the port counts
  116,015,104 and JAX 117,680,760 (0.986). The port counts the matmuls
  FlopCounterMode sees plus the attention kernels' walked cells; XLA
  also counts elementwise work (norms, softmax, SiLU, the cross
  entropy) and counts the interpret-mode attention kernels its own way.

The probes alone: FlopCounterMode's count of a matmul, the kernel
wrappers' walked-cell counts (dropping that addition leaves no count),
the peak registry, ``compute_mfu``, the CPU memory fallback, the timer's
memory stats and the monitor's training writers.
"""

import importlib.util
import json
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_threads  # noqa: F401  (torch threads per xdist worker)
from tests.test_torch_llama_training import (LLAMA_TINY, _ids, _jax_tree,
                                             _np_tree, _zero2_config)

REPO = pathlib.Path(__file__).resolve().parents[1]
STEPS = 3
FLOPS_RTOL = 0.05
PINNED_TAGS = {"Observability/recompiles", "Observability/compile_ms_total",
               "Observability/dispatches", "Observability/bytes_accessed"}
PINNED_EVENTS = {"compile", "compile_summary"}


def _load_obs_report():
    spec = importlib.util.spec_from_file_location(
        "obs_report", REPO / "tools" / "obs_report.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _events(path):
    rows = [json.loads(line) for line in open(path)]
    tags = {}
    for r in rows:
        if "tag" in r:
            tags.setdefault(r["tag"], []).append((r["step"], r["value"]))
    return rows, tags


def _observed(d):
    return {"steps_per_print": 1,
            "observability": {"enabled": True, "events_dir": str(d),
                              "chrome_trace_path": str(d / "trace.json")}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' 3-step observed runs; the port's engine is left
    open for the close() test."""
    import deepspeed_tpu
    from deepspeed_tpu.models.llama import LlamaConfig as JConfig
    from deepspeed_tpu.models.llama import llama_loss_fn as jloss

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import LlamaConfig, llama_loss_fn
    jd, td = tmp_path_factory.mktemp("jax"), tmp_path_factory.mktemp("port")
    tree = _jax_tree()
    micros = _ids(4, STEPS)
    jeng, *_ = deepspeed_tpu.initialize(
        model=jloss(JConfig(**LLAMA_TINY), dtype=jnp.float32),
        model_parameters=tree,
        config=_zero2_config(mesh={"axes": {"data": 1}}, **_observed(jd)))
    teng, *_ = deepspeed_tpu_torch.initialize(
        model=llama_loss_fn(LlamaConfig(**LLAMA_TINY), dtype=torch.float32),
        model_parameters=_np_tree(tree), config=_zero2_config(**_observed(td)),
        device="cpu")
    assert teng.observability.enabled
    ji, ti = iter(micros), iter(micros)
    for _ in range(STEPS):
        jeng.train_batch(ji)
        teng.train_batch(ti)
    jeng.observability.close()
    return {"jax": _events(jd / "events.jsonl"), "port_dir": td,
            "port": _events(td / "events.jsonl"), "engine": teng}


def test_tags_and_event_kinds_match_jax(runs):
    (jrows, jtags), (trows, ttags) = runs["jax"], runs["port"]
    assert set(ttags) == set(jtags) - PINNED_TAGS
    jkinds = {r["event"] for r in jrows if "event" in r}
    tkinds = {r["event"] for r in trows if "event" in r}
    assert tkinds == jkinds - PINNED_EVENTS


def test_pinned_differences_are_never_written(runs):
    """No compile rows and no byte count, not even as zeros."""
    trows, ttags = runs["port"]
    assert not PINNED_TAGS & set(ttags)
    assert not PINNED_EVENTS & {r.get("event") for r in trows}
    (prof,) = [r for r in trows if r.get("event") == "flops_profile"]
    assert "bytes_accessed" not in prof and prof["uncounted"] == []
    assert set(prof["kernel_flops"]) == {
        "masked_flash_fwd", "masked_flash_dq", "masked_flash_dkv"}


def test_samples_axis_loss_and_lr_match_jax(runs):
    (_, jtags), (_, ttags) = runs["jax"], runs["port"]
    micro = _zero2_config()["train_micro_batch_size_per_gpu"]
    samples = [micro * i for i in range(1, STEPS + 1)]
    for tag, rows in ttags.items():
        if tag != "Observability/flops_per_step":
            assert [s for s, _ in rows] == [s for s, _ in jtags[tag]], tag
    assert [s for s, _ in ttags["Train/Samples/train_loss"]] == samples
    for tag, rtol in (("Train/Samples/train_loss", 1e-5),
                      ("Train/Samples/lr", 1e-6),
                      ("Train/Samples/loss_scale", 0)):
        np.testing.assert_allclose([v for _, v in ttags[tag]],
                                   [v for _, v in jtags[tag]], rtol=rtol)


def test_flops_per_step_matches_cost_analysis(runs):
    (_, jtags), (_, ttags) = runs["jax"], runs["port"]
    (js, jf), = jtags["Observability/flops_per_step"]
    (ts, tf), = ttags["Observability/flops_per_step"]
    assert ts == js and tf > 0
    assert abs(tf / jf - 1.0) <= FLOPS_RTOL, (tf, jf)
    mfus = [v for _, v in ttags["Observability/mfu"]]
    assert len(mfus) == STEPS and all(v > 0 for v in mfus)


def test_memory_watermarks_and_chrome_trace(runs):
    _, ttags = runs["port"]
    peaks = [v for _, v in ttags["Memory/peak_bytes_in_use"]]
    assert len(peaks) == STEPS and all(v > 0 for v in peaks)
    assert peaks == sorted(peaks)
    assert len(ttags["Memory/step_delta_bytes"]) == STEPS
    trace = json.load(open(runs["port_dir"] / "trace.json"))
    names = {e["name"] for e in trace["traceEvents"]}
    assert {"train_batch", "data", "forward", "backward", "step"} <= names


def test_obs_report_summarizes_and_renders_the_port_log(runs):
    obs_report = _load_obs_report()
    s = obs_report.summarize(str(runs["port_dir"]))
    assert s["steps"] == STEPS
    assert s["step_time_ms"]["p50"] > 0
    assert s["samples_per_sec"]["last"] > 0
    assert s["mfu"]["best"] > 0 and s["flops_per_step"] > 0
    assert s["bytes_accessed"] is None
    assert s["recompiles"]["count"] == 0
    assert s["memory"]["peak_bytes_in_use"] > 0
    assert s["loss"]["first"] == runs["port"][1][
        "Train/Samples/train_loss"][0][1]
    text = obs_report.render(s)
    for needle in ("step_time_ms", "mfu", "memory", "samples_per_sec"):
        assert needle in text


def test_close_is_idempotent(runs):
    """close() flushes and seals the log once; a second close() and a
    later last_loss() write nothing more."""
    eng = runs["engine"]
    path = runs["port_dir"] / "events.jsonl"
    eng.close()
    size = os.path.getsize(path)
    eng.close()
    eng.observability.close()
    assert eng.last_loss() is not None
    assert os.path.getsize(path) == size
    assert eng.monitor.mirror is None


def test_tensorboard_enabled_run_writes_the_train_scalars(tmp_path):
    """``tensorboard.enabled`` builds in both packages and trains; the
    port's writer gets the JAX engine's training scalars at the same
    samples."""
    import deepspeed_tpu
    from deepspeed_tpu.models.llama import LlamaConfig as JConfig
    from deepspeed_tpu.models.llama import llama_loss_fn as jloss

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import LlamaConfig, llama_loss_fn
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig

    def tb(d):
        return {"steps_per_print": 1, "tensorboard": {
            "enabled": True, "output_path": str(d), "job_name": "llama"}}

    assert DeepSpeedConfig(_zero2_config(**tb(tmp_path))).tensorboard_enabled
    written = {}

    class Recorder:
        def __init__(self, name):
            self.name = name

        def add_scalar(self, tag, value, step):
            written.setdefault(self.name, []).append((tag, step, value))

        def flush(self):
            pass

        def close(self):
            pass

    tree = _jax_tree()
    micros = _ids(4, 2)
    jeng, *_ = deepspeed_tpu.initialize(
        model=jloss(JConfig(**LLAMA_TINY), dtype=jnp.float32),
        model_parameters=tree,
        config=_zero2_config(mesh={"axes": {"data": 1}},
                             **tb(tmp_path / "j")))
    teng, *_ = deepspeed_tpu_torch.initialize(
        model=llama_loss_fn(LlamaConfig(**LLAMA_TINY), dtype=torch.float32),
        model_parameters=_np_tree(tree),
        config=_zero2_config(**tb(tmp_path / "t")), device="cpu")
    assert teng.monitor.enabled and teng.summary_writer is not None
    assert not teng.observability.enabled
    jeng.monitor.writer = Recorder("jax")
    teng.monitor.writer = Recorder("port")
    ji, ti = iter(micros), iter(micros)
    for _ in range(2):
        jeng.train_batch(ji)
        teng.train_batch(ti)
    key = sorted({(t, s) for t, s, _ in written["port"]})
    assert key == sorted({(t, s) for t, s, _ in written["jax"]})
    assert {t for t, _ in key} == {
        "Train/Samples/train_loss", "Train/Samples/lr",
        "Train/Samples/loss_scale", "Train/Samples/step_time_ms",
        "Train/Samples/samples_per_sec"}
    assert os.listdir(tmp_path / "t" / "llama")


def test_flush_barrier_averages_the_window(tmp_path, monkeypatch):
    """With steps_per_print 4 the barrier at step 4 writes 4 step times:
    the first step's own (it builds and counts, and is synchronised at
    its end), the window's rest divided evenly over the other three;
    together they are the window's wall time.

    The first step's synchronisation stalls the engine's clock by
    STALL_MS, so the first step is the longest by construction, whatever
    the load on the host does to the others' real times; the wall-time
    check holds on the real part of the window."""
    import time
    import types

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import LlamaConfig, llama_loss_fn
    from deepspeed_tpu_torch.runtime import engine as engine_mod
    STALL_MS = 600e3
    stalled = [0.0]
    clock = types.SimpleNamespace(
        perf_counter=lambda: time.perf_counter() + stalled[0],
        time=time.time)
    monkeypatch.setattr(engine_mod, "time", clock)
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=llama_loss_fn(LlamaConfig(**LLAMA_TINY), dtype=torch.float32),
        model_parameters=_np_tree(_jax_tree()),
        config=_zero2_config(**dict(_observed(tmp_path),
                                    steps_per_print=4)),
        device="cpu")
    sync, syncs = eng._sync, []

    def stall_first_sync():
        if not syncs:
            stalled[0] += STALL_MS / 1e3
        syncs.append(1)
        sync()
    eng._sync = stall_first_sync
    it = iter(_ids(6, 4))
    t0 = clock.perf_counter()
    eng.train_batch(it)
    first_own_ms = eng._last_step_time_ms
    assert len(syncs) == 1          # the stall sits inside step 1's time
    for _ in range(3):
        eng.train_batch(it)
    wall_ms = (clock.perf_counter() - t0) * 1e3
    eng.close()
    _, tags = _events(tmp_path / "events.jsonl")
    rows = tags["Train/Samples/step_time_ms"]
    assert [s for s, _ in rows] == [2, 4, 6, 8]
    first, *rest = [v for _, v in rows]
    assert first == first_own_ms and first >= STALL_MS
    assert len(set(rest)) == 1 and 0 < rest[0] < first
    assert abs(first + sum(rest) - wall_ms) <= 0.05 * (wall_ms - STALL_MS)
    (mfu,) = tags["Observability/mfu"]
    flops = tags["Observability/flops_per_step"][0][1]
    assert mfu[1] == pytest.approx(flops / (rest[0] / 1e3) / 1e11)


def test_disabled_observability_writes_nothing(tmp_path):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import LlamaConfig, llama_loss_fn
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=llama_loss_fn(LlamaConfig(**LLAMA_TINY), dtype=torch.float32),
        model_parameters=_np_tree(_jax_tree()),
        config=_zero2_config(observability={
            "enabled": False, "events_dir": str(tmp_path / "obs")}),
        device="cpu")
    eng.train_batch(iter(_ids(1)))
    assert not eng.observability.enabled and not eng._monitor_ring
    assert not (tmp_path / "obs").exists()
    assert eng.observability.flops_profiles == {}


# ---------------------------------------------------------- the probes
def test_flop_counter_counts_one_matmul_as_2mnk():
    from deepspeed_tpu_torch.profiling.flops import profile_step
    m, k, n = 48, 32, 40
    a, b = torch.randn(m, k), torch.randn(k, n)
    out, prof = profile_step(lambda x, y: x @ y, (a, b), name="matmul",
                             device="cpu")
    assert out.shape == (m, n)
    assert prof.flops == 2 * m * n * k
    assert prof.kernel_flops == {} and prof.uncounted == ()


def _band_mask():
    from deepspeed_tpu_torch.ops.attention.masked_flash import BlockMask
    n = 8                                   # S 128 at block 16
    idx = np.arange(n)
    keep = (idx[:, None] < 1) | (idx[None, :] < 1) | \
        (np.abs(idx[:, None] - idx[None, :]) <= 1)
    mask = BlockMask.from_layout(keep[None].astype(np.int32), 16,
                                 walk_block=32)
    assert mask.has_band
    return mask


@pytest.mark.parametrize("route", ["causal", "band", "flash_causal",
                                   "gqa_causal"])
def test_kernel_wrappers_add_their_walked_cells(route, monkeypatch):
    """One forward and backward of attention through K1-K3 (or K5-K7)
    counts 9 products of length D per computed cell (K1 2, K2 3, K3 4):
    the causal cells, or the band's kept cells, never S x S. Dropping
    the wrappers' addition leaves nothing counted: the plain versions
    that run here are not counted twice."""
    from deepspeed_tpu_torch.ops.attention import flash as tf
    from deepspeed_tpu_torch.ops.attention import masked_flash as mf
    from deepspeed_tpu_torch.profiling.flops import profile_step
    B, H, S, D = 2, 4, 128, 16
    Hkv = 2 if route == "gqa_causal" else H
    g = torch.Generator().manual_seed(0)
    q = torch.randn(B, H, S, D, generator=g, requires_grad=True)
    k = torch.randn(B, Hkv, S, D, generator=g, requires_grad=True)
    v = torch.randn(B, Hkv, S, D, generator=g, requires_grad=True)
    if route == "band":
        mask = _band_mask()
        cells = int((mask.dense_additive() == 0).sum())

        def attend():
            return mf.masked_flash_attention(q, k, v, mask)
    else:
        cells = S * (S + 1) // 2
        kernel = "flash" if route == "flash_causal" else "masked"

        def attend():
            return tf.flash_attention(q, k, v, causal=True, kernel=kernel)

    def step():
        return torch.autograd.grad(attend().square().sum(), (q, k, v))

    _, prof = profile_step(step, device="cpu")
    per_dot = cells * B * H * 2 * D
    names = (("flash_fwd", "flash_dq", "flash_dkv")
             if route == "flash_causal" else
             ("masked_flash_fwd", "masked_flash_dq", "masked_flash_dkv"))
    assert prof.kernel_flops == {n: d * per_dot
                                 for n, d in zip(names, (2, 3, 4))}
    assert prof.flops == 9 * per_dot          # nothing else is a matmul
    assert prof.flops < 9 * S * S * B * H * 2 * D
    module = tf if route == "flash_causal" else mf
    monkeypatch.setattr(module, "walk_flops", lambda *a, **kw: 0)
    _, dropped = profile_step(step, device="cpu")
    assert dropped.flops == 0


def test_an_uncounted_kernel_leaves_no_total(tmp_path):
    """The block-sparse kernels cannot count their walks yet: a profile
    that reaches one names it and has no total, and the Observer then
    writes no FLOPs scalar."""
    from deepspeed_tpu_torch.ops.sparse_attention import (banded,
                                                          blocksparse,
                                                          blocksparse_v2)
    from deepspeed_tpu_torch.profiling import Observer
    from deepspeed_tpu_torch.profiling.flops import (counted_flops,
                                                     profile_step,
                                                     uncounted)
    for w in (blocksparse_v2.blocksparse_v2_fwd, banded.banded_dkv,
              blocksparse.bs_dq):
        assert hasattr(w, "__wrapped__")

    @counted_flops("sparse_kernel", uncounted)
    def kernel(x):
        return x @ x

    x = torch.ones(8, 8)
    _, prof = profile_step(lambda: kernel(x) @ x, device="cpu")
    assert prof.uncounted == ("sparse_kernel",) and prof.flops == 0

    written = []

    class Monitor:
        mirror = None

        def write_scalar(self, tag, value, step):
            written.append(tag)

    obs = Observer({"enabled": True, "events_dir": str(tmp_path)},
                   monitor=Monitor())
    obs._pending_profile = prof
    obs.record_flops(8)
    obs.close()
    assert written == [] and obs.mfu(10.0) is None
    rows, tags = _events(tmp_path / "events.jsonl")
    assert not tags
    (row,) = [r for r in rows if r.get("event") == "flops_profile"]
    assert row["uncounted"] == ["sparse_kernel"]


def test_peak_registry():
    from deepspeed_tpu_torch.profiling.flops import (CPU_FALLBACK_PEAK_FLOPS,
                                                     peak_flops_per_device)
    assert peak_flops_per_device(kind="NVIDIA H100 80GB HBM3") == \
        (989e12, "NVIDIA H100 80GB HBM3")
    assert peak_flops_per_device(kind="NVIDIA H100 PCIe")[0] == 989e12
    peak, label = peak_flops_per_device(torch.device("cpu"))
    assert peak == CPU_FALLBACK_PEAK_FLOPS == 1e11
    assert label == "cpu+nominal-peak"
    assert peak_flops_per_device(kind="NVIDIA A100")[1].endswith(
        "+nominal-peak")


def test_compute_mfu():
    from deepspeed_tpu_torch.profiling.flops import compute_mfu
    assert compute_mfu(1e12, 1.0, 2e12) == pytest.approx(0.5)
    assert compute_mfu(1e12, 0.0, 2e12) == 0.0
    assert compute_mfu(1e12, 1.0, 0.0) == 0.0


def test_memory_snapshot_cpu_host_fallback():
    from deepspeed_tpu_torch.profiling.memory import (MemoryWatermark,
                                                      memory_snapshot)
    snap = memory_snapshot(torch.device("cpu"))
    assert snap is not None and snap["source"] == "host"
    assert snap["bytes_in_use"] > 0 and snap["peak_bytes_in_use"] > 0
    wm = MemoryWatermark(torch.device("cpu"))
    s1 = wm.sample("forward")
    s2 = wm.sample("step")
    assert s1["delta_bytes"] == 0 and isinstance(s2["delta_bytes"], int)
    assert wm.peak_bytes >= max(s1["bytes_in_use"], s2["bytes_in_use"])
    assert wm.last is s2 and s2["phase"] == "step"


def test_timer_memory_stats_and_usage():
    from deepspeed_tpu_torch.utils.timer import SynchronizedWallClockTimer
    stats = SynchronizedWallClockTimer.memory_stats()
    assert stats["source"] == "host" and stats["bytes_in_use"] > 0
    text = SynchronizedWallClockTimer.memory_usage()
    assert text.startswith("mem in_use=") and text.endswith("(host)")


def test_monitor_training_writers_match_jax(tmp_path):
    """write_train_metrics and write_timer_values write the JAX
    monitor's rows into the mirror."""
    from deepspeed_tpu.utils.monitor import TensorBoardMonitor as JMonitor
    from deepspeed_tpu.utils.monitor import _JsonlWriter as JWriter

    from deepspeed_tpu_torch.utils.monitor import (TensorBoardMonitor,
                                                   _JsonlWriter)
    out = {}
    for name, mon, writer in (("jax", JMonitor, JWriter),
                              ("port", TensorBoardMonitor, _JsonlWriter)):
        m = mon(enabled=False)
        m.mirror = writer(str(tmp_path / name))
        m.write_train_metrics(loss=2.5, lr=1e-4, loss_scale=1.0, samples=8)
        m.write_train_metrics(loss=2.25, samples=16, flush=False)
        m.write_timer_values({"step_time_ms": 12.5, "forward": 3.0},
                             samples=16)
        m.mirror.close()
        out[name] = [json.loads(line) for line in
                     open(tmp_path / name / "events.jsonl")]
    assert out["port"] == out["jax"] and len(out["port"]) == 6
