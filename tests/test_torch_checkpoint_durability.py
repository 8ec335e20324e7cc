"""The port's checkpoint protocol on its own (deepspeed_tpu_torch:
``runtime/checkpoint.py``, ``runtime/fault.py``, the engine's
``save_checkpoint``/``load_checkpoint``, the verify CLI, the checkpoint
telemetry) and the trace window, on the CPU.

The cases are the JAX package's own (tests/unit/test_fault_injection.py
and tests/unit/test_checkpointing.py's one-device cases) run against the
port's engine: a save killed at each fault point, a flipped bit, a torn
or missing file, must leave a resume that falls back to the newest
committed and verified tag, never to torn bytes. The model is their tiny
linear stack (hidden 16, 2 layers, MSE), written in torch.

Within one process the same steps on the same state are bitwise equal, so
a resumed trajectory is held to the straight run's exactly.
"""

import json
import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import tests.torch_threads  # noqa: F401  (torch threads per xdist worker)

import deepspeed_tpu_torch
from deepspeed_tpu_torch.runtime import checkpoint as ckpt
from deepspeed_tpu_torch.runtime import fault
from deepspeed_tpu_torch.utils.tree import tree_leaves

HIDDEN = 16
BATCH = 16


@pytest.fixture(autouse=True)
def _reset_injector():
    fault.reset()
    yield
    fault.reset()


def _params(seed, layers=2):
    rng = np.random.RandomState(seed)
    return {f"layer_{i}": {
        "w": (rng.randn(HIDDEN, HIDDEN) / np.sqrt(HIDDEN)).astype(
            np.float32),
        "b": np.zeros((HIDDEN,), np.float32)} for i in range(layers)}


def _loss(params, batch):
    x = batch["x"]
    n = len(params)
    for i in range(n):
        x = x @ params[f"layer_{i}"]["w"] + params[f"layer_{i}"]["b"]
        if i < n - 1:
            x = torch.relu(x)
    return torch.mean((x - batch["y"]) ** 2)


def _dropout_loss(params, batch, seed):
    """The linear stack with an input dropout drawn from the step's
    seed: the trajectory depends on the engine's generator."""
    g = torch.Generator().manual_seed(int(seed) & 0x7FFFFFFF)
    keep = (torch.rand(batch["x"].shape, generator=g) > 0.25).float()
    return _loss(params, dict(batch, x=batch["x"] * keep / 0.75))


def _config(**extra):
    return dict({"train_micro_batch_size_per_gpu": BATCH,
                 "gradient_accumulation_steps": 1,
                 "steps_per_print": 1000,
                 "optimizer": {"type": "Adam", "params": {"lr": 1e-2}}},
                **extra)


def _engine(config=None, seed=0, loss=_loss, engine_seed=0):
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=loss, model_parameters=_params(seed),
        config=config or _config(), device="cpu", seed=engine_seed)
    return engine


def _batches(n, seed=0):
    rng = np.random.RandomState(seed)
    w_true = (np.random.RandomState(1234).randn(HIDDEN, HIDDEN) /
              np.sqrt(HIDDEN)).astype(np.float32)
    out = []
    for _ in range(n):
        x = rng.randn(BATCH, HIDDEN).astype(np.float32)
        out.append({"x": x, "y": x @ w_true})
    return out


def _train(engine, n, seed=0):
    it = iter(_batches(n * engine.gradient_accumulation_steps, seed))
    return [float(engine.train_batch(it)) for _ in range(n)]


def _leaves(engine):
    st = engine.opt_state
    return [t.detach().clone() for tree in
            (engine.params, st.exp_avg, st.exp_avg_sq)
            for t in tree_leaves(tree)]


def _assert_same_state(a, b):
    assert a.global_steps == b.global_steps
    assert a.opt_state.step == b.opt_state.step
    for x, y in zip(_leaves(a), _leaves(b)):
        assert torch.equal(x, y)


def _save_step2_then_crash(tmp_path, point, **arm_kw):
    """Commit a tag at step 2, then kill the save at step 4 at
    ``point``. Returns the engine that crashed."""
    e = _engine(seed=1)
    _train(e, 2, seed=2)
    e.save_checkpoint(str(tmp_path))
    _train(e, 2, seed=3)
    fault.arm(point, exc=fault.InjectedCrash(point), **arm_kw)
    with pytest.raises(fault.InjectedCrash):
        e.save_checkpoint(str(tmp_path))
    fault.reset()
    return e


def _assert_resumes_at(tmp_path, step):
    e2 = _engine(seed=9)
    path, _ = e2.load_checkpoint(str(tmp_path))
    assert path is not None, "the fallback found no loadable checkpoint"
    assert e2.global_steps == step
    assert all(np.isfinite(_train(e2, 1, seed=11)))
    return e2, path


def _model_shard_only(**ctx):
    return ctx.get("name") == "model_states"


# point, arm keywords, the staging dir's state, the step resumed
CRASHES = {
    "snapshot": ("ckpt.snapshot", {}, None, 2),
    "after_model_shard": ("ckpt.after_shard",
                          {"filter": _model_shard_only}, "meta absent", 2),
    "after_optim_shard": ("ckpt.after_shard",
                          {"filter": lambda **c: c.get("name") ==
                           "optim_states"}, "meta absent", 2),
    "before_marker": ("ckpt.before_marker", {}, "no marker", 2),
    "before_rename": ("ckpt.before_rename", {}, "marker", 2),
    "latest_tmp_written": ("ckpt.latest_tmp_written", {}, None, 4),
}


@pytest.mark.parametrize("case", sorted(CRASHES))
def test_crash_at_each_fault_point_falls_back(tmp_path, case):
    """A save killed at each point of the stage/commit protocol leaves
    the staging dir (never a tag) and ``latest`` untorn; resume takes
    the newest committed tag: step 2, or step 4 when the kill came after
    the rename (the save committed but did not repoint ``latest``)."""
    point, kw, staged, step = CRASHES[case]
    _save_step2_then_crash(tmp_path, point, **kw)
    staging = tmp_path / "global_step4.tmp"
    if staged is None:
        assert not staging.exists()
    else:
        assert (staging / "model_states.shard_0.npz").is_file()
        assert (staging / "meta.json").is_file() == (staged != "meta absent")
        assert (staging / ckpt.COMMIT_MARKER).is_file() == \
            (staged == "marker")
        assert not (tmp_path / "global_step4").exists()
    assert ckpt.read_latest(str(tmp_path)) == "global_step2"
    _, path = _assert_resumes_at(tmp_path, step)
    assert path.endswith(f"global_step{step}")


def _flip(path):
    fault.flip_byte(path)


def _truncate(path):
    fault.truncate_file(path)


def _remove(path):
    os.remove(path)


@pytest.mark.parametrize("damage,fn,problem", [
    (_flip, "model_states.shard_0.npz", "CRC32"),
    (_truncate, "model_states.shard_0.npz", "size"),
    (_remove, "optim_states.shard_0.npz", "missing"),
    (_flip, "meta.json", "CRC32"),
], ids=["bitflip", "truncated", "missing_fragment", "bitflip_meta"])
def test_damaged_newest_tag_falls_back(tmp_path, damage, fn, problem):
    """A flipped bit, a torn file or a lost fragment in the newest tag
    fails verification, writes a fallback row and resumes from the tag
    before, with its exact state."""
    e = _engine(seed=1)
    _train(e, 2, seed=2)
    e.save_checkpoint(str(tmp_path))
    ref = _leaves(e)
    _train(e, 2, seed=3)
    e.save_checkpoint(str(tmp_path))
    damage(str(tmp_path / "global_step4" / fn))
    ok, problems = ckpt.verify_checkpoint_dir(str(tmp_path / "global_step4"))
    assert not ok and any(problem in p for p in problems)
    e2, path = _assert_resumes_at(tmp_path, 2)
    assert path.endswith("global_step2")
    e3 = _engine(seed=9)
    e3.load_checkpoint(str(tmp_path))
    for x, y in zip(_leaves(e3), ref):
        assert torch.equal(x, y)


def test_torn_empty_latest_pointer_recovers(tmp_path):
    e = _engine(seed=1)
    _train(e, 2)
    e.save_checkpoint(str(tmp_path))
    with open(str(tmp_path / "latest"), "w") as f:
        f.write("  \n")
    assert ckpt.read_latest(str(tmp_path)) is None
    _assert_resumes_at(tmp_path, 2)


def test_explicit_tag_integrity_failure_raises(tmp_path):
    """An explicit tag that fails verification raises, and the engine is
    left as it was."""
    e = _engine(seed=1)
    _train(e, 2)
    e.save_checkpoint(str(tmp_path))
    fault.flip_byte(str(tmp_path / "global_step2" /
                        "model_states.shard_0.npz"))
    e2 = _engine(seed=9)
    before = _leaves(e2)
    with pytest.raises(RuntimeError, match="integrity"):
        e2.load_checkpoint(str(tmp_path), tag="global_step2")
    assert e2.global_steps == 0
    for x, y in zip(_leaves(e2), before):
        assert torch.equal(x, y)


def test_transient_oserror_on_write_is_retried(tmp_path):
    e = _engine(seed=1)
    _train(e, 2, seed=2)
    fault.arm("io_write", exc=OSError("simulated transient flake"),
              times=2)
    d = e.save_checkpoint(str(tmp_path))
    assert fault.get_injector().fired("io_write") == 2
    assert os.path.isfile(os.path.join(d, ckpt.COMMIT_MARKER))
    _assert_resumes_at(tmp_path, 2)


@pytest.mark.parametrize("exc,retries,calls", [
    (OSError("disk on fire"), 2, 3),
    (fault.InjectedCrash("preempted"), 5, 1),
    (ValueError("not io"), 5, 1),
], ids=["oserror_exhausts_retries", "injected_crash_never_retried",
        "other_errors_never_retried"])
def test_retry_io(exc, retries, calls):
    n = {"calls": 0}

    def fail():
        n["calls"] += 1
        raise exc
    with pytest.raises(type(exc)):
        fault.retry_io(fail, retries=retries, backoff=0,
                       sleep=lambda _: None)
    assert n["calls"] == calls


def test_resave_after_crash_reuses_tag_cleanly(tmp_path):
    e = _save_step2_then_crash(tmp_path, "ckpt.before_marker")
    d = e.save_checkpoint(str(tmp_path))
    assert d.endswith("global_step4")
    assert not os.path.isdir(d + ckpt.TMP_SUFFIX)
    ok, problems = ckpt.verify_checkpoint_dir(d)
    assert ok, problems
    e2, _ = _assert_resumes_at(tmp_path, 4)


def test_crash_between_tag_renames_keeps_old_copy_loadable(tmp_path):
    """Re-saving a tag renames the old copy aside first; dying between
    the two renames leaves ``<tag>.old``, which resume restores."""
    e = _engine(seed=1)
    _train(e, 2, seed=2)
    e.save_checkpoint(str(tmp_path))
    _train(e, 2, seed=3)
    e.save_checkpoint(str(tmp_path))
    os.rename(str(tmp_path / "global_step4"),
              str(tmp_path / "global_step4.old"))
    assert ckpt.candidate_tags(str(tmp_path))[0] == "global_step4.old"
    e2 = _engine(seed=9)
    path, _ = e2.load_checkpoint(str(tmp_path))
    assert path.endswith("global_step4.old") and e2.global_steps == 4


def test_custom_latest_tag_is_preferred(tmp_path):
    e = _engine(seed=1)
    _train(e, 2, seed=2)
    e.save_checkpoint(str(tmp_path))
    _train(e, 1, seed=3)
    e.save_checkpoint(str(tmp_path), tag="best")
    assert ckpt.candidate_tags(str(tmp_path))[0] == "best"
    e2 = _engine(seed=9)
    path, _ = e2.load_checkpoint(str(tmp_path))
    assert path.endswith("best") and e2.global_steps == 3


@pytest.mark.parametrize("named", [False, True],
                         ids=["gc", "named_tag_and_latest_survive"])
def test_keep_n_retention(tmp_path, named):
    """``checkpoint.keep_n`` deletes committed step tags past the newest
    n; an uncommitted dir, a custom-named tag and the tag ``latest``
    names survive."""
    e = _engine(_config(checkpoint={"keep_n": 2}))
    for _ in range(3):
        _train(e, 1)
        e.save_checkpoint(str(tmp_path))
    assert ckpt.list_tags(str(tmp_path)) == ["global_step3", "global_step2"]
    if not named:
        legacy = tmp_path / "global_step0"
        legacy.mkdir()
        ckpt.write_meta(str(legacy), {"global_step": 0})
        _train(e, 1)
        e.save_checkpoint(str(tmp_path))
        assert legacy.is_dir()
        assert not (tmp_path / "global_step2").exists()
        return
    _train(e, 1)
    d = e.save_checkpoint(str(tmp_path), tag="best")
    assert os.path.isdir(d)
    assert ckpt.read_latest(str(tmp_path)) == "best"
    assert "global_step1" not in ckpt.list_tags(str(tmp_path))
    e2 = _engine(_config(checkpoint={"keep_n": 2}))
    path, _ = e2.load_checkpoint(str(tmp_path))
    assert path.endswith("best") and e2.global_steps == 4


@pytest.mark.parametrize("extra", [
    {}, {"zero_optimization": {"stage": 2}},
    {"gradient_accumulation_steps": 2, "gradient_clipping": 0.5},
    {"optimizer": {"type": "Lamb", "params": {"lr": 1e-2}}},
], ids=["stage0", "stage2", "ga2_clip", "lamb"])
def test_roundtrip_resumes_bitwise(tmp_path, extra):
    """A new engine from another init loads the tag: the client state,
    every param and moment bitwise, and the next steps equal the straight
    run's bitwise."""
    cfg = _config(**extra)
    a = _engine(cfg, seed=1)
    _train(a, 3, seed=2)
    a.save_checkpoint(str(tmp_path), client_state={"note": "hi"})
    b = _engine(cfg, seed=99, engine_seed=5)
    path, client = b.load_checkpoint(str(tmp_path))
    assert path.endswith("global_step3") and client == {"note": "hi"}
    _assert_same_state(a, b)
    assert _train(a, 3, seed=5) == _train(b, 3, seed=5)
    _assert_same_state(a, b)


def test_lr_schedule_and_generator_restored(tmp_path):
    """WarmupLR's state and the engine's generator come back: with a
    seeded dropout in the loss, the resumed run is the straight run
    bitwise, while a run whose generator was not restored is not."""
    cfg = _config(scheduler={"type": "WarmupLR", "params": {
        "warmup_max_lr": 1e-2, "warmup_num_steps": 100}})
    a = _engine(cfg, seed=1, loss=_dropout_loss)
    _train(a, 4)
    a.save_checkpoint(str(tmp_path))
    b = _engine(cfg, seed=1, loss=_dropout_loss, engine_seed=3)
    b.load_checkpoint(str(tmp_path))
    assert b.get_lr() == a.get_lr()
    assert b.lr_scheduler.state_dict() == a.lr_scheduler.state_dict()
    assert torch.equal(b._generator.get_state(), a._generator.get_state())
    straight = _train(a, 2, seed=6)
    assert _train(b, 2, seed=6) == straight
    c = _engine(cfg, seed=1, loss=_dropout_loss, engine_seed=3)
    c.load_checkpoint(str(tmp_path))
    c._generator.manual_seed(3)
    assert _train(c, 2, seed=6) != straight


def test_jax_rng_words_seed_the_generator(tmp_path):
    """A tag without the port's generator state (a JAX tag) seeds the
    generator from meta's two key words."""
    e = _engine(seed=1)
    _train(e, 1)
    d = e.save_checkpoint(str(tmp_path))
    meta = ckpt.read_meta(d)
    words = meta["rng"]
    assert len(words) == 2 and all(0 <= w < 2**32 for w in words)
    del meta["torch_rng_state"]
    ckpt.write_meta(d, meta)
    ckpt.write_commit_marker(d)
    e2 = _engine(seed=1)
    assert e2.load_checkpoint(str(tmp_path))[0] == d
    want = torch.Generator().manual_seed((words[0] << 32) | words[1])
    assert torch.equal(e2._generator.get_state(), want.get_state())


def test_load_optimizer_states_false_starts_fresh_moments(tmp_path):
    a = _engine(seed=1)
    _train(a, 3)
    a.save_checkpoint(str(tmp_path))
    b = _engine(seed=7)
    _train(b, 1)
    b.load_checkpoint(str(tmp_path), load_optimizer_states=False)
    assert b.global_steps == 3 and b.opt_state.step == 0
    for x, y in zip(tree_leaves(b.params), tree_leaves(a.params)):
        assert torch.equal(x, y)
    for t in tree_leaves((b.opt_state.exp_avg, b.opt_state.exp_avg_sq)):
        assert not t.any()
    fresh = _engine(seed=1)
    fresh.load_checkpoint(str(tmp_path), load_optimizer_states=False)
    assert _train(b, 2, seed=4) == _train(fresh, 2, seed=4)


def test_latest_tag_and_explicit_tag(tmp_path):
    e = _engine()
    _train(e, 2)
    e.save_checkpoint(str(tmp_path))
    _train(e, 2)
    e.save_checkpoint(str(tmp_path))
    e2 = _engine()
    e2.load_checkpoint(str(tmp_path))
    assert e2.global_steps == 4
    e3 = _engine()
    e3.load_checkpoint(str(tmp_path), tag="global_step2")
    assert e3.global_steps == 2


def test_legacy_single_file_checkpoint_loads(tmp_path):
    from deepspeed_tpu_torch.runtime.engine import STATIC_LOSS_SCALE
    e1 = _engine(seed=1)
    _train(e1, 2)
    d = os.path.join(str(tmp_path), "global_step2")
    os.makedirs(d)
    ckpt.save_tree(os.path.join(d, "model_states.npz"), e1.params)
    ckpt.save_tree(os.path.join(d, "optim_states.npz"),
                   {"opt_state": e1.opt_state._replace(
                       step=np.int32(e1.opt_state.step)),
                    "loss_scale": STATIC_LOSS_SCALE})
    ckpt.write_meta(d, {"global_step": 2, "micro_step": 0,
                        "skipped_steps": 0, "rng": [0, 1],
                        "lr_scheduler": None, "dp_world_size": 1,
                        "zero_stage": 0, "client_state": {}})
    ckpt.write_latest(str(tmp_path), "global_step2")
    assert ckpt.state_groups(d)["model_states"] == "single-file"
    e2 = _engine(seed=9)
    path, _ = e2.load_checkpoint(str(tmp_path))
    assert path is not None
    _assert_same_state(e1, e2)


def test_missing_checkpoint_returns_none(tmp_path):
    assert _engine().load_checkpoint(str(tmp_path)) == (None, {})


def test_loss_scale_group_is_checked_on_load(tmp_path):
    """A tag whose loss-scale group is not the static scale of 1.0 (an
    fp16 run's) is refused before the engine changes."""
    from deepspeed_tpu_torch.runtime.engine import STATIC_LOSS_SCALE
    e = _engine(seed=1)
    _train(e, 1)
    d = e.save_checkpoint(str(tmp_path))
    ckpt.save_tree_sharded(d, "optim_states", {
        "opt_state": e.opt_state._replace(step=np.int32(1)),
        "loss_scale": STATIC_LOSS_SCALE._replace(
            scale=np.float32(2.0**16))})
    e2 = _engine(seed=9)
    with pytest.raises(ValueError, match="loss_scale"):
        e2.load_checkpoint(str(tmp_path), tag="global_step1",
                           verify_integrity=False)
    assert e2.global_steps == 0


def test_commit_marker_records_sizes_and_checksums(tmp_path):
    e = _engine(seed=1)
    _train(e, 1)
    d = e.save_checkpoint(str(tmp_path))
    with open(os.path.join(d, ckpt.COMMIT_MARKER)) as f:
        marker = json.load(f)
    assert marker["process_count"] == 1
    assert sorted(marker["files"]) == [
        "meta.json", "model_states.shard_0.json", "model_states.shard_0.npz",
        "optim_states.shard_0.json", "optim_states.shard_0.npz"]
    for fn, info in marker["files"].items():
        p = os.path.join(d, fn)
        assert os.path.getsize(p) == info["size"]
        assert fault.crc32_file(p) == info["crc32"]


def test_write_latest_atomic_and_empty_is_none(tmp_path):
    ckpt.write_latest(str(tmp_path), "global_step7")
    assert ckpt.read_latest(str(tmp_path)) == "global_step7"
    assert not os.path.exists(str(tmp_path / "latest.tmp"))
    with open(str(tmp_path / "latest"), "w") as f:
        f.write("   \n")
    assert ckpt.read_latest(str(tmp_path)) is None
    assert ckpt.read_latest(str(tmp_path / "nonexistent")) is None


def test_sharded_exists_requires_complete_save(tmp_path):
    d = str(tmp_path)
    ckpt.save_tree_sharded(d, "model_states",
                           {"w": np.arange(8, dtype=np.float32)})
    assert ckpt.sharded_exists(d, "model_states")
    with open(os.path.join(d, "model_states.shard_1.json"), "w") as f:
        f.write("{}")
    assert not ckpt.sharded_exists(d, "model_states")
    os.remove(os.path.join(d, "model_states.shard_1.json"))
    ckpt.write_commit_marker(d, process_count=1)
    assert ckpt.sharded_exists(d, "model_states")
    os.remove(os.path.join(d, "model_states.shard_0.npz"))
    assert not ckpt.sharded_exists(d, "model_states")


def _write_chunked(d, full, chunks):
    """A two-fragment save of one (6, 4) leaf ``w`` cut into ``chunks``
    ((start, stop) pairs), half in each fragment, as several processes
    write it."""
    for p, part in enumerate((chunks[::2], chunks[1::2])):
        arrays, entries = {}, []
        for n, (start, stop) in enumerate(part):
            ek = f"w::{n}"
            arrays[ek] = full[tuple(slice(b, e) for b, e in
                                    zip(start, stop))]
            entries.append({"entry": ek, "start": list(start),
                            "stop": list(stop)})
        np.savez(os.path.join(d, f"model_states.shard_{p}.npz"), **arrays)
        with open(os.path.join(d, f"model_states.shard_{p}.json"), "w") as f:
            json.dump({"w": {"global_shape": [6, 4], "dtype": "bfloat16",
                             "chunks": entries}}, f)


@pytest.mark.parametrize("complete", [True, False])
def test_load_tree_sharded_assembles_any_chunk_set(tmp_path, complete):
    """Chunks cut along both dims, across two fragments, assemble into
    the leaf in the template's dtype (bf16 widened on disk); a missing
    chunk is a coverage error."""
    full = np.arange(24, dtype=np.float32).reshape(6, 4)
    chunks = [((0, 0), (3, 2)), ((0, 2), (3, 4)), ((3, 0), (6, 2)),
              ((3, 2), (6, 4))]
    _write_chunked(str(tmp_path), full, chunks if complete else chunks[:3])
    template = {"w": torch.empty((6, 4), dtype=torch.bfloat16,
                                 device="meta")}
    if not complete:
        with pytest.raises(ValueError, match="incomplete checkpoint"):
            ckpt.load_tree_sharded(str(tmp_path), "model_states", template)
        return
    out = ckpt.load_tree_sharded(str(tmp_path), "model_states", template)
    assert out["w"].dtype == torch.bfloat16
    assert torch.equal(out["w"], torch.from_numpy(full).bfloat16())


def test_topology_mismatch_warns_not_crashes(tmp_path, caplog):
    from deepspeed_tpu_torch.utils.logging import logger as ds_logger
    a = _engine(_config(zero_optimization={"stage": 2}), seed=1)
    _train(a, 2)
    a.save_checkpoint(str(tmp_path))
    b = _engine(seed=5)
    old = ds_logger.propagate
    ds_logger.propagate = True
    try:
        with caplog.at_level(logging.WARNING, logger=ds_logger.name):
            path, _ = b.load_checkpoint(str(tmp_path))
    finally:
        ds_logger.propagate = old
    assert path is not None
    assert any("zero_stage" in r.message for r in caplog.records)
    _assert_same_state(a, b)


def test_async_save_is_refused(tmp_path):
    e = _engine()
    with pytest.raises(NotImplementedError, match="Queue 1 item 15"):
        e.save_checkpoint(str(tmp_path), async_=True)
    assert not os.path.exists(str(tmp_path / "global_step0.tmp"))
    assert e.wait_pending_saves() is None


def test_checkpoint_events_read_by_obs_report(tmp_path):
    """With observability on, two saves, a corrupt newest tag and a
    load write the JAX package's rows (save, fallback, load, the resume
    event, the snapshot and write times) that tools/obs_report.py
    counts."""
    import importlib.util
    obs = {"enabled": True, "events_dir": str(tmp_path / "events")}
    e = _engine(_config(observability=obs), seed=1)
    _train(e, 1)
    e.save_checkpoint(str(tmp_path / "ck"))
    _train(e, 1)
    e.save_checkpoint(str(tmp_path / "ck"))
    fault.flip_byte(str(tmp_path / "ck" / "global_step2" /
                        "model_states.shard_0.npz"))
    path, _ = e.load_checkpoint(str(tmp_path / "ck"))
    assert path.endswith("global_step1")
    e.close()
    spec = importlib.util.spec_from_file_location(
        "obs_report", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "tools", "obs_report.py"))
    report = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(report)
    s = report.summarize(str(tmp_path / "events"))
    assert s["checkpoints"]["saves"] == 2
    assert s["checkpoints"]["loads"] == 1
    assert s["checkpoints"]["fallbacks"] == 1
    assert s["elastic"]["resumes"] == 1
    rows = [json.loads(line) for line in
            open(tmp_path / "events" / "events.jsonl")]
    tags = {r.get("tag") for r in rows}
    assert {"Checkpoint/snapshot_ms", "Checkpoint/write_ms",
            "Checkpoint/restarts"} <= tags
    resume = [r for r in rows if r.get("event") == "resume"]
    assert resume[0]["tag"] == "global_step1" and resume[0]["restarts"] == 0


def test_verify_cli_flags_and_exit_codes(tmp_path, capsys):
    """The port's CLI (``python -m
    deepspeed_tpu_torch.tools.verify_checkpoint``): 0 on a healthy tag
    (directly, by --tag, --all, --serve-ready), 1 on --expect-step past
    the newest tag or a corrupt tag, 2 on a path that is no directory."""
    from deepspeed_tpu_torch.tools import verify_checkpoint as vc
    e = _engine(seed=1)
    _train(e, 2)
    e.save_checkpoint(str(tmp_path))
    tag = str(tmp_path / "global_step2")
    for argv in ([str(tmp_path)], [tag], [str(tmp_path), "--all"],
                 [str(tmp_path), "--tag", "global_step2", "--no-crc"],
                 [str(tmp_path), "--serve-ready", "--expect-step", "2"]):
        assert vc.main(argv) == 0, argv
    assert vc.main([str(tmp_path), "--expect-step", "3"]) == 1
    assert vc.main([str(tmp_path / "nope")]) == 2
    fault.flip_byte(os.path.join(tag, "optim_states.shard_0.npz"))
    assert vc.main([tag]) == 1
    assert "CRC32 mismatch" in capsys.readouterr().out
    run = subprocess.run(
        [sys.executable, "-m", "deepspeed_tpu_torch.tools.verify_checkpoint",
         str(tmp_path), "--no-crc"], capture_output=True, text=True,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert run.returncode == 0, run.stderr
    assert "verdict: COMMITTED+VERIFIED" in run.stdout


# ------------------------------------------------------------------ #
# the trace window
# ------------------------------------------------------------------ #

def _trace_steps(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted({int(e["name"].split("#")[1]) for e in events
                   if str(e.get("name", "")).startswith("train_batch#")})


@pytest.mark.parametrize("section", ["observability", "profiler"])
def test_trace_window_covers_the_configured_steps(tmp_path, section):
    """``observability.trace`` (or the legacy ``profiler`` section) at
    start_step 1 and num_steps 2 traces steps 1 and 2 only, and writes
    their Chrome trace under output_path."""
    window = {"enabled": True, "start_step": 1, "num_steps": 2,
              "output_path": str(tmp_path / "trace")}
    extra = ({"observability": {"trace": window}}
             if section == "observability" else {"profiler": window})
    e = _engine(_config(**extra))
    _train(e, 5)
    assert os.path.dirname(e.trace_path) == str(tmp_path / "trace")
    assert _trace_steps(e.trace_path) == [1, 2]
    assert e._profiler is None


def test_close_stops_an_open_trace_window(tmp_path):
    window = {"enabled": True, "start_step": 0, "num_steps": 10,
              "output_path": str(tmp_path)}
    e = _engine(_config(observability={"trace": window}))
    _train(e, 2)
    assert e._profiler is not None and e.trace_path is None
    e.close()
    assert e._profiler is None
    assert _trace_steps(e.trace_path) == [0, 1]


def test_trace_window_of_no_steps_raises_like_jax():
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfigError
    with pytest.raises(DeepSpeedConfigError, match="num_steps"):
        _engine(_config(observability={"trace": {"enabled": True,
                                                 "num_steps": 0}}))
