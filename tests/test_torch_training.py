"""The port's training path (deepspeed_tpu_torch: initialize, the engine,
Adam, Lamb with WarmupLR, ZeRO stages on a world of one, the config's
batch triangle, the GPT-2 loss and the BERT MLM loss) against the JAX
package on the CPU, at a tiny GPT-2 (2 layers, hidden 64, 2 heads, seq
32) and a tiny BERT of the same widths.

The same parameters (made by the JAX init from a seed and carried across
through numpy) and the same token ids go through both. The JAX side's
flash attention runs its Pallas kernels in interpret mode; the port's
runs the masked-flash kernels' plain versions. Tolerances:

- fp32: loss rtol 1e-5, grads within 1e-4 of each grad's largest entry,
  logits atol 1e-4 (sums run in another order);
- bf16 compute over fp32 masters: loss rtol 2e-3, grads within 2e-2 of
  each grad's largest entry (bf16 activations rounded after differently
  ordered fp32 sums);
- Adam: rtol 1e-6 (the same fp32 expressions, fused differently);
- the 5-step trajectories (fp32): every loss within rtol 1e-5, the final
  params within 1e-4 absolute.

Dropout cannot run the same masks on both sides (the JAX engine derives
its seeds from ``jax.random`` keys), so the trajectories run without it;
the masks themselves are held bit for bit in test_torch_masked_flash.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_threads  # noqa: F401  (torch threads per xdist worker)

V, S, B = 256, 32, 2
MODEL = dict(vocab_size=V, max_position_embeddings=S, hidden_size=64,
             num_layers=2, num_heads=2, embd_dropout=0.0, attn_dropout=0.0,
             resid_dropout=0.0)


def _jax_tree(seed=0):
    from deepspeed_tpu.models.gpt2 import GPT2Config, init_gpt2_params
    return init_gpt2_params(GPT2Config(**MODEL), jax.random.PRNGKey(seed))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _ids(seed, n=1):
    rng = np.random.RandomState(seed)
    return [{"input_ids": rng.randint(0, V, (B, S + 1)).astype(np.int32)}
            for _ in range(n)]


def _port_leaves(tree):
    from deepspeed_tpu_torch.utils.tree import tree_leaves
    return list(tree_leaves(tree))


def _assert_grads_close(got, want, tol):
    """Each grad within ``tol`` of its largest entry."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) <= tol * scale


@pytest.mark.parametrize("dtype,loss_rtol,grad_tol",
                         [("fp32", 1e-5, 1e-4), ("bf16", 2e-3, 2e-2)])
def test_loss_and_grads_match_jax(dtype, loss_rtol, grad_tol):
    """gpt2_loss_fn, deterministic, through the compute-dtype cast of
    fp32 masters: the loss and every master grad against
    jax.value_and_grad; in fp32 also gpt2_forward's logits."""
    from deepspeed_tpu.models import gpt2 as jg

    from deepspeed_tpu_torch.models import gpt2 as tg
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    tree = _jax_tree()
    batch = _ids(1)[0]
    jloss = jg.gpt2_loss_fn(jg.GPT2Config(**MODEL), dtype=jd,
                            deterministic=True)
    jl, jgr = jax.jit(jax.value_and_grad(lambda p: jloss(
        jax.tree_util.tree_map(lambda x: x.astype(jd), p),
        {"input_ids": jnp.asarray(batch["input_ids"])}, None)))(tree)

    params = tg.trainable_params_from_jax(_np_tree(tree), "cpu")
    leaves = _port_leaves(params)
    assert all(t.dtype == torch.float32 and t.requires_grad for t in leaves)
    tloss = tg.gpt2_loss_fn(tg.GPT2Config(**MODEL), dtype=td,
                            deterministic=True)
    cast = jax.tree_util.tree_map(lambda t: t.to(td), params)
    tl = tloss(cast, {"input_ids": torch.from_numpy(batch["input_ids"])},
               None)
    grads = torch.autograd.grad(tl, leaves)
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(float(tl.detach()), float(jl),
                               rtol=loss_rtol)
    _assert_grads_close([g.numpy() for g in grads],
                        jax.tree_util.tree_leaves(jgr), grad_tol)
    assert tg.count_params(params) == jg.count_params(tree)
    if dtype == "fp32":     # the training forward's tied-head logits
        ids = batch["input_ids"][:, :-1]
        want = jax.jit(lambda p: jg.gpt2_forward(
            p, jg.GPT2Config(**MODEL), jnp.asarray(ids),
            dtype=jnp.float32))(tree)
        with torch.no_grad():
            got = tg.gpt2_forward(params, tg.GPT2Config(**MODEL),
                                  torch.from_numpy(ids), dtype=td)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=0, atol=1e-4)


def test_dropout_path_runs_and_is_seeded():
    """With dropout on, the loss depends on the seed and only on it; a
    None seed (eval) turns every dropout off."""
    from deepspeed_tpu_torch.models import gpt2 as tg
    cfg = tg.GPT2Config(**dict(MODEL, embd_dropout=0.1, attn_dropout=0.1,
                               resid_dropout=0.1))
    params = tg.trainable_params_from_jax(_np_tree(_jax_tree()), "cpu")
    batch = {"input_ids": torch.from_numpy(_ids(2)[0]["input_ids"])}
    loss = tg.gpt2_loss_fn(cfg, dtype=torch.float32)
    det = tg.gpt2_loss_fn(tg.GPT2Config(**MODEL), dtype=torch.float32,
                          deterministic=True)
    with torch.no_grad():
        a, b, c = (float(loss(params, batch, s)) for s in (-7, -7, 11))
        assert a == b and a != c
        assert float(loss(params, batch, None)) == float(
            det(params, batch, None))


@pytest.mark.parametrize("adamw_mode,bias_correction,weight_decay", [
    (True, True, 0.01), (False, True, 0.01), (True, False, 0.0),
    (False, False, 0.05)])
def test_adam_update_matches_jax(adamw_mode, bias_correction, weight_decay):
    from deepspeed_tpu.ops.optimizers import Adam as JAdam

    from deepspeed_tpu_torch.ops.optimizers import Adam
    rng = np.random.RandomState(3)
    p0 = {"a": rng.randn(3, 4).astype(np.float32),
          "b": {"c": rng.randn(5).astype(np.float32)}}
    grads = [jax.tree_util.tree_map(
        lambda x: rng.randn(*x.shape).astype(np.float32), p0)
        for _ in range(3)]
    kw = dict(lr=1e-2, betas=(0.8, 0.99), eps=1e-6,
              weight_decay=weight_decay, adamw_mode=adamw_mode,
              bias_correction=bias_correction)
    jopt, topt = JAdam(**kw), Adam(**kw)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    js = jopt.init(jp)
    tp = jax.tree_util.tree_map(lambda x: torch.from_numpy(x.copy()), p0)
    ts = topt.init(tp)
    for g in grads:
        jp, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        tp, ts = topt.update(jax.tree_util.tree_map(torch.from_numpy, g),
                             ts, tp)
    assert ts.step == int(js.step) == 3
    for ours, theirs in ((tp, jp), (ts.exp_avg, js.exp_avg),
                         (ts.exp_avg_sq, js.exp_avg_sq)):
        for o, t in zip(jax.tree_util.tree_leaves(ours),
                        jax.tree_util.tree_leaves(theirs)):
            np.testing.assert_allclose(o.numpy(), np.asarray(t), rtol=1e-6,
                                       atol=1e-7)


# the batch-triangle cases of tests/unit/test_config.py
TRIANGLE = [
    ({"train_batch_size": 32, "train_micro_batch_size_per_gpu": 4,
      "gradient_accumulation_steps": 2}, 4),
    ({"train_batch_size": 32, "train_micro_batch_size_per_gpu": 4,
      "gradient_accumulation_steps": 4}, 4),
    ({"train_batch_size": 32, "train_micro_batch_size_per_gpu": 4}, 4),
    ({"train_batch_size": 32, "gradient_accumulation_steps": 2}, 4),
    ({"train_micro_batch_size_per_gpu": 4, "gradient_accumulation_steps": 2},
     4),
    ({"train_batch_size": 32}, 4),
    ({"train_micro_batch_size_per_gpu": 4}, 4),
    ({"steps_per_print": 10}, 4),
    ({"train_micro_batch_size_per_chip": 4}, 2),
]


@pytest.mark.parametrize("raw,world", TRIANGLE)
def test_batch_triangle_matches_jax(raw, world):
    """The same dict resolves to the same triangle, or raises in both.
    Where the JAX package asserts the triangle (an ``assert``, gone under
    ``python -O``), the port raises its DeepSpeedConfigError."""
    from deepspeed_tpu.runtime.config import DeepSpeedConfig as JConfig

    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig

    def resolve(cls):
        try:
            c = cls(dict(raw), world_size=world)
        except AssertionError:
            return "DeepSpeedConfigError"
        except Exception as e:      # both packages' config errors
            return type(e).__name__
        return (c.train_batch_size, c.train_micro_batch_size_per_gpu,
                c.gradient_accumulation_steps, c.steps_per_print,
                c.gradient_clipping, c.bf16_enabled, c.fp16_enabled)
    assert resolve(DeepSpeedConfig) == resolve(JConfig)


def _ds_config(ga, clip, **extra):
    return dict({"train_micro_batch_size_per_gpu": B,
                 "gradient_accumulation_steps": ga,
                 "gradient_clipping": clip, "steps_per_print": 1000,
                 "optimizer": {"type": "Adam", "params": {"lr": 3e-3}}},
                **extra)


def _port_engine(ga, clip, tree, **extra):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, gpt2_loss_fn
    return deepspeed_tpu_torch.initialize(
        model=gpt2_loss_fn(GPT2Config(**MODEL), dtype=torch.float32,
                           deterministic=True),
        model_parameters=_np_tree(tree), config=_ds_config(ga, clip, **extra),
        device="cpu")


@pytest.mark.parametrize("ga,clip", [(1, 0.0), (2, 0.05)])
def test_trajectory_matches_jax_engine(ga, clip):
    """5 train_batch steps of initialize(...) in fp32 against the JAX
    engine on one device, over one repeated batch: every loss and the
    final params."""
    import deepspeed_tpu
    from deepspeed_tpu.models.gpt2 import GPT2Config, gpt2_loss_fn
    tree = _jax_tree()
    micros = _ids(4, ga) * 5
    jeng, *_ = deepspeed_tpu.initialize(
        model=gpt2_loss_fn(GPT2Config(**MODEL), dtype=jnp.float32,
                           deterministic=True),
        model_parameters=tree,
        config=_ds_config(ga, clip, mesh={"axes": {"data": 1}}))
    assert jeng.dp_world_size == 1
    teng, *_ = _port_engine(ga, clip, tree)
    jit, tit = iter(micros), iter(micros)
    jl = [float(jeng.train_batch(jit)) for _ in range(5)]
    tl = [float(teng.train_batch(tit)) for _ in range(5)]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]
    assert teng.global_steps == 5 and teng.last_loss() == tl[-1]
    # Adam moves an entry by up to lr per step whatever its grad's size,
    # so near-zero grads turn fp32 sum-order differences into update
    # differences of that order: the params are held to an absolute 1e-4
    # against the 1.5e-2 that 5 steps at lr 3e-3 can move them
    for t, j in zip(_port_leaves(teng.module_params),
                    jax.tree_util.tree_leaves(jeng.module_params)):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                   rtol=0, atol=1e-4)


def test_forward_backward_step_equal_train_batch():
    """The three-call facade takes the same steps as train_batch,
    accumulation boundary included, and eval_batch changes nothing."""
    tree = _jax_tree()
    micros = _ids(5, 4)
    a, *_ = _port_engine(2, 0.05, tree)
    b, *_ = _port_engine(2, 0.05, tree)
    it = iter(micros)
    la = [float(a.train_batch(it)) for _ in range(2)]
    lb = []
    for m in micros:
        assert b.is_gradient_accumulation_boundary() == (len(lb) % 2 == 1)
        lb.append(float(b.forward(m)))
        b.backward()
        b.step()
    assert b.global_steps == a.global_steps == 2
    np.testing.assert_allclose(la, [np.mean(lb[:2]), np.mean(lb[2:])],
                               rtol=1e-6)
    for x, y in zip(_port_leaves(a.module_params),
                    _port_leaves(b.module_params)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    before = [t.clone() for t in _port_leaves(a.module_params)]
    ev = a.eval_batch(micros[0])
    assert torch.isfinite(ev)
    for x, y in zip(before, _port_leaves(a.module_params)):
        assert torch.equal(x, y)


def test_initialize_returns_four_tuple_and_copies_params():
    tree = _np_tree(_jax_tree())
    engine, opt, loader, sched = _port_engine(1, 0.0, _jax_tree())
    from deepspeed_tpu_torch import Adam, DeepSpeedEngine
    assert isinstance(engine, DeepSpeedEngine)
    assert isinstance(opt, Adam) and opt.lr == 3e-3
    assert loader is None and sched is None
    assert engine.device == torch.device("cpu")
    assert engine.train_batch_size() == B
    engine.train_batch(iter(_ids(6)))
    np.testing.assert_array_equal(tree["wte"], _np_tree(_jax_tree())["wte"])


def test_training_data_loader_repeats():
    """training_data goes through DeepSpeedDataLoader and RepeatingLoader
    on the engine's device."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, gpt2_loss_fn
    rows = [{"input_ids": r} for r in _ids(7)[0]["input_ids"]]
    engine, _, loader, _ = deepspeed_tpu_torch.initialize(
        model=gpt2_loss_fn(GPT2Config(**MODEL), dtype=torch.float32,
                           deterministic=True),
        model_parameters=_np_tree(_jax_tree()),
        config=_ds_config(1, 0.0, train_micro_batch_size_per_gpu=1),
        training_data=rows, device="cpu")
    assert len(loader) == 2
    batch = next(iter(loader))
    assert batch["input_ids"].shape == (1, S + 1)
    losses = [float(engine.train_batch()) for _ in range(3)]
    assert all(np.isfinite(losses)) and engine.global_steps == 3


@pytest.mark.parametrize("extra,word", [
    ({"zero_optimization": {"stage": 3}}, "ZeRO"),
    ({"mesh": {"axes": {"data": 1, "seq": 2}}}, "mesh"),
    ({"fp16": {"enabled": True}}, "fp16"),
    ({"pipeline": {"stages": 2}}, "pipeline"),
    ({"optimizer": {"type": "OneBitAdam", "params": {"lr": 1e-3}}}, "1-bit"),
    ({"optimizer": {"type": "SGD", "params": {"lr": 1e-3}}}, "not ported"),
])
def test_unported_settings_raise(extra, word):
    with pytest.raises(NotImplementedError, match=word):
        _port_engine(1, 0.0, _jax_tree(), **extra)


@pytest.mark.parametrize("stage,world,offload", [(1, 2, False),
                                                 (2, 4, False),
                                                 (3, 1, False),
                                                 (1, 1, True)])
def test_zero_beyond_one_shard_raises(stage, world, offload):
    """Stage 3 still raises, naming the ROADMAP item that ports it; ZeRO
    1 and 2 across a data-parallel world and ZeRO-Offload now parse (their
    runtime: tests/test_torch_zero.py, tests/test_torch_cpu_adam.py), the
    batch triangle resolving against the world."""
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
    raw = {"train_micro_batch_size_per_gpu": 2,
           "zero_optimization": {"stage": stage, "cpu_offload": offload}}
    if stage == 3:
        with pytest.raises(NotImplementedError, match="Queue 1 item 18"):
            DeepSpeedConfig(raw, world_size=world)
        return
    cfg = DeepSpeedConfig(raw, world_size=world)
    assert cfg.zero_optimization_stage == stage
    assert cfg.zero_config.cpu_offload == offload
    assert cfg.train_batch_size == 2 * world
    for ok in (1, 2):
        cfg = DeepSpeedConfig({"train_micro_batch_size_per_gpu": 2,
                               "zero_optimization": {"stage": ok}})
        assert cfg.zero_optimization_stage == ok


@pytest.mark.parametrize("extra,word", [
    ({"mesh": {"axes": {"data": 1, "model": 2}}}, "mesh"),
    ({"mesh": {"axes": {"pipe": 2}}}, "mesh"),
    ({"observability": {"health": {"enabled": True}}},
     "observability.health"),
])
def test_monitor_and_mesh_sections_raise(extra, word):
    """The JAX engine opens the health plane and the model or pipe mesh
    axes these sections ask for; the port has neither yet, so it refuses
    them through the config and through initialize, never training
    without. (A data axis trains: tests/test_torch_zero.py; one larger
    than the process group raises ValueError there.)
    (``tensorboard.enabled`` and ``observability.enabled`` train:
    tests/test_torch_observability.py; the trace window:
    tests/test_torch_checkpoint_durability.py.)"""
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
    with pytest.raises(NotImplementedError, match=word):
        DeepSpeedConfig(_ds_config(1, 0.0, **extra))
    with pytest.raises(NotImplementedError, match=word):
        _port_engine(1, 0.0, _jax_tree(), **extra)


@pytest.mark.parametrize("extra", [
    {"tensorboard": {"enabled": False, "output_path": "tb"}},
    {"mesh": {"axes": {"data": 1, "model": 1}}},
    {"observability": {"enabled": False, "events_dir": "obs"}},
    {"observability": {"trace": {"enabled": False, "num_steps": 2}}},
    {"observability": {"health": {"enabled": False}}},
    {"profiler": {"enabled": False}},
    {"observability": {"serve": {"enabled": True, "sample_rate": 0.5}}},
])
def test_disabled_monitor_and_unit_mesh_train(extra):
    """Disabled monitor and observability sections, a mesh of one device
    and the serving engine's ``observability.serve`` train."""
    engine, *_ = _port_engine(1, 0.0, _jax_tree(), **extra)
    loss = float(engine.train_batch(iter(_ids(8))))
    assert np.isfinite(loss) and engine.global_steps == 1


@pytest.mark.parametrize("extra", [
    {"bf16": {"enabled": False, "stochastic_rounding": True}},
    {"quantized_comm": {"algo": "nope"}},
    {"quantized_comm": {"block": 4}},
    {"comm_autotune": {"overlap": "sometimes"}},
    {"async_pipeline": {"prefetch_depth": -1}},
    {"observability": {"recompile_warn_after": -1}},
    {"observability": {"trace": {"enabled": True, "num_steps": 0}}},
    {"compressed_allreduce": {"block": 2}},
    {"quantized_comm": {"hierarchical": True}},
    {"profiler": {"enabled": True, "num_steps": 0}},
])
def test_config_value_checks_match_jax(extra):
    """Values the JAX package refuses get its DeepSpeedConfigError from
    the port too, ahead of any refusal of a section that is not ported."""
    from deepspeed_tpu.runtime.config import DeepSpeedConfig as JConfig
    from deepspeed_tpu.runtime.config import \
        DeepSpeedConfigError as JConfigError

    from deepspeed_tpu_torch.runtime.config import (DeepSpeedConfig,
                                                    DeepSpeedConfigError)
    raw = _ds_config(1, 0.0, **extra)
    with pytest.raises(JConfigError):
        JConfig(dict(raw))
    with pytest.raises(DeepSpeedConfigError):
        DeepSpeedConfig(dict(raw))


def test_config_values_both_packages_accept():
    """Valid values of those sections build in both packages, and the
    port reads them as the JAX package does."""
    from deepspeed_tpu.runtime.config import DeepSpeedConfig as JConfig

    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
    raw = _ds_config(
        1, 0.0, bf16={"enabled": True, "stochastic_rounding": True},
        compressed_allreduce={"enabled": True, "block": 64},
        quantized_comm={"algo": "allgather"},
        comm_autotune={"overlap": 0, "block_candidates": [64, 128]},
        async_pipeline={"prefetch_depth": 0},
        profiler={"output_path": "trace", "num_steps": 0},
        observability={"recompile_warn_after": 0,
                       "trace": {"start_step": 5},
                       "health": {"ring_events": 8, "on_stall": "exit"},
                       "serve": {"sample_rate": 1.0}})
    j, t = JConfig(dict(raw)), DeepSpeedConfig(dict(raw))
    assert t.bf16_stochastic_rounding is j.bf16_stochastic_rounding is True
    for key in ("enabled", "algo", "block", "hierarchical",
                "quantize_weights", "secondary_partition"):
        assert t.quantized_comm_config[key] == j.quantized_comm_config[key]
    for key, value in t.comm_autotune_config.items():
        assert value == j.comm_autotune_config[key], key
    assert t.async_pipeline_config == j.async_pipeline_config
    for key, value in t.observability_config.items():
        assert value == j.observability_config[key], key


def test_engine_needs_a_card_or_an_explicit_device(monkeypatch):
    import deepspeed_tpu_torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        deepspeed_tpu_torch.initialize(
            model=lambda p, b: p["w"].sum(),
            model_parameters={"w": np.ones(3, np.float32)},
            config=_ds_config(1, 0.0))


def test_timers_and_wall_clock_breakdown():
    """The ported timers time host work, and an engine with
    ``wall_clock_breakdown`` runs its timed three-call step."""
    import time

    from deepspeed_tpu_torch.utils.timer import (SynchronizedWallClockTimer,
                                                 ThroughputTimer)
    timers = SynchronizedWallClockTimer()
    timers("a").start()
    time.sleep(0.01)
    timers("a").stop()
    assert timers("a").elapsed(reset=False) >= 0.01
    with pytest.raises(RuntimeError, match="not started"):
        timers("b").stop()
    tput = ThroughputTimer(batch_size=4, start_step=1, steps_per_output=2)
    assert tput.avg_samples_per_sec() == -1
    for _ in range(3):
        tput.start()
        time.sleep(0.005)
        tput.stop()
    assert 0 < tput.avg_samples_per_sec() < 4 / 0.005
    engine, *_ = _port_engine(1, 0.0, _jax_tree(), wall_clock_breakdown=True)
    engine.forward(_ids(8)[0])
    engine.backward()
    engine.step()
    assert engine.global_steps == 1


# ------------------------------------------------------------------ BERT
BERT = dict(vocab_size=V, hidden_size=64, num_layers=2, num_heads=2,
            intermediate_size=128, max_position_embeddings=S,
            hidden_dropout=0.0, attn_dropout=0.0)


def _bing_bert_config(**over):
    """examples/bing_bert/ds_config.json as the repo holds it (Lamb,
    WarmupLR, clipping 1.0, ZeRO 1, ga 2), with micro batch B, fp32."""
    import json
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "examples" / \
        "bing_bert" / "ds_config.json"
    raw = json.loads(path.read_text())
    raw.update(train_micro_batch_size_per_gpu=B, bf16={"enabled": False},
               steps_per_print=1000, **over)
    return raw


def _mlm_batches(seed, n):
    """Padded MLM micro batches: lengths 16-32, labels -100 on the pads
    and on the real tokens not picked."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ids = rng.randint(0, V, (B, S)).astype(np.int32)
        am = (np.arange(S)[None, :] < rng.randint(16, S + 1, B)[:, None]
              ).astype(np.int32)
        labels = np.where((rng.rand(B, S) < 0.3) & (am == 1), ids,
                          -100).astype(np.int32)
        out.append({"input_ids": ids, "attention_mask": am,
                    "labels": labels})
    return out


def _bert_engine(tree, raw):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.bert import BertConfig, bert_mlm_loss_fn
    return deepspeed_tpu_torch.initialize(
        model=bert_mlm_loss_fn(BertConfig(**BERT), dtype=torch.float32,
                               deterministic=True),
        model_parameters=_np_tree(tree), config=raw, device="cpu")


def _bert_tree():
    from deepspeed_tpu.models.bert import BertConfig, init_bert_params
    return init_bert_params(BertConfig(**BERT), jax.random.PRNGKey(0))


def test_bing_bert_trajectory_matches_jax_engine():
    """5 train_batch steps of the bing_bert config (Lamb lr 2e-3, wd 0.01,
    coefficients clamped to [0.01, 0.3]; log WarmupLR over 100 steps;
    clipping 1.0; ZeRO 1; ga 2) in fp32 on a padded batch, against the
    JAX engine on one device: every loss, every step's lr (read before the
    step counts) and the final params."""
    import deepspeed_tpu
    from deepspeed_tpu.models.bert import BertConfig, bert_mlm_loss_fn

    from deepspeed_tpu_torch.ops.optimizers import Lamb
    from deepspeed_tpu_torch.runtime.lr_schedules import WarmupLR
    tree = _bert_tree()
    micros = _mlm_batches(3, 2) * 5
    raw = _bing_bert_config()
    jeng, *_ = deepspeed_tpu.initialize(
        model=bert_mlm_loss_fn(BertConfig(**BERT), dtype=jnp.float32,
                               deterministic=True),
        model_parameters=tree, config=dict(raw, mesh={"axes": {"data": 1}}))
    teng, opt, _, sched = _bert_engine(tree, raw)
    assert isinstance(opt, Lamb) and isinstance(sched, WarmupLR)
    assert (opt.lr, opt.weight_decay, opt.min_coeff, opt.max_coeff) == \
        (2e-3, 0.01, 0.01, 0.3)
    assert teng.zero_optimization_stage() == jeng.zero_optimization_stage() \
        == 1
    jit, tit = iter(micros), iter(micros)
    jl, tl = [], []
    for step in range(5):
        np.testing.assert_allclose(teng.get_lr(), jeng.get_lr(), rtol=1e-6,
                                   atol=1e-12)
        assert teng.get_lr() == [sched.lr_at(step)]
        jl.append(float(jeng.train_batch(jit)))
        tl.append(float(teng.train_batch(tit)))
        coeffs = opt.get_lamb_coeffs()
        assert len(coeffs) == len(_port_leaves(teng.module_params))
        assert all(c == 1.0 or np.float32(0.01) <= c <= np.float32(0.3)
                   for c in coeffs)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for t, j in zip(_port_leaves(teng.module_params),
                    jax.tree_util.tree_leaves(jeng.module_params)):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                   rtol=0, atol=1e-4)


@pytest.mark.parametrize("stage", [1, 2])
def test_zero_stage_at_world_one_equals_stage_0(stage):
    """ZeRO 1 and 2 on one device are one shard of everything: three
    steps take the params stage 0 takes, bit for bit."""
    tree = _bert_tree()
    micros = _mlm_batches(4, 2) * 3
    runs = []
    for st in (0, stage):
        eng, *_ = _bert_engine(tree, _bing_bert_config(
            zero_optimization={"stage": st}))
        assert eng.zero_optimization_stage() == st
        it = iter(micros)
        losses = [float(eng.train_batch(it)) for _ in range(3)]
        runs.append((losses, _port_leaves(eng.module_params)))
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)
