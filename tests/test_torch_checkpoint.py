"""Checkpoints across the packages: a tag the JAX engine writes loads in
the port, and a tag the port writes loads in the JAX engine and passes
the unmodified ``tools/verify_checkpoint.py``; the port serves a JAX tag
through ``InferenceEngine.from_checkpoint`` and moves to a newer one with
``swap_params``; the ``checkpoint`` config section gets the JAX package's
checks.

A tiny GPT-2 (2 layers, hidden 64, 4 heads, seq 32) trains under Adam and
WarmupLR, with the same parameters (made by the JAX init from a seed and
carried across through numpy) and the same token ids in both packages.
The JAX side's attention runs its Pallas kernels in interpret mode, the
port's the kernels' plain versions. Tolerances:

- every leaf of a loaded tag: bitwise (``np.array_equal``); the step
  counters and the lr schedule's state exactly, the lr itself at
  tests/test_torch_observability.py's rtol 1e-6 (the JAX schedule
  computes it in fp32, the port's in fp64: one fp32 ulp apart);
- 2 steps after the load, both packages from the same state: fp32 losses
  rtol 1e-5 and params atol 1e-5; bf16 compute over fp32 masters the
  loss rtol of PERF.md's bf16 row, 2e-3, and params within 2 lr (Adam
  moves an entry by up to lr per step, so a grad whose sign differs after
  bf16 rounding moves it by at most that). Each leaf's difference is also
  held to its own move since the load (the RMS of port - JAX over that
  of JAX - loaded): fp32 1e-4, bf16 0.05, where these cases measured at
  most 7.8e-6 and 0.0118 (the median 3e-7 and 0.005). A port that left
  the params where the load put them reads 1 and fails. The key third
  of the qkv bias is left out of that check: its exact grad is 0, so
  both packages move it on rounding noise alone (0.7-1.0 measured);
- served logits: ``tests/test_torch_serving.py``'s 1e-4 (fp32), tokens
  exactly.
"""

import copy
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
from tests.unit.test_inference import TINY_INF, tiny_gpt2

REPO = pathlib.Path(__file__).resolve().parents[1]
V, S, B = 256, 32, 8
LR = 3e-3
MODEL = dict(vocab_size=V, max_position_embeddings=S, hidden_size=64,
             num_layers=2, num_heads=4, embd_dropout=0.0, attn_dropout=0.0,
             resid_dropout=0.0)
TRAJ_TOL = {"fp32": dict(loss=1e-5, params=1e-5, update=1e-4),
            "bf16": dict(loss=2e-3, params=2 * LR, update=0.05)}
LOGIT_ATOL = 1e-4
PAGED_INF = dict(TINY_INF, paged_kv={"page_size": 4})
PROMPTS = [[5, 6, 7, 8, 9, 10], [5, 6, 7, 8, 11], [1, 2, 3], [40, 41]]


def _jax_tree(seed=0):
    from deepspeed_tpu.models.gpt2 import GPT2Config, init_gpt2_params
    return init_gpt2_params(GPT2Config(**MODEL), jax.random.PRNGKey(seed))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _batches(n, seed=0):
    rng = np.random.RandomState(seed)
    return [{"input_ids": rng.randint(0, V, (B, S + 1)).astype(np.int32)}
            for _ in range(n)]


def _ds_config(dtype, stage=0, micro=B, **extra):
    return dict({"train_micro_batch_size_per_gpu": micro,
                 "steps_per_print": 1000,
                 "bf16": {"enabled": dtype == "bf16"},
                 "zero_optimization": {"stage": stage},
                 "optimizer": {"type": "Adam", "params": {"lr": LR}},
                 "scheduler": {"type": "WarmupLR",
                               "params": {"warmup_max_lr": LR,
                                          "warmup_num_steps": 10}}},
                **extra)


def _jax_engine(dtype, stage=0, dp=1, seed=0):
    import deepspeed_tpu
    from deepspeed_tpu.models.gpt2 import GPT2Config, gpt2_loss_fn
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    engine, *_ = deepspeed_tpu.initialize(
        model=gpt2_loss_fn(GPT2Config(**MODEL), dtype=jd,
                           deterministic=True),
        model_parameters=_jax_tree(seed),
        config=_ds_config(dtype, stage, micro=B // dp,
                          mesh={"axes": {"data": dp}}))
    assert engine.dp_world_size == dp
    return engine


def _port_engine(dtype, stage=0, seed=0, engine_seed=0):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, gpt2_loss_fn
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=gpt2_loss_fn(GPT2Config(**MODEL), dtype=td,
                           deterministic=True),
        model_parameters=_np_tree(_jax_tree(seed)),
        config=_ds_config(dtype, stage), device="cpu", seed=engine_seed)
    return engine


def _train(engine, batches):
    return [float(engine.train_batch(iter([b]))) for b in batches]


def _port_state(engine):
    """{params, exp_avg, exp_avg_sq}: leaf lists as numpy, in JAX's leaf
    order."""
    from deepspeed_tpu_torch.utils.tree import tree_leaves
    st = engine.opt_state
    return {name: [t.detach().numpy() for t in tree_leaves(tree)]
            for name, tree in (("params", engine.params),
                               ("exp_avg", st.exp_avg),
                               ("exp_avg_sq", st.exp_avg_sq))}


def _jax_state(engine):
    st = engine.state.opt_state
    return {name: [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]
            for name, tree in (("params", engine.state.params),
                               ("exp_avg", st.exp_avg),
                               ("exp_avg_sq", st.exp_avg_sq))}


def _assert_bitwise(port, jx):
    for name in ("params", "exp_avg", "exp_avg_sq"):
        assert len(port[name]) == len(jx[name]) > 0
        for a, b in zip(port[name], jx[name]):
            assert a.dtype == b.dtype and np.array_equal(a, b), name


def _assert_same_counters(teng, jeng):
    assert teng.global_steps == int(jeng.global_steps)
    assert teng.opt_state.step == int(jeng.state.opt_state.step)
    assert teng.lr_scheduler.state_dict() == jeng.lr_scheduler.state_dict()
    np.testing.assert_allclose(teng.get_lr(), jeng.get_lr(), rtol=1e-6)


def _update_gap(port, jx, at_load):
    """How far the port's params are from JAX's, relative to JAX's own
    move since the load: the RMS of ``port - jx`` over that of
    ``jx - at_load``."""
    return float(np.sqrt(np.mean((port - jx) ** 2)
                         / np.mean((jx - at_load) ** 2)))


def _assert_trajectories(tl, jl, teng, jeng, dtype, at_load):
    from deepspeed_tpu_torch.runtime.checkpoint import _flatten_named
    tol = TRAJ_TOL[dtype]
    np.testing.assert_allclose(tl, jl, rtol=tol["loss"])
    for key, a, b, p0 in zip(_flatten_named(teng.params),
                             _port_state(teng)["params"],
                             _jax_state(jeng)["params"], at_load):
        np.testing.assert_allclose(a, b, rtol=0, atol=tol["params"])
        if key.endswith("attn/qkvb"):
            # the key bias's exact grad is 0 (it adds one constant to a
            # row's scores), so Adam moves it on rounding noise alone
            h = a.shape[-1] // 3
            keep = np.r_[:h, 2 * h:3 * h]
            a, b, p0 = a[..., keep], b[..., keep], p0[..., keep]
        assert _update_gap(a, b, p0) <= tol["update"], key
        # the control: a port that left out the update fails
        assert _update_gap(p0, b, p0) > tol["update"], key


@pytest.mark.parametrize("dtype,stage,dp", [("fp32", 0, 1), ("bf16", 0, 1),
                                            ("fp32", 2, 8)])
def test_jax_tag_loads_in_port(tmp_path, dtype, stage, dp):
    """The JAX engine takes 3 steps and saves; a port engine made from
    another init and another seed loads the tag: every leaf bitwise, the
    counters and the lr equal; then both take 2 more steps. At ZeRO 2
    over the 8 CPU devices every leaf is saved in several chunks, which
    the port assembles."""
    batches = _batches(5)
    jeng = _jax_engine(dtype, stage, dp)
    _train(jeng, batches[:3])
    jeng.save_checkpoint(str(tmp_path))
    with open(tmp_path / "global_step3" / "model_states.shard_0.json") as f:
        chunks = {len(e["chunks"]) for e in json.load(f).values()}
    assert chunks == ({8} if dp == 8 else {1})
    teng = _port_engine(dtype, stage, seed=1, engine_seed=7)
    path, client = teng.load_checkpoint(str(tmp_path))
    assert path.endswith("global_step3") and client == {}
    _assert_bitwise(_port_state(teng), _jax_state(jeng))
    _assert_same_counters(teng, jeng)
    at_load = _jax_state(jeng)["params"]
    jl, tl = _train(jeng, batches[3:]), _train(teng, batches[3:])
    _assert_trajectories(tl, jl, teng, jeng, dtype, at_load)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_port_tag_loads_in_jax(tmp_path, dtype):
    """The port takes 3 steps and saves; the JAX engine, from another
    init, loads the tag with verify_integrity=True: every leaf bitwise,
    the counters, the lr and meta's two key words; then both take 2 more
    steps."""
    batches = _batches(5, seed=1)
    teng = _port_engine(dtype)
    _train(teng, batches[:3])
    d = teng.save_checkpoint(str(tmp_path), client_state={"epoch": 1})
    jeng = _jax_engine(dtype, seed=1)
    path, client = jeng.load_checkpoint(str(tmp_path),
                                        verify_integrity=True)
    assert path == d and client == {"epoch": 1}
    _assert_bitwise(_port_state(teng), _jax_state(jeng))
    _assert_same_counters(teng, jeng)
    with open(os.path.join(d, "meta.json")) as f:
        words = json.load(f)["rng"]
    assert np.asarray(jeng.state.rng).tolist() == words
    at_load = _jax_state(jeng)["params"]
    jl, tl = _train(jeng, batches[3:]), _train(teng, batches[3:])
    _assert_trajectories(tl, jl, teng, jeng, dtype, at_load)


def _bert_engines(dtype):
    import deepspeed_tpu
    import deepspeed_tpu_torch
    from deepspeed_tpu.models import bert as jb

    from deepspeed_tpu_torch.models import bert as tb
    widths = dict(vocab_size=V, hidden_size=64, num_layers=2, num_heads=2,
                  intermediate_size=128, max_position_embeddings=S,
                  hidden_dropout=0.0, attn_dropout=0.0)
    with open(REPO / "examples" / "bing_bert" / "ds_config.json") as f:
        cfg = dict(json.load(f), train_micro_batch_size_per_gpu=2)
    tree = jb.init_bert_params(jb.BertConfig(**widths),
                               jax.random.PRNGKey(0))
    jeng, *_ = deepspeed_tpu.initialize(
        model=jb.bert_mlm_loss_fn(jb.BertConfig(**widths)),
        model_parameters=tree,
        config=dict(cfg, mesh={"axes": {"data": 1}}))
    teng, *_ = deepspeed_tpu_torch.initialize(
        model=tb.bert_mlm_loss_fn(tb.BertConfig(**widths)),
        model_parameters=_np_tree(tree), config=cfg, device="cpu")
    return jeng, teng


def _llama_engines(dtype):
    import deepspeed_tpu
    import deepspeed_tpu_torch
    from deepspeed_tpu.models import llama as jl

    from deepspeed_tpu_torch.models import llama as tl
    widths = dict(vocab_size=V, hidden_size=64, num_layers=2, num_heads=4,
                  num_kv_heads=2, max_position_embeddings=S,
                  scan_layers=True)
    with open(REPO / "examples" / "llama" / "ds_config_zero2.json") as f:
        cfg = dict(json.load(f), train_micro_batch_size_per_gpu=2)
    tree = jl.init_llama_params(jl.LlamaConfig(**widths),
                                jax.random.PRNGKey(0))
    assert "h" in tree          # the stacked layout
    jeng, *_ = deepspeed_tpu.initialize(
        model=jl.llama_loss_fn(jl.LlamaConfig(**widths)),
        model_parameters=tree,
        config=dict(cfg, mesh={"axes": {"data": 1}}))
    teng, *_ = deepspeed_tpu_torch.initialize(
        model=tl.llama_loss_fn(tl.LlamaConfig(**widths)),
        model_parameters=_np_tree(tree), config=cfg, device="cpu")
    return jeng, teng


def _gpt2_engines(dtype):
    return _jax_engine(dtype), _port_engine(dtype)


@pytest.mark.parametrize("make", [_gpt2_engines, _bert_engines,
                                  _llama_engines],
                         ids=["gpt2_adam", "bert_lamb", "llama_stacked"])
def test_tag_manifests_and_meta_keys_match(tmp_path, make):
    """GPT-2 under Adam, BERT under bing_bert's Lamb config and Llama in
    the stacked layout under its ZeRO 2 config: a tag of each package
    has the same files, manifests (leaf keys, shapes, dtypes, chunk
    entries) and meta keys (the port adds its generator state)."""
    from deepspeed_tpu_torch.runtime.engine import TORCH_RNG_KEY
    jeng, teng = make("bf16")
    dirs = [e.save_checkpoint(str(tmp_path / name), tag="t")
            for name, e in (("jax", jeng), ("port", teng))]
    listing = [sorted(os.listdir(d)) for d in dirs]
    assert listing[0] == listing[1]
    for fn in ("model_states.shard_0.json", "optim_states.shard_0.json"):
        manifests = []
        for d in dirs:
            with open(os.path.join(d, fn)) as f:
                manifests.append(json.load(f))
        assert list(manifests[0]) == list(manifests[1])     # leaf order
        assert manifests[0] == manifests[1]
    metas = []
    for d in dirs:
        with open(os.path.join(d, "meta.json")) as f:
            metas.append(json.load(f))
    assert set(metas[1]) - set(metas[0]) == {TORCH_RNG_KEY}
    assert set(metas[0]) <= set(metas[1])
    for key in ("global_step", "micro_step", "skipped_steps",
                "lr_scheduler", "dp_world_size", "zero_stage"):
        assert metas[0][key] == metas[1][key], key


def _jax_verify_tool():
    spec = importlib.util.spec_from_file_location(
        "verify_checkpoint", REPO / "tools" / "verify_checkpoint.py")
    vc = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(vc)
    return vc


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_verify_tools_pass_the_other_packages_tag(tmp_path, capsys,
                                                  writer):
    """The unmodified tools/verify_checkpoint.py passes a port tag, and
    the port's CLI a JAX tag, both with every leaf covered; a flipped
    bit makes both exit 1."""
    from deepspeed_tpu_torch.tools import verify_checkpoint as port_tool
    engine = _port_engine("fp32") if writer == "port" else \
        _jax_engine("fp32")
    _train(engine, _batches(2))
    engine.save_checkpoint(str(tmp_path))
    tools = (_jax_verify_tool(), port_tool)
    for tool in tools:
        assert tool.main([str(tmp_path), "--expect-step", "2"]) == 0
        out = capsys.readouterr().out
        assert "COMMITTED+VERIFIED" in out and "GAP" not in out
    from deepspeed_tpu_torch.runtime import fault
    fault.flip_byte(str(tmp_path / "global_step2" /
                        "model_states.shard_0.npz"))
    for tool in tools:
        assert tool.main([str(tmp_path)]) == 1
        assert "CRC32 mismatch" in capsys.readouterr().out


def _serving_tags(tmp_path, steps=(2, 4)):
    """A JAX engine trains the serving tests' tiny GPT-2 and saves at
    each of ``steps``. Returns the JAX config."""
    import deepspeed_tpu
    from deepspeed_tpu.models.gpt2 import gpt2_loss_fn
    cfg, params = tiny_gpt2()
    engine, *_ = deepspeed_tpu.initialize(
        model=gpt2_loss_fn(cfg, dtype=jnp.float32, deterministic=True),
        model_parameters=params,
        config={"train_micro_batch_size_per_gpu": 2,
                "steps_per_print": 1000, "mesh": {"axes": {"data": 1}},
                "optimizer": {"type": "Adam", "params": {"lr": 1e-2}}})
    rng = np.random.RandomState(5)
    done = 0
    for step in steps:
        for _ in range(step - done):
            engine.train_batch(iter([{"input_ids": rng.randint(
                0, cfg.vocab_size, (2, 17)).astype(np.int32)}]))
        done = step
        engine.save_checkpoint(str(tmp_path))
    return cfg


def _port_config(cfg):
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config
    return GPT2Config(**cfg._asdict())


def _logits(forward, params, cfg, ids, cache, start, tables, np_):
    """One paged prefill then one decode of the argmax tokens."""
    out, cache = forward(params, cfg, np_(ids), cache, np_(start),
                         np_(tables))
    lengths = np.asarray([ids.shape[1]] * ids.shape[0])
    tok = np.asarray(out)[:, -1].argmax(-1).astype(np.int32)[:, None]
    out2, _ = forward(params, cfg, np_(tok), cache,
                      np_((start + lengths).astype(np.int32)), np_(tables))
    return np.asarray(out), np.asarray(out2)


def test_from_checkpoint_serves_a_jax_tag(tmp_path):
    """The port's from_checkpoint of a JAX tag: its weights bitwise equal
    to those JAX's from_checkpoint loads, one paged prefill and one
    decode within LOGIT_ATOL of JAX's, greedy tokens equal, the version
    named and the serve_load row written."""
    from deepspeed_tpu.inference import InferenceEngine as JaxEngine
    from deepspeed_tpu.models.gpt2 import gpt2_forward as jax_forward

    from deepspeed_tpu_torch import InferenceEngine
    from deepspeed_tpu_torch.models.gpt2 import gpt2_forward
    cfg = _serving_tags(tmp_path, steps=(2,))
    tcfg = _port_config(cfg)
    jeng = JaxEngine.from_checkpoint(str(tmp_path), cfg,
                                     inference_config=PAGED_INF,
                                     dtype=jnp.float32)
    events = tmp_path / "events"
    teng = InferenceEngine.from_checkpoint(
        str(tmp_path), tcfg, inference_config=dict(
            PAGED_INF, events_dir=str(events)),
        dtype=torch.float32, device="cpu")
    assert teng.weight_version == "global_step2" == jeng.weight_version
    state = teng.debug_state()
    assert (state["weight_version"], state["weight_ordinal"]) == \
        ("global_step2", 0)
    jl = jax.tree_util.tree_leaves(jeng.params)
    tl = jax.tree_util.tree_leaves(teng.params)
    assert len(jl) == len(tl)
    for a, b in zip(tl, jl):
        assert np.array_equal(a.numpy(), np.asarray(b))

    L, H, hd, ps, P = cfg.num_layers, cfg.num_heads, 8, 4, 4
    shape = (L, 2 * P + 1, H, ps, hd)
    tables = np.stack([np.arange(1, P + 1), np.arange(P + 1, 2 * P + 1)]
                      ).astype(np.int32)
    ids = np.asarray([[3, 9, 27, 4, 1], [8, 6, 7, 5, 3]], np.int32)
    start = np.zeros((2,), np.int32)

    def jfwd(p, c, i, cache, pos, tab):
        out, cache = jax_forward(p, c, i, dtype=jnp.float32, kv_cache=cache,
                                 cache_position=pos, block_tables=tab,
                                 paged_attn_kernel="pallas")
        return out, cache

    def tfwd(p, c, i, cache, pos, tab):
        return gpt2_forward(p, c, i, dtype=torch.float32, kv_cache=cache,
                            cache_position=pos, block_tables=tab,
                            paged_attn_kernel="kernel")
    want = _logits(jfwd, jeng.params, cfg, ids,
                   (jnp.zeros(shape), jnp.zeros(shape)), start, tables,
                   jnp.asarray)
    got = _logits(tfwd, teng.params, tcfg, ids,
                  (torch.zeros(shape), torch.zeros(shape)), start, tables,
                  torch.from_numpy)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=LOGIT_ATOL, rtol=0)
    assert teng.generate(PROMPTS, max_new_tokens=5) == \
        jeng.generate(PROMPTS, max_new_tokens=5)
    teng.close()
    rows = [json.loads(line) for line in
            open(events / "events.jsonl") if '"event"' in line]
    assert [r["checkpoint"] for r in rows if r["event"] == "serve_load"] \
        == [str(tmp_path / "global_step2")]


def test_swap_params_moves_the_version_and_rolls_back(tmp_path):
    """swap_params between requests: the engine then generates what
    JAX's from_checkpoint of the newer tag generates, at ordinal 1. A
    swap that fails (the serve.swap_load fault point, a corrupt tag)
    raises and leaves the engine serving the same weights and
    version."""
    from deepspeed_tpu.inference import InferenceEngine as JaxEngine

    from deepspeed_tpu_torch import InferenceEngine
    from deepspeed_tpu_torch.runtime import fault
    cfg = _serving_tags(tmp_path)
    teng = InferenceEngine.from_checkpoint(
        str(tmp_path), _port_config(cfg), tag="global_step2",
        inference_config=PAGED_INF, dtype=torch.float32, device="cpu")
    before = teng.generate(PROMPTS, max_new_tokens=4)
    assert teng.swap_params(str(tmp_path)) == "global_step4"
    assert (teng.weight_version, teng.weight_ordinal) == \
        ("global_step4", 1)
    assert teng.debug_state()["weight_version"] == "global_step4"
    after = teng.generate(PROMPTS, max_new_tokens=4)
    ref = JaxEngine.from_checkpoint(str(tmp_path), cfg,
                                    tag="global_step4",
                                    inference_config=PAGED_INF,
                                    dtype=jnp.float32)
    assert after == ref.generate(PROMPTS, max_new_tokens=4)
    assert after != before
    fault.arm("serve.swap_load", exc=OSError("injected"))
    try:
        with pytest.raises(OSError, match="injected"):
            teng.swap_params(str(tmp_path), tag="global_step2")
    finally:
        fault.reset()
    fault.flip_byte(str(tmp_path / "global_step2" /
                        "model_states.shard_0.npz"))
    with pytest.raises(FileNotFoundError, match="no loadable"):
        teng.swap_params(str(tmp_path), tag="global_step2")
    assert (teng.weight_version, teng.weight_ordinal) == \
        ("global_step4", 1)
    assert teng.generate(PROMPTS, max_new_tokens=4) == after


@pytest.mark.parametrize("section", [
    {"supervisor": {"max_restarts": -1}},
    {"supervisor": {"backoff": -1.0}},
    {"save_dir": 5},
])
def test_checkpoint_config_checks_match_jax(section):
    """The JAX package's three checks of the ``checkpoint`` section, with
    its DeepSpeedConfigError, in both packages."""
    from deepspeed_tpu.runtime.config import DeepSpeedConfig as JConfig
    from deepspeed_tpu.runtime.config import \
        DeepSpeedConfigError as JConfigError

    from deepspeed_tpu_torch.runtime.config import (DeepSpeedConfig,
                                                    DeepSpeedConfigError)
    raw = {"train_micro_batch_size_per_gpu": 2, "checkpoint": section}
    with pytest.raises(JConfigError):
        JConfig(copy.deepcopy(raw))
    with pytest.raises(DeepSpeedConfigError):
        DeepSpeedConfig(copy.deepcopy(raw))


def test_checkpoint_config_reads_like_jax():
    from deepspeed_tpu.runtime.config import DeepSpeedConfig as JConfig

    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
    for section in ({}, {"keep_n": 2, "io_retries": 5, "save_dir": "ck",
                         "verify_checksums": False,
                         "io_retry_backoff": 0.0,
                         "supervisor": {"max_restarts": 0,
                                        "backoff": 0.5}}):
        raw = {"train_micro_batch_size_per_gpu": 2, "checkpoint": section}
        assert DeepSpeedConfig(copy.deepcopy(raw)).checkpoint_config == \
            JConfig(copy.deepcopy(raw)).checkpoint_config


@pytest.mark.parametrize("key", ["async_save", "drain_on_preemption"])
def test_async_save_and_drain_are_refused(key):
    """The JAX engine runs these; the port refuses them through the
    config and through initialize, naming the ROADMAP item that ports
    them, never saving without."""
    from deepspeed_tpu.runtime.config import DeepSpeedConfig as JConfig

    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
    raw = _ds_config("fp32", checkpoint={key: True})
    assert JConfig(copy.deepcopy(raw)).checkpoint_config[key] is True
    with pytest.raises(NotImplementedError, match="Queue 1 item 15"):
        DeepSpeedConfig(copy.deepcopy(raw))
    import deepspeed_tpu_torch
    with pytest.raises(NotImplementedError, match=f"checkpoint.{key}"):
        deepspeed_tpu_torch.initialize(
            model=lambda p, b: p["w"].sum(),
            model_parameters={"w": np.ones(3, np.float32)},
            config=copy.deepcopy(raw), device="cpu")
