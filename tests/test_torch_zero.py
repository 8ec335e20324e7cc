"""ZeRO over a process group in the port (``runtime/zero/sharding.py``,
the engine's ZeRO paths) against the JAX package on the CPU.

Two gloo ranks, spawned once for the module (``tests/torch_dist_worker.py``),
train a tiny GPT-2 in fp32 (vocab 255, so ZeRO shards wte on its second
dim, plus a (3, 5) leaf that divides by no data degree and stays
replicated) at ZeRO stages 0, 1 and 2, at ga 1 and 2, with clipping 1.0;
the JAX engine trains the same params on the same global batches at
``{"data": 2}`` (2 of the conftest's 8 CPU devices). Tolerances, as
``PERF.md`` section 2's trajectories: losses rtol 1e-5, params atol 1e-4.

Dropout cannot draw the same masks in both packages (the JAX engine's
seeds come from ``jax.random`` keys), so the dp-2 run with dropout is
held to the port's own dp-1 run over the global batch: equal masks come
from a rank hashing its rows' global indices, which is what JAX's sharded
program draws.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_threads  # noqa: F401  (torch threads per xdist worker)
from tests import torch_dist_worker as W

STEPS = 3
MICRO, DP = 2, 2
LR = 3e-3


def _jax_tree():
    from deepspeed_tpu.models.gpt2 import GPT2Config, init_gpt2_params
    tree = init_gpt2_params(GPT2Config(**W.MODEL), jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.array, tree)
    tree["extra"] = W.extra_leaf()
    return tree


def _jax_loss():
    from deepspeed_tpu.models.gpt2 import GPT2Config, gpt2_loss_fn
    base = gpt2_loss_fn(GPT2Config(**W.MODEL), dtype=jnp.float32,
                        deterministic=True)

    def fn(params, batch, rng):
        core = {k: v for k, v in params.items() if k != "extra"}
        return base(core, batch, rng) + \
            W.EXTRA_WEIGHT * jnp.sum(params["extra"] ** 2)
    return fn


def _config(stage, ga, **extra):
    return dict({"train_micro_batch_size_per_gpu": MICRO,
                 "gradient_accumulation_steps": ga,
                 "gradient_clipping": 1.0, "steps_per_print": 1000,
                 "optimizer": {"type": "Adam", "params": {"lr": LR}},
                 "zero_optimization": {"stage": stage}}, **extra)


def _batches(seed, n, rows=MICRO * DP):
    rng = np.random.RandomState(seed)
    return [{"input_ids": rng.randint(0, W.MODEL["vocab_size"],
                                      (rows, 33)).astype(np.int32)}
            for _ in range(n)]


def _jax_run(tree, config, batches, steps=STEPS, data=DP, load=None,
             save=None):
    import deepspeed_tpu
    eng, *_ = deepspeed_tpu.initialize(
        model=_jax_loss(), model_parameters=tree,
        config=dict(config, mesh={"axes": {"data": data}}))
    assert eng.dp_world_size == data
    if load is not None:
        eng.load_checkpoint(load)
    it = iter(batches)
    losses = [float(eng.train_batch(it)) for _ in range(steps)]
    if save is not None:
        eng.save_checkpoint(save)
    return losses, jax.tree_util.tree_map(np.asarray, eng.module_params)


CASES = [(stage, ga) for stage in (0, 1, 2) for ga in (1, 2)]
# the bing_bert config's optimizer over ZeRO shards: its trust ratios take
# each whole leaf's norm (the shards' squares summed over the ranks)
LAMB = {"optimizer": {"type": "Lamb", "params": {"lr": LR}}}
LAMB_CASES = [(1, 1), (2, 2)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One spawn of 2 gloo ranks for every dp-2 case of the module, and
    the JAX dp-2 tag one of them loads (written first)."""
    root = tmp_path_factory.mktemp("zero")
    tree = _jax_tree()
    jax_tag_dir = str(root / "jax_tag")
    jax_batches = _batches(50, 3 * 2)
    _jax_run(tree, _config(2, 2), jax_batches[:4], steps=2,
             save=jax_tag_dir)
    cases = [{"name": f"s{s}ga{g}", "config": _config(s, g),
              "steps": STEPS, "batches": _batches(10 * s + g, STEPS * g)}
             for s, g in CASES]
    cases += [{"name": f"lamb_s{s}ga{g}", "config": _config(s, g, **LAMB),
               "steps": STEPS, "batches": _batches(30 + 10 * s + g,
                                                   STEPS * g)}
              for s, g in LAMB_CASES]
    cases.append({"name": "dropout", "config": _config(1, 1),
                  "steps": STEPS, "batches": _batches(40, STEPS),
                  "dropout": True, "seed": 3})
    cases.append({"name": "save", "config": _config(2, 2), "steps": 2,
                  "batches": _batches(41, 4), "save": str(root / "port")})
    cases.append({"name": "load_jax", "config": _config(2, 2), "steps": 1,
                  "batches": jax_batches[4:], "load": jax_tag_dir})
    ranks = W.spawn("train", DP, {"params": tree, "cases": cases})
    return {"tree": tree, "ranks": ranks, "cases":
            {c["name"]: c for c in cases}, "jax_tag": jax_tag_dir,
            "jax_batches": jax_batches}


def _close_params(got, want, atol=1e-4):
    assert sorted(got) == sorted(want)
    for k in got:
        if isinstance(got[k], dict):
            _close_params(got[k], want[k], atol)
        else:
            np.testing.assert_allclose(got[k], np.asarray(want[k]),
                                       rtol=0, atol=atol, err_msg=k)


def _equal_params(a, b):
    for x, y in zip(jax.tree_util.tree_leaves(a),
                    jax.tree_util.tree_leaves(b)):
        np.testing.assert_array_equal(x, y)


def _gpt2_jax_specs(dp, llama=False):
    """(shape, JAX's leaf_partition_spec) of every leaf of tiny GPT-2 or
    tiny Llama."""
    from deepspeed_tpu.runtime.zero.sharding import leaf_partition_spec
    if llama:
        from deepspeed_tpu.models.llama import LlamaConfig, init_llama_params
        from tests.test_torch_llama_training import LLAMA_TINY
        tree = init_llama_params(LlamaConfig(**LLAMA_TINY),
                                 jax.random.PRNGKey(0))
    else:
        tree = _jax_tree()
    return [(np.shape(x), leaf_partition_spec(np.shape(x), "data", dp))
            for x in jax.tree_util.tree_leaves(tree)]


@pytest.mark.parametrize("model", ["gpt2", "llama"])
@pytest.mark.parametrize("dp", [2, 4])
def test_shard_dims_equal_leaf_partition_spec(model, dp):
    """Every leaf's shard dim is the dim JAX's ``leaf_partition_spec``
    gives the data axis (None where it replicates), and the port's spec
    tuple is JAX's."""
    from deepspeed_tpu_torch.runtime.zero.sharding import (
        leaf_partition_spec, zero_shard_dims)
    pairs = _gpt2_jax_specs(dp, llama=model == "llama")
    dims = zero_shard_dims([s for s, _ in pairs], dp, stage=2)
    for (shape, spec), d in zip(pairs, dims):
        want = list(spec).index("data") if "data" in spec else None
        assert d == want, (shape, spec, d)
        assert leaf_partition_spec(shape, "data", dp) == tuple(spec)
    assert any(d is None for d in dims) or model == "llama"
    assert zero_shard_dims([s for s, _ in pairs], dp, stage=0) == \
        [None] * len(pairs)


@pytest.mark.parametrize("stage,ga", CASES)
def test_trajectory_matches_jax_dp2(runs, stage, ga):
    """Both ranks report the same losses and params; they are JAX's at
    ``{"data": 2}`` on the same global batches."""
    name = f"s{stage}ga{ga}"
    r0, r1 = (r[name] for r in runs["ranks"])
    assert r0["dp"] == r1["dp"] == DP and (r0["rank"], r1["rank"]) == (0, 1)
    assert r0["losses"] == r1["losses"]
    _equal_params(r0["params"], r1["params"])
    case = runs["cases"][name]
    jl, jp = _jax_run(runs["tree"], case["config"], case["batches"])
    np.testing.assert_allclose(r0["losses"], jl, rtol=1e-5)
    _close_params(r0["params"], jp)
    # stage 0 replicates everything; stages 1-2 shard all but "extra"
    # (the first leaf) and wte on its second dim
    if stage == 0:
        assert r0["dims"] == [None] * len(r0["dims"])
    else:
        shapes = [np.shape(x) for x in jax.tree_util.tree_leaves(
            runs["tree"])]
        assert len(r0["dims"]) == len(shapes)
        assert r0["dims"][shapes.index(W.EXTRA_SHAPE)] is None
        wte = shapes.index((W.MODEL["vocab_size"], W.MODEL["hidden_size"]))
        assert r0["dims"][wte] == 1
    assert r0["global_steps"] == STEPS


@pytest.mark.parametrize("stage,ga", LAMB_CASES)
def test_lamb_over_shards_matches_jax_dp2(runs, stage, ga):
    """Lamb at ZeRO 1 and 2 on two ranks takes JAX's steps at
    ``{"data": 2}``: each trust ratio from the whole leaf's norms."""
    name = f"lamb_s{stage}ga{ga}"
    r0, r1 = (r[name] for r in runs["ranks"])
    assert r0["losses"] == r1["losses"]
    _equal_params(r0["params"], r1["params"])
    case = runs["cases"][name]
    jl, jp = _jax_run(runs["tree"], case["config"], case["batches"])
    np.testing.assert_allclose(r0["losses"], jl, rtol=1e-5)
    _close_params(r0["params"], jp)


def test_dropout_draws_the_global_rows(runs):
    """ZeRO 1 at dp 2 with dropout 0.1 takes the steps one process takes
    over the global batch with the same seed: each rank draws its rows'
    masks of the global batch (the functional dropouts' counters and the
    attention kernels' ``b * H + h`` offset by the rank's first row)."""
    import deepspeed_tpu_torch
    case = runs["cases"]["dropout"]
    r0 = runs["ranks"][0]["dropout"]
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=W.loss_fn(dropout=True), model_parameters=runs["tree"],
        config=dict(case["config"], train_micro_batch_size_per_gpu=MICRO * DP),
        device="cpu", seed=case["seed"])
    it = iter(case["batches"])
    losses = [float(eng.train_batch(it)) for _ in range(STEPS)]
    np.testing.assert_allclose(r0["losses"], losses, rtol=1e-5)
    _close_params(r0["params"], W.host(eng.module_params))
    # and the masks did act: without dropout the losses differ
    eng2, *_ = deepspeed_tpu_torch.initialize(
        model=W.loss_fn(), model_parameters=runs["tree"],
        config=dict(case["config"], train_micro_batch_size_per_gpu=MICRO * DP),
        device="cpu", seed=case["seed"])
    it = iter(case["batches"])
    plain = [float(eng2.train_batch(it)) for _ in range(STEPS)]
    assert abs(plain[0] - losses[0]) > 1e-3


def test_dp2_tag_loads_in_jax_and_at_dp1(runs, tmp_path):
    """A tag the two ranks saved (ZeRO 2, rank 0 writing whole arrays)
    holds one chunk per leaf, loads in the JAX engine and in a dp-1 port
    engine, each taking the saved params and moments bitwise, and both
    take the same next step."""
    import deepspeed_tpu
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.runtime import checkpoint as ckpt
    r0 = runs["ranks"][0]["save"]
    tag = r0["tag"]
    assert runs["ranks"][1]["save"]["tag"] == tag
    ok, problems = ckpt.verify_checkpoint_dir(tag)
    assert ok, problems
    with open(os.path.join(tag, "meta.json")) as f:
        meta = json.load(f)
    assert meta["dp_world_size"] == DP and meta["zero_stage"] == 2
    assert meta["global_step"] == 2
    with open(os.path.join(tag, "model_states.shard_0.json")) as f:
        manifest = json.load(f)
    assert all(len(e["chunks"]) == 1 for e in manifest.values())
    config = _config(2, 1)
    jeng, *_ = deepspeed_tpu.initialize(
        model=_jax_loss(), model_parameters=runs["tree"],
        config=dict(config, mesh={"axes": {"data": 1}},
                    train_micro_batch_size_per_gpu=MICRO * DP))
    jeng.load_checkpoint(os.path.dirname(tag))
    _close_params(r0["params"], jeng.module_params, atol=0)
    teng, *_ = deepspeed_tpu_torch.initialize(
        model=W.loss_fn(), model_parameters=runs["tree"],
        config=dict(config, train_micro_batch_size_per_gpu=MICRO * DP),
        device="cpu")
    teng.load_checkpoint(os.path.dirname(tag))
    _close_params(r0["params"], W.host(teng.module_params), atol=0)
    assert teng.global_steps == jeng.global_steps == 2
    jax_v = jax.tree_util.tree_leaves(jeng.state.opt_state.exp_avg_sq)
    for t, j in zip(tree_leaves_port(teng.opt_state.exp_avg_sq), jax_v):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    nxt = _batches(60, 1)
    jl = float(jeng.train_batch(iter(nxt)))
    tl = float(teng.train_batch(iter(nxt)))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)


def tree_leaves_port(tree):
    from deepspeed_tpu_torch.utils.tree import tree_leaves
    return list(tree_leaves(tree))


def test_jax_dp2_tag_loads_at_port_dp2(runs):
    """A tag the JAX engine wrote at ``{"data": 2}`` (ZeRO 2: several
    chunks a leaf) loads on the two ranks, each taking its shards; their
    next step is JAX's."""
    r0 = runs["ranks"][0]["load_jax"]
    assert r0["global_steps"] == 3
    batches = runs["jax_batches"]
    jl, jp = _jax_run(runs["tree"], _config(2, 2), batches[4:], steps=1,
                      load=runs["jax_tag"])
    np.testing.assert_allclose(r0["losses"], jl, rtol=1e-5)
    _close_params(r0["params"], jp)
    _equal_params(r0["params"], runs["ranks"][1]["load_jax"]["params"])


def test_zero_supported_optimizers():
    from deepspeed_tpu_torch.ops.adam import DeepSpeedCPUAdam
    from deepspeed_tpu_torch.ops.optimizers import Adam, Lamb, Optimizer
    from deepspeed_tpu_torch.runtime.zero.utils import \
        is_zero_supported_optimizer
    assert is_zero_supported_optimizer(Adam())
    assert is_zero_supported_optimizer(Lamb())
    assert is_zero_supported_optimizer(DeepSpeedCPUAdam(
        {"w": np.zeros(4, np.float32)}))
    assert not is_zero_supported_optimizer(Optimizer())


@pytest.mark.parametrize("world", [1, 2])
def test_stage3_raises_naming_its_item(world):
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
    with pytest.raises(NotImplementedError, match="Queue 1 item 18"):
        DeepSpeedConfig({"train_micro_batch_size_per_gpu": 2,
                         "zero_optimization": {"stage": 3}},
                        world_size=world)


@pytest.mark.parametrize("axes", [{"data": 2, "model": 2},
                                  {"pipe": 2, "data": 1},
                                  {"seq": 2}])
def test_model_pipe_seq_axes_raise_naming_items(axes):
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
    with pytest.raises(NotImplementedError, match="items 14 and 16"):
        DeepSpeedConfig({"train_micro_batch_size_per_gpu": 2,
                         "mesh": {"axes": axes}}, world_size=4)


def test_mesh_larger_or_smaller_than_the_world_raises():
    """One process with no group is a world of one: a data axis of 2
    raises (JAX would take 2 of its devices; the port runs one process
    per device, and every process must hold a place in the mesh)."""
    from deepspeed_tpu_torch.parallel.mesh import build_mesh
    with pytest.raises(ValueError, match="one process per device"):
        build_mesh({"data": 2}, "cpu")
    mesh = build_mesh({"data": 1, "model": 1}, "cpu")
    assert tuple(mesh.mesh_dim_names) == ("data", "model")


def test_zero_partition_collectives_without_a_group_are_the_identity():
    """One process, no group: a shard is the whole leaf, the reduce is the
    grad itself, and the gather copies."""
    from deepspeed_tpu_torch.runtime.zero.sharding import ZeroPartition
    part = ZeroPartition([(4, 6), (3,)], dp=1, rank=0, stage=2)
    assert part.dims == [None, None] and not part.live
    g = torch.randn(4, 6)
    assert part.reduce_scatter(0, g) is g
    out = torch.empty(4, 6)
    part.all_gather(0, g, out)
    assert torch.equal(out, g)
    assert torch.equal(part.shard(0, g), g)
    with pytest.raises(RuntimeError, match="process group"):
        ZeroPartition([(4, 6)], dp=2, rank=0, stage=2)



@pytest.mark.parametrize("stage", [1, 2])
def test_zero_at_one_data_rank_takes_stage0s_step(stage):
    """One data rank: ZeRO 1-2 have nothing to shard and take stage 0's
    step (fp32 params cast per forward, no second copy of the params on
    the device), bitwise stage 0's in bf16 at ga 2 with clipping; over
    more ranks they take the sharded step (``test_trajectory_matches_jax_
    dp2``), and offload takes it at any."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, gpt2_loss_fn
    from deepspeed_tpu_torch.utils.tree import tree_leaves
    tree = {k: v for k, v in _jax_tree().items() if k != "extra"}
    batches = _batches(3, 2 * STEPS, rows=MICRO)

    def run(zero):
        eng, *_ = deepspeed_tpu_torch.initialize(
            model=gpt2_loss_fn(GPT2Config(**W.MODEL), dtype=torch.bfloat16,
                               deterministic=True),
            model_parameters=tree, device="cpu",
            config=_config(zero, 2, bf16={"enabled": True}))
        it = iter(batches)
        return eng, [float(eng.train_batch(it)) for _ in range(STEPS)]

    ref, ref_losses = run(0)
    eng, losses = run(stage)
    assert eng.zero_optimization_stage() == stage
    assert not eng._sharded and eng.master is None
    assert losses == ref_losses
    for t, r in zip(tree_leaves(eng.module_params),
                    tree_leaves(ref.module_params)):
        assert t.dtype == torch.float32 and torch.equal(t, r)
