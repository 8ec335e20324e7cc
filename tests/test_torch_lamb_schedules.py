"""The port's Lamb (deepspeed_tpu_torch/ops/optimizers.py) and lr schedules
(deepspeed_tpu_torch/runtime/lr_schedules.py) against the JAX package on
the CPU.

The same numpy params and grads go through both optimizers. Tolerances:
params, moments and trust ratios rtol 1e-6 (the same fp32 expressions,
fused differently). The schedules are the same formulas in float64 on
the port's side and fp32 on JAX's: rtol 1e-6 step by step.
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_threads  # noqa: F401  (torch threads per xdist worker)

from deepspeed_tpu.ops import optimizers as jopt
from deepspeed_tpu.runtime import lr_schedules as jls

from deepspeed_tpu_torch.ops import optimizers as topt
from deepspeed_tpu_torch.runtime import lr_schedules as tls

RTOL = 1e-6


def _tree(rng):
    """Params with a zero-norm leaf ("bias"), sorted so that the leaf order
    (JAX's sorted keys) is not the insertion order."""
    return {"w": rng.randn(6, 5).astype(np.float32),
            "bias": np.zeros(5, np.float32),
            "ln": {"g": (1 + 0.1 * rng.randn(5)).astype(np.float32)}}


def _grads(rng, tree, zero=()):
    return jax.tree_util.tree_map(
        lambda x: rng.randn(*x.shape).astype(np.float32), tree) | {
        k: np.zeros_like(tree[k]) for k in zero}


def _close(ours, theirs, rtol=RTOL, atol=1e-8):
    for o, t in zip(jax.tree_util.tree_leaves(ours),
                    jax.tree_util.tree_leaves(theirs)):
        np.testing.assert_allclose(np.asarray(o), np.asarray(t), rtol=rtol,
                                   atol=atol)


@pytest.mark.parametrize("kw", [
    dict(lr=2e-3, weight_decay=0.01, max_coeff=0.3, min_coeff=0.01),
    dict(lr=1e-2, betas=(0.8, 0.99), eps=1e-6),
    dict(lr=5e-3, weight_decay=0.1, bias_correction=False),
])
def test_lamb_update_and_coeffs_match_jax(kw):
    """Three Lamb steps: params, moments and the per-leaf trust ratios in
    leaf order, with a leaf whose weight norm is 0 (ratio 1.0) and, in
    the last step, one whose grad is 0 too. ``lamb_coeffs`` (the ratios
    the next update will take) equals the ratios JAX's update then takes;
    JAX's own ``lamb_coeffs`` applies bias correction whatever
    ``bias_correction`` says, so it equals them only when that is on."""
    rng = np.random.RandomState(0)
    p0 = _tree(rng)
    grads = [_grads(rng, p0), _grads(rng, p0), _grads(rng, p0, ("bias",))]
    jo, to = jopt.Lamb(**kw), topt.Lamb(**kw)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    js = jo.init(jp)
    tp = jax.tree_util.tree_map(lambda x: torch.from_numpy(x.copy()), p0)
    ts = to.init(tp)
    assert to.get_lamb_coeffs() == []
    for g in grads:
        predicted = to.lamb_coeffs(jax.tree_util.tree_map(torch.from_numpy,
                                                          g), ts, tp)
        if kw.get("bias_correction", True):
            np.testing.assert_allclose(predicted, jo.lamb_coeffs(
                jax.tree_util.tree_map(jnp.asarray, g), js, jp), rtol=RTOL)
        jp, js = jo.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        tp, ts = to.update(jax.tree_util.tree_map(torch.from_numpy, g), ts,
                           tp)
        taken = [float(c) for c in jo.get_lamb_coeffs()]
        np.testing.assert_allclose(to.get_lamb_coeffs(), taken, rtol=RTOL)
        np.testing.assert_allclose(predicted, taken, rtol=RTOL)
    assert ts.step == int(js.step) == 3
    _close(tp, jp)
    _close(ts.exp_avg, js.exp_avg)
    _close(ts.exp_avg_sq, js.exp_avg_sq)


def test_lamb_zero_norm_leaf_takes_unit_trust():
    """A leaf whose weights are all 0 takes trust 1.0 and a finite step
    (tests/unit/test_optimizers.py), and ``last_zero_norm`` names it; a
    leaf with a huge trust ratio is clamped to max_coeff."""
    opt = topt.Lamb(lr=1e-3, max_coeff=10.0, min_coeff=0.01)
    params = {"w": torch.full((8, 8), 100.0), "z": torch.zeros(4)}
    before = params["w"].clone()
    state = opt.init(params)
    opt.update({"w": torch.full((8, 8), 1e-6), "z": torch.ones(4)}, state,
               params)
    coeffs = dict(zip(("w", "z"), opt.get_lamb_coeffs()))
    assert coeffs["z"] == 1.0 and torch.isfinite(params["z"]).all()
    assert opt.last_zero_norm.tolist() == [False, True]
    assert coeffs["w"] == pytest.approx(10.0)
    delta = (before - params["w"]).numpy()
    assert (delta > 0).all() and delta.max() <= 1e-3 * 10.0 * 1.5


@pytest.mark.parametrize("cls", ["Adam", "Lamb"])
def test_momentum_override_matches_jax(cls):
    """``update(..., momentum=b)`` takes b for beta1 in the moment and in
    its bias correction (the OneCycle hook), as in JAX."""
    rng = np.random.RandomState(1)
    p0 = _tree(rng)
    grads = [_grads(rng, p0) for _ in range(2)]
    jo = getattr(jopt, cls)(lr=1e-2, weight_decay=0.01)
    to = getattr(topt, cls)(lr=1e-2, weight_decay=0.01)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    js = jo.init(jp)
    tp = jax.tree_util.tree_map(lambda x: torch.from_numpy(x.copy()), p0)
    ts = to.init(tp)
    for g, mom in zip(grads, (0.85, 0.95)):
        jp, js = jo.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp,
                           lr=3e-3, momentum=mom)
        tp, ts = to.update(jax.tree_util.tree_map(torch.from_numpy, g), ts,
                           tp, lr=3e-3, momentum=mom)
    _close(tp, jp)
    _close(ts.exp_avg, js.exp_avg)


@pytest.mark.parametrize("name,params", [
    ("lamb", {}),
    ("lamb", {"lr": 2e-3, "weight_decay": 0.01, "max_coeff": 0.3,
              "min_coeff": 0.01}),
    ("Lamb", {"betas": [0.8, 0.9], "eps": 1e-6, "bias_correction": False}),
    ("adamw", {}),
])
def test_build_optimizer_matches_jax(name, params):
    fields = ("lr", "b1", "b2", "eps", "weight_decay", "max_coeff",
              "min_coeff", "bias_correction", "adamw_mode")
    j = jopt.build_optimizer(name, dict(params))
    t = topt.build_optimizer(name, dict(params))
    assert type(t).__name__ == type(j).__name__
    assert {f: getattr(t, f, None) for f in fields} == \
        {f: getattr(j, f, None) for f in fields}
    assert topt.FusedLamb is topt.Lamb and topt.FusedAdam is topt.Adam


SCHEDULES = [
    ("WarmupLR", {"warmup_min_lr": 0, "warmup_max_lr": 2e-3,
                  "warmup_num_steps": 100}),         # bing_bert's (log)
    ("WarmupLR", {"warmup_min_lr": 1e-4, "warmup_max_lr": 1e-3,
                  "warmup_num_steps": 10, "warmup_type": "linear"}),
    ("WarmupLR", {"warmup_num_steps": 1}),
    ("LRRangeTest", {"lr_range_test_min_lr": 1e-3,
                     "lr_range_test_step_size": 4,
                     "lr_range_test_step_rate": 2.0}),
    ("LRRangeTest", {"lr_range_test_step_size": 3,
                     "lr_range_test_staircase": True}),
    ("OneCycle", {"cycle_min_lr": 1e-4, "cycle_max_lr": 1e-3,
                  "cycle_first_step_size": 10, "decay_lr_rate": 0.5,
                  "decay_step_size": 4, "decay_mom_rate": 0.1}),
    ("OneCycle", {"cycle_first_step_size": 6, "cycle_second_step_size": 9,
                  "cycle_first_stair_count": 3, "warmup_proportion": 0.1}),
]


@pytest.mark.parametrize("name,params", SCHEDULES)
def test_schedules_match_jax_step_by_step(name, params):
    """lr_at (and mom_at for OneCycle) at every step through warmup,
    cycle and decay, and the step()/get_lr()/state_dict() facade."""
    j = jls.build_lr_schedule(name, dict(params))
    t = tls.build_lr_schedule(name, dict(params))
    assert type(t).__name__ == name
    for step in range(-1, 40):
        np.testing.assert_allclose(t.lr_at(step),
                                   float(j.lr_at(jnp.asarray(step))),
                                   rtol=RTOL, atol=1e-12)
        if name == "OneCycle":
            np.testing.assert_allclose(t.mom_at(step),
                                       float(j.mom_at(jnp.asarray(step))),
                                       rtol=RTOL)
    assert t.get_lr() == [t.lr_at(0)]
    for _ in range(3):
        t.step()
        j.step()
    np.testing.assert_allclose(t.get_last_lr(), j.get_last_lr(), rtol=RTOL)
    assert t.state_dict() == j.state_dict() == {"last_batch_iteration": 2}
    t.load_state_dict({"last_batch_iteration": 7})
    assert t.last_batch_iteration == 7
    assert tls.build_lr_schedule(None, None) is None
    with pytest.raises(ValueError, match="Unknown scheduler"):
        tls.build_lr_schedule("Cosine", {})


def test_config_and_tuning_argument_helpers_match_jax():
    for mod in (jls, tls):
        assert mod.VALID_LR_SCHEDULES == ["LRRangeTest", "OneCycle",
                                          "WarmupLR"]
    for config in ({"type": "OneCycle", "params": {"cycle_max_lr": 0.3}},
                   {"type": "WarmupLR", "params": {"warmup_max_lr": 0.2}},
                   {"type": "LRRangeTest",
                    "params": {"lr_range_test_min_lr": 0.1}},
                   {"type": "Nope", "params": {}}, {"params": {}},
                   {"type": "WarmupLR"}):
        assert tls.get_lr_from_config(config) == \
            jls.get_lr_from_config(config)
    argv = ["--lr_schedule", "OneCycle", "--cycle_max_lr", "0.5",
            "--cycle_momentum", "--warmup_num_steps", "7"]
    args = [mod.add_tuning_arguments(argparse.ArgumentParser())
            .parse_args(argv) for mod in (jls, tls)]
    assert vars(args[0]) == vars(args[1])
    assert tls.get_config_from_args(args[1]) == \
        jls.get_config_from_args(args[0])
    assert tls.override_params(args[1], {}) == \
        jls.override_params(args[0], {})
    none = argparse.Namespace(lr_schedule=None)
    assert tls.get_config_from_args(none) == jls.get_config_from_args(none)


def test_onecycle_momentum_reaches_the_optimizer():
    """An engine whose schedule cycles momentum hands the optimizer
    ``mom_at(global_step)`` as beta1 at each boundary, the lr as
    ``lr_at(global_step)``: the update equals Adam's with those values,
    and get_lr()/get_mom() report them."""
    import deepspeed_tpu_torch
    sched = tls.OneCycle(cycle_min_lr=1e-3, cycle_max_lr=1e-2,
                         cycle_first_step_size=2, cycle_min_mom=0.8,
                         cycle_max_mom=0.9)
    w0 = np.linspace(-1, 1, 6).astype(np.float32)
    engine, opt, _, got_sched = deepspeed_tpu_torch.initialize(
        model=lambda p, b: ((p["w"] - b["x"]) ** 2).sum(),
        model_parameters={"w": w0}, lr_scheduler=sched, device="cpu",
        config={"train_micro_batch_size_per_gpu": 1,
                "optimizer": {"type": "Adam", "params": {"lr": 1.0}}})
    assert got_sched is sched
    ref = topt.Adam(lr=1.0)
    rp = {"w": torch.from_numpy(w0.copy())}
    rs = ref.init(rp)
    x = torch.from_numpy(np.full(6, 0.5, np.float32))
    for step in range(4):
        assert engine.get_lr() == [sched.lr_at(step)]
        assert engine.get_mom() == [sched.mom_at(step)]
        engine.train_batch(iter([{"x": x}]))
        g = {"w": 2 * (rp["w"] - x)}
        rp, rs = ref.update(g, rs, rp, lr=sched.lr_at(step),
                            momentum=sched.mom_at(step))
        torch.testing.assert_close(engine.module_params["w"].detach(),
                                   rp["w"], rtol=0, atol=0)
