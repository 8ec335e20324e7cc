"""ZeRO-Offload in the port (``ops/adam/cpu_adam.py`` over
``csrc/adam/cpu_adam.cpp``, the engine's offload path) against the JAX
package on the CPU.

Both packages build the same C++ source, so the port's
``DeepSpeedCPUAdam`` is held bitwise to JAX's on the same inputs (the bf16
output included), and within JAX's own tolerance (rtol 1e-4, atol 1e-5,
``tests/unit/test_cpu_adam.py``) to the port's plain ``Adam``. The offload
engine trains the tiny GPT-2 of ``tests/torch_dist_worker.py`` in fp32
against JAX's offload engine (losses rtol 1e-5, params atol 1e-4, the
trajectory tolerance of ``PERF.md`` section 2), at dp 1 and on two gloo
ranks against ``{"data": 2}``.
"""

import os

import jax
import numpy as np
import pytest
import torch

import tests.torch_threads  # noqa: F401  (torch threads per xdist worker)
from tests import torch_dist_worker as W
from tests.test_torch_zero import (_batches, _close_params, _jax_loss,
                                   _jax_tree)

LR = 3e-3


def _offload_config(ga=1, overlap=False, micro=2, **extra):
    return dict({"train_micro_batch_size_per_gpu": micro,
                 "gradient_accumulation_steps": ga,
                 "gradient_clipping": 1.0, "steps_per_print": 1000,
                 "optimizer": {"type": "Adam", "params": {"lr": LR}},
                 "zero_optimization": {"stage": 2, "cpu_offload": True,
                                       "overlap_comm": overlap}}, **extra)


def _jax_engine(tree, config, data=1):
    import deepspeed_tpu
    eng, *_ = deepspeed_tpu.initialize(
        model=_jax_loss(), model_parameters=tree,
        config=dict(config, mesh={"axes": {"data": data}}))
    return eng


def _port_engine(tree, config):
    import deepspeed_tpu_torch
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=W.loss_fn(), model_parameters=tree, config=config,
        device="cpu")
    return eng


def _params_of(rng, sizes=(("b", (3,)), ("w", (2049,)))):
    return {k: rng.randn(*s).astype(np.float32) for k, s in sizes}


def test_library_builds_from_the_repo_source():
    from deepspeed_tpu_torch.ops import _build
    from deepspeed_tpu_torch.ops.adam.cpu_adam import SOURCE, load_library
    lib = load_library()
    assert lib.ds_adam_simd_width() in (1, 8, 16)
    assert SOURCE.endswith(os.path.join("csrc", "adam", "cpu_adam.cpp"))
    so = _build.build_host(SOURCE)
    assert so.startswith(_build.BUILD_DIR) and os.path.isfile(so)


@pytest.mark.parametrize("wd,adamw,bf16", [(0.0, True, False),
                                           (0.01, True, False),
                                           (0.01, False, False),
                                           (0.01, True, True)])
def test_cpu_adam_bitwise_jax(wd, adamw, bf16):
    """Ten steps of the port's DeepSpeedCPUAdam equal JAX's bit for bit:
    the masters, both moments and (bf16_out) the bf16 output."""
    from deepspeed_tpu.ops.adam import DeepSpeedCPUAdam as JAdam
    from deepspeed_tpu_torch.ops.adam import DeepSpeedCPUAdam
    rng = np.random.RandomState(0)
    params = _params_of(rng)
    port = DeepSpeedCPUAdam(params, lr=1e-2, weight_decay=wd,
                            adamw_mode=adamw)
    ref = JAdam(params, lr=1e-2, weight_decay=wd, adamw_mode=adamw)
    assert port.uses_native_kernel and ref.uses_native_kernel
    for step in range(10):
        grads = _params_of(rng)
        lr = 1e-2 * (step + 1) / 10
        got = port.step(grads, lr=lr, bf16_out=bf16)
        want = ref.step(grads, lr=lr, bf16_out=bf16)
        for k in params:
            g = got[k]
            if bf16:
                assert g.dtype == torch.bfloat16
                np.testing.assert_array_equal(
                    g.view(torch.int16).numpy().view(np.uint16),
                    np.asarray(want[k]).view(np.uint16))
            else:
                np.testing.assert_array_equal(g.numpy(), want[k])
    for a, b in ((port.master_params, ref.master_params),
                 (port.exp_avg, ref.exp_avg),
                 (port.exp_avg_sq, ref.exp_avg_sq)):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("wd,adamw", [(0.0, True), (0.01, True),
                                      (0.01, False)])
def test_cpu_adam_within_tolerance_of_plain_adam(wd, adamw):
    """Against the port's device Adam (the plain version), within JAX's
    tolerance for this comparison."""
    from deepspeed_tpu_torch.ops.adam import DeepSpeedCPUAdam
    from deepspeed_tpu_torch.ops.optimizers import Adam
    rng = np.random.RandomState(1)
    params = _params_of(rng)
    opt = DeepSpeedCPUAdam(params, lr=1e-2, weight_decay=wd,
                           adamw_mode=adamw)
    plain = Adam(lr=1e-2, weight_decay=wd, adamw_mode=adamw)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    st = plain.init(tp)
    for _ in range(10):
        grads = _params_of(rng)
        out = opt.step(grads)
        tp, st = plain.update({k: torch.from_numpy(v)
                               for k, v in grads.items()}, st, tp)
    for k in params:
        np.testing.assert_allclose(out[k].numpy(), tp[k].numpy(),
                                   rtol=1e-4, atol=1e-5)


def test_state_dict_round_trips():
    from deepspeed_tpu_torch.ops.adam import DeepSpeedCPUAdam
    rng = np.random.RandomState(2)
    params = _params_of(rng)
    a = DeepSpeedCPUAdam(params, lr=1e-2)
    g = _params_of(rng)
    a.step(g)
    sd = a.state_dict()
    b = DeepSpeedCPUAdam(params, lr=1e-2)
    b.load_state_dict(sd)
    assert b.step_count == 1
    x, y = a.step(g), b.step(g)
    for k in params:
        np.testing.assert_array_equal(x[k].numpy(), y[k].numpy())


def test_a_failed_build_raises(tmp_path):
    """No numpy fallback: a missing source and one the compiler refuses
    both raise (the JAX package's loader would return None and step in
    numpy)."""
    from deepspeed_tpu_torch.ops.adam.cpu_adam import load_library
    with pytest.raises(FileNotFoundError):
        load_library(str(tmp_path / "missing.cpp"))
    bad = tmp_path / "bad.cpp"
    bad.write_text("int f( {\n")
    with pytest.raises(RuntimeError, match="failed"):
        load_library(str(bad))


def _trajectory(engine, batches, steps, per_window=False):
    it = iter(batches)
    losses, windows = [], []
    for _ in range(steps):
        losses.append(float(engine.train_batch(it)))
        if per_window:
            windows.append(W.host(engine.params) if hasattr(engine, "master")
                           else jax.tree_util.tree_map(
                               np.asarray, engine.state.params))
    return losses, windows


@pytest.mark.parametrize("ga", [1, 2])
def test_offload_engine_matches_jax(ga):
    """The direct path (ga 1: compute-dtype grads, no accumulator) and the
    accumulator path (ga 2) take JAX's offload steps; the host holds the
    masters and the device no Adam moments."""
    tree = _jax_tree()
    batches = _batches(70 + ga, 3 * ga, rows=2)
    config = _offload_config(ga=ga)
    jeng = _jax_engine(tree, config)
    teng = _port_engine(tree, config)
    assert teng.zero_cpu_offload and teng._offload_direct == (ga == 1)
    assert teng.accum_grads is None if ga == 1 else teng.accum_grads
    assert teng.opt_state == () and teng.master is None
    jl, _ = _trajectory(jeng, batches, 3)
    tl, _ = _trajectory(teng, batches, 3)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    _close_params(W.host(teng.module_params),
                  jax.tree_util.tree_map(np.asarray, jeng.module_params))
    for a, b in zip(teng.optimizer.master_params,
                    jeng.optimizer.master_params):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
    assert teng.global_steps == jeng.global_steps == 3


def test_overlap_one_window_delay_matches_jax():
    """``overlap_comm``: after window 1 the params are the initial ones,
    after window 2 the synchronous engine's after window 1, in both
    packages; ``synchronize`` applies the pending update."""
    tree = _jax_tree()
    batches = _batches(80, 3, rows=2)
    jeng = _jax_engine(tree, _offload_config(overlap=True))
    teng = _port_engine(tree, _offload_config(overlap=True))
    sync = _port_engine(tree, _offload_config())
    assert teng._offload_overlap
    tl, tw = _trajectory(teng, batches, 2, per_window=True)
    jl, jw = _trajectory(jeng, batches, 2, per_window=True)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    _close_params(tw[0], tree, atol=0)
    _close_params(tw[1], jw[1])
    _, sw = _trajectory(sync, batches, 1, per_window=True)
    _close_params(tw[1], sw[0], atol=0)
    assert teng._offload_pending is not None and teng.global_steps == 1
    teng.synchronize()
    jeng.synchronize()
    assert teng._offload_pending is None and teng.global_steps == 2
    _close_params(W.host(teng.module_params),
                  jax.tree_util.tree_map(np.asarray, jeng.module_params))


def test_module_params_warn_while_an_update_is_in_flight():
    import logging
    from deepspeed_tpu_torch.utils.logging import logger
    tree = _jax_tree()
    teng = _port_engine(tree, _offload_config(overlap=True))
    teng.train_batch(iter(_batches(81, 1, rows=2)))
    seen = []
    handler = logging.Handler()
    handler.emit = lambda record: seen.append(record.getMessage())
    logger.addHandler(handler)
    try:
        teng.module_params
        teng.module_params
    finally:
        logger.removeHandler(handler)
    assert sum("one window stale" in m for m in seen) == 1
    teng.eval_batch(_batches(82, 1, rows=2)[0])     # eval drains
    assert teng._offload_pending is None and teng.global_steps == 1
    teng.close()


def test_offload_tags_pass_between_the_packages(tmp_path):
    """A port offload tag (with ``cpu_optim_states.npz``) loads in JAX's
    offload engine and a JAX one in the port's: the next step agrees;
    a tag without the npz raises JAX's FileNotFoundError, and
    ``load_optimizer_states=False`` re-seeds the host masters from the
    loaded weights."""
    tree = _jax_tree()
    batches = _batches(90, 4, rows=2)
    teng = _port_engine(tree, _offload_config(overlap=True))
    _trajectory(teng, batches[:2], 2)
    port_dir = str(tmp_path / "port")
    tag = teng.save_checkpoint(port_dir)       # drains first
    assert teng.global_steps == 2
    assert os.path.isfile(os.path.join(tag, "cpu_optim_states.npz"))
    with np.load(os.path.join(tag, "cpu_optim_states.npz")) as z:
        keys = set(z.files)
    n = len(teng.optimizer.master_params)
    assert keys == {"step"} | {f"{p}_{i}" for p in ("mp", "m", "v")
                               for i in range(n)}
    jeng = _jax_engine(tree, _offload_config())
    jeng.load_checkpoint(port_dir)
    assert jeng.optimizer.step_count == 2 and jeng.global_steps == 2
    for a, b in zip(teng.optimizer.master_params,
                    jeng.optimizer.master_params):
        np.testing.assert_array_equal(a, b)
    t2 = _port_engine(tree, _offload_config())
    t2.load_checkpoint(port_dir)
    jl, _ = _trajectory(jeng, batches[2:], 1)
    tl, _ = _trajectory(t2, batches[2:], 1)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    # JAX -> port
    jax_dir = str(tmp_path / "jax")
    jeng.save_checkpoint(jax_dir)
    t3 = _port_engine(tree, _offload_config())
    t3.load_checkpoint(jax_dir)
    assert t3.optimizer.step_count == 3 and t3.global_steps == 3
    for a, b in zip(t3.optimizer.master_params,
                    jeng.optimizer.master_params):
        np.testing.assert_array_equal(a, b)
    # a tag of a run without offload
    plain_dir = str(tmp_path / "plain")
    dev = _port_engine(tree, dict(_offload_config(), zero_optimization={
        "stage": 2}))
    _trajectory(dev, batches[:1], 1)
    dev.save_checkpoint(plain_dir)
    t4 = _port_engine(tree, _offload_config())
    with pytest.raises(FileNotFoundError, match="cpu_optim_states.npz"):
        t4.load_checkpoint(plain_dir, tag="global_step1")
    t4.load_checkpoint(plain_dir, tag="global_step1",
                       load_optimizer_states=False)
    for m, p in zip(t4.optimizer.master_params,
                    jax.tree_util.tree_leaves(W.host(dev.module_params))):
        np.testing.assert_array_equal(m, p.ravel())


@pytest.fixture(scope="module")
def dp2_offload():
    """Two gloo ranks running offload at ga 1, at ga 2, and overlapped."""
    tree = _jax_tree()
    cases = [{"name": name, "config": _offload_config(ga=ga, overlap=ov),
              "steps": 3, "batches": _batches(100 + ga + 3 * ov, 3 * ga)}
             for name, ga, ov in (("ga1", 1, False), ("ga2", 2, False),
                                  ("overlap", 1, True))]
    from deepspeed_tpu_torch.ops.adam.cpu_adam import load_library
    load_library()          # built once here, before the ranks load it
    ranks = W.spawn("train", 2, {"params": tree, "cases": cases})
    return tree, {c["name"]: c for c in cases}, ranks


@pytest.mark.parametrize("name", ["ga1", "ga2", "overlap"])
def test_offload_dp2_matches_jax(dp2_offload, name):
    """Each rank's host Adam updates its own master shard; the gathered
    params take JAX's steps at ``{"data": 2}`` (the overlapped run one
    window behind, as JAX's)."""
    tree, cases, ranks = dp2_offload
    r0, r1 = ranks[0][name], ranks[1][name]
    assert r0["losses"] == r1["losses"]
    _close_params(r0["params"], r1["params"], atol=0)
    total = sum(m.size for m in r0["masters"] + r1["masters"])
    replicated = W.EXTRA_SHAPE[0] * W.EXTRA_SHAPE[1]
    assert total == sum(np.size(x) for x in jax.tree_util.tree_leaves(tree)) \
        + replicated           # the shards, and the replicated leaf twice
    case = cases[name]
    jeng = _jax_engine(tree, dict(case["config"]), data=2)
    jl, _ = _trajectory(jeng, case["batches"], 3)
    np.testing.assert_allclose(r0["losses"], jl, rtol=1e-5)
    jeng.synchronize()
    _close_params(r0["params"],
                  jax.tree_util.tree_map(np.asarray, jeng.module_params))
