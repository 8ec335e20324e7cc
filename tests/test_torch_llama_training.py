"""Llama training in the port (``models.llama.llama_loss_fn``, per-block
remat, the stacked ``scan_layers`` layout) and GPT-2's remat, against the
JAX package on the CPU, at ``LLAMA_TINY`` (examples/llama/train.py: 4
layers, 4 heads over 2 kv heads, hidden 64, vocab 512) at seq 32.

The same parameters (made by the JAX init from a seed and carried across
through numpy) and the same token ids go through both. The JAX side's
flash attention runs its Pallas kernels in interpret mode; the port's
runs the masked-flash kernels' plain versions. Tolerances:

- fp32: loss rtol 1e-5, grads within 1e-4 of each grad's largest entry
  (sums run in another order);
- bf16 compute over fp32 masters: the BERT row's, loss rtol 2e-3 and
  each grad within a relative RMS error of 2e-2 (bf16 activations
  rounded after differently ordered fp32 sums);
- the 5-step trajectory under ``ds_config_zero2.json``'s Adam (betas
  0.9/0.95, weight decay 0.1), WarmupLR and clipping 1.0, in fp32:
  every loss within rtol 1e-5, the final params within 1e-4 absolute;
- GPT-2's remat against its own non-remat path at dropout 0.1: the
  recompute runs the same ops on the same inputs and draws the same
  hash masks, so loss and grads are held to 1e-6 relative.
"""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_threads  # noqa: F401  (torch threads per xdist worker)

REPO = pathlib.Path(__file__).resolve().parents[1]
LLAMA_TINY = dict(vocab_size=512, hidden_size=64, num_layers=4,
                  num_heads=4, num_kv_heads=2, max_position_embeddings=128)
S, B = 32, 2
TOLS = {"fp32": dict(loss=1e-5, grad_max=1e-4),
        "bf16": dict(loss=2e-3, grad_rms=2e-2)}


def _jax_tree(scan=False, seed=0):
    from deepspeed_tpu.models.llama import LlamaConfig, init_llama_params
    return init_llama_params(LlamaConfig(scan_layers=scan, **LLAMA_TINY),
                             jax.random.PRNGKey(seed))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _torch_tree(np_tree):
    """The JAX tree's leaves as fp32 torch leaves, in its own layout."""
    from deepspeed_tpu_torch.utils.tree import tree_map
    return tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)),
                    np_tree)


def _ids(seed, n=1):
    rng = np.random.RandomState(seed)
    return [{"input_ids": rng.randint(0, LLAMA_TINY["vocab_size"],
                                      (B, S + 1)).astype(np.int32)}
            for _ in range(n)]


def _jax_loss_and_grads(tree, batch, dtype, remat, scan=False):
    from deepspeed_tpu.models.llama import LlamaConfig, llama_loss_fn
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    loss = llama_loss_fn(LlamaConfig(scan_layers=scan, **LLAMA_TINY),
                         dtype=jd, remat=remat)
    return jax.jit(jax.value_and_grad(lambda p: loss(
        jax.tree_util.tree_map(lambda x: x.astype(jd), p),
        {"input_ids": jnp.asarray(batch["input_ids"])}, None)))(tree)


def _port_loss_and_grads(params, batch, dtype, remat, scan=False):
    from deepspeed_tpu_torch.models.llama import LlamaConfig, llama_loss_fn
    from deepspeed_tpu_torch.utils.tree import tree_leaves, tree_map
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    leaves = list(tree_leaves(params))
    for t in leaves:
        t.requires_grad_()
    loss_fn = llama_loss_fn(LlamaConfig(scan_layers=scan, **LLAMA_TINY),
                            dtype=td, remat=remat)
    loss = loss_fn(tree_map(lambda t: t.to(td), params),
                   {"input_ids": torch.from_numpy(batch["input_ids"])}, 7)
    grads = torch.autograd.grad(loss, leaves)
    return loss, [g.numpy() for g in grads]


def _assert_grads(got, want_tree, dtype):
    want = jax.tree_util.tree_leaves(want_tree)
    assert len(got) == len(want)
    tol = TOLS[dtype]
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape
        if dtype == "fp32":
            scale = max(float(np.abs(w).max()), 1e-30)
            assert float(np.abs(g - w).max()) <= tol["grad_max"] * scale
        else:
            err = np.linalg.norm(g - w) / max(float(np.linalg.norm(w)),
                                              1e-30)
            assert err <= tol["grad_rms"], err


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_llama_loss_and_grads_match_jax(dtype, remat):
    """llama_loss_fn through the compute-dtype cast of fp32 masters: the
    loss and every master grad against jax.value_and_grad, with and
    without remat in both packages."""
    from deepspeed_tpu_torch.models.llama import llama_params_from_jax
    tree = _jax_tree()
    batch = _ids(1)[0]
    jl, jgr = _jax_loss_and_grads(tree, batch, dtype, remat)
    params = llama_params_from_jax(_np_tree(tree))
    tl, grads = _port_loss_and_grads(params, batch, dtype, remat)
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(float(tl.detach()), float(jl),
                               rtol=TOLS[dtype]["loss"])
    _assert_grads(grads, jgr, dtype)


@pytest.mark.parametrize("remat", [False, True])
def test_stacked_layout_matches_jax_scan_layers(remat):
    """LlamaConfig(scan_layers=True) trains on the stacked ``h`` tree:
    the loss and the stacked leaves' grads against JAX's scan trunk, in
    fp32."""
    tree = _jax_tree(scan=True)
    batch = _ids(2)[0]
    jl, jgr = _jax_loss_and_grads(tree, batch, "fp32", remat, scan=True)
    params = _torch_tree(_np_tree(tree))
    assert "h" in params and not any(k.startswith("h_") for k in params)
    tl, grads = _port_loss_and_grads(params, batch, "fp32", remat,
                                     scan=True)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    stacked = [g for g in grads if g.shape[:1] == (LLAMA_TINY["num_layers"],)
               and g.ndim >= 2]
    assert stacked and all(np.abs(g).max() > 0 for g in stacked)
    _assert_grads(grads, jgr, "fp32")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpt2_remat_equals_its_non_remat_path(dtype):
    """gpt2_loss_fn(remat=True) at dropout 0.1 takes the same loss and
    grads as the non-remat path at the same seed: the recompute draws the
    same hash keep masks (embedding, attention inside K1-K3, residual)."""
    from deepspeed_tpu_torch.models.gpt2 import (GPT2Config, gpt2_loss_fn,
                                                 init_gpt2_params)
    from deepspeed_tpu_torch.utils.tree import tree_leaves, tree_map
    cfg = GPT2Config(vocab_size=256, max_position_embeddings=S,
                     hidden_size=64, num_layers=2, num_heads=2,
                     embd_dropout=0.1, attn_dropout=0.1, resid_dropout=0.1)
    params = init_gpt2_params(cfg, torch.Generator().manual_seed(3))
    leaves = list(tree_leaves(params))
    for t in leaves:
        t.requires_grad_()
    ids = torch.from_numpy(np.random.RandomState(5).randint(
        0, cfg.vocab_size, (B, S + 1)).astype(np.int32))
    out = {}
    for remat in (False, True):
        loss = gpt2_loss_fn(cfg, dtype=dtype, remat=remat)(
            tree_map(lambda t: t.to(dtype), params), {"input_ids": ids},
            -1234567)
        out[remat] = (loss, torch.autograd.grad(loss, leaves))
    (l0, g0), (l1, g1) = out[False], out[True]
    np.testing.assert_allclose(float(l1.detach()), float(l0.detach()),
                               rtol=1e-6)
    for a, b in zip(g1, g0):
        scale = max(float(b.abs().max()), 1e-30)
        assert float((a - b).abs().max()) <= 1e-6 * scale
    # and the dropout is on: another seed moves the loss
    other = gpt2_loss_fn(cfg, dtype=dtype, remat=True)(
        tree_map(lambda t: t.to(dtype), params), {"input_ids": ids}, 99)
    assert float(other.detach()) != float(l0.detach())


def _zero2_config(**over):
    """examples/llama/ds_config_zero2.json as held (Adam betas 0.9/0.95,
    weight decay 0.1, WarmupLR, clipping 1.0, ZeRO 2), in fp32 at a tiny
    micro batch."""
    with open(REPO / "examples" / "llama" / "ds_config_zero2.json") as f:
        cfg = json.load(f)
    cfg.update({"train_micro_batch_size_per_gpu": B,
                "bf16": {"enabled": False}, "steps_per_print": 1000})
    cfg.update(over)
    return cfg


def test_zero2_trajectory_matches_jax_engine():
    """5 train_batch steps of the tiny Llama under ds_config_zero2.json's
    optimizer, schedule and clipping in fp32, the port against the JAX
    engine on one device: every loss and the final params."""
    import deepspeed_tpu
    from deepspeed_tpu.models.llama import LlamaConfig as JConfig
    from deepspeed_tpu.models.llama import llama_loss_fn as jloss

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import LlamaConfig, llama_loss_fn
    from deepspeed_tpu_torch.utils.tree import tree_leaves
    tree = _jax_tree()
    micros = _ids(4, 5)
    jeng, *_ = deepspeed_tpu.initialize(
        model=jloss(JConfig(**LLAMA_TINY), dtype=jnp.float32),
        model_parameters=tree,
        config=_zero2_config(mesh={"axes": {"data": 1}}))
    teng, *_ = deepspeed_tpu_torch.initialize(
        model=llama_loss_fn(LlamaConfig(**LLAMA_TINY), dtype=torch.float32),
        model_parameters=_np_tree(tree), config=_zero2_config(),
        device="cpu")
    assert teng.zero_optimization_stage() == 2
    jit, tit = iter(micros), iter(micros)
    jl = [float(jeng.train_batch(jit)) for _ in range(5)]
    tl = [float(teng.train_batch(tit)) for _ in range(5)]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert teng.get_lr() == pytest.approx(jeng.get_lr(), rel=1e-6)
    for t, j in zip(tree_leaves(teng.module_params),
                    jax.tree_util.tree_leaves(jeng.module_params)):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                   rtol=0, atol=1e-4)
