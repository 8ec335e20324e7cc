"""int8-resident weights in the port's serving engine
(``deepspeed_tpu_torch/runtime/quantized_params.py``,
``inference.quantize_weights``, ``qwz_distribute_params`` and the
dequantization at each weight use) against the JAX package on the CPU.

- ``quantize_param``'s payload and scales are bitwise JAX's (partial last
  blocks, an all-zero block, a bf16 weight), and so is the dequantized
  weight; the tree helpers quantize the same leaves and count the same
  bytes;
- an engine with ``quantize_weights: "int8"`` serves JAX's greedy tokens,
  over the float and the int8 pool, for the tiny GPT-2 and
  ``LLAMA_TINY``, with the same warmup program count and the same
  ``quantization`` section of ``debug_state``; its logits are bitwise
  those of the same engine served the dequantized tree;
- the quantized forward's max logit error against the fp forward is
  JAX's and under its budget, and ``record_quant_logit_err`` lands it;
- ``from_checkpoint`` ships a tag through the qwZ format in ``"bf16"``
  (and its alias ``True``) and ``"int8"`` modes and serves JAX's tokens,
  and ``swap_params`` requantizes a newer tag into the live tensors in
  place.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_threads  # noqa: F401  (torch threads per xdist worker)
from tests.unit.test_inference import TINY_INF, tiny_gpt2

LLAMA_TINY = dict(vocab_size=512, hidden_size=64, num_layers=4,
                  num_heads=4, num_kv_heads=2, max_position_embeddings=128)
BASE_INF = dict(TINY_INF, prompt_buckets=[4, 16])
POOLS = {"fp": {"page_size": 4, "num_pages": 20},
         "int8": {"page_size": 4, "num_pages": 20, "kv_dtype": "int8",
                  "kv_quant_block": 4}}
# the JAX suite's max |logits_fp - logits_quant| budget at the tiny size
LOGIT_BUDGET = 0.05


def _family(name):
    """(JAX config, JAX params, port config, port params)."""
    if name == "gpt2":
        from deepspeed_tpu_torch.models.gpt2 import GPT2Config as TConfig
        cfg, params = tiny_gpt2()
    else:
        from deepspeed_tpu.models.llama import LlamaConfig, init_llama_params

        from deepspeed_tpu_torch.models.llama import LlamaConfig as TConfig
        cfg = LlamaConfig(**LLAMA_TINY)
        params = init_llama_params(cfg, jax.random.PRNGKey(4))
    from deepspeed_tpu_torch.models.gpt2 import params_from_jax
    return cfg, params, TConfig(**cfg._asdict()), params_from_jax(
        jax.tree_util.tree_map(np.asarray, params))


def _prompts(vocab):
    rng = np.random.RandomState(11)
    sys_prompt = rng.randint(1, vocab, (8,)).tolist()
    prompts = [rng.randint(1, vocab, (n,)).tolist() for n in (3, 6, 2, 7)]
    return prompts + [sys_prompt + [10], sys_prompt + [20, 21],
                      sys_prompt[:]]


# ------------------------------------------------------------ the format
@pytest.mark.parametrize("shape,block,dtype", [
    ((8, 512), 256, np.float32),
    ((3, 5, 100), 32, np.float32),         # a narrower last block
    ((4, 7), 256, np.float32),             # one block wider than d
    ((6, 64), 8, "bfloat16"),
])
def test_quantize_param_bitwise_jax(shape, block, dtype):
    from deepspeed_tpu.runtime.quantized_params import \
        dequantize_param as jdeq
    from deepspeed_tpu.runtime.quantized_params import quantize_param as jq

    from deepspeed_tpu_torch.runtime.quantized_params import (
        dequantize_param, quantize_param)
    rng = np.random.RandomState(sum(shape))
    x = (rng.randn(*shape) * rng.uniform(0.01, 3, shape[:-1] + (1,))
         ).astype(np.float32)
    x[0, ...] = 0.0                        # an all-zero row: scale 1.0
    if dtype == "bfloat16":
        jx = jnp.asarray(x, jnp.bfloat16)
        tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
            torch.bfloat16)
    else:
        jx, tx = jnp.asarray(x), torch.from_numpy(x)
    want, got = jq(jx, block), quantize_param(tx, block)
    assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
    assert got.orig_dtype == tx.dtype and got.block == block
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    deq = dequantize_param(got, torch.float32)
    np.testing.assert_array_equal(
        deq.numpy(), np.asarray(jdeq(want, jnp.float32)))
    assert dequantize_param(got).dtype == tx.dtype


def test_tree_helpers_like_jax():
    from deepspeed_tpu.runtime import quantized_params as jqp

    from deepspeed_tpu_torch.runtime import quantized_params as qp
    for name in ("gpt2", "llama"):
        _, params, _, tparams = _family(name)
        jtree = jqp.quantize_param_tree(params, 64)
        ttree = qp.quantize_param_tree(tparams, 64)
        assert qp.is_quantized_tree(ttree) and \
            not qp.is_quantized_tree(tparams)
        assert qp.quantized_tree_bytes(ttree) == \
            jqp.quantized_tree_bytes(jtree)
        assert qp.param_tree_bytes(tparams) == jqp.param_tree_bytes(params)
        # the same leaves quantized; quantizing again changes nothing
        assert isinstance(ttree["h_0"]["attn"], dict)
        flat = jax.tree_util.tree_leaves(
            jtree, is_leaf=lambda x: isinstance(x, jqp.QuantizedParam))
        kinds = [isinstance(x, jqp.QuantizedParam) for x in flat]
        tflat = []
        qp.map_quantized(qp.quantize_param_tree(ttree, 64),
                         lambda p: tflat.append(True) or p,
                         lambda x: tflat.append(False) or x)
        assert sorted(kinds) == sorted(tflat)
        deq = qp.dequantize_param_tree(ttree)
        jdeq = jqp.dequantize_param_tree(jtree)
        np.testing.assert_array_equal(deq["ln_f"]["w"].numpy(),
                                      np.asarray(jdeq["ln_f"]["w"]))
        key = "wte" if name == "gpt2" else "lm_head"
        np.testing.assert_array_equal(deq[key].numpy(),
                                      np.asarray(jdeq[key]))


def test_qwz_distribute_params_like_jax():
    from deepspeed_tpu.inference.engine import qwz_distribute_params as jqwz

    from deepspeed_tpu_torch.inference.engine import qwz_distribute_params
    from deepspeed_tpu_torch.runtime.quantized_params import QuantizedParam
    _, params, _, tparams = _family("gpt2")
    wire = qwz_distribute_params(tparams, 256, "bf16")
    want = jqwz(params, 256, "bf16")
    assert wire["wte"].dtype == torch.float32
    np.testing.assert_array_equal(wire["wte"].numpy(),
                                  np.asarray(want["wte"]))
    np.testing.assert_array_equal(wire["h_1"]["mlp"]["fc_b"].numpy(),
                                  np.asarray(params["h_1"]["mlp"]["fc_b"]))
    assert not np.array_equal(wire["wte"].numpy(), np.asarray(params["wte"]))
    res = qwz_distribute_params(tparams, 256, "int8")
    assert isinstance(res["h_0"]["attn"]["qkvw"], QuantizedParam)
    with pytest.raises(ValueError) as jerr:
        jqwz(params, 256, "fp8")
    with pytest.raises(ValueError) as terr:
        qwz_distribute_params(tparams, 256, "fp8")
    assert str(terr.value) == str(jerr.value)


# ------------------------------------------------------------ the engine
def _served(eng, prompts, max_new=4):
    """(greedy outputs, every dispatch's logits)."""
    logits, sample = [], eng._sample_tokens

    def rec(lg, *args):
        logits.append(lg.clone())
        return sample(lg, *args)
    eng._sample_tokens = rec
    out = eng.generate(prompts, max_new_tokens=max_new, temperature=0.0)
    eng._sample_tokens = sample
    return out, logits


@pytest.mark.parametrize("pool", list(POOLS))
@pytest.mark.parametrize("name", ["gpt2", "llama"])
def test_int8_weights_engine_matches_jax(name, pool):
    from deepspeed_tpu.inference import InferenceEngine as JaxEngine

    from deepspeed_tpu_torch.inference import InferenceEngine
    from deepspeed_tpu_torch.runtime.quantized_params import (
        dequantize_param_tree, is_quantized_tree, quantize_param_tree)
    cfg, params, tcfg, tparams = _family(name)
    prompts = _prompts(cfg.vocab_size)
    ic = dict(BASE_INF, paged_kv=POOLS[pool], quantize_weights="int8")
    jeng = JaxEngine(cfg, params, ic, dtype=jnp.float32)
    jwarm = jeng.warmup()
    want = jeng.generate(prompts, max_new_tokens=4, temperature=0.0)
    eng = InferenceEngine(tcfg, tparams, ic, dtype=torch.float32,
                          device="cpu")
    assert eng.warmup() == jwarm
    got, logits = _served(eng, prompts)
    assert got == want
    assert eng.steady_state_recompiles == 0
    assert is_quantized_tree(eng.params)
    tq, jq = (e.debug_state()["quantization"] for e in (eng, jeng))
    assert tq == jq
    assert tq["weights_resident"] == "int8"
    assert tq["weight_bytes"] < tq["weight_bytes_dense"]
    # the same engine over the dequantized tree: bitwise the same logits
    deq = dequantize_param_tree(quantize_param_tree(tparams))
    ref = InferenceEngine(tcfg, deq, dict(ic, quantize_weights=False),
                          dtype=torch.float32, device="cpu")
    ref.warmup()
    ref_out, ref_logits = _served(ref, prompts)
    assert ref_out == got and len(ref_logits) == len(logits)
    assert all(torch.equal(a, b) for a, b in zip(logits, ref_logits))
    assert eng.scheduler.allocator.prefix_hit_tokens >= 4


@pytest.mark.parametrize("name", ["gpt2", "llama"])
def test_quant_logit_err_like_jax_and_recorded(name, tmp_path):
    from deepspeed_tpu.runtime.quantized_params import \
        quantize_param_tree as jquant

    from deepspeed_tpu_torch.inference import InferenceEngine
    from deepspeed_tpu_torch.runtime.quantized_params import \
        quantize_param_tree
    if name == "gpt2":
        from deepspeed_tpu.models.gpt2 import gpt2_forward as jfwd

        from deepspeed_tpu_torch.models.gpt2 import gpt2_forward as tfwd
    else:
        from deepspeed_tpu.models.llama import llama_forward as jfwd

        from deepspeed_tpu_torch.models.llama import llama_forward as tfwd
    cfg, params, tcfg, tparams = _family(name)
    ids = np.random.RandomState(12).randint(1, 61, (2, 8)).astype(np.int32)
    jerr = float(jnp.max(jnp.abs(
        jfwd(params, cfg, jnp.asarray(ids), dtype=jnp.float32)
        - jfwd(jquant(params), cfg, jnp.asarray(ids), dtype=jnp.float32))))
    with torch.no_grad():
        terr = float((tfwd(tparams, tcfg, torch.from_numpy(ids),
                           dtype=torch.float32)
                      - tfwd(quantize_param_tree(tparams), tcfg,
                             torch.from_numpy(ids), dtype=torch.float32)
                      ).abs().max())
    assert 0.0 < terr < LOGIT_BUDGET
    assert terr == pytest.approx(jerr, rel=1e-3)
    eng = InferenceEngine(tcfg, tparams,
                          dict(TINY_INF, events_dir=str(tmp_path),
                               quantize_weights="int8",
                               paged_kv={"page_size": 4, "num_pages": 20,
                                         "kv_dtype": "int8"}),
                          dtype=torch.float32, device="cpu")
    eng.record_quant_logit_err(terr)
    eng.generate([[1, 2, 3], [4, 5]], max_new_tokens=3)
    assert eng.debug_state()["quantization"]["quant_logit_err"] == terr
    eng.close()
    tags = {r.get("tag") for r in map(json.loads,
                                       open(tmp_path / "events.jsonl"))}
    assert {"Serve/quant_logit_err", "Serve/kv_pool_bytes_per_token"} <= tags


def test_int8_weights_with_spec_decode_equal_without():
    from deepspeed_tpu_torch.inference import InferenceEngine
    _, _, tcfg, tparams = _family("gpt2")
    quant = {"quantize_weights": "int8",
             "paged_kv": {"page_size": 4, "num_pages": 20,
                          "kv_dtype": "int8"}}
    prompts = [[1, 2, 3, 1, 2, 3, 1, 2], [4, 5, 4, 5, 4, 5],
               [7, 8, 9, 7, 8, 9, 7]]
    outs = []
    for extra in ({}, {"spec_decode": {"enabled": True, "k": 4}}):
        eng = InferenceEngine(tcfg, tparams, dict(TINY_INF, **quant,
                                                  **extra),
                              dtype=torch.float32, device="cpu")
        eng.warmup()
        outs.append(eng.generate(prompts, max_new_tokens=8,
                                 temperature=0.0))
        assert eng.steady_state_recompiles == 0
    assert outs[0] == outs[1]


# -------------------------------------------------- serving from a tag
@pytest.fixture(scope="module")
def tags(tmp_path_factory):
    """Two committed tags of the tiny GPT-2, written by the port's
    training engine (``global_step1``, ``global_step2``)."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt2 import gpt2_loss_fn
    d = tmp_path_factory.mktemp("tags")
    cfg, params, tcfg, _ = _family("gpt2")
    train, *_ = deepspeed_tpu_torch.initialize(
        model=gpt2_loss_fn(tcfg, dtype=torch.float32),
        model_parameters=jax.tree_util.tree_map(np.asarray, params),
        config={"train_micro_batch_size_per_gpu": 2,
                "steps_per_print": 1000,
                "optimizer": {"type": "Adam", "params": {"lr": 1e-2}}},
        device="cpu")
    rng = np.random.RandomState(5)
    for _ in range(2):
        train.train_batch(iter([{"input_ids": rng.randint(
            0, cfg.vocab_size, (2, 17)).astype(np.int32)}]))
        train.save_checkpoint(str(d))
    return str(d), cfg, tcfg


PAGED = dict(TINY_INF, paged_kv={"page_size": 4})
PROMPTS = [[5, 6, 7, 8, 9, 10], [5, 6, 7, 8, 11], [1, 2, 3], [40, 41]]


@pytest.mark.parametrize("mode", [True, "bf16", "int8"])
def test_from_checkpoint_quantized_modes_match_jax(tags, mode, tmp_path):
    from deepspeed_tpu.inference import InferenceEngine as JaxEngine

    from deepspeed_tpu_torch.inference import InferenceEngine
    d, cfg, tcfg = tags
    jeng = JaxEngine.from_checkpoint(d, cfg, tag="global_step1",
                                     inference_config=PAGED,
                                     dtype=jnp.float32,
                                     quantize_weights=mode)
    want = jeng.generate(PROMPTS, max_new_tokens=4, temperature=0.0)
    eng = InferenceEngine.from_checkpoint(
        d, tcfg, tag="global_step1",
        inference_config=dict(PAGED, events_dir=str(tmp_path)),
        dtype=torch.float32, quantize_weights=mode, device="cpu")
    assert eng.generate(PROMPTS, max_new_tokens=4,
                        temperature=0.0) == want
    tq, jq = (e.debug_state()["quantization"] for e in (eng, jeng))
    assert tq == jq
    assert tq["weights_resident"] == ("int8" if mode == "int8" else "bf16")
    if mode != "int8":
        # the weights crossed as int8 blocks: no longer the tag's values
        plain = InferenceEngine.from_checkpoint(
            d, tcfg, tag="global_step1", inference_config=PAGED,
            dtype=torch.float32, device="cpu")
        assert not torch.equal(eng.params["wte"], plain.params["wte"])
        np.testing.assert_array_equal(eng.params["wte"].numpy(),
                                      np.asarray(jeng.params["wte"]))
    eng.close()
    load = [json.loads(line) for line in open(tmp_path / "events.jsonl")
            if '"serve_load"' in line]
    assert load[0]["quantize_weights"] == ("bf16" if mode is True
                                           else mode)


def test_swap_params_requantizes_into_the_live_tensors(tags):
    from deepspeed_tpu_torch.inference import InferenceEngine
    d, _, tcfg = tags
    from deepspeed_tpu_torch.runtime.quantized_params import QuantizedParam

    def ptrs(tree):
        out = []
        for v in tree.values():
            if isinstance(v, dict):
                out += ptrs(v)
            elif isinstance(v, QuantizedParam):
                out += [v.q.data_ptr(), v.scale.data_ptr()]
            else:
                out.append(v.data_ptr())
        return out

    def make(tag):
        e = InferenceEngine.from_checkpoint(
            d, tcfg, tag=tag, inference_config=PAGED, dtype=torch.float32,
            quantize_weights="int8", device="cpu")
        e.warmup()
        return e
    eng = make("global_step1")
    before_ptrs = ptrs(eng.params)
    before = _served(eng, PROMPTS)
    assert eng.swap_params(d, tag="global_step2") == "global_step2"
    assert ptrs(eng.params) == before_ptrs
    got = _served(eng, PROMPTS)
    want = _served(make("global_step2"), PROMPTS)
    assert got[0] == want[0] and got[0] != before[0]
    assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))
    assert eng.steady_state_recompiles == 0
    assert eng.debug_state()["quantization"]["weights_resident"] == "int8"
