"""The port's paged serving slices (deepspeed_tpu_torch/: GPT-2 and
Llama, float and int8 KV pools) against the JAX package on the CPU.

- ``params_from_jax`` carries the JAX init across through numpy, under
  both JAX layouts;
- one paged prefill plus one decode through ``gpt2_forward`` give the
  JAX logits within 1e-4 in fp32 (the sums run in another order) and
  write the same pools;
- greedy ``generate()`` equals the JAX engine's token for token, with
  more requests than slots and a shared page-aligned prefix, so
  continuous batching and prefix-cache hits are both exercised: for
  both families, over the float and the int8 pool, with the paged-decode
  path and the gather path (the Llama model itself is held against JAX
  in tests/test_torch_llama.py);
- config parsing resolves the same fields and raises the same errors;
- ``swap_params`` copies into the live parameter tensors (the CUDA
  graphs of the program set hold their addresses);
- nothing in the port, nor chip_smoke.py, imports jax or deepspeed_tpu.
"""

import ast
import copy
import importlib.util
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_threads  # noqa: F401  (torch threads per xdist worker)
from tests.unit.test_inference import TINY_INF, tiny_gpt2, tiny_llama

REPO = pathlib.Path(__file__).resolve().parents[1]
LOGIT_ATOL = 1e-4
PAGED_INF = dict(TINY_INF, paged_kv={"page_size": 4})
# more requests than the 3 slots; prompts 0/1 and 3 share the
# page-aligned prefix [5, 6, 7, 8]
PROMPTS = [[5, 6, 7, 8, 9, 10], [5, 6, 7, 8, 11], [1, 2, 3],
           [5, 6, 7, 8, 9, 10, 12, 13], [40, 41], [7] * 8, [3, 1, 4, 1, 5]]


def _port_params(params):
    from deepspeed_tpu_torch.models.gpt2 import params_from_jax
    return params_from_jax(jax.tree_util.tree_map(np.asarray, params))


def _port_config(cfg):
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config
    return GPT2Config(**cfg._asdict())


def test_params_from_jax_both_layouts():
    from deepspeed_tpu.models.gpt2 import init_gpt2_params
    cfg, params = tiny_gpt2()
    stacked = init_gpt2_params(cfg._replace(scan_layers=True),
                               jax.random.PRNGKey(3))
    a, b = _port_params(params), _port_params(stacked)
    assert sorted(a) == sorted(b) == sorted(params)
    flat_a = jax.tree_util.tree_leaves(a)
    flat_b = jax.tree_util.tree_leaves(b)
    assert len(flat_a) == len(flat_b) == len(jax.tree_util.tree_leaves(
        params))
    for x, y in zip(flat_a, flat_b):
        assert x.dtype == torch.float32
        torch.testing.assert_close(x, y, atol=0, rtol=0)
    np.testing.assert_array_equal(a["h_1"]["attn"]["qkvw"].numpy(),
                                  np.asarray(params["h_1"]["attn"]["qkvw"]))


def test_prefill_and_decode_logits_and_pools_match_jax():
    """One paged prefill (rows at prefix offsets 0 and 4, the second
    padded) and one seq-1 decode through gpt2_forward: the JAX side runs
    its gather path for the prefill and K4 in interpret mode for the
    decode, the port its plain prefill attention and its paged-decode
    wrapper on the CPU."""
    from deepspeed_tpu.models.gpt2 import gpt2_forward as jax_forward

    from deepspeed_tpu_torch.models.gpt2 import gpt2_forward
    cfg, params = tiny_gpt2()
    tcfg, tparams = _port_config(cfg), _port_params(params)
    L, H, hd, ps, P = cfg.num_layers, cfg.num_heads, 8, 4, 8
    num_pages = 2 * P + 1
    shape = (L, num_pages, H, ps, hd)
    tables = np.zeros((2, P), np.int32)
    tables[0] = np.arange(1, P + 1)
    tables[1] = np.arange(P + 1, 2 * P + 1)
    ids = np.asarray([[3, 9, 27, 4, 1, 5, 9, 2],
                      [8, 6, 7, 5, 3, 0, 0, 0]], np.int32)
    start = np.asarray([0, 4], np.int32)
    rng = np.random.RandomState(0)
    # the second row's prefix pages hold earlier content
    pool0 = rng.randn(*shape).astype(np.float32) * 0.1

    jk, jv = jnp.asarray(pool0), jnp.asarray(pool0 * 0.5)
    tk = torch.from_numpy(pool0.copy())
    tv = torch.from_numpy(pool0 * 0.5)
    jl, (jk, jv) = jax_forward(params, cfg, jnp.asarray(ids),
                               dtype=jnp.float32, kv_cache=(jk, jv),
                               cache_position=jnp.asarray(start),
                               block_tables=jnp.asarray(tables),
                               paged_attn_kernel="pallas")
    tl, (tk2, tv2) = gpt2_forward(tparams, tcfg, torch.from_numpy(ids),
                                  dtype=torch.float32, kv_cache=(tk, tv),
                                  cache_position=torch.from_numpy(start),
                                  block_tables=torch.from_numpy(tables),
                                  paged_attn_kernel="kernel")
    assert tk2 is tk and tv2 is tv          # updated in place
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL,
                               rtol=0)
    for t, j in ((tk, jk), (tv, jv)):
        real = np.asarray(j)[:, 1:]         # page 0 is scratch
        np.testing.assert_allclose(t.numpy()[:, 1:], real, atol=LOGIT_ATOL,
                                   rtol=0)

    lengths = np.asarray([8, 5])
    tok = np.asarray(jl)[np.arange(2), lengths - 1].argmax(-1).astype(
        np.int32)
    pos = (start + lengths).astype(np.int32)
    jl2, (jk, jv) = jax_forward(params, cfg, jnp.asarray(tok[:, None]),
                                dtype=jnp.float32, kv_cache=(jk, jv),
                                cache_position=jnp.asarray(pos),
                                block_tables=jnp.asarray(tables),
                                paged_attn_kernel="pallas")
    tl2, _ = gpt2_forward(tparams, tcfg, torch.from_numpy(tok[:, None]),
                          dtype=torch.float32, kv_cache=(tk, tv),
                          cache_position=torch.from_numpy(pos),
                          block_tables=torch.from_numpy(tables),
                          paged_attn_kernel="kernel")
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2),
                               atol=LOGIT_ATOL, rtol=0)
    for t, j in ((tk, jk), (tv, jv)):
        np.testing.assert_allclose(t.numpy()[:, 1:], np.asarray(j)[:, 1:],
                                   atol=LOGIT_ATOL, rtol=0)


@pytest.mark.parametrize("attn_kernel", ["pallas", "gather"])
def test_greedy_generate_matches_jax_engine(attn_kernel):
    from deepspeed_tpu.inference import InferenceEngine as JaxEngine

    from deepspeed_tpu_torch import InferenceEngine
    cfg, params = tiny_gpt2()
    icfg = copy.deepcopy(PAGED_INF)
    icfg["paged_kv"]["attn_kernel"] = attn_kernel
    ref = JaxEngine(cfg, params, icfg, dtype=jnp.float32).generate(
        PROMPTS, max_new_tokens=6)
    eng = InferenceEngine(_port_config(cfg), _port_params(params), icfg,
                          dtype=torch.float32, device="cpu")
    out = eng.generate(PROMPTS, max_new_tokens=6)
    assert out == ref
    pool = eng.debug_state()["page_pool"]
    assert pool["prefix_cache"]["hit_requests"] >= 1
    assert eng.dispatches["prefill"] >= 3       # 7 requests, 3 slots
    assert pool["pages_in_use"] == 0            # everything freed


def _tiny_family(family):
    """(JAX config, JAX params, port config, port params)."""
    if family == "gpt2":
        cfg, params = tiny_gpt2()
        return cfg, params, _port_config(cfg), _port_params(params)
    from deepspeed_tpu_torch.models.llama import (LlamaConfig,
                                                  llama_params_from_jax)
    cfg, params = tiny_llama()
    return cfg, params, LlamaConfig(**cfg._asdict()), llama_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params))


@pytest.mark.parametrize("attn_kernel", ["pallas", "gather"])
@pytest.mark.parametrize("family,kv", [("gpt2", "int8"), ("llama", "fp"),
                                       ("llama", "int8")])
def test_greedy_generate_families_and_pools_match_jax(family, kv,
                                                      attn_kernel):
    """Llama over the float pool and both families over the int8 pool
    (two scale blocks per token row), token for token, with continuous
    batching and prefix reuse happening under quantization too. GPT-2
    over the float pool is test_greedy_generate_matches_jax_engine."""
    from deepspeed_tpu.inference import InferenceEngine as JaxEngine

    from deepspeed_tpu_torch import InferenceEngine
    cfg, params, tcfg, tparams = _tiny_family(family)
    icfg = copy.deepcopy(PAGED_INF)
    icfg["paged_kv"]["attn_kernel"] = attn_kernel
    if kv == "int8":
        icfg["paged_kv"].update(kv_dtype="int8", kv_quant_block=4)
    ref = JaxEngine(cfg, params, icfg, dtype=jnp.float32).generate(
        PROMPTS, max_new_tokens=6)
    eng = InferenceEngine(tcfg, tparams, icfg, dtype=torch.float32,
                          device="cpu")
    assert eng.family == family
    assert len(eng._cache) == (4 if kv == "int8" else 2)
    out = eng.generate(PROMPTS, max_new_tokens=6)
    assert out == ref
    state = eng.debug_state()
    assert state["page_pool"]["prefix_cache"]["hit_requests"] >= 1
    assert state["page_pool"]["pages_in_use"] == 0
    assert state["quantization"]["kv_dtype"] == (
        "int8" if kv == "int8" else "float32")


def test_llama_engine_serves_the_stacked_layout():
    """A ``scan_layers`` tree (blocks stacked under ``h``) serves as it
    is, and generates what the ``h_{i}`` layout generates."""
    from deepspeed_tpu_torch import InferenceEngine
    from deepspeed_tpu_torch.utils.tree import tree_map
    _, _, tcfg, tparams = _tiny_family("llama")
    stacked = {k: v for k, v in tparams.items() if not k.startswith("h_")}
    stacked["h"] = tree_map(lambda *xs: torch.stack(xs),
                            *(tparams[f"h_{i}"]
                              for i in range(tcfg.num_layers)))
    icfg = dict(PAGED_INF, paged_kv={"page_size": 4, "kv_dtype": "int8"})
    out = [InferenceEngine(tcfg, p, icfg, dtype=torch.float32,
                           device="cpu").generate(PROMPTS[:3],
                                                  max_new_tokens=4)
           for p in (tparams, stacked)]
    assert out[0] == out[1]


def test_warmup_then_serve_with_events(tmp_path):
    """warmup runs every bucket shape once; the events.jsonl rows keep the
    JAX schema, so tools/obs_report.py reads a port run."""
    from deepspeed_tpu_torch import InferenceEngine
    cfg, params = tiny_gpt2()
    icfg = dict(PAGED_INF, events_dir=str(tmp_path))
    eng = InferenceEngine(_port_config(cfg), _port_params(params), icfg,
                          dtype=torch.float32, device="cpu")
    assert eng.warmup() == 2 * 2 + 1
    out = eng.generate(PROMPTS[:4], max_new_tokens=3)
    assert [len(o) for o in out] == [len(p) + 3 for p in PROMPTS[:4]]
    eng.close()
    spec = importlib.util.spec_from_file_location(
        "obs_report", REPO / "tools" / "obs_report.py")
    obs_report = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(obs_report)
    s = obs_report.summarize(str(tmp_path))
    serving = s["serving"]
    assert serving["paged_kv"]["decode_attn_path"] == "pallas"
    assert serving["paged_kv"]["pages_in_use_peak"] > 0
    assert serving["requests"] == 4
    assert "ttft" in obs_report.render_serve(s)


def test_sampled_rows_are_deterministic_per_request():
    from deepspeed_tpu_torch import InferenceEngine
    cfg, params = tiny_gpt2()
    mk = lambda: InferenceEngine(_port_config(cfg), _port_params(params),
                                 dict(PAGED_INF, top_k=5),
                                 dtype=torch.float32, device="cpu")
    a = mk().generate(PROMPTS[:2], max_new_tokens=5, temperature=0.8,
                      seeds=[11, 12])
    b = mk().generate(PROMPTS[:2] + [[9, 9]], max_new_tokens=5,
                      temperature=0.8, seeds=[11, 12, 13])
    assert a == b[:2]
    assert all(0 <= t < cfg.vocab_size for o in b for t in o)


CONFIG_CASES = [
    {},
    PAGED_INF,
    {"max_batch_size": 4, "prompt_buckets": [16, 32, 64],
     "batch_buckets": [1, 2, 4], "top_k": 7, "temperature": 0.5,
     "paged_kv": {"page_size": 8, "num_pages": 40, "prefix_cache": False,
                  "attn_kernel": "gather", "decode_page_buckets": [2, 4],
                  "kv_dtype": "BF16"},
     "fleet": {"replicas": 2, "routing": "prefix_affinity"}},
    {"quantize_weights": True, "spec_decode": {"enabled": True, "k": 2,
                                               "verify_widths": [2, 3]}},
]

BAD_CONFIGS = [
    {"prompt_buckets": []},
    {"prompt_buckets": [8, 4]},
    {"batch_buckets": [0, 2]},
    {"batch_buckets": [1, 16]},
    {"prompt_buckets": [64, 2048]},
    {"paged_kv": {"attn_kernel": "triton"}},
    {"paged_kv": {"decode_page_buckets": [4, 4]}},
    {"paged_kv": {"num_pages": 1}},
    {"paged_kv": {"kv_dtype": "fp8"}},
    {"quantize_weights": "int4"},
    {"mesh": {"axes": {"data": 2}}},
]


@pytest.mark.parametrize("case", range(len(CONFIG_CASES)))
def test_config_resolves_like_jax(case):
    from deepspeed_tpu.runtime.config import get_inference_config as jax_cfg

    from deepspeed_tpu_torch.runtime.config import get_inference_config
    d = {"inference": CONFIG_CASES[case]}
    assert get_inference_config(copy.deepcopy(d)) == jax_cfg(
        copy.deepcopy(d))


@pytest.mark.parametrize("case", range(len(BAD_CONFIGS)))
def test_config_errors_like_jax(case):
    from deepspeed_tpu.runtime.config import DeepSpeedConfigError as JaxErr
    from deepspeed_tpu.runtime.config import get_inference_config as jax_cfg

    from deepspeed_tpu_torch.runtime.config import (DeepSpeedConfigError,
                                                    get_inference_config)
    d = {"inference": BAD_CONFIGS[case]}
    with pytest.raises(JaxErr) as jerr:
        jax_cfg(copy.deepcopy(d))
    with pytest.raises(DeepSpeedConfigError) as terr:
        get_inference_config(copy.deepcopy(d))
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("obs", [
    {}, {"events_max_mb": 4, "chrome_trace_path": "/x/t.json",
         "serve": {"slo": {"ttft_ms": 50}, "sample_rate": 0.5,
                   "replica_id": "3"}},
    {"serve": {"sample_rate": 2.0}},
])
def test_observability_serve_section_like_jax(obs):
    from deepspeed_tpu.runtime.config import get_observability_config as jo

    from deepspeed_tpu_torch.runtime.config import get_observability_config
    d = {"observability": obs}
    try:
        ref = jo(copy.deepcopy(d))
    except Exception as e:          # the JAX error the port must repeat
        with pytest.raises(Exception) as terr:
            get_observability_config(copy.deepcopy(d))
        assert str(terr.value) == str(e)
        return
    got = get_observability_config(copy.deepcopy(d))
    assert got["serve"] == ref["serve"]
    assert got["events_max_mb"] == ref["events_max_mb"]
    assert got["chrome_trace_path"] == ref["chrome_trace_path"]


@pytest.mark.parametrize("override,feature", [
    ({"mesh": {"axes": {"model": 2}}}, "inference.mesh"),
    ({"disagg": {"enabled": True, "decode_mesh": {"axes": {"model": 2}}}},
     "disagg.decode_mesh"),
])
def test_unported_features_raise(override, feature):
    """The serving meshes are refused until ported. The dense cache,
    disaggregation and quantized weights, refused before, are served:
    tests/test_torch_disagg.py, test_torch_quantized_serving.py and
    test_torch_generate.py hold them against the JAX engine."""
    from deepspeed_tpu_torch import InferenceEngine
    cfg, params = tiny_gpt2()
    with pytest.raises(NotImplementedError, match=feature):
        InferenceEngine(_port_config(cfg), _port_params(params),
                        dict(PAGED_INF, **override), dtype=torch.float32,
                        device="cpu")


def test_swap_params_copies_into_the_live_tensors(tmp_path):
    """swap_params copies the tag's weights into the tensors the engine
    serves from (the program set's CUDA graphs hold their addresses):
    every param keeps its data_ptr, and the engine then serves the
    logits, bitwise, of an engine built fresh from the tag."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import InferenceEngine
    from deepspeed_tpu_torch.models.gpt2 import gpt2_loss_fn
    from deepspeed_tpu_torch.utils.tree import tree_leaves
    cfg, params = tiny_gpt2()
    tcfg = _port_config(cfg)
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
        train.save_checkpoint(str(tmp_path))
    (old, new) = ("global_step1", "global_step2")

    def served(eng):
        logits, sample = [], eng._sample_tokens

        def rec(lg, *args):
            logits.append(lg.clone())
            return sample(lg, *args)
        eng._sample_tokens = rec
        out = eng.generate(PROMPTS, max_new_tokens=4)
        eng._sample_tokens = sample
        return out, logits

    eng = InferenceEngine.from_checkpoint(
        str(tmp_path), tcfg, tag=old, inference_config=PAGED_INF,
        dtype=torch.float32, device="cpu")
    eng.warmup()
    ptrs = [t.data_ptr() for t in tree_leaves(eng.params)]
    head = eng._head_w.data_ptr()
    before = served(eng)
    assert eng.swap_params(str(tmp_path), tag=new) == new
    assert [t.data_ptr() for t in tree_leaves(eng.params)] == ptrs
    assert eng._head_w.data_ptr() == head
    got = served(eng)
    fresh = InferenceEngine.from_checkpoint(
        str(tmp_path), tcfg, tag=new, inference_config=PAGED_INF,
        dtype=torch.float32, device="cpu")
    fresh.warmup()
    want = served(fresh)
    assert got[0] == want[0] and got[0] != before[0]
    assert len(got[1]) == len(want[1])
    assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))
    assert eng.steady_state_recompiles == 0


def test_unported_model_and_checkpoint_raise():
    """A config outside the family table is refused with the JAX
    engine's error: the JAX package's own LlamaConfig is such a class
    to the port, which serves its own. ``from_checkpoint`` of a directory
    without a committed tag raises JAX's error, with ``quantize_weights``
    too (serving from a tag: tests/test_torch_checkpoint.py and
    tests/test_torch_quantized_serving.py)."""
    from deepspeed_tpu.inference import InferenceEngine as JaxEngine
    from deepspeed_tpu.models.bert import BertConfig
    from deepspeed_tpu.models.llama import LlamaConfig as JaxLlamaConfig

    from deepspeed_tpu_torch import InferenceEngine
    with pytest.raises(TypeError) as jerr:
        JaxEngine(BertConfig(), {})
    with pytest.raises(TypeError) as terr:
        InferenceEngine(BertConfig(), {}, device="cpu")
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(TypeError, match="unsupported model config"):
        InferenceEngine(JaxLlamaConfig(), {}, device="cpu")
    cfg, _ = tiny_gpt2()
    with pytest.raises(FileNotFoundError) as jerr:
        JaxEngine.from_checkpoint("/nonexistent", cfg)
    with pytest.raises(FileNotFoundError) as terr:
        InferenceEngine.from_checkpoint("/nonexistent", _port_config(cfg),
                                        device="cpu")
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(FileNotFoundError) as jerr:
        JaxEngine.from_checkpoint("/nonexistent", cfg,
                                  quantize_weights="int8")
    with pytest.raises(FileNotFoundError) as terr:
        InferenceEngine.from_checkpoint("/nonexistent", _port_config(cfg),
                                        quantize_weights="int8",
                                        device="cpu")
    assert str(terr.value) == str(jerr.value)


def test_engine_without_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    from deepspeed_tpu_torch import InferenceEngine
    cfg, params = tiny_gpt2()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(_port_config(cfg), _port_params(params), PAGED_INF)


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


def test_port_imports_neither_jax_nor_deepspeed_tpu():
    files = sorted((REPO / "deepspeed_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 15
    for module in ("models/llama.py", "models/bert.py",
                   "ops/transformer/transformer.py",
                   "runtime/lr_schedules.py", "ops/optimizers.py",
                   "ops/sparse_attention/blocksparse_v2.py",
                   "ops/sparse_attention/ops.py",
                   "ops/sparse_attention/banded.py",
                   "ops/sparse_attention/hybrid.py",
                   "runtime/checkpoint.py", "runtime/fault.py",
                   "tools/verify_checkpoint.py", "inference/disagg.py",
                   "runtime/quantized_params.py", "inference/fleet.py",
                   "inference/rpc.py", "inference/replica_worker.py",
                   "runtime/elastic.py", "utils/health.py",
                   "launcher/runner.py", "launcher/multinode_runner.py",
                   "parallel/topology.py", "parallel/mesh.py",
                   "distributed.py", "runtime/zero/sharding.py",
                   "ops/adam/cpu_adam.py"):
        assert REPO / "deepspeed_tpu_torch" / module in files
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "deepspeed_tpu"), \
                f"{path.relative_to(REPO)} imports {name}"


def test_port_package_imports_without_jax():
    """Importing the port (serving and training entry points, the GPT-2,
    Llama and BERT families, the transformer layer, the schedules, the
    kernels' modules, the row-run, banded and hybrid attention and the
    sparse ops) in a fresh interpreter loads no jax module."""
    import subprocess
    import sys
    code = ("import sys; before = set(sys.modules); "
            "import deepspeed_tpu_torch; "
            "import deepspeed_tpu_torch.inference.engine; "
            "import deepspeed_tpu_torch.runtime.engine; "
            "import deepspeed_tpu_torch.ops.attention.masked_flash; "
            "import deepspeed_tpu_torch.ops.attention.paged; "
            "import deepspeed_tpu_torch.models.llama; "
            "import deepspeed_tpu_torch.inference.kv_cache; "
            "import deepspeed_tpu_torch.models.bert; "
            "import deepspeed_tpu_torch.ops.transformer.transformer; "
            "import deepspeed_tpu_torch.runtime.lr_schedules; "
            "import deepspeed_tpu_torch.ops.sparse_attention.blocksparse_v2; "
            "import deepspeed_tpu_torch.ops.sparse_attention.ops; "
            "import deepspeed_tpu_torch.ops.sparse_attention.banded; "
            "import deepspeed_tpu_torch.ops.sparse_attention.hybrid; "
            "import deepspeed_tpu_torch.runtime.checkpoint; "
            "import deepspeed_tpu_torch.tools.verify_checkpoint; "
            "import deepspeed_tpu_torch.inference.disagg; "
            "import deepspeed_tpu_torch.runtime.quantized_params; "
            "import deepspeed_tpu_torch.inference.fleet; "
            "import deepspeed_tpu_torch.inference.replica_worker; "
            "import deepspeed_tpu_torch.runtime.elastic; "
            "import deepspeed_tpu_torch.launcher.runner; "
            "bad = [m for m in set(sys.modules) - before "
            "if m.split('.')[0] in ('jax', 'deepspeed_tpu')]; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=str(REPO), timeout=120)
