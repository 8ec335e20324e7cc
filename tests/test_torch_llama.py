"""The port's Llama family (deepspeed_tpu_torch/models/llama.py) and its
int8 KV page pool against the JAX package on the CPU.

The same numpy inputs, made from a seed, go through both packages; the
JAX parameters cross through ``llama_params_from_jax``. Tolerances:

- ``rms_norm`` and ``apply_rope`` in fp32: 1e-6 (the same few fp32
  operations, which XLA may fuse or reorder). In bf16 ``rms_norm``
  rounds one fp32 result that may differ in its last bit, so one bf16
  ulp (2**-7 relative); ``apply_rope`` rounds every product and sum to
  bf16 on both sides and gives the same bits.
- ``rope_cos_sin``: the angles are the same bits (numpy inverse
  frequencies, one fp32 product each), and cos/sin of them may differ by
  a bound that grows with the angle (``ROPE_TABLE_ULPS`` and
  ``ROPE_TABLE_ANGLE_REL``, below).
- logits and float pools of the fp32 model: 1e-4 (matmul sums run in
  another order), as tests/test_torch_serving.py holds GPT-2 to.
- the int8 pool: the payload holds JAX's bits and the scales agree to
  1e-6 relative (the K/V that are quantized differ from JAX's in their
  last bits, see above).
"""

import importlib.util
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_threads  # noqa: F401  (torch threads per xdist worker)
from tests.unit.test_inference import TINY_INF, tiny_gpt2, tiny_llama

REPO = pathlib.Path(__file__).resolve().parents[1]
FP32_ATOL = 1e-6
BF16_RTOL = 2.0 ** -7
# cos/sin tables, per element: each side's polynomial within 2 fp32 ulps
# of 1 (4 together, 2**-21), plus what the reduction of the fp32 angle
# into [-pi/4, pi/4] may lose. XLA's CPU code reduces with an fp32
# multiple of pi/2, whose error may reach one fp32 ulp of the angle, at
# most |angle| * 2**-23 (|d cos/dx| <= 1): 2.4e-4 at the 2047 rad of a
# 2048-token table, where a fixed 1e-6 held on some hosts and not on
# others. Below ~4 rad the bound is under 1e-6.
ROPE_TABLE_ULPS = 2.0 ** -21
ROPE_TABLE_ANGLE_REL = 2.0 ** -23
LOGIT_ATOL = 1e-4
SCALE_RTOL = 1e-6


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _port(cfg, params):
    from deepspeed_tpu_torch.models.llama import (LlamaConfig,
                                                  llama_params_from_jax)
    return LlamaConfig(**cfg._asdict()), llama_params_from_jax(
        _np_tree(params))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_rms_norm_matches_jax(dtype):
    from deepspeed_tpu.ops.functional import rms_norm as jax_rms

    from deepspeed_tpu_torch.ops.functional import rms_norm
    rng = np.random.RandomState(0)
    x = (rng.randn(3, 5, 32) * 3).astype(np.float32)
    w = (1 + 0.1 * rng.randn(32)).astype(np.float32)
    jd, td = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
              else (jnp.float32, torch.float32))
    ref = jax_rms(jnp.asarray(x).astype(jd), jnp.asarray(w), 1e-5)
    out = rms_norm(torch.from_numpy(x).to(td), torch.from_numpy(w), 1e-5)
    assert out.dtype == td
    atol, rtol = (0, BF16_RTOL) if dtype == "bf16" else (FP32_ATOL, 0)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("seq,hd,theta", [(2048, 64, 10000.0),
                                          (32, 8, 10000.0),
                                          (100, 128, 500000.0)])
def test_rope_tables_match_jax(seq, hd, theta):
    from deepspeed_tpu.models.llama import rope_cos_sin as jax_rope

    from deepspeed_tpu_torch.models.llama import rope_cos_sin
    jc, js = jax_rope(seq, hd, theta)
    tc, ts = rope_cos_sin(seq, hd, theta)
    assert tc.shape == (seq, hd // 2) and tc.dtype == torch.float32
    inv = 1.0 / (theta ** (np.arange(0, hd, 2, dtype=np.float32) / hd))
    angles = np.outer(np.arange(seq, dtype=np.float32), inv.astype(
        np.float32))
    bound = ROPE_TABLE_ULPS + np.abs(angles) * ROPE_TABLE_ANGLE_REL
    for got, want in ((tc, jc), (ts, js)):
        gap = np.abs(got.numpy() - np.asarray(want))
        assert (gap <= bound).all(), float((gap / bound).max())


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("rank", [2, 3])
def test_apply_rope_matches_jax(rank, dtype):
    """Both table ranks: the shared (S, hd/2) tables, and per-row
    (B, S, hd/2) gathers at each row's own positions. Both sides get
    JAX's tables, so only the rotation is compared."""
    from deepspeed_tpu.models.llama import apply_rope as jax_apply
    from deepspeed_tpu.models.llama import rope_cos_sin as jax_rope

    from deepspeed_tpu_torch.models.llama import apply_rope
    rng = np.random.RandomState(rank)
    B, H, S, hd = 3, 4, 6, 16
    x = rng.randn(B, H, S, hd).astype(np.float32)
    cos, sin = (np.array(t) for t in jax_rope(40, hd, 10000.0))
    if rank == 3:
        pos = np.asarray([0, 7, 30])[:, None] + np.arange(S)[None, :]
        cos, sin = cos[pos], sin[pos]
    else:
        cos, sin = cos[:S], sin[:S]
    jd, td = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
              else (jnp.float32, torch.float32))
    ref = jax_apply(jnp.asarray(x).astype(jd), jnp.asarray(cos),
                    jnp.asarray(sin))
    out = apply_rope(torch.from_numpy(x).to(td), torch.from_numpy(cos),
                     torch.from_numpy(sin))
    assert out.dtype == td and out.shape == (B, H, S, hd)
    # bf16: each product and each sum rounds to bf16 on both sides, so
    # the same bits come out; fp32 may fuse a multiply-add
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               atol=0 if dtype == "bf16" else FP32_ATOL,
                               rtol=0)


@pytest.mark.parametrize("kwargs", [
    dict(),
    dict(vocab_size=32128, hidden_size=2048, num_layers=16, num_heads=32,
         num_kv_heads=8, max_position_embeddings=2048),
    dict(hidden_size=64, num_heads=4, num_kv_heads=1,
         intermediate_size=100),
])
def test_config_properties_match_jax(kwargs):
    from deepspeed_tpu.models.llama import LlamaConfig as JaxConfig

    from deepspeed_tpu_torch import LlamaConfig
    j, t = JaxConfig(**kwargs), LlamaConfig(**kwargs)
    assert t._asdict() == j._asdict()
    assert (t.kv_heads, t.head_dim, t.inter) == (j.kv_heads, j.head_dim,
                                                 j.inter)
    if kwargs.get("hidden_size") == 2048:
        assert t.inter == 5504 and t.head_dim == 64 and t.kv_heads == 8


@pytest.mark.parametrize("scan_layers", [False, True])
def test_init_params_have_the_jax_tree(scan_layers):
    from deepspeed_tpu.models.llama import init_llama_params as jax_init

    from deepspeed_tpu_torch.models.llama import (LlamaConfig, count_params,
                                                  init_llama_params)
    cfg, _ = tiny_llama()
    cfg = cfg._replace(scan_layers=scan_layers)
    ref = jax_init(cfg, jax.random.PRNGKey(0))
    out = init_llama_params(LlamaConfig(**cfg._asdict()),
                            torch.Generator().manual_seed(0))
    shapes = lambda tree: jax.tree_util.tree_map(lambda a: tuple(a.shape),
                                                 tree)
    assert shapes(out) == shapes(ref)
    assert ("h" in out) == scan_layers
    from deepspeed_tpu.models.llama import count_params as jax_count
    assert count_params(out) == jax_count(ref)
    leaves = jax.tree_util.tree_leaves(out)
    assert all(t.dtype == torch.float32 for t in leaves)
    assert float(out["ln_f"]["w"].min()) == 1.0
    wo = out["h"]["attn"]["wo"][0] if scan_layers else out["h_0"]["attn"]["wo"]
    wq = out["h"]["attn"]["wq"][0] if scan_layers else out["h_0"]["attn"]["wq"]
    # output projections are scaled by 1/sqrt(2 * num_layers) = 1/2 here
    assert 0.3 < float(wo.std() / wq.std()) < 0.7


def test_params_from_jax_both_layouts():
    from deepspeed_tpu.models.llama import init_llama_params as jax_init

    from deepspeed_tpu_torch.models.llama import llama_params_from_jax
    cfg, params = tiny_llama()
    stacked = jax_init(cfg._replace(scan_layers=True), jax.random.PRNGKey(4))
    a = llama_params_from_jax(_np_tree(params))
    b = llama_params_from_jax(_np_tree(stacked))
    assert sorted(a) == sorted(b) == sorted(params)
    for x, y in zip(jax.tree_util.tree_leaves(a),
                    jax.tree_util.tree_leaves(b)):
        assert x.dtype == torch.float32
        torch.testing.assert_close(x, y, atol=0, rtol=0)
    np.testing.assert_array_equal(a["h_1"]["mlp"]["w_down"].numpy(),
                                  np.asarray(params["h_1"]["mlp"]["w_down"]))
    np.testing.assert_array_equal(a["lm_head"].numpy(),
                                  np.asarray(params["lm_head"]))


@pytest.mark.parametrize("seq,scan_layers", [(8, False), (16, False),
                                             (16, True)])
def test_forward_matches_jax(seq, scan_layers):
    """The cache-free forward. seq 8 takes flash_attention's plain route
    on both sides, seq 16 the masked-flash kernels (interpret mode in
    JAX, their plain versions in the port), with GQA groups of 2. The
    stacked layout is read in place by the port's model."""
    from deepspeed_tpu.models.llama import init_llama_params as jax_init
    from deepspeed_tpu.models.llama import llama_forward as jax_forward

    from deepspeed_tpu_torch.models.llama import LlamaConfig, llama_forward
    cfg, params = tiny_llama()
    tree = _np_tree(params)
    if scan_layers:
        cfg = cfg._replace(scan_layers=True)
        params = jax_init(cfg, jax.random.PRNGKey(4))
        # the stacked tree as it is, not through llama_params_from_jax
        tree = jax.tree_util.tree_map(
            lambda a: torch.from_numpy(np.array(a)), _np_tree(params))
    else:
        _, tree = _port(cfg, params)
    ids = np.random.RandomState(seq).randint(0, cfg.vocab_size, (2, seq))
    ref = jax_forward(params, cfg, jnp.asarray(ids, jnp.int32),
                      dtype=jnp.float32)
    out = llama_forward(tree, LlamaConfig(**cfg._asdict()),
                        torch.from_numpy(ids), dtype=torch.float32)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=LOGIT_ATOL,
                               rtol=0)


@pytest.mark.parametrize("attn_kernel", ["pallas", "gather"])
@pytest.mark.parametrize("kv", ["fp32", "int8", "int8_nb2"])
def test_prefill_and_decode_logits_and_pools_match_jax(kv, attn_kernel):
    """One paged prefill (rows at prefix offsets 0 and 4, the second
    padded) and one seq-1 decode through llama_forward with
    block_tables, over a float pool and over the int8 pool (one and two
    scale blocks per row). Prefill over the int8 pool reads back the
    dequantized pool, as JAX does. Pools are compared outside page 0,
    which is scratch."""
    from deepspeed_tpu.models.llama import llama_forward as jax_forward

    from deepspeed_tpu_torch.models.llama import llama_forward
    cfg, params = tiny_llama()
    tcfg, tparams = _port(cfg, params)
    L, KH, hd, ps, P = cfg.num_layers, cfg.kv_heads, cfg.head_dim, 4, 8
    nb = {"fp32": 0, "int8": 1, "int8_nb2": 2}[kv]
    num_pages = 2 * P + 1
    tables = np.zeros((2, P), np.int32)
    tables[0] = np.arange(1, P + 1)
    tables[1] = np.arange(P + 1, 2 * P + 1)
    ids = np.asarray([[3, 9, 27, 4, 1, 5, 9, 2],
                      [8, 6, 7, 5, 3, 0, 0, 0]], np.int32)
    start = np.asarray([0, 4], np.int32)
    rng = np.random.RandomState(0)
    # the second row's prefix pages hold earlier content
    k0 = (rng.randn(L, num_pages, KH, ps, hd) * 0.1).astype(np.float32)
    v0 = k0 * 0.5
    if nb:
        from deepspeed_tpu.ops.attention.paged import quantize_kv
        pools = [np.array(a) for a in (*quantize_kv(jnp.asarray(k0), nb),
                                       *quantize_kv(jnp.asarray(v0), nb))]
        pools = [pools[0], pools[2], pools[1], pools[3]]   # kc vc ks vs
    else:
        pools = [k0, v0]
    jcache = tuple(jnp.asarray(a) for a in pools)
    tcache = tuple(torch.from_numpy(a.copy()) for a in pools)
    tkernel = {"pallas": "kernel", "gather": "gather"}[attn_kernel]

    def both(tok, pos, jcache):
        jl, jcache = jax_forward(params, cfg, jnp.asarray(tok),
                                 dtype=jnp.float32, kv_cache=jcache,
                                 cache_position=jnp.asarray(pos),
                                 block_tables=jnp.asarray(tables),
                                 paged_attn_kernel=attn_kernel)
        tl, back = llama_forward(tparams, tcfg, torch.from_numpy(tok),
                                 dtype=torch.float32, kv_cache=tcache,
                                 cache_position=torch.from_numpy(pos),
                                 block_tables=torch.from_numpy(tables),
                                 paged_attn_kernel=tkernel)
        assert all(a is b for a, b in zip(back, tcache))   # in place
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_ATOL, rtol=0)
        assert len(jcache) == len(tcache) == (4 if nb else 2)
        for i, (t, j) in enumerate(zip(tcache, jcache)):
            t, j = t.numpy()[:, 1:], np.asarray(j)[:, 1:]
            if not nb:
                np.testing.assert_allclose(t, j, atol=LOGIT_ATOL, rtol=0)
            elif i < 2:
                assert t.dtype == np.int8
                np.testing.assert_array_equal(t, j)
            else:
                np.testing.assert_allclose(t, j, atol=0, rtol=SCALE_RTOL)
        return np.asarray(jl), jcache

    jl, jcache = both(ids, start, jcache)
    lengths = np.asarray([8, 5])
    tok = jl[np.arange(2), lengths - 1].argmax(-1).astype(np.int32)
    both(tok[:, None], (start + lengths).astype(np.int32), jcache)


def test_int8_prefill_reads_the_dequantized_pool():
    """A seq > 1 call over the int8 pool attends what it just wrote,
    dequantized, not this call's unquantized K/V: its logits differ from
    the float pool's by the quantization error and no more."""
    from deepspeed_tpu_torch.models.llama import llama_forward
    cfg, params = tiny_llama()
    tcfg, tparams = _port(cfg, params)
    L, KH, hd, ps, P = cfg.num_layers, cfg.kv_heads, cfg.head_dim, 4, 4
    shape = (L, P + 1, KH, ps, hd)
    tables = torch.arange(1, P + 1, dtype=torch.int32)[None]
    ids = torch.tensor([[3, 9, 27, 4, 1, 5, 9, 2]])
    fp = tuple(torch.zeros(shape) for _ in range(2))
    q8 = tuple(torch.zeros(shape, dtype=torch.int8) for _ in range(2)) + \
        tuple(torch.zeros(shape[:-1] + (1,)) for _ in range(2))
    out = {}
    for name, cache in (("fp", fp), ("int8", q8)):
        out[name], _ = llama_forward(tparams, tcfg, ids, dtype=torch.float32,
                                     kv_cache=cache, block_tables=tables)
    err = float((out["fp"] - out["int8"]).abs().max())
    assert 0.0 < err < 5e-2


def test_dense_cache_raises():
    """The dense slot cache (no block tables), refused until it was
    ported, now serves: the same call as before returns JAX's logits
    (its own atol 2e-4) and writes JAX's cache (the dense cases proper:
    tests/test_torch_generate.py)."""
    from deepspeed_tpu.models.llama import llama_forward as jax_forward

    from deepspeed_tpu_torch.models.llama import llama_forward
    cfg, params = tiny_llama()
    tcfg, tparams = _port(cfg, params)
    cache = tuple(torch.zeros((2, 1, 2, 32, 8)) for _ in range(2))
    logits, got = llama_forward(tparams, tcfg, torch.tensor([[1, 2]]),
                                dtype=torch.float32, kv_cache=cache)
    jcache = tuple(jnp.zeros((2, 1, 2, 32, 8)) for _ in range(2))
    want, jgot = jax_forward(params, cfg, jnp.asarray([[1, 2]]),
                             dtype=jnp.float32, kv_cache=jcache)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), atol=2e-4,
                               rtol=0)
    for t, j in zip(got, jgot):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=2e-4,
                                   rtol=0)


@pytest.mark.parametrize("block,nb", [(0, 1), (4, 2), (8, 1), (2, 4)])
def test_int8_spec_matches_jax(block, nb):
    """Geometry and byte accounting of the int8 pool, from a LlamaConfig
    (the pool is kv_heads-sized) and from a GPT2Config."""
    from deepspeed_tpu.inference import kv_cache as jk

    from deepspeed_tpu_torch.inference import kv_cache as tk
    for cfg, _ in (tiny_llama(), tiny_gpt2()):
        js = jk.paged_spec_for(cfg, 9, 4, 32, dtype=jnp.int8,
                               kv_quant_block=block)
        ts = tk.paged_spec_for(cfg, 9, 4, 32, dtype=torch.int8,
                               kv_quant_block=block)
        assert ts.quantized and ts.scale_blocks == nb == js.scale_blocks
        assert (ts.shape, ts.scale_shape, ts.quant_block, ts.kv_heads) == \
            (js.shape, js.scale_shape, js.quant_block, js.kv_heads)
        assert tk.paged_kv_bytes(ts) == jk.paged_kv_bytes(js)
        cache = tk.init_paged_kv_cache(ts, "cpu")
        assert [tuple(c.shape) for c in cache] == \
            [tuple(c.shape) for c in jk.init_paged_kv_cache(js)]
        assert [c.dtype for c in cache] == [torch.int8] * 2 + \
            [torch.float32] * 2
    fs = tk.paged_spec_for(cfg, 9, 4, 32, dtype=torch.float32,
                           kv_quant_block=3)      # ignored off int8
    assert not fs.quantized and fs.quant_block == 0
    assert len(tk.init_paged_kv_cache(fs, "cpu")) == 2
    assert tk.paged_kv_bytes(fs) == jk.paged_kv_bytes(
        jk.paged_spec_for(cfg, 9, 4, 32, dtype=jnp.float32))


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_quant_block_must_divide_head_dim_as_in_jax(family):
    from deepspeed_tpu.inference import InferenceEngine as JaxEngine

    from deepspeed_tpu_torch import InferenceEngine
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, params_from_jax
    cfg, params = tiny_gpt2() if family == "gpt2" else tiny_llama()
    icfg = dict(TINY_INF, paged_kv={"page_size": 4, "kv_dtype": "int8",
                                    "kv_quant_block": 3})
    with pytest.raises(ValueError) as jerr:
        JaxEngine(cfg, params, icfg, dtype=jnp.float32)
    if family == "gpt2":
        tcfg, tparams = GPT2Config(**cfg._asdict()), params_from_jax(
            _np_tree(params))
    else:
        tcfg, tparams = _port(cfg, params)
    with pytest.raises(ValueError) as terr:
        InferenceEngine(tcfg, tparams, icfg, dtype=torch.float32,
                        device="cpu")
    assert str(terr.value) == str(jerr.value)
    assert "must divide head_dim" in str(terr.value)


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_quantization_state_and_logit_err_row(family, tmp_path):
    """debug_state()["quantization"] carries the JAX keys and values for
    an int8 pool, and a recorded probe lands the Serve/quant_logit_err
    row beside Serve/kv_pool_bytes_per_token, which tools/obs_report.py
    reads from a port run unchanged."""
    from deepspeed_tpu.inference import InferenceEngine as JaxEngine

    from deepspeed_tpu_torch import InferenceEngine
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, params_from_jax
    cfg, params = tiny_gpt2() if family == "gpt2" else tiny_llama()
    if family == "gpt2":
        tcfg, tparams = GPT2Config(**cfg._asdict()), params_from_jax(
            _np_tree(params))
    else:
        tcfg, tparams = _port(cfg, params)
    pk = {"page_size": 4, "num_pages": 20, "kv_dtype": "int8",
          "kv_quant_block": 4}
    err = 0.0123
    jeng = JaxEngine(cfg, params, dict(TINY_INF, paged_kv=pk),
                     dtype=jnp.float32)
    jeng.record_quant_logit_err(err)
    eng = InferenceEngine(tcfg, tparams,
                          dict(TINY_INF, paged_kv=pk,
                               events_dir=str(tmp_path)),
                          dtype=torch.float32, device="cpu")
    assert len(eng._cache) == 4
    assert eng.debug_state()["quantization"]["quant_logit_err"] is None
    eng.record_quant_logit_err(err)
    eng.generate([[1, 2, 3], [4, 5]], max_new_tokens=3)
    state = eng.debug_state()
    assert state["family"] == family
    jq, tq = jeng.debug_state()["quantization"], state["quantization"]
    for key in ("kv_dtype", "kv_quant_block", "kv_pool_bytes_per_token",
                "quant_logit_err", "weights_resident"):
        assert tq[key] == jq[key], key
    assert tq["kv_dtype"] == "int8" and tq["kv_quant_block"] == 4
    assert tq["weights_resident"] == "off"
    eng.close()
    rows = [json.loads(line) for line in open(tmp_path / "events.jsonl")]
    by_tag = {r["tag"]: r["value"] for r in rows if "tag" in r}
    assert by_tag["Serve/quant_logit_err"] == pytest.approx(err)
    assert by_tag["Serve/kv_pool_bytes_per_token"] == pytest.approx(
        tq["kv_pool_bytes_per_token"])
    spec = importlib.util.spec_from_file_location(
        "obs_report", REPO / "tools" / "obs_report.py")
    obs_report = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(obs_report)
    qz = obs_report.summarize(str(tmp_path))["serving"]["quantization"]
    assert qz["quant_logit_err"] == pytest.approx(err)
    assert qz["kv_pool_bytes_per_token"] == pytest.approx(
        tq["kv_pool_bytes_per_token"])
    assert qz["kv_dtype"] == "int8"
