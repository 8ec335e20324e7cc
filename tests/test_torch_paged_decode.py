"""The port's paged-decode attention (deepspeed_tpu_torch/ops/attention/
paged.py) against the JAX package's Pallas kernel K4
(deepspeed_tpu/ops/attention/paged.py::_decode_kernel) run in interpret
mode on the CPU.

The same numpy inputs, made from a seed, go through both. Tolerances:
2e-5 in fp32 (what tests/unit/test_paged_attention.py holds the Pallas
kernel to against its oracle: the sums run in another order) and 2e-2 in
bf16 (q.K is exact in fp32 either way, but the probabilities are rounded
to bf16 before P.V and the sums run in another order).

The plain version also walks the table split by split
(``pages_per_split``), as the CUDA kernels do, and merges the splits in
order: each split restarts JAX's running max, so in bf16 the rounding of
p follows the split's pages, within the same tolerances of JAX's one
walk. Each case's JAX output is computed once (``_sweep_case`` caches the
sweeps) and held against every split.

The CUDA kernels themselves run only on a card: their tests are marked
``cuda`` and skip here.
"""

import functools
import math

import numpy as np
import pytest
import torch

import tests.torch_threads  # noqa: F401  (torch threads per xdist worker)

FP32_ATOL = 2e-5
BF16_ATOL = 2e-2
# the CUDA kernel against the plain version on the card: the same p
# rounding in both, so only the sum order differs; the output's last
# bf16 rounding may still land one ulp apart (2**-8 relative)
CUDA_BF16_ATOL = 2e-3
CUDA_BF16_RTOL = 1e-2
# the int8 arity with bf16 q: every product is fp32 on both sides, so
# only the output's bf16 rounding differs, by at most one ulp
INT8_BF16_ATOL = 1e-4
INT8_BF16_RTOL = 2.0 ** -7


def _jax_decode(q, kpool, vpool, tables, pos, dtype):
    """K4 in interpret mode on numpy inputs; returns fp32 numpy."""
    import jax.numpy as jnp

    from deepspeed_tpu.ops.attention.paged import paged_decode_attention
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    out = paged_decode_attention(
        jnp.asarray(q).astype(jd), jnp.asarray(kpool).astype(jd),
        jnp.asarray(vpool).astype(jd), jnp.asarray(tables, jnp.int32),
        jnp.asarray(pos, jnp.int32), interpret=True)
    return np.asarray(out.astype(jnp.float32))


def _torch_args(q, kpool, vpool, tables, pos, dtype):
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    return (torch.from_numpy(q).to(td), torch.from_numpy(kpool).to(td),
            torch.from_numpy(vpool).to(td),
            torch.from_numpy(np.asarray(tables, np.int32)),
            torch.from_numpy(np.asarray(pos, np.int32)))


def _case(rng, kv_heads, gqa, page_size, pages_per_seq, hd=16, batch=5,
          num_pages=None):
    """Random pools, queries and per-row tables of distinct non-null
    pages, as numpy fp32."""
    H = kv_heads * gqa
    num_pages = num_pages or (batch * pages_per_seq + 1)
    kpool = rng.randn(num_pages, kv_heads, page_size, hd).astype(np.float32)
    vpool = rng.randn(num_pages, kv_heads, page_size, hd).astype(np.float32)
    q = rng.randn(batch, H, hd).astype(np.float32)
    tables = np.zeros((batch, pages_per_seq), np.int32)
    avail = list(range(1, num_pages))
    rng.shuffle(avail)
    for b in range(batch):
        tables[b] = [avail.pop() for _ in range(pages_per_seq)]
    return q, kpool, vpool, tables


def _both(args, dtype, pages_per_split=None):
    """(plain, wrapper-on-CPU) outputs of the port as fp32 numpy."""
    from deepspeed_tpu_torch.ops.attention.paged import (
        paged_decode_attention, paged_decode_plain)
    t = _torch_args(*args, dtype)
    return (paged_decode_plain(*t, pages_per_split=pages_per_split
                               ).float().numpy(),
            paged_decode_attention(*t, pages_per_split=pages_per_split
                                   ).float().numpy())


SPLITS = [1, 2, 3]    # pages per split of the split twins


@functools.lru_cache(maxsize=None)
def _sweep_case(page_size, gqa, dtype):
    """The sweep's inputs (page_size x GQA, the cache-position edges in
    one batch: position 0, the last slot of page 0, the first slot of
    page 1, the slot after it, the table's final position) and K4's
    output on them, computed once per case."""
    rng = np.random.RandomState(page_size + gqa)
    P = 3
    q, kpool, vpool, tables = _case(rng, kv_heads=2, gqa=gqa,
                                    page_size=page_size, pages_per_seq=P)
    pos = np.asarray([0, page_size - 1, page_size, page_size + 1,
                      P * page_size - 1], np.int32)
    ref = _jax_decode(q, kpool, vpool, tables, pos, dtype)
    return (q, kpool, vpool, tables, pos), ref


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("gqa", [1, 4])
@pytest.mark.parametrize("page_size", [8, 16, 128])
def test_matches_jax_kernel_sweep(page_size, gqa, dtype):
    """page_size x GQA sweep with the cache-position edges in one batch:
    position 0, the last slot of page 0 (page-aligned context), the
    first slot of page 1 (one past a page), the slot after it, and the
    table's final position."""
    args, ref = _sweep_case(page_size, gqa, dtype)
    atol = BF16_ATOL if dtype == "bf16" else FP32_ATOL
    for out in _both(args, dtype):
        np.testing.assert_allclose(out, ref, atol=atol, rtol=0)


@pytest.mark.parametrize("pps", SPLITS)
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("gqa", [1, 4])
@pytest.mark.parametrize("page_size", [8, 16, 128])
def test_split_matches_jax_kernel_sweep(page_size, gqa, dtype, pps):
    """The sweep's split twin: the plain version walking 1, 2 or 3 pages
    per split (of the 3-page tables) against K4's one walk."""
    args, ref = _sweep_case(page_size, gqa, dtype)
    atol = BF16_ATOL if dtype == "bf16" else FP32_ATOL
    for out in _both(args, dtype, pps):
        np.testing.assert_allclose(out, ref, atol=atol, rtol=0)


def test_split_plan_reads_shapes_only():
    """split_plan takes shapes, not tensors, and gives the same split on
    every call; pps is at least 1 and within the kernels' limits (pages,
    token rows, the table's width). At the serving shapes (9 rows, page
    16, 64-page tables) it splits the table."""
    from deepspeed_tpu_torch.ops.attention import paged as tp
    for B, KH, G, hd, ps, P in [(9, 16, 1, 64, 16, 64), (9, 8, 4, 64, 16, 64),
                                (1, 1, 1, 8, 1, 1), (64, 32, 1, 128, 16, 64),
                                (2, 2, 8, 256, 128, 4), (5, 2, 1, 64, 1, 500)]:
        pps = tp.split_plan(B, KH, G, hd, ps, P)
        assert pps == tp.split_plan(B, KH, G, hd, ps, P)
        assert isinstance(pps, int) and 1 <= pps <= min(
            P, tp.MAX_PAGES_PER_SPLIT)
        assert pps * ps <= tp.MAX_SPLIT_ROWS
    for shape in ((9, 16, 1, 64, 16, 64), (9, 8, 4, 64, 16, 64)):
        assert tp.split_plan(*shape) < 64


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_shared_prefix_pages_two_rows(dtype):
    """Two rows whose tables point at the SAME physical prefix pages, with
    identical queries at identical positions, read identical K/V — and
    a third row diverges."""
    rng = np.random.RandomState(0)
    q, kpool, vpool, tables = _case(rng, kv_heads=2, gqa=2, page_size=8,
                                    pages_per_seq=3, batch=3)
    tables[1, :2] = tables[0, :2]
    tables[1, 2] = tables[0, 2]
    q[1] = q[0]
    pos = np.asarray([17, 17, 5], np.int32)
    ref = _jax_decode(q, kpool, vpool, tables, pos, dtype)
    atol = BF16_ATOL if dtype == "bf16" else FP32_ATOL
    for out in _both((q, kpool, vpool, tables, pos), dtype):
        np.testing.assert_allclose(out, ref, atol=atol, rtol=0)
        np.testing.assert_array_equal(out[0], out[1])
        assert not np.allclose(out[0], out[2])


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_all_null_rows_are_zero(dtype):
    """Inactive slots and the scratch row carry all-null tables: their
    output is exactly 0, in the port as in K4 (its l_safe), never NaN;
    an all-null row beside live rows leaves them untouched."""
    rng = np.random.RandomState(1)
    q, kpool, vpool, tables = _case(rng, kv_heads=2, gqa=1, page_size=8,
                                    pages_per_seq=2, batch=3)
    tables[1] = 0
    tables[2] = 0
    pos = np.asarray([9, 0, 15], np.int32)
    ref = _jax_decode(q, kpool, vpool, tables, pos, dtype)
    np.testing.assert_array_equal(ref[1:], 0.0)
    atol = BF16_ATOL if dtype == "bf16" else FP32_ATOL
    for out in _both((q, kpool, vpool, tables, pos), dtype):
        np.testing.assert_array_equal(out[1:], 0.0)
        np.testing.assert_allclose(out, ref, atol=atol, rtol=0)


@pytest.mark.parametrize("pps", SPLITS)
def test_split_all_null_rows_are_zero(pps):
    """The all-null rows' split twin: every split of a null row is null,
    and the row stays exactly 0."""
    rng = np.random.RandomState(1)
    q, kpool, vpool, tables = _case(rng, kv_heads=2, gqa=1, page_size=8,
                                    pages_per_seq=3, batch=3)
    tables[1] = 0
    tables[2] = 0
    pos = np.asarray([20, 0, 23], np.int32)
    ref = _jax_decode(q, kpool, vpool, tables, pos, "fp32")
    for out in _both((q, kpool, vpool, tables, pos), "fp32", pps):
        np.testing.assert_array_equal(out[1:], 0.0)
        np.testing.assert_allclose(out, ref, atol=FP32_ATOL, rtol=0)


def test_split_of_null_pages_and_live_pages_only_in_the_last_split():
    """Null entries inside live pages, split: row 0 has a whole split of
    null pages (entries 2 and 3 at 2 pages per split, each its own split
    at 1), and row 1's only live pages lie in its last split (entries 0-4
    null). The null splits leave the merge untouched."""
    rng = np.random.RandomState(13)
    q, kpool, vpool, tables = _case(rng, kv_heads=2, gqa=2, page_size=8,
                                    pages_per_seq=6, batch=3)
    tables[0, 2:4] = 0
    tables[1, :5] = 0
    tables[2, 1] = 0
    pos = np.asarray([47, 47, 30], np.int32)
    for dtype in ("fp32", "bf16"):
        ref = _jax_decode(q, kpool, vpool, tables, pos, dtype)
        atol = BF16_ATOL if dtype == "bf16" else FP32_ATOL
        for pps in SPLITS:
            for out in _both((q, kpool, vpool, tables, pos), dtype, pps):
                assert np.isfinite(out).all()
                np.testing.assert_allclose(out, ref, atol=atol, rtol=0)


def test_null_entry_inside_live_pages_is_masked():
    """A null entry among a row's live pages masks that page only."""
    rng = np.random.RandomState(3)
    q, kpool, vpool, tables = _case(rng, kv_heads=1, gqa=2, page_size=8,
                                    pages_per_seq=3, batch=2)
    tables[0, 1] = 0
    pos = np.asarray([20, 20], np.int32)
    ref = _jax_decode(q, kpool, vpool, tables, pos, "fp32")
    for out in _both((q, kpool, vpool, tables, pos), "fp32"):
        np.testing.assert_allclose(out, ref, atol=FP32_ATOL, rtol=0)


def test_nan_past_live_pages_does_not_leak():
    """NaN planted in every page past each row's live count (its own
    reserved-but-unreached pages included) must not reach the output:
    the result equals K4's on the clean pool."""
    rng = np.random.RandomState(2)
    q, kpool, vpool, tables = _case(rng, kv_heads=2, gqa=2, page_size=8,
                                    pages_per_seq=4, batch=2)
    pos = np.asarray([9, 3], np.int32)        # live pages: 2 and 1
    ref = _jax_decode(q, kpool, vpool, tables, pos, "fp32")
    kp, vp = kpool.copy(), vpool.copy()
    for b, live in ((0, 2), (1, 1)):
        for page in tables[b, live:]:
            kp[page] = np.nan
            vp[page] = np.nan
    for out in _both((q, kp, vp, tables, pos), "fp32"):
        assert np.isfinite(out).all()
        np.testing.assert_allclose(out, ref, atol=FP32_ATOL, rtol=0)


@pytest.mark.parametrize("pps", SPLITS)
def test_split_nan_past_live_pages_and_position_does_not_leak(pps):
    """The NaN pins' split twin: NaN in every page past each row's live
    count and in the rows past its position inside its last live page
    must not reach the output of any split."""
    rng = np.random.RandomState(2)
    q, kpool, vpool, tables = _case(rng, kv_heads=2, gqa=2, page_size=8,
                                    pages_per_seq=4, batch=2)
    pos = np.asarray([20, 3], np.int32)       # live pages: 3 and 1
    ref = _jax_decode(q, kpool, vpool, tables, pos, "fp32")
    kp, vp = kpool.copy(), vpool.copy()
    for b, live in ((0, 3), (1, 1)):
        for page in tables[b, live:]:
            kp[page] = vp[page] = np.nan
        first = pos[b] % 8 + 1
        kp[tables[b, live - 1], :, first:] = np.nan
        vp[tables[b, live - 1], :, first:] = np.nan
    for out in _both((q, kp, vp, tables, pos), "fp32", pps):
        assert np.isfinite(out).all()
        np.testing.assert_allclose(out, ref, atol=FP32_ATOL, rtol=0)


@pytest.mark.parametrize("pps", SPLITS)
def test_split_position_past_the_table_walks_the_table_only(pps):
    from deepspeed_tpu_torch.ops.attention.paged import paged_decode_plain
    rng = np.random.RandomState(6)
    case = _case(rng, kv_heads=2, gqa=2, page_size=8, pages_per_seq=3,
                 batch=2)
    last = _torch_args(*case, np.asarray([23, 23], np.int32), "fp32")
    past = _torch_args(*case, np.asarray([24, 90], np.int32), "fp32")
    torch.testing.assert_close(
        paged_decode_plain(*past, pages_per_split=pps),
        paged_decode_plain(*last, pages_per_split=pps), atol=0, rtol=0)


def test_cpu_wrapper_counts_no_launch():
    from deepspeed_tpu_torch.ops.attention.paged import \
        paged_decode_attention
    rng = np.random.RandomState(4)
    args = _torch_args(*_case(rng, 1, 1, 8, 2, batch=2),
                       np.asarray([3, 9], np.int32), "fp32")
    before = paged_decode_attention.launches
    paged_decode_attention(*args)
    assert paged_decode_attention.launches == before


def test_wrapper_refuses_other_devices():
    from deepspeed_tpu_torch.ops.attention.paged import \
        paged_decode_attention
    q = torch.empty((2, 4, 16), device="meta")
    pool = torch.empty((5, 4, 8, 16), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        paged_decode_attention(q, pool, pool,
                               torch.zeros((2, 2), dtype=torch.int32),
                               torch.zeros((2,), dtype=torch.int32))


def test_read_bytes_and_live_pages_match_jax():
    from deepspeed_tpu.ops.attention import paged as jp

    from deepspeed_tpu_torch.ops.attention import paged as tp
    pos = [0, 15, 16, 300, 1023]
    for ps in (8, 16, 128):
        assert tp.decode_read_bytes(pos, ps, 64, 16, 64) == \
            jp.decode_read_bytes(pos, ps, 64, 16, 64)
        assert [tp.live_pages(p, ps) for p in pos] == \
            [jp.live_pages(p, ps) for p in pos]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,kv_heads,gqa,hd,page_size", [
    ("bf16", 16, 1, 64, 16),      # the GPT-2 345M serving shapes
    ("bf16", 2, 4, 128, 16),      # GQA
    ("fp32", 4, 2, 64, 128),      # fp32, wide pages
    ("bf16", 2, 8, 256, 8),       # widest head, largest group
    ("bf16", 2, 2, 256, 128),     # bf16 pages of 128 at the widest head
])
def test_cuda_kernel_matches_plain(dtype, kv_heads, gqa, hd, page_size):
    """The sm_90a kernels against their plain version on the card, with
    the cache-position edges, an all-null row, a null entry inside live
    pages and NaN past the live pages: at split_plan's split and at 1 and
    3 pages per split, each against the plain version with the same
    split, and in bf16 also within BF16_ATOL of the one walk (JAX's).
    Two calls give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from deepspeed_tpu_torch.ops.attention.paged import (
        paged_decode_attention, paged_decode_plain, split_plan)
    rng = np.random.RandomState(hd + gqa)
    P = 4
    q, kpool, vpool, tables = _case(rng, kv_heads, gqa, page_size, P, hd=hd,
                                    batch=7)
    tables[5] = 0
    tables[6, 1] = 0
    pos = np.asarray([0, page_size - 1, page_size, page_size + 1,
                      P * page_size - 1, 7, P * page_size - 2], np.int32)
    for b in range(5):
        for page in tables[b, pos[b] // page_size + 1:]:
            kpool[page] = np.nan
            vpool[page] = np.nan
    args = [t.cuda() for t in _torch_args(q, kpool, vpool, tables, pos,
                                          dtype)]
    before = paged_decode_attention.launches
    out = paged_decode_attention(*args)
    torch.cuda.synchronize()
    assert paged_decode_attention.launches == before + 1
    atol, rtol = (CUDA_BF16_ATOL, CUDA_BF16_RTOL) if dtype == "bf16" \
        else (1e-5, 0)
    whole = paged_decode_plain(*args)
    plan = split_plan(7, kv_heads, gqa, hd, page_size, P)
    for pps in (plan, 1, 3):
        got = out if pps == plan else \
            paged_decode_attention(*args, pages_per_split=pps)
        ref = paged_decode_plain(*args, pages_per_split=pps)
        assert torch.isfinite(got).all()
        assert (got[5] == 0).all()
        torch.testing.assert_close(got.float(), ref.float(), atol=atol,
                                   rtol=rtol)
        torch.testing.assert_close(
            got.float(), whole.float(),
            atol=BF16_ATOL if dtype == "bf16" else atol, rtol=0)
    again = paged_decode_attention(*args)
    assert torch.equal(again, out)
    assert math.isfinite(float(out.float().abs().max()))


def test_nan_past_position_inside_last_live_page():
    """Rows past a row's position inside its last live page are never
    read by the port. K4 itself multiplies their masked (zero)
    probabilities by V, so a NaN there reaches its output: the port
    deliberately does not copy that."""
    rng = np.random.RandomState(5)
    q, kpool, vpool, tables = _case(rng, kv_heads=2, gqa=1, page_size=8,
                                    pages_per_seq=2, batch=2)
    pos = np.asarray([10, 4], np.int32)
    clean = _jax_decode(q, kpool, vpool, tables, pos, "fp32")
    kp, vp = kpool.copy(), vpool.copy()
    kp[tables[0, 1], :, 3:] = np.nan       # positions 11.. of row 0
    vp[tables[0, 1], :, 3:] = np.nan
    kp[tables[1, 0], :, 5:] = np.nan       # positions 5.. of row 1
    vp[tables[1, 0], :, 5:] = np.nan
    assert np.isnan(_jax_decode(q, kp, vp, tables, pos, "fp32")).any()
    for out in _both((q, kp, vp, tables, pos), "fp32"):
        np.testing.assert_allclose(out, clean, atol=FP32_ATOL, rtol=0)


def test_position_past_the_table_walks_the_table_only():
    """A position at or past the table's extent reads the P pages the
    table maps and no entry past it (K4 would index past the table)."""
    from deepspeed_tpu_torch.ops.attention.paged import paged_decode_plain
    rng = np.random.RandomState(6)
    case = _case(rng, kv_heads=2, gqa=2, page_size=8, pages_per_seq=2,
                 batch=2)
    last = _torch_args(*case, np.asarray([15, 15], np.int32), "fp32")
    past = _torch_args(*case, np.asarray([16, 40], np.int32), "fp32")
    torch.testing.assert_close(paged_decode_plain(*past),
                               paged_decode_plain(*last), atol=0, rtol=0)


# --------------------------------------------------------------------- #
# the int8-pool arity (K4 with quantized=True)
# --------------------------------------------------------------------- #
def _quantized(kpool, vpool, nb):
    """(kq, vq, kscale, vscale) as numpy, by the JAX package's
    quantize_kv."""
    import jax.numpy as jnp

    from deepspeed_tpu.ops.attention.paged import quantize_kv
    kq, ks = quantize_kv(jnp.asarray(kpool), nb)
    vq, vs = quantize_kv(jnp.asarray(vpool), nb)
    return tuple(np.array(a) for a in (kq, vq, ks, vs))


def _jax_decode_int8(q, kq, vq, ks, vs, tables, pos, dtype):
    """K4's int8 arity in interpret mode; returns fp32 numpy."""
    import jax.numpy as jnp

    from deepspeed_tpu.ops.attention.paged import paged_decode_attention
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    out = paged_decode_attention(
        jnp.asarray(q).astype(jd), jnp.asarray(kq), jnp.asarray(vq),
        jnp.asarray(tables, jnp.int32), jnp.asarray(pos, jnp.int32),
        interpret=True, k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs))
    return np.asarray(out.astype(jnp.float32))


def _both_int8(q, kq, vq, ks, vs, tables, pos, dtype, pages_per_split=None):
    """(plain, wrapper-on-CPU) outputs of the port's int8 arity."""
    from deepspeed_tpu_torch.ops.attention.paged import (
        paged_decode_attention, paged_decode_plain)
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    t = (torch.from_numpy(q).to(td), torch.from_numpy(kq),
         torch.from_numpy(vq), torch.from_numpy(np.asarray(tables, np.int32)),
         torch.from_numpy(np.asarray(pos, np.int32)))
    kw = dict(k_scales=torch.from_numpy(ks), v_scales=torch.from_numpy(vs),
              pages_per_split=pages_per_split)
    return (paged_decode_plain(*t, **kw).float().numpy(),
            paged_decode_attention(*t, **kw).float().numpy())


@pytest.mark.parametrize("nb", [1, 2, 4])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_quantize_kv_bitwise_equal_jax(dtype, nb):
    """Payload and scales hold the JAX function's bits: one fp32
    division for the scale, round half to even, a zero block at scale 1.
    dequantize_pool inverts it with the same bits too."""
    import jax.numpy as jnp

    from deepspeed_tpu.ops.attention import paged as jp

    from deepspeed_tpu_torch.ops.attention import paged as tp
    rng = np.random.RandomState(nb)
    x = (rng.randn(3, 2, 5, 16) * rng.choice([1e-3, 1.0, 30.0],
                                             size=(3, 2, 5, 1))
         ).astype(np.float32)
    x[0, 0, 0] = 0.0                       # a zero row
    x[1, 1, 2, :16 // nb] = 0.0            # a zero block
    x[2, 0, 1] = np.round(x[2, 0, 1]) + 0.5    # values on rounding ties
    jd, td = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
              else (jnp.float32, torch.float32))
    jq, js = jp.quantize_kv(jnp.asarray(x).astype(jd), nb)
    tq, ts = tp.quantize_kv(torch.from_numpy(x).to(td), nb)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert ts.shape == (3, 2, 5, nb)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert (ts.numpy()[0, 0, 0] == 1.0).all() and ts.numpy()[1, 1, 2, 0] == 1
    np.testing.assert_array_equal(
        tp.dequantize_pool(tq, ts).numpy(),
        np.asarray(jp.dequantize_pool(jq, js)))


@functools.lru_cache(maxsize=None)
def _int8_sweep_case(page_size, gqa, nb, dtype):
    """The int8 sweep's inputs (the cache-position edges in one batch)
    and K4's int8 output on them, computed once per case."""
    rng = np.random.RandomState(page_size + gqa + nb)
    P = 3
    q, kpool, vpool, tables = _case(rng, kv_heads=2, gqa=gqa,
                                    page_size=page_size, pages_per_seq=P)
    kq, vq, ks, vs = _quantized(kpool, vpool, nb)
    pos = np.asarray([0, page_size - 1, page_size, page_size + 1,
                      P * page_size - 1], np.int32)
    ref = _jax_decode_int8(q, kq, vq, ks, vs, tables, pos, dtype)
    return (q, kq, vq, ks, vs, tables, pos), ref


def _int8_tol(dtype):
    return ((INT8_BF16_ATOL, INT8_BF16_RTOL) if dtype == "bf16"
            else (FP32_ATOL, 0))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("nb", [1, 2])
@pytest.mark.parametrize("gqa", [1, 4])
@pytest.mark.parametrize("page_size", [8, 16])
def test_int8_matches_jax_kernel_sweep(page_size, gqa, nb, dtype):
    """The int8 arity against K4 (quantized) in interpret mode, with the
    cache-position edges in one batch. Every product is fp32 on both
    sides, so fp32 q holds FP32_ATOL (a plain version that rounded p as
    the dense arity does would miss it by orders); bf16 q adds only the
    output's rounding, which may land one bf16 ulp apart
    (INT8_BF16_ATOL + INT8_BF16_RTOL |ref|)."""
    args, ref = _int8_sweep_case(page_size, gqa, nb, dtype)
    atol, rtol = _int8_tol(dtype)
    for out in _both_int8(*args, dtype):
        np.testing.assert_allclose(out, ref, atol=atol, rtol=rtol)


@pytest.mark.parametrize("pps", SPLITS)
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("nb", [1, 2])
@pytest.mark.parametrize("gqa", [1, 4])
@pytest.mark.parametrize("page_size", [8, 16])
def test_int8_split_matches_jax_kernel_sweep(page_size, gqa, nb, dtype, pps):
    """The int8 sweep's split twin: nothing is rounded, so the merged
    splits hold the same tolerances as the one walk."""
    args, ref = _int8_sweep_case(page_size, gqa, nb, dtype)
    atol, rtol = _int8_tol(dtype)
    for out in _both_int8(*args, dtype, pps):
        np.testing.assert_allclose(out, ref, atol=atol, rtol=rtol)


def test_int8_poisoned_dead_pages_and_scales_do_not_leak():
    """Garbage payload under NaN scales in every page past each row's
    live count must not reach the output: the result equals K4's on the
    clean pools."""
    rng = np.random.RandomState(12)
    q, kpool, vpool, tables = _case(rng, kv_heads=2, gqa=2, page_size=8,
                                    pages_per_seq=4, batch=2)
    kq, vq, ks, vs = _quantized(kpool, vpool, 2)
    pos = np.asarray([9, 3], np.int32)        # live pages: 2 and 1
    ref = _jax_decode_int8(q, kq, vq, ks, vs, tables, pos, "fp32")
    for b, live in ((0, 2), (1, 1)):
        for page in tables[b, live:]:
            kq[page] = vq[page] = -128
            ks[page] = vs[page] = np.nan
    for out in _both_int8(q, kq, vq, ks, vs, tables, pos, "fp32"):
        assert np.isfinite(out).all()
        np.testing.assert_allclose(out, ref, atol=FP32_ATOL, rtol=0)


def test_int8_shared_prefix_pages_share_their_scales():
    """Two rows whose tables point at the same physical pages read the
    same payload and the same scale pages."""
    rng = np.random.RandomState(10)
    q, kpool, vpool, tables = _case(rng, kv_heads=2, gqa=2, page_size=8,
                                    pages_per_seq=3, batch=3)
    kq, vq, ks, vs = _quantized(kpool, vpool, 1)
    tables[1] = tables[0]
    q[1] = q[0]
    pos = np.asarray([17, 17, 5], np.int32)
    ref = _jax_decode_int8(q, kq, vq, ks, vs, tables, pos, "fp32")
    for out in _both_int8(q, kq, vq, ks, vs, tables, pos, "fp32"):
        np.testing.assert_allclose(out, ref, atol=FP32_ATOL, rtol=0)
        np.testing.assert_array_equal(out[0], out[1])
        assert not np.allclose(out[0], out[2])


def test_int8_all_null_rows_are_zero():
    rng = np.random.RandomState(11)
    q, kpool, vpool, tables = _case(rng, kv_heads=2, gqa=1, page_size=8,
                                    pages_per_seq=2, batch=3)
    kq, vq, ks, vs = _quantized(kpool, vpool, 1)
    tables[1] = 0
    tables[2] = 0
    pos = np.asarray([9, 0, 15], np.int32)
    ref = _jax_decode_int8(q, kq, vq, ks, vs, tables, pos, "fp32")
    np.testing.assert_array_equal(ref[1:], 0.0)
    for out in _both_int8(q, kq, vq, ks, vs, tables, pos, "fp32"):
        np.testing.assert_array_equal(out[1:], 0.0)
        np.testing.assert_allclose(out, ref, atol=FP32_ATOL, rtol=0)


def test_int8_unwritten_rows_inside_last_live_page_are_never_read():
    """An unwritten row's scale may be anything, NaN included. K4
    dequantizes the whole tile and multiplies the masked (zero)
    probabilities by V, so a NaN scale past ``pos`` reaches its output;
    the port never reads those rows."""
    rng = np.random.RandomState(15)
    q, kpool, vpool, tables = _case(rng, kv_heads=2, gqa=1, page_size=8,
                                    pages_per_seq=2, batch=2)
    kq, vq, ks, vs = _quantized(kpool, vpool, 1)
    pos = np.asarray([10, 4], np.int32)
    clean = _jax_decode_int8(q, kq, vq, ks, vs, tables, pos, "fp32")
    ks[tables[0, 1], :, 3:] = vs[tables[0, 1], :, 3:] = np.nan
    ks[tables[1, 0], :, 5:] = vs[tables[1, 0], :, 5:] = np.nan
    assert np.isnan(_jax_decode_int8(q, kq, vq, ks, vs, tables, pos,
                                     "fp32")).any()
    for out in _both_int8(q, kq, vq, ks, vs, tables, pos, "fp32"):
        np.testing.assert_allclose(out, clean, atol=FP32_ATOL, rtol=0)


def test_int8_position_past_the_table_walks_the_table_only():
    rng = np.random.RandomState(16)
    q, kpool, vpool, tables = _case(rng, kv_heads=2, gqa=2, page_size=8,
                                    pages_per_seq=2, batch=2)
    quant = _quantized(kpool, vpool, 2)
    last = _both_int8(q, *quant, tables, np.asarray([15, 15]), "fp32")[0]
    past = _both_int8(q, *quant, tables, np.asarray([16, 40]), "fp32")[0]
    np.testing.assert_array_equal(past, last)


@pytest.mark.parametrize("pps", SPLITS)
def test_int8_split_null_rows_null_splits_and_poison(pps):
    """The int8 pins' split twin: an all-null row is exactly 0; a whole
    split of null pages (row 0, entries 2-3), a row whose live pages lie
    only in its last split (row 1) and garbage payload under NaN scales
    in every row past each position do not reach the output."""
    rng = np.random.RandomState(17)
    q, kpool, vpool, tables = _case(rng, kv_heads=2, gqa=2, page_size=8,
                                    pages_per_seq=6, batch=4)
    kq, vq, ks, vs = _quantized(kpool, vpool, 2)
    tables[0, 2:4] = 0
    tables[1, :5] = 0
    tables[3] = 0
    pos = np.asarray([44, 47, 20, 9], np.int32)
    ref = _jax_decode_int8(q, kq, vq, ks, vs, tables, pos, "fp32")
    np.testing.assert_array_equal(ref[3], 0.0)
    for b in range(3):
        last = pos[b] // 8
        for i in range(last, 6):
            dead = pos[b] % 8 + 1 if i == last else 0
            page = tables[b, i]
            if page:
                kq[page, :, dead:] = vq[page, :, dead:] = -128
                ks[page, :, dead:] = vs[page, :, dead:] = np.nan
    for out in _both_int8(q, kq, vq, ks, vs, tables, pos, "fp32", pps):
        assert np.isfinite(out).all()
        np.testing.assert_array_equal(out[3], 0.0)
        np.testing.assert_allclose(out, ref, atol=FP32_ATOL, rtol=0)


@pytest.mark.parametrize("pps", SPLITS)
def test_int8_split_position_past_the_table_walks_the_table_only(pps):
    rng = np.random.RandomState(16)
    q, kpool, vpool, tables = _case(rng, kv_heads=2, gqa=2, page_size=8,
                                    pages_per_seq=3, batch=2)
    quant = _quantized(kpool, vpool, 2)
    last = _both_int8(q, *quant, tables, np.asarray([23, 23]), "fp32",
                      pps)[0]
    past = _both_int8(q, *quant, tables, np.asarray([24, 70]), "fp32",
                      pps)[0]
    np.testing.assert_array_equal(past, last)


def test_int8_wrapper_wants_both_scales_and_counts_no_cpu_launch():
    from deepspeed_tpu_torch.ops.attention.paged import \
        paged_decode_attention
    rng = np.random.RandomState(14)
    q, kpool, vpool, tables = _case(rng, 1, 1, 8, 2, batch=2)
    kq, vq, ks, vs = _quantized(kpool, vpool, 1)
    args = (torch.from_numpy(q), torch.from_numpy(kq), torch.from_numpy(vq),
            torch.from_numpy(tables), torch.tensor([3, 9], dtype=torch.int32))
    with pytest.raises(ValueError, match="both k_scales and v_scales"):
        paged_decode_attention(*args, k_scales=torch.from_numpy(ks))
    before = (paged_decode_attention.launches,
              paged_decode_attention.launches_int8)
    paged_decode_attention(*args, k_scales=torch.from_numpy(ks),
                           v_scales=torch.from_numpy(vs))
    assert (paged_decode_attention.launches,
            paged_decode_attention.launches_int8) == before


def test_int8_read_bytes_match_jax():
    from deepspeed_tpu.ops.attention import paged as jp

    from deepspeed_tpu_torch.ops.attention import paged as tp
    pos = [0, 15, 16, 300, 1023]
    for nb in (1, 4):
        assert tp.decode_read_bytes(pos, 16, 64, 8, 64, dtype_bytes=1,
                                    scale_blocks=nb) == \
            jp.decode_read_bytes(pos, 16, 64, 8, 64, dtype_bytes=1,
                                 scale_blocks=nb)


# the int8 kernel against its plain version on the card: every product
# is fp32 in both; bf16 q adds one bf16 ulp of the output's rounding
CUDA_INT8_TOL = {"bf16": dict(atol=1e-4, rtol=2.0**-7),
                 "fp32": dict(atol=1e-5, rtol=1e-4)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,kv_heads,gqa,hd,page_size,nb", [
    ("bf16", 8, 4, 64, 16, 1),     # the Llama serving shapes
    ("bf16", 16, 1, 64, 16, 1),    # the GPT-2 345M serving shapes
    ("fp32", 4, 1, 128, 8, 2),     # fp32 q, short pages, two blocks
    ("bf16", 2, 4, 128, 16, 4),    # four scale blocks
    ("fp32", 2, 8, 256, 8, 32),    # widest head, largest group, 8-wide blocks
    ("fp32", 4, 2, 64, 128, 1),    # wide pages
])
def test_cuda_int8_kernel_matches_plain(dtype, kv_heads, gqa, hd, page_size,
                                        nb):
    """The sm_90a int8 kernel against its plain version on the card, with
    the cache-position edges, an all-null row, and garbage payload under
    NaN scales in every row past each position."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from deepspeed_tpu_torch.ops.attention.paged import (
        paged_decode_attention, paged_decode_plain, quantize_kv, split_plan)
    rng = np.random.RandomState(hd + gqa + nb)
    P = 4
    q, kpool, vpool, tables = _case(rng, kv_heads, gqa, page_size, P, hd=hd,
                                    batch=7)
    tables[5] = 0
    pos = np.asarray([0, page_size - 1, page_size, page_size + 1,
                      P * page_size - 1, 7, P * page_size + 3], np.int32)
    kq, ks = quantize_kv(torch.from_numpy(kpool), nb)
    vq, vs = quantize_kv(torch.from_numpy(vpool), nb)
    for b in (0, 1, 2, 3, 4):
        last = pos[b] // page_size
        for i in range(last, P):
            dead = pos[b] % page_size + 1 if i == last else 0
            for payload, scales in ((kq, ks), (vq, vs)):
                payload[tables[b, i], :, dead:] = -128
                scales[tables[b, i], :, dead:] = float("nan")
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    args = (torch.from_numpy(q).to(td).cuda(), kq.cuda(), vq.cuda(),
            torch.from_numpy(tables).cuda(), torch.from_numpy(pos).cuda())
    kw = dict(k_scales=ks.cuda(), v_scales=vs.cuda())
    before = (paged_decode_attention.launches,
              paged_decode_attention.launches_int8)
    out = paged_decode_attention(*args, **kw)
    torch.cuda.synchronize()
    assert (paged_decode_attention.launches,
            paged_decode_attention.launches_int8) == (before[0],
                                                      before[1] + 1)
    whole = paged_decode_plain(*args, **kw)
    plan = split_plan(7, kv_heads, gqa, hd, page_size, P)
    for pps in (plan, 1, 3):
        got = out if pps == plan else \
            paged_decode_attention(*args, pages_per_split=pps, **kw)
        ref = paged_decode_plain(*args, pages_per_split=pps, **kw)
        assert torch.isfinite(got).all()
        assert (got[5] == 0).all()
        torch.testing.assert_close(got.float(), ref.float(),
                                   **CUDA_INT8_TOL[dtype])
        torch.testing.assert_close(got.float(), whole.float(),
                                   **CUDA_INT8_TOL[dtype])
    assert torch.equal(paged_decode_attention(*args, **kw), out)


@pytest.mark.cuda
def test_cuda_int8_wrapper_raises_and_never_falls_back():
    """On CUDA tensors the wrapper launches the kernel or raises: a
    head_dim that is no multiple of 16, bf16 scales, and float pools
    passed with scales are all refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from deepspeed_tpu_torch.ops.attention.paged import \
        paged_decode_attention

    def call(hd=64, pool_dtype=torch.int8, scale_dtype=torch.float32):
        q = torch.zeros((2, 4, hd), device="cuda")
        pool = torch.zeros((5, 2, 8, hd), dtype=pool_dtype, device="cuda")
        sc = torch.ones((5, 2, 8, 1), dtype=scale_dtype, device="cuda")
        return paged_decode_attention(
            q, pool, pool, torch.zeros((2, 2), dtype=torch.int32,
                                       device="cuda"),
            torch.zeros((2,), dtype=torch.int32, device="cuda"),
            k_scales=sc, v_scales=sc)
    assert (call() == 0).all()
    with pytest.raises(ValueError, match="multiple of 16"):
        call(hd=24)
    with pytest.raises(TypeError, match="int8 pools and fp32 scales"):
        call(scale_dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="int8 pools and fp32 scales"):
        call(pool_dtype=torch.float32)
