"""Elementwise building blocks and the vocab GEMM (the port of
``deepspeed_tpu/ops/functional.py``'s ``layer_norm``, ``rms_norm``,
``_hash_keep_mask``, ``dropout`` and ``matmul_bf16_accum_fp32``).

GELU is written at its call site, as in the JAX models: GPT-2's is
``F.gelu(x, approximate="tanh")`` (``jax.nn.gelu(approximate=True)``),
BERT's and the transformer layer's the exact ``F.gelu(x)``
(``jax.nn.gelu(approximate=False)``).

``dropout`` takes its 32-bit seed directly: the JAX function folds it out
of a ``jax.random`` key's data, which torch cannot reproduce. Given the
same seed, the keep mask is the JAX package's bit for bit (the hash runs
in int64 with the uint32 wrap-around done by hand; see
``ops/attention/flash.py``).

Under data parallelism a rank holds rows ``[row0, row0 + micro)`` of the
global batch, and JAX's sharded program draws its masks by the global
row (a dropout's counter runs over the whole global tensor, the
attention kernels hash ``b * H + h`` of the global ``b``).
:func:`batch_rows` sets ``row0`` for the block it wraps: :func:`dropout`
then starts its counter at the rank's first element, and
``flash_attention`` offsets the kernels' ``b * H + h`` by ``row0 * H``,
so a rank draws the masks of its rows of the global batch.
"""

import contextlib
import contextvars

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.ops.attention.flash import (_M32, _mix32, _mul32,
                                                     keep_threshold)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-12) -> torch.Tensor:
    """LayerNorm with fp32 statistics whatever the input dtype (biased
    variance, as the JAX version), output in the input dtype."""
    out = F.layer_norm(x.float(), (x.shape[-1],), w.float(), b.float(),
                       eps)
    return out.to(x.dtype)


def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with fp32 statistics (no mean subtraction, no bias),
    output in the input dtype: the pre-norm of the llama family."""
    x32 = x.float()
    ms = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(ms + eps) * w.float()).to(x.dtype)


def _hash_keep_mask(seed32: int, n: int, rate: float,
                    device=None) -> torch.Tensor:
    """lowbias32-style counter hash over ``0..n-1`` -> bool keep mask of
    n elements (True = keep)."""
    return _hash_keep_mask_from(seed32, 0, n, rate, device)


def fold_seed(seed: int, i: int) -> int:
    """The int32 seed of dropout site ``i`` under a step's seed: one
    round of the dropout hash, so sites draw independent masks. (The JAX
    models split a ``jax.random`` key per site; torch cannot derive the
    same keys, so the port's sites take these seeds instead.)"""
    x = _mix32((int(seed) & _M32) ^ _mul32((i + 1) & _M32, 0x9E3779B9))
    return x - (1 << 32) if x >= (1 << 31) else x


_ROW0 = contextvars.ContextVar("batch_row0", default=0)


@contextlib.contextmanager
def batch_rows(row0: int):
    """Within the block, the tensors a loss sees hold the rows of the
    global batch from ``row0`` on (their leading dim is the batch): the
    dropouts draw those rows' masks."""
    token = _ROW0.set(int(row0))
    try:
        yield
    finally:
        _ROW0.reset(token)


def batch_row0() -> int:
    """The first global batch row of the block (0 outside
    :func:`batch_rows`)."""
    return _ROW0.get()


def _hash_keep_mask_from(seed32: int, start: int, n: int, rate: float,
                         device=None) -> torch.Tensor:
    """:func:`_hash_keep_mask`'s elements ``start .. start + n - 1``."""
    x = torch.arange(start, start + n, dtype=torch.int64, device=device) \
        ^ (int(seed32) & _M32)
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    x = x ^ (x >> 16)
    return x < keep_threshold(rate)


def dropout(x: torch.Tensor, rate: float, seed32, deterministic: bool):
    """Inverted dropout with the hash keep mask of ``seed32``; identity
    when deterministic, rate == 0 or ``seed32`` is None. Inside
    :func:`batch_rows` the mask is that of ``x``'s rows of the global
    batch (``x``'s leading dim is the batch)."""
    if deterministic or rate == 0.0 or seed32 is None:
        return x
    keep = 1.0 - rate
    start = batch_row0() * (x.numel() // x.shape[0]) if x.dim() else 0
    mask = _hash_keep_mask_from(seed32, start, x.numel(), rate,
                                device=x.device).reshape(x.shape)
    return torch.where(mask, x / keep, torch.zeros_like(x))


@contextlib.contextmanager
def ieee_fp32_matmul():
    """fp32 matmuls in full fp32 on the card (TF32 off) for the block."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _operand_dtype(x: torch.Tensor):
    return x.dtype if x.dtype in (torch.bfloat16, torch.float16) \
        else torch.bfloat16


class _MatmulBf16AccumFp32(torch.autograd.Function):
    """``x @ w_t.T`` over bf16-rounded operands with fp32 sums and an fp32
    result, and a backward that keeps the rounded operands and returns
    fp32 sums cast to each input's dtype (the JAX custom VJP). Each
    product is an fp32 GEMM of the widened operands with TF32 off: the
    product of two bf16 values is exact in fp32, so this is the bf16
    GEMM with fp32 accumulation and output, on the CPU as on the card,
    by the route the GPT-2 head takes (``models/gpt2.py``)."""

    @staticmethod
    def forward(ctx, x, w_t):
        dt = _operand_dtype(x)
        xb, wb = x.to(dt), w_t.to(dt)
        ctx.save_for_backward(xb, wb)
        ctx.dtypes = (x.dtype, w_t.dtype)
        with ieee_fp32_matmul():
            return xb.float() @ wb.float().t()

    @staticmethod
    def backward(ctx, g):
        xb, wb = ctx.saved_tensors
        gb = g.to(xb.dtype).float()
        with ieee_fp32_matmul():
            dx = (gb @ wb.float()).to(ctx.dtypes[0])
            dw = (gb.reshape(-1, gb.shape[-1]).t()
                  @ xb.reshape(-1, xb.shape[-1]).float()).to(ctx.dtypes[1])
        return dx, dw


def matmul_bf16_accum_fp32(x: torch.Tensor, w_t: torch.Tensor):
    """``x @ w_t.T`` with bf16-cast operands (fp16 ones stay fp16) and
    fp32 accumulation and result, the vocab projection's product.
    ``w_t``: (vocab, hidden). Gradients: fp32 sums, cast to x's and
    w_t's dtypes."""
    return _MatmulBf16AccumFp32.apply(x, w_t)
