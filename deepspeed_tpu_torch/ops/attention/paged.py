"""Paged-decode attention: one query token per row, straight against the
page pool (the port of ``deepspeed_tpu/ops/attention/paged.py``, both
pool arities).

- :func:`paged_decode_attention` — the wrapper. For CUDA tensors it
  launches a hand-written kernel (built with nvcc for sm_90a at first
  use) or raises; it never falls back. Both arities are one kernel body
  in ``csrc/paged_decode.cu`` with a tile loader and an entry point
  each: ``paged_decode`` for a dense pool (bf16 or fp32, q's dtype) and
  ``paged_decode_int8`` for an int8 pool with its fp32 scale pools
  (``k_scales``/``v_scales``, both or neither). For CPU tensors it runs
  :func:`paged_decode_plain`. Each launch adds one to
  ``paged_decode_attention.launches`` (dense kernel) or
  ``paged_decode_attention.launches_int8`` (int8 kernel).
- :func:`paged_decode_plain` — the same function in plain PyTorch. It
  walks the pages the way the Pallas kernel does (online softmax per
  page in fp32), so it reproduces the kernel's semantics: the page-0
  mask, and a zero row where nothing is visible. The dense arity rounds
  the probabilities to the pool dtype before the P.V product; the int8
  arity dequantizes each walked tile to fp32 and rounds nothing.
- :func:`quantize_kv` / :func:`dequantize_pool` — the int8 pool's write
  and read math: symmetric absmax int8 per token row, in ``nb`` blocks
  along head_dim, with fp32 scales.

Replaces ``deepspeed_tpu/ops/attention/paged.py::_decode_kernel`` (built
by ``_paged_decode_pallas``, with and without ``quantized``). Unlike the
TPU, Hopper has no 128-lane rule, so head_dim 64 runs the kernels; there
is no geometry fallback to the gather path.
"""

import ctypes
import math
from typing import Optional, Sequence

import torch

__all__ = ["paged_decode_attention", "paged_decode_plain",
           "decode_read_bytes", "live_pages", "quantize_kv",
           "dequantize_pool"]

NEG_INF = -1e30   # finite, as the JAX kernels' NEG_INF

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
MAX_PAGE_SIZE = 128
MAX_GROUP = 8


def live_pages(cache_position, page_size: int):
    """Pages a row at ``cache_position`` (its just-written token's
    position) actually reads: positions ``0..cache_position`` span
    ``cache_position // page_size + 1`` pages. Works on ints and
    tensors."""
    return cache_position // page_size + 1


def decode_read_bytes(cache_positions: Sequence[int], page_size: int,
                      pages_per_seq: int, kv_heads: int, head_dim: int,
                      dtype_bytes: int = 2, scale_blocks: int = 0):
    """Modeled K+V bytes one decode step reads from the pool, per layer
    for the whole batch: ``(paged_bytes, gather_bytes)``. The paged
    kernel reads each row's live pages once; the gather path
    materializes the full ``pages_per_seq``-wide stripe per row. For the
    int8 pool pass ``dtype_bytes=1`` and the spec's ``scale_blocks``:
    each token row also streams its fp32 scales (K and V)."""
    positions = [int(p) for p in cache_positions]
    per_tok = kv_heads * head_dim * dtype_bytes * 2          # K and V
    per_tok += kv_heads * scale_blocks * 4 * 2               # fp32 scales
    paged = sum(live_pages(p, page_size) * page_size * per_tok
                for p in positions)
    gather = len(positions) * pages_per_seq * page_size * per_tok
    return paged, gather


def quantize_kv(x: torch.Tensor, scale_blocks: int = 1):
    """Symmetric int8 absmax quantization of new K/V values per token
    row: ``x`` (..., hd) float -> ``(q (..., hd) int8, scales (..., nb)
    fp32)`` with ``nb = scale_blocks`` blocks along head_dim. A zero
    block takes scale 1. Rounds half to even and divides once in fp32,
    as the JAX function, so payload and scales are the same bits."""
    hd = x.shape[-1]
    nb = max(int(scale_blocks), 1)
    xb = x.float().reshape(x.shape[:-1] + (nb, hd // nb))
    absmax = xb.abs().amax(dim=-1)
    scale = torch.where(absmax > 0, absmax / 127.0,
                        torch.ones_like(absmax))
    q = torch.clamp(torch.round(xb / scale[..., None]), -127, 127)
    return q.reshape(x.shape).to(torch.int8), scale


def dequantize_pool(pool: torch.Tensor, scales: torch.Tensor):
    """fp32 view of an int8 pool (or any gathered part of one): ``pool``
    (..., page_size, hd) int8, ``scales`` (..., page_size, nb) fp32
    per-token-row scales with nb dividing hd."""
    hd = pool.shape[-1]
    nb = scales.shape[-1]
    return pool.float() * scales.repeat_interleave(hd // nb, dim=-1)


def paged_decode_plain(q, kpool, vpool, block_tables, cache_position,
                       sm_scale: Optional[float] = None, k_scales=None,
                       v_scales=None) -> torch.Tensor:
    """Plain PyTorch paged decode attention with the kernels' semantics.

    q: (B, H, hd); kpool/vpool: (num_pages, KH, page_size, hd) with
    H % KH == 0; block_tables: (B, P) int; cache_position: (B,) int —
    the position of the already-written current token. Row b attends
    positions ``<= cache_position[b]`` over its first
    ``min(cache_position // page_size + 1, P)`` table entries; entries
    that are the null page 0 (or outside ``[1, num_pages)``) are masked,
    and a row with nothing visible returns 0. With ``k_scales`` and
    ``v_scales`` ((num_pages, KH, page_size, nb) fp32) the pools are
    int8: each walked tile is dequantized to fp32 and every product
    stays fp32. Returns (B, H, hd) in q's dtype."""
    B, H, hd = q.shape
    N, KH, ps, _ = kpool.shape
    G = H // KH
    P = block_tables.shape[1]
    quantized = k_scales is not None
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(hd)
    tables = block_tables.long()
    pos = cache_position.long()
    num_pg = torch.where(pos < 0, torch.zeros_like(pos),
                         torch.clamp(pos // ps + 1, max=P))
    qg = q.reshape(B, KH, G, hd).float()
    m = torch.full((B, KH, G), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, KH, G), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, KH, G, hd), dtype=torch.float32, device=q.device)
    offs = torch.arange(ps, device=q.device)
    walk = int(num_pg.max()) if B else 0
    for i in range(walk):
        page = tables[:, i]
        live = (i < num_pg) & (page > 0) & (page < N)            # (B,)
        safe = torch.where(live, page, torch.zeros_like(page))
        valid = live[:, None] & (i * ps + offs[None, :] <= pos[:, None])
        if quantized:
            kt = dequantize_pool(kpool[safe], k_scales[safe])
            vt = dequantize_pool(vpool[safe], v_scales[safe])
        else:
            kt = kpool[safe].float()                             # (B,KH,ps,hd)
            vt = vpool[safe].float()
        # masked rows never reach the sums, whatever the pool holds there
        vt = torch.where(valid[:, None, :, None], vt, 0.0)
        s = torch.einsum("bkgd,bktd->bkgt", qg, kt) * sm_scale
        vmask = valid[:, None, None, :]
        s = torch.where(vmask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(vmask, torch.exp(s - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(dim=-1)
        if not quantized:
            p = p.to(vpool.dtype).float()
        acc = acc * alpha[..., None] + torch.einsum("bkgt,bktd->bkgd", p, vt)
        m = m_new
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc / l_safe[..., None]).to(q.dtype).reshape(B, H, hd)


def _check_cuda_args(q, kpool, vpool, tables, positions, k_scales,
                     v_scales):
    B, H, hd = q.shape
    N, KH, ps, hd_k = kpool.shape
    dev = q.device
    quantized = k_scales is not None
    tensors = [("kpool", kpool), ("vpool", vpool), ("tables", tables),
               ("positions", positions)]
    if quantized:
        tensors += [("k_scales", k_scales), ("v_scales", v_scales)]
    for name, t in tensors:
        if t.device != dev:
            raise ValueError(f"paged decode: {name} on {t.device}, q on "
                             f"{dev}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"paged decode kernels take q in "
                        f"{list(_DTYPE_CODE)}, got {q.dtype}")
    if quantized:
        if kpool.dtype != torch.int8 or vpool.dtype != torch.int8 or \
                k_scales.dtype != torch.float32 or \
                v_scales.dtype != torch.float32:
            raise TypeError(
                f"int8 paged decode kernel takes int8 pools and fp32 "
                f"scales, got kpool {kpool.dtype}, vpool {vpool.dtype}, "
                f"k_scales {k_scales.dtype}, v_scales {v_scales.dtype}")
    elif kpool.dtype != q.dtype or vpool.dtype != q.dtype:
        raise TypeError(
            f"paged decode kernel takes q and pools of one dtype in "
            f"{list(_DTYPE_CODE)}, got q {q.dtype}, kpool {kpool.dtype}, "
            f"vpool {vpool.dtype}")
    if vpool.shape != kpool.shape or hd_k != hd or H % KH != 0:
        raise ValueError(f"paged decode shapes: q {tuple(q.shape)}, kpool "
                         f"{tuple(kpool.shape)}, vpool {tuple(vpool.shape)}")
    # 16-byte vector loads of a token row: 8 bf16/4 fp32 values, 16 int8
    row_multiple = 16 if quantized else 8
    if hd % row_multiple != 0 or hd > MAX_HEAD_DIM:
        raise ValueError(
            f"paged decode kernel takes head_dim a multiple of "
            f"{row_multiple} up to {MAX_HEAD_DIM} for "
            f"{'int8' if quantized else 'dense'} pools, got {hd}")
    if ps > MAX_PAGE_SIZE or H // KH > MAX_GROUP:
        raise ValueError(f"paged decode kernel takes page_size <= "
                         f"{MAX_PAGE_SIZE} and q/kv head groups <= "
                         f"{MAX_GROUP}, got {ps} and {H // KH}")
    if tables.dim() != 2 or tables.shape[0] != B or \
            positions.shape != (B,):
        raise ValueError(f"paged decode: tables {tuple(tables.shape)} and "
                         f"positions {tuple(positions.shape)} for batch {B}")
    aligned = [("q", q), ("kpool", kpool), ("vpool", vpool)]
    if quantized:
        nb = k_scales.shape[-1]
        if k_scales.shape != (N, KH, ps, nb) or \
                v_scales.shape != k_scales.shape or nb < 1 or hd % nb != 0:
            raise ValueError(
                f"int8 paged decode: scales {tuple(k_scales.shape)} and "
                f"{tuple(v_scales.shape)} for pools {tuple(kpool.shape)}; "
                f"want (num_pages, kv_heads, page_size, nb) with nb "
                f"dividing head_dim")
        # the kernel reads scales one fp32 at a time: no vector alignment
        for name, t in (("k_scales", k_scales), ("v_scales", v_scales)):
            if not t.is_contiguous():
                raise ValueError(f"int8 paged decode kernel needs {name} "
                                 f"contiguous")
    for name, t in aligned:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"paged decode kernel needs {name} contiguous "
                             f"and 16-byte aligned")


_kernel_fns = {}


def _kernel(quantized: bool):
    """A kernel's C entry point, built and typed at first use."""
    fn = _kernel_fns.get(quantized)
    if fn is None:
        from deepspeed_tpu_torch.ops._build import load
        lib = load("paged_decode.cu")
        if quantized:
            fn = lib.paged_decode_int8
            fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + \
                [ctypes.c_float, ctypes.c_void_p]
        else:
            fn = lib.paged_decode
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + \
                [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _kernel_fns[quantized] = fn
    return fn


def paged_decode_attention(q, kpool, vpool, block_tables, cache_position,
                           sm_scale: Optional[float] = None, k_scales=None,
                           v_scales=None) -> torch.Tensor:
    """Decode attention straight from the page pool — O(live tokens).

    Shapes and semantics as :func:`paged_decode_plain`;
    ``k_scales``/``v_scales`` (both or neither) select the int8-pool
    arity. A CUDA ``q`` launches the arity's sm_90a kernel (raising on
    any dtype, shape, device or launch problem); a CPU ``q`` runs the
    plain version."""
    if q.dim() != 3 or kpool.dim() != 4:
        raise ValueError(f"paged decode takes (B, H, hd) queries and "
                         f"(N, KH, page_size, hd) pools, got "
                         f"{tuple(q.shape)}, {tuple(kpool.shape)}")
    if (k_scales is None) != (v_scales is None):
        raise ValueError("int8 pool needs both k_scales and v_scales")
    quantized = k_scales is not None
    if q.device.type == "cpu":
        return paged_decode_plain(q, kpool, vpool, block_tables,
                                  cache_position, sm_scale, k_scales,
                                  v_scales)
    if q.device.type != "cuda":
        raise ValueError(f"paged decode runs on cuda or cpu, not "
                         f"{q.device}")
    tables = block_tables.to(torch.int32).contiguous()
    positions = cache_position.to(torch.int32).contiguous()
    _check_cuda_args(q, kpool, vpool, tables, positions, k_scales, v_scales)
    B, H, hd = q.shape
    N, KH, ps, _ = kpool.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(hd)
    out = torch.empty_like(q)
    if B == 0:
        return out
    fn = _kernel(quantized)

    def launch():
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if quantized:
            return fn(q.data_ptr(), kpool.data_ptr(), vpool.data_ptr(),
                      k_scales.data_ptr(), v_scales.data_ptr(),
                      tables.data_ptr(), positions.data_ptr(),
                      out.data_ptr(), _DTYPE_CODE[q.dtype], B, N, KH, ps, hd,
                      H // KH, tables.shape[1], k_scales.shape[-1],
                      float(sm_scale), stream)
        return fn(q.data_ptr(), kpool.data_ptr(), vpool.data_ptr(),
                  tables.data_ptr(), positions.data_ptr(), out.data_ptr(),
                  _DTYPE_CODE[q.dtype], B, N, KH, ps, hd, H // KH,
                  tables.shape[1], float(sm_scale), stream)

    if q.device.index == torch.cuda.current_device():
        err = launch()
    else:                     # the launch goes to the current device
        with torch.cuda.device(q.device):
            err = launch()
    if err != 0:
        raise RuntimeError(
            f"paged_decode{'_int8' if quantized else ''} kernel launch "
            f"failed: CUDA error {err}")
    if quantized:
        paged_decode_attention.launches_int8 += 1
    else:
        paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0        # dense kernel
paged_decode_attention.launches_int8 = 0   # int8 kernel
