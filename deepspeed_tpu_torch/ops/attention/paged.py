"""Paged-decode attention: one query token per row, straight against the
page pool (the port of ``deepspeed_tpu/ops/attention/paged.py``, dense
pool arity).

- :func:`paged_decode_attention` — the wrapper. For CUDA tensors it
  launches the hand-written kernel in ``csrc/paged_decode.cu`` (built
  with nvcc for sm_90a at first use) or raises; it never falls back.
  For CPU tensors it runs :func:`paged_decode_plain`. Each launch adds
  one to ``paged_decode_attention.launches``.
- :func:`paged_decode_plain` — the same function in plain PyTorch. It
  walks the pages the way the Pallas kernel does (online softmax per
  page in fp32, probabilities rounded to the pool dtype before the P.V
  product), so it reproduces the kernel's semantics: the page-0 mask,
  and a zero row where nothing is visible.

Replaces ``deepspeed_tpu/ops/attention/paged.py::_decode_kernel`` (built
by ``_paged_decode_pallas``). Unlike the TPU, Hopper has no 128-lane
rule, so head_dim 64 (GPT-2) runs the kernel; there is no geometry
fallback to the gather path.
"""

import ctypes
import math
from typing import Optional, Sequence

import torch

__all__ = ["paged_decode_attention", "paged_decode_plain",
           "decode_read_bytes", "live_pages"]

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
                      dtype_bytes: int = 2):
    """Modeled K+V bytes one decode step reads from the pool, per layer
    for the whole batch: ``(paged_bytes, gather_bytes)``. The paged
    kernel reads each row's live pages once; the gather path
    materializes the full ``pages_per_seq``-wide stripe per row."""
    positions = [int(p) for p in cache_positions]
    per_tok = kv_heads * head_dim * dtype_bytes * 2          # K and V
    paged = sum(live_pages(p, page_size) * page_size * per_tok
                for p in positions)
    gather = len(positions) * pages_per_seq * page_size * per_tok
    return paged, gather


def paged_decode_plain(q, kpool, vpool, block_tables, cache_position,
                       sm_scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch paged decode attention with the kernel's semantics.

    q: (B, H, hd); kpool/vpool: (num_pages, KH, page_size, hd) with
    H % KH == 0; block_tables: (B, P) int; cache_position: (B,) int —
    the position of the already-written current token. Row b attends
    positions ``<= cache_position[b]`` over its first
    ``min(cache_position // page_size + 1, P)`` table entries; entries
    that are the null page 0 (or outside ``[1, num_pages)``) are masked,
    and a row with nothing visible returns 0. Returns (B, H, hd) in q's
    dtype."""
    B, H, hd = q.shape
    N, KH, ps, _ = kpool.shape
    G = H // KH
    P = block_tables.shape[1]
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
        kt = kpool[safe].float()                                 # (B,KH,ps,hd)
        # masked rows never reach the sums, whatever the pool holds there
        vt = torch.where(valid[:, None, :, None], vpool[safe].float(), 0.0)
        s = torch.einsum("bkgd,bktd->bkgt", qg, kt) * sm_scale
        vmask = valid[:, None, None, :]
        s = torch.where(vmask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(vmask, torch.exp(s - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(dim=-1)
        p = p.to(vpool.dtype).float()
        acc = acc * alpha[..., None] + torch.einsum("bkgt,bktd->bkgd", p, vt)
        m = m_new
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc / l_safe[..., None]).to(q.dtype).reshape(B, H, hd)


def _check_cuda_args(q, kpool, vpool, tables, positions):
    B, H, hd = q.shape
    N, KH, ps, hd_k = kpool.shape
    dev = q.device
    for name, t in (("kpool", kpool), ("vpool", vpool), ("tables", tables),
                    ("positions", positions)):
        if t.device != dev:
            raise ValueError(f"paged decode: {name} on {t.device}, q on "
                             f"{dev}")
    if q.dtype not in _DTYPE_CODE or kpool.dtype != q.dtype or \
            vpool.dtype != q.dtype:
        raise TypeError(
            f"paged decode kernel takes q and pools of one dtype in "
            f"{list(_DTYPE_CODE)}, got q {q.dtype}, kpool {kpool.dtype}, "
            f"vpool {vpool.dtype}")
    if vpool.shape != kpool.shape or hd_k != hd or H % KH != 0:
        raise ValueError(f"paged decode shapes: q {tuple(q.shape)}, kpool "
                         f"{tuple(kpool.shape)}, vpool {tuple(vpool.shape)}")
    if hd % 8 != 0 or hd > MAX_HEAD_DIM:
        raise ValueError(f"paged decode kernel takes head_dim a multiple "
                         f"of 8 up to {MAX_HEAD_DIM}, got {hd}")
    if ps > MAX_PAGE_SIZE or H // KH > MAX_GROUP:
        raise ValueError(f"paged decode kernel takes page_size <= "
                         f"{MAX_PAGE_SIZE} and q/kv head groups <= "
                         f"{MAX_GROUP}, got {ps} and {H // KH}")
    if tables.dim() != 2 or tables.shape[0] != B or \
            positions.shape != (B,):
        raise ValueError(f"paged decode: tables {tuple(tables.shape)} and "
                         f"positions {tuple(positions.shape)} for batch {B}")
    for name, t in (("q", q), ("kpool", kpool), ("vpool", vpool)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"paged decode kernel needs {name} contiguous "
                             f"and 16-byte aligned")


_kernel_fn = None


def _kernel():
    """The kernel's C entry point, built and typed at first use."""
    global _kernel_fn
    if _kernel_fn is None:
        from deepspeed_tpu_torch.ops._build import load
        fn = load("paged_decode.cu").paged_decode
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + \
            [ctypes.c_float, ctypes.c_void_p]
        _kernel_fn = fn
    return _kernel_fn


def paged_decode_attention(q, kpool, vpool, block_tables, cache_position,
                           sm_scale: Optional[float] = None) -> torch.Tensor:
    """Decode attention straight from the page pool — O(live tokens).

    Shapes and semantics as :func:`paged_decode_plain`. A CUDA ``q``
    launches the sm_90a kernel (raising on any dtype, shape, device or
    launch problem); a CPU ``q`` runs the plain version."""
    if q.dim() != 3 or kpool.dim() != 4:
        raise ValueError(f"paged decode takes (B, H, hd) queries and "
                         f"(N, KH, page_size, hd) pools, got "
                         f"{tuple(q.shape)}, {tuple(kpool.shape)}")
    if q.device.type == "cpu":
        return paged_decode_plain(q, kpool, vpool, block_tables,
                                  cache_position, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged decode runs on cuda or cpu, not "
                         f"{q.device}")
    tables = block_tables.to(torch.int32).contiguous()
    positions = cache_position.to(torch.int32).contiguous()
    _check_cuda_args(q, kpool, vpool, tables, positions)
    B, H, hd = q.shape
    N, KH, ps, _ = kpool.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(hd)
    out = torch.empty_like(q)
    if B == 0:
        return out
    fn = _kernel()

    def launch():
        stream = torch.cuda.current_stream(q.device).cuda_stream
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
        raise RuntimeError(f"paged_decode kernel launch failed: CUDA error "
                           f"{err}")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
