"""Standalone block-sparse MatMul / Softmax ops (the port of
``deepspeed_tpu/ops/sparse_attention/ops.py``).

The reference's composable sparse ops (deepspeed/ops/sparse_attention/
matmul.py:595 MatMul, softmax.py:207 Softmax): ``sdd`` (dense x dense ->
sparse), softmax on the sparse scores, and ``dsd`` / ``dds`` (sparse x
dense / dense x sparse -> dense), with the same compressed block format:
a (batch, nnz, block, block) tensor whose blocks come in the layout's
``np.nonzero`` order (head, then block row, then block column).

Plain PyTorch gathers, batched matrix products and index adds, as the
JAX package's are jnp gathers and einsums: there is no kernel here, and
autograd differentiates them. ``SparseSelfAttention`` runs the fused
kernels of ``blocksparse.py`` instead.

Softmax normalizes each query row over the row's nonzero blocks only
(structural zeros excluded exactly), with the reference's mask
semantics: ``rpe`` (the compressed shape of x, added), key-padding mask
(B, S), attention mask (S, S), each 'add' (values added, the default
here) or 'mul' (zeros drop entries).
"""

import numpy as np
import torch

from deepspeed_tpu_torch.ops.sparse_attention.blocksparse import (
    NEG_INF, _to_additive)

__all__ = ["MatMul", "Softmax"]


def _nonzeros(layout: np.ndarray):
    hs, rs, cs = np.nonzero(np.asarray(layout))
    return tuple(torch.from_numpy(a.astype(np.int64)) for a in (hs, rs, cs))


class MatMul:
    """Block-sparse matmul (reference matmul.py:595): one of
    - 'sdd': dense x dense -> sparse (compressed (B, nnz, blk, blk))
    - 'dsd': sparse x dense -> dense
    - 'dds': dense x sparse -> dense
    ``trans_a`` / ``trans_b`` transpose the last two dims of the
    corresponding operand first (e.g. sdd with trans_b=True is the
    attention Q @ K^T)."""

    def __init__(self, layout, block: int, mode: str,
                 trans_a: bool = False, trans_b: bool = False,
                 bench: bool = False):
        if mode not in ("sdd", "dsd", "dds"):
            raise NotImplementedError(
                f"Supported modes are: sdd, dsd, dds; got {mode}")
        self.layout = np.asarray(layout)
        self.block = int(block)
        self.mode = mode
        self.trans_a = trans_a
        self.trans_b = trans_b
        self.bench = bench                       # accepted for parity
        self.spdims = self.layout.shape
        self.hs, self.rs, self.cs = _nonzeros(self.layout)
        self.nnz = len(self.hs)

    def _dense_blocks(self, x, block_idx):
        """Gather (B, nnz, blk, D) row blocks out of a dense (B, H, S, D)
        operand: head hs[n], sequence block ``block_idx[n]``."""
        B, H, S, D = x.shape
        xb = x.reshape(B, H, S // self.block, self.block, D)
        dev = x.device
        return xb[:, self.hs.to(dev), block_idx.to(dev)]

    def __call__(self, a, b):
        blk = self.block
        if self.mode == "sdd":
            if self.trans_a:
                a = a.transpose(-1, -2)
            if self.trans_b:
                b = b.transpose(-1, -2)
            # a: (B, H, Sq, K), b: (B, H, K, Sk) -> blocks of a @ b
            a_blocks = self._dense_blocks(a, self.rs)        # (B,nnz,blk,K)
            b_blocks = self._dense_blocks(b.transpose(-1, -2), self.cs)
            return a_blocks @ b_blocks.transpose(-1, -2)
        if self.mode == "dsd":
            # a: sparse (B, nnz, blk, blk), b: dense (B, H, Sk, D)
            if self.trans_a:
                a = a.transpose(-1, -2)
                rs, cs, out_blocks = self.cs, self.rs, self.spdims[2]
            else:
                rs, cs, out_blocks = self.rs, self.cs, self.spdims[1]
            if self.trans_b:
                b = b.transpose(-1, -2)
            B, H, Sk, D = b.shape
            contrib = a @ self._dense_blocks(b, cs)          # (B,nnz,blk,D)
            # scatter-add into (B, H * out_blocks, blk, D) rows
            out = torch.zeros((B, self.spdims[0] * out_blocks, blk, D),
                              dtype=contrib.dtype, device=contrib.device)
            dest = (self.hs * out_blocks + rs).to(contrib.device)
            out = out.index_add(1, dest, contrib)
            return out.reshape(B, self.spdims[0], out_blocks * blk, D)
        # dds: a dense (B, H, Sq, K) x b sparse -> dense (B, H, Sq, Sk)
        if self.trans_a:
            a = a.transpose(-1, -2)
        if self.trans_b:
            b = b.transpose(-1, -2)
            rs, cs, out_blocks = self.cs, self.rs, self.spdims[1]
        else:
            rs, cs, out_blocks = self.rs, self.cs, self.spdims[2]
        B, H, Sq, K = a.shape
        # a's K dim is blocked by the sparse operand's row blocks
        ab = a.reshape(B, H, Sq, K // blk, blk).permute(0, 1, 3, 2, 4)
        dev = a.device
        a_blocks = ab[:, self.hs.to(dev), rs.to(dev)]        # (B,nnz,Sq,blk)
        contrib = a_blocks @ b                               # (B,nnz,Sq,blk)
        out = torch.zeros((B, self.spdims[0] * out_blocks, Sq, blk),
                          dtype=contrib.dtype, device=dev)
        out = out.index_add(1, (self.hs * out_blocks + cs).to(dev), contrib)
        out = out.reshape(B, self.spdims[0], out_blocks, Sq, blk)
        return out.permute(0, 1, 3, 2, 4).reshape(B, self.spdims[0], Sq,
                                                  out_blocks * blk)


class Softmax:
    """Block-sparse softmax (reference softmax.py:207): normalizes each
    query row over the row's nonzero blocks; structural zeros never
    contribute. Masks as in the reference: rpe (compressed, added),
    key_padding_mask (B, S), attn_mask (S, S), each 'add' / 'mul'."""

    def __init__(self, layout, block: int, bench: bool = False):
        self.layout = np.asarray(layout)
        self.block = int(block)
        self.bench = bench
        self.spdims = self.layout.shape
        self.num_blocks = int(self.layout.sum())
        hs, rs, cs = np.nonzero(self.layout)
        self.hs, self.rs, self.cs = _nonzeros(self.layout)
        # group the nonzeros by (head, block row), padded to the widest
        H, nq, _ = self.spdims
        groups = [[] for _ in range(H * nq)]
        for n, (h, r) in enumerate(zip(hs, rs)):
            groups[h * nq + r].append(n)
        maxdeg = max((len(g) for g in groups), default=1) or 1
        lut = np.zeros((H * nq, maxdeg), np.int64)
        valid = np.zeros((H * nq, maxdeg), bool)
        slot = np.zeros(len(hs), np.int64)
        for g, ns in enumerate(groups):
            lut[g, :len(ns)] = ns
            valid[g, :len(ns)] = True
            slot[ns] = np.arange(len(ns))
        self.maxdeg = maxdeg
        self.lut = torch.from_numpy(lut)
        self.valid = torch.from_numpy(valid)
        self.g_of_n = torch.from_numpy(hs.astype(np.int64) * nq + rs)
        self.slot_of_n = torch.from_numpy(slot)

    def __call__(self, x, scale=1.0, rpe=None, key_padding_mask=None,
                 attn_mask=None, key_padding_mask_mode: str = "add",
                 attn_mask_mode: str = "add"):
        blk = self.block
        B = x.shape[0]
        dev = x.device
        s = x.float() * scale
        if rpe is not None:
            s = s + rpe.float()
        if attn_mask is not None:
            am = _to_additive(attn_mask, attn_mask_mode)
            amb = am.reshape(self.spdims[1], blk, self.spdims[2], blk
                             ).transpose(1, 2)
            s = s + amb[self.rs.to(dev), self.cs.to(dev)][None]
        if key_padding_mask is not None:
            kpm = _to_additive(key_padding_mask, key_padding_mask_mode)
            kpmb = kpm.reshape(B, self.spdims[2], blk)
            s = s + kpmb[:, self.cs.to(dev)][:, :, None, :]
        # each (head, block row) group: (B, G, maxdeg, blk, blk)
        sg = s[:, self.lut.to(dev)]
        sg = torch.where(self.valid.to(dev)[None, :, :, None, None], sg,
                         NEG_INF)
        # softmax jointly over (maxdeg, blk_k) per query row
        Bn, G, Dg, _, _ = sg.shape
        flat = sg.transpose(2, 3).reshape(Bn, G, blk, Dg * blk)
        m = flat.amax(dim=-1, keepdim=True)
        # all-masked rows normalize to exact zeros, like the kernels
        e = torch.where(flat > NEG_INF / 2, torch.exp(flat - m), 0.0)
        denom = e.sum(dim=-1, keepdim=True)
        p = e / torch.where(denom == 0.0, 1.0, denom)
        pg = p.reshape(Bn, G, blk, Dg, blk).transpose(2, 3)
        out = pg[:, self.g_of_n.to(dev), self.slot_of_n.to(dev)]
        return out.to(x.dtype)
