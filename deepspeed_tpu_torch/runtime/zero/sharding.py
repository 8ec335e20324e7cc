"""ZeRO over a process group (the port of
``deepspeed_tpu/runtime/zero/sharding.py``).

The JAX package's ZeRO is a sharding assignment: each leaf of the fp32
masters and the optimizer state (and at stage 2 the grad accumulator)
gets a ``NamedSharding`` over the ``data`` axis, on the first dim that
divides by the data degree (:func:`leaf_partition_spec`), and XLA emits
the reduce-scatter, the sharded update and the all-gather. The port
keeps that assignment leaf for leaf as the dim of each leaf whose slice
this rank owns (:func:`zero_shard_dims`), so rank ``r`` holds exactly
the block device ``r`` holds in JAX, and :class:`ZeroPartition` makes the
collectives by hand over ``torch.distributed``:

- stage 1: the masters and moments are sharded; the window's grads are
  reduce-scattered at the boundary, each rank updates its shard, and the
  new compute-dtype params are all-gathered;
- stage 2: the grad accumulator is sharded too, so each micro step
  reduce-scatters;
- a leaf no dim of which divides (or a 0-d one) stays replicated: its
  grad is all-reduced and every rank updates all of it.

Grads are summed and divided by the data degree: the mean of the ranks'
grads, which is the grad of JAX's loss over the global batch. Without a
process group (one process) every collective is the identity.
"""

from typing import Any, List, Optional, Sequence, Tuple

import torch

__all__ = ["leaf_partition_spec", "shard_dim", "zero_shard_dims",
           "ZeroPartition"]


def leaf_partition_spec(shape, axis_name="data", axis_n: int = 1,
                        model_spec: Optional[Sequence] = None
                        ) -> Tuple:
    """JAX's rule, as the tuple of a ``PartitionSpec``: the first dim of
    ``shape`` divisible by ``axis_n`` (and at least ``axis_n`` long) not
    taken by ``model_spec`` gets ``axis_name``; else replication (``()``
    without a model spec)."""
    base = list(model_spec) if model_spec is not None else []
    base += [None] * (len(shape) - len(base))
    for i, d in enumerate(shape):
        if base[i] is None and d % axis_n == 0 and d >= axis_n:
            base[i] = axis_name
            return tuple(base)
    return tuple(base) if model_spec is not None else ()


def shard_dim(shape, dp: int, stage: int = 1) -> Optional[int]:
    """The dim of a leaf of ``shape`` that ZeRO shards over ``dp`` ranks
    (JAX's ``zero_shardings``: 0-d leaves, stage 0 and one rank
    replicate), or None."""
    if len(shape) == 0 or stage < 1 or dp == 1:
        return None
    spec = leaf_partition_spec(shape, "data", dp)
    return spec.index("data") if "data" in spec else None


def zero_shard_dims(shapes: Sequence[Sequence[int]], dp: int,
                    stage: int) -> List[Optional[int]]:
    """:func:`shard_dim` of each leaf shape, in leaf order."""
    return [shard_dim(tuple(s), dp, stage) for s in shapes]


def _front(t: torch.Tensor, d: int) -> torch.Tensor:
    return t if d == 0 else t.movedim(d, 0).contiguous()


class ZeroPartition:
    """The shard of each leaf that this rank owns, and the collectives
    over them. ``shapes`` are the full leaf shapes in leaf order; a
    process group must exist when ``dp > 1``."""

    def __init__(self, shapes: Sequence[Sequence[int]], dp: int, rank: int,
                 stage: int):
        import torch.distributed as dist
        self.shapes = [tuple(s) for s in shapes]
        self.dp, self.rank, self.stage = dp, rank, stage
        self.dims = zero_shard_dims(self.shapes, dp, stage)
        # collectives run whenever a group exists, at a world of one too
        self.live = dist.is_available() and dist.is_initialized()
        if dp > 1 and not self.live:
            raise RuntimeError(f"ZeRO over {dp} ranks needs a process group "
                               "(init_distributed)")

    def shard_shape(self, i: int) -> Tuple[int, ...]:
        shape, d = list(self.shapes[i]), self.dims[i]
        if d is not None:
            shape[d] //= self.dp
        return tuple(shape)

    def shard(self, i: int, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of leaf ``i`` (a new tensor)."""
        d = self.dims[i]
        if d is None:
            return full.clone()
        return full.chunk(self.dp, d)[self.rank].clone()

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the ranks, in place."""
        if self.live:
            import torch.distributed as dist
            dist.all_reduce(t)
        return t

    def reduce_scatter(self, i: int, full: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks of leaf ``i``'s full grad, cut to this
        rank's block (all of it for a replicated leaf)."""
        d = self.dims[i]
        if d is None:
            return self.all_reduce_(full)
        if not self.live:
            return full
        import torch.distributed as dist
        src = _front(full, d)
        out = torch.empty((src.shape[0] // self.dp,) + tuple(src.shape[1:]),
                          dtype=src.dtype, device=src.device)
        dist.reduce_scatter_tensor(out, src)
        return out if d == 0 else out.movedim(0, d).contiguous()

    def all_gather(self, i: int, shard: torch.Tensor,
                   out: torch.Tensor) -> torch.Tensor:
        """Leaf ``i`` assembled from every rank's block into ``out`` (a
        copy of ``shard`` for a replicated leaf)."""
        d = self.dims[i]
        if d is None or not self.live:
            return out.copy_(shard)
        import torch.distributed as dist
        parts = [torch.empty_like(shard) for _ in range(self.dp)]
        dist.all_gather(parts, shard.contiguous())
        return out.copy_(torch.cat(parts, dim=d))

    def gather_full(self, i: int, shard: torch.Tensor) -> torch.Tensor:
        """Leaf ``i`` whole, in a new tensor."""
        out = torch.empty(self.shapes[i], dtype=shard.dtype,
                          device=shard.device)
        return self.all_gather(i, shard, out)

    def leaf_norms(self, norms: torch.Tensor) -> torch.Tensor:
        """The whole leaves' norms from the norms of this rank's blocks
        (one per leaf, in leaf order): a sharded leaf's squared norms
        summed over the ranks; a replicated leaf's as it is."""
        if not (self.live and self.dp > 1):
            return norms
        sharded = torch.tensor([d is not None for d in self.dims],
                               device=norms.device)
        sq = torch.where(sharded, norms * norms, torch.zeros_like(norms))
        self.all_reduce_(sq)
        return torch.where(sharded, torch.sqrt(sq), norms)

    def sq_norm(self, grads: Sequence[torch.Tensor], dtype=None) -> Any:
        """The global squared norm of the grads (shards and replicated
        leaves in leaf order): each leaf's sum of squares (in ``dtype``,
        default the grads'), the shards' summed over the ranks, a
        replicated leaf counted once; then summed over the leaves in
        order, as the single-device engine sums them."""
        sums = torch.stack([torch.sum(g * g) if dtype is None else
                            torch.sum(g.to(dtype) ** 2) for g in grads])
        if self.live and self.dp > 1:
            if self.rank != 0:
                keep = torch.tensor([d is not None for d in self.dims],
                                    device=sums.device)
                sums = torch.where(keep, sums, torch.zeros_like(sums))
            self.all_reduce_(sums)
        return sum(sums.unbind())
