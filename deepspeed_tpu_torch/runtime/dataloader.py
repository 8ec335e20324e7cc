"""Data loading (the port of ``deepspeed_tpu/runtime/dataloader.py``'s
``RepeatingLoader`` and ``DeepSpeedDataLoader``).

``DeepSpeedDataLoader`` batches an indexable dataset of numpy pytrees
(or passes an iterable of ready batches through) and turns every numpy
leaf into a tensor on the loader's device: on CUDA through pinned host
memory with a non-blocking copy. ``PrefetchLoader`` is not ported yet.
"""

from typing import Any, Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.utils.tree import tree_map


class RepeatingLoader:
    """Wraps an iterable to restart on StopIteration."""

    def __init__(self, loader: Iterable):
        self.loader = loader
        self.data_iter = iter(self.loader)

    def __iter__(self):
        return self

    def __next__(self):
        try:
            batch = next(self.data_iter)
        except StopIteration:
            self.data_iter = iter(self.loader)
            batch = next(self.data_iter)
        return batch


def to_device(batch, device):
    """Every array leaf of ``batch`` as a tensor on ``device`` (CUDA:
    staged through pinned memory, copied without blocking)."""
    device = torch.device(device)

    def put(x):
        t = x if isinstance(x, torch.Tensor) else \
            torch.from_numpy(np.ascontiguousarray(x))
        if device.type == "cuda" and t.device.type == "cpu":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)
    return tree_map(put, batch)


class DeepSpeedDataLoader:
    """Yields device batches of ``batch_size`` rows.

    ``dataset`` is any indexable of pytrees (dict/tuple of numpy arrays)
    or an iterable of already-batched pytrees."""

    def __init__(self, dataset, batch_size: int, device="cpu",
                 shuffle: bool = True, seed: int = 0,
                 drop_last: bool = True,
                 collate_fn: Optional[Callable] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.device = torch.device(device)
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.collate_fn = collate_fn
        self._epoch = 0
        try:
            n = len(dataset)
            self.len = (n // batch_size if drop_last
                        else -(-n // batch_size))
        except TypeError:
            self.len = None

    def __len__(self):
        if self.len is None:
            raise TypeError("underlying dataset has no length")
        return self.len

    def __iter__(self) -> Iterator[Any]:
        if hasattr(self.dataset, "__getitem__") and self.len is not None:
            n_total = len(self.dataset)
            n = (self.len * self.batch_size if self.drop_last else n_total)
            order = np.arange(n_total)
            if self.shuffle:
                rng = np.random.RandomState(self.seed + self._epoch)
                rng.shuffle(order)
            self._epoch += 1
            for i in range(0, n, self.batch_size):
                idx = order[i:i + self.batch_size]
                items = [self.dataset[int(j)] for j in idx]
                if self.collate_fn is not None:
                    batch = self.collate_fn(items)
                else:
                    batch = tree_map(lambda *xs: np.stack(xs), *items)
                yield to_device(batch, self.device)
        else:
            for batch in self.dataset:
                yield to_device(batch, self.device)
