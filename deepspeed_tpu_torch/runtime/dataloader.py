"""Data loading: the port of the JAX package's ``runtime/dataloader.py``
(the counterpart of the reference's ``deepspeed/runtime/dataloader.py``
``DeepSpeedDataLoader``).

The loader yields global batches as numpy arrays, as the JAX package's
does; the engine moves each batch to its device (``_to_device``).  One
device trains, so the global batch is the device's batch.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, Optional, Sequence

import numpy as np

PyTree = Any


def _default_collate(items: Sequence) -> PyTree:
    """Stack a list of samples into batched numpy arrays (dict/tuple/array)."""
    first = items[0]
    if isinstance(first, dict):
        return {k: _default_collate([it[k] for it in items]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_default_collate([it[i] for it in items])
                           for i in range(len(first)))
    return np.stack([np.asarray(it) for it in items])


class DeepSpeedDataLoader:
    """Batching iterator over an indexable dataset, global-batch semantics."""

    def __init__(self, dataset, batch_size: int,
                 collate_fn: Optional[Callable] = None,
                 shuffle: bool = False, seed: int = 0, drop_last: bool = True):
        if batch_size <= 0:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn or _default_collate
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        n = len(dataset)
        self.len = n // batch_size if drop_last else (n + batch_size - 1) // batch_size
        if self.len == 0:
            raise ValueError(
                f"DeepSpeedDataLoader would yield zero batches: batch_size "
                f"({batch_size}) exceeds dataset size ({n}) with "
                f"drop_last=True — shrink the batch or set drop_last=False")

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return self.len

    def __iter__(self) -> Iterator[PyTree]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(order)
        for start in range(0, self.len * self.batch_size, self.batch_size):
            idx = order[start:start + self.batch_size]
            yield self.collate_fn([self.dataset[int(i)] for i in idx])
