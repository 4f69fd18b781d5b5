"""Host batch loading (port of the host half of ``loans_tpu/data/loader.py``).

``default_collate`` and ``padded_collate`` stack examples into numpy
batches, and ``DataLoader`` assembles batches in a thread pool with a
bounded lookahead, delivering them in order. The offline evaluation
(``cli/evaluate.py``) feeds on it. The JAX package's ``device_prefetch``
is not ported: a batch goes to the card where the model takes it.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterator

import numpy as np


def default_collate(examples: list[Any]) -> Any:
    """Stack a list of examples (arrays, or tuples or dicts of arrays) into
    one batch of the same structure."""
    first = examples[0]
    if isinstance(first, (tuple, list)):
        return tuple(default_collate([ex[k] for ex in examples]) for k in range(len(first)))
    if isinstance(first, dict):
        return {k: default_collate([ex[k] for ex in examples]) for k in first}
    return np.stack([np.asarray(ex) for ex in examples], axis=0)


def padded_collate(examples: list[Any], padding: float = 0.0) -> Any:
    """Collate ragged examples by padding each field to its largest shape
    with ``padding`` (e.g. a varying number of gt boxes per image). Padded
    gt rows are all ``padding``; the evaluators drop rows of zeros."""
    first = examples[0]
    if isinstance(first, (tuple, list)):
        return tuple(padded_collate([ex[k] for ex in examples], padding) for k in range(len(first)))
    if isinstance(first, dict):
        return {k: padded_collate([ex[k] for ex in examples], padding) for k in first}
    arrays = [np.asarray(ex) for ex in examples]
    shapes = np.array([a.shape for a in arrays])
    if (shapes == shapes[0]).all():
        return np.stack(arrays, axis=0)
    out = np.full((len(arrays), *shapes.max(axis=0)), padding, dtype=arrays[0].dtype)
    for i, a in enumerate(arrays):
        out[(i,) + tuple(slice(0, s) for s in a.shape)] = a
    return out


class DataLoader:
    """Thread-pooled, order-preserving batch loader.

    Iterating yields numpy batches for one epoch (``repeat=True``: forever).
    With ``shuffle``, each epoch's order is a permutation drawn from
    ``numpy.random.default_rng((seed, epoch))``, as in the JAX package.
    ``dataset`` has ``__len__`` and ``get_example(i)``.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        repeat: bool = False,
        drop_last: bool = True,
        num_workers: int | None = None,
        n_prefetch: int = 2,
        seed: int = 0,
        collate: Callable = default_collate,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.repeat = repeat
        self.drop_last = drop_last
        self.num_workers = num_workers or min(8, os.cpu_count() or 1)
        self.n_prefetch = n_prefetch
        self.seed = seed
        self.collate = collate
        self.epoch = 0

    def _epoch_order(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            return np.random.default_rng((self.seed, self.epoch)).permutation(n)
        return np.arange(n)

    def _batches_of_indices(self) -> Iterator[np.ndarray]:
        while True:
            order = self._epoch_order()
            n = len(order)
            stop = n - self.batch_size + 1 if self.drop_last else n
            for start in range(0, max(stop, 0), self.batch_size):
                yield order[start : start + self.batch_size]
            self.epoch += 1
            if not self.repeat:
                return

    def __iter__(self) -> Iterator[Any]:
        def assemble(indices):
            return self.collate([self.dataset.get_example(int(i)) for i in indices])

        with ThreadPoolExecutor(self.num_workers) as pool:
            pending = []
            index_iter = self._batches_of_indices()
            try:
                for _ in range(self.n_prefetch):
                    pending.append(pool.submit(assemble, next(index_iter)))
            except StopIteration:
                pass
            while pending:
                fut = pending.pop(0)
                try:
                    pending.append(pool.submit(assemble, next(index_iter)))
                except StopIteration:
                    pass
                yield fut.result()

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)
