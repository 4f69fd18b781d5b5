"""Device-resident datasets: upload the whole pool to the card once, gather
batches on the device by index (port of ``loans_tpu/data/device_data.py``).

The reference streams every batch host->GPU per iteration. For the
in-memory synthetic datasets the whole pool fits in device memory (512
scenes of 224x224x3 uint8 are 77 MB), so the pools are uploaded once and
each chunk of K training steps ships only a (K, B) index tensor per group.
The index streams are the JAX package's exactly: the same numpy generator,
seeds and epoch permutations.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def materialize(dataset) -> tuple:
    """Stack a map-style dataset's examples into batch-axis numpy arrays.

    Returns a tuple of arrays (one per example field); scalar/1-field
    datasets produce a 1-tuple.
    """
    first = dataset[0]
    n = len(dataset)
    if not isinstance(first, (tuple, list)):
        out = np.stack([np.asarray(dataset[i]) for i in range(n)])
        return (out,)
    fields = len(first)
    cols = [[] for _ in range(fields)]
    for i in range(n):
        ex = dataset[i]
        for k in range(fields):
            cols[k].append(np.asarray(ex[k]))
    return tuple(np.stack(c) for c in cols)


def pool_nbytes(dataset) -> int:
    """Estimated device footprint of ``materialize(dataset)``."""
    first = dataset[0]
    fields = first if isinstance(first, (tuple, list)) else (first,)
    per = sum(np.asarray(f).nbytes for f in fields)
    return per * len(dataset)


class IndexSampler:
    """Epoch-permutation index stream (DataLoader shuffle semantics)."""

    def __init__(self, n: int, batch_size: int, seed: int = 0,
                 shuffle: bool = True, drop_last: bool = True):
        if batch_size > n:
            raise ValueError(f"batch_size {batch_size} > dataset size {n}")
        self.n = n
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._rng = np.random.default_rng(seed)

    def epochs(self):
        while True:
            order = (
                self._rng.permutation(self.n)
                if self.shuffle
                else np.arange(self.n)
            )
            stop = (
                self.n - self.batch_size + 1
                if self.drop_last
                else self.n
            )
            for start in range(0, max(stop, 1), self.batch_size):
                yield order[start : start + self.batch_size]


def device_chunk_batches(
    groups: dict[str, dict[str, np.ndarray]],
    batch_size: int,
    steps_per_call: int,
    seed: int = 0,
    device: str | torch.device = "cuda",
    refresh: dict[str, tuple[Any, int]] | None = None,
):
    """Yield ``{'pools', 'idx'}`` chunks for ``train.steps.pooled_step``.

    ``groups`` maps a group name to a dict of host arrays with a common
    leading (dataset) dimension. The pools are uploaded to ``device`` once
    and every chunk carries the same tensors; each chunk brings a fresh
    ``(steps_per_call, batch_size)`` int64 index tensor per group, drawn
    from ``IndexSampler(n, batch_size, seed=seed + j)`` for the j-th group,
    as the JAX package draws them. Host->device traffic per K training
    iterations is the index tensors only.

    ``refresh`` (the assessor-refresh pool swap) is not ported yet.
    """
    if refresh:
        raise NotImplementedError(
            "device_chunk_batches(refresh=...) is not ported: the assessor "
            "pool refresh is ROADMAP.md Queue 1 item 8 (pool refresh)"
        )
    device = torch.device(device)
    pools = {
        g: {k: torch.from_numpy(np.ascontiguousarray(a)).to(device) for k, a in tree.items()}
        for g, tree in groups.items()
    }
    samplers = {
        g: IndexSampler(len(next(iter(tree.values()))), batch_size, seed=seed + j).epochs()
        for j, (g, tree) in enumerate(groups.items())
    }
    while True:
        idx = {
            g: torch.from_numpy(
                np.stack([next(samplers[g]) for _ in range(steps_per_call)]).astype(np.int64)
            ).to(device)
            for g in groups
        }
        yield {"pools": pools, "idx": idx}
