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

from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable

import numpy as np
import torch
import torch.distributed

from loans_tpu_torch import parallel
from loans_tpu_torch.utils.tracing import span


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
    refresh: dict[str, tuple[Callable[[int], dict[str, np.ndarray]], int]] | None = None,
):
    """Yield ``{'pools', 'idx'}`` chunks for ``train.steps.pooled_step``.

    ``groups`` maps a group name to a dict of host arrays with a common
    leading (dataset) dimension. The pools are uploaded to ``device`` once
    and every chunk carries the same tensors; each chunk brings a fresh
    ``(steps_per_call, batch_size)`` int64 index tensor per group, drawn
    from ``IndexSampler(n, batch_size, seed=seed + j)`` for the j-th group,
    as the JAX package draws them. Host->device traffic per K training
    iterations is the index tensors only; on a CUDA device they are copied
    from pinned memory without a wait, so the host can draw the next
    chunk while the card still runs the last call.

    ``refresh`` maps a group name to ``(factory, every)``: at every
    ``every``-th chunk after chunk 0, one worker thread calls
    ``factory(generation) -> dict of host arrays`` (generation 1, 2, ...),
    unless a call for the group is still running. At the first chunk after
    it returns, the new pool replaces the group's, and its sampler restarts
    with seed ``seed + j + 7919 * generation``. Training does not wait for
    the factory; a factory that launches on the card must finish its own
    stream's work before it returns (``data.synthetic.render_stn_crops``
    does). Each swap adds one to ``device_chunk_batches.swaps``. A factory
    that raises raises from the chunk that would have swapped its pool, or
    from closing the generator, which waits for a running call.

    In data-parallel training (``loans_tpu_torch.parallel``) every rank
    uploads the whole pool and draws the same index streams, and keeps its
    columns ``[r·B/W, (r+1)·B/W)`` of each (K, B) index tensor, as the JAX
    package shards it on the batch axis. Only rank 0 calls a refresh
    factory; at every chunk it tells the other ranks whether its pool is
    ready, and on a swap it broadcasts the new pool (uploaded on rank 0,
    with the keys and dtypes of the group's first pool), so every rank
    swaps at the same chunk to the same pool.
    """
    device = torch.device(device)
    main = parallel.is_main()
    start, size = parallel.local_batch_slice(batch_size)

    def upload(tree):
        return {k: torch.from_numpy(np.ascontiguousarray(a)).to(device) for k, a in tree.items()}

    def upload_indices(idx: np.ndarray) -> torch.Tensor:
        # from pinned memory on a card, so the host does not wait for the
        # queued steps; torch's caching host allocator keeps the buffer
        # until its copy is done
        host = torch.from_numpy(idx)
        if device.type != "cuda":
            return host.to(device)
        return host.pin_memory().to(device, non_blocking=True)

    pools = {g: upload(tree) for g, tree in groups.items()}
    seeds = {g: seed + j for j, g in enumerate(groups)}
    samplers = {g: IndexSampler(_pool_size(tree), batch_size, seed=seeds[g]).epochs()
                for g, tree in groups.items()}
    executor = ThreadPoolExecutor(max_workers=1) if refresh and main else None
    futures: dict[str, Future] = {}
    generation = {g: 0 for g in groups}
    chunk_i = 0
    try:
        while True:
            with span("loans.feed"):
                for g, (factory, every) in (refresh or {}).items():
                    ready = parallel.broadcast_object(g in futures and futures[g].done())
                    if ready:
                        tree = upload(futures.pop(g).result()) if main else None
                        pools[g] = _broadcast_pool(tree, pools[g])
                        generation[g] += 1
                        samplers[g] = IndexSampler(
                            _pool_size(pools[g]), batch_size, seed=seeds[g] + 7919 * generation[g]
                        ).epochs()
                        device_chunk_batches.swaps += 1
                        if main:
                            print(f"refresh: pool {g!r} generation {generation[g]} swapped in at chunk {chunk_i}")
                    elif main and g not in futures and every > 0 and chunk_i > 0 and chunk_i % every == 0:
                        futures[g] = executor.submit(factory, generation[g] + 1)
                idx = {
                    g: upload_indices(
                        np.stack([next(samplers[g])[start : start + size] for _ in range(steps_per_call)])
                        .astype(np.int64)
                    )
                    for g in groups
                }
                chunk_i += 1
            yield {"pools": pools, "idx": idx}
    finally:
        if executor is not None:
            executor.shutdown(wait=True)
            for future in futures.values():
                future.result()  # a refresh that failed after the last swap raises here


device_chunk_batches.swaps = 0


def _pool_size(tree: dict) -> int:
    return len(next(iter(tree.values())))


def _broadcast_pool(tree: dict[str, torch.Tensor] | None, like: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Rank 0's pool ``tree`` (on the device) on every rank; the other
    ranks pass ``None`` and receive tensors of ``like``'s keys and dtypes.
    ``tree`` itself without a group."""
    if parallel.world_size() == 1:
        return tree
    shapes = parallel.broadcast_object({k: tuple(v.shape) for k, v in tree.items()} if tree is not None else None)
    if tree is None:
        tree = {k: torch.empty(shape, dtype=like[k].dtype, device=like[k].device) for k, shape in shapes.items()}
    for k in sorted(tree):
        torch.distributed.broadcast(tree[k], 0)
    return tree


def device_eval_batches(dataset, batch_size: int, device: str | torch.device = "cuda") -> list:
    """An eval set as a list of ``(images on the device, gt boxes, ...)``
    batches: the images are uploaded once and stay on the device across
    every eval sweep; the rest stays on the host, where the ragged ground
    truth is matched. A last partial batch is dropped. In data-parallel
    training only rank 0 evaluates (``train.loop.Trainer``), so the other
    ranks get no batches and upload nothing."""
    if not parallel.is_main():
        return []
    fields = materialize(dataset)
    n = (len(fields[0]) // batch_size) * batch_size
    batches = []
    for start in range(0, n, batch_size):
        sl = slice(start, start + batch_size)
        images = torch.from_numpy(np.ascontiguousarray(fields[0][sl])).to(device)
        batches.append((images,) + tuple(f[sl] for f in fields[1:]))
    return batches
