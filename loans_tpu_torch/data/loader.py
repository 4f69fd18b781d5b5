"""Host batch loading and the host-to-device prefetch (port of
``loans_tpu/data/loader.py``).

``default_collate`` and ``padded_collate`` stack examples into numpy
batches, and ``DataLoader`` assembles batches in a thread pool with a
bounded lookahead, delivering them in order. ``device_prefetch`` moves
the batches to the device from a thread of its own: from pinned host
memory, on a side CUDA stream, so that the copy of batch t + 1 overlaps
the step on batch t. The training CLIs' ``--device-data off`` path and
the offline evaluation (``cli/evaluate.py``) feed on them.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor
from queue import Empty, Queue
from typing import Any, Callable, Iterator

import numpy as np
import torch

from loans_tpu_torch import parallel


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

    With ``shard`` (data-parallel training), ``batch_size`` is the global
    batch: every rank draws the same order and loads only its slice of
    each global batch (``parallel.local_batch_slice``), nothing else.
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
        shard: bool = False,
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
        self._slice = parallel.local_batch_slice(batch_size) if shard else (0, batch_size)

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
            first, size = self._slice
            for start in range(0, max(stop, 0), self.batch_size):
                yield order[start : start + self.batch_size][first : first + size]
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


def images_to(batches, device: str | torch.device, limit: int | None = None) -> Iterator[tuple]:
    """Eval batches ``(images, gt, ...)`` with the images moved to
    ``device`` (the evaluators' form), at most ``limit`` of them."""
    it = iter(batches)
    try:
        for i, batch in enumerate(it):
            if limit is not None and i >= limit:
                return
            yield (torch.from_numpy(np.ascontiguousarray(batch[0])).to(device),) + tuple(batch[1:])
    finally:
        if hasattr(it, "close"):
            it.close()


def tree_map(fn: Callable, tree: Any) -> Any:
    """``fn`` over the leaves of a batch (nested tuples, lists and dicts)."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree: Any) -> list:
    out: list = []
    tree_map(out.append, tree)
    return out


def device_prefetch(iterator: Iterator[Any], device: str | torch.device, size: int = 2) -> Iterator[Any]:
    """The batches of ``iterator`` (numpy pytrees) as tensors on ``device``,
    with up to ``size`` of them in flight.

    A producer thread draws the batches. On a CUDA device it copies each
    one to pinned host memory, and from there to the device with
    ``non_blocking=True`` on a side stream, and records an event after the
    copy; the consumer makes its current stream wait on that event before
    it takes the batch, so the copy of the next batch overlaps the work on
    this one, and each device tensor is marked as used on the consumer's
    stream. The pinned buffers stay referenced until the next batch is
    taken, after the consumer's stream has waited for their copy. On the
    CPU the batches are ``torch.from_numpy`` views. An error in the
    producer is raised on the consumer's side; closing the generator stops
    the producer.
    """
    device = torch.device(device)
    cuda = device.type == "cuda"
    stream = torch.cuda.Stream(device) if cuda else None
    queue: Queue = Queue(maxsize=size)
    stop = threading.Event()
    done = object()
    error: list[BaseException] = []

    def put(batch):
        host = tree_map(lambda a: torch.from_numpy(np.ascontiguousarray(a)), batch)
        if not cuda:
            return host, None, None
        pinned = tree_map(lambda t: t.pin_memory(), host)
        with torch.cuda.stream(stream):
            moved = tree_map(lambda t: t.to(device, non_blocking=True), pinned)
            event = torch.cuda.Event()
            event.record(stream)
        return moved, event, pinned

    def producer():
        try:
            for batch in iterator:
                if stop.is_set():
                    break
                queue.put(put(batch))
        except BaseException as e:  # re-raised on the consumer's side
            error.append(e)
        finally:
            if hasattr(iterator, "close"):
                iterator.close()  # a DataLoader's pool shuts down
            queue.put((done, None, None))

    thread = threading.Thread(target=producer, name="device_prefetch", daemon=True)
    thread.start()
    held = None
    try:
        while True:
            moved, event, pinned = queue.get()
            if moved is done:
                if error:
                    raise error[0]
                return
            if event is not None:
                current = torch.cuda.current_stream(device)
                current.wait_event(event)
                for t in _leaves(moved):
                    t.record_stream(current)
            held = pinned  # noqa: F841 (kept alive until the next batch is taken)
            yield moved
    finally:
        stop.set()
        while thread.is_alive():  # unblock a producer waiting on a full queue
            try:
                queue.get(timeout=0.05)
            except Empty:
                pass
