"""The process group of data-parallel training (port of
``loans_tpu/parallel/distributed.py``).

The JAX package trains over every device it sees as one SPMD program over
a mesh (``jax.distributed`` joins hosts). The port runs one process per
GPU instead, launched by ``torchrun``, and makes the collectives XLA would
insert explicit: the BatchNorm statistics of the global batch
(``models.resnet.BatchNorm2d``), the gradient mean (``train.state``), the
SSD loss's positives (``ops.multibox``) and the logged metrics
(``train.loop``). W processes at global batch B compute what one process
computes at batch B.

Without a group, every function here answers as one process does: rank 0
of world size 1. ``suspended()`` turns the data-parallel math off for a
block that only some ranks run (the in-training evaluation on rank 0).

Host-side agreement (the control commands, the pool-refresh swap) goes
over a gloo group, so that it never waits for the device; with the NCCL
backend that is a second group beside the default one.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import threading
from typing import Any

import torch
import torch.distributed as dist

_state: dict[str, Any] = {"host_group": None}
_suspended = threading.local()  # per thread: the loader's and refresh's threads keep the group


def _is_suspended() -> bool:
    return getattr(_suspended, "depth", 0) > 0


def init_distributed(
    backend: str | None = None,
    init_method: str | None = None,
    world_size: int | None = None,
    rank: int | None = None,
    device_type: str = "cuda",
    timeout: float | None = None,
) -> bool:
    """Create the process group; True when there is one.

    With ``init_method`` (``tcp://host:port``) the group is built from the
    explicit ``world_size`` and ``rank``, as ``initialize_distributed`` of
    the JAX package takes them. Without it, ``torchrun``'s environment
    (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) is read;
    where it is absent nothing happens and the process stays alone. The
    backend defaults to NCCL for ``device_type`` ``cuda`` and gloo
    otherwise. Calling it again once a group exists does nothing.
    """
    if dist.is_initialized():
        return True
    if init_method is None and "WORLD_SIZE" not in os.environ:
        return False
    backend = backend or ("nccl" if device_type == "cuda" else "gloo")
    kwargs: dict[str, Any] = {}
    if init_method is not None:
        kwargs = dict(init_method=init_method, world_size=world_size, rank=rank)
    if timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout)
    dist.init_process_group(backend, **kwargs)
    if backend != "gloo":
        _state["host_group"] = dist.new_group(backend="gloo", timeout=kwargs.get("timeout"))
    return True


def shutdown() -> None:
    """Destroy the process group (no-op without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _state["host_group"] = None


def rank() -> int:
    """This process's rank in the group (0 without one)."""
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    """The number of processes in the group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def local_rank() -> int:
    """This process's GPU on its host: ``torchrun``'s ``LOCAL_RANK``, else
    the rank."""
    return int(os.environ.get("LOCAL_RANK", rank()))


def is_main() -> bool:
    """Rank 0: the process that writes the log dir and reads commands."""
    return rank() == 0


def data_parallel_size() -> int:
    """The world size the data-parallel math sees: 1 inside
    ``suspended()``."""
    return 1 if _is_suspended() else world_size()


def data_parallel_rank() -> int:
    """The rank the data-parallel math sees: 0 inside ``suspended()``."""
    return 0 if _is_suspended() else rank()


@contextlib.contextmanager
def suspended():
    """A block without data-parallel collectives: BatchNorm takes the local
    batch's statistics, draws are local and gradients are not reduced. For
    work that not every rank runs, such as the evaluation on rank 0. It
    holds for the calling thread only: threads that feed the training
    meanwhile (the host loader, the pool refresh) still see the group."""
    _suspended.depth = getattr(_suspended, "depth", 0) + 1
    try:
        yield
    finally:
        _suspended.depth -= 1


def local_batch_slice(global_batch: int) -> tuple[int, int]:
    """(start, size) of this process's slice of a global batch; raises
    where the batch does not divide by the world size."""
    n = data_parallel_size()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by {n} processes")
    per = global_batch // n
    return data_parallel_rank() * per, per


@contextlib.contextmanager
def process_group(device_type: str = "cuda"):
    """``init_distributed`` from ``torchrun``'s environment for the block
    (nothing without it); a group made here is destroyed after it."""
    made = not dist.is_initialized() and init_distributed(device_type=device_type)
    try:
        yield
    finally:
        if made:
            shutdown()


def bind_device(device: str | torch.device) -> torch.device:
    """``device`` with a group on CUDA: this process's GPU,
    ``cuda:LOCAL_RANK`` where no index is given, made the current one.
    Otherwise ``device``."""
    device = torch.device(device)
    if device.type == "cuda" and dist.is_initialized():
        if device.index is None:
            device = torch.device("cuda", local_rank())
        torch.cuda.set_device(device)
    return device


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """``obj`` of rank ``src`` on every rank (pickled, over the host group);
    ``obj`` itself without a group."""
    if world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=_state["host_group"])
    return box[0]
