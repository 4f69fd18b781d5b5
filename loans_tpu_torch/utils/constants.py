"""Constant tensors made once per device and dtype.

A small table built from Python data on every call (``torch.tensor(...,
device=...)``, ``x.new_tensor(...)``) is a blocking host-to-device copy on
a CUDA device: the host waits for the stream to drain before it can queue
the next kernel. The hot path takes such tables from here instead: each
is made on first use by the same operations on the same device as before,
so it holds the same bits, and every later call returns that tensor.

The tensors are shared by every caller (every model, step, data-parallel
rank's device and thread) and nothing may write to them in place. They are
made outside inference mode and without autograd, so a table first made
while serving can be saved for a training step's backward.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch


def device_constant(build: Callable[..., torch.Tensor]) -> Callable[..., torch.Tensor]:
    """Decorator: ``build(*key)`` runs once per hashable ``key`` (values, a
    dtype, a device) and its tensor is returned from then on. On a CUDA
    device the building stream is synchronised once, so the tensor is
    ready for every stream that reads it later."""

    @functools.cache
    @functools.wraps(build)
    def made(*key):
        with torch.inference_mode(False), torch.no_grad():
            table = build(*key)
        if table.is_cuda:
            torch.cuda.current_stream(table.device).synchronize()
        return table

    return made


@device_constant
def device_table(values, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``torch.tensor(values, dtype=dtype, device=device)``, made once;
    ``values`` is a number or a (nested) tuple of numbers."""
    return torch.tensor(values, dtype=dtype, device=device)
