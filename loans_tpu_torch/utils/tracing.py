"""Named ranges at the port's layer boundaries, on ``torch.profiler``'s
clock.

``span(name)`` marks a phase of the hot path. While a profiler runs (the
training CLI's ``--profile``, or any ``torch.profiler.profile`` around the
call) it enters ``torch.profiler.record_function(name)``: the range lands
as a ``user_annotation`` event in the same Kineto trace as the device's
kernels and copies, nested in the span around it. With no profiler
running it costs one check of the profiler's state and returns a shared
no-op context. Names start with ``loans.``; PERF.md lists every span and
the metrics that read it.
"""

from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """A profiler range named ``name`` around a ``with`` block; a no-op
    while no profiler runs."""
    if not torch._C._autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)
