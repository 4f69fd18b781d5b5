"""A traced stretch of a run and what is read from it.

``profile`` runs a stretch under ``torch.profiler`` (CUPTI on the card)
inside a span of the benchmark's own, exports the Chrome trace to a
temporary file, reads it back and deletes it. ``Trace`` keeps the device's
activity (kernels, copies and fills on every stream) and the host's events
(operators, spans, runtime calls). The device is busy over the union of
its activity intervals, so overlapping streams count once.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict

import numpy as np
import torch

from perfbench.yardstick import gaps, union_length

SPAN = "perfbench.traced"
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "user_annotation", "cuda_runtime", "cuda_driver"}
RUNTIME_CATS = {"cuda_runtime", "cuda_driver"}
NAME_CHARS = 120


class Trace:
    """Events in microseconds on the trace's clock: ``device`` and
    ``host`` lists of (start, end, name, category); ``window`` the span
    around the stretch."""

    def __init__(self, device, host, window):
        self.device = device
        self.host = host
        self.window = window

    @classmethod
    def from_chrome(cls, data: dict) -> "Trace":
        device, host, window = [], [], None
        for e in data.get("traceEvents", []):
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat = str(e.get("cat", "")).lower()
            start = float(e["ts"])
            item = (start, start + float(e["dur"]), str(e.get("name", "")), cat)
            if cat in DEVICE_CATS:
                device.append(item)
            elif cat in HOST_CATS:
                host.append(item)
                if cat == "user_annotation" and item[2] == SPAN:
                    window = (item[0], item[1])
        if window is None:
            raise RuntimeError(f"the trace holds no {SPAN!r} span")
        return cls(device, host, window)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    @property
    def busy_s(self) -> float:
        return union_length([(a, b) for a, b, _, _ in self.device], *self.window) * 1e-6

    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s

    def kernels(self) -> int:
        return sum(1 for _, _, _, cat in self.device if cat == "kernel")

    def copy_s(self, direction: str) -> float:
        """Device seconds of copies whose name holds ``direction``
        ('HtoD', 'DtoH', 'DtoD')."""
        return sum(b - a for a, b, name, cat in self.device if cat == "gpu_memcpy" and direction in name) * 1e-6

    def device_ops(self, top: int = 10) -> list[list]:
        """The device operations that took most time: [name, seconds]."""
        total: dict[str, float] = defaultdict(float)
        for a, b, name, _ in self.device:
            total[name[:NAME_CHARS]] += (b - a) * 1e-6
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10, most: int = 5000) -> list[list]:
        """The device's idle stretches inside the window, by what the host
        was doing at each one's midpoint (the innermost host operator or
        span, and the runtime call under it), summed by that label:
        [label, seconds]. Only the ``most`` longest stretches are labelled;
        the rest are summed under '(shorter gaps)'."""
        stretches = sorted(gaps([(a, b) for a, b, _, _ in self.device], *self.window), key=lambda g: g[0] - g[1])
        total: dict[str, float] = defaultdict(float)
        ops = [h for h in self.host if h[3] not in RUNTIME_CATS and h[2] != SPAN]
        calls = [h for h in self.host if h[3] in RUNTIME_CATS]
        for a, b in stretches[most:]:
            total["(shorter gaps)"] += (b - a) * 1e-6
        for (a, b), label in zip(stretches[:most], _labels(stretches[:most], ops, calls)):
            total[label] += (b - a) * 1e-6
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:top]]


def _innermost(mids: np.ndarray, events) -> list[str | None]:
    if not events:
        return [None] * len(mids)
    starts = np.array([e[0] for e in events])
    ends = np.array([e[1] for e in events])
    span = ends - starts
    out = []
    for m in mids:
        inside = (starts <= m) & (ends >= m)
        if not inside.any():
            out.append(None)
            continue
        i = int(np.argmin(np.where(inside, span, np.inf)))
        out.append(events[i][2][:NAME_CHARS])
    return out


def _labels(stretches, ops, calls) -> list[str]:
    mids = np.array([(a + b) / 2 for a, b in stretches])
    labels = []
    for op, call in zip(_innermost(mids, ops), _innermost(mids, calls)):
        label = op or "(between host operators)"
        labels.append(f"{label} > {call}" if call else label)
    return labels


def profile(stretch, device: torch.device) -> Trace:
    """Run ``stretch()`` under the profiler inside the span ``SPAN``,
    which ends after a device sync, and read the trace."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(SPAN):
            stretch()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    fd, path = tempfile.mkstemp(prefix="perfbench-trace-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.remove(path)
    return Trace.from_chrome(data)
