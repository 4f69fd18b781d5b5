"""Profiling hooks of the training loop (port of
``loans_tpu/train/profiling.py``).

``ProfileHook`` traces iterations [start, start + steps) with
``torch.profiler`` (the host's operators and, on the card, its kernels)
and writes a Chrome JSON trace under ``<log_dir>/profile``, readable in
Perfetto or ``chrome://tracing``; the training CLI's ``--profile START
STEPS`` adds it. The window is rounded to step calls: the hook runs after
each call, which trains ``--steps-per-call`` iterations; a run that ends
inside the window writes the trace at its end (``close``). The trace holds
the port's ``loans.*`` phase spans (``utils.tracing``). ``StepTimer``
records the wall time between hook calls after a device sync and reports
its percentiles under the JAX package's keys.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch


def _device(trainer) -> torch.device:
    return next(trainer.loc_state.model.parameters()).device


def _sync(trainer) -> None:
    device = _device(trainer)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ProfileHook:
    """A ``Hook`` fn (``every=1``): trace iterations [start, start+steps)."""

    def __init__(self, log_dir: str, start: int = 50, steps: int = 5):
        self.trace_dir = os.path.join(log_dir, "profile")
        self.start = start
        self.steps = steps
        self._profiler: torch.profiler.profile | None = None
        self.done = False

    def __call__(self, trainer, iteration: int) -> None:
        if self.done:
            return
        if self._profiler is None and iteration >= self.start:
            os.makedirs(self.trace_dir, exist_ok=True)
            activities = [torch.profiler.ProfilerActivity.CPU]
            if _device(trainer).type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._profiler = torch.profiler.profile(activities=activities)
            self._profiler.__enter__()
            self._t0 = time.perf_counter()
            self._first = iteration
        elif self._profiler is not None and iteration >= self.start + self.steps:
            self._finish(trainer, iteration)

    def close(self, trainer) -> None:
        """End a window that the run stopped inside and write its trace
        (``Trainer.run`` calls it at the run's end)."""
        if self._profiler is not None:
            self._finish(trainer, trainer.iteration)

    def _finish(self, trainer, iteration: int) -> None:
        _sync(trainer)  # the trace holds the device's work of the window
        self._profiler.__exit__(None, None, None)
        self._profiler.export_chrome_trace(os.path.join(self.trace_dir, f"trace_{self._first}_{iteration}.json"))
        self._profiler = None
        self.done = True
        dt = time.perf_counter() - self._t0
        print(f"profiler trace ({iteration - self._first} steps, {dt:.2f}s) -> {self.trace_dir}")


class StepTimer:
    """A ``Hook`` fn: the wall time between calls, after a device sync
    (use a coarse ``every``, or accept the sync); ``report()``."""

    def __init__(self):
        self._last: float | None = None
        self.latencies: list[float] = []

    def __call__(self, trainer, iteration: int) -> None:
        _sync(trainer)
        now = time.perf_counter()
        if self._last is not None:
            self.latencies.append(now - self._last)
        self._last = now

    def report(self) -> dict:
        if not self.latencies:
            return {}
        lat = np.asarray(self.latencies)
        return {
            "step_ms_p50": float(np.percentile(lat, 50) * 1e3),
            "step_ms_p90": float(np.percentile(lat, 90) * 1e3),
            "step_ms_p99": float(np.percentile(lat, 99) * 1e3),
            "step_ms_mean": float(lat.mean() * 1e3),
        }
