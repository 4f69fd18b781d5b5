"""Training harness: the host-side loop around the step (port of
``loans_tpu/train/loop.py``).

A plain loop with interval hooks. Metrics stay on the device between log
intervals; at each log flush the loop waits for the device, so
``images_per_sec`` counts finished work. Snapshots go through
``train.checkpoint.save_state``. Randomness comes from one explicit
``torch.Generator``, passed to every step call, where the JAX package
splits keys. Runtime control (``train/control.py``: LR shifts, early stop,
the bbox plotter's switch) is not ported yet, nor the trainer methods it
calls.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Any, Callable, Iterable, Iterator

import torch

from loans_tpu_torch.train import checkpoint
from loans_tpu_torch.train.logger import MetricsLog


@dataclasses.dataclass
class Hook:
    """Call ``fn(trainer, iteration)`` every ``every`` iterations."""

    fn: Callable[["Trainer", int], None]
    every: int
    at_zero: bool = False  # BBOXPlotter runs at initialize time too
    name: str = ""

    def due(self, iteration: int) -> bool:
        if iteration == 0:
            return self.at_zero
        return self.every > 0 and iteration % self.every == 0

    def due_span(self, prev: int, iteration: int) -> bool:
        """Due if any multiple of ``every`` falls in (prev, iteration] —
        interval semantics that stay correct when the trainer advances
        multiple iterations per step call (pooled steps)."""
        if self.every <= 0:
            return False
        return iteration // self.every > prev // self.every


class Trainer:
    """Alternating-update training harness.

    Args:
      step_fn: ``(loc_state, ass_state, batch, generator) -> (loc_state,
        ass_state, metrics)``, e.g. ``train.steps.alternating_step`` or
        ``functools.partial(pooled_step, steps_per_call=K, config=...)``.
      batches: iterator of device-ready batches (or pooled chunks).
      generator: the steps' source of randomness.
      eval_fn: optional ``(trainer, iteration) -> dict`` of metrics,
        merged into the log entry at each log interval.
      lr_schedule: optional ``iteration -> lr | None``; a float return
        sets both optimizers' learning rate.
      control: runtime command channel; not ported yet, must be None.
    """

    def __init__(
        self,
        step_fn,
        loc_state,
        ass_state,
        batches: Iterator[Any],
        log_dir: str,
        max_iterations: int,
        generator: torch.Generator | None = None,
        config: dict[str, Any] | None = None,
        snapshot_interval: int = 0,
        log_interval: int = 100,
        eval_fn: Callable[["Trainer", int], dict] | None = None,
        lr_schedule: Callable[[int], float | None] | None = None,
        hooks: Iterable[Hook] = (),
        control=None,
        snapshot_names: tuple[str, str] = ("Localizer", "ResnetAssessor"),
        keep_snapshots: int = 0,
        print_report: bool = True,
        steps_per_call: int = 1,
    ):
        if control is not None:
            raise NotImplementedError(
                "Trainer(control=...) is not ported: train/control.py is "
                "ROADMAP.md Queue 1 item 9"
            )
        self.step_fn = step_fn
        self.loc_state = loc_state
        self.ass_state = ass_state
        self.batches = batches
        self.log_dir = log_dir
        self.max_iterations = max_iterations
        self.generator = generator
        self.snapshot_interval = snapshot_interval
        self.log_interval = log_interval
        self.eval_fn = eval_fn
        self.lr_schedule = lr_schedule
        self.hooks = list(hooks)
        self.snapshot_names = snapshot_names
        self.keep_snapshots = keep_snapshots
        self.print_report = print_report
        self.steps_per_call = steps_per_call
        self._last_lr_set: float | None = None
        self.log = MetricsLog(log_dir, config=config)
        self.iteration = int(loc_state.step)
        self._pending_metrics: list[dict[str, torch.Tensor]] = []
        self._t_interval = time.perf_counter()
        self._images_in_interval = 0

    # -- main loop ------------------------------------------------------------
    def run(self):
        os.makedirs(self.log_dir, exist_ok=True)
        for hook in self.hooks:
            if hook.at_zero and self.iteration == 0:
                hook.fn(self, 0)
        while self.iteration < self.max_iterations:
            batch = next(self.batches, None)
            if batch is None:
                break
            prev = self.iteration
            self.loc_state, self.ass_state, metrics = self.step_fn(
                self.loc_state, self.ass_state, batch, self.generator
            )
            self.iteration += self.steps_per_call
            self._pending_metrics.append(metrics)
            self._images_in_interval += _batch_size(batch)

            if self.lr_schedule is not None:
                lr = self.lr_schedule(self.iteration)
                if lr is not None and lr != self._last_lr_set:
                    self._last_lr_set = lr
                    self.loc_state = self.loc_state.with_learning_rate(lr)
                    if self.ass_state is not None:
                        self.ass_state = self.ass_state.with_learning_rate(lr)

            if self.log_interval and _crossed(prev, self.iteration, self.log_interval):
                self._flush_log()
            if self.snapshot_interval and _crossed(prev, self.iteration, self.snapshot_interval):
                self.save_snapshot()
            for hook in self.hooks:
                if hook.due_span(prev, self.iteration):
                    hook.fn(self, self.iteration)
        if self._pending_metrics:
            self._flush_log()
        self.save_snapshot()
        return self.loc_state, self.ass_state

    def _flush_log(self):
        pending, self._pending_metrics = self._pending_metrics, []
        devices = {v.device for m in pending for v in m.values()}
        for device in devices:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        dt = time.perf_counter() - self._t_interval
        means: dict[str, list[float]] = {}
        for m in pending:
            for k, v in m.items():
                means.setdefault(k, []).append(float(v))
        entry: dict[str, Any] = {k: sum(v) / len(v) for k, v in means.items()}
        entry["iteration"] = self.iteration
        entry["lr"] = float(self.loc_state.learning_rate)
        entry["images_per_sec"] = self._images_in_interval / dt if dt > 0 else 0.0
        self._t_interval = time.perf_counter()
        self._images_in_interval = 0
        if self.eval_fn is not None:
            entry.update(self.eval_fn(self, self.iteration))
        self.log.append(entry)
        if self.print_report:
            print("  ".join(
                f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in entry.items() if k != "elapsed_time"
            ))

    def save_snapshot(self):
        for name, state in zip(self.snapshot_names, (self.loc_state, self.ass_state)):
            if state is None:
                continue
            path = os.path.join(self.log_dir, checkpoint.snapshot_name(name, self.iteration))
            checkpoint.save_state(path, state)
            if self.keep_snapshots:
                snaps = checkpoint.list_snapshots(self.log_dir, name + "_")
                for _, old in snaps[: -self.keep_snapshots]:
                    try:
                        os.remove(old)
                    except OSError:
                        pass

    def resume(self, loc_path: str | None = None, ass_path: str | None = None):
        """Resume full state from snapshots. ``max_iterations`` is TOTAL,
        so resuming a snapshot at or beyond it would train nothing: that
        is always a flag mistake, and it fails loudly."""
        if loc_path:
            self.loc_state = checkpoint.restore_state(loc_path, self.loc_state)
        if ass_path and self.ass_state is not None:
            self.ass_state = checkpoint.restore_state(ass_path, self.ass_state)
        self.iteration = int(self.loc_state.step)
        if self.iteration >= self.max_iterations:
            raise SystemExit(
                f"resumed snapshot is at iteration {self.iteration} but "
                f"--iterations {self.max_iterations} is TOTAL (not "
                f"additional): nothing would train. Pass --iterations "
                f"{self.iteration} + <extra steps>."
            )
        return self


def _crossed(prev: int, cur: int, every: int) -> bool:
    """True when a multiple of ``every`` falls in (prev, cur]."""
    return cur // every > prev // every


def _batch_size(batch) -> int:
    if isinstance(batch, dict) and "idx" in batch and "pools" in batch:
        # pooled chunk: (steps_per_call, batch) index tensors
        first = next(iter(batch["idx"].values()))
        return math.prod(first.shape)
    first = next(iter(batch.values())) if isinstance(batch, dict) else batch[0]
    return int(first.shape[0])


def two_state_lr_shifter(
    start_lr: float,
    target_lr: float,
    start_iteration: int,
    end_iteration: int,
) -> Callable[[int], float | None]:
    """Piecewise-linear LR interpolation between two iterations
    (``train_utils/train_utils.py:32-82`` ``TwoStateLearningRateShifter``)."""

    def schedule(iteration: int) -> float | None:
        if iteration < start_iteration:
            return None
        if iteration >= end_iteration:
            return target_lr
        frac = (iteration - start_iteration) / max(end_iteration - start_iteration, 1)
        return start_lr + frac * (target_lr - start_lr)

    return schedule


def multiplicative_lr_decay(
    shift: float, every: int, base_lr: float
) -> Callable[[int], float | None]:
    """Multiply LR by ``shift`` every ``every`` iterations
    (``train_utils/train_utils.py:17-29`` ``AttributeUpdater``)."""

    def schedule(iteration: int) -> float | None:
        if every > 0 and iteration // every > 0:
            return base_lr * (shift ** (iteration // every))
        return None

    return schedule
