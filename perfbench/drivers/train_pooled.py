"""Closed-loop training: back-to-back calls of the program's pooled step
(K steps over batches gathered on the card from resident pools), as the
training CLI's ``Trainer`` makes them.

Set-up builds the program, makes its weights and pools from the seed and
runs the warm-up calls, whose first steps the reference follows. The
window makes calls until ``seconds`` have passed, then syncs the card:
``train_images_per_s`` is every image of every call made, over the
seconds from the window's start to that sync.
"""

from __future__ import annotations

import torch

from perfbench import trace
from perfbench.harness import clock


def setup(ctx, adapter):
    program = adapter.train_program(ctx)
    ctx.sync()
    ctx.mark("program built")
    for i in range(ctx.traffic["warmup_calls"]):
        program.call()
        ctx.sync()
        ctx.mark(f"warm-up call {i + 1}")
    return program


def window(ctx, program, seconds: float) -> dict:
    losses = []
    start = clock()
    while clock() - start < seconds:
        losses.append(program.call()[program.loss_key])
    ctx.sync()
    elapsed = clock() - start
    calls = len(losses)
    failed = int((~torch.isfinite(torch.stack(losses))).sum()) if losses else 0
    images = calls * program.images_per_call
    return {"t_start": start, "seconds": elapsed, "calls": calls, "steps": calls * program.steps_per_call,
            "images": images, "attempted": calls, "failed": failed, "train_images_per_s": images / elapsed}


def traced(ctx, program):
    calls = ctx.traffic["traced_calls"]

    def stretch():
        for _ in range(calls):
            program.call()

    return trace.profile(stretch, ctx.device), {"calls": calls, "steps": calls * program.steps_per_call}


def finish(ctx, program) -> dict:
    readings = program.readings()
    program.close()
    return readings


def check(ctx, adapter, readings) -> dict[str, float]:
    return adapter.train_check(ctx, readings)
