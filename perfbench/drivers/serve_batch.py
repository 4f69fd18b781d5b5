"""One client in a closed loop: each batch of preprocessed frames, taken in
turn from a host pool, goes to the program's batched entry and its results
come back to the host before the next batch is sent.

``serve_images_per_s`` is the frames whose results reached the host in the
window over the window's seconds; ``serve_batch_ms_p95`` the 95th
percentile of every batch's time, from the call with the frames on the host
to its gated results on the host. A sample of the window's batches, drawn
from the seed (a reservoir), is kept for the comparison with the reference.
"""

from __future__ import annotations

import random

import numpy as np

from perfbench import inputs, trace
from perfbench.harness import clock
from perfbench.yardstick import percentile


def setup(ctx, adapter):
    program = adapter.serve_program(ctx)
    ctx.sync()
    ctx.mark("program built")
    for i in range(ctx.traffic["warmup_batches"]):
        program.serve(i)
        ctx.sync()
        ctx.mark(f"warm-up batch {i + 1}")
    return program


def window(ctx, program, seconds: float) -> dict:
    first = ctx.traffic["warmup_batches"]
    keep = ctx.traffic["check_batches"]
    rng = random.Random(inputs.sub_seed(ctx.seed, "sample"))
    sample, times = [], []
    start = clock()
    while clock() - start < seconds:
        index = first + len(times)
        t = clock()
        out = program.serve(index)
        times.append(clock() - t)
        n = len(times)
        if len(sample) < keep:
            sample.append((index, out))
        elif (j := rng.randrange(n)) < keep:
            sample[j] = (index, out)
    elapsed = clock() - start
    batches = len(times)
    program.sample = sorted(sample, key=lambda s: s[0])
    return {"t_start": start, "seconds": elapsed, "batches": batches, "attempted": batches, "failed": 0,
            "serve_images_per_s": batches * ctx.traffic["batch"] / elapsed,
            "serve_batch_ms_p95": percentile([s * 1e3 for s in times], 95)}


def traced(ctx, program):
    n = ctx.traffic["traced_batches"]
    first = ctx.traffic["warmup_batches"]

    def stretch():
        for i in range(n):
            program.serve(first + i)

    return trace.profile(stretch, ctx.device), {"batches": n}


def finish(ctx, program) -> dict:
    sample = program.sample
    program.close()
    outputs = {k: np.concatenate([out[k] for _, out in sample]) for k in ("boxes", "rois", "scores")}
    outputs["indices"] = [i for i, _ in sample]
    return outputs


def check(ctx, adapter, outputs) -> dict[str, float]:
    return adapter.serve_check(ctx, outputs)
