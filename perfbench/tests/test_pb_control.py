"""The control of each cell on the card, at a size a test run holds: the
reference computed in TF32 (the precision below the configurations'
float32 with TF32 off), put in the program's place, comes out not correct,
while the program at the same size comes out correct. The limits are the
cells' own; the readings they were set from, at the cells' sizes, are in
PERF.md (``perfbench/control.py`` takes them)."""

from __future__ import annotations

import copy

import pytest

from perfbench import compare, harness

SMALL = {
    "r50-train-b64": dict(batch=8, pool_scenes=32, pool_crops=32, steps_per_call=2),
    "ssd300-train-b32": dict(batch=4, pool_scenes=16, steps_per_call=2),
    "r50-serve-b32": dict(batch=8, pool_frames=32, check_batches=2),
}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_tf32_control_fails_and_the_program_passes(cell, cuda_device):
    workload = copy.deepcopy(harness.load_json("workloads", cell))
    workload["traffic"].update(SMALL[cell])
    config = harness.load_json("configs", workload["config"])
    spec = harness.benchmark_spec()
    line = harness.run_cell(workload, config, spec, seed=2**31 + 99, seconds=1.0, trace=False,
                            device=cuda_device, t0=harness.clock())
    assert line["correct"], line["checks"]
    ctx = harness.Context(workload, config, 2**31 + 99, cuda_device)
    adapter = harness.load_module("adapters", config["family"])
    if workload["driver"] == "train_pooled":
        controls = adapter.train_controls(ctx)
    else:
        first = workload["traffic"]["warmup_batches"]
        controls = adapter.serve_controls(ctx, list(range(first, first + workload["traffic"]["check_batches"])))
    assert not compare.verdict(controls["tf32"], workload["limits"]), controls["tf32"]
