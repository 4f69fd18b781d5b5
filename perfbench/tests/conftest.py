"""Shared pieces of the benchmark's CPU tests: a configuration and cells
cut to a size the CPU runs in seconds (the benchmark's own cells run only
on the card), and the ``cuda`` marker for tests that need a card, which
skip here. Whether a card is present is decided inside the ``cuda_device``
fixture, never while a module is imported."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import harness  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card: python -m pytest perfbench/tests -m cuda)")
    return torch.device("cuda", 0)


@pytest.fixture
def tiny_config():
    config = copy.deepcopy(harness.load_json("configs", "loans-r50"))
    config["localizer"].update(input_size=[32, 32], out_size=[8, 8])
    config["assessor"]["ch"] = 8
    return config


@pytest.fixture
def tiny_cells():
    train = copy.deepcopy(harness.load_json("workloads", "r50-train-b64"))
    train["traffic"].update(batch=4, steps_per_call=2, pool_scenes=16, pool_crops=32, traced_calls=1)
    serve = copy.deepcopy(harness.load_json("workloads", "r50-serve-b32"))
    serve["traffic"].update(batch=4, pool_frames=16, check_batches=3, traced_batches=2)
    return {"train": train, "serve": serve}


@pytest.fixture
def spec(tiny_cells):
    """BENCHMARK.json with the tiny cells in place of the real ones."""
    spec = harness.benchmark_spec()
    names = {"r50-train-b64": tiny_cells["train"]["name"], "r50-serve-b32": tiny_cells["serve"]["name"]}
    for metric in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in metric:
            metric["workloads"] = [names.get(w, w) for w in metric["workloads"]]
    return spec


def run(cell, config, spec, seed=3, seconds=0.2, trace=False):
    return harness.run_cell(cell, config, spec, seed=seed, seconds=seconds, trace=trace,
                            device=torch.device("cpu"), t0=harness.clock())
