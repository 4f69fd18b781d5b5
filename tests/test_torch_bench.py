"""The port's training bench (``loans_tpu_torch.bench``), on the CPU.

The bench's number is a time on the card; here only its path runs:
``measure`` at R-18, batch 2, 32²→8², one timed call of two steps, and
``main``'s JSON line. The operating point (batch, calls, steps per call,
pools, the north-star baseline) is the root ``bench.py``'s, read from its
source, which imports JAX.
"""

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from loans_tpu_torch import bench

ROOT_BENCH = Path(__file__).resolve().parents[1] / "bench.py"
KEYS = {"metric", "value", "unit", "vs_baseline", "batch", "backend"}


def _root_constants() -> dict:
    tree = ast.parse(ROOT_BENCH.read_text())
    out = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name):
            try:
                out[node.targets[0].id] = ast.literal_eval(node.value)
            except ValueError:
                pass
    return out


def test_operating_point_is_the_root_bench():
    root = _root_constants()
    for name in ("BATCH", "STEPS_PER_CALL", "WARMUP_CALLS", "CALLS", "POOL_SCENES", "POOL_CROPS"):
        assert getattr(bench, name) == root[name], name
    assert bench.BASELINE_IMAGES_PER_SEC == 5 * 80.0
    src = ROOT_BENCH.read_text()
    assert '"localizer_train_images_per_sec_per_chip"' in src and '"images/sec/chip"' in src


def test_measure_runs_small_on_the_cpu(capsys):
    run = bench.measure(2, device="cpu", n_layers=18, image_size=32, crop_size=8, steps_per_call=2,
                        warmup_calls=1, calls=1, pool_scenes=4, pool_crops=4)
    assert run["device"] == "cpu" and len(run["call_ms"]) == 1
    assert run["images_per_sec"] > 0 and np.isfinite(run["loss_localizer"])
    line = bench.result_line(run, 2)
    print(json.dumps(line))
    assert set(line) == KEYS
    assert line["metric"] == "localizer_train_images_per_sec_per_chip" and line["unit"] == "images/sec/chip"
    assert line["batch"] == 2 and "cpu" in line["backend"]
    assert line["vs_baseline"] == round(run["images_per_sec"] / 400.0, 3)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == line


@pytest.mark.parametrize("batch64", [False, True])
def test_main_prints_one_json_line(monkeypatch, capsys, batch64):
    calls = []

    def fake(batch, device):
        calls.append((batch, device))
        return {"images_per_sec": 1234.5678 / batch * 128, "call_ms": [1.0], "loss_localizer": 0.1, "device": "cpu"}

    monkeypatch.setattr(bench, "measure", fake)
    if batch64:
        monkeypatch.setenv("LOANS_BENCH_BATCH64", "1")
    else:
        monkeypatch.delenv("LOANS_BENCH_BATCH64", raising=False)
    out = bench.main(["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == out
    assert set(out) == KEYS | ({"batch64_images_per_sec_per_chip"} if batch64 else set())
    assert out["value"] == 1234.57 and out["batch"] == 128
    assert calls == [(128, "cpu")] + ([(64, "cpu")] if batch64 else [])


def test_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.measure()
