"""Every file of the benchmark parses and is found by its name, and a new
cell, configuration or per-layer metric is taken up from new files alone."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from perfbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = harness.benchmark_spec()


def test_benchmark_json_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["perfbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    names = [e["name"] for key in ("configs", "workloads", "end_to_end", "per_layer") for e in SPEC[key]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
    for e in SPEC["configs"] + SPEC["workloads"]:
        for text in (e["why"], e.get("source", "why")):
            assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text, e["name"]
    assert len(json.dumps(SPEC)) < 64 * 1024
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    ends = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in ends and "\n" not in m["layer"]


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_files_found_by_name(cell):
    entry = next(w for w in SPEC["workloads"] if w["name"] == cell)
    workload = harness.load_json("workloads", cell)
    assert workload["config"] == entry["config"] and workload["chips"] == entry["chips"] == 1
    assert entry["traffic"] == cell
    config = harness.load_json("configs", workload["config"])
    for kind, name in (("drivers", workload["driver"]), ("adapters", config["family"]), ("flops", config["family"])):
        assert harness.load_module(kind, name) is not None
    ends, layers = harness.cell_metrics(SPEC, cell)
    assert "setup_s" in {m["name"] for m in ends} and len(ends) >= 2 and layers
    assert set(workload["limits"]) and all(v >= 0 for v in workload["limits"].values())


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_metric_reader_found_by_name(metric):
    assert callable(harness.load_module("metrics", metric).read)


@pytest.mark.parametrize("config", [c["name"] for c in SPEC["configs"]])
def test_config_file(config):
    entry = next(c for c in SPEC["configs"] if c["name"] == config)
    data = harness.load_json("configs", config)
    assert entry["file"] == f"perfbench/configs/{config}.json"
    assert data["reduced"] == entry["reduced"] and data["dtype"] == "float32" and data["tf32"] is False


def test_new_cell_config_and_metric_from_new_files_alone(tmp_path):
    base = tmp_path / "perfbench"
    shutil.copytree(harness.BENCH, base, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(base): p.read_bytes() for p in base.rglob("*") if p.is_file()}
    config = harness.load_json("configs", "loans-r50", base)
    config["name"] = "loans-r50-gray"
    (base / "configs" / "loans-r50-gray.json").write_text(json.dumps(config))
    cell = harness.load_json("workloads", "r50-serve-b32", base)
    cell.update(name="gray-serve-b16", config="loans-r50-gray")
    cell["traffic"]["batch"] = 16
    (base / "workloads" / "gray-serve-b16.json").write_text(json.dumps(cell))
    (base / "metrics" / "d2h_ms.serve.py").write_text("def read(ctx):\n    return 1.0\n")
    spec = json.loads(json.dumps(SPEC))
    spec["configs"].append({"name": "loans-r50-gray"})
    spec["workloads"].append({"name": "gray-serve-b16", "config": "loans-r50-gray"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "r50-serve-b32" in m.get("workloads", []):
            m["workloads"].append("gray-serve-b16")
    spec["per_layer"].append({"name": "d2h_ms.serve", "unit": "ms", "moves": "serve_images_per_s"})
    assert harness.load_json("workloads", "gray-serve-b16", base)["traffic"]["batch"] == 16
    assert harness.load_json("configs", "loans-r50-gray", base)["name"] == "loans-r50-gray"
    assert harness.load_module("adapters", config["family"], base).serve_program is not None
    assert harness.load_module("metrics", "d2h_ms.serve", base).read(None) == 1.0
    assert harness.load_module("flops", config["family"], base).count(cell, config)["serve_batch"] > 0
    ends, layers = harness.cell_metrics(spec, "gray-serve-b16")
    assert {m["name"] for m in ends} == {"serve_images_per_s", "serve_batch_ms_p95", "setup_s"}
    assert {"d2h_ms.serve", "mfu.serve", "idle_share.serve"} <= {m["name"] for m in layers}
    # the metric without a workloads key reaches every cell that reports what it moves, and no other
    assert "d2h_ms.serve" in {m["name"] for m in harness.cell_metrics(spec, "r50-serve-b32")[1]}
    assert "d2h_ms.serve" not in {m["name"] for m in harness.cell_metrics(spec, "r50-train-b64")[1]}
    after = {p.relative_to(base): p.read_bytes() for p in base.rglob("*") if p.is_file() and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items() if "__pycache__" not in k.parts)


def test_missing_names_are_refused():
    with pytest.raises(FileNotFoundError):
        harness.load_json("workloads", "no-such-cell")
    with pytest.raises(FileNotFoundError):
        harness.load_module("metrics", "no_such_metric")
