"""The run of one cell, driven by data.

Everything that belongs to one cell, configuration or per-layer metric is
found by its name:

* ``workloads/<cell>.json``: the cell's configuration, driver, traffic,
  chips, why, and the limits of its comparison;
* ``configs/<config>.json``: the configuration as it is run, with the
  ``family`` of models it belongs to;
* ``adapters/<family>.py``: how a configuration of the family is built in
  the program and in its reference;
* ``flops/<family>.py``: the operations of a step or a served batch;
* ``drivers/<driver>.py``: one window loop;
* ``metrics/<metric>.py``: one per-layer metric, read from the traced run.

``BENCHMARK.json`` says which metrics a cell reports.
"""

from __future__ import annotations

import importlib.util
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

from perfbench import compare, trace as tracing

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "loans_tpu")


def load_json(kind: str, name: str, base: Path = BENCH) -> dict:
    path = base / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    with open(path) as f:
        data = json.load(f)
    if data.get("name") != name:
        raise ValueError(f"{path} names itself {data.get('name')!r}, not {name!r}")
    return data


def load_module(kind: str, name: str, base: Path = BENCH):
    path = base / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    module_name = f"perfbench_{kind}_" + re.sub(r"\W", "_", name)
    if module_name in sys.modules:
        return sys.modules[module_name]
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[module_name] = module
    spec.loader.exec_module(module)
    return module


def benchmark_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell_metrics(spec: dict, cell: str) -> tuple[list[dict], list[dict]]:
    """The end-to-end and the per-layer metrics that ``cell`` reports: those
    that list it under ``workloads``, and those without the key (a
    per-layer one of them where the cell reports the metric it moves)."""
    ends = [m for m in spec["end_to_end"] if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in ends}
    layers = [m for m in spec["per_layer"]
              if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return ends, layers


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that belong to the JAX side,
    compared whole (``loans_tpu_torch`` is not ``loans_tpu``)."""
    tops = {name.split(".")[0] for name, mod in list(sys.modules.items()) if mod is not None}
    return sorted(tops & set(FORBIDDEN))


def power_limit_w() -> float | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=20, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


class Context:
    """What a driver, an adapter and a metric reader are handed."""

    def __init__(self, workload: dict, config: dict, seed: int, device: torch.device, t0: float | None = None):
        """``t0``: the clock at the process's start, from which ``mark``
        counts (by default, now)."""
        self.workload, self.config, self.seed, self.device = workload, config, seed, device
        self.traffic = workload["traffic"]
        self.window: dict = {}
        self.trace_data: tracing.Trace | None = None
        self.traced_units: dict = {}
        self.flops: dict = {}
        self.program = None
        self.memo: dict = {}  # inputs made once a run, for the program and the reference
        self.t0 = clock() if t0 is None else t0

    def mark(self, what: str) -> None:
        """A line on standard error: seconds since ``t0``."""
        print(f"setup: {what} at {clock() - self.t0:.3f} s", file=sys.stderr)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def run_cell(workload: dict, config: dict, spec: dict, *, seed: int, seconds: float, trace: bool,
             device: torch.device, t0: float, base: Path = BENCH) -> dict:
    """Set up, measure, trace and check one cell; returns the result line.
    A run is correct where every number compared is within its limit and no
    step or batch of the window failed."""
    ends, layers = cell_metrics(spec, workload["name"])
    ctx = Context(workload, config, seed, device, t0)
    driver = load_module("drivers", workload["driver"], base)
    adapter = load_module("adapters", config["family"], base)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
    ctx.program = driver.setup(ctx, adapter)
    ctx.window = driver.window(ctx, ctx.program, seconds)
    ctx.window["setup_s"] = ctx.window["t_start"] - t0
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    metrics = {}
    breakdown = None
    if trace:
        ctx.flops = load_module("flops", config["family"], base).count(workload, config)
        ctx.trace_data, ctx.traced_units = driver.traced(ctx, ctx.program)
        for m in layers:
            value = load_module("metrics", m["name"], base).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        breakdown = {"device_ops": ctx.trace_data.device_ops(), "idle_gaps": ctx.trace_data.idle_gaps()}
    else:
        for m in ends:
            if m["name"] not in ctx.window:
                raise KeyError(f"the {workload['driver']} driver measured no {m['name']!r}")
            metrics[m["name"]] = {"value": float(ctx.window[m["name"]]), "unit": m["unit"]}
    outputs = driver.finish(ctx, ctx.program)
    ctx.program = None
    if cuda:
        torch.cuda.empty_cache()
    numbers = driver.check(ctx, adapter, outputs)
    limits = workload["limits"]
    correct = compare.verdict(numbers, limits) and ctx.window["failed"] == 0
    device_info = {
        "platform": "gpu" if cuda else device.type,
        "kind": torch.cuda.get_device_name(device) if cuda else device.type,
        "count": int(workload["chips"]),
        "memory_peak_bytes": int(peak),
        "power_limit_w": power_limit_w() if cuda else None,
    }
    if trace:
        device_info["busy_s"] = ctx.trace_data.busy_s
        device_info["window_s"] = ctx.trace_data.window_s
    line = {
        "correct": bool(correct),
        "attempted": int(ctx.window["attempted"]),
        "failed": int(ctx.window["failed"]),
        "metrics": metrics,
        "device": device_info,
    }
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    for k in limits:
        print(f"check {k} {numbers[k]!r} limit {limits[k]!r}", file=sys.stderr)
    return line


def clock() -> float:
    return time.perf_counter()
