"""Readings that the limits of a cell's comparison are set from, on the
card at the cell's own size:

* the program, run as a benchmark run runs it (set-up, for serving a short
  window at the cell's load), against the reference, on each of ``--seeds``
  (the lower readings);
* the control, the reference in TF32 put in the program's place, and for
  training the fault of half of each batch planted in the reference, on
  each of ``--control-seeds`` (the upper readings).

    python3 perfbench/control.py --workload r50-train-b64 --seeds 1 2 3 --control-seeds 4 5 6

Prints one JSON line per reading and a summary (the largest program
reading and the smallest control reading of each number); with ``--out``
also writes them there.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def worst_leaves(prog: dict[str, float], ref: dict[str, float], top: int = 3) -> list:
    median = statistics.median(ref.values())
    return sorted(((abs(prog[k] - ref[k]) / max(ref[k], median), k) for k in ref), reverse=True)[:top]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=2.0, help="serving: the short window's seconds")
    p.add_argument("--out", help="also write the readings here (JSON)")
    args = p.parse_args(argv)

    import torch

    from perfbench import harness

    workload = harness.load_json("workloads", args.workload)
    config = harness.load_json("configs", workload["config"])
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    driver = harness.load_module("drivers", workload["driver"])
    adapter = harness.load_module("adapters", config["family"])
    train = workload["driver"] == "train_pooled"
    lines = []

    def emit(line):
        lines.append(line)
        print(json.dumps(line), flush=True)

    for seed in args.seeds:
        t = time.perf_counter()
        ctx = harness.Context(workload, config, seed, device)
        program = driver.setup(ctx, adapter)
        if not train:
            driver.window(ctx, program, args.seconds)
        outputs = driver.finish(ctx, program)
        del program
        torch.cuda.empty_cache()
        line = {"seed": seed, "kind": "program"}
        if train:
            truth = adapter.train_reference(ctx)
            from perfbench import compare
            line["numbers"] = compare.train(outputs, truth)
            line["losses"] = {"program": outputs["losses"], "reference": truth["losses"]}
            line["worst"] = {k: worst_leaves(outputs[k], truth[k]) for k in ("grad1", "change")}
            for step, (mp, mr) in enumerate(zip(outputs.get("moments", []), truth.get("moments", []))):
                line["worst"].update({f"{m}{step + 1}": worst_leaves(mp[m], mr[m]) for m in mr})
        else:
            line["numbers"] = driver.check(ctx, adapter, outputs)
        line["seconds"] = time.perf_counter() - t
        emit(line)
    for seed in args.control_seeds:
        t = time.perf_counter()
        ctx = harness.Context(workload, config, seed, device)
        if train:
            readings = adapter.train_controls(ctx)
        else:
            first = workload["traffic"]["warmup_batches"]
            readings = adapter.serve_controls(ctx, list(range(first, first + workload["traffic"]["check_batches"])))
        for kind, numbers in readings.items():
            emit({"seed": seed, "kind": kind, "numbers": numbers, "seconds": time.perf_counter() - t})
        torch.cuda.empty_cache()
    summary = {}
    for line in lines:
        for k, v in line["numbers"].items():
            entry = summary.setdefault(line["kind"], {}).setdefault(k, [])
            entry.append(v)
    summary = {kind: {k: (max(v) if kind == "program" else min(v)) for k, v in nums.items()}
               for kind, nums in summary.items()}
    print(json.dumps({"summary": summary, "device": torch.cuda.get_device_name(device),
                      "power_limit_w": harness.power_limit_w()}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"workload": args.workload, "readings": lines, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
