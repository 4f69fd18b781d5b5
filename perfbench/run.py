"""Benchmark of ``loans_tpu_torch`` on NVIDIA H100 cards: one cell, one run.

    python3 perfbench/run.py --workload r50-train-b64 --seed 7 --seconds 10 --trace 0

Run from the root of a checkout. It makes the cell's weights and inputs
on the card from ``--seed``, warms up the cell's shapes (set-up), measures
for ``--seconds`` (``--trace 0``: the cell's end-to-end metrics) or
measures and then traces a stretch and reads the per-layer metrics
(``--trace 1``), checks the timed path's outputs against the plain
reference, and prints one JSON line last on standard output. Without a
CUDA card, or with fewer than the cell asks for, it exits with code 2 and
prints no result; if a module of the JAX side was loaded, with code 3.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from perfbench import harness

    print(f"setup: torch imported at {time.perf_counter() - T0:.3f} s", file=sys.stderr)

    spec = harness.benchmark_spec()
    workload = harness.load_json("workloads", args.workload)
    config = harness.load_json("configs", workload["config"])
    chips = int(workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: the cell {args.workload} needs {chips} CUDA card(s); found {found}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.cuda.init()
    print(f"setup: card ready at {time.perf_counter() - T0:.3f} s", file=sys.stderr)
    line = harness.run_cell(workload, config, spec, seed=args.seed, seconds=args.seconds,
                            trace=bool(args.trace), device=device, t0=T0)
    found = harness.forbidden_modules()
    if found:
        print(f"perfbench: modules of the JAX side were loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
