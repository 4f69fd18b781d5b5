"""What the benchmark loads: a run of each cell (tiny, on the CPU) loads
no module whose top-level name is ``jax``, ``jaxlib``, ``flax``, ``optax``
or ``loans_tpu``, compared whole, so that ``loans_tpu_torch`` is not taken
for ``loans_tpu``; the reference and the FLOP counts load nothing of
``loans_tpu_torch``."""

from __future__ import annotations

import ast
import subprocess
import sys
import textwrap

from perfbench import harness

BLOCK = "import sys\nfor name in {names!r}:\n    sys.modules[name] = None  # an import of it raises ImportError\n"

RUN = textwrap.dedent("""
    import copy, sys, torch
    sys.path.insert(0, {root!r})
    torch.set_num_threads(2)
    from perfbench import harness
    config = copy.deepcopy(harness.load_json("configs", "loans-r50"))
    config["localizer"].update(input_size=[32, 32], out_size=[8, 8]); config["assessor"]["ch"] = 8
    spec = harness.benchmark_spec()
    for name, traffic in (("r50-train-b64", dict(batch=4, steps_per_call=2, pool_scenes=16, pool_crops=16,
                                                 checked_steps=2, traced_calls=1)),
                          ("r50-serve-b32", dict(batch=4, pool_frames=8, check_batches=2, traced_batches=1))):
        cell = copy.deepcopy(harness.load_json("workloads", name))
        cell["traffic"].update(traffic)
        for trace in (False, True):
            harness.run_cell(cell, config, spec, seed=1, seconds=0.05, trace=trace,
                             device=torch.device("cpu"), t0=harness.clock())
    import perfbench.control
    found = harness.forbidden_modules()
    assert not found, found
    assert "loans_tpu_torch" in sys.modules
    print("clean")
""")

REFERENCE = textwrap.dedent("""
    import copy, sys, torch
    sys.path.insert(0, {root!r})
    from perfbench import harness, inputs
    from perfbench.reference import loans_pair as ref
    config = copy.deepcopy(harness.load_json("configs", "loans-r50"))
    config["localizer"].update(input_size=[32, 32], out_size=[8, 8]); config["assessor"]["ch"] = 8
    w = inputs.seeded_weights(ref.weight_spec(config), 1, "weights", "cpu")
    scenes = inputs.uint8_pool(1, "scenes", (4, 32, 32, 3), "cpu")
    crops = inputs.uint8_pool(1, "crops", (4, 8, 8, 3), "cpu")
    ref.train_steps(config, w, [(scenes, crops, torch.rand(4, 1))])
    ref.serve(config, ref.calibrate(config, w, torch.rand(4, 32, 32, 3)), torch.rand(4, 32, 32, 3))
    for spec in harness.benchmark_spec()["workloads"]:
        cell = harness.load_json("workloads", spec["name"])
        config = harness.load_json("configs", cell["config"])
        harness.load_module("flops", config["family"]).count(cell, config)
    tops = {{m.split(".")[0] for m, mod in sys.modules.items() if mod is not None}}
    assert "loans_tpu_torch" not in tops
    print("clean")
""")


def _run(script: str, blocked) -> None:
    code = BLOCK.format(names=tuple(blocked)) + script.format(root=str(harness.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0 and out.stdout.strip().endswith("clean"), out.stderr[-4000:]


def test_a_run_loads_nothing_of_the_jax_side():
    _run(RUN, harness.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    _run(REFERENCE, harness.FORBIDDEN + ("loans_tpu_torch",))


def test_top_level_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "loans_tpu_torchx", sys)
    assert "loans_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "loans_tpu.ops", sys)
    assert harness.forbidden_modules() == ["loans_tpu"]


def test_no_source_of_the_reference_names_the_program():
    for path in (harness.BENCH / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = [a.name for a in node.names] if isinstance(node, ast.Import) else [node.module or ""]
                assert not any(n.split(".")[0] in harness.FORBIDDEN + ("loans_tpu_torch",) for n in names), path
