"""The PyTorch port stands without JAX: the machines with the card have no
JAX, flax or ``loans_tpu`` dependencies installed.

A subprocess blocks ``jax``, ``flax`` and ``loans_tpu`` imports, imports
every module of ``loans_tpu_torch`` and serves a tiny log dir on the CPU.
It also checks that importing the package never runs ``nvcc`` and that
the CUDA kernel refuses CPU tensors.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "loans_tpu_torch"

SCRIPT = r"""
import subprocess, sys
spawned = []
_Popen = subprocess.Popen
class _Spy(_Popen):
    def __init__(self, args, *a, **k):
        spawned.append(args)
        super().__init__(args, *a, **k)
subprocess.Popen = _Spy
for name in ("jax", "jaxlib", "flax", "optax", "loans_tpu"):
    sys.modules[name] = None  # any import of them raises ImportError

import importlib, pkgutil, tempfile
import numpy as np, torch
import loans_tpu_torch
for info in pkgutil.walk_packages(loans_tpu_torch.__path__, "loans_tpu_torch."):
    importlib.import_module(info.name)
from loans_tpu_torch.ops import _cuda
assert _cuda.load_library.cache_info().currsize == 0
assert not spawned, spawned

from loans_tpu_torch.inference import LocalizerInference
from loans_tpu_torch.models import Localizer, ResnetAssessor
from loans_tpu_torch.ops import Size, sample_separable_kernel
from loans_tpu_torch.train import checkpoint

torch.manual_seed(0)
log_dir = tempfile.mkdtemp()
loc = Localizer(out_size=Size(8, 8), n_layers=18, input_size=Size(32, 32))
ass = ResnetAssessor(ch=8, in_size=Size(8, 8))
checkpoint.save_manifest(log_dir, {
    "localizer": {"model": "Localizer", "kwargs": {
        "out_size": [8, 8], "n_layers": 18, "input_size": [32, 32]}},
    "assessor": {"model": "ResnetAssessor", "kwargs": {"ch": 8}},
    "snapshot_names": ["Localizer", "ResnetAssessor"],
})
checkpoint.save_params(f"{log_dir}/Localizer_1.pt", loc.state_dict())
checkpoint.save_params(f"{log_dir}/ResnetAssessor_1.pt", ass.state_dict())
inf = LocalizerInference(log_dir, device="cpu", use_assessor=True, score_threshold=0.0)
frames = np.random.default_rng(0).uniform(size=(3, 32, 32, 3)).astype(np.float32)
boxes, rois, scores, heat = inf.localize_batch(frames)
assert boxes.shape == (3, 1, 4) and rois.shape == (3, 8, 8, 3) and scores.shape == (3,)
assert np.isfinite(boxes).all() and np.isfinite(rois).all()
assert ((scores > 0) & (scores < 1)).all() and heat is None

try:
    sample_separable_kernel(torch.zeros(1, 4, 4, 3), torch.zeros(1, 2, 3), Size(2, 2))
except ValueError as e:
    assert "CUDA" in str(e)
else:
    raise AssertionError("the kernel accepted a CPU tensor")
assert sample_separable_kernel.launches == 0
assert not spawned, spawned
assert not [m for m, v in sys.modules.items() if v is not None and m.split(".")[0] in ("jax", "flax", "loans_tpu")]
print("NO_JAX_OK")
"""


def test_port_imports_and_serves_without_jax():
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT],
        cwd=str(ROOT), env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "NO_JAX_OK" in proc.stdout


def test_port_sources_import_no_jax():
    """No module of the port names jax, flax or loans_tpu in an import,
    even inside a function."""
    banned = ("jax", "jaxlib", "flax", "optax", "loans_tpu")
    offenders = []
    for path in PACKAGE.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            offenders += [(path.name, n) for n in names if n.split(".")[0] in banned]
    assert not offenders, offenders
