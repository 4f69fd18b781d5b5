"""The PyTorch port stands without JAX: the machines with the card have no
JAX, flax or ``loans_tpu`` dependencies installed.

A subprocess blocks ``jax``, ``flax`` and ``loans_tpu`` imports, and
``PIL``, ``cv2`` and ``matplotlib``, which the card's machine lacks too;
imports every module of ``loans_tpu_torch`` (the training and evaluation
CLIs, the bench, the synthetic world and the renders among them), generates
a tiny synthetic world, serves a tiny log dir on the CPU, with and without
VisualBackprop, sweeps it with the evaluation CLI (renders, deteval XML and
the report without matplotlib), and runs one tiny alternating training
step, then one with rotation dropout at ratio 1.0 on the plain rotated crop
(``sampler="rotated"``).
It also checks that importing the package never runs ``nvcc`` and that
the CUDA kernels of both crops refuse CPU tensors. The sources of the port
and of ``chip_smoke.py``, which runs on the card, name none of them in an
import.
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
for name in ("jax", "jaxlib", "flax", "optax", "loans_tpu", "PIL", "cv2", "matplotlib"):
    sys.modules[name] = None  # any import of them raises ImportError

import importlib, pkgutil, tempfile
import numpy as np, torch
import loans_tpu_torch
import loans_tpu_torch.cli.train_localizer, loans_tpu_torch.data.synthetic
for info in pkgutil.walk_packages(loans_tpu_torch.__path__, "loans_tpu_torch."):
    importlib.import_module(info.name)
from loans_tpu_torch.ops import _cuda
assert _cuda.load_library.cache_info().currsize == 0
assert not spawned, spawned

from loans_tpu_torch.data.synthetic import SyntheticAssessorDataset, SyntheticLocalizerDataset
scenes = SyntheticLocalizerDataset(4, image_size=(32, 32), labeled=True, output_dtype="uint8")
crops = SyntheticAssessorDataset(4, output_size=(8, 8), image_size=(32, 32), output_dtype="uint8")
assert scenes[0][0].shape == (32, 32, 3) and crops[0][0].shape == (8, 8, 3)

from loans_tpu_torch.inference import LocalizerInference
from loans_tpu_torch.models import Localizer, ResnetAssessor
from loans_tpu_torch.ops import Size, sample_rotated_kernel, sample_separable_kernel
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
vbp_inf = LocalizerInference(log_dir, device="cpu", use_assessor=True, score_threshold=0.0,
                             use_visual_backprop=True)
vbp_boxes, _, _, heat = vbp_inf.localize_batch(frames)
assert np.array_equal(vbp_boxes, boxes) and len(heat) == 3
assert heat[0].shape == (32, 32, 3) and heat[0].dtype == np.uint8

import contextlib, io, os
from loans_tpu_torch.cli import evaluate
out_dir = tempfile.mkdtemp()
report = io.StringIO()
with contextlib.redirect_stdout(report):
    results = evaluate.main(["synthetic:4", log_dir, "-b", "2", "-a", "--bn-warmup", "1", "--device", "cpu",
                             "--save-predictions", out_dir, "--deteval", out_dir])
assert [e["snapshot_name"] for e in results.entries] == ["Localizer_1.pt"], report.getvalue()
assert 0.0 <= results.entries[0]["mean_assessor_score"] <= 1.0
assert sorted(os.listdir(os.path.join(out_dir, "1"))) == ["0.png", "1.png", "2.png", "3.png"]
assert os.path.exists(os.path.join(out_dir, "deteval_1.xml"))
assert "no metric curve drawn" in report.getvalue() and "best snapshot: Localizer_1.pt" in report.getvalue()

for kernel in (sample_separable_kernel, sample_rotated_kernel):
    try:
        kernel(torch.zeros(1, 4, 4, 3), torch.zeros(1, 2, 3), Size(2, 2))
    except ValueError as e:
        assert "CUDA" in str(e)
    else:
        raise AssertionError(f"{kernel.__name__} accepted a CPU tensor")
    assert kernel.launches == 0

from loans_tpu_torch.train import AlternatingConfig, alternating_step, create_train_state
loc_s, ass_s = create_train_state(loc), create_train_state(ass)
gen = torch.Generator().manual_seed(0)
batch = {
    "real": torch.randint(0, 256, (2, 8, 8, 3), dtype=torch.uint8, generator=gen),
    "labels": torch.rand(2, 1, generator=gen),
    "unlabeled": torch.randint(0, 256, (2, 32, 32, 3), dtype=torch.uint8, generator=gen),
}
head0 = loc.param_predictor.bias.detach().clone()
loc_s, ass_s, metrics = alternating_step(
    loc_s, ass_s, batch, gen, AlternatingConfig(image_size=Size(32, 32)))
assert loc_s.step == 1 and ass_s.step == 1
assert all(np.isfinite(float(v)) for v in metrics.values()), metrics
assert not torch.equal(loc.param_predictor.bias, head0)
assert sample_separable_kernel.launches_bwd_theta == 0

loc.rotation_dropout_ratio, loc.sampler = 1.0, "rotated"  # off-diagonals kept
bias0 = loc.param_predictor.bias.detach().clone()
loc_s, ass_s, metrics = alternating_step(
    loc_s, ass_s, batch, None, AlternatingConfig(image_size=Size(32, 32)))
assert loc_s.step == 2 and all(np.isfinite(float(v)) for v in metrics.values()), metrics
moved = loc.param_predictor.bias.detach() != bias0
assert moved[[1, 3]].all(), loc.param_predictor.bias  # theta01, theta10 train
assert sample_rotated_kernel.launches == 0 and sample_rotated_kernel.launches_bwd_theta == 0
assert not spawned, spawned
assert not [m for m, v in sys.modules.items()
            if v is not None and m.split(".")[0] in ("jax", "flax", "loans_tpu", "PIL", "cv2", "matplotlib")]
import shutil
shutil.rmtree(out_dir)
shutil.rmtree(log_dir)
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


def _imports(paths, banned):
    offenders = []
    for path in paths:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            offenders += [(path.name, n) for n in names if n.split(".")[0] in banned]
    return offenders


def test_port_sources_import_no_jax():
    """No module of the port, and not ``chip_smoke.py``, names jax, flax,
    loans_tpu or PIL in an import, even inside a function."""
    banned = ("jax", "jaxlib", "flax", "optax", "loans_tpu", "PIL")
    assert not _imports([*PACKAGE.rglob("*.py"), ROOT / "chip_smoke.py"], banned)


def test_training_cli_path_imports_no_cv2():
    """The training CLI's path (its data, evaluation, training and model
    modules, and ``chip_smoke.py``) names no cv2 either; only the image
    CLI and the serving helpers that draw or resize frames use it."""
    paths = [PACKAGE / "cli" / "train_localizer.py", ROOT / "chip_smoke.py"]
    for sub in ("data", "evaluation", "train", "models", "ops"):
        paths += list((PACKAGE / sub).rglob("*.py"))
    assert not _imports(paths, ("cv2",))


def test_evaluation_path_imports_no_cv2_or_matplotlib():
    """The evaluation CLI's and the bench's path (the loader, deteval, the
    sweep, VisualBackprop and the renders) and ``chip_smoke.py`` name
    neither cv2 nor matplotlib in an import (``Evaluator.plot`` loads
    matplotlib by name where it is installed), nor jax, flax, loans_tpu or
    PIL."""
    paths = [PACKAGE / "cli" / "evaluate.py", PACKAGE / "bench.py", PACKAGE / "data" / "loader.py",
             ROOT / "chip_smoke.py"]
    for sub in ("evaluation", "insights", "models"):
        paths += list((PACKAGE / sub).rglob("*.py"))
    assert not _imports(paths, ("cv2", "matplotlib", "jax", "jaxlib", "flax", "optax", "loans_tpu", "PIL"))
