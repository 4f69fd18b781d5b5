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
(``sampler="rotated"``); then one SSD300 iteration of the SSD training CLI
on the CPU (the device augmentation on the plain crop, the encoder, the
multibox loss and the optimizer, and mAP through NMS), its log dir served
through ``load_inference`` and swept by the evaluation CLI; then image
files: PNGs written by the port (every row filter) read back by its
decoder, ``generate_dataset``, the training CLI on an image list, an
IoU-labeled csv and a labeled csv with the host loader, its log dir swept
against the csv, the SSD CLI on a gt json with ``--no-augment``, and the
augmenting SSD transform refused by name without cv2; then a frame streamed
from the progress client to its server, and the BBoxPlotter (its caption's
font) and the video CLI refused by name without Pillow and cv2; then the
offline tools (tkinter blocked too): ``generate_scenes``, ``paste_and_crop``
and the snapshot edits of the dataset tools, the subcommands that need
matplotlib or cv2 and the annotator refused by name, and the supervisor
over a child that completes.
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
for name in ("jax", "jaxlib", "flax", "optax", "loans_tpu", "PIL", "cv2", "matplotlib", "tkinter"):
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
from loans_tpu_torch.cli import train_ssd
from loans_tpu_torch.inference import SSDInference, load_inference
ssd_root = tempfile.mkdtemp()
ssd_dir = train_ssd.main(["synthetic:2", "synthetic:2", "-b", "1", "--steps-per-call", "1", "--iterations", "1",
                          "--log-interval", "1", "--eval-interval", "1", "--eval-batches", "1", "--device", "cpu",
                          "--log-dir", ssd_root])
assert sorted(os.listdir(ssd_dir)) == ["SSD300_1.pt", "log", "manifest.json"]
ssd = load_inference(ssd_dir, device="cpu", score_threshold=0.6)
assert isinstance(ssd, SSDInference)
ssd_boxes, _, ssd_scores, _ = ssd.localize(np.random.default_rng(0).uniform(size=(300, 300, 3)).astype(np.float32))
assert ssd_boxes.shape[1:] == (4,) and len(ssd_scores) == len(ssd_boxes)
with contextlib.redirect_stdout(io.StringIO()):
    swept = evaluate.main(["synthetic:2", ssd_dir, "-b", "1", "--device", "cpu"])
assert [e["snapshot_name"] for e in swept.entries] == ["SSD300_1.pt"]
assert sample_separable_kernel.launches == 0 and not spawned, spawned
assert not [m for m, v in sys.modules.items()
            if v is not None and m.split(".")[0] in ("jax", "flax", "loans_tpu", "PIL", "cv2", "matplotlib")]

# image files without Pillow or cv2: the port's writer, its PNG decoder,
# generate_dataset, both training CLIs with the host loader, the sweep
import json
from loans_tpu_torch.data import datasets, synthetic as syn
from loans_tpu_torch.data.ssd_augment import SSDTransform
from loans_tpu_torch.insights.rendering import write_png
files = tempfile.mkdtemp()
crops_csv = syn.generate_dataset(os.path.join(files, "crops"), 8, image_size=(32, 32), output_size=(8, 8))
os.makedirs(os.path.join(files, "scenes"))
rows, gt = [], []
for i, (img, box) in enumerate(scenes.items):
    write_png(os.path.join(files, "scenes", f"{i}.png"), img, filters=i % 5)
    rows.append("\t".join([f"scenes/{i}.png"] + [str(float(v)) for v in box]))
    gt.append({"image": f"scenes/{i}.png", "bounding_boxes": [box.tolist()]})
    assert np.array_equal(datasets.load_image(os.path.join(files, "scenes", f"{i}.png")), img)
open(os.path.join(files, "val.csv"), "w").write("\n".join(rows) + "\n")
open(os.path.join(files, "list.txt"), "w").write("".join(f"scenes/{i}.png\n" for i in range(4)))
json.dump(gt, open(os.path.join(files, "gt.json"), "w"))
assert len(datasets.LabeledImageDataset(crops_csv)) == 8
files_dir = loans_tpu_torch.cli.train_localizer.main([
    os.path.join(files, "list.txt"), crops_csv, os.path.join(files, "val.csv"), "--batch-size", "2",
    "--n-layers", "18", "--target-size", "32", "32", "--crop-size", "8", "8", "--iterations", "2",
    "--log-interval", "2", "--eval-batches", "1", "--num-workers", "2", "--device-data", "off",
    "--device", "cpu", "--log-dir", files])
assert "Localizer_2.pt" in os.listdir(files_dir)
with contextlib.redirect_stdout(io.StringIO()):
    swept = evaluate.main([os.path.join(files, "val.csv"), files_dir, "-b", "2", "--device", "cpu"])
assert [e["snapshot_name"] for e in swept.entries] == ["Localizer_2.pt"]
gt_dir = train_ssd.main([os.path.join(files, "gt.json"), os.path.join(files, "gt.json"), "-b", "1",
                         "--iterations", "1", "--log-interval", "1", "--eval-interval", "1", "--eval-batches", "1",
                         "--no-augment", "--device-data", "off", "--device", "cpu", "--log-dir", files])
assert "SSD300_1.pt" in os.listdir(gt_dir)
try:
    SSDTransform(ssd.model.coder(), 300, augment=True)(scenes.items[0][0], scenes.items[0][1][None])
except RuntimeError as e:
    assert "cv2" in str(e) and "--no-augment" in str(e), e
else:
    raise AssertionError("the augmenting SSD transform ran without cv2")
assert sample_separable_kernel.launches == 0 and not spawned, spawned
assert not [m for m, v in sys.modules.items()
            if v is not None and m.split(".")[0] in ("jax", "flax", "loans_tpu", "PIL", "cv2", "matplotlib")]

# the progress stream without Pillow: a frame from the port's client to its
# server, pixel for pixel; the plotter and the video CLI refused by name
import time
from loans_tpu_torch.insights.progress_server import ImageClient, ImageServer
from loans_tpu_torch.cli import video_inference
server = ImageServer("127.0.0.1", 0).start()
frame = np.random.default_rng(0).integers(0, 256, (9, 11, 3), dtype=np.uint8)
assert ImageClient("127.0.0.1", server.port).send(frame, title="no Pillow")
for _ in range(500):
    if server.count:
        break
    time.sleep(0.01)
server.stop()
assert server.count == 1 and np.array_equal(server.latest, frame)
for argv in (["--plot-interval", "2"], ["--plot-interval", "2", "--send-bboxes", "127.0.0.1:1"]):
    try:
        loans_tpu_torch.cli.train_localizer.main(["synthetic:4", "synthetic:4", "synthetic:4", "--device", "cpu",
                                                  "--log-dir", files] + argv)
    except SystemExit as e:
        assert "Pillow is not installed" in str(e), e
    else:
        raise AssertionError("the BBoxPlotter ran without Pillow")
try:
    video_inference.main([log_dir, "-i", "clip.avi", "--device", "cpu"])
except SystemExit as e:
    assert "OpenCV (cv2)" in str(e), e
else:
    raise AssertionError("the video CLI ran without cv2")
assert sample_separable_kernel.launches == 0 and not spawned, spawned
assert not [m for m, v in sys.modules.items()
            if v is not None and m.split(".")[0] in ("jax", "flax", "loans_tpu", "PIL", "cv2", "matplotlib",
                                                    "tkinter")]

# the offline tools without Pillow, cv2, matplotlib or tkinter: the dataset
# tools on PNGs and .pt snapshots, the refusals by name, the annotator's
# refusal, and the supervisor over a child that completes
from loans_tpu_torch.cli import annotate, dataset_tools, supervise
tools = tempfile.mkdtemp()
write_png(os.path.join(tools, "bg.png"), scenes.items[0][0])
write_png(os.path.join(tools, "stamp.png"), np.full((6, 5, 4), (200, 200, 200, 255), np.uint8))
json.dump([{"image": os.path.join(tools, "bg.png"), "bounding_boxes": [[2, 3, 12, 20]]}],
          open(os.path.join(tools, "ann.json"), "w"))
with contextlib.redirect_stdout(io.StringIO()):
    dataset_tools.main(["generate_scenes", os.path.join(tools, "ann.json"), os.path.join(tools, "gen"),
                        "--stamps", os.path.join(tools, "stamp.png"), "--per-background", "2"])
    dataset_tools.main(["paste_and_crop", os.path.join(tools, "pc"), "2", "--image-size", "32", "32",
                        "--output-size", "8", "8"])
    __import__("shutil").copy(os.path.join(log_dir, "Localizer_1.pt"), os.path.join(log_dir, "Localizer_2.pt"))
    dataset_tools.main(["average_snapshots", log_dir])
    dataset_tools.main(["strip_params", os.path.join(log_dir, "Localizer_swa.pt"), os.path.join(tools, "s.pt")])
    dataset_tools.main(["convert_snapshot", os.path.join(log_dir, "Localizer_2.pt"), os.path.join(tools, "c.pt")])
assert datasets.load_image(os.path.join(tools, "gen", "images", "1.png"))[5, 10].tolist() == [200, 200, 200]
assert "param_predictor.bias" not in torch.load(os.path.join(tools, "s.pt"), weights_only=True)
for argv, library in ((["plot_log", log_dir, "x.png"], "matplotlib"), (["label_histogram", "a.csv", "x.png"],
                      "matplotlib"), (["extract_frames", "a.avi", tools], "OpenCV (cv2)"),
                      (["blend_videos", "a.avi", "b.avi", "c.mp4"], "OpenCV (cv2)")):
    try:
        dataset_tools.main(argv)
    except SystemExit as e:
        assert f"needs {library}, which is not installed" in str(e), e
    else:
        raise AssertionError(f"{argv[0]} ran without {library}")
try:
    annotate.main(["view", os.path.join(tools, "ann.json")])
except SystemExit as e:
    assert "needs tkinter, which is not installed" in str(e), e
else:
    raise AssertionError("the annotator ran without tkinter")
assert not [m for m, v in sys.modules.items()
            if v is not None and m.split(".")[0] in ("jax", "flax", "loans_tpu", "PIL", "cv2", "matplotlib",
                                                    "tkinter")]
supervise.RESTART_PAUSE_S = 0.0
child = ("import json, os, sys; d = os.path.join(sys.argv[2], 'run'); os.makedirs(d); "
         "json.dump([{'iteration': 1}], open(os.path.join(d, 'log'), 'w'))")
with contextlib.redirect_stdout(io.StringIO()):
    assert supervise.main(["--poll-interval", "0.05", "--", sys.executable, "-c", child, "--log-dir",
                           os.path.join(tools, "logs")]) == 0

import shutil
shutil.rmtree(tools)
shutil.rmtree(out_dir)
shutil.rmtree(log_dir)
shutil.rmtree(ssd_root)
shutil.rmtree(files)
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


def _imports(paths, banned, module_level_only=False):
    """(file, module) of each import of a ``banned`` top-level package in
    ``paths``; with ``module_level_only``, only those outside functions."""
    offenders = []
    for path in paths:
        tree = ast.parse(path.read_text())
        in_functions = {id(n) for f in ast.walk(tree) if isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef))
                        for n in ast.walk(f)}
        for node in ast.walk(tree):
            if module_level_only and id(node) in in_functions:
                continue
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            offenders += [(path.relative_to(ROOT).as_posix(), n) for n in names if n.split(".")[0] in banned]
    return offenders


def test_port_sources_import_no_jax():
    """No module of the port, and not ``chip_smoke.py``, names jax, flax or
    loans_tpu in an import, even inside a function; none imports PIL, cv2
    or tkinter when it is imported. PIL is imported inside a function only
    by ``data/datasets.py`` (image formats other than PNG, where Pillow is
    installed), ``insights/rendering.py`` (text in Pillow's font) and
    ``insights/media.py`` (GIF encoding); tkinter only by
    ``insights/progress_server.py`` (the viewer's window) and
    ``cli/annotate.py`` (the annotator's windows)."""
    sources = [*PACKAGE.rglob("*.py"), ROOT / "chip_smoke.py"]
    assert not _imports(sources, ("jax", "jaxlib", "flax", "optax", "loans_tpu"))
    assert not _imports(sources, ("PIL", "cv2", "tkinter"), module_level_only=True)
    pil = {f for f, _ in _imports(sources, ("PIL",))}
    assert pil <= {"loans_tpu_torch/data/datasets.py", "loans_tpu_torch/insights/rendering.py",
                   "loans_tpu_torch/insights/media.py"}, pil
    assert {f for f, _ in _imports(sources, ("tkinter",))} == {"loans_tpu_torch/insights/progress_server.py",
                                                              "loans_tpu_torch/cli/annotate.py"}


def test_training_cli_path_imports_no_cv2():
    """The training CLIs' path (their data, evaluation, training and model
    modules, and ``chip_smoke.py``) names no cv2 but in
    ``data/augment.py::require_cv2``, which the host augmentations of
    ``data/augment.py`` and ``data/ssd_augment.py`` call when they run, and
    in the functions of ``chip_smoke.py``'s phase 21 that write and count
    the video clip (run only where cv2 is installed); only the image, video
    and live CLIs and the serving helpers that draw or resize frames use it
    otherwise."""
    paths = [PACKAGE / "cli" / "train_localizer.py", PACKAGE / "cli" / "train_ssd.py", ROOT / "chip_smoke.py"]
    for sub in ("data", "evaluation", "train", "models", "ops"):
        paths += list((PACKAGE / sub).rglob("*.py"))
    assert sorted(set(_imports(paths, ("cv2",)))) == [("chip_smoke.py", "cv2"), ("loans_tpu_torch/data/augment.py", "cv2")]
    assert not _imports(paths, ("cv2",), module_level_only=True)


def test_evaluation_path_imports_no_cv2_or_matplotlib():
    """The evaluation CLI's and the bench's path (the loader, deteval, the
    sweep, VisualBackprop, the renders, the BBoxPlotter and the progress
    stream) and ``chip_smoke.py`` name neither cv2 nor matplotlib in an
    import (``Evaluator.plot`` loads matplotlib by name where it is
    installed), nor jax, flax or loans_tpu; but ``insights/media.py``, whose
    ``make_video`` writes with cv2 when it runs. PIL only inside
    ``insights/rendering.py::draw_text`` (score text) and the GIF encoder
    of ``insights/media.py``."""
    paths = [PACKAGE / "cli" / "evaluate.py", PACKAGE / "bench.py", PACKAGE / "data" / "loader.py",
             ROOT / "chip_smoke.py"]
    for sub in ("evaluation", "insights", "models"):
        paths += list((PACKAGE / sub).rglob("*.py"))
    assert not _imports(paths, ("matplotlib", "jax", "jaxlib", "flax", "optax", "loans_tpu"))
    assert sorted(set(_imports(paths, ("cv2",)))) == [("chip_smoke.py", "cv2"), ("loans_tpu_torch/insights/media.py", "cv2")]
    assert sorted(_imports(paths, ("PIL",))) == [("loans_tpu_torch/insights/media.py", "PIL"),
                                                ("loans_tpu_torch/insights/rendering.py", "PIL")]


PARALLEL_SCRIPT = r"""
import os, subprocess, sys
spawned = []
_Popen = subprocess.Popen
class _Spy(_Popen):
    def __init__(self, args, *a, **k):
        spawned.append(args)
        super().__init__(args, *a, **k)
subprocess.Popen = _Spy
for name in ("jax", "jaxlib", "flax", "optax", "loans_tpu", "PIL", "cv2", "matplotlib", "triton"):
    sys.modules[name] = None  # any import of them raises ImportError
os.environ.pop("WORLD_SIZE", None)
from loans_tpu_torch import parallel
import loans_tpu_torch.parallel.dryrun
from loans_tpu_torch.ops import _cuda
assert _cuda.load_library.cache_info().currsize == 0
assert not spawned, spawned
assert not parallel.init_distributed()  # no torchrun environment: one process
assert (parallel.rank(), parallel.world_size(), parallel.local_batch_slice(8)) == (0, 1, (0, 8))
print("PARALLEL_NO_JAX_OK")
"""


def test_parallel_imports_without_jax_or_toolchains():
    """``loans_tpu_torch.parallel`` and its dry run import without jax,
    flax, ``loans_tpu``, Triton, Pillow, cv2 or matplotlib and run no
    ``nvcc``; without ``torchrun``'s environment it is one process."""
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.run([sys.executable, "-c", PARALLEL_SCRIPT], cwd=str(ROOT), env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "PARALLEL_NO_JAX_OK" in proc.stdout
    assert not _imports(list((PACKAGE / "parallel").rglob("*.py")),
                        ("jax", "jaxlib", "flax", "optax", "loans_tpu", "PIL", "cv2", "matplotlib", "triton"))


WEIGHT_TOOLS_SCRIPT = r"""
import os, subprocess, sys, tempfile
spawned = []
_Popen = subprocess.Popen
class _Spy(_Popen):
    def __init__(self, args, *a, **k):
        spawned.append(args)
        super().__init__(args, *a, **k)
subprocess.Popen = _Spy
for name in ("jax", "jaxlib", "flax", "optax", "msgpack", "loans_tpu", "PIL", "cv2", "matplotlib", "triton"):
    sys.modules[name] = None  # any import of them raises ImportError
import torch
from loans_tpu_torch.cli import import_resnet50, import_vgg16, pretrain_backbone
from loans_tpu_torch.ops import _cuda
assert _cuda.load_library.cache_info().currsize == 0
work = tempfile.mkdtemp()
result = pretrain_backbone.main(["--out", os.path.join(work, "b.pth"), "--classes", "2", "--pool", "4",
                                 "--val-pool", "2", "--iterations", "1", "--batch-size", "2", "--steps-per-call", "1",
                                 "--log-interval", "1", "--image-size", "32", "--device", "cpu"])
assert result["tensors"] == 318 and len(result["log"]) == 1
import_resnet50.main([result["out"], os.path.join(work, "b.pt"), "--verify", "--device", "cpu"])
assert import_vgg16.FEATURE_CONVS[-1] == 28
assert not spawned, spawned
assert not [m for m, v in sys.modules.items() if v is not None and m.split(".")[0] in
            ("jax", "flax", "optax", "msgpack", "loans_tpu", "PIL", "cv2", "matplotlib", "triton")]
import shutil
shutil.rmtree(work)
print("WEIGHT_TOOLS_NO_JAX_OK")
"""


def test_weight_tools_run_without_jax_or_toolchains():
    """The pretraining CLI and the two importers import without jax, flax,
    optax, msgpack, ``loans_tpu``, Pillow, cv2, matplotlib or Triton and
    run no ``nvcc``: one pretraining iteration at 32² on the CPU, its
    export imported and verified."""
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.run([sys.executable, "-c", WEIGHT_TOOLS_SCRIPT], cwd=str(ROOT), env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "WEIGHT_TOOLS_NO_JAX_OK" in proc.stdout
    tools = [PACKAGE / "cli" / f"{name}.py" for name in ("pretrain_backbone", "import_resnet50", "import_vgg16")]
    assert not _imports(tools, ("jax", "jaxlib", "flax", "optax", "msgpack", "loans_tpu", "PIL", "cv2",
                                "matplotlib", "triton"))


WARM_CACHE_SCRIPT = r"""
import os, runpy, subprocess, sys, tempfile
spawned = []
_Popen = subprocess.Popen
class _Spy(_Popen):
    def __init__(self, args, *a, **k):
        spawned.append(args)
        super().__init__(args, *a, **k)
subprocess.Popen = _Spy
for name in ("jax", "jaxlib", "flax", "optax", "msgpack", "loans_tpu", "PIL", "cv2", "matplotlib", "triton"):
    sys.modules[name] = None  # any import of them raises ImportError
work = tempfile.mkdtemp()
sys.argv = ["warm_cache", "synthetic:4", "synthetic:8", "synthetic:4", "--target-size", "32", "32", "--crop-size",
            "8", "8", "--assessor-pipeline", "stn", "--synthetic-cache", work, "--device", "cpu"]
runpy.run_module("loans_tpu_torch.cli.warm_cache", run_name="__main__")
from loans_tpu_torch.ops import _cuda
assert _cuda.load_library.cache_info().currsize == 0
assert len(os.listdir(work)) == 3 and all(n.endswith(".npz") for n in os.listdir(work)), os.listdir(work)
assert not spawned, spawned
assert not [m for m, v in sys.modules.items() if v is not None and m.split(".")[0] in
            ("jax", "flax", "optax", "msgpack", "loans_tpu", "PIL", "cv2", "matplotlib", "triton")]
import shutil
shutil.rmtree(work)
print("WARM_CACHE_NO_JAX_OK")
"""


def test_warm_cache_runs_without_jax_or_toolchains():
    """``python -m loans_tpu_torch.cli.warm_cache ... --device cpu`` with
    ``stn`` crops (K1's plain version) fills a cache without jax, flax,
    optax, msgpack, ``loans_tpu``, Pillow, cv2, matplotlib or Triton, and
    runs no ``nvcc``."""
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.run([sys.executable, "-c", WARM_CACHE_SCRIPT], cwd=str(ROOT), env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "WARM_CACHE_NO_JAX_OK" in proc.stdout and "warmed cache in " in proc.stdout
    assert not _imports([PACKAGE / "cli" / "warm_cache.py"], ("jax", "jaxlib", "flax", "optax", "msgpack",
                                                               "loans_tpu", "PIL", "cv2", "matplotlib", "triton"))
