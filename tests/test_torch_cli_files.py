"""The training and evaluation CLIs on image files, the JAX package's and
the port's, on the CPU.

The files are written in a temporary directory by Pillow (adaptive row
filters) from the JAX package's synthetic scenes, at sizes other than the
CLI's 32² so that every image is resized, and by the JAX package's
``generate_dataset`` (IoU-labeled crops): an image list, a labeled csv of
crops, labeled csv and gt json files of scenes with their boxes.

* The localizer CLIs (R-18 32²→8², as ``test_torch_cli_train.py`` sizes
  them: batch 8, 4 iterations, a log entry every 2 with mAP on one val
  batch) with ``--device-data off`` (the host loader: ``DataLoader`` and
  the device prefetch) on the same files and the same initial weights
  (JAX's ``Module.init`` loaded through the bridge, in the test only):
  the manifests agree but for the log dir's path and ``device``; the
  first entry's losses agree to 1e-5 relative, its mean IoU to 1e-3 and
  its mAP exactly, for the same reasons as on synthetic data
  (``test_torch_cli_train.py``); weak and ``--supervised``, and the same
  with ``--device-data on`` (the files materialized into pools, calls of
  2 steps).
* With ``--device-data on`` the files are materialized into device pools:
  the first batch of either mode holds, row for row, the dataset's
  examples at the indices of that mode's index stream, in float32 equal
  bit for bit (the same ``/ 255`` of the same pixels).
* ``cli.evaluate`` on a labeled csv and on a gt json sweeps the JAX run's
  snapshots (bridged to ``.pt``) to JAX's metrics (``test_torch_evaluate.py``'s
  tolerances).
* The SSD CLI trains on a gt json with the host loader and ``--no-augment``
  (SSD300, batch 2, 2 steps), its val adapter giving JAX's images and boxes.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_cli_train import jax_initial_states
from test_torch_evaluate import _assert_entries_match, _copy, add_port_snapshots

from loans_tpu.cli import evaluate as jevaluate
from loans_tpu.cli import train_localizer as jcli
from loans_tpu.cli import train_ssd as jssd_cli
from loans_tpu.data import synthetic as jsyn
from loans_tpu.models import ssd as jssd
from loans_tpu_torch.cli import evaluate
from loans_tpu_torch.cli import train_localizer as cli
from loans_tpu_torch.cli import train_ssd
from loans_tpu_torch.data.datasets import ImageDataset, LabeledImageDataset, read_labeled_csv
from loans_tpu_torch.train import MetricsLog, checkpoint

ARGS = [
    "--batch-size", "8", "--n-layers", "18", "--target-size", "32", "32", "--crop-size", "8", "8",
    "--iterations", "4", "--log-interval", "2", "--eval-batches", "1", "--num-workers", "2",
]


@pytest.fixture(autouse=True)
def pinned(monkeypatch):
    monkeypatch.setattr(os, "cpu_count", lambda: 8)
    monkeypatch.setattr(cli, "build_states", jax_initial_states)
    torch.set_num_threads(min(4, torch.get_num_threads()))


def _write_scenes(root, name, n, size, seed):
    """Labeled scenes as Pillow PNGs; (relative paths, boxes)."""
    scenes = jsyn.SyntheticLocalizerDataset(n, image_size=size, seed=seed, labeled=True, output_dtype="uint8")
    os.makedirs(root / name)
    paths, boxes = [], []
    for i, (img, box) in enumerate(scenes.items):
        paths.append(f"{name}/{i}.png")
        Image.fromarray(img).save(root / paths[-1])
        boxes.append([float(v) for v in box])
    return paths, boxes


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("files")
    train, train_boxes = _write_scenes(root, "train", 16, (40, 36), 0)
    val, val_boxes = _write_scenes(root, "val", 8, (36, 44), 2)
    (root / "train.txt").write_text("".join(p + "\n" for p in train))
    (root / "train.json").write_text(json.dumps([{"image": p, "bounding_boxes": [b]}
                                                 for p, b in zip(train, train_boxes)]))
    (root / "val.csv").write_text("".join("\t".join([p] + [str(v) for v in b]) + "\n" for p, b in zip(val, val_boxes)))
    (root / "val.json").write_text(json.dumps([{"image": p, "bounding_boxes": [b]} for p, b in zip(val, val_boxes)]))
    crops = jsyn.generate_dataset(str(root / "crops"), 16, image_size=(40, 40), output_size=(10, 10), seed=1)
    return {"root": root, "train": str(root / "train.txt"), "train_json": str(root / "train.json"),
            "crops": crops, "val_csv": str(root / "val.csv"), "val_json": str(root / "val.json")}


def _argv(files, mode):
    if mode == "supervised":
        return [files["train_json"], files["crops"], files["val_csv"], "--supervised"] + ARGS
    return [files["train"], files["crops"], files["val_csv"]] + ARGS


@pytest.fixture(scope="module")
def runs(files, tmp_path_factory):
    """The weak CLIs of both packages on the files, with the host loader."""
    tmp = tmp_path_factory.mktemp("runs")
    argv = _argv(files, "alternating") + ["--device-data", "off", "--snapshot-interval", "2"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(os, "cpu_count", lambda: 8)
        mp.setattr(cli, "build_states", jax_initial_states)
        jdir = jcli.main(argv + ["--log-dir", str(tmp / "jax")])
        pdir = cli.main(argv + ["--log-dir", str(tmp / "port"), "--device", "cpu"])
    return jdir, pdir


def _assert_logs_match(jdir, pdir, mode):
    jman, pman = checkpoint.load_manifest(jdir), checkpoint.load_manifest(pdir)
    for man in (jman, pman):
        man["config"].pop("log_dir")
    assert pman["config"].pop("device") == "cpu"
    assert json.loads(json.dumps(jman)) == pman
    jlog, plog = MetricsLog.read(jdir), MetricsLog.read(pdir)
    assert len(jlog) == len(plog) == 2
    for a, b in zip(jlog, plog):
        assert set(b) - {"device"} == set(a)
    losses = ["loss_localizer", "loss/box", "loss/iou"] if mode == "supervised" else ["loss_localizer", "loss_dis"]
    for k in losses:
        np.testing.assert_allclose(plog[0][k], jlog[0][k], rtol=1e-5, err_msg=k)
    assert abs(plog[0]["mean_iou"] - jlog[0]["mean_iou"]) <= 1e-3
    assert plog[0]["map"] == jlog[0]["map"]
    assert all(np.isfinite(e[k]) for e in plog for k in losses + ["mean_iou", "map", "images_per_sec"])
    assert "Localizer_4.pt" in os.listdir(pdir)


def test_weak_cli_on_files_matches_jax(runs):
    _assert_logs_match(*runs, "alternating")


@pytest.mark.parametrize("mode,device_data", [("supervised", "off"), ("alternating", "on"), ("supervised", "on")])
def test_cli_on_files_matches_jax(files, tmp_path, mode, device_data):
    """The other three of weak/supervised x host loader/device pools (the
    pools in calls of 2 steps in both packages)."""
    argv = _argv(files, mode) + ["--device-data", device_data]
    if device_data == "on":
        argv += ["--steps-per-call", "2"]
    jdir = jcli.main(argv + ["--log-dir", str(tmp_path / "jax")])
    pdir = cli.main(argv + ["--log-dir", str(tmp_path / "port"), "--device", "cpu"])
    _assert_logs_match(jdir, pdir, mode)
    shutil.rmtree(tmp_path)  # R-18 snapshots with optimizer state: ~0.2 GB each


def test_device_data_on_with_files_feeds_the_off_batches(files, tmp_path, monkeypatch):
    """The first batch the step sees, with the host loader and with device
    pools: the datasets' examples at each mode's indices, bit for bit."""
    import loans_tpu_torch.train as train

    seen = {}
    step = train.alternating_step

    def capture(loc_state, ass_state, batch, generator=None, config=None):
        seen.setdefault(mode, {k: v.clone() for k, v in batch.items()})
        return step(loc_state, ass_state, batch, generator, config)

    monkeypatch.setattr(train, "alternating_step", capture)
    for mode, extra in (("off", ["--device-data", "off"]), ("on", ["--device-data", "on", "--steps-per-call", "2"])):
        cli.main(_argv(files, "alternating") + extra + ["--iterations", "2", "--log-dir", str(tmp_path / mode),
                                                         "--device", "cpu"])
    scenes = ImageDataset(files["train"], image_size=(32, 32))
    crops = LabeledImageDataset(read_labeled_csv(files["crops"]), image_size=(8, 8))
    order = {  # DataLoader: default_rng((seed, epoch)); pools: default_rng(seed + group) (unlabeled 0, reference 1)
        "off": {"unlabeled": np.random.default_rng((0, 0)).permutation(16)[:8],
                "real": np.random.default_rng((0, 0)).permutation(16)[:8]},
        "on": {"unlabeled": np.random.default_rng(0).permutation(16)[:8],
               "real": np.random.default_rng(1).permutation(16)[:8]},
    }
    for mode in ("off", "on"):
        batch = seen[mode]
        assert batch["unlabeled"].dtype == batch["real"].dtype == torch.float32
        want_scenes = np.stack([scenes[i] for i in order[mode]["unlabeled"]])
        want_crops = np.stack([crops[i][0] for i in order[mode]["real"]])
        want_labels = np.stack([crops[i][1] for i in order[mode]["real"]])
        np.testing.assert_array_equal(batch["unlabeled"].numpy(), want_scenes)
        np.testing.assert_array_equal(batch["real"].numpy(), want_crops)
        np.testing.assert_array_equal(batch["labels"].numpy(), want_labels)
    assert not np.array_equal(order["off"]["real"], order["on"]["real"])  # two index streams
    shutil.rmtree(tmp_path)


@pytest.mark.parametrize("gt", ["val_csv", "val_json"])
def test_evaluate_on_files_matches_jax(files, runs, tmp_path, gt):
    jdir = _copy(runs[0], tmp_path / "run")
    add_port_snapshots(jdir)
    want_dir, got_dir = _copy(jdir, tmp_path / "jax"), _copy(jdir, tmp_path / "port")
    want = jevaluate.main([files[gt], want_dir, "-b", "4", "-a", "--iou-threshold", "0.02"])
    got = evaluate.main([files[gt], got_dir, "-b", "4", "-a", "--iou-threshold", "0.02", "--device", "cpu"])
    _assert_entries_match(got.entries, want.entries)
    assert [e["iteration"] for e in got.entries] == [2, 4]
    shutil.rmtree(tmp_path)


def test_train_ssd_on_a_gt_json(files, tmp_path):
    coder = jssd.SSD300().coder()
    got_val, want_val = train_ssd.ValAdapter(files["val_json"], 300), jssd_cli._ValAdapter(files["val_json"], 300)
    assert len(got_val) == len(want_val) == 8
    for i in range(3):
        for g, w in zip(got_val.get_example(i), want_val.get_example(i)):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    log_dir = train_ssd.main([
        files["train_json"], files["val_json"], "-b", "2", "--iterations", "2", "--log-interval", "1",
        "--eval-interval", "2", "--eval-batches", "1", "--no-augment", "--num-workers", "2", "--device-data", "off",
        "--device", "cpu", "--log-dir", str(tmp_path),
    ])
    log = MetricsLog.read(log_dir)
    assert [e["iteration"] for e in log] == [1, 2] and "map" in log[1]
    assert all(np.isfinite(e[k]) for e in log for k in ("loss", "loss/loc", "loss/conf"))
    assert {"SSD300_2.pt", "manifest.json", "log"} <= set(os.listdir(log_dir))
    assert len(coder.default_bbox) == 8732
    shutil.rmtree(tmp_path)
