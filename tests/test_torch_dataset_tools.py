"""The port's dataset tools (``loans_tpu_torch/cli/dataset_tools.py``)
against the JAX package's CLI (``loans_tpu/cli/dataset_tools.py``) on the
same inputs, made with numpy from a seed:

* ``paste_and_crop`` and ``generate_scenes``: pixel-equal PNGs and equal
  csv and JSON (stamps with partial alpha pasted through their own mask,
  float boxes truncated, a box of no width skipped after its draw);
* ``filter_single``: equal JSON;
* ``extract_frames`` (cv2 decode, LANCZOS resize) and ``blend_videos``:
  pixel-equal on a small clip that cv2 writes;
* ``convert_snapshot``, ``strip_params`` and ``average_snapshots``: JAX's
  output on ``.msgpack`` snapshots of an R-18 localizer (BatchNorm
  statistics included), mapped through the bridge, equals the port's
  output on the bridged ``.pt`` snapshots bit for bit; the SWA file loads
  through ``restore_state`` and stays outside ``list_snapshots``;
* ``label_histogram`` and ``plot_log`` write their PNGs, and are refused
  by name without matplotlib; the cv2 subcommands without cv2;
* ``image_ops.paste`` with a mask against Pillow's ``paste(im, box,
  mask)`` (hypothesis over sizes, offsets and alpha values).
"""

import csv
import json
import os
import shutil
import sys
import types

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from test_torch_models import random_variables  # noqa: E402

from loans_tpu import models as jmodels
from loans_tpu.cli import dataset_tools as jax_tools
from loans_tpu.ops.geometry import Size as JSize
from loans_tpu.train import adam_amsgrad
from loans_tpu.train import checkpoint as jax_checkpoint
from loans_tpu.train.logger import MetricsLog as JaxLog
from loans_tpu_torch import bridge
from loans_tpu_torch.cli import dataset_tools
from loans_tpu_torch.data import image_ops
from loans_tpu_torch.data.png import read_png
from loans_tpu_torch.models import Localizer
from loans_tpu_torch.ops import Size
from loans_tpu_torch.train import checkpoint, create_train_state
from loans_tpu_torch.train.logger import MetricsLog


def pixels(path):
    return np.asarray(Image.open(path))


def assert_same_tree(port_dir, jax_dir):
    """The same files under both dirs: PNGs pixel-equal, others equal."""
    names = sorted(os.path.relpath(os.path.join(d, f), port_dir) for d, _, fs in os.walk(port_dir) for f in fs)
    assert names == sorted(os.path.relpath(os.path.join(d, f), jax_dir) for d, _, fs in os.walk(jax_dir) for f in fs)
    for name in names:
        got, want = os.path.join(port_dir, name), os.path.join(jax_dir, name)
        if name.endswith(".png"):
            assert np.array_equal(pixels(got), pixels(want)), name
        else:
            assert open(got).read() == open(want).read(), name


def test_paste_and_crop_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(os, "cpu_count", lambda: 8)  # the synthetic data depend on it
    argv = ["6", "--image-size", "48", "40", "--output-size", "12", "10", "--seed", "3", "--low-iou", "0.3"]
    dataset_tools.main(["paste_and_crop", str(tmp_path / "port")] + argv)
    jax_tools.main(["paste_and_crop", str(tmp_path / "jax")] + argv)
    assert_same_tree(tmp_path / "port", tmp_path / "jax")
    assert len(list(csv.reader(open(tmp_path / "port" / "images.csv"), delimiter="\t"))) == 6


def test_generate_scenes_matches_jax(tmp_path):
    rng = np.random.default_rng(5)
    stamps = []
    for i, (h, w) in enumerate(((9, 13), (17, 6))):
        rgba = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
        rgba[..., 3] = rng.choice([0, 255, 90, 200], size=(h, w))
        stamps.append(str(tmp_path / f"stamp{i}.png"))
        Image.fromarray(rgba, "RGBA").save(stamps[-1])
    ann = []
    for i in range(2):
        path = str(tmp_path / f"bg{i}.png")
        Image.fromarray(rng.integers(0, 256, (40, 56, 3), dtype=np.uint8)).save(path)
        ann.append({"image": path, "bounding_boxes": [
            [3.7, 4.2, 20.9, 30.5], [10, 12, 10, 30], [25, 40.6, 39.2, 55.9], [30, 50, 45, 70]]})
    ann.append({"image": path})
    with open(tmp_path / "ann.json", "w") as f:
        json.dump(ann, f)
    argv = [str(tmp_path / "ann.json"), "--stamps", *stamps, "--per-background", "3", "--test-fraction", "0.25",
            "--seed", "7"]
    dataset_tools.main(["generate_scenes", argv[0], str(tmp_path / "port"), *argv[1:]])
    jax_tools.main(["generate_scenes", argv[0], str(tmp_path / "jax"), *argv[1:]])
    assert_same_tree(tmp_path / "port", tmp_path / "jax")
    train = json.load(open(tmp_path / "port" / "train_info.json"))
    assert len(train) == 6 and len(train[0]["bounding_boxes"]) in (0, 3)


def test_filter_single_matches_jax(tmp_path):
    gt = [{"image": f"{i}.png", "bounding_boxes": [[0, 0, 1, 1]] * (i % 3)} for i in range(7)] + [{"image": "x.png"}]
    with open(tmp_path / "gt.json", "w") as f:
        json.dump(gt, f)
    dataset_tools.main(["filter_single", str(tmp_path / "gt.json"), str(tmp_path / "port.json")])
    jax_tools.main(["filter_single", str(tmp_path / "gt.json"), str(tmp_path / "jax.json")])
    assert open(tmp_path / "port.json").read() == open(tmp_path / "jax.json").read()
    assert len(json.load(open(tmp_path / "port.json"))) == 2


def write_clip(path, n, seed, size=(40, 30)):
    rng = np.random.default_rng(seed)
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 10.0, size)
    for _ in range(n):
        writer.write(rng.integers(0, 256, (size[1], size[0], 3), dtype=np.uint8))
    writer.release()
    return str(path)


def decoded(path):
    cap, frames = cv2.VideoCapture(str(path)), []
    while True:
        ok, frame = cap.read()
        if not ok:
            return np.stack(frames)
        frames.append(frame)


def test_extract_frames_and_blend_videos_match_jax(tmp_path):
    a, b = write_clip(tmp_path / "a.avi", 4, 0), write_clip(tmp_path / "b.avi", 4, 1)
    for resize in ("0", "24", "52"):
        dataset_tools.main(["extract_frames", a, str(tmp_path / f"port{resize}"), "--resize", resize])
        jax_tools.main(["extract_frames", a, str(tmp_path / f"jax{resize}"), "--resize", resize])
        assert_same_tree(tmp_path / f"port{resize}", tmp_path / f"jax{resize}")
    assert pixels(tmp_path / "port24" / "000003.png").shape == (18, 24, 3)
    assert len(open(tmp_path / "port0" / "gt.csv").read().split()) == 4
    dataset_tools.main(["blend_videos", a, b, str(tmp_path / "port.mp4"), "--alpha", "0.3"])
    jax_tools.main(["blend_videos", a, b, str(tmp_path / "jax.mp4"), "--alpha", "0.3"])
    got, want = decoded(tmp_path / "port.mp4"), decoded(tmp_path / "jax.mp4")
    assert got.shape == (4, 30, 40, 3) and np.array_equal(got, want)


LOC_KW = {"out_size": (8, 8), "n_layers": 18, "input_size": (32, 32)}


@pytest.fixture(scope="module")
def snapshots(tmp_path_factory):
    """Three JAX training snapshots (iterations 10, 20, 30) of an R-18
    localizer with seeded weights and statistics, and the same as port
    training snapshots through the bridge, each with its own optimizer
    learning rate."""
    root = tmp_path_factory.mktemp("snapshots")
    jloc = jmodels.Localizer(**{k: JSize(*v) if isinstance(v, tuple) else v for k, v in LOC_KW.items()})
    port = Localizer(**{k: Size(*v) if isinstance(v, tuple) else v for k, v in LOC_KW.items()})
    for it in (10, 20, 30):
        v = random_variables(jloc, jnp.zeros((1, 32, 32, 3)), seed=it, train=False)
        state = types.SimpleNamespace(step=np.int32(it), params=v["params"], batch_stats=v["batch_stats"],
                                      opt_state=adam_amsgrad(1e-3).init(v["params"]))
        jax_checkpoint.save_state(str(root / "jax" / f"Localizer_{it}.msgpack"), state)
        port.load_state_dict(bridge.to_state_dict(port, v["params"], v["batch_stats"]))
        ts = create_train_state(port, learning_rate=it * 1e-5)
        ts.step = it
        checkpoint.save_state(str(root / "port" / f"Localizer_{it}.pt"), ts)
    yield root, port
    shutil.rmtree(root)  # ~1 GB of snapshots


@pytest.fixture
def out_dir(tmp_path):
    """``tmp_path``, emptied after the test: the outputs are snapshots."""
    yield tmp_path
    shutil.rmtree(tmp_path)


def bridged(model, path):
    """A JAX ``.msgpack`` output and its leaves under the port's keys
    (``bridge.torch_leaves``: a stripped file is no complete model; where
    it is one, ``bridge.to_state_dict`` agrees)."""
    with open(path, "rb") as f:
        raw = serialization.msgpack_restore(f.read())
    leaves = {k: torch.tensor(v)
              for k, v in bridge.torch_leaves(raw["params"], raw["batch_stats"]).items()}
    if len(leaves) == len([k for k in model.state_dict() if not k.endswith("num_batches_tracked")]):
        strict = bridge.to_state_dict(model, raw["params"], raw["batch_stats"])
        assert all(torch.equal(strict[k], leaves[k]) for k in leaves)
    return raw, leaves


def assert_params_equal(got: dict, want: dict):
    got = {k: v for k, v in got.items() if not k.endswith("num_batches_tracked")}
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def test_convert_snapshot_matches_jax(snapshots, out_dir):
    root, model = snapshots
    jax_tools.main(["convert_snapshot", str(root / "jax" / "Localizer_20.msgpack"), str(out_dir / "j.msgpack")])
    dataset_tools.main(["convert_snapshot", str(root / "port" / "Localizer_20.pt"), str(out_dir / "p.pt")])
    raw, want = bridged(model, out_dir / "j.msgpack")
    assert set(raw) == {"params", "batch_stats"}
    got = torch.load(out_dir / "p.pt", weights_only=True)
    assert_params_equal(got, want)
    assert got.keys() == model.state_dict().keys()  # a model-only file the server loads
    assert checkpoint.load_params(str(out_dir / "p.pt")).keys() == got.keys()


@pytest.mark.parametrize("prefixes", [[], ["feature_extractor/Conv_0", "param_predictor"]])
def test_strip_params_matches_jax(snapshots, out_dir, prefixes):
    root, model = snapshots
    flags = ["--prefixes", *prefixes] if prefixes else []
    jax_tools.main(["strip_params", str(root / "jax" / "Localizer_10.msgpack"), str(out_dir / "j.msgpack")] + flags)
    dataset_tools.main(["strip_params", str(root / "port" / "Localizer_10.pt"), str(out_dir / "p.pt")] + flags)
    raw, want = bridged(model, out_dir / "j.msgpack")
    got = torch.load(out_dir / "p.pt", weights_only=True)
    assert_params_equal(got["params"], want)
    stripped = {"param_predictor.weight", "param_predictor.bias"} | (
        {"feature_extractor.Conv_0.weight"} if prefixes else set())
    assert stripped.isdisjoint(got["params"]) and len(got["params"]) == len(model.state_dict()) - len(stripped)
    source = torch.load(root / "port" / "Localizer_10.pt", weights_only=True)
    assert got["step"] == source["step"] == int(raw["step"]) == 10
    assert got["optimizer"]["param_groups"] == source["optimizer"]["param_groups"]


def test_average_snapshots_matches_jax(snapshots, out_dir, capsys):
    root, model = snapshots
    for package in ("jax", "port"):
        os.symlink(root / package, out_dir / package)
    argv = ["--min-iteration", "15", "--output"]
    jax_tools.main(["average_snapshots", str(out_dir / "jax")] + argv + [str(out_dir / "swa.msgpack")])
    dataset_tools.main(["average_snapshots", str(out_dir / "port")] + argv + [str(out_dir / "swa.pt")])
    assert capsys.readouterr().out.count("wrote SWA of 2 snapshots (20..30)") == 2
    raw, want = bridged(model, out_dir / "swa.msgpack")
    got = torch.load(out_dir / "swa.pt", weights_only=True)
    assert_params_equal(got["params"], want)
    last = torch.load(root / "port" / "Localizer_30.pt", weights_only=True)
    assert got["step"] == int(raw["step"]) == 30
    assert got["optimizer"]["param_groups"] == last["optimizer"]["param_groups"]
    key = "feature_extractor.BatchNorm_0.running_var"  # statistics average with the weights
    mean = torch.stack([torch.load(root / "port" / f"Localizer_{i}.pt", weights_only=True)["params"][key]
                        for i in (20, 30)]).double().mean(0).float()
    assert torch.equal(got["params"][key], mean) and not torch.equal(mean, last["params"][key])
    assert torch.equal(got["params"]["feature_extractor.BatchNorm_0.num_batches_tracked"],
                       last["params"]["feature_extractor.BatchNorm_0.num_batches_tracked"])


def test_swa_file_names_and_restore_state(snapshots, out_dir):
    root, model = snapshots
    log_dir = out_dir / "log"
    log_dir.mkdir()
    for it in (10, 20, 30):
        os.symlink(root / "port" / f"Localizer_{it}.pt", log_dir / f"Localizer_{it}.pt")
    dataset_tools.main(["average_snapshots", str(log_dir)])
    assert (log_dir / "Localizer_swa.pt").exists()
    assert [it for it, _ in checkpoint.list_snapshots(str(log_dir), "Localizer_")] == [10, 20, 30]
    dataset_tools.main(["average_snapshots", str(log_dir), "--out-iteration", "40", "--max-iteration", "20"])
    assert [it for it, _ in checkpoint.list_snapshots(str(log_dir), "Localizer_")] == [10, 20, 30, 40]
    state = create_train_state(Localizer(out_size=Size(8, 8), n_layers=18, input_size=Size(32, 32)))
    checkpoint.restore_state(str(log_dir / "Localizer_40.pt"), state)
    assert state.step == 20 and state.learning_rate == pytest.approx(20 * 1e-5)
    with pytest.raises(SystemExit, match="need >=2 snapshots"):
        dataset_tools.main(["average_snapshots", str(log_dir), "--min-iteration", "35"])


def test_plots_and_refusals(tmp_path, monkeypatch):
    log = MetricsLog(str(tmp_path), config={"x": 1})
    jlog = JaxLog(str(tmp_path / "jax"), config={"x": 1})
    for i in (10, 20, 30):
        for m in (log, jlog):
            m.append({"iteration": i, "loss": 1.0 / i, "map": i / 40})
    with open(tmp_path / "labels.csv", "w") as f:
        f.writelines(f"{i}.png\t{i / 10}\n" for i in range(10))
    dataset_tools.main(["plot_log", str(tmp_path), str(tmp_path / "curves.png")])
    jax_tools.main(["plot_log", str(tmp_path / "jax"), str(tmp_path / "jax_curves.png")])
    assert read_png(str(tmp_path / "curves.png")).shape == read_png(str(tmp_path / "jax_curves.png")).shape
    dataset_tools.main(["label_histogram", str(tmp_path / "labels.csv"), str(tmp_path / "hist.png")])
    assert read_png(str(tmp_path / "hist.png")).ndim == 3
    for name in ("matplotlib", "matplotlib.pyplot", "cv2"):
        monkeypatch.setitem(sys.modules, name, None)
    for argv, library in ((["plot_log", str(tmp_path), "x.png"], "matplotlib"),
                          (["label_histogram", str(tmp_path / "labels.csv"), "x.png"], "matplotlib"),
                          (["extract_frames", "clip.avi", str(tmp_path / "f")], "OpenCV (cv2)"),
                          (["blend_videos", "a.avi", "b.avi", "c.mp4"], "OpenCV (cv2)")):
        with pytest.raises(SystemExit, match=rf"^{argv[0]}.* needs {library.replace('(', '.').replace(')', '.')}, "
                                             "which is not installed"):
            dataset_tools.main(argv)


@settings(max_examples=60, deadline=None)
@given(
    dst_hw=st.tuples(st.integers(1, 12), st.integers(1, 12)),
    src_hw=st.tuples(st.integers(1, 12), st.integers(1, 12)),
    xy=st.tuples(st.integers(-14, 14), st.integers(-14, 14)),
    alphas=st.lists(st.integers(0, 255), min_size=1, max_size=4),
    modes=st.sampled_from([("RGB", "RGBA", "RGBA"), ("RGBA", "RGBA", "RGBA"), ("RGB", "RGB", "L"),
                           ("RGBA", "RGB", "L")]),
    seed=st.integers(0, 2**16),
)
def test_masked_paste_matches_pillow(dst_hw, src_hw, xy, alphas, modes, seed):
    rng = np.random.default_rng(seed)
    dst_mode, src_mode, mask_mode = modes
    dst = rng.integers(0, 256, (*dst_hw, len(dst_mode)), dtype=np.uint8)
    src = rng.integers(0, 256, (*src_hw, len(src_mode)), dtype=np.uint8)
    alpha = rng.choice(np.asarray(alphas + [0, 255], np.uint8), size=src_hw)
    if mask_mode == "RGBA":
        src[..., 3] = alpha
        mask = src
    else:
        mask = alpha
    want = Image.fromarray(dst, dst_mode)
    want.paste(Image.fromarray(src, src_mode), xy, Image.fromarray(mask, mask_mode))
    got = image_ops.paste(dst.copy(), src, xy, mask=mask)
    assert np.array_equal(got, np.asarray(want))
