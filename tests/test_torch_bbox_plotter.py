"""The training monitor of the PyTorch port against the JAX package's, on
the CPU: the BBoxPlotter (``insights/bbox_plotter.py``), the progress
stream (``insights/progress_server.py``), the training CLI's
``--plot-interval``, ``--send-bboxes`` and ``--profile``, and
``train/profiling.py``.

* The canvas at iteration 0 from the same weights (``test_torch_inference.py``'s
  log dir: R-18 64x64 -> 16x16 and a ResnetAssessor, the port's ``.pt``
  bridged from JAX's ``.msgpack``), on one scene with a gt box: the same
  shape; the box tile equal where the box's coordinates truncate alike
  (they agree within 1e-3 px, ``test_torch_inference.py``'s bound); every
  other pixel (the crop, the heat map, the feature map, each resized as
  Pillow's BILINEAR, the PCA tile and the caption over them) within one
  uint8 step: the float32 tiles agree within about 1e-5 before they are
  truncated to uint8; the caption is the same text through the same Pillow.
* The plotter leaves the models as they were: their modes, parameters and
  statistics, no gradient, the global random stream; a bfloat16 pair is
  run in its own dtype.
* The training CLI (R-18 32x32 -> 8x8, 4 iterations in calls of 2) with
  ``--plot-interval 2 --send-bboxes`` to a port ``ImageServer`` logs the
  same losses, bit for bit, as without the plotter, at rotation dropout 0
  and 0.5 (where every step draws from the device generator); ``bboxes/``
  holds iterations 0, 2 and 4 and the server received three frames equal
  to them (at 0.5 on ``--plot-image``, a file of another size). ``--profile
  2 2`` writes a Chrome trace that names the crop's forward
  (``SeparableSampler``).
* The stream both ways, pixel for pixel: the port's client to JAX's server
  and JAX's client to the port's server; a refused connection disables the
  client and the trainer's ``bbox_vis_enabled``, and ``enablebboxvis``
  turns both on again.
* ``StepTimer.report()`` has JAX's keys.
"""

import json
import os
import shutil
import socket
import time
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from flax import serialization

from loans_tpu import models as jmodels
from loans_tpu.insights import BBoxPlotter as JaxPlotter
from loans_tpu.insights import ImageClient as JaxClient
from loans_tpu.insights import ImageServer as JaxServer
from loans_tpu.ops.geometry import Size as JSize
from loans_tpu.train import profiling as jprofiling
from loans_tpu_torch.cli import train_localizer as cli
from loans_tpu_torch.data.png import read_png
from loans_tpu_torch.inference import LocalizerInference
from loans_tpu_torch.insights.bbox_plotter import BBoxPlotter
from loans_tpu_torch.insights.progress_server import ImageClient, ImageServer
from loans_tpu_torch.insights.rendering import write_png
from loans_tpu_torch.models import Localizer, ResnetAssessor
from loans_tpu_torch.ops import Size
from loans_tpu_torch.train import Hook, MetricsLog, Trainer, apply_commands
from loans_tpu_torch.train.profiling import StepTimer
from test_torch_inference import log_dir, scenes  # noqa: F401  (the shared log dir fixture)

GT = np.array([[8.0, 10.0, 40.0, 50.0]])


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module, the worker's count put back
    after: the tier-1 run shares the cores among its workers, where
    threads that wait on each other's barriers run several times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def _remove_log_dir(log_dir):  # noqa: F811
    yield
    shutil.rmtree(log_dir)  # this module's copy of the shared log dir


def until(cond, timeout=5.0):
    end = time.time() + timeout
    while not cond() and time.time() < end:
        time.sleep(0.01)
    return cond()


def msgpack_variables(path):
    """(params, batch_stats) of a JAX ``.msgpack`` snapshot, as saved."""
    with open(path, "rb") as f:
        raw = serialization.msgpack_restore(f.read())
    return raw["params"], raw.get("batch_stats") or {}


def test_canvas_matches_jax(log_dir, tmp_path):  # noqa: F811
    image = scenes(11, 1)[0]
    loc_params, loc_stats = msgpack_variables(os.path.join(log_dir, "Localizer_5.msgpack"))
    ass_params, _ = msgpack_variables(os.path.join(log_dir, "ResnetAssessor_5.msgpack"))
    jtrainer = SimpleNamespace(loc_state=SimpleNamespace(params=loc_params, batch_stats=loc_stats),
                               ass_state=SimpleNamespace(params=ass_params), bbox_vis_enabled=True)
    jloc = jmodels.Localizer(out_size=JSize(16, 16), n_layers=18, input_size=JSize(64, 64))
    jplotter = JaxPlotter(jloc, jmodels.ResnetAssessor(), image, str(tmp_path / "jax"), gt_bbox=GT)
    want = np.asarray(jplotter(jtrainer, 0))
    inf = LocalizerInference(log_dir, device="cpu", use_assessor=True)
    trainer = SimpleNamespace(loc_state=SimpleNamespace(model=inf.localizer),
                              ass_state=SimpleNamespace(model=inf.assessor))
    plotter = BBoxPlotter(image, str(tmp_path / "port"), gt_bbox=GT)
    got = plotter(trainer, 0)

    assert got.shape == want.shape == (64, 5 * 64 + 4 * 2, 3) and got.dtype == np.uint8
    assert np.array_equal(read_png(str(tmp_path / "port" / "bboxes" / "0.png")), got)
    assert np.array_equal(np.asarray(Image.open(tmp_path / "jax" / "bboxes" / "0.png")), want)
    jboxes = np.asarray(jplotter._forward(loc_params, loc_stats, ass_params, jplotter.image)[1])
    boxes = plotter.forward(inf.localizer, inf.assessor)[1]
    np.testing.assert_allclose(boxes, jboxes, rtol=0, atol=1e-3)
    diff = np.abs(got.astype(int) - want.astype(int)).max(axis=-1)
    print(f"boxes {boxes} vs {jboxes}; pixels one step apart {int((diff > 0).sum())}")
    if np.array_equal(np.trunc(boxes), np.trunc(jboxes)):
        assert not diff[:, :64].any()  # the box tile (and the caption over it)
    assert diff.max() <= 1
    for x in range(66, got.shape[1], 66):  # each tile beside it is a picture, not blank
        assert np.ptp(got[:48, x : x + 64]) > 0 or x == 4 * 66  # the PCA tile: one row, white
    assert (got[:48, 4 * 66 :] == 255).all()


def test_plotter_leaves_the_models_alone(log_dir, tmp_path):  # noqa: F811
    inf = LocalizerInference(log_dir, device="cpu", use_assessor=True)
    loc, ass = inf.localizer.train(), inf.assessor.train()
    loc.feature_extractor.Conv_0.eval()  # a submodule in another mode stays so
    before = {k: v.clone() for m in (loc, ass) for k, v in m.state_dict().items()}
    modes = [m.training for m in (*loc.modules(), *ass.modules())]
    rng = torch.get_rng_state()
    plotter = BBoxPlotter(scenes(12, 1)[0] * 255.0, str(tmp_path))
    plotter(SimpleNamespace(loc_state=SimpleNamespace(model=loc), ass_state=SimpleNamespace(model=ass)), 3)
    assert os.listdir(tmp_path / "bboxes") == ["3.png"]
    assert [m.training for m in (*loc.modules(), *ass.modules())] == modes
    after = {k: v for m in (loc, ass) for k, v in m.state_dict().items()}
    assert all(torch.equal(before[k], after[k]) for k in before)
    assert all(p.grad is None for m in (loc, ass) for p in m.parameters())
    assert torch.equal(torch.get_rng_state(), rng)

    torch.manual_seed(0)  # bfloat16 models run in their dtype
    bf_loc = Localizer(out_size=Size(8, 8), n_layers=18, input_size=Size(32, 32), dtype=torch.bfloat16)
    bf_ass = ResnetAssessor(ch=8, in_size=Size(8, 8), dtype=torch.bfloat16)
    bf = BBoxPlotter(scenes(13, 1, size=32)[0], str(tmp_path / "bf16"))
    rois, boxes, score, anchor, heat, feats = bf.forward(bf_loc, bf_ass)
    with torch.no_grad():
        want_rois, _ = bf_loc.eval()(torch.from_numpy(bf.image))
        want_score = bf_ass.eval()(want_rois)
    assert np.array_equal(rois, want_rois.numpy()) and np.array_equal(score, want_score.float().numpy())
    assert feats.shape == (1, 2 * 2 * 8) and heat.shape == (1, 32, 32, 1) and np.isfinite(heat).all()


ARGV = [
    "synthetic:16", "synthetic:16", "synthetic:8", "--batch-size", "8", "--n-layers", "18",
    "--target-size", "32", "32", "--crop-size", "8", "8", "--steps-per-call", "2",
    "--iterations", "4", "--log-interval", "2", "--eval-batches", "1", "--device", "cpu",
]


@pytest.mark.parametrize("ratio", ["0.0", "0.5"])
def test_cli_losses_equal_with_the_plotter(tmp_path, ratio):
    received = []
    server = ImageServer("127.0.0.1", 0, on_image=lambda img, title: received.append((title, img))).start()
    try:
        argv = ARGV + ["--rotation-dropout-ratio", ratio]
        profile = ["--profile", "2", "2"] if ratio == "0.0" else []
        if ratio == "0.5":  # a plot image of another size, resized to the input size
            write_png(str(tmp_path / "plot.png"), np.random.default_rng(0).integers(0, 256, (40, 48, 3), np.uint8))
            profile = ["--plot-image", str(tmp_path / "plot.png")]
        plotted = cli.main(argv + ["--log-dir", str(tmp_path / "plot"), "--plot-interval", "2",
                                   "--send-bboxes", f"127.0.0.1:{server.port}"] + profile)
        plain = cli.main(argv + ["--log-dir", str(tmp_path / "plain")])
        assert until(lambda: len(received) == 3)
    finally:
        server.stop()
    got, want = MetricsLog.read(plotted), MetricsLog.read(plain)
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        for k in ("loss_localizer", "loss_dis", "y_fake_mean", "y_real_mean", "mean_iou", "map"):
            assert a[k] == b[k], k
    assert sorted(os.listdir(os.path.join(plotted, "bboxes"))) == ["0.png", "2.png", "4.png"]
    assert sorted(t for t, _ in received) == ["iteration 0", "iteration 2", "iteration 4"]
    for title, img in received:
        assert np.array_equal(img, read_png(os.path.join(plotted, "bboxes", f"{title.split()[-1]}.png")))
        assert img.shape == (32, 5 * 32 + 4 * 2, 3)
    if ratio == "0.0":
        (trace,) = os.listdir(os.path.join(plotted, "profile"))
        with open(os.path.join(plotted, "profile", trace)) as f:
            names = {e.get("name") for e in json.load(f)["traceEvents"]}
        assert "SeparableSampler" in names
    shutil.rmtree(tmp_path)  # R-18 snapshots with optimizer state: ~0.2 GB each


def test_stream_both_ways(tmp_path):
    rng = np.random.default_rng(0)
    frame = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    got = []
    jserver = JaxServer("127.0.0.1", 0, on_image=lambda img, t: got.append((t, np.asarray(img))),
                        save_dir=str(tmp_path / "jax")).start()
    pserver = ImageServer("127.0.0.1", 0, on_image=lambda img, t: got.append((t, img)),
                          save_dir=str(tmp_path / "port")).start()
    try:
        assert ImageClient("127.0.0.1", jserver.port).send(frame, title="port to jax")
        assert until(lambda: len(got) == 1)
        assert JaxClient("127.0.0.1", pserver.port).send(Image.fromarray(frame), title="jax to port")
        assert until(lambda: len(got) == 2)
    finally:
        jserver.stop()
        pserver.stop()
    assert [t for t, _ in got] == ["port to jax", "jax to port"]
    assert all(np.array_equal(img, frame) for _, img in got)
    assert np.array_equal(read_png(str(tmp_path / "port" / "000001.png")), frame)
    assert np.array_equal(np.asarray(Image.open(tmp_path / "jax" / "000001.png")), frame)
    assert pserver.count == 1 and np.array_equal(pserver.latest, frame)


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_refused_client_disables_and_enablebboxvis_enables(tmp_path):
    torch.manual_seed(0)
    loc = Localizer(out_size=Size(8, 8), n_layers=18, input_size=Size(32, 32))
    ass = ResnetAssessor(ch=8, in_size=Size(8, 8))
    port = free_port()
    plotter = BBoxPlotter(scenes(14, 1, size=32)[0], str(tmp_path), send_to=("127.0.0.1", port))
    trainer = SimpleNamespace(loc_state=SimpleNamespace(model=loc), ass_state=SimpleNamespace(model=ass),
                              bbox_vis_enabled=True, hooks=[Hook(plotter, every=1)])
    trainer.enable_bbox_vis = lambda: Trainer.enable_bbox_vis(trainer)
    plotter(trainer, 0)  # nothing listens: refused
    assert not plotter.client.enabled and not trainer.bbox_vis_enabled
    server = ImageServer("127.0.0.1", port).start()
    try:
        plotter(trainer, 1)  # disabled: not sent
        apply_commands(["enablebboxvis"], trainer)
        assert plotter.client.enabled and trainer.bbox_vis_enabled
        canvas = plotter(trainer, 2)
        assert until(lambda: server.count == 1)
    finally:
        server.stop()
    assert server.count == 1 and np.array_equal(server.latest, canvas)
    assert sorted(os.listdir(tmp_path / "bboxes")) == ["0.png", "1.png", "2.png"]


def test_step_timer_reports_jax_keys():
    jtimer, timer = jprofiling.StepTimer(), StepTimer()
    jtrainer = SimpleNamespace(loc_state=SimpleNamespace(params=jnp.zeros(2)))
    trainer = SimpleNamespace(loc_state=SimpleNamespace(model=torch.nn.Linear(2, 2)))
    assert jtimer.report() == timer.report() == {}
    for i in range(3):
        jtimer(jtrainer, i)
        timer(trainer, i)
    assert set(timer.report()) == set(jtimer.report()) == {"step_ms_p50", "step_ms_p90", "step_ms_p99",
                                                            "step_ms_mean"}
    assert len(timer.latencies) == 2 and all(v >= 0 for v in timer.report().values())
