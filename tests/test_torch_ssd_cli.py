"""The port's SSD entry points against the JAX package's, on the CPU:
the training CLI (``cli/train_ssd.py``), the evaluator and the sweep's SSD
branch (``evaluation/ssd_eval.py``, ``evaluation/evaluator.py``,
``cli/evaluate.py``), serving (``inference/ssd.py``: ``SSDInference`` and
``load_inference``), and what the port refuses.

* The two training CLIs on the same tiny argv (SSD300, ``synthetic:4
  synthetic:2``, batch 2, ``--no-augment``, 2 iterations in one call of
  2): the datasets are equal byte for byte (``test_torch_synthetic.py``)
  and so are the index streams; the initial weights are made equal here,
  in the test only, by replacing the function of each CLI that makes the
  model with one that takes the same seeded numpy weights (the JAX CLI's
  ``create_train_state`` and the port's ``build_model``). The JAX CLI runs
  on a mesh of one of the eight virtual CPU devices of
  ``tests/conftest.py``, as the port runs on one, and its
  pooled step runs the jitted body one step at a time: the same function
  as its scan, which XLA's CPU backend runs some 60 times slower. The
  manifests agree but for the log dir's path and ``device``, the log
  entries have the same keys, the losses (the mean of steps 1 and 2)
  agree to 1e-3 relative and the parameters of the final snapshot to
  2·lr per step, as ``test_torch_ssd_device.py`` holds two steps and for
  its reasons. The JAX package's own inits are replaced the same way
  wherever a snapshot's weights replace them (serving, the sweep).
* Detections on one log dir (two snapshots of bridged weights, the
  multibox head scaled so that hundreds of anchors pass the 0.6 gate):
  the kept boxes agree to 1e-3 px and their scores to 1e-5 (float32
  networks, measured 2e-5 px), the same boxes kept (the JAX package's
  native NMS in float32, the port's in float64: no IoU in these images
  falls within rounding of 0.45), and mAP to 1e-6.
* The plot hook (``SSDPlotHook``) and the sweep's ``--save-predictions``
  renders against JAX's, and the live CLI on the SSD log dir against JAX's
  live CLI: the detections as above, the drawings equal but where a box or
  a score moves by a pixel.
"""

import json
import os
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_ssd_models import port_ssd, ssd_variables  # noqa: E402

import loans_tpu.parallel as jparallel
import loans_tpu.train as jtrain
from loans_tpu.cli import train_ssd as jcli
from loans_tpu.evaluation import evaluator as jevaluator
from loans_tpu.evaluation.ssd_eval import SSDEvaluator as JSSDEvaluator
from loans_tpu.inference import ssd as jinference
from loans_tpu.models import ssd as jssd
from loans_tpu.parallel import mesh as jmesh
from loans_tpu.train import checkpoint as jcheckpoint
from loans_tpu.train import state as jstate
from loans_tpu_torch import bridge
from loans_tpu_torch.cli import evaluate
from loans_tpu_torch.cli import train_ssd as cli
from loans_tpu_torch.data.png import read_png
from loans_tpu_torch.data.synthetic import SyntheticLocalizerDataset
from loans_tpu_torch.evaluation.evaluator import Evaluator
from loans_tpu_torch.evaluation.ssd_eval import SSDEvaluator
from loans_tpu_torch.inference import LocalizerInference, SSDInference, load_inference
from loans_tpu_torch.insights.rendering import draw_boxes_on_image
from loans_tpu_torch.models import Localizer
from loans_tpu_torch.ops import Size
from loans_tpu_torch.train import MetricsLog, checkpoint

ARGV = ["synthetic:4", "synthetic:2", "--model", "ssd300", "-b", "2", "--no-augment", "--iterations", "2",
        "--steps-per-call", "2", "--log-interval", "2"]
LR = 1e-4  # both CLIs' default


@pytest.fixture(scope="module")
def variables():
    return ssd_variables("SSD300", seed=10, conf_scale=1e-2, loc_scale=1e-2)


@pytest.fixture(autouse=True)
def pinned(monkeypatch, variables):
    monkeypatch.setattr(os, "cpu_count", lambda: 8)  # the synthetic data depend on it
    torch.set_num_threads(min(4, torch.get_num_threads()))

    def jax_state(model, rng, sample_input, tx, **kw):  # the seeded weights, not flax's init
        params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
        return jstate.TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats={},
                                 opt_state=tx.init(params), tx=tx)

    monkeypatch.setattr(jtrain, "create_train_state", jax_state)


def stepwise_pooled_train_step(body, steps_per_call):
    """``make_pooled_train_step`` of one group, its scan written as a
    Python loop over the jitted body (the same gathers, per-step keys and
    mean of the metrics)."""
    step = jax.jit(body)

    def pooled_step(loc_state, ass_state, chunk, rng):
        (group,) = chunk["pools"]
        metrics = []
        for t, key in enumerate(jax.random.split(rng, steps_per_call)):
            ind = chunk["idx"][group][t]
            batch = jax.tree_util.tree_map(lambda a: jnp.take(a, ind, axis=0), chunk["pools"][group])
            loc_state, ass_state, m = step(loc_state, ass_state, batch, key)
            metrics.append(m)
        return loc_state, ass_state, jax.tree_util.tree_map(lambda *m: jnp.mean(jnp.stack(m), axis=0), *metrics)

    return pooled_step


def test_cli_matches_jax(tmp_path, monkeypatch, variables):
    monkeypatch.setattr(jparallel, "create_mesh", lambda: jmesh.create_mesh(jax.devices()[:1]))
    monkeypatch.setattr(jtrain, "make_pooled_train_step", stepwise_pooled_train_step)
    monkeypatch.setattr(cli, "build_model", lambda args, device: port_ssd("SSD300", variables).to(device))
    jdir = jcli.main(ARGV + ["--log-dir", str(tmp_path / "jax")])
    # the port's run with the plot hook: iterations 0 and 2 drawn, the losses as JAX's without it
    pdir = cli.main(ARGV + ["--log-dir", str(tmp_path / "port"), "--device", "cpu", "--plot-interval", "2"])

    jman, pman = checkpoint.load_manifest(jdir), checkpoint.load_manifest(pdir)
    for man in (jman, pman):
        man["config"].pop("log_dir")
    assert pman["config"].pop("device") == "cpu"
    assert pman["config"].pop("plot_interval") == 2 and jman["config"].pop("plot_interval") == 0
    assert json.loads(json.dumps(jman)) == pman

    jlog, plog = MetricsLog.read(jdir), MetricsLog.read(pdir)
    assert len(jlog) == len(plog) == 1 and plog[0]["iteration"] == 2
    assert set(plog[0]) - {"device"} == set(jlog[0])
    for k in ("loss", "loss/loc", "loss/conf"):
        np.testing.assert_allclose(plog[0][k], jlog[0][k], rtol=1e-3, err_msg=k)

    assert {"manifest.json", "log", "SSD300_2.pt", "bboxes"} <= set(os.listdir(pdir))
    assert sorted(os.listdir(os.path.join(pdir, "bboxes"))) == ["0.png", "2.png"]
    assert read_png(os.path.join(pdir, "bboxes", "0.png")).shape == (300, 300, 3)
    port = checkpoint.load_params(os.path.join(pdir, "SSD300_2.pt"))
    jax_params, _ = jcheckpoint.restore_params(os.path.join(jdir, "SSD300_2.msgpack"), variables["params"])
    want = bridge.ssd_state_dict(port_ssd("SSD300", variables), jax.tree_util.tree_map(np.asarray, jax_params))
    start = bridge.ssd_state_dict(port_ssd("SSD300", variables), variables["params"])
    for key, value in port.items():
        assert float((value - want[key]).abs().max()) <= 2 * 2 * LR + 1e-7, key
        if not key.endswith("bias"):  # trained (a dead ReLU's bias may stay)
            assert not torch.equal(value, start[key]), key


def test_cli_refuses_what_the_port_lacks(tmp_path, monkeypatch):
    """A gt json with ``--device-data on`` is refused with the JAX CLI's
    message, and the plot hook without Pillow (its scores are drawn with
    Pillow's font) by name, before the log dir is made. With Pillow the
    plot hook runs (``test_plot_hook_matches_jax``); gt json files,
    ``--device-data off`` and ``--num-workers`` are no longer refused
    (``test_torch_cli_files.py`` runs them)."""
    with pytest.raises(SystemExit, match="requires synthetic train data"):
        cli.main(["train.json"] + ARGV[1:] + ["--device-data", "on", "--log-dir", str(tmp_path), "--device", "cpu"])
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(SystemExit, match="plot hook draws scores with Pillow's font, and Pillow is not installed"):
        cli.main(ARGV + ["--plot-interval", "10", "--log-dir", str(tmp_path), "--device", "cpu"])
    assert not os.listdir(tmp_path)  # refused before the log dir is made


def test_cli_needs_a_card_unless_told_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        cli.main(ARGV + ["--log-dir", str(tmp_path)])


@pytest.fixture(scope="module")
def ssd_log_dir(tmp_path_factory, variables):
    """A log dir with SSD300 snapshots at iterations 1 and 2 in both
    formats (``.msgpack`` for the JAX package, ``.pt`` for the port: the
    first through the bridge, the second through
    ``tools/export_torch_snapshot.py``)."""
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
    import export_torch_snapshot

    log_dir = str(tmp_path_factory.mktemp("ssdlog"))
    manifest = {"localizer": {"model": "SSD300", "kwargs": {"n_fg_class": 1}}, "snapshot_names": ["SSD300"],
                "config": {}}
    jcheckpoint.save_manifest(log_dir, manifest)
    second = jax.tree_util.tree_map(lambda a: a * np.float32(1.01), variables["params"])
    for iteration, params in ((1, variables["params"]), (2, second)):
        jcheckpoint.save_params(os.path.join(log_dir, f"SSD300_{iteration}.msgpack"), params)
    model = port_ssd("SSD300", variables)
    checkpoint.save_params(os.path.join(log_dir, "SSD300_1.pt"), model.state_dict())
    assert export_torch_snapshot.export(log_dir) == [os.path.join(log_dir, "SSD300_2.pt")]
    return log_dir


def val_batches(n=4, batch=2):
    """Labeled synthetic scenes at 300² (the SSD CLIs' val split: seed 1),
    as (float images, gt boxes (N, 1, 4), scores) numpy batches."""
    ds = SyntheticLocalizerDataset(n, image_size=(300, 300), seed=1, labeled=True)
    items = [ds[i] for i in range(n)]
    return [tuple(np.stack([it[k] for it in items[s : s + batch]]) for k in range(3)) for s in range(0, n, batch)]


def test_detections_and_map_match_jax(ssd_log_dir, variables):
    batches = val_batches()
    jmodel = jssd.SSD300()
    jev = JSSDEvaluator(jmodel, jmodel.coder())
    jstate_ = jstate.TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"], batch_stats={},
                                opt_state=None, tx=None)
    port_state = checkpoint_state(variables)
    ev = SSDEvaluator(300, port_ssd("SSD300", variables).coder())
    n_kept = 0
    for images, gt, _ in batches:
        for (jb, jl, js), (pb, pl, ps) in zip(jev.detect(jstate_, jnp.asarray(images)),
                                              ev.detect(port_state, torch.from_numpy(images))):
            assert len(pb) == len(jb) and np.array_equal(pl, jl)
            np.testing.assert_allclose(pb, jb, rtol=0, atol=1e-3)
            np.testing.assert_allclose(ps, js, rtol=0, atol=1e-5)
            n_kept += len(pb)
    assert n_kept >= 20
    want = jev(jstate_, [(jnp.asarray(b[0]), b[1]) for b in batches])["map"]
    got = ev(port_state, [(torch.from_numpy(b[0]), b[1]) for b in batches])["map"]
    assert abs(got - want) <= 1e-6


def checkpoint_state(variables):
    from loans_tpu_torch.train import TrainState

    return TrainState(model=port_ssd("SSD300", variables), optimizer=None)


def test_inference_and_dispatch_match_jax(ssd_log_dir, tmp_path):
    frame = val_batches(2, 2)[0][0][0]
    jinf = jinference.SSDInference(ssd_log_dir, score_threshold=0.6)
    inf = load_inference(ssd_log_dir, device="cpu", score_threshold=0.6, use_assessor=True)
    assert isinstance(inf, SSDInference) and inf.input_size == 300
    jb, _, js, _ = jinf.localize(frame)
    pb, rois, ps, heat = inf.localize(frame)
    assert rois is None and heat is None and len(pb) == len(jb) > 0
    np.testing.assert_allclose(pb, jb, rtol=0, atol=1e-3)
    np.testing.assert_allclose(ps, js, rtol=0, atol=1e-5)
    [(bb, bs)] = inf.localize_batch([frame])
    assert np.array_equal(bb, pb) and np.array_equal(bs, ps)
    # the latest snapshot by default, a named one on request
    first = SSDInference(ssd_log_dir, device="cpu", snapshot="SSD300_1.pt")
    assert not np.array_equal(first.localize(frame)[0], pb)
    np.testing.assert_allclose(inf.scale_boxes(pb, (2.0, 0.5)), pb * [2.0, 0.5, 2.0, 0.5])

    # a localizer log dir still builds LocalizerInference
    loc_dir = str(tmp_path / "loc")
    torch.manual_seed(0)
    loc = Localizer(out_size=Size(8, 8), n_layers=18, input_size=Size(32, 32))
    checkpoint.save_manifest(loc_dir, {
        "localizer": {"model": "Localizer", "kwargs": {"out_size": [8, 8], "n_layers": 18, "input_size": [32, 32]}},
        "snapshot_names": ["Localizer"]})
    checkpoint.save_params(os.path.join(loc_dir, "Localizer_1.pt"), loc.state_dict())
    assert isinstance(load_inference(loc_dir, device="cpu"), LocalizerInference)


def assert_renders_match(got, want, base):
    """A port render against JAX's of the same image: any difference lies
    on a pixel that one of them drew over ``base`` (a detection's box moved
    by one pixel where a coordinate truncates to either side, or its score
    printed one step apart); returns whether they are equal."""
    off = (got != want).any(axis=-1)
    on_drawing = (got != base).any(axis=-1) | (want != base).any(axis=-1)
    assert not (off & ~on_drawing).any(), "a difference off the drawn detections"
    return not off.any()


def test_sweep_matches_jax_and_resumes(ssd_log_dir, tmp_path, capsys, monkeypatch):
    """The SSD branch of the sweep: the ``SSD300_`` prefix by default, mAP
    per snapshot as the JAX package's ``Evaluator`` gives it, no deteval,
    no BatchNorm warm-up; the renders of ``--save-predictions`` (the
    detections with their scores over the gt boxes) equal JAX's where the
    detections agree (``assert_renders_match``); a second run evaluates
    nothing; without Pillow the renders are refused by name."""
    batches = val_batches()
    jev = jevaluator.Evaluator(ssd_log_dir, results_name="eval_jax.json")
    jresults = jev.sweep(lambda: iter([(jnp.asarray(b[0]), b[1]) for b in batches]), deteval_dir="unused",
                         save_predictions=str(tmp_path / "jax"))
    ev = Evaluator(ssd_log_dir, results_name="eval_port.json", device="cpu")
    assert ev.is_ssd and ev.snapshot_prefix == "SSD300_" and ev.image_size == Size(300, 300)
    results = ev.sweep(lambda: iter(batches), deteval_dir=str(ssd_log_dir) + "/deteval", bn_warmup=1,
                       save_predictions=str(tmp_path / "port"))
    assert [e["snapshot_name"] for e in results.entries] == ["SSD300_1.pt", "SSD300_2.pt"]
    for got, want in zip(results.entries, jresults.entries):
        assert set(got) == set(want) == {"snapshot_name", "iteration", "map"}
        assert got["iteration"] == want["iteration"] and abs(got["map"] - want["map"]) <= 1e-6
    assert not os.path.exists(str(ssd_log_dir) + "/deteval")
    equal = 0
    for it in ("1", "2"):
        names = sorted(os.listdir(tmp_path / "port" / it))
        assert names == sorted(os.listdir(tmp_path / "jax" / it)) == ["0.png", "1.png", "2.png", "3.png"]
        for i, name in enumerate(names):
            img, gt = batches[i // 2][0][i % 2], batches[i // 2][1][i % 2]
            base = draw_boxes_on_image((img * 255).astype(np.uint8), np.zeros((0, 4)), gt_boxes=gt[np.abs(gt).sum(1) > 0])
            got = read_png(str(tmp_path / "port" / it / name))
            want = np.asarray(Image.open(tmp_path / "jax" / it / name))
            equal += assert_renders_match(got, want, base)
            assert (got != base).any()  # detections drawn
    assert equal >= 6  # of 8 renders

    argv = ["synthetic:4", ssd_log_dir, "-b", "2", "--seed", "1", "--device", "cpu"]
    first = evaluate.main(argv)
    assert sorted(first.timings) == ["SSD300_1.pt", "SSD300_2.pt"]
    maps = {e["snapshot_name"]: e["map"] for e in first.entries}
    assert maps == {e["snapshot_name"]: e["map"] for e in results.entries}  # the same scenes
    assert not evaluate.main(argv).timings  # resume
    assert "best snapshot: SSD300_" in capsys.readouterr().out
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(SystemExit, match="SSD log dir.*Pillow is not installed"):
        evaluate.main(argv + ["--save-predictions", str(ssd_log_dir) + "/renders"])
    with pytest.raises(NotImplementedError, match="Pillow is not installed"):
        ev.sweep(lambda: iter(batches), save_predictions=str(ssd_log_dir) + "/renders")


def test_plot_hook_matches_jax(variables, tmp_path):
    """``SSDPlotHook`` at iteration 0 against JAX's from the same weights
    on the first val scene: the detections within 1e-3 px and 1e-5 as
    ``test_detections_and_map_match_jax`` holds them, and the PNG equal,
    but where a box or score moves by a pixel (``assert_renders_match``).
    ``test_cli_matches_jax`` runs the hook in the CLI."""
    image, gt = val_batches(2, 2)[0][0][0], val_batches(2, 2)[0][1][0]
    jmodel = jssd.SSD300()
    jev = JSSDEvaluator(jmodel, jmodel.coder())
    jstate_ = jstate.TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"], batch_stats={},
                                opt_state=None, tx=None)
    jcli.SSDPlotHook(jev, image, gt, str(tmp_path / "jax"))(SimpleNamespace(loc_state=jstate_), 0)
    ev = SSDEvaluator(300, port_ssd("SSD300", variables).coder())
    state = checkpoint_state(variables)
    got = cli.SSDPlotHook(ev, image, gt, str(tmp_path / "port"))(SimpleNamespace(loc_state=state), 0)
    assert np.array_equal(read_png(str(tmp_path / "port" / "bboxes" / "0.png")), got)
    want = np.asarray(Image.open(tmp_path / "jax" / "bboxes" / "0.png"))
    ((pb, _, ps),) = ev.detect(state, torch.from_numpy(image[None]))
    ((jb, _, js),) = jev.detect(jstate_, jnp.asarray(image[None]))
    assert len(pb) == len(jb) > 0
    np.testing.assert_allclose(pb, jb, rtol=0, atol=1e-3)
    np.testing.assert_allclose(ps, js, rtol=0, atol=1e-5)
    assert got.shape == want.shape == (300, 300, 3)
    base = draw_boxes_on_image((image * 255).astype(np.uint8), np.zeros((0, 4)), gt_boxes=gt[np.abs(gt).sum(1) > 0])
    print(f"plot hook render equal to JAX's: {assert_renders_match(got, want, base)}")


def lockstep(results):
    """A stand-in for ``AsynchronousLocalizer`` that localizes each frame
    when it is submitted and hands its result to the next ``get_result``,
    with its fps at 0: the live CLI then shows the same frames in every
    run. Each result is appended to ``results``."""

    class Lockstep:
        def __init__(self, localizer):
            self.localizer, self.fps, self.result = localizer, 0.0, None

        def start_localization_worker(self):
            return self

        def submit(self, image):
            self.result = self.localizer.localize(image)
            results.append(self.result)
            return True

        def get_result(self):
            result, self.result = self.result, None
            return result

        def shutdown(self):
            pass

    return Lockstep


def test_live_cli_serves_an_ssd_log_dir(ssd_log_dir, tmp_path, monkeypatch):
    """The live CLI on an SSD log dir serves through ``SSDInference``, as
    the JAX package's does: three frames of a clip (two scenes at 400x300
    and one again), then ESC. With the worker in lock step in both CLIs,
    each frame's detections (several a frame) agree with JAX's to 1e-3 px
    and 1e-5, and each shown frame (mirrored, the boxes and scores drawn
    at the frame's scale, the fps text) equals JAX's but where a box or
    score moves by a pixel (``assert_renders_match``)."""
    import cv2

    import loans_tpu.inference as jax_inference
    import loans_tpu_torch.inference as port_inference
    from loans_tpu.cli import live_inference as jlive
    from loans_tpu_torch.cli import live_inference

    scenes = [img for images, _, _ in val_batches(2, 2) for img in images]
    frames = [cv2.resize((img[..., ::-1] * 255).astype(np.uint8), (400, 300)) for img in scenes + scenes[:1]]
    clip = str(tmp_path / "live.avi")
    writer = cv2.VideoWriter(clip, cv2.VideoWriter_fourcc(*"MJPG"), 10.0, (400, 300))
    for f in frames:
        writer.write(f)
    writer.release()
    cap, decoded = cv2.VideoCapture(clip), []
    while (read := cap.read())[0]:
        decoded.append(read[1])
    cap.release()

    def shown_by(cli, package, argv):
        results, shown, keys = [], [], iter([255, 255, 27])
        monkeypatch.setattr(package, "AsynchronousLocalizer", lockstep(results))
        monkeypatch.setattr(cv2, "imshow", lambda name, frame: shown.append(frame.copy()))
        monkeypatch.setattr(cv2, "waitKey", lambda delay: next(keys))
        monkeypatch.setattr(cv2, "destroyAllWindows", lambda: None)
        cli.main(argv)
        return results, shown

    argv = [ssd_log_dir, "-c", clip, "--score-threshold", "0.6"]
    monkeypatch.setattr(jlive, "get_parser", live_inference.get_parser)  # JAX's takes a device index only
    jresults, jshown = shown_by(jlive, jax_inference, argv)
    results, shown = shown_by(live_inference, port_inference, argv + ["--device", "cpu"])
    assert len(results) == len(jresults) == len(shown) == len(jshown) == 3
    for (pb, rois, ps, heat), (jb, _, js, _) in zip(results, jresults):
        assert rois is None and heat is None and len(pb) == len(jb) > 1
        np.testing.assert_allclose(pb, jb, rtol=0, atol=1e-3)
        np.testing.assert_allclose(ps, js, rtol=0, atol=1e-5)
    for got, want, frame in zip(shown, jshown, decoded):
        base = cv2.flip(frame, 1)
        cv2.putText(base, "0.0 fps", (10, 24), cv2.FONT_HERSHEY_SIMPLEX, 0.7, (0, 255, 0), 2)
        assert got.shape == (300, 400, 3) and (got != base).any()  # detections drawn
        assert_renders_match(got, want, base)


def test_image_cli_serves_an_ssd_log_dir(ssd_log_dir, tmp_path, capsys):
    """The image CLI builds its wrapper through ``load_inference``: an SSD
    log dir is served by ``SSDInference`` and its detections drawn."""
    import cv2

    from loans_tpu_torch.cli import image_inference

    frame = (val_batches(2, 2)[0][0][0][..., ::-1] * 255).astype(np.uint8)  # BGR, as cv2 reads
    path = str(tmp_path / "scene.png")
    cv2.imwrite(path, cv2.resize(frame, (450, 300)))
    image_inference.main([ssd_log_dir, "-i", path, "-o", str(tmp_path / "out"), "--score-threshold", "0.6",
                          "--device", "cpu"])
    drawn = cv2.imread(str(tmp_path / "out" / "scene.png"))
    assert drawn.shape == (300, 450, 3) and not np.array_equal(drawn, cv2.imread(path))
    assert "scene.png: box=" in capsys.readouterr().out
