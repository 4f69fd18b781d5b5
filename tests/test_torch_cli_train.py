"""The training CLI, end to end: the JAX package's and the port's on the
same tiny argv (R-18 32²→8², ``synthetic:16 synthetic:16 synthetic:8``,
batch 8, 2 steps per call, 4 iterations, a log entry every 2 with mAP on
one val batch), on the CPU.

The datasets are equal byte for byte (``test_torch_synthetic.py``) and so
are the index streams; the initial weights are made equal by replacing
the port CLI's ``build_states`` here, in the test only, with one that
loads JAX's ``Module.init`` at ``jax.random.key(seed)`` (what the JAX CLI's
``create_train_state`` draws) through the bridge. Then:

* the manifests agree, except for the log dir's path and ``device``;
* every log entry has the same keys;
* the first entry (the mean over steps 1 and 2) agrees in its losses to
  1e-5 relative, the alternating and supervised steps' tolerance in
  ``test_torch_train.py`` and ``test_torch_supervised.py`` (measured
  6e-7);
* its mean IoU agrees to 1e-3 absolute and its mAP exactly: the eval
  follows step 2, whose Adam update moves every backbone weight by about
  lr in its gradient's sign, so weights whose gradient is within float32
  error of 0 may step apart (see ``test_torch_train.py``) and the boxes
  move by a little (measured 6e-5 in mean IoU);
* the port's log dir serves through ``LocalizerInference`` on the CPU.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loans_tpu import models as jmodels
from loans_tpu.cli import train_localizer as jcli
from loans_tpu.ops.geometry import Size as JSize
from loans_tpu_torch import bridge
from loans_tpu_torch.cli import train_localizer as cli
from loans_tpu_torch.inference import LocalizerInference
from loans_tpu_torch.train import MetricsLog, checkpoint

ARGV = [
    "synthetic:16", "synthetic:16", "synthetic:8", "--batch-size", "8", "--n-layers", "18",
    "--target-size", "32", "32", "--crop-size", "8", "8", "--steps-per-call", "2",
    "--iterations", "4", "--log-interval", "2", "--eval-batches", "1",
]


@pytest.fixture(autouse=True)
def pinned(monkeypatch):
    monkeypatch.setattr(os, "cpu_count", lambda: 8)  # the data depend on it
    monkeypatch.setattr(cli, "build_states", jax_initial_states)
    torch.set_num_threads(min(4, torch.get_num_threads()))


_build_states = cli.build_states


def jax_initial_states(args, device):
    """The port's states with the JAX CLI's initial parameters."""
    loc_state, ass_state = _build_states(args, device)
    jl = jmodels.Localizer(out_size=JSize(*args.crop_size), n_layers=args.n_layers,
                           input_size=JSize(*args.target_size))
    key = jax.random.key(args.seed)
    loc_v = jl.init(key, jnp.zeros((2, *args.target_size, 3)), train=False)
    ass_v = jmodels.ResnetAssessor().init(key, jnp.zeros((2, *args.crop_size, 3)))
    loc_state.model.load_state_dict(
        bridge.localizer_state_dict(loc_state.model, loc_v["params"], loc_v["batch_stats"]))
    ass_state.model.load_state_dict(bridge.assessor_state_dict(ass_state.model, ass_v["params"]))
    return loc_state, ass_state


def run_both(tmp_path, extra=()):
    argv = ARGV + list(extra)
    jdir = jcli.main(argv + ["--log-dir", str(tmp_path / "jax")])
    pdir = cli.main(argv + ["--log-dir", str(tmp_path / "port"), "--device", "cpu"])
    return jdir, pdir


@pytest.mark.parametrize("mode", ["alternating", "supervised"])
def test_cli_matches_jax(tmp_path, mode):
    extra = ["--supervised"] if mode == "supervised" else []
    jdir, pdir = run_both(tmp_path, extra)

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
    first_j, first_p = jlog[0], plog[0]
    for k in losses:
        np.testing.assert_allclose(first_p[k], first_j[k], rtol=1e-5, err_msg=k)
    assert abs(first_p["mean_iou"] - first_j["mean_iou"]) <= 1e-3
    assert first_p["map"] == first_j["map"]
    for e in plog:
        assert all(np.isfinite(e[k]) for k in losses + ["mean_iou", "map", "images_per_sec"])

    names = sorted(os.listdir(pdir))
    want = {"manifest.json", "log", "Localizer_4.pt"} | ({"ResnetAssessor_4.pt"} if mode == "alternating" else set())
    assert want <= set(names), names
    inf = LocalizerInference(pdir, device="cpu", use_assessor=mode == "alternating", score_threshold=0.0)
    frames = np.random.default_rng(0).uniform(size=(3, 32, 32, 3)).astype(np.float32)
    boxes, rois, scores, _ = inf.localize_batch(frames)
    assert boxes.shape == (3, 1, 4) and rois.shape == (3, 8, 8, 3) and scores.shape == (3,)
    assert np.isfinite(boxes).all() and np.isfinite(scores).all()


def test_cli_refuses_what_the_port_lacks(tmp_path, monkeypatch):
    """``--dump-graph`` (the JAX step's StableHLO) is refused by name before
    the log dir is made, and so are the plotter with ``--supervised`` (it
    scores with the assessor) and, without Pillow (its caption's font), the
    plotter. ``--plot-interval``, ``--plot-image``, ``--send-bboxes`` and
    ``--profile`` run otherwise (``test_torch_bbox_plotter.py``). Image
    files and ``--device-data off`` are no longer refused
    (``test_torch_cli_files.py`` runs them): a list file that does not
    exist fails as a missing file."""
    for extra, needle in [
        (["--dump-graph"], "StableHLO"),
        (["--plot-interval", "1", "--supervised"], "BBoxPlotter scores the crop with the assessor"),
    ]:
        with pytest.raises(SystemExit, match=needle):
            cli.main(ARGV + extra + ["--device-data", "off", "--log-dir", str(tmp_path), "--device", "cpu"])
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "PIL", None)
        with pytest.raises(SystemExit, match="BBoxPlotter's caption is drawn with Pillow's font"):
            cli.main(ARGV + ["--plot-interval", "1", "--send-bboxes", "localhost:1", "--log-dir", str(tmp_path),
                             "--device", "cpu"])
    assert not os.listdir(tmp_path)  # refused before the log dir is made
    with pytest.raises(FileNotFoundError, match="train.txt"):
        cli.main([str(tmp_path / "train.txt")] + ARGV[1:] + ["--log-dir", str(tmp_path / "run"), "--device", "cpu"])


def test_cli_needs_a_card_unless_told_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        cli.main(ARGV + ["--log-dir", str(tmp_path)])


def test_cli_control_and_resume(tmp_path, monkeypatch):
    """``quit`` on the command channel stops a run at the next step call;
    resuming its snapshots continues to the total ``--iterations`` (a
    resume at or past it is refused)."""
    from loans_tpu_torch.train import control

    argv = ARGV[:ARGV.index("--iterations")] + ["--iterations", "8", "--log-interval", "2", "--eval-batches", "0",
                                                "--device", "cpu", "--log-dir", str(tmp_path / "a")]
    commands = [["quit"]]
    monkeypatch.setattr(control.CommandChannel, "drain", lambda self: commands.pop() if commands else [])
    log_dir = cli.main(argv)
    assert checkpoint.list_snapshots(log_dir, "Localizer_")[-1][0] == 2
    resumed = cli.main(argv[:-1] + [str(tmp_path / "b"), "--resume-localizer", f"{log_dir}/Localizer_2.pt",
                                    "--resume-discriminator", f"{log_dir}/ResnetAssessor_2.pt", "--no-freeze"])
    assert checkpoint.list_snapshots(resumed, "Localizer_")[-1][0] == 8
    log = MetricsLog.read(resumed)
    assert [e["iteration"] for e in log] == [4, 6, 8]
    with pytest.raises(SystemExit, match="TOTAL"):
        cli.main(argv[:-1] + [str(tmp_path / "c"), "--resume-localizer", f"{resumed}/Localizer_8.pt"])
