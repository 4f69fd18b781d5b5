"""The offline snapshot sweep of the port (``loans_tpu_torch.cli.evaluate``,
``evaluation/evaluator.py``) against the JAX package's
(``loans_tpu.cli.evaluate``), on the CPU.

A tiny JAX training run (the JAX CLI: R-18 32²→8², 4 iterations, a
snapshot every 2) gives a log dir with two localizer and two assessor
snapshots; each ``.msgpack`` snapshot is mapped to a ``.pt`` one through
``loans_tpu_torch.bridge``. Both CLIs then sweep copies of it with the same
flags, and:

* ``eval_results.json`` holds the same entries, snapshot names equal up to
  their extension, with ``mean_iou`` and ``mean_assessor_score`` within
  1e-5 and ``map`` and ``ap/object`` within 1e-6 (float32 networks that
  differ only in summation order: measured 1e-8), with and without
  ``--bn-warmup``; a low ``--iou-threshold`` makes the mAP of this short
  run non-zero;
* the renders of ``--save-predictions`` equal JAX's Pillow renders, and the
  deteval XML holds the same images and boxes to its 2 decimals (a box
  within 1e-5 px of a rounding boundary may print one step apart);
* resume and ``--force-reset`` evaluate the same snapshots as JAX's;
* a corrupt snapshot is reported and the sweep goes on; an assessor
  without snapshots scores nothing; an SSD log dir, image files and a
  missing card are refused; without matplotlib, ``plot`` still reports the
  best snapshot;
* the parser has JAX's flags and defaults, plus ``--device``.
"""

import argparse
import glob
import json
import os
import shutil
import sys
import xml.etree.ElementTree as ET

import numpy as np
import pytest
import torch
from flax import serialization
from PIL import Image

from loans_tpu.cli import evaluate as jevaluate
from loans_tpu.cli import train_localizer as jtrain
from loans_tpu_torch import bridge
from loans_tpu_torch.cli import evaluate
from loans_tpu_torch.evaluation.evaluator import Evaluator
from loans_tpu_torch.train import checkpoint
from loans_tpu_torch.utils.registry import build_assessor, build_model

METRIC_TOL = {"mean_iou": 1e-5, "mean_assessor_score": 1e-5, "map": 1e-6, "ap/object": 1e-6}


@pytest.fixture(scope="module")
def log_dir(tmp_path_factory):
    """A JAX-trained log dir, its snapshots also as the port's ``.pt``."""
    tmp = str(tmp_path_factory.mktemp("jax_train"))
    log_dir = jtrain.main([
        "synthetic:16", "synthetic:16", "synthetic:8", "--batch-size", "8", "--target-size", "32", "32",
        "--crop-size", "8", "8", "--n-layers", "18", "--iterations", "4", "--log-dir", tmp,
        "--log-interval", "2", "--snapshot-interval", "2", "--eval-batches", "1", "--steps-per-call", "1",
    ])
    manifest = checkpoint.load_manifest(log_dir)
    loc = build_model(manifest["localizer"]["model"], **manifest["localizer"]["kwargs"])
    models = {"Localizer": loc, "ResnetAssessor": build_assessor(manifest["assessor"], loc)}
    for path in sorted(glob.glob(os.path.join(log_dir, "*.msgpack"))):
        with open(path, "rb") as f:
            raw = serialization.msgpack_restore(f.read())
        model = models[os.path.basename(path).split("_")[0]]
        state = bridge.to_state_dict(model, raw.get("params", raw), raw.get("batch_stats") or None)
        checkpoint.save_params(path[: -len(".msgpack")] + ".pt", state)
    assert [i for i, _ in checkpoint.list_snapshots(log_dir, "Localizer_")] == [2, 4]
    return log_dir


def _copy(log_dir, dest):
    """The log dir for one sweep: its files hard-linked (a snapshot of this
    R-18 run is 50-200 MB), its own ``eval_results.json``."""
    shutil.copytree(log_dir, dest, copy_function=os.link)
    return str(dest)


def _assert_entries_match(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert os.path.splitext(g["snapshot_name"])[0] == os.path.splitext(w["snapshot_name"])[0]
        assert g["snapshot_name"].endswith(".pt") and w["snapshot_name"].endswith(".msgpack")
        assert g["iteration"] == w["iteration"]
        assert set(g) == set(w)
        for key, tol in METRIC_TOL.items():
            if key in w:
                assert abs(g[key] - w[key]) <= tol, (key, g[key], w[key])


@pytest.mark.parametrize("extra", [[], ["--bn-warmup", "1", "--iou-threshold", "0.02"]],
                         ids=["plain", "bn-warmup"])
def test_sweep_matches_jax(log_dir, tmp_path, extra):
    argv = ["synthetic:16", "--batch-size", "4", "-a", "--synthetic-assets", "4"] + extra
    jdir, pdir = _copy(log_dir, tmp_path / "jax"), _copy(log_dir, tmp_path / "port")
    outputs = {}
    for name, main, d, device in (("jax", jevaluate.main, jdir, []), ("port", evaluate.main, pdir, ["--device", "cpu"])):
        outputs[name] = (str(tmp_path / f"{name}_renders"), str(tmp_path / f"{name}_deteval"))
        main([argv[0], d] + argv[1:] + device + ["--save-predictions", outputs[name][0],
                                                  "--deteval", outputs[name][1]])
    with open(os.path.join(jdir, "eval_results.json")) as f:
        want = json.load(f)
    with open(os.path.join(pdir, "eval_results.json")) as f:
        got = json.load(f)
    _assert_entries_match(got, want)
    assert all("mean_assessor_score" in e for e in got)
    if extra:
        assert max(e["map"] for e in want) > 0
    for iteration in (2, 4):
        renders = sorted(os.listdir(os.path.join(outputs["port"][0], str(iteration))))
        assert renders == sorted(os.listdir(os.path.join(outputs["jax"][0], str(iteration))))
        assert len(renders) == 16
        for name in renders:
            g = np.asarray(Image.open(os.path.join(outputs["port"][0], str(iteration), name)))
            w = np.asarray(Image.open(os.path.join(outputs["jax"][0], str(iteration), name)))
            assert g.shape == w.shape == (32, 32, 3)
            np.testing.assert_array_equal(g, w)
        trees = [ET.parse(os.path.join(outputs[k][1], f"deteval_{iteration}.xml")).getroot() for k in ("port", "jax")]
        images = [t.findall("image") for t in trees]
        assert len(images[0]) == len(images[1]) == 16
        for gi, wi in zip(*images):
            assert gi.findtext("imageName") == wi.findtext("imageName")
            gr, wr = gi.find("taggedRectangles"), wi.find("taggedRectangles")
            assert len(gr) == len(wr) == 1
            for k in ("x", "y", "width", "height"):
                assert abs(float(gr[0].get(k)) - float(wr[0].get(k))) <= 0.01 + 1e-6


def test_resume_and_force_reset_match_jax(log_dir, tmp_path, capsys):
    argv = ["synthetic:8", "--batch-size", "4"]
    jdir, pdir = _copy(log_dir, tmp_path / "jax"), _copy(log_dir, tmp_path / "port")
    counts = {}
    for name, main, d, device in (("jax", jevaluate.main, jdir, []), ("port", evaluate.main, pdir, ["--device", "cpu"])):
        counts[name] = []
        for flags in ([], [], ["--force-reset"]):
            capsys.readouterr()
            results = main([argv[0], d] + argv[1:] + device + flags)
            scored = [line.split(":")[0] for line in capsys.readouterr().out.splitlines() if ": map=" in line]
            counts[name].append(([os.path.splitext(s)[0] for s in scored], len(results.entries)))
        if name == "port":
            assert sorted(results.timings) == ["Localizer_2.pt", "Localizer_4.pt"]
            assert all(t["images"] == 8 and t["seconds"] > 0 for t in results.timings.values())
    assert counts["port"] == counts["jax"]
    assert counts["port"] == [(["Localizer_2", "Localizer_4"], 2), ([], 2), (["Localizer_2", "Localizer_4"], 2)]


def test_corrupt_snapshot_is_reported_and_the_sweep_goes_on(log_dir, tmp_path, capsys):
    pdir = _copy(log_dir, tmp_path / "port")
    os.remove(os.path.join(pdir, "Localizer_2.pt"))  # a link to the fixture's snapshot
    with open(os.path.join(pdir, "Localizer_2.pt"), "wb") as f:
        f.write(b"not a snapshot")
    results = evaluate.main(["synthetic:8", pdir, "-b", "4", "--device", "cpu"])
    out = capsys.readouterr()
    assert "evaluation of Localizer_2.pt failed" in out.out
    assert "Traceback" in out.err
    assert [e["snapshot_name"] for e in results.entries] == ["Localizer_4.pt"]


def test_assessor_without_snapshots_scores_nothing(log_dir, tmp_path):
    """With ``-a`` but no assessor snapshot, the JAX sweep scores no crop
    (unlike serving, which uses the initial parameters); so does the port."""
    jdir, pdir = _copy(log_dir, tmp_path / "jax"), _copy(log_dir, tmp_path / "port")
    for d in (jdir, pdir):
        for path in glob.glob(os.path.join(d, "ResnetAssessor_*")):
            os.remove(path)
    want = jevaluate.main(["synthetic:8", jdir, "-b", "4", "-a"]).entries
    got = evaluate.main(["synthetic:8", pdir, "-b", "4", "-a", "--device", "cpu"]).entries
    assert not any("mean_assessor_score" in e for e in want + got)
    _assert_entries_match(got, want)


def test_refusals(log_dir, tmp_path, monkeypatch):
    ssd = tmp_path / "ssd"
    checkpoint.save_manifest(str(ssd), {"localizer": {"model": "SSD300", "kwargs": {}}})
    with pytest.raises(NotImplementedError, match="item 12"):
        Evaluator(str(ssd), device="cpu")
    with pytest.raises(SystemExit, match="step 9b"):
        evaluate.main(["gt.json", log_dir, "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        evaluate.main(["synthetic:8", log_dir])


def test_plot_without_matplotlib_reports_the_best(log_dir, tmp_path, monkeypatch, capsys):
    pdir = _copy(log_dir, tmp_path / "port")
    ev = Evaluator(pdir, device="cpu")
    assert ev.plot() is None  # nothing scored yet: nothing to report
    ev.results.append({"snapshot_name": "Localizer_2.pt", "iteration": 2, "map": 0.25, "mean_iou": 0.5})
    ev.results.append({"snapshot_name": "Localizer_4.pt", "iteration": 4, "map": 0.5, "mean_iou": 0.25})
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    capsys.readouterr()
    assert ev.plot() is None
    out = capsys.readouterr().out
    assert "no metric curve drawn" in out and "best snapshot: Localizer_4.pt (map=0.5000)" in out
    assert not os.path.exists(os.path.join(pdir, "plot.png"))


def _actions(parser: argparse.ArgumentParser) -> dict:
    return {a.dest: (tuple(a.option_strings), a.default, a.nargs, a.type, a.choices, type(a).__name__)
            for a in parser._actions}


def test_parser_matches_jax():
    want, got = _actions(jevaluate.get_parser()), _actions(evaluate.get_parser())
    assert set(got) - set(want) == {"device"}
    assert {k: got[k] for k in want} == want
    assert got["device"][1] == "cuda"
