"""The serving slice of the PyTorch port against the JAX package, end to end.

A JAX log dir (manifest + ``.msgpack`` snapshots of a seeded R-18
Localizer at 64x64 -> 16x16 and a ResnetAssessor) is exported to ``.pt``
snapshots with ``tools/export_torch_snapshot.py``; then the JAX and the
port ``LocalizerInference`` answer the same frames on the CPU, with the
assessor gating on.

Tolerances: boxes 1e-3 px, rois 1e-4 and scores 1e-5 absolute. The
float32 networks differ only in summation order (see
``test_torch_models.py``), which moves theta by about 1e-6.
"""

import os
import shutil
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from loans_tpu import models as jmodels
from loans_tpu.inference import LocalizerInference as JaxInference
from loans_tpu.ops.geometry import Size as JSize
from loans_tpu.train import checkpoint as jax_checkpoint
from loans_tpu_torch.inference import LocalizerInference
from loans_tpu_torch.train import checkpoint

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import export_torch_snapshot  # noqa: E402
from test_torch_models import fit_head, random_variables  # noqa: E402

MANIFEST = {
    "localizer": {
        "model": "Localizer",
        "kwargs": {
            "out_size": [16, 16],
            "n_layers": 18,
            "input_size": [64, 64],
            "rotation_dropout_ratio": 0.0,
            "transform_rois_to_grayscale": False,
        },
    },
    "assessor": {"model": "ResnetAssessor", "kwargs": {}},
    "snapshot_names": ["Localizer", "ResnetAssessor"],
}


def scenes(seed, n, size=64):
    """Noise backgrounds, each with one bright rectangle pasted in."""
    rng = np.random.default_rng(seed)
    frames = rng.uniform(0.0, 0.5, size=(n, size, size, 3)).astype(np.float32)
    for f in frames:
        y, x = rng.integers(0, size // 2, 2)
        h, w = rng.integers(size // 4, size // 2, 2)
        f[y : y + h, x : x + w] = rng.uniform(0.7, 1.0, 3)
    return frames


@pytest.fixture(scope="module")
def log_dir(tmp_path_factory):
    log_dir = str(tmp_path_factory.mktemp("jax_log"))
    jax_checkpoint.save_manifest(log_dir, MANIFEST)
    loc = jmodels.Localizer(out_size=JSize(16, 16), n_layers=18, input_size=JSize(64, 64))
    x = jnp.asarray(scenes(9, 8))
    for iteration, seed in ((2, 20), (5, 21)):  # the export takes the latest
        v = fit_head(loc, random_variables(loc, x, seed=seed, train=False), x, seed=seed)
        jax_checkpoint.save_params(
            os.path.join(log_dir, f"Localizer_{iteration}.msgpack"),
            v["params"],
            v["batch_stats"],
        )
    a = random_variables(jmodels.ResnetAssessor(), jnp.zeros((1, 16, 16, 3)), seed=22)
    jax_checkpoint.save_params(os.path.join(log_dir, "ResnetAssessor_5.msgpack"), a["params"])
    export_torch_snapshot.main([log_dir])
    return log_dir


def test_export_writes_latest_pt_snapshots(log_dir):
    assert [p for _, p in checkpoint.list_snapshots(log_dir, "Localizer_")] == [
        os.path.join(log_dir, "Localizer_5.pt")
    ]
    assert checkpoint.list_snapshots(log_dir, "ResnetAssessor_")[0][0] == 5
    state = checkpoint.load_params(os.path.join(log_dir, "Localizer_5.pt"))
    assert state["param_predictor.weight"].shape == (6, 512)


def test_export_raises_without_snapshots(tmp_path):
    jax_checkpoint.save_manifest(str(tmp_path), MANIFEST)
    with pytest.raises(FileNotFoundError, match="Localizer"):
        export_torch_snapshot.export(str(tmp_path))


def test_localize_batch_matches_jax_with_gating(log_dir):
    frames = scenes(0, 6)
    ref = JaxInference(log_dir, use_assessor=True, score_threshold=0.0)
    port = LocalizerInference(log_dir, device="cpu", use_assessor=True, score_threshold=0.0)
    # Gate at the middle of the widest gap between the reference's scores,
    # so some frames fall below the threshold and none sits on it.
    raw = np.sort(ref.localize_batch(frames)[2])
    gap = int(np.argmax(np.diff(raw)))
    ref.score_threshold = port.score_threshold = float(raw[gap] + raw[gap + 1]) / 2

    want_boxes, want_rois, want_scores, _ = ref.localize_batch(frames)
    boxes, rois, scores, heat = port.localize_batch(frames)
    assert heat is None
    assert boxes.shape == (6, 1, 4) and rois.shape == (6, 16, 16, 3) and scores.shape == (6,)
    gated = np.asarray(want_scores) == 0.0
    assert 0 < gated.sum() < 6
    np.testing.assert_array_equal(scores == 0.0, gated)
    assert np.ptp(np.asarray(want_boxes)[:, 0, 0]) > 1.0  # boxes differ per frame
    np.testing.assert_allclose(boxes, np.asarray(want_boxes), atol=1e-3)
    np.testing.assert_allclose(rois, np.asarray(want_rois), atol=1e-4)
    np.testing.assert_allclose(scores, np.asarray(want_scores), atol=1e-5)


def test_localize_matches_jax_and_batch(log_dir):
    frames = scenes(1, 2)
    ref = JaxInference(log_dir, use_assessor=True, score_threshold=0.0)
    port = LocalizerInference(log_dir, device="cpu", use_assessor=True, score_threshold=0.0)
    handle = port.localize_batch(list(frames), sync=False)
    batch_boxes, _, batch_scores, _ = port.finish_batch(handle)
    for i, frame in enumerate(frames):
        boxes, rois, scores, heat = port.localize(frame)
        want_boxes, want_rois, want_scores, _ = ref.localize(frame)
        assert heat is None and boxes.shape == (1, 4)
        np.testing.assert_allclose(boxes, np.asarray(want_boxes), atol=1e-3)
        np.testing.assert_allclose(rois, np.asarray(want_rois), atol=1e-4)
        np.testing.assert_allclose(scores, np.asarray(want_scores), atol=1e-5)
        # batch 1 against batch 2: same float32 sums in another blocking
        np.testing.assert_allclose(boxes, batch_boxes[i], atol=1e-3)
        np.testing.assert_allclose(scores, batch_scores[i : i + 1], atol=1e-5)


def test_without_assessor_scores_are_one(log_dir):
    port = LocalizerInference(log_dir, device="cpu")
    boxes, _, scores, _ = port.localize_batch(scenes(2, 3))
    np.testing.assert_array_equal(scores, 1.0)
    assert np.isfinite(boxes).all()
    assert port.scale_boxes(boxes[0], (2.0, 3.0)).tolist() == (boxes[0] * [2, 3, 2, 3]).tolist()


def test_unported_options_and_missing_snapshots_raise(log_dir, tmp_path):
    """An SSD log dir is refused, naming the wrapper that serves it
    (``SSDInference``); a log dir without localizer snapshots raises."""
    ssd = tmp_path / "ssd"
    checkpoint.save_manifest(str(ssd), {"localizer": {"model": "SSD300", "kwargs": {}}})
    with pytest.raises(KeyError, match="SSD300.*Localizer"):
        LocalizerInference(str(ssd), device="cpu")
    checkpoint.save_manifest(str(tmp_path), MANIFEST)
    with pytest.raises(FileNotFoundError, match="Localizer"):
        LocalizerInference(str(tmp_path), device="cpu")


def test_visual_backprop_is_served_like_jax(log_dir):
    """``use_visual_backprop=True`` serves the heat map in the last tuple
    position, as the JAX package does: one (H, W, 3) uint8 gray image per
    frame from ``localize_batch``, one from ``localize``, and the other
    positions unchanged. The float heat maps agree within 1e-5 (they lie in
    [0, 1]; see ``test_torch_visual_backprop.py``), so the uint8 images,
    which truncate 255 * heat, differ by at most one step where a value
    sits within that of an integer."""
    frames = scenes(6, 3)
    ref = JaxInference(log_dir, use_assessor=True, score_threshold=0.0, use_visual_backprop=True)
    port = LocalizerInference(log_dir, device="cpu", use_assessor=True, score_threshold=0.0,
                              use_visual_backprop=True)
    plain = LocalizerInference(log_dir, device="cpu", use_assessor=True, score_threshold=0.0)
    want = ref.localize_batch(frames)
    got = port.localize_batch(frames)
    for g, p in zip(got[:3], plain.localize_batch(frames)[:3]):
        np.testing.assert_array_equal(g, p)  # boxes, rois, scores: as without VisualBackprop
    np.testing.assert_allclose(got[0], np.asarray(want[0]), atol=1e-3)
    assert len(got[3]) == len(want[3]) == 3
    for g, w in zip(got[3], want[3]):
        assert g.shape == w.shape == (64, 64, 3) and g.dtype == np.uint8
        assert int(np.abs(g.astype(int) - w.astype(int)).max()) <= 1
        assert np.array_equal(g[..., 0], g[..., 2])  # gray
    assert int(np.ptp(got[3][0])) > 100  # a heat map, not a constant
    heat = port._predict(frames)[3].numpy()
    want_heat = np.asarray(ref._predict(ref._variables, jnp.asarray(frames))[3])
    assert heat.shape == (3, 64, 64, 1)
    np.testing.assert_allclose(heat, want_heat, rtol=0, atol=1e-5)
    boxes, rois, scores, heat_img = port.localize(frames[1])
    want_boxes, _, _, want_img = ref.localize(frames[1])
    assert boxes.shape == (1, 4) and rois.shape == (1, 16, 16, 3) and scores.shape == (1,)
    np.testing.assert_allclose(boxes, np.asarray(want_boxes), atol=1e-3)
    assert heat_img.shape == (64, 64, 3) and int(np.abs(heat_img.astype(int) - want_img.astype(int)).max()) <= 1


def test_missing_assessor_snapshot_is_served_with_initial_parameters(log_dir, tmp_path):
    """A log dir with localizer snapshots but no assessor snapshot: the JAX
    package serves it with the assessor's initial parameters (``key(0)``),
    and so does the port (seed 0, with a warning). The initialisers differ,
    so only the boxes are held to JAX; the port's scores are pinned by
    being finite and the same for two constructions; the assessor's
    initialisation draws nothing from the global random stream."""
    bare = tmp_path / "no_assessor"
    shutil.copytree(log_dir, bare, ignore=shutil.ignore_patterns("ResnetAssessor_*"))
    assert not checkpoint.list_snapshots(str(bare), "ResnetAssessor_")
    frames = scenes(4, 5)
    want_boxes, _, _, _ = JaxInference(str(bare), use_assessor=True, score_threshold=0.0).localize_batch(frames)
    got = []
    for _ in range(2):
        stream = torch.random.get_rng_state()
        LocalizerInference(str(bare), device="cpu")  # the localizer alone
        without = torch.random.get_rng_state()
        torch.random.set_rng_state(stream)
        with pytest.warns(UserWarning, match="no ResnetAssessor_.*no_assessor"):
            port = LocalizerInference(str(bare), device="cpu", use_assessor=True, score_threshold=0.0)
        assert torch.equal(torch.random.get_rng_state(), without)
        got.append(port.localize_batch(frames))
    (boxes, _, scores, _), (_, _, scores_again, _) = got
    np.testing.assert_allclose(boxes, np.asarray(want_boxes), atol=1e-3)
    assert scores.shape == (5,) and np.isfinite(scores).all()
    np.testing.assert_array_equal(scores, scores_again)
    # the localizer snapshot is still required
    os.remove(bare / "Localizer_5.pt")
    with pytest.raises(FileNotFoundError, match="Localizer"):
        LocalizerInference(str(bare), device="cpu", use_assessor=True)


def test_image_cli_on_cpu(log_dir, tmp_path, capsys):
    cv2 = pytest.importorskip("cv2")
    from loans_tpu_torch.cli.image_inference import main

    frame = (scenes(3, 1, size=80)[0][..., ::-1] * 255).astype(np.uint8)
    path = str(tmp_path / "scene.png")
    cv2.imwrite(path, frame)
    out_dir = tmp_path / "out"
    main([log_dir, "-i", path, "-o", str(out_dir), "-a", "--device", "cpu"])
    assert cv2.imread(str(out_dir / "scene.png")).shape == frame.shape
    assert "scene.png: box=" in capsys.readouterr().out
