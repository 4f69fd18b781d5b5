"""A run of each cell, at a tiny size on the CPU past the harness's look
for a card, comes out correct, and comes out not correct with the timed
path broken underneath: a step that leaves its state unchanged, half of
each batch left out (the mean taken over the rest), and an answer altered
where it is produced. (One card: no exchange between cards to leave out.)"""

from __future__ import annotations

import pytest
import torch

from perfbench.tests.conftest import run


@pytest.fixture
def two_steps(tiny_cells):
    """The training cell compared over its first two steps: at this size the
    third step's losses swing with round-off (Adam's first update moves
    theta by ~1.6, out of the 32^2 image)."""
    cell = tiny_cells["train"]
    cell["traffic"]["checked_steps"] = 2
    return cell


def test_sound_training_run_is_correct(two_steps, tiny_config, spec):
    line = run(two_steps, tiny_config, spec)
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks" and line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["metrics"]) == {"train_images_per_s", "setup_s"}


def test_training_state_left_unchanged_is_caught(two_steps, tiny_config, spec, monkeypatch):
    from loans_tpu_torch.train.state import TrainState

    monkeypatch.setattr(TrainState, "apply_gradients", lambda self: self)
    line = run(two_steps, tiny_config, spec)
    assert not line["correct"]
    assert line["checks"]["change_median_gap"]["value"] > 0.99  # nothing moved


def test_half_of_the_batch_is_caught(two_steps, tiny_config, spec, monkeypatch):
    from loans_tpu_torch.train import steps

    real = steps.gather_batch

    def half(chunk, t):
        return {k: v[: len(v) // 2] for k, v in real(chunk, t).items()}

    monkeypatch.setattr(steps, "gather_batch", half)
    line = run(two_steps, tiny_config, spec)
    assert not line["correct"]
    assert line["checks"]["loss1_rel"]["value"] > line["checks"]["loss1_rel"]["limit"]


def test_sound_serving_run_is_correct(tiny_cells, tiny_config, spec):
    line = run(tiny_cells["serve"], tiny_config, spec)
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {"serve_images_per_s", "serve_batch_ms_p95", "setup_s"}


@pytest.mark.parametrize("what", ["box", "score"])
def test_an_altered_answer_is_caught(what, tiny_cells, tiny_config, spec, monkeypatch):
    from loans_tpu_torch.inference import localizer
    from loans_tpu_torch.models import ResnetAssessor

    if what == "box":
        real = localizer.corners_to_aabb
        monkeypatch.setattr(localizer, "corners_to_aabb", lambda *a, **k: real(*a, **k) + 0.5)
        # every frame open, so that each box is compared
        tiny_cells["serve"]["traffic"]["score_threshold"] = 0.0
    else:
        forward = ResnetAssessor.forward
        monkeypatch.setattr(ResnetAssessor, "forward", lambda self, x, features=None: forward(self, x) + 0.01)
    line = run(tiny_cells["serve"], tiny_config, spec)
    assert not line["correct"]


def test_traced_run_reports_per_layer_metrics_only(tiny_cells, tiny_config, spec):
    line = run(tiny_cells["serve"], tiny_config, spec, trace=True)
    # off the card no reader finds device activity, so every per-layer metric is left out
    assert line["metrics"] == {} and line["device"]["window_s"] > 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
