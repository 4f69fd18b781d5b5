"""In-training evaluation of the port against the JAX package.

``MAPEvaluator`` on the same weights (carried through the bridge) and the
same val batches gives JAX's mean IoU and VOC mAP, with ``bn_warmup`` 0
and 2; the warm-up leaves the live model's BatchNorm statistics as they
were. The gt boxes are the JAX localizer's own eval boxes moved by seeded
offsets, so that some predictions hit (IoU >= 0.5) and some miss and the
mAP is neither 0 nor 1. ``eval_detection_voc`` and ``AccuracyAccumulator``
(copies of the JAX package's) match it on random boxes.

Tolerances: mean IoU 1e-5 absolute (theta agrees to float32 rounding, a
box to ~1e-5 px on a 64 px image; measured 6e-8); mAP exactly equal
(no IoU lies within 1e-3 of the 0.5 threshold, checked).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import random_variables  # noqa: E402

from loans_tpu import models as jmodels
from loans_tpu.evaluation import intraining as jintraining
from loans_tpu.evaluation import metrics as jmetrics
from loans_tpu.evaluation import voc as jvoc
from loans_tpu.ops import geometry as jgeo
from loans_tpu.ops.geometry import Size as JSize
from loans_tpu.train import state as jstate
from loans_tpu_torch import bridge, models
from loans_tpu_torch.evaluation import AccuracyAccumulator, MAPEvaluator, eval_detection_voc
from loans_tpu_torch.ops.geometry import Size
from loans_tpu_torch.train import create_train_state

IMG, CROP, N_BATCHES, BATCH = 64, 16, 3, 6


@pytest.fixture(scope="module")
def setup():
    jl = jmodels.Localizer(out_size=JSize(CROP, CROP), n_layers=18, input_size=JSize(IMG, IMG))
    variables = random_variables(jl, jnp.zeros((2, IMG, IMG, 3)), seed=3, train=False, head_std=3e-6)
    tx = jstate.adam_amsgrad(1e-3)
    jstate_ = jstate.TrainState(
        step=jnp.zeros((), jnp.int32), params=jax.tree.map(jnp.asarray, variables["params"]),
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
        opt_state=tx.init(variables["params"]), tx=tx)
    loc = models.Localizer(out_size=Size(CROP, CROP), n_layers=18, input_size=Size(IMG, IMG))
    loc.load_state_dict(bridge.localizer_state_dict(loc, variables["params"], variables["batch_stats"]))
    rng = np.random.default_rng(7)
    images = rng.integers(0, 256, (N_BATCHES * BATCH, IMG, IMG, 3), dtype=np.uint8)
    # gt: JAX's own eval boxes moved by up to 40% of their size
    theta = jintraining.make_eval_step(jl, JSize(IMG, IMG))(jstate_, images)
    pred = np.asarray(jgeo.corners_to_aabb(jgeo.theta_corners(theta), JSize(IMG, IMG), clip=True))
    size = np.concatenate([pred[:, 2:] - pred[:, :2]] * 2, axis=1)
    gt = pred + rng.uniform(-0.4, 0.4, pred.shape) * size
    gt = np.concatenate([np.minimum(gt[:, :2], gt[:, 2:] - 1), np.maximum(gt[:, 2:], gt[:, :2] + 1)], 1)
    gt = gt.astype(np.float32)
    pad = np.zeros_like(gt)  # a padding row of zeros, as padded val batches carry
    boxes = np.stack([gt, pad], axis=1)
    batches = [(images[i * BATCH:(i + 1) * BATCH], boxes[i * BATCH:(i + 1) * BATCH]) for i in range(N_BATCHES)]
    return jl, jstate_, loc, batches


@pytest.mark.parametrize("bn_warmup", [0, 2])
def test_map_evaluator_matches_jax(setup, bn_warmup):
    jl, jstate_, loc, batches = setup
    want = jintraining.MAPEvaluator(jl, JSize(IMG, IMG), max_batches=N_BATCHES, bn_warmup=bn_warmup)(
        jstate_, iter(batches))
    state = create_train_state(loc)
    before = {k: v.clone() for k, v in loc.state_dict().items()}
    evaluator = MAPEvaluator(Size(IMG, IMG), max_batches=N_BATCHES, bn_warmup=bn_warmup)
    got = evaluator(state, iter([(torch.from_numpy(b[0]), b[1]) for b in batches]))
    assert set(got) == set(want)
    assert abs(got["mean_iou"] - want["mean_iou"]) <= 1e-5
    assert got["map"] == want["map"] and got["ap/object"] == want["ap/object"]
    assert 0.0 < want["map"] < 1.0 and want["mean_iou"] > 0.2
    assert evaluator.forwards == N_BATCHES
    for k, v in loc.state_dict().items():  # the live statistics are untouched
        assert torch.equal(v, before[k]), k
    assert loc.training  # the model's mode is restored


def test_map_evaluator_scores_crops_like_jax(setup):
    """With an assessor, the eval crops are scored too: the same mean
    score as JAX's (1e-5 absolute; float32 on both sides)."""
    jl, jstate_, loc, batches = setup
    ja = jmodels.ResnetAssessor(ch=8)
    ass_v = random_variables(ja, jnp.zeros((2, CROP, CROP, 3)), seed=4)
    want = jintraining.MAPEvaluator(jl, JSize(IMG, IMG), max_batches=2, assessor=ja)(
        jstate_, iter(batches), ass_params=jax.tree.map(jnp.asarray, ass_v["params"]))
    ass = models.ResnetAssessor(ch=8, in_size=Size(CROP, CROP))
    ass.load_state_dict(bridge.assessor_state_dict(ass, ass_v["params"]))
    got = MAPEvaluator(Size(IMG, IMG), max_batches=2)(
        create_train_state(loc), iter([(torch.from_numpy(b[0]), b[1]) for b in batches]), assessor=ass)
    assert set(got) == set(want)
    assert abs(got["mean_assessor_score"] - want["mean_assessor_score"]) <= 1e-5
    assert abs(got["mean_iou"] - want["mean_iou"]) <= 1e-5


def test_map_evaluator_thresholds_are_clear(setup):
    """No IoU within 1e-3 of 0.5, so exact mAP equality is meaningful."""
    jl, jstate_, loc, batches = setup
    ious = []
    for images, gt in batches:
        theta = jintraining.make_eval_step(jl, JSize(IMG, IMG))(jstate_, images)
        pred = np.asarray(jgeo.corners_to_aabb(jgeo.theta_corners(theta), JSize(IMG, IMG), clip=True))
        ious += [float(jvoc._bbox_iou(pred[i:i + 1].astype(np.float64), gt[i, :1].astype(np.float64)).max())
                 for i in range(len(pred))]
    assert min(abs(np.asarray(ious) - 0.5)) > 1e-3


def test_max_batches_zero_scores_nothing(setup):
    _, _, loc, batches = setup
    got = MAPEvaluator(Size(IMG, IMG), max_batches=0)(create_train_state(loc), iter(batches))
    assert got == {"mean_iou": 0.0, "map": 0.0}


def _random_boxes(rng, n):
    tl = rng.uniform(0, 50, (n, 2))
    return np.concatenate([tl, tl + rng.uniform(1, 30, (n, 2))], axis=1)


@pytest.mark.parametrize("use_07", [False, True])
def test_eval_detection_voc_matches_jax(use_07):
    rng = np.random.default_rng(11)
    args = [[], [], [], [], [], []]
    for _ in range(20):
        n_pred, n_gt = rng.integers(0, 5), rng.integers(0, 4)
        args[0].append(_random_boxes(rng, n_pred))
        args[1].append(rng.integers(0, 3, n_pred))
        args[2].append(rng.uniform(size=n_pred))
        args[3].append(_random_boxes(rng, n_gt))
        args[4].append(rng.integers(0, 3, n_gt))
        args[5].append(rng.uniform(size=n_gt) < 0.2)
    got = eval_detection_voc(*args, iou_thresh=0.3, use_07_metric=use_07)
    want = jvoc.eval_detection_voc(*args, iou_thresh=0.3, use_07_metric=use_07)
    np.testing.assert_array_equal(got["ap"], want["ap"])
    assert got["map"] == want["map"]


def test_accuracy_accumulator_matches_jax():
    rng = np.random.default_rng(12)
    got, want = AccuracyAccumulator(0.5), jmetrics.AccuracyAccumulator(0.5)
    for i in range(30):
        low = 1 if i % 3 == 0 else 0
        pred, gt = _random_boxes(rng, rng.integers(low, 3)), _random_boxes(rng, rng.integers(low, 3))
        if i % 3 == 0:
            gt[0] = pred[0] + rng.uniform(-2, 2, 4)  # some hits
        assert got.add(pred, gt) == want.add(pred, gt)
    assert got.summary() == want.summary()
    assert 0 < got.hits < got.n_images


def test_map_evaluator_warms_a_rotation_dropout_localizer_like_jax(setup):
    """``bn_warmup`` on a localizer with rotation dropout at 0 < ratio < 1:
    the warm-up forwards run in train mode, where the port's rotation
    dropout needs a generator and raised without one; they now run the
    backbone alone (``Localizer.features``), which is all the statistics
    see, and the result is JAX's (which draws from ``key(0)`` there)."""
    _, jstate_, loc, batches = setup
    jl = jmodels.Localizer(out_size=JSize(CROP, CROP), n_layers=18, input_size=JSize(IMG, IMG),
                           rotation_dropout_ratio=0.5)
    want = jintraining.MAPEvaluator(jl, JSize(IMG, IMG), max_batches=N_BATCHES, bn_warmup=2)(
        jstate_, iter(batches))
    rotated = models.Localizer(out_size=Size(CROP, CROP), n_layers=18, input_size=Size(IMG, IMG),
                               rotation_dropout_ratio=0.5)
    rotated.load_state_dict(loc.state_dict())
    got = MAPEvaluator(Size(IMG, IMG), max_batches=N_BATCHES, bn_warmup=2)(
        create_train_state(rotated), iter([(torch.from_numpy(b[0]), b[1]) for b in batches]))
    assert set(got) == set(want)
    assert abs(got["mean_iou"] - want["mean_iou"]) <= 1e-5
    assert got["map"] == want["map"] and got["ap/object"] == want["ap/object"]
