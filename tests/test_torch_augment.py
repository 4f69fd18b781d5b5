"""The port's host augmentation against the JAX package's, on the CPU.

* ``data/augment.py``: each numpy operator, the two imgaug-style pipelines
  and ``random_crop_flip`` give the JAX package's images exactly from a
  generator of the same seed (the same draws in the same order), over
  many seeds; ``crop_and_pad`` resizes with ``cv_resize`` where the JAX
  package calls cv2, and the HSV shift calls cv2 in both.
* ``data/cv_resize.py``: ``resize_linear`` equals ``cv2.resize(img, (w,
  h))`` (``INTER_LINEAR``) bit for bit over a hypothesis sweep of sizes
  and channel counts, the exact 2x shrink (OpenCV's ``INTER_AREA``), the
  same size and the SSD's sizes included.
* ``data/ssd_augment.py``: ``SSDTransform`` and ``SSDDataset`` give the
  JAX package's encoded tuples exactly, with and without augmentation,
  on the same gt json and seeds; without cv2 the augmenting transform is
  refused by name and ``augment=False`` runs.
"""

import json
import sys

import cv2
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from loans_tpu.data import augment as jaug
from loans_tpu.data import ssd_augment as jssd_aug
from loans_tpu.models import ssd as jssd
from loans_tpu_torch.data import augment, ssd_augment
from loans_tpu_torch.data.cv_resize import resize_linear
from loans_tpu_torch.ops.multibox import MultiboxCoder


def _images(seed, n=4, h=37, w=29):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h + i, w + 2 * i, 3), dtype=np.uint8) for i in range(n)]


def _same(a, b):
    if isinstance(b, tuple):
        assert isinstance(a, tuple) and len(a) == len(b)
        for u, v in zip(a, b):
            _same(u, v)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["fliplr", "crop_and_pad", "contrast_normalization", "multiply",
                                  "add_to_hue_and_saturation"])
def test_operators_match_jax(name):
    for seed in range(20):
        for img in _images(seed):
            got = getattr(augment, name)(img, np.random.default_rng(seed))
            want = getattr(jaug, name)(img, np.random.default_rng(seed))
            _same(got, want)


@pytest.mark.parametrize("pipeline", ["unlabeled_pipeline", "labeled_pipeline"])
def test_pipelines_match_jax(pipeline):
    got_rng, want_rng = np.random.default_rng(7), np.random.default_rng(7)
    got_p, want_p = getattr(augment, pipeline)(0.8), getattr(jaug, pipeline)(0.8)
    for img in _images(1, n=40):
        _same(got_p(img, got_rng), want_p(img, want_rng))
    assert got_rng.uniform() == want_rng.uniform()  # the same number of draws


def test_random_crop_flip_matches_jax():
    for crop_always in (False, True):
        got_rng, want_rng = np.random.default_rng(3), np.random.default_rng(3)
        for img in _images(2, n=30):
            _same(augment.random_crop_flip(img, got_rng, 0.7, crop_always=crop_always),
                  jaug.random_crop_flip(img, want_rng, 0.7, crop_always=crop_always))


def test_hsv_needs_cv2(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="add_to_hue_and_saturation.*cv2"):
        augment.add_to_hue_and_saturation(_images(0)[0], np.random.default_rng(0))
    augment.crop_and_pad(_images(0)[0], np.random.default_rng(0))  # numpy only


@settings(max_examples=200, deadline=None)
@given(h=st.integers(1, 90), w=st.integers(1, 90), oh=st.integers(1, 120), ow=st.integers(1, 120),
       channels=st.sampled_from([0, 1, 3, 4]), seed=st.integers(0, 2**16))
def test_resize_linear_is_cv2_s(h, w, oh, ow, channels, seed):
    rng = np.random.default_rng(seed)
    shape = (h, w) if channels == 0 else (h, w, channels)
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    for size in [(ow, oh), (max(w // 2, 1), max(h // 2, 1)), (2 * w, 2 * h), (w, h)]:
        _same(resize_linear(img, size), cv2.resize(img, size))


@pytest.mark.parametrize("hw,size", [((375, 500), 300), ((600, 800), 512), ((224, 224), 300), ((448, 448), 224),
                                     ((1000, 700), 300), ((300, 300), 300)])
def test_resize_linear_at_the_ssd_sizes(hw, size):
    img = np.random.default_rng(0).integers(0, 256, (*hw, 3), dtype=np.uint8)
    _same(resize_linear(img, (size, size)), cv2.resize(img, (size, size)))


@pytest.fixture(scope="module")
def coders():
    jcoder = jssd.SSD300().coder()
    return MultiboxCoder(jcoder.default_bbox), jcoder


@pytest.fixture(scope="module")
def gt_json(tmp_path_factory):
    root = tmp_path_factory.mktemp("gt")
    rng = np.random.default_rng(5)
    records = []
    for i in range(6):
        h, w = 60 + 7 * i, 80 - 5 * i
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(root / f"{i}.png")
        boxes = [[h * 0.1, w * 0.2, h * 0.6, w * 0.7], [h * 0.4, w * 0.05, h * 0.9, w * 0.5]][: 1 + i % 2]
        records.append({"image": f"{i}.png", "bounding_boxes": boxes})
    (root / "gt.json").write_text(json.dumps(records))
    return str(root / "gt.json")


@pytest.mark.parametrize("augment_on", [False, True])
def test_ssd_transform_matches_jax(coders, augment_on):
    coder, jcoder = coders
    got_t = ssd_augment.SSDTransform(coder, 300, seed=4, augment=augment_on)
    want_t = jssd_aug.SSDTransform(jcoder, 300, seed=4, augment=augment_on)
    for i, img in enumerate(_images(9, n=12, h=90, w=110)):
        box = np.array([[10 + i, 12, 60, 80 + i], [30, 5, 85, 40]], np.float32)[: 1 + i % 2]
        img_in = img if i % 3 else img.astype(np.float32) / 255.0  # uint8 or float in [0, 1]
        _same(got_t(img_in, box), want_t(img_in, box))


@pytest.mark.parametrize("augment_on", [False, True])
def test_ssd_dataset_matches_jax(coders, gt_json, augment_on):
    coder, jcoder = coders
    got = ssd_augment.SSDDataset(gt_json, coder, 300, seed=1, augment=augment_on)
    want = jssd_aug.SSDDataset(gt_json, jcoder, 300, seed=1, augment=augment_on)
    assert len(got) == len(want) == 6
    for i in range(len(want)):
        _same(got[i], want[i])


def test_ssd_augment_needs_cv2_and_no_augment_does_not(coders, gt_json, monkeypatch):
    coder, _ = coders
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="random_distort.*--no-augment runs without it.*cv2"):
        ssd_augment.SSDDataset(gt_json, coder, 300, augment=True)[0]
    img, loc, conf = ssd_augment.SSDDataset(gt_json, coder, 300, augment=False)[0]
    assert img.shape == (300, 300, 3) and loc.shape == (len(coder.default_bbox), 4) and (conf > 0).any()
