"""The port's media helpers, score text, PCA dots and receptive fields
against the JAX package's, on the CPU.

* ``insights/media.py``: ``list_frames`` orders as JAX's; ``make_gif`` is
  byte-equal to JAX's on the same PNG frames (read by ``data/png.py``
  instead of Pillow, encoded by the same Pillow), also strided and resized;
  ``make_video`` writes the frames JAX's writes (``cv2.VideoWriter``
  replaced by a recorder), odd-sized frames cut to even sizes by the
  port's BICUBIC (``data/image_ops.py``) as JAX's Pillow does.
* ``insights/rendering.py``: ``draw_boxes_on_image`` with ``scores`` equals
  JAX's Pillow render pixel for pixel (outlines that cover an earlier
  score included); ``fill_ellipse`` equals Pillow's
  ``ellipse([cx - 3, cy - 3, cx + 3, cy + 3])`` at any center, clipped at
  the borders; without Pillow, text is refused by name.
* ``utils/receptive_field.py`` equals JAX's on the R-18 and R-50 ladders
  and the localizer's ladders with ``res6``/``res7``.
"""

import os
import sys

import cv2
import numpy as np
import pytest
from PIL import Image, ImageDraw

from loans_tpu.insights import media as jmedia
from loans_tpu.insights import rendering as jrendering
from loans_tpu.models.resnet import resnet_vbp_ladder as jax_resnet_ladder
from loans_tpu.utils import receptive_field as jrf
from loans_tpu_torch.insights import media, rendering
from loans_tpu_torch.models.localizer import localizer_vbp_ladder
from loans_tpu_torch.models.resnet import resnet_vbp_ladder
from loans_tpu_torch.ops import Size
from loans_tpu_torch.utils import receptive_field as rf


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """Eleven renders of 45x67 (odd sides), named as the plotter names them."""
    root = tmp_path_factory.mktemp("bboxes")
    rng = np.random.default_rng(0)
    for it in (0, 2, 4, 6, 8, 10, 12, 14, 16, 18, 100):
        img = rng.integers(0, 256, (45, 67, 3), dtype=np.uint8)
        img[10:30, 20:50] = rng.integers(0, 256, 3)
        rendering.write_png(str(root / f"{it}.png"), img, filters=it % 5)
    (root / "notes.txt").write_text("not a frame")
    return str(root)


def test_list_frames_matches_jax(frames):
    assert media.list_frames(frames) == jmedia.list_frames(frames)
    assert [os.path.basename(p) for p in media.list_frames(frames)][-2:] == ["18.png", "100.png"]


@pytest.mark.parametrize("kw", [{}, {"fps": 4, "max_frames": 4}, {"resize_to": (30, 21)}])
def test_make_gif_is_byte_equal(frames, tmp_path, kw):
    want = jmedia.make_gif(frames, str(tmp_path / "jax.gif"), **kw)
    got = media.make_gif(frames, str(tmp_path / "port.gif"), **kw)
    with open(got, "rb") as g, open(want, "rb") as w:
        assert g.read() == w.read()
    with pytest.raises(ValueError, match="no frames"):
        media.make_gif(str(tmp_path), str(tmp_path / "none.gif"))


def test_make_video_writes_jax_frames(frames, tmp_path, monkeypatch):
    written = {}

    class Recorder:
        def __init__(self, path, fourcc, fps, size):
            written[path] = (fourcc, fps, size, [])

        def write(self, frame):
            written[next(reversed(written))][3].append(frame.copy())

        def release(self):
            pass

    monkeypatch.setattr(cv2, "VideoWriter", Recorder)
    jmedia.make_video(frames, str(tmp_path / "jax.mp4"), fps=12)
    media.make_video(frames, str(tmp_path / "port.mp4"), fps=12)
    (jf, jfps, jsize, jframes), (pf, pfps, psize, pframes) = written.values()
    assert (pf, pfps, psize) == (jf, jfps, jsize) and psize == (66, 44)
    assert len(pframes) == len(jframes) == 11
    assert all(np.array_equal(p, j) for p, j in zip(pframes, jframes))


def test_score_text_matches_jax():
    rng = np.random.default_rng(1)
    img = rng.uniform(size=(60, 80, 3)).astype(np.float32)
    # the third box's outline runs over the first box's score
    boxes = np.array([[20, 5, 40, 30], [25.5, 15.2, 50.9, 70.6], [3.7, 2.2, 9.9, 60.1], [55, 60, 59, 79]])
    scores = np.array([0.912, 0.5, 0.1234, 0.0])
    for s in (scores, scores[:2]):  # fewer scores than boxes: the rest unscored
        want = np.asarray(jrendering.draw_boxes_on_image(img, boxes, gt_boxes=boxes[:1] + 1, scores=s))
        got = rendering.draw_boxes_on_image(img, boxes, gt_boxes=boxes[:1] + 1, scores=s)
        np.testing.assert_array_equal(got, want)
    canvas = np.zeros((20, 90, 3), np.uint8)
    rendering.draw_text(canvas, (4, 6), "assessor: 0.123", rendering.COLOR_MAP[0])
    pil = Image.new("RGB", (90, 20))
    ImageDraw.Draw(pil).text((4, 6), "assessor: 0.123", fill=rendering.COLOR_MAP[0])
    np.testing.assert_array_equal(canvas, np.asarray(pil))


def test_ellipse_stamp_matches_pillow():
    rng = np.random.default_rng(2)
    for size in (5, 16, 48):
        pil = Image.new("RGB", (size, size), (255, 255, 255))
        draw = ImageDraw.Draw(pil)
        got = np.full((size, size, 3), 255, np.uint8)
        for i in range(40):
            cx, cy = (int(v) for v in rng.integers(-5, size + 5, 2))
            color = rendering.COLOR_MAP[i % len(rendering.COLOR_MAP)]
            draw.ellipse([cx - 3, cy - 3, cx + 3, cy + 3], fill=color)
            rendering.fill_ellipse(got, cx, cy, color)
        np.testing.assert_array_equal(got, np.asarray(pil))


def test_text_without_pillow_is_refused(monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    img = np.zeros((20, 20, 3), np.uint8)
    with pytest.raises(RuntimeError, match="Pillow is not installed"):
        rendering.draw_text(img, (0, 0), "0.50", (255, 0, 0))
    with pytest.raises(RuntimeError, match="Pillow is not installed"):
        rendering.draw_boxes_on_image(img, np.array([[2, 2, 9, 9]]), scores=[0.5])
    assert rendering.draw_boxes_on_image(img, np.array([[2, 2, 9, 9]])).any()  # outlines need no Pillow


@pytest.mark.parametrize("ladder", ["R-18", "R-50", "R-18 localizer 320", "R-50 localizer 256"])
def test_receptive_fields_match_jax(ladder):
    depth = int(ladder[2:4])
    steps = (localizer_vbp_ladder(depth, Size(int(ladder.split()[-1]), int(ladder.split()[-1])))
             if "localizer" in ladder else resnet_vbp_ladder(depth))
    if "localizer" not in ladder:
        assert steps == jax_resnet_ladder(depth)
    got, want = rf.calculate_receptive_fields(steps), jrf.calculate_receptive_fields(steps)
    assert [(r.size, r.stride, r.offset) for r in got] == [(r.size, r.stride, r.offset) for r in want]
    for box in ([0, 0, 63, 63], [10.5, 20.25, 100, 180.75]):
        assert rf.bbox_to_feature_coords(box, steps) == jrf.bbox_to_feature_coords(box, steps)
