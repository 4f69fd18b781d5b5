"""The offline evaluation's host pieces against the JAX package's: the
loader (``data/loader.py``), the deteval XML (``evaluation/deteval.py``)
and the renders without Pillow (``insights/rendering.py``).

* ``padded_collate``, ``default_collate`` and ``DataLoader`` give the JAX
  package's batches exactly: the same order (shuffled or not, epochs,
  ``drop_last``), the same padding, the same dtypes.
* The deteval XML is byte-equal to the JAX writer's for the same boxes.
* ``draw_boxes_on_image`` is equal pixel for pixel to the JAX package's
  Pillow render (Pillow 12.1.0's ``ImageDraw.rectangle``); hypothesis
  draws boxes reversed, partly or wholly outside the image, of zero width
  or height, and outline widths 1-3. Unordered gt corners raise
  ``ValueError`` in both.
* ``write_png``'s files read back through Pillow to the same array.
"""

import io
import os

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st
from PIL import Image

from loans_tpu.data import loader as jloader
from loans_tpu.evaluation.deteval import DetEvalWriter as JaxDetEvalWriter
from loans_tpu.insights import rendering as jrendering
from loans_tpu_torch.data import loader
from loans_tpu_torch.evaluation.deteval import DetEvalWriter
from loans_tpu_torch.insights import rendering


class Ragged:
    """Examples of an image and 1-3 gt boxes, as a labeled dataset gives."""

    def __init__(self, n: int, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.items = [
            (rng.uniform(size=(4, 5, 3)).astype(np.float32),
             rng.uniform(0, 30, (int(rng.integers(1, 4)), 4)).astype(np.float32),
             np.zeros((1,), np.float32))
            for _ in range(n)
        ]

    def __len__(self):
        return len(self.items)

    def get_example(self, i):
        return self.items[i]


def _assert_same_tree(got, want):
    assert type(got) is type(want)
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same_tree(g, w)
    elif isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _assert_same_tree(got[k], want[k])
    else:
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_collate_matches_jax():
    ds = Ragged(5)
    examples = [ds.get_example(i) for i in range(5)]
    _assert_same_tree(loader.padded_collate(examples), jloader.padded_collate(examples))
    _assert_same_tree(loader.padded_collate(examples, padding=-1.0), jloader.padded_collate(examples, padding=-1.0))
    fixed = [{"a": e[0], "b": e[2]} for e in examples]
    _assert_same_tree(loader.default_collate(fixed), jloader.default_collate(fixed))
    _assert_same_tree(loader.padded_collate(fixed), jloader.padded_collate(fixed))
    boxes = loader.padded_collate(examples)[1]
    assert boxes.shape == (5, 3, 4)
    for i, e in enumerate(examples):  # the rows past an example's own are zeros
        assert not boxes[i, len(e[1]):].any()


@pytest.mark.parametrize("shuffle,drop_last,repeat", [
    (False, True, False), (True, True, False), (False, False, False), (True, False, True)])
def test_loader_order_and_padding_match_jax(shuffle, drop_last, repeat):
    ds = Ragged(11, seed=3)
    kw = dict(shuffle=shuffle, drop_last=drop_last, repeat=repeat, num_workers=3, seed=5,
              collate=jloader.padded_collate)
    want_loader = jloader.DataLoader(ds, 4, **kw)
    got_loader = loader.DataLoader(ds, 4, **{**kw, "collate": loader.padded_collate})
    assert len(got_loader) == len(want_loader)
    n = 8 if repeat else len(want_loader)  # two epochs of a repeating loader
    want = [b for _, b in zip(range(n), want_loader)]
    got = [b for _, b in zip(range(n), got_loader)]
    assert len(got) == len(want) == n
    for g, w in zip(got, want):
        _assert_same_tree(g, w)


def test_deteval_xml_is_byte_equal(tmp_path):
    rng = np.random.default_rng(0)
    writers = (JaxDetEvalWriter(), DetEvalWriter())
    for i in range(4):
        boxes = rng.uniform(-10, 230, (int(rng.integers(0, 3)), 4))
        scores = rng.uniform(size=len(boxes)) if i % 2 else None
        for w in writers:
            w.add_image(f"{i}.png", boxes, scores=scores)
    want, got = (w.write(str(tmp_path / f"{k}.xml")) for k, w in zip(("jax", "port"), writers))
    with open(want, "rb") as f_want, open(got, "rb") as f_got:
        assert f_got.read() == f_want.read()


coord = st.floats(-80.0, 140.0, allow_nan=False, width=32)


@settings(max_examples=300, deadline=None)
@given(
    h=st.integers(1, 48), w=st.integers(1, 48), width=st.integers(1, 3),
    boxes=st.lists(st.tuples(coord, coord, coord, coord), max_size=3),
    gt=st.lists(st.tuples(coord, coord, coord, coord), max_size=2),
    integral=st.booleans(), seed=st.integers(0, 2**16),
)
def test_rectangles_match_jax_pillow(h, w, width, boxes, gt, integral, seed):
    image = np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)
    boxes = np.asarray(boxes, np.float64).reshape(-1, 4)  # yxyx, possibly reversed
    gt = np.asarray(gt, np.float64).reshape(-1, 4)
    if integral:
        boxes, gt = np.round(boxes), np.round(gt)
    # gt boxes are drawn as given: ordered corners, zero extent allowed
    gt = np.concatenate([np.minimum(gt[:, :2], gt[:, 2:]), np.maximum(gt[:, :2], gt[:, 2:])], axis=1)
    want = np.asarray(jrendering.draw_boxes_on_image(image, boxes, gt_boxes=gt, width=width))
    got = rendering.draw_boxes_on_image(image, boxes, gt_boxes=gt, width=width)
    assert got.dtype == np.uint8 and got.shape == (h, w, 3)
    np.testing.assert_array_equal(got, want)


def test_unordered_gt_raises_as_pillow():
    image = np.zeros((8, 8, 3), np.uint8)
    for gt in ([[5.0, 1, 2, 6]], [[1.0, 6, 5, 2]]):  # y and then x reversed
        with pytest.raises(ValueError) as want:
            jrendering.draw_boxes_on_image(image, np.zeros((0, 4)), gt_boxes=np.array(gt))
        with pytest.raises(ValueError, match=str(want.value)):
            rendering.draw_boxes_on_image(image, np.zeros((0, 4)), gt_boxes=np.array(gt))


@pytest.mark.parametrize("kind", ["float01", "float255", "gray", "gray1", "rgba"])
def test_image_kinds_convert_as_jax(kind):
    rng = np.random.default_rng(1)
    image = {
        "float01": rng.uniform(size=(9, 7, 3)).astype(np.float32),
        "float255": rng.uniform(0, 300, size=(9, 7, 3)),
        "gray": rng.integers(0, 256, (9, 7), dtype=np.uint8),
        "gray1": rng.uniform(size=(9, 7, 1)).astype(np.float32),
        "rgba": rng.integers(0, 256, (9, 7, 4), dtype=np.uint8),
    }[kind]
    box = np.array([[1.5, 1.2, 6.7, 5.1]])
    want = np.asarray(jrendering.draw_boxes_on_image(image, box))
    np.testing.assert_array_equal(rendering.draw_boxes_on_image(image, box), want)


def test_heatmap_and_stacks_match_jax():
    rng = np.random.default_rng(2)
    heat = rng.uniform(-0.1, 1.1, (6, 5, 1)).astype(np.float32)
    np.testing.assert_array_equal(rendering.heatmap_to_rgb(heat), jrendering.heatmap_to_rgb(heat))
    tiles = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in ((4, 6), (7, 3), (5, 5))]
    pil = [Image.fromarray(t) for t in tiles]
    np.testing.assert_array_equal(rendering.hstack_images(tiles), np.asarray(jrendering.hstack_images(pil)))
    np.testing.assert_array_equal(rendering.vstack_images(tiles, pad=3),
                                  np.asarray(jrendering.vstack_images(pil, pad=3)))


@pytest.mark.parametrize("shape", [(5, 7, 3), (1, 1, 3), (6, 4), (6, 4, 1), (3, 9, 4)])
def test_png_reads_back_through_pillow(tmp_path, shape):
    image = np.random.default_rng(3).integers(0, 256, shape, dtype=np.uint8)
    path = rendering.write_png(os.path.join(tmp_path, "x.png"), image)
    back = np.asarray(Image.open(path))
    np.testing.assert_array_equal(back, image.reshape(back.shape))
    assert back.shape == (shape if len(shape) == 3 and shape[2] != 1 else shape[:2])
    assert Image.open(io.BytesIO(rendering.encode_png(image))).mode == {1: "L", 3: "RGB", 4: "RGBA"}[
        shape[2] if len(shape) == 3 else 1]


def test_png_refuses_what_it_cannot_encode():
    with pytest.raises(TypeError):
        rendering.encode_png(np.zeros((2, 2, 3), np.float32))
    with pytest.raises(ValueError):
        rendering.encode_png(np.zeros((2, 2, 2), np.uint8))
    with pytest.raises(ValueError):
        rendering.encode_png(np.zeros((0, 2, 3), np.uint8))
