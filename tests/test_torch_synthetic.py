"""The port's synthetic world against the JAX package's, byte for byte.

``loans_tpu_torch.data.synthetic`` draws the same random streams in the
same order as ``loans_tpu/data/synthetic.py`` and replaces its Pillow
calls with ``data.image_ops``; so for the same arguments the scenes, the
gt boxes, the ``pil``-pipeline crops and the IoU labels must be equal
bytes, in the default and the hard world, with and without a shared asset
world (``--synthetic-assets``). Both packages split the generation into
``4 * min(8, os.cpu_count())`` chunks, so ``os.cpu_count`` is pinned here.

The ``stn`` pipeline renders its crops with each package's separable
sampler (JAX's jitted ``spatial_transform``, the port's plain version on
the CPU): float32 sums in another order, so a crop may round to the other
uint8 value where the float lies within rounding of a .5 boundary. Such
pixels differ by exactly one step; they are held to at most 1e-3 of all
pixels (measured: 0 here), and the labels are equal.
"""

import os

import numpy as np
import pytest

from loans_tpu.data import synthetic as jsyn
from loans_tpu_torch.data import synthetic

IMG, CROP = (64, 64), (16, 16)
WORLDS = {
    "default": {},
    "hard": {"hard": True},
    "assets": {"asset_seed": 9973, "n_assets": 4},
    "hard+assets": {"hard": True, "asset_seed": 5, "n_assets": 4},
}


@pytest.fixture(autouse=True)
def pinned_cpu_count(monkeypatch):
    monkeypatch.setattr(os, "cpu_count", lambda: 8)


def assert_items_equal(got, want):
    assert len(got.items) == len(want.items)
    for a, b in zip(got.items, want.items):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            u, v = np.asarray(u), np.asarray(v)
            assert u.dtype == v.dtype and u.shape == v.shape
            np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("world", sorted(WORLDS))
@pytest.mark.parametrize("labeled", [False, True])
def test_localizer_scenes_equal_jax(world, labeled):
    kw = dict(image_size=IMG, seed=3, labeled=labeled, output_dtype="uint8", **WORLDS[world])
    got = synthetic.SyntheticLocalizerDataset(40, **kw)
    assert_items_equal(got, jsyn.SyntheticLocalizerDataset(40, **kw))
    ex, want = got[5], jsyn.SyntheticLocalizerDataset(40, **kw)[5]
    for a, b in zip(ex if labeled else (ex,), want if labeled else (want,)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("world", sorted(WORLDS))
@pytest.mark.parametrize("low_iou", [0.0, 0.3])
def test_assessor_pil_crops_equal_jax(world, low_iou):
    kw = dict(output_size=CROP, image_size=IMG, seed=4, output_dtype="uint8",
              low_iou_fraction=low_iou, **WORLDS[world])
    got = synthetic.SyntheticAssessorDataset(40, crop_pipeline="pil", **kw)
    assert_items_equal(got, jsyn.SyntheticAssessorDataset(40, crop_pipeline="pil", **kw))


def test_full_size_scenes_and_crops_equal_jax():
    """The CLI's own sizes (224^2 scenes, 75^2 crops, 256^2 assets)."""
    kw = dict(seed=1, output_dtype="uint8")
    assert_items_equal(synthetic.SyntheticAssessorDataset(24, **kw), jsyn.SyntheticAssessorDataset(24, **kw))
    assert_items_equal(synthetic.SyntheticLocalizerDataset(16, **kw), jsyn.SyntheticLocalizerDataset(16, **kw))


def test_float32_output_and_base_bboxes(tmp_path):
    path = tmp_path / "boxes.json"
    path.write_text('[{"image": "a.png", "bounding_boxes": [[1, 2, 30, 40], [5, 5, 5, 9], [0, 0, 12, 10]]}]')
    sizes = synthetic.load_base_bbox_sizes(str(path))
    assert sizes == jsyn.load_base_bbox_sizes(str(path)) == [(10, 12), (38, 29)]
    kw = dict(image_size=IMG, seed=2, base_bboxes=sizes, labeled=True)
    got, want = synthetic.SyntheticLocalizerDataset(12, **kw), jsyn.SyntheticLocalizerDataset(12, **kw)
    for i in range(12):
        for a, b in zip(got[i], want[i]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("world", ["default", "hard"])
def test_assessor_stn_crops_within_one_step_of_jax(world):
    kw = dict(output_size=CROP, image_size=IMG, seed=6, output_dtype="uint8", **WORLDS[world])
    got = synthetic.SyntheticAssessorDataset(300, crop_pipeline="stn", device="cpu", **kw)
    want = jsyn.SyntheticAssessorDataset(300, crop_pipeline="stn", **kw)
    assert len(got) == len(want) == 300  # two render batches, the second padded
    crops = np.stack([c for c, _ in got.items]).astype(np.int16)
    ref = np.stack([np.asarray(c) for c, _ in want.items]).astype(np.int16)
    assert crops.shape == ref.shape == (300, *CROP, 3)
    diff = np.abs(crops - ref)
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 1e-3
    assert [iou for _, iou in got.items] == [iou for _, iou in want.items]


def test_render_counts_batches_and_pads_the_tail():
    gen = synthetic.PasteAndCropGenerator(image_size=IMG, seed=0)
    triples = [gen.sample_box() for _ in range(synthetic.RENDER_BATCH + 3)]
    before = synthetic.render_stn_crops.batches
    crops = synthetic.render_stn_crops(triples, CROP, device="cpu")
    assert synthetic.render_stn_crops.batches - before == 2
    assert len(crops) == len(triples) and crops[0].dtype == np.uint8
    alone = synthetic.render_stn_crops(triples[-3:], CROP, device="cpu")
    np.testing.assert_array_equal(np.stack(crops[-3:]), np.stack(alone))


def test_cached_synthetic_round_trips(tmp_path):
    """A second build with the same key reads the file back (``build``
    is handed the stored items and generates nothing); the file name is the
    JAX package's, so either package reads the other's cache."""
    calls = []

    def build(items):
        calls.append(items is None)
        return synthetic.SyntheticAssessorDataset(
            12, output_size=CROP, image_size=IMG, seed=5, output_dtype="uint8", items=items)

    key = dict(n=12, crop=list(CROP), image_size=list(IMG), seed=5, pipeline="pil", low_iou=0.0)
    first = synthetic.cached_synthetic(str(tmp_path), "crops", build, **key)
    second = synthetic.cached_synthetic(str(tmp_path), "crops", build, **key)
    assert calls == [True, False]
    assert_items_equal(second, first)
    assert os.listdir(tmp_path) == [jsyn._cache_key("crops", **key)]
    third = jsyn.cached_synthetic(
        str(tmp_path), "crops",
        lambda items: jsyn.SyntheticAssessorDataset(12, output_size=CROP, image_size=IMG, seed=5,
                                                    output_dtype="uint8", items=items), **key)
    assert_items_equal(third, first)
