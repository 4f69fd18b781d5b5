"""The port's datasets over image files (``loans_tpu_torch/data/datasets.py``)
and its ``synthetic.generate_dataset`` against the JAX package's, on the
same files.

The files are written by the JAX package's own tool
(``loans_tpu.data.synthetic.generate_dataset``: Pillow's PNGs, adaptive
row filters) and by Pillow from the JAX package's labeled scenes, in a
temporary directory. The port decodes PNG with ``data/png.py`` and resizes
with Pillow's integers in numpy (``data/image_ops.py``), so every image,
label and box must be equal to the JAX package's exactly; a JPEG goes
through Pillow in both.
"""

import json
import os
import sys

import numpy as np
import pytest
from PIL import Image

from loans_tpu.data import datasets as jds
from loans_tpu.data import synthetic as jsyn
from loans_tpu_torch.data import datasets, synthetic


@pytest.fixture(autouse=True)
def pinned_cpu_count(monkeypatch):
    monkeypatch.setattr(os, "cpu_count", lambda: 8)  # the synthetic data depend on it


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """IoU-labeled crops (the JAX tool), labeled scenes of several sizes as
    a csv and a json (boxes), an image list and a JPEG."""
    root = tmp_path_factory.mktemp("files")
    crops_csv = jsyn.generate_dataset(str(root / "crops"), 12, image_size=(48, 40), output_size=(14, 12), seed=3)
    scenes = jsyn.SyntheticLocalizerDataset(6, image_size=(40, 48), seed=4, labeled=True, output_dtype="uint8")
    os.makedirs(root / "scenes")
    rows, records = [], []
    for i, (img, box) in enumerate(scenes.items):
        if i % 2:  # another size: the boxes scale with the image
            img = np.asarray(Image.fromarray(img).resize((56, 44)))
            box = box * np.array([44 / 48, 56 / 40, 44 / 48, 56 / 40], np.float32)
        name = f"scenes/{i}.png"
        (Image.fromarray(img).convert("L") if i == 4 else Image.fromarray(img)).save(root / name)
        second = box + 1.5
        rows.append("\t".join([name] + [str(float(v)) for v in np.concatenate([box, second])]))
        records.append({"image": name, "bounding_boxes": [box.tolist(), second.tolist()]})
    (root / "labeled.csv").write_text("\n".join(rows) + "\n\n")
    (root / "labeled.json").write_text(json.dumps(records))
    (root / "list.txt").write_text("".join(f"scenes/{i}.png\n" for i in range(6)) + f"{root}/scenes/0.png\n")
    Image.fromarray(scenes.items[0][0]).save(root / "scene.jpg", quality=90)
    return {"root": root, "crops": crops_csv, "csv": str(root / "labeled.csv"), "json": str(root / "labeled.json"),
            "list": str(root / "list.txt"), "jpg": str(root / "scene.jpg")}


def assert_same(got, want):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_same(g, w)
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_readers_match_jax(files):
    assert datasets.read_path_list(files["list"]) == jds.read_path_list(files["list"])
    assert datasets.read_labeled_csv(files["csv"]) == jds.read_labeled_csv(files["csv"])
    assert datasets.read_labeled_csv(files["crops"]) == jds.read_labeled_csv(files["crops"])
    assert datasets.read_bbox_json(files["json"]) == jds.read_bbox_json(files["json"])
    assert len(datasets.read_path_list(files["list"])) == 7


@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
def test_load_image_matches_jax(files, mode):
    paths = datasets.read_path_list(files["list"]) + [p for p, _ in datasets.read_labeled_csv(files["crops"])]
    for path in paths + [files["jpg"]]:
        assert_same(datasets.load_image(path, mode), jds.load_image(path, mode))


def test_other_formats_need_pillow(files, monkeypatch):
    png = datasets.read_path_list(files["list"])[0]
    monkeypatch.setitem(sys.modules, "PIL", None)
    assert datasets.load_image(png).shape == (48, 40, 3)  # PNG never needs Pillow
    with pytest.raises(ValueError, match="not a PNG file.*Pillow"):
        datasets.load_image(files["jpg"])


@pytest.mark.parametrize("size", [(40, 48), (20, 24), (75, 75), (33, 17)])
def test_resize_image_matches_jax(files, size):
    img = datasets.load_image(datasets.read_path_list(files["list"])[0])
    assert_same(datasets.resize_image(img, size), jds.resize_image(img, size))
    floats = img.astype(np.float32) * 0.999  # truncated to uint8 first, as Pillow's fromarray(astype)
    assert_same(datasets.resize_image(floats, size), jds.resize_image(floats, size))


def test_resize_bbox_matches_jax():
    box = np.array([[1.5, 2.0, 30.25, 40.0], [0, 0, 10, 10]], np.float32)
    for in_size, out_size in [((40, 48), (75, 75)), ((44, 56), (32, 32)), ((10, 10), (10, 10))]:
        assert_same(datasets.resize_bbox(box, in_size, out_size), jds.resize_bbox(box, in_size, out_size))


@pytest.mark.parametrize("output_dtype", ["float32", "uint8"])
@pytest.mark.parametrize("image_size", [None, (32, 32)])
def test_datasets_match_jax(files, output_dtype, image_size):
    kw = dict(image_size=image_size, output_dtype=output_dtype)
    pairs = [
        (datasets.ImageDataset(files["list"], **kw), jds.ImageDataset(files["list"], **kw)),
        (datasets.DiscriminatorImageDataset(files["list"], label=0.5, **kw),
         jds.DiscriminatorImageDataset(files["list"], label=0.5, **kw)),
        (datasets.LabeledImageDataset(files["crops"], **kw), jds.LabeledImageDataset(files["crops"], **kw)),
        (datasets.LabeledImageDataset(files["csv"], **kw), jds.LabeledImageDataset(files["csv"], **kw)),
        (datasets.LabeledImageDataset(files["json"], return_dummy_scores=False, **kw),
         jds.LabeledImageDataset(files["json"], return_dummy_scores=False, **kw)),
    ]
    for got, want in pairs:
        assert len(got) == len(want)
        for i in range(len(want)):
            assert_same(got[i], want[i])


def test_bad_label_shrink_and_fallback(files, capsys):
    """The 10% tolerance of ``check_for_bad_label``, ``shrink_dataset``,
    and a file that fails to load replaced by example 0."""
    got = datasets.LabeledImageDataset(files["json"], image_size=(32, 32))
    want = jds.LabeledImageDataset(files["json"], image_size=(32, 32))
    for ds in (got, want):
        ds.check_for_bad_label(np.array([[-4.7, -3.9, 52.7, 43.9]]), (48, 40))  # inside the 10% margin
        with pytest.raises(ValueError, match="Label can not be scaled"):
            ds.check_for_bad_label(np.array([[-4.9, 0, 10, 10]]), (48, 40))
        ds.pairs.append((str(files["root"] / "missing.png"), [1.0, 2.0, 3.0, 4.0]))
        ds.pairs.append((ds.pairs[0][0], [0.0, 0.0, 60.0, 10.0]))  # 60 > 48 + 10%: off the image
        with pytest.raises(ValueError, match="Label can not be scaled"):
            ds[len(ds) - 1]
    assert_same(got[len(got) - 2], want[len(want) - 2])
    assert_same(got[len(got) - 2], got[0])
    assert "missing.png" in capsys.readouterr().out
    for ds in (got, want):
        ds.shrink_dataset(3)
    assert len(got) == len(want) == 3 and got.pairs == want.pairs


@pytest.mark.parametrize("zoom_mode", [True, False])
def test_generate_dataset_matches_jax(tmp_path, zoom_mode):
    kw = dict(image_size=(48, 40), output_size=(14, 12), seed=5, zoom_mode=zoom_mode, low_iou_fraction=0.25)
    got = synthetic.generate_dataset(str(tmp_path / "port"), 10, **kw)
    want = jsyn.generate_dataset(str(tmp_path / "jax"), 10, **kw)
    assert open(got).read() == open(want).read()
    for (p, label), (q, jlabel) in zip(datasets.read_labeled_csv(got), jds.read_labeled_csv(want)):
        assert label == jlabel
        assert_same(datasets.load_image(p), jds.load_image(q))


def test_generate_dataset_with_stamp_and_background_files(tmp_path):
    """Stamps and backgrounds read from image files (RGBA), as the JAX tool
    reads them with Pillow."""
    rng = np.random.default_rng(0)
    stamp = np.zeros((20, 16, 4), np.uint8)
    stamp[4:16, 3:13] = [200, 40, 90, 255]
    stamp[2:4, 2:14, 3] = 128  # a half-transparent rim
    Image.fromarray(stamp).save(tmp_path / "stamp.png")
    os.makedirs(tmp_path / "bg")
    for i in range(2):
        Image.fromarray(rng.integers(0, 256, (30 + i, 36, 3), dtype=np.uint8)).save(tmp_path / "bg" / f"{i}.png")
    kw = dict(stamps=[str(tmp_path / "stamp.png")], background_dir=str(tmp_path / "bg"), image_size=(40, 40),
              output_size=(10, 10), seed=2)
    got = synthetic.generate_dataset(str(tmp_path / "port"), 6, **kw)
    want = jsyn.generate_dataset(str(tmp_path / "jax"), 6, **kw)
    assert open(got).read() == open(want).read()
    for (p, _), (q, _) in zip(datasets.read_labeled_csv(got), jds.read_labeled_csv(want)):
        assert_same(datasets.load_image(p), jds.load_image(q))
