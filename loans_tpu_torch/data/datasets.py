"""Datasets over image files (port of ``loans_tpu/data/datasets.py``).

The on-disk formats are the JAX package's:

* an unlabeled list: one image path per line (the first tab-separated
  column);
* a labeled csv: tab-separated ``path<TAB>label...`` rows (an IoU for
  assessor crops, 4k values for k boxes);
* a labeled json: a list of ``{"image": path, "bounding_boxes": [[y1, x1,
  y2, x2], ...]}`` records.

Relative paths are relative to the list file. Images are returned HWC
float32 in [0, 1], or uint8 with ``output_dtype='uint8'``.

Decoding: PNG files are always read by ``data/png.py``, the same code on
every machine, so the tests run the card's decoder. Other formats go
through Pillow where it is installed and are refused by name where it is
not (the machines with the card have no Pillow). Resizing is Pillow's
LANCZOS in numpy (``data/image_ops.py``), equal to Pillow's pixels.
"""

from __future__ import annotations

import csv
import json
import os
from typing import Sequence

import numpy as np

from loans_tpu_torch.data import augment, image_ops, png


def resize_image(image: np.ndarray, image_size, image_mode: str = "RGB") -> np.ndarray:
    """LANCZOS resize of an HWC RGB image (uint8, or float in [0, 255],
    truncated to uint8 first) to HWC float32; ``image_size`` is (height,
    width). The same size returns the image unchanged, as Pillow does."""
    if image_mode != "RGB":
        raise ValueError(f"resize_image: image mode {image_mode!r} is not supported (only 'RGB')")
    arr = np.asarray(image).astype(np.uint8)
    out = image_ops.resize(arr, (int(image_size[1]), int(image_size[0])), "lanczos")
    return out.astype(np.float32)


def resize_bbox(bbox: np.ndarray, in_size, out_size) -> np.ndarray:
    """Scale (y1, x1, y2, x2) boxes from an image of ``in_size`` (h, w) to
    one of ``out_size``, in float32."""
    y_scale = out_size[0] / in_size[0]
    x_scale = out_size[1] / in_size[1]
    out = bbox.astype(np.float32).copy()
    out[:, 0] *= y_scale
    out[:, 2] *= y_scale
    out[:, 1] *= x_scale
    out[:, 3] *= x_scale
    return out


def load_image(path: str, image_mode: str = "RGB") -> np.ndarray:
    """The file at ``path`` as HWC uint8, converted to ``image_mode``
    ('RGB' or 'RGBA') as Pillow's ``convert`` does."""
    if png.is_png(path):
        return png.read_png(path, image_mode)
    try:
        from PIL import Image
    except ImportError:
        raise ValueError(
            f"{path}: not a PNG file, and other image formats need Pillow, which is not installed"
        ) from None
    with Image.open(path) as img:
        arr = np.asarray(img.convert(image_mode))
    if arr.ndim == 2:
        arr = arr[..., None]
    return arr


def _resolve(root: str, p: str) -> str:
    return p if os.path.isabs(p) else os.path.join(root, p)


def read_path_list(path: str) -> list[str]:
    """One path per line (the first tab-separated column)."""
    root = os.path.dirname(os.path.abspath(path))
    with open(path) as handle:
        return [_resolve(root, row[0]) for row in csv.reader(handle, delimiter="\t") if row]


def read_labeled_csv(path: str) -> list[tuple[str, list[float]]]:
    """Tab-separated ``path<TAB>label...`` rows."""
    root = os.path.dirname(os.path.abspath(path))
    with open(path) as handle:
        return [(_resolve(root, row[0]), [float(v) for v in row[1:]])
                for row in csv.reader(handle, delimiter="\t") if row]


def read_bbox_json(path: str) -> list[tuple[str, list[float]]]:
    """``{"image", "bounding_boxes"}`` records: (path, flat yxyx values)."""
    root = os.path.dirname(os.path.abspath(path))
    with open(path) as handle:
        data = json.load(handle)
    return [(_resolve(root, item["image"]), [float(v) for box in item["bounding_boxes"] for v in box])
            for item in data]


def _finish(img: np.ndarray, output_dtype: str) -> np.ndarray:
    if output_dtype == "uint8":
        return np.ascontiguousarray(np.clip(img, 0, 255), dtype=np.uint8)
    return np.ascontiguousarray(img, dtype=np.float32) / 255.0


class ImageDataset:
    """Unlabeled images from a path list (or a list of paths).

    ``transform_probability > 0`` augments each image on the host
    (``augment.unlabeled_pipeline``, or ``augment.random_crop_flip`` with
    ``use_imgaug=False``) from a generator seeded with ``seed``; then the
    image is resized to ``image_size`` (h, w) when one is given.
    """

    def __init__(
        self,
        paths: Sequence[str] | str,
        image_size=None,
        image_mode: str = "RGB",
        transform_probability: float = 0.0,
        use_imgaug: bool = True,
        min_crop_ratio: float = 0.6,
        max_crop_ratio: float = 0.9,
        crop_always: bool = False,
        seed: int = 0,
        output_dtype: str = "float32",
    ):
        self.output_dtype = output_dtype
        if isinstance(paths, str):
            paths = read_path_list(paths)
        self.paths = list(paths)
        self.image_size = image_size
        self.image_mode = image_mode
        self.transform_probability = transform_probability
        self.use_imgaug = use_imgaug
        self.min_crop_ratio = min_crop_ratio
        self.max_crop_ratio = max_crop_ratio
        self.crop_always = crop_always
        self.pipeline = (
            augment.unlabeled_pipeline(transform_probability)
            if transform_probability > 0 and use_imgaug
            else None
        )
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.paths)

    def _load(self, i: int) -> np.ndarray:
        img = load_image(self.paths[i], "RGB")
        if img.shape[-1] == 1:
            img = np.tile(img, (1, 1, 3))
        return img

    def get_example(self, i: int) -> np.ndarray:
        img = self._load(i)
        if self.pipeline is not None:
            img = self.pipeline(img, self._rng)
        elif self.transform_probability > 0:
            img = augment.random_crop_flip(
                img, self._rng, self.transform_probability, self.min_crop_ratio,
                self.max_crop_ratio, self.crop_always,
            )
        if self.image_size is not None:
            img = resize_image(img, self.image_size, self.image_mode)
        return _finish(img, self.output_dtype)

    def __getitem__(self, i):
        return self.get_example(i)


class LabeledImageDataset:
    """Images with labels, from a labeled csv or json (or a list of
    (path, label values) pairs).

    Labels of 4k values become (k, 4) boxes, checked against the image
    (``check_for_bad_label``) and scaled with it; other labels (an IoU)
    pass through. Returns (image, label, a dummy score of 0) with
    ``return_dummy_scores``, else (image, label). A file that fails to
    load is reported and example 0 is returned in its place.
    """

    def __init__(
        self,
        pairs,
        image_size=None,
        image_mode: str = "RGB",
        transform_probability: float = 0.0,
        label_dtype=np.float32,
        return_dummy_scores: bool = True,
        seed: int = 0,
        output_dtype: str = "float32",
    ):
        self.output_dtype = output_dtype
        if isinstance(pairs, str):
            pairs = read_bbox_json(pairs) if pairs.endswith(".json") else read_labeled_csv(pairs)
        self.pairs = list(pairs)
        self.image_size = image_size
        self.image_mode = image_mode
        self.label_dtype = label_dtype
        self.return_dummy_scores = return_dummy_scores
        self.pipeline = augment.labeled_pipeline(transform_probability) if transform_probability > 0 else None
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.pairs)

    def shrink_dataset(self, new_size: int):
        self.pairs = self.pairs[:new_size]

    def check_for_bad_label(self, label: np.ndarray, image_size):
        """Boxes may leave the image by at most 10% of its size."""
        extra = [s * 0.1 for s in image_size]
        ok = (
            (label[:, 0] >= -extra[0]).all()
            and (label[:, 1] >= -extra[1]).all()
            and (label[:, 2] <= image_size[0] + extra[0]).all()
            and (label[:, 3] <= image_size[1] + extra[1]).all()
        )
        if not ok:
            raise ValueError(f"Label can not be scaled correctly; image size {image_size}, label {label}")

    def get_example(self, i: int):
        try:
            path, label = self.pairs[i]
            img = load_image(path, "RGB")
        except Exception as e:  # fall back to example 0, as the JAX package does
            print(e)
            path, label = self.pairs[0]
            img = load_image(path, "RGB")
        label = np.asarray(label, dtype=np.float32)
        if label.ndim > 0 and label.size % 4 == 0 and label.size > 0:
            label = label.reshape(-1, 4)
        if img.shape[-1] == 1:
            img = np.tile(img, (1, 1, 3))
        if self.pipeline is not None:
            img = self.pipeline(img.astype(np.uint8), self._rng)
        if self.image_size is not None:
            in_size = img.shape[:2]
            if label.ndim > 1:
                self.check_for_bad_label(label, in_size)
                label = resize_bbox(label, in_size, self.image_size)
            img = resize_image(img, self.image_size, self.image_mode)
        img = _finish(img, self.output_dtype)
        label = label.astype(self.label_dtype)
        if self.return_dummy_scores:
            return img, label, np.zeros((1,), dtype=np.float32)
        return img, label

    def __getitem__(self, i):
        return self.get_example(i)


class DiscriminatorImageDataset(ImageDataset):
    """Unlabeled images, each with the constant label ``label``."""

    def __init__(self, *args, label: float, **kwargs):
        self.label = label
        super().__init__(*args, **kwargs)

    def get_example(self, i: int):
        img = super().get_example(i)
        return img, np.asarray([self.label], dtype=np.float32)
