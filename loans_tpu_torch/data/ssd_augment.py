"""The SSD's host-side train transform and its gt-json dataset (port of
``loans_tpu/data/ssd_augment.py``).

With augmentation, chainercv's five steps, each drawing from the
transform's ``np.random.Generator`` in the JAX package's order: (1) a
photometric distortion, (2) a random expand onto a mean-filled canvas, (3)
an IoU-constrained random crop, (4) a resize by a random interpolation
method, (5) a random horizontal flip; then the boxes are scaled to [0, 1]
and encoded to multibox targets (``ops.multibox.MultiboxCoder.encode``).
Without augmentation the image is only resized, by OpenCV's linear resize
in numpy (``data/cv_resize.py``).

Steps (1) and (4) are OpenCV's (HSV conversions, and five interpolation
methods): cv2 is imported when they run and refused by name where it is
not installed; ``augment=False`` (the CLI's ``--no-augment``) needs no cv2.
The on-device augmentation of the synthetic pools is ``data/ssd_device.py``.

Boxes are (y_min, x_min, y_max, x_max) pixels throughout.
"""

from __future__ import annotations

import numpy as np

from loans_tpu_torch.data.augment import require_cv2
from loans_tpu_torch.data.cv_resize import resize_linear
from loans_tpu_torch.data.datasets import load_image, read_bbox_json
from loans_tpu_torch.evaluation.voc import _bbox_iou

NO_CV2 = "the SSD train augmentation; --no-augment runs without it"


def random_distort(img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Brightness, contrast, saturation and hue jitter (chainercv's
    ``random_distort`` defaults)."""
    cv2 = require_cv2(f"random_distort ({NO_CV2})")
    img = img.astype(np.float32)
    if rng.random() < 0.5:
        img += rng.uniform(-32, 32)
    if rng.random() < 0.5:
        img *= rng.uniform(0.5, 1.5)
    img = np.clip(img, 0, 255).astype(np.uint8)
    hsv = cv2.cvtColor(img, cv2.COLOR_RGB2HSV).astype(np.float32)
    if rng.random() < 0.5:
        hsv[..., 1] *= rng.uniform(0.5, 1.5)
    if rng.random() < 0.5:
        hsv[..., 0] = (hsv[..., 0] + rng.uniform(-18, 18)) % 180
    hsv[..., 1] = np.clip(hsv[..., 1], 0, 255)
    return cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2RGB)


def random_expand(img: np.ndarray, bbox: np.ndarray, rng: np.random.Generator, max_ratio: float = 4.0,
                  fill=(123, 117, 104)):
    """Half the time, paste the image at a random place on a canvas up to
    ``max_ratio`` times its size, filled with ``fill``."""
    if rng.random() < 0.5:
        return img, bbox
    h, w = img.shape[:2]
    ratio = rng.uniform(1.0, max_ratio)
    oh, ow = int(h * ratio), int(w * ratio)
    top = rng.integers(0, oh - h + 1)
    left = rng.integers(0, ow - w + 1)
    canvas = np.empty((oh, ow, 3), dtype=img.dtype)
    canvas[...] = np.asarray(fill, dtype=img.dtype)
    canvas[top : top + h, left : left + w] = img
    return canvas, bbox + np.array([top, left, top, left], dtype=bbox.dtype)


def random_crop_with_bbox_constraints(img: np.ndarray, bbox: np.ndarray, rng: np.random.Generator,
                                      min_scale: float = 0.3, max_aspect_ratio: float = 2.0,
                                      max_trial: int = 50):
    """chainercv's IoU-constrained random crop: draw a minimum IoU from
    {none, 0.1, 0.3, 0.5, 0.7, 0.9}, rejection-sample a crop that every box
    overlaps by at least that much, and keep the boxes whose centres fall
    inside it, clipped to it."""
    h, w = img.shape[:2]
    constraints = [None, 0.1, 0.3, 0.5, 0.7, 0.9]
    constraint = constraints[rng.integers(0, len(constraints))]
    if constraint is None or bbox.shape[0] == 0:
        return img, bbox
    for _ in range(max_trial):
        scale = rng.uniform(min_scale, 1.0)
        ar = rng.uniform(max(1 / max_aspect_ratio, scale * scale), min(max_aspect_ratio, 1 / (scale * scale)))
        ch = int(h * scale / np.sqrt(ar))
        cw = int(w * scale * np.sqrt(ar))
        if ch == 0 or cw == 0 or ch > h or cw > w:
            continue
        top = rng.integers(0, h - ch + 1)
        left = rng.integers(0, w - cw + 1)
        crop_box = np.array([[top, left, top + ch, left + cw]], dtype=np.float64)
        if _bbox_iou(bbox.astype(np.float64), crop_box).min() >= constraint:
            img = img[top : top + ch, left : left + cw]
            center = (bbox[:, :2] + bbox[:, 2:]) / 2
            mask = ((center[:, 0] >= top) & (center[:, 0] < top + ch)
                    & (center[:, 1] >= left) & (center[:, 1] < left + cw))
            bbox = bbox[mask] - np.array([top, left, top, left], dtype=bbox.dtype)
            bbox[:, 0::2] = np.clip(bbox[:, 0::2], 0, ch)
            bbox[:, 1::2] = np.clip(bbox[:, 1::2], 0, cw)
            return img, bbox
    return img, bbox


def resize_random_interpolation(img: np.ndarray, size: int, rng: np.random.Generator) -> np.ndarray:
    """Resize to ``size``² by one of OpenCV's linear, area, nearest, cubic
    and Lanczos-4 methods, drawn uniformly."""
    cv2 = require_cv2(f"resize_random_interpolation ({NO_CV2})")
    methods = [cv2.INTER_LINEAR, cv2.INTER_AREA, cv2.INTER_NEAREST, cv2.INTER_CUBIC, cv2.INTER_LANCZOS4]
    return cv2.resize(img, (size, size), interpolation=methods[rng.integers(0, len(methods))])


def random_flip_lr(img: np.ndarray, bbox: np.ndarray, rng):
    if rng.random() < 0.5:
        w = img.shape[1]
        img = img[:, ::-1]
        bbox = bbox.copy()
        if bbox.shape[0]:
            x1 = w - bbox[:, 3]
            x2 = w - bbox[:, 1]
            bbox[:, 1], bbox[:, 3] = x1, x2
    return np.ascontiguousarray(img), bbox


class SSDTransform:
    """(image, bbox pixels, labels) -> (image float32 [0, 1] at
    ``size``², mb_loc (K, 4), mb_conf (K,)). The image is uint8 or float in
    [0, 1]."""

    def __init__(self, coder, size: int, seed: int = 0, augment=True):
        self.coder = coder
        self.size = size
        self.augment = augment
        self._rng = np.random.default_rng(seed)

    def __call__(self, img: np.ndarray, bbox: np.ndarray, label=None):
        rng = self._rng
        bbox = np.asarray(bbox, dtype=np.float32).reshape(-1, 4)
        if label is None:
            label = np.zeros((bbox.shape[0],), dtype=np.int32)
        img8 = np.clip(img * 255, 0, 255).astype(np.uint8) if img.dtype != np.uint8 else img
        h, w = img8.shape[:2]
        if self.augment:
            img8 = random_distort(img8, rng)
            img8, bbox = random_expand(img8, bbox, rng)
            img8, bbox = random_crop_with_bbox_constraints(img8, bbox, rng)
            h, w = img8.shape[:2]
            img8 = resize_random_interpolation(img8, self.size, rng)
        else:
            img8 = resize_linear(img8, (self.size, self.size))
        bbox = bbox * np.array([self.size / h, self.size / w] * 2, dtype=np.float32)
        if self.augment:
            img8, bbox = random_flip_lr(img8, bbox, rng)
        mb_loc, mb_conf = self.coder.encode(bbox / self.size, np.asarray(label))
        return img8.astype(np.float32) / 255.0, mb_loc, mb_conf


class SSDDataset:
    """A gt json (or (path, flat boxes) pairs) through ``SSDTransform``."""

    def __init__(self, source, coder, size: int, seed=0, augment=True):
        if isinstance(source, str):
            source = read_bbox_json(source)
        self.pairs = list(source)
        self.transform = SSDTransform(coder, size, seed=seed, augment=augment)

    def __len__(self):
        return len(self.pairs)

    def get_example(self, i: int):
        path, flat = self.pairs[i]
        img = load_image(path, "RGB").astype(np.float32) / 255.0
        bbox = np.asarray(flat, dtype=np.float32).reshape(-1, 4)
        return self.transform(img, bbox)

    def __getitem__(self, i):
        return self.get_example(i)
