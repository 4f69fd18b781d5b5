"""Host-side image augmentation of uint8 HWC numpy images (port of
``loans_tpu/data/augment.py``).

The operators of the reference's imgaug pipelines, each drawing from an
explicit ``np.random.Generator`` in the JAX package's order, so the same
generator seed gives the same images. ``fliplr``, ``contrast_normalization``,
``multiply``, ``SomeOf``, ``random_crop_flip`` and ``crop_and_pad`` (whose
resize is OpenCV's, in numpy: ``data/cv_resize.py``) are numpy.
``add_to_hue_and_saturation`` (OpenCV's HSV) needs cv2, which is imported
when it runs and refused by name where it is not installed (the machines
with the card have none). The training CLIs build their datasets without
augmentation, so no CLI path reaches it.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

from loans_tpu_torch.data.cv_resize import resize_linear


def require_cv2(what: str):
    """``cv2``, or a ``RuntimeError`` that names ``what`` needs it."""
    try:
        import cv2
    except ImportError:
        raise RuntimeError(f"{what} needs OpenCV (cv2), which is not installed") from None
    return cv2


def fliplr(img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    del rng
    return img[:, ::-1]


def add_to_hue_and_saturation(
    img: np.ndarray, rng: np.random.Generator, lo: float = -20, hi: float = 20
) -> np.ndarray:
    """Shift hue and saturation by independent uniform offsets (imgaug's
    ``AddToHueAndSaturation(Uniform(-20, 20), per_channel=True)``)."""
    cv2 = require_cv2("add_to_hue_and_saturation (the hue/saturation augmentation)")
    hsv = cv2.cvtColor(img, cv2.COLOR_RGB2HSV).astype(np.int16)
    hue_shift = int(rng.uniform(lo, hi))
    sat_shift = int(rng.uniform(lo, hi))
    hsv[..., 0] = (hsv[..., 0] + hue_shift) % 180
    hsv[..., 1] = np.clip(hsv[..., 1] + sat_shift, 0, 255)
    return cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2RGB)


def crop_and_pad(img: np.ndarray, rng: np.random.Generator, lo: float = -0.10, hi: float = 0.10) -> np.ndarray:
    """Crop (negative) or pad (positive) each side by an independent share
    of the image, then resize back (imgaug's ``CropAndPad(percent=(-0.1,
    0.1), pad_mode=['constant', 'edge'])``)."""
    h, w = img.shape[:2]
    pcts = rng.uniform(lo, hi, size=4)  # top, right, bottom, left
    mode = rng.choice(["constant", "edge"])
    top, right, bottom, left = int(pcts[0] * h), int(pcts[1] * w), int(pcts[2] * h), int(pcts[3] * w)
    ct, cr, cb, cl = (max(0, -v) for v in (top, right, bottom, left))
    out = img[ct : h - cb if cb else h, cl : w - cr if cr else w]
    pt, pr, pb, pl = (max(0, v) for v in (top, right, bottom, left))
    if any((pt, pr, pb, pl)):
        pad_width = ((pt, pb), (pl, pr)) + ((0, 0),) * (img.ndim - 2)
        out = np.pad(out, pad_width, mode="constant" if mode == "constant" else "edge")
    if out.shape[:2] != (h, w):
        out = resize_linear(np.ascontiguousarray(out), (w, h))
    return out


def contrast_normalization(
    img: np.ndarray, rng: np.random.Generator, lo: float = 0.75, hi: float = 1.0
) -> np.ndarray:
    alpha = rng.uniform(lo, hi)
    out = (img.astype(np.float32) - 128.0) * alpha + 128.0
    return np.clip(out, 0, 255).astype(np.uint8)


def multiply(
    img: np.ndarray,
    rng: np.random.Generator,
    lo: float = 0.8,
    hi: float = 1.2,
    per_channel_prob: float = 0.2,
) -> np.ndarray:
    if rng.uniform() < per_channel_prob:
        factors = rng.uniform(lo, hi, size=(1, 1, img.shape[-1]))
    else:
        factors = rng.uniform(lo, hi)
    out = img.astype(np.float32) * factors
    return np.clip(out, 0, 255).astype(np.uint8)


Augmenter = Callable[[np.ndarray, np.random.Generator], np.ndarray]


class SomeOf:
    """With probability ``probability``, a random subset of ``ops`` in
    random order (imgaug's ``Sometimes(p, SomeOf((0, None), ops,
    random_order=True))``)."""

    def __init__(self, ops: Sequence[Augmenter], probability: float):
        self.ops = list(ops)
        self.probability = probability

    def __call__(self, img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        if rng.uniform() >= self.probability:
            return img
        n = int(rng.integers(0, len(self.ops) + 1))
        order = rng.permutation(len(self.ops))[:n]
        for idx in order:
            img = self.ops[idx](img, rng)
        return img


def unlabeled_pipeline(probability: float) -> SomeOf:
    """The unlabeled localizer stream's augmentation."""
    return SomeOf([fliplr, add_to_hue_and_saturation, crop_and_pad], probability)


def labeled_pipeline(probability: float) -> SomeOf:
    """The labeled data's augmentation."""
    return SomeOf([fliplr, add_to_hue_and_saturation, contrast_normalization, multiply], probability)


def random_crop_flip(
    img: np.ndarray,
    rng: np.random.Generator,
    probability: float,
    min_crop_ratio: float = 0.6,
    max_crop_ratio: float = 0.9,
    crop_always: bool = False,
) -> np.ndarray:
    """The augmentation without imgaug: with probability ``probability``, a
    random crop (half the time, or always) and a random horizontal flip."""
    if rng.uniform() >= probability:
        return img
    if crop_always or rng.uniform() <= 0.5:
        ratio = rng.uniform(min_crop_ratio, max_crop_ratio)
        h, w = img.shape[:2]
        ch, cw = int(h * ratio), int(w * ratio)
        y0 = int(rng.integers(0, h - ch + 1))
        x0 = int(rng.integers(0, w - cw + 1))
        img = img[y0 : y0 + ch, x0 : x0 + cw]
    if rng.uniform() < 0.5:
        img = img[:, ::-1]
    return img
