"""OpenCV's ``cv2.resize(img, (w, h))`` (``INTER_LINEAR``) of uint8 images
in numpy, bit-equal to OpenCV's (``imgproc/src/resize.cpp``).

The SSD's gt-json val images and its un-augmented train transform are
resized this way in the JAX package (``cv2.resize`` without a flag); the
machines with the card have no cv2. OpenCV's fixed-point form:

* per output column ``fx = float32((x + 0.5) * in / out - 0.5)``,
  ``sx = floor(fx)``, ``fx -= sx``; a column left of the image or at its
  last column takes ``fx = 0`` at the clamped column; the weights
  ``rint((1 - fx) * 2048)`` and ``rint(fx * 2048)``, int16;
* the horizontal pass in int32: ``a0 * S[sx] + a1 * S[sx + 1]``;
* per output row the same ``fy`` and weights, but not clamped: the two
  source rows are clamped instead, so a border row blends one row with
  itself;
* the vertical pass as OpenCV's SIMD kernel computes it on 16-bit lanes,
  for every element of the row (the tail too):
  ``((h0 >> 4) * b0 >> 16) + ((h1 >> 4) * b1 >> 16)``, then
  ``(v + 2) >> 2`` saturated to uint8;
* the same size is a copy, and an exact 2x shrink in both axes is
  OpenCV's ``INTER_AREA`` instead: the mean of each 2x2 block,
  ``(a + b + c + d + 2) >> 2``.
"""

from __future__ import annotations

import functools

import numpy as np

COEF_BITS = 11
COEF_SCALE = 1 << COEF_BITS


@functools.lru_cache(maxsize=1024)
def _taps(in_size: int, out_size: int, clamp: bool) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(source index 0, source index 1, int64 weights (out, 2)) of one axis."""
    scale = 1.0 / (out_size / in_size)  # OpenCV's 1 / inv_scale, in double
    f = ((np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    if clamp:
        left = s < 0
        f[left], s[left] = 0.0, 0
        right = s >= in_size - 1
        f[right], s[right] = 0.0, in_size - 1
    w = np.stack([np.float32(1.0) - f, f], axis=1) * np.float32(COEF_SCALE)
    w = np.rint(w).astype(np.int64)
    i0 = np.clip(s, 0, in_size - 1)
    i1 = np.clip(s + 1, 0, in_size - 1)
    for a in (i0, i1, w):
        a.flags.writeable = False
    return i0, i1, w


def _area_half(img: np.ndarray) -> np.ndarray:
    a = img.astype(np.int32)
    s = a[0::2, 0::2] + a[0::2, 1::2] + a[1::2, 0::2] + a[1::2, 1::2]
    return ((s + 2) >> 2).astype(np.uint8)


def resize_linear(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, size)`` of an HW or HWC uint8 array; ``size`` is
    (width, height), as OpenCV's. As OpenCV returns it, an image of one
    channel comes back HW."""
    if img.dtype != np.uint8:
        raise TypeError(f"resize_linear takes uint8, not {img.dtype}")
    out_w, out_h = int(size[0]), int(size[1])
    if out_w <= 0 or out_h <= 0:
        raise ValueError(f"resize to an empty size {size}")
    src = img[..., None] if img.ndim == 2 else img
    h, w, c = src.shape
    if (out_h, out_w) == (h, w):
        out = src.copy()
    elif w == 2 * out_w and h == 2 * out_h:
        out = _area_half(src)
    else:
        out = _resize(src, out_w, out_h)
    return out[..., 0] if c == 1 else out


def _resize(src: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    h, w, c = src.shape
    x0, x1, a = _taps(w, out_w, True)
    y0, y1, b = _taps(h, out_h, False)
    s = src.astype(np.int64)
    rows = s[:, x0] * a[None, :, 0, None] + s[:, x1] * a[None, :, 1, None]  # (h, out_w, c)
    rows = rows.reshape(h, out_w * c)
    h0, h1 = rows[y0], rows[y1]
    b0, b1 = b[:, 0, None], b[:, 1, None]
    out = (((h0 >> 4) * b0 >> 16) + ((h1 >> 4) * b1 >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8).reshape(out_h, out_w, c)
