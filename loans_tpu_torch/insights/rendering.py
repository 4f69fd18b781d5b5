"""Drawing for prediction renders, in numpy (port of
``loans_tpu/insights/rendering.py``, which draws with Pillow).

The machines with the card have no Pillow, so the port draws the same
pixels itself, as ``data/image_ops.py`` computes Pillow's resizes:

* ``draw_boxes_on_image`` outlines yxyx boxes as Pillow 12.1.0's
  ``ImageDraw.rectangle(xy, outline=, width=)`` does (``libImaging/Draw.c``,
  ``ImagingDrawRectangle``): the corners are truncated toward zero (a C
  ``int`` cast), then for ``i < width`` two horizontal lines at rows
  ``y0 + i`` and ``y1 - i`` over columns ``[x0, x1]``, and two vertical lines
  at columns ``x0 + i`` and ``x1 - i`` from row ``y0 + width`` toward row
  ``y1 - width + 1``, that end row left out (Bresenham's ``line`` with
  ``dx = 0``), every pixel clipped to the image. Unordered corners raise
  ``ValueError``, as Pillow does; predicted boxes are ordered first, gt
  boxes are not (as in the JAX package).
* ``write_png`` saves an RGB, gray or RGBA uint8 array as a PNG, on
  ``zlib`` and ``struct``.

Images are HWC uint8 numpy arrays. The JAX package's ``scores`` argument,
text drawn with Pillow's bitmap font, is used only by its SSD renders
(ROADMAP.md Queue 1 item 12) and is not ported.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

# 20 distinguishable colors (the JAX package's COLOR_MAP)
COLOR_MAP = [
    (230, 25, 75),
    (60, 180, 75),
    (255, 225, 25),
    (0, 130, 200),
    (245, 130, 48),
    (145, 30, 180),
    (70, 240, 240),
    (240, 50, 230),
    (210, 245, 60),
    (250, 190, 190),
    (0, 128, 128),
    (230, 190, 255),
    (170, 110, 40),
    (255, 250, 200),
    (128, 0, 0),
    (170, 255, 195),
    (128, 128, 0),
    (255, 215, 180),
    (0, 0, 128),
    (128, 128, 128),
]
GT_COLOR = (255, 255, 255)


def to_rgb(image: np.ndarray) -> np.ndarray:
    """HW, HW1, HW3 or HW4 (uint8, or float in [0, 1] or [0, 255]) -> a new
    HW3 uint8 array, as the JAX package's ``_to_pil(...).convert("RGB")``:
    floats whose maximum is at most 1.5 are scaled by 255, clipped and
    truncated; gray is repeated, alpha dropped."""
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        arr = np.clip(arr * 255.0 if arr.max() <= 1.5 else arr, 0, 255).astype(np.uint8)
    if arr.ndim == 2:
        arr = arr[..., None]
    if arr.shape[-1] == 1:
        arr = np.repeat(arr, 3, axis=-1)
    return np.ascontiguousarray(arr[..., :3])


def _hline(img: np.ndarray, x0: int, y: int, x1: int, ink) -> None:
    h, w = img.shape[:2]
    if not 0 <= y < h:
        return
    x0, x1 = min(x0, x1), max(x0, x1)
    if x0 >= w or x1 < 0:
        return
    img[y, max(x0, 0) : min(x1, w - 1) + 1] = ink


def _vline(img: np.ndarray, x: int, y0: int, y1: int, ink) -> None:
    """The rows from ``y0`` toward ``y1``, ``y1`` left out."""
    h, w = img.shape[:2]
    if not 0 <= x < w:
        return
    lo, hi = (y0, y1) if y1 >= y0 else (y1 + 1, y0 + 1)
    img[max(lo, 0) : max(min(hi, h), 0), x] = ink


def draw_rectangle(img: np.ndarray, xy, ink, width: int = 1) -> None:
    """Pillow's ``ImageDraw.rectangle(xy, outline=ink, width=width)`` on an
    HW3 uint8 array, in place; ``xy`` is ``[x0, y0, x1, y1]``."""
    x0, y0, x1, y1 = (float(v) for v in xy)
    if x1 < x0:
        raise ValueError("x1 must be greater than or equal to x0")
    if y1 < y0:
        raise ValueError("y1 must be greater than or equal to y0")
    if width == 0:
        return
    x0, y0, x1, y1 = int(x0), int(y0), int(x1), int(y1)
    for i in range(width):
        _hline(img, x0, y0 + i, x1, ink)
        _hline(img, x0, y1 - i, x1, ink)
        _vline(img, x1 - i, y0 + width, y1 - width + 1, ink)
        _vline(img, x0 + i, y0 + width, y1 - width + 1, ink)


def draw_boxes_on_image(
    image: np.ndarray,
    boxes: np.ndarray,
    gt_boxes: np.ndarray | None = None,
    width: int = 2,
) -> np.ndarray:
    """Draw predicted (colored) and gt (white) yxyx boxes on a copy of an
    image; returns the HW3 uint8 canvas."""
    img = to_rgb(image)
    boxes = np.asarray(boxes, dtype=np.float64).reshape(-1, 4)
    for i, (y1, x1, y2, x2) in enumerate(boxes):
        x1, x2 = sorted((float(x1), float(x2)))
        y1, y2 = sorted((float(y1), float(y2)))
        draw_rectangle(img, [x1, y1, x2, y2], COLOR_MAP[i % len(COLOR_MAP)], width)
    if gt_boxes is not None:
        for y1, x1, y2, x2 in np.asarray(gt_boxes).reshape(-1, 4):
            draw_rectangle(img, [x1, y1, x2, y2], GT_COLOR, width)
    return img


def heatmap_to_rgb(heat: np.ndarray) -> np.ndarray:
    """(H, W, 1) or (H, W) heat map in [0, 1] -> (H, W, 3) uint8 gray tile."""
    h = np.asarray(heat)
    if h.ndim == 3 and h.shape[-1] == 1:
        h = h[..., 0]
    h8 = np.clip(h * 255.0, 0, 255).astype(np.uint8)
    return np.stack([h8] * 3, axis=-1)


def hstack_images(images: list[np.ndarray], pad: int = 2) -> np.ndarray:
    """Side by side, top-aligned, ``pad`` white columns between."""
    images = [to_rgb(im) for im in images]
    h = max(im.shape[0] for im in images)
    w = sum(im.shape[1] for im in images) + pad * (len(images) - 1)
    canvas = np.full((h, w, 3), 255, np.uint8)
    x = 0
    for im in images:
        canvas[: im.shape[0], x : x + im.shape[1]] = im
        x += im.shape[1] + pad
    return canvas


def vstack_images(images: list[np.ndarray], pad: int = 2) -> np.ndarray:
    """One above the other, left-aligned, ``pad`` white rows between."""
    images = [to_rgb(im) for im in images]
    w = max(im.shape[1] for im in images)
    h = sum(im.shape[0] for im in images) + pad * (len(images) - 1)
    canvas = np.full((h, w, 3), 255, np.uint8)
    y = 0
    for im in images:
        canvas[y : y + im.shape[0], : im.shape[1]] = im
        y += im.shape[0] + pad
    return canvas


_PNG_COLOR_TYPES = {1: 0, 3: 2, 4: 6}  # channels -> gray, RGB, RGBA


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def encode_png(image: np.ndarray) -> bytes:
    """The PNG file of an HW, HW1, HW3 or HW4 uint8 array (8 bits per
    sample, no filter, no interlace)."""
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        raise TypeError(f"encode_png takes uint8, not {arr.dtype}")
    if arr.ndim == 2:
        arr = arr[..., None]
    h, w, c = arr.shape
    if c not in _PNG_COLOR_TYPES or h == 0 or w == 0:
        raise ValueError(f"encode_png takes a non-empty HW, HW1, HW3 or HW4 array, not {arr.shape}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, w * c)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, _PNG_COLOR_TYPES[c], 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))


def write_png(path: str, image: np.ndarray) -> str:
    """Save ``image`` (see ``encode_png``) at ``path``."""
    with open(path, "wb") as f:
        f.write(encode_png(image))
    return path
