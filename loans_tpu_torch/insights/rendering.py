"""Drawing for prediction renders, in numpy (port of
``loans_tpu/insights/rendering.py``, which draws with Pillow).

A machine with the card need not have Pillow, so the port draws the same
pixels itself, as ``data/image_ops.py`` computes Pillow's resizes, but for
text:

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
* ``fill_ellipse`` stamps Pillow 12.1.0's ``ImageDraw.ellipse([cx - 3,
  cy - 3, cx + 3, cy + 3], fill=ink)`` (the BBoxPlotter's PCA dots) as one
  measured 7x7 mask, clipped to the image.
* ``draw_text`` writes text with Pillow's default font (in Pillow 12.1.0 a
  FreeType font, Aileron, anti-aliased), through Pillow itself: numpy
  cannot draw that font. Pillow is imported when text is drawn; without it
  text is refused by name (``TEXT_NEEDS_PILLOW``). ``draw_boxes_on_image``
  with ``scores`` writes each box's score after its outline and before the
  next box, in the JAX package's order, so a later outline may cover an
  earlier score.

Images are HWC uint8 numpy arrays.
"""

from __future__ import annotations

import importlib.util
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
TEXT_NEEDS_PILLOW = "text (scores, the BBoxPlotter's caption) is drawn with Pillow's font: Pillow is not installed"
# ImageDraw.ellipse([cx - 3, cy - 3, cx + 3, cy + 3], fill=...) of Pillow
# 12.1.0, rows cy - 3 .. cy + 3 by columns cx - 3 .. cx + 3
_ELLIPSE_7 = np.array([
    [0, 0, 1, 1, 1, 0, 0],
    [0, 1, 1, 1, 1, 1, 0],
    [1, 1, 1, 1, 1, 1, 1],
    [1, 1, 1, 1, 1, 1, 1],
    [1, 1, 1, 1, 1, 1, 1],
    [0, 1, 1, 1, 1, 1, 0],
    [0, 0, 1, 1, 1, 0, 0],
], dtype=bool)


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


def fill_ellipse(img: np.ndarray, cx: int, cy: int, ink) -> None:
    """Pillow's ``ImageDraw.ellipse([cx - 3, cy - 3, cx + 3, cy + 3],
    fill=ink)`` on an HW3 uint8 array, in place, for integer centers."""
    h, w = img.shape[:2]
    y0, x0 = cy - 3, cx - 3
    ys, xs = slice(max(y0, 0), min(y0 + 7, h)), slice(max(x0, 0), min(x0 + 7, w))
    if ys.start >= ys.stop or xs.start >= xs.stop:
        return
    mask = _ELLIPSE_7[ys.start - y0 : ys.stop - y0, xs.start - x0 : xs.stop - x0]
    img[ys, xs][mask] = ink


def pillow_installed() -> bool:
    return importlib.util.find_spec("PIL") is not None


def draw_text(img: np.ndarray, xy, text: str, ink) -> None:
    """Pillow's ``ImageDraw.Draw(image).text(xy, text, fill=ink)`` with its
    default font on an HW3 uint8 array, in place (through Pillow, imported
    here; without it ``RuntimeError(TEXT_NEEDS_PILLOW)``)."""
    try:
        from PIL import Image, ImageDraw
    except ImportError:
        raise RuntimeError(TEXT_NEEDS_PILLOW) from None
    canvas = Image.fromarray(img)
    ImageDraw.Draw(canvas).text(xy, text, fill=tuple(ink))
    img[...] = np.asarray(canvas)


def draw_boxes_on_image(
    image: np.ndarray,
    boxes: np.ndarray,
    gt_boxes: np.ndarray | None = None,
    scores=None,
    width: int = 2,
) -> np.ndarray:
    """Draw predicted (colored) and gt (white) yxyx boxes on a copy of an
    image, with each predicted box's score above it where ``scores`` is
    given (``draw_text``); returns the HW3 uint8 canvas."""
    img = to_rgb(image)
    boxes = np.asarray(boxes, dtype=np.float64).reshape(-1, 4)
    for i, (y1, x1, y2, x2) in enumerate(boxes):
        color = COLOR_MAP[i % len(COLOR_MAP)]
        x1, x2 = sorted((float(x1), float(x2)))
        y1, y2 = sorted((float(y1), float(y2)))
        draw_rectangle(img, [x1, y1, x2, y2], color, width)
        if scores is not None and i < len(scores):
            draw_text(img, (x1 + 2, max(y1 - 12, 0)), f"{scores[i]:.2f}", color)
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


def _filter_rows(arr: np.ndarray, filters) -> np.ndarray:
    """The PNG rows of an HWC uint8 array, each led by its filter type and
    filtered by it (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth). Every filter
    reads the raw bytes, so all rows are filtered at once."""
    h, w, c = arr.shape
    x = arr.reshape(h, w * c).astype(np.int16)
    left = np.zeros_like(x)
    left[:, c:] = x[:, :-c]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    up_left = np.zeros_like(x)
    up_left[:, c:] = up[:, :-c]
    pa, pb, pc = np.abs(up - up_left), np.abs(left - up_left), np.abs(left + up - 2 * up_left)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, up_left))
    pred = np.stack([np.zeros_like(x), left, up, (left + up) >> 1, paeth])
    f = np.broadcast_to(np.asarray(filters, np.int64), (h,))
    if f.min() < 0 or f.max() > 4:
        raise ValueError(f"PNG row filters are 0-4, not {sorted(set(f.tolist()))}")
    rows = ((x - pred[f, np.arange(h)]) & 0xFF).astype(np.uint8)
    return np.concatenate([f.astype(np.uint8)[:, None], rows], axis=1)


def encode_png(image: np.ndarray, filters=0) -> bytes:
    """The PNG file of an HW, HW1, HW3 or HW4 uint8 array (8 bits per
    sample, no interlace). ``filters``: the row filter type (0-4) of every
    row, or one per row; 0 (none) by default."""
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        raise TypeError(f"encode_png takes uint8, not {arr.dtype}")
    if arr.ndim == 2:
        arr = arr[..., None]
    h, w, c = arr.shape
    if c not in _PNG_COLOR_TYPES or h == 0 or w == 0:
        raise ValueError(f"encode_png takes a non-empty HW, HW1, HW3 or HW4 array, not {arr.shape}")
    if np.ndim(filters) == 0 and filters == 0:
        rows = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, w * c)], axis=1)
    else:
        rows = _filter_rows(arr, filters)
    header = struct.pack(">IIBBBBB", w, h, 8, _PNG_COLOR_TYPES[c], 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))


def write_png(path: str, image: np.ndarray, filters=0) -> str:
    """Save ``image`` (see ``encode_png``) at ``path``."""
    with open(path, "wb") as f:
        f.write(encode_png(image, filters))
    return path
