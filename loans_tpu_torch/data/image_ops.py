"""The image operations of the synthetic world, in numpy, bit-equal to
Pillow's.

The JAX package composes its synthetic scenes with Pillow
(``loans_tpu/data/synthetic.py``); the machines with the card have no
Pillow, so the port computes the same integers itself. Images are HWC
uint8 numpy arrays, RGB (C = 3) or RGBA (C = 4); sizes are (width,
height), as Pillow's.

Resizing follows Pillow's two-pass resampler (``libImaging/Resample.c``):
the horizontal pass first if the width changes, then the vertical pass if
the height changes, with a uint8 image in between. Per axis, output ``i``
reads inputs ``[xmin, xmax)`` around ``center = (i + 0.5) * in / out`` with
filter weights ``f((x - center + 0.5) / fs)``, ``fs = max(in / out, 1)``,
normalised by their sum and rounded to integers of 22 fractional bits
(away from zero); a pixel is ``clip((sum(w * p) + 2^21) >> 22, 0, 255)``.
The sums run as float64 matmuls against a dense (out, in) matrix of those
integers: every product and partial sum is an integer below 2^53, so the
result is exact in any order. An RGBA resize premultiplies the colour by
alpha first and divides it out after, as Pillow's ``RGBa`` round trip.
"""

from __future__ import annotations

import functools
import math

import numpy as np

_PRECISION_BITS = 22  # 32 - 8 - 2, Pillow's for 8-bit images
_SUPPORT = {"bilinear": 1.0, "bicubic": 2.0, "lanczos": 3.0}


def _bilinear(x: float) -> float:
    x = abs(x)
    return 1.0 - x if x < 1.0 else 0.0


def _bicubic(x: float, a: float = -0.5) -> float:
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _lanczos(x: float) -> float:
    return _sinc(x) * _sinc(x / 3.0) if -3.0 <= x < 3.0 else 0.0


_FILTERS = {"bilinear": _bilinear, "bicubic": _bicubic, "lanczos": _lanczos}


@functools.lru_cache(maxsize=4096)
def _matrix(in_size: int, out_size: int, method: str) -> np.ndarray:
    """The (out, in) float64 matrix of integer weights of one axis."""
    filt = _FILTERS[method]
    scale = in_size / out_size
    fs = max(scale, 1.0)
    support = _SUPPORT[method] * fs
    ss = 1.0 / fs
    m = np.zeros((out_size, in_size), dtype=np.float64)
    for i in range(out_size):
        center = (i + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        w = [filt((x - center + 0.5) * ss) for x in range(xmin, xmax)]
        total = sum(w)
        if total != 0.0:
            w = [v / total for v in w]
        m[i, xmin:xmax] = [
            int(-0.5 + v * (1 << _PRECISION_BITS)) if v < 0
            else int(0.5 + v * (1 << _PRECISION_BITS))
            for v in w
        ]
    m.flags.writeable = False
    return m


def _to_uint8(acc: np.ndarray) -> np.ndarray:
    # (acc + 2^21) >> 22, clipped: the division by a power of two is exact
    out = np.floor((acc + float(1 << (_PRECISION_BITS - 1))) / float(1 << _PRECISION_BITS))
    return np.clip(out, 0, 255).astype(np.uint8)


def _resample(arr: np.ndarray, size: tuple[int, int], method: str) -> np.ndarray:
    h, w, c = arr.shape
    out_w, out_h = size
    if out_w != w:
        m = _matrix(w, out_w, method)
        acc = np.tensordot(arr.astype(np.float64), m, axes=([1], [1]))  # (h, c, out_w)
        arr = _to_uint8(acc.transpose(0, 2, 1))
    if out_h != h:
        m = _matrix(h, out_h, method)
        flat = arr.reshape(h, -1).astype(np.float64)
        arr = _to_uint8(m @ flat).reshape(out_h, out_w, c)
    return arr


def _premultiply(arr: np.ndarray) -> np.ndarray:
    a = arr[..., 3:].astype(np.int64)
    t = arr[..., :3].astype(np.int64) * a + 128
    out = arr.copy()
    out[..., :3] = ((t >> 8) + t) >> 8
    return out


def _unpremultiply(arr: np.ndarray) -> np.ndarray:
    a = arr[..., 3:].astype(np.int64)
    partial = (a > 0) & (a < 255)
    c = np.minimum(255 * arr[..., :3].astype(np.int64) // np.maximum(a, 1), 255)
    out = arr.copy()
    out[..., :3] = np.where(partial, c, arr[..., :3])
    return out


def resize(arr: np.ndarray, size: tuple[int, int], method: str) -> np.ndarray:
    """Pillow's ``Image.resize(size, BILINEAR | BICUBIC | LANCZOS)`` of an
    RGB or RGBA uint8 array; ``size`` is (width, height), ``method``
    'bilinear', 'bicubic' or 'lanczos'. The same size returns a copy."""
    if method not in _FILTERS:
        raise ValueError(f"unknown resize method: {method!r}")
    size = (int(size[0]), int(size[1]))
    if size[0] <= 0 or size[1] <= 0:
        raise ValueError(f"resize to an empty size {size}")
    if (arr.shape[1], arr.shape[0]) == size:
        return arr.copy()
    if arr.shape[2] == 4:
        return _unpremultiply(_resample(_premultiply(arr), size, method))
    return _resample(arr, size, method)


def alpha_composite(dst: np.ndarray, src: np.ndarray) -> np.ndarray:
    """Pillow's ``Image.alpha_composite(dst, src)`` of two RGBA arrays of
    one shape: ``src`` over ``dst``, in integers with 7 bits of precision.
    Where ``src`` is fully transparent, ``dst`` passes through."""
    if dst.shape != src.shape or dst.shape[-1] != 4:
        raise ValueError(f"alpha_composite takes two RGBA arrays of one shape, got {dst.shape} and {src.shape}")
    out = dst.copy()
    live = src[..., 3] != 0
    if not live.any():
        return out
    s = src[live].astype(np.int64)
    d = dst[live].astype(np.int64)
    sa, da = s[:, 3:], d[:, 3:]
    blend = da * (255 - sa)
    outa255 = sa * 255 + blend
    coef1 = sa * 255 * 255 * (1 << 7) // outa255
    coef2 = 255 * (1 << 7) - coef1
    t = s[:, :3] * coef1 + d[:, :3] * coef2 + (0x80 << 7)
    rgb = (((t >> 8) + t) >> 8) >> 7
    t = outa255 + 0x80
    alpha = ((t >> 8) + t) >> 8
    out[live] = np.concatenate([rgb, alpha], axis=1).astype(np.uint8)
    return out


def paste(dst: np.ndarray, src: np.ndarray, xy: tuple[int, int]) -> np.ndarray:
    """Pillow's ``dst.paste(src, xy)`` without a mask: a plain copy of every
    channel, clipped to ``dst``; in place, returns ``dst``."""
    x, y = int(xy[0]), int(xy[1])
    h, w = src.shape[:2]
    x0, y0 = max(x, 0), max(y, 0)
    x1, y1 = min(x + w, dst.shape[1]), min(y + h, dst.shape[0])
    if x1 > x0 and y1 > y0:
        dst[y0:y1, x0:x1] = src[y0 - y : y1 - y, x0 - x : x1 - x]
    return dst


def crop(arr: np.ndarray, box) -> np.ndarray:
    """Pillow's ``Image.crop((x0, y0, x1, y1))``: the region, with zeros
    where it leaves the image."""
    x0, y0, x1, y1 = (int(v) for v in box)
    out = np.zeros((max(y1 - y0, 0), max(x1 - x0, 0), arr.shape[2]), dtype=arr.dtype)
    return paste(out, arr, (-x0, -y0))


def flip_lr(arr: np.ndarray) -> np.ndarray:
    """``Image.transpose(FLIP_LEFT_RIGHT)``."""
    return np.ascontiguousarray(arr[:, ::-1])


def to_rgba(arr: np.ndarray) -> np.ndarray:
    """``convert('RGBA')`` of an RGB array: alpha 255."""
    alpha = np.full(arr.shape[:2] + (1,), 255, dtype=np.uint8)
    return np.concatenate([arr, alpha], axis=2)


def to_rgb(arr: np.ndarray) -> np.ndarray:
    """``convert('RGB')`` of an RGBA array: alpha dropped."""
    return np.ascontiguousarray(arr[..., :3])
