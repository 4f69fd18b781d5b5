"""A PNG decoder on ``zlib``, ``struct`` and numpy.

The machines with the card have no Pillow, and the port's datasets read
their images from PNG files (``data/datasets.py``). This module reads the
PNGs that Pillow and ``insights/rendering.py::encode_png`` write: colour
types 0 (gray), 2 (RGB), 3 (palette, with ``PLTE`` and ``tRNS``), 4 (gray
+ alpha) and 6 (RGBA) at 8 bits per sample, gray and palette images also
at 1, 2 or 4 bits (Pillow writes a small palette so), several ``IDAT``
chunks, and all five row filters. Every chunk's CRC is checked. Adam7
interlace, 16-bit samples and files that are not PNG are refused by name
(``PNGError``).

``read_png(path, mode)`` returns what Pillow's
``Image.open(path).convert(mode)`` returns as an HWC uint8 array, for
``mode`` 'RGB' (gray replicated, and scaled to 0-255 below 8 bits; alpha
dropped without compositing; palette looked up) or 'RGBA' (alpha 255
where the file has none; a ``tRNS`` chunk gives a palette's alpha, or
makes the one key colour of a gray or RGB image transparent).

Unfiltering: None, Sub and Up rows are whole-row numpy operations (Sub a
wrapping ``np.add.accumulate`` over the pixels). Average and Paeth read
the pixel to the left, already unfiltered, so an image with such rows is
unfiltered along its anti-diagonals: pixel (y, x) needs only (y, x - 1),
(y - 1, x) and (y - 1, x - 1), so every pixel of a diagonal ``x + y = d``
is computed at once, h + w - 1 numpy steps for the image, each row by its
own filter.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples per pixel
MODES = ("RGB", "RGBA")


class PNGError(ValueError):
    """A file that this decoder refuses or cannot read."""


def _chunks(data: bytes, name: str):
    if data[:8] != SIGNATURE:
        raise PNGError(f"{name}: not a PNG file (no PNG signature)")
    pos = 8
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        kind = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        crc = data[pos + 8 + length : pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise PNGError(f"{name}: truncated {kind!r} chunk")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise PNGError(f"{name}: bad CRC in the {kind!r} chunk")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise PNGError(f"{name}: no IEND chunk")


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    pa = np.abs(b - c)
    pb = np.abs(a - c)
    pc = np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter_rows(raw: np.ndarray, filters: np.ndarray, bpp: int) -> np.ndarray:
    """Images with None, Sub and Up rows only: one row at a time."""
    h, stride = raw.shape
    out = np.empty_like(raw)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        f, row = filters[y], raw[y]
        if f == 0:
            out[y] = row
        elif f == 1:
            out[y] = np.add.accumulate(row.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        else:
            np.add(row, prev, out=out[y])
        prev = out[y]
    return out


def _unfilter_diagonals(raw: np.ndarray, filters: np.ndarray, bpp: int) -> np.ndarray:
    """Any filters: along the anti-diagonals of the pixel grid.

    ``t[k, j]`` holds pixel (y, x) = (j - 1, k - j - 1): row j of column k
    is that row's pixel on diagonal ``x + y = k - 2``; row 0 and every
    position left of a row are zeros, as the filters read them."""
    h, stride = raw.shape
    w = stride // bpp
    pix = raw.reshape(h, w, bpp).astype(np.int16)
    ys, xs = np.mgrid[0:h, 0:w]
    k_of = xs + ys + 2
    skew = np.zeros((w + h + 1, h, bpp), np.int16)
    skew[k_of, ys] = pix
    t = np.zeros((w + h + 1, h + 1, bpp), np.int16)
    f = filters.astype(np.int16)[:, None]
    is_sub, is_up, is_avg, is_paeth = (f == 1), (f == 2), (f == 3), (f == 4)
    for k in range(2, w + h + 1):
        lo, hi = max(0, k - 1 - w), min(h, k - 1)  # rows whose x = k - y - 2 is in [0, w)
        a = t[k - 1, lo + 1 : hi + 1]  # left
        b = t[k - 1, lo:hi]  # up
        c = t[k - 2, lo:hi]  # up-left
        pred = np.where(
            is_sub[lo:hi], a,
            np.where(is_up[lo:hi], b,
                     np.where(is_avg[lo:hi], (a + b) >> 1,
                              np.where(is_paeth[lo:hi], _paeth(a, b, c), 0))))
        t[k, lo + 1 : hi + 1] = (skew[k, lo:hi] + pred) & 0xFF
    return t[k_of, ys + 1].astype(np.uint8).reshape(h, stride)


def _unfilter(raw: np.ndarray, bpp: int) -> np.ndarray:
    filters = raw[:, 0]
    if filters.max(initial=0) > 4:
        raise PNGError(f"unknown row filter {int(filters.max())}")
    rows = raw[:, 1:]
    if not filters.any():
        return rows
    if filters.max() <= 2:
        return _unfilter_rows(rows, filters, bpp)
    return _unfilter_diagonals(rows, filters, bpp)


def decode_png(data: bytes, mode: str = "RGB", name: str = "<bytes>") -> np.ndarray:
    """The pixels of a PNG file's bytes; see ``read_png``."""
    if mode not in MODES:
        raise PNGError(f"{name}: conversion to mode {mode!r} is not supported (only {MODES})")
    header, palette, trns, idat = None, None, None, []
    for kind, body in _chunks(data, name):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise PNGError(f"{name}: no IHDR chunk")
    w, h, depth, color, compression, filter_method, interlace = header
    if interlace:
        raise PNGError(f"{name}: Adam7 interlaced PNGs are not supported")
    if color not in CHANNELS or compression or filter_method:
        raise PNGError(f"{name}: colour type {color} / compression {compression} / filter method "
                       f"{filter_method} is not a PNG this decoder reads")
    if depth != 8 and not (color in (0, 3) and depth in (1, 2, 4)):
        raise PNGError(f"{name}: bit depth {depth} is not supported for colour type {color} (8 bits per "
                       f"sample; 1, 2 or 4 for gray and palette images)")
    if color == 3 and palette is None:
        raise PNGError(f"{name}: a palette image without a PLTE chunk")
    channels = CHANNELS[color]
    stride = (w * channels * depth + 7) // 8
    try:
        flat = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as e:
        raise PNGError(f"{name}: corrupt image data ({e})") from None
    if flat.size < h * (1 + stride):
        raise PNGError(f"{name}: {flat.size} bytes of image data, {h * (1 + stride)} expected")
    rows = _unfilter(flat[: h * (1 + stride)].reshape(h, 1 + stride), max(1, channels * depth // 8))
    if depth < 8:  # samples packed high bits first
        bits = np.unpackbits(rows, axis=1)[:, : w * depth].reshape(h, w, depth)
        rows = bits @ (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return _convert(rows.reshape(h, w, channels), color, depth, palette, trns, mode)


def _convert(pix: np.ndarray, color: int, depth: int, palette, trns, mode: str) -> np.ndarray:
    h, w = pix.shape[:2]
    alpha = None
    if color == 3:
        lut = np.zeros((256, 4), np.uint8)
        lut[:, 3] = 255
        lut[: len(palette), :3] = palette
        if trns is not None:
            lut[: len(trns), 3] = np.frombuffer(trns, np.uint8)[:256]
        rgba = lut[pix[..., 0]]
        rgb, alpha = rgba[..., :3], rgba[..., 3]
    elif color in (0, 4):
        rgb = np.repeat(pix[..., :1] * np.uint8(255 // ((1 << depth) - 1)), 3, axis=2)
        if color == 4:
            alpha = pix[..., 1]
        elif trns is not None and len(trns) >= 2:
            (key,) = struct.unpack(">H", trns[:2])
            alpha = np.where(pix[..., 0] == key, 0, 255).astype(np.uint8)
    else:
        rgb = pix[..., :3]
        if color == 6:
            alpha = pix[..., 3]
        elif trns is not None and len(trns) >= 6:
            key = np.array(struct.unpack(">HHH", trns[:6]))
            alpha = np.where((pix == key).all(axis=2), 0, 255).astype(np.uint8)
    if mode == "RGB":
        return np.ascontiguousarray(rgb)
    if alpha is None:
        alpha = np.full((h, w), 255, np.uint8)
    return np.concatenate([rgb, alpha[..., None]], axis=2)


def is_png(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(8) == SIGNATURE


def read_png(path: str, mode: str = "RGB") -> np.ndarray:
    """Pillow's ``Image.open(path).convert(mode)`` of an 8-bit,
    non-interlaced PNG, as an HWC uint8 array; ``mode`` 'RGB' or 'RGBA'."""
    with open(path, "rb") as f:
        return decode_png(f.read(), mode, name=path)
