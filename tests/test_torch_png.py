"""The port's PNG decoder (``loans_tpu_torch/data/png.py``) against Pillow.

* Pillow-written files of every colour type it writes (L, LA, P with and
  without transparency, RGB, RGBA; Pillow packs a palette of few colours
  in 1, 2 or 4 bits), over sizes drawn by hypothesis: ``read_png(p,
  mode)`` equals Pillow's
  ``Image.open(p).convert(mode)`` pixel for pixel, for 'RGB' and 'RGBA';
* files whose rows take each of the five filters (and a mix), written by
  ``insights.rendering.encode_png(filters=)``, read back equal to the
  array and to Pillow's reading, in every channel count, several IDAT
  chunks included;
* ``rendering.write_png`` round-trips;
* Adam7 interlace, a 16-bit file, a bad CRC and a file that is not a PNG
  are refused by name.
"""

import io
import struct
import zlib

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from loans_tpu_torch.data import png
from loans_tpu_torch.insights import rendering


def _image(rng, h, w, c):
    """Smooth gradients plus noise: Pillow's adaptive filter picks a mix of
    filters on such rows."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = (yy * 3 + xx * 5)[..., None] + np.arange(c) * 40
    return ((base + rng.integers(0, 12, (h, w, c))) % 256).astype(np.uint8)


def _pillow(img: Image.Image, **save) -> bytes:
    buf = io.BytesIO()
    img.save(buf, "PNG", **save)
    return buf.getvalue()


def _filters_used(data: bytes) -> set[int]:
    body = b"".join(b for k, b in png._chunks(data, "x") if k == b"IDAT")
    header = next(b for k, b in png._chunks(data, "x") if k == b"IHDR")
    w, h, _, color = struct.unpack(">IIBB", header[:10])
    rows = np.frombuffer(zlib.decompress(body), np.uint8).reshape(h, -1)
    return set(rows[:, 0].tolist())


def _pillow_images(rng, h, w):
    rgb = _image(rng, h, w, 3)
    rgba = np.concatenate([rgb, _image(rng, h, w, 1)], axis=2)
    pal = Image.fromarray(rgb).quantize(64)
    pal_t = pal.copy()
    pal_t.info["transparency"] = bytes(range(0, 256, 4))
    return {
        "L": Image.fromarray(rgb).convert("L"),
        "LA": Image.fromarray(rgba).convert("LA"),
        "P": pal,
        "P+tRNS": pal_t,
        "RGB": Image.fromarray(rgb),
        "RGBA": Image.fromarray(rgba),
    }


@settings(max_examples=12, deadline=None)
@given(h=st.integers(1, 40), w=st.integers(1, 40), seed=st.integers(0, 2**16))
def test_pillow_files_decode_as_pillow_converts(h, w, seed):
    rng = np.random.default_rng(seed)
    for name, img in _pillow_images(rng, h, w).items():
        data = _pillow(img)
        for mode in ("RGB", "RGBA"):
            want = np.asarray(Image.open(io.BytesIO(data)).convert(mode))
            got = png.decode_png(data, mode)
            assert got.dtype == np.uint8 and got.shape == want.shape, (name, mode)
            np.testing.assert_array_equal(got, want, err_msg=f"{name} -> {mode}")


def test_pillow_writes_the_sequential_filters():
    """Pillow's adaptive filter mixes rows of several filters, Average and
    Paeth among them, which the decoder unfilters along anti-diagonals."""
    rng = np.random.default_rng(0)
    used = set()
    for img in _pillow_images(rng, 64, 80).values():
        data = _pillow(img)
        used |= _filters_used(data)
        np.testing.assert_array_equal(png.decode_png(data), np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))
    assert {1, 2, 4} <= used, used


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("filters", ["none", "sub", "up", "average", "paeth", "mixed"])
def test_each_filter_reads_back(channels, filters, tmp_path):
    rng = np.random.default_rng(channels)
    img = _image(rng, 37, 53, channels)
    f = {"none": 0, "sub": 1, "up": 2, "average": 3, "paeth": 4}.get(filters, np.arange(37) % 5)
    data = rendering.encode_png(img, f)
    assert _filters_used(data) == ({f} if np.ndim(f) == 0 else {0, 1, 2, 3, 4})
    want_rgb = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    np.testing.assert_array_equal(png.decode_png(data, "RGB"), want_rgb)
    np.testing.assert_array_equal(png.decode_png(data, "RGBA"),
                                  np.asarray(Image.open(io.BytesIO(data)).convert("RGBA")))
    if channels == 3:
        np.testing.assert_array_equal(png.decode_png(data, "RGB"), img)


def test_several_idat_chunks(tmp_path):
    img = _image(np.random.default_rng(1), 30, 20, 3)
    data = rendering.encode_png(img, np.arange(30) % 5)
    chunks = list(png._chunks(data, "x"))
    body = b"".join(b for k, b in chunks if k == b"IDAT")
    parts = [body[i : i + 97] for i in range(0, len(body), 97)]
    split = png.SIGNATURE + rendering._chunk(b"IHDR", chunks[0][1])
    split += b"".join(rendering._chunk(b"IDAT", p) for p in parts) + rendering._chunk(b"IEND", b"")
    assert len(parts) > 3
    np.testing.assert_array_equal(png.decode_png(split), img)
    np.testing.assert_array_equal(png.decode_png(split), np.asarray(Image.open(io.BytesIO(split)).convert("RGB")))


def test_write_png_round_trips(tmp_path):
    img = _image(np.random.default_rng(2), 16, 24, 3)
    path = rendering.write_png(str(tmp_path / "x.png"), img)
    assert png.is_png(path)
    np.testing.assert_array_equal(png.read_png(path), img)
    np.testing.assert_array_equal(png.read_png(path, "RGBA")[..., 3], 255)


def _header(data: bytes, **fields) -> bytes:
    chunks = list(png._chunks(data, "x"))
    w, h, depth, color, comp, filt, interlace = struct.unpack(">IIBBBBB", chunks[0][1])
    vals = dict(w=w, h=h, depth=depth, color=color, comp=comp, filt=filt, interlace=interlace)
    vals.update(fields)
    ihdr = struct.pack(">IIBBBBB", *vals.values())
    return png.SIGNATURE + b"".join(rendering._chunk(k, ihdr if k == b"IHDR" else b) for k, b in chunks)


def test_refusals(tmp_path):
    data = rendering.encode_png(np.zeros((4, 4, 3), np.uint8))
    with pytest.raises(png.PNGError, match="Adam7 interlaced"):
        png.decode_png(_header(data, interlace=1))
    sixteen = _pillow(Image.fromarray(np.arange(64, dtype=np.uint16).reshape(8, 8) * 1000))
    assert next(b for k, b in png._chunks(sixteen, "x") if k == b"IHDR")[8] == 16
    with pytest.raises(png.PNGError, match="bit depth 16"):
        png.decode_png(sixteen)
    bad = bytearray(data)
    bad[-20] ^= 1  # inside the IDAT chunk
    with pytest.raises(png.PNGError, match="bad CRC"):
        png.decode_png(bytes(bad))
    with pytest.raises(png.PNGError, match="not a PNG"):
        png.decode_png(b"GIF89a" + bytes(20))
    with pytest.raises(png.PNGError, match="mode 'L'"):
        png.decode_png(data, "L")
