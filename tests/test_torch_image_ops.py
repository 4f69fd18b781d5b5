"""``loans_tpu_torch.data.image_ops`` against Pillow, bit for bit.

The JAX package composes its synthetic world with Pillow; the port
computes the same integers with numpy (``image_ops``), because the card's
machine has no Pillow. Pillow is used here, in the test only, as the
oracle: every operation must return exactly Pillow's bytes. Hypothesis
draws sizes from 1 to 260 px up and down, the three filters (bicubic for
the media helpers' even-size frames), RGB and RGBA, and
alphas of 0, 255 and in between.
"""

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st
from PIL import Image

from loans_tpu_torch.data import image_ops

FILTERS = {"bilinear": Image.BILINEAR, "bicubic": Image.BICUBIC, "lanczos": Image.LANCZOS}


def _image(seed: int, w: int, h: int, channels: int, alpha: str) -> np.ndarray:
    rng = np.random.default_rng(seed)
    arr = rng.integers(0, 256, (h, w, channels), dtype=np.uint8)
    if channels == 4:
        a = rng.integers(0, 256, (h, w))
        if alpha == "mixed":  # exact 0 and 255 beside values in between
            a[rng.uniform(size=(h, w)) < 0.25] = 0
            a[rng.uniform(size=(h, w)) < 0.25] = 255
        else:
            a[...] = {"zero": 0, "opaque": 255}[alpha]
        arr[..., 3] = a
    return arr


def _pil(arr: np.ndarray) -> Image.Image:
    return Image.fromarray(arr, "RGBA" if arr.shape[2] == 4 else "RGB")


sizes = st.integers(1, 260)


@settings(max_examples=120, deadline=None)
@given(
    seed=st.integers(0, 2**31),
    w=st.integers(1, 96), h=st.integers(1, 96), out_w=sizes, out_h=sizes,
    channels=st.sampled_from([3, 4]),
    alpha=st.sampled_from(["mixed", "zero", "opaque"]),
    method=st.sampled_from(sorted(FILTERS)),
)
def test_resize_matches_pillow(seed, w, h, out_w, out_h, channels, alpha, method):
    arr = _image(seed, w, h, channels, alpha)
    want = np.asarray(_pil(arr).resize((out_w, out_h), FILTERS[method]))
    got = image_ops.resize(arr, (out_w, out_h), method)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 2**31), big=sizes, small=st.integers(1, 40),
       method=st.sampled_from(sorted(FILTERS)), channels=st.sampled_from([3, 4]))
def test_resize_large_factors_match_pillow(seed, big, small, method, channels):
    """Down by up to 260x and up by as much, the synthetic world's extremes
    (a 24^2 noise field to 256^2, a 256^2 background to a few pixels)."""
    arr = _image(seed, big, small, channels, "mixed")
    for size in ((small, big), (big, small), (1, 1)):
        want = np.asarray(_pil(arr).resize(size, FILTERS[method]))
        np.testing.assert_array_equal(image_ops.resize(arr, size, method), want)


def test_resize_same_size_is_a_copy():
    arr = _image(0, 7, 5, 4, "mixed")
    out = image_ops.resize(arr, (7, 5), "lanczos")
    np.testing.assert_array_equal(out, arr)
    assert out is not arr
    with pytest.raises(ValueError):
        image_ops.resize(arr, (7, 5), "nearest")


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2**31), w=st.integers(1, 64), h=st.integers(1, 64),
       alpha=st.sampled_from(["mixed", "zero", "opaque"]))
def test_alpha_composite_matches_pillow(seed, w, h, alpha):
    dst = _image(seed, w, h, 4, "mixed")
    src = _image(seed + 1, w, h, 4, alpha)
    want = np.asarray(Image.alpha_composite(_pil(dst), _pil(src)))
    np.testing.assert_array_equal(image_ops.alpha_composite(dst, src), want)


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2**31), w=st.integers(1, 48), h=st.integers(1, 48),
       box=st.tuples(st.integers(-60, 60), st.integers(-60, 60), st.integers(1, 80), st.integers(1, 80)),
       channels=st.sampled_from([3, 4]))
def test_crop_and_paste_match_pillow(seed, w, h, box, channels):
    """Crop with zero fill outside the image; paste without a mask as a
    plain copy of every channel, clipped to the destination."""
    arr = _image(seed, w, h, channels, "mixed")
    x0, y0, cw, ch = box
    crop_box = (x0, y0, x0 + cw, y0 + ch)
    np.testing.assert_array_equal(image_ops.crop(arr, crop_box), np.asarray(_pil(arr).crop(crop_box)))
    dst = _image(seed + 2, 40, 30, channels, "mixed")
    want = _pil(dst)
    want.paste(_pil(arr), (x0, y0))
    np.testing.assert_array_equal(image_ops.paste(dst.copy(), arr, (x0, y0)), np.asarray(want))


def test_flip_and_conversions_match_pillow():
    rgba = _image(3, 13, 9, 4, "mixed")
    rgb = _image(4, 13, 9, 3, "mixed")
    np.testing.assert_array_equal(
        image_ops.flip_lr(rgba), np.asarray(_pil(rgba).transpose(Image.FLIP_LEFT_RIGHT)))
    np.testing.assert_array_equal(image_ops.to_rgb(rgba), np.asarray(_pil(rgba).convert("RGB")))
    np.testing.assert_array_equal(image_ops.to_rgba(rgb), np.asarray(_pil(rgb).convert("RGBA")))
