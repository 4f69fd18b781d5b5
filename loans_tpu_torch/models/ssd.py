"""SSD300 / SSD512 single-shot detector, the supervised baseline (port of
``loans_tpu/models/ssd.py``).

VGG16 through conv5_3, fc6/fc7 as atrous convolutions, the extra feature
layers and a multibox head over 6 (SSD300) or 7 (SSD512) feature scales,
with conv4_3 L2-normalized as a source. As in the JAX package:

* the input is ``images * 255 - mean`` (caffe's VGG mean, RGB order);
* pool3 is chainer's ceil mode where its input side is odd (75 -> 38 for
  SSD300: -inf padding on the bottom and right); pool5 is 3x3, stride 1,
  pad 1; fc6 is a 3x3 convolution at dilation 6, padding 6;
* L2Norm runs in float32 with 1e-12 inside the square root, on conv4_3's
  output as a source only: pool4 takes the unnormalized tensor;
* the head's convolutions give (N, C, H, W); each is laid out as NHWC
  before the (N, H * W * n_box, ·) reshape, so anchors are ordered row,
  column, box as ``ops.multibox.default_boxes`` lays them out;
* with ``dtype=torch.bfloat16`` the convolutions compute in bfloat16
  (parameters stay float32) and the multibox outputs are cast to float32.

Submodules carry flax's module names (``VGG16Extractor_0/Conv_3``,
``VGG16Extractor_0/L2Norm_0``, ``Multibox_0/Conv_5``, ...), so the bridge
maps the JAX package's parameters onto them (``bridge.ssd_state_dict``).
Weights start as flax's initialisers draw them in distribution (He normal,
truncated at two standard deviations; zero biases; L2Norm's scale 20), not
in value.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from loans_tpu_torch.models.resnet import Conv2d, set_dtypes
from loans_tpu_torch.ops.multibox import MultiboxCoder, default_boxes

# caffe's VGG mean, RGB order, for x*255 inputs
VGG_MEAN_RGB = (123.68, 116.779, 103.939)
_TRUNCATED_STD = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]


def _conv(in_ch: int, ch: int, k: int, stride: int = 1, pad: int | None = None, dilation: int = 1) -> Conv2d:
    """flax's ``nn.Conv`` with He-normal weights (truncated normal, as
    ``nn.initializers.he_normal``) and a zero bias."""
    conv = Conv2d(in_ch, ch, k, stride=stride, padding=k // 2 if pad is None else pad, dilation=dilation)
    std = math.sqrt(2.0 / (in_ch * k * k)) / _TRUNCATED_STD
    nn.init.trunc_normal_(conv.weight, 0.0, std, -2.0 * std, 2.0 * std)
    nn.init.zeros_(conv.bias)
    return conv


class L2Norm(nn.Module):
    """Channelwise L2 normalization with a learnable scale, in float32.

    Its parameter is flax's ``scale`` leaf, named ``weight`` here as the
    bridge names every ``scale`` leaf. It is not a bias, so the SSD
    optimizer decays it.
    """

    def __init__(self, ch: int, scale_init: float = 20.0):
        super().__init__()
        self.weight = nn.Parameter(torch.full((ch,), scale_init))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        norm = torch.sqrt(torch.sum(torch.square(x), dim=1, keepdim=True) + 1e-12)
        return x / norm * self.weight[:, None, None]


def _pool(x: torch.Tensor, ceil: bool = False) -> torch.Tensor:
    if ceil:  # flax's max_pool with ((0, 1), (0, 1)) padding at -inf
        x = F.pad(x, (0, 1, 0, 1), value=-math.inf)
    return F.max_pool2d(x, 2, 2)


class VGG16Extractor(nn.Module):
    """VGG16 with SSD's changes; returns the sources conv4_3 (L2-normalized)
    and conv7 (the atrous fc7)."""

    def __init__(self):
        super().__init__()
        chans = [(3, 64), (64, 64), (64, 128), (128, 128), (128, 256), (256, 256), (256, 256),
                 (256, 512), (512, 512), (512, 512), (512, 512), (512, 512), (512, 512)]
        for i, (c_in, c_out) in enumerate(chans):
            self.add_module(f"Conv_{i}", _conv(c_in, c_out, 3))
        self.L2Norm_0 = L2Norm(512)
        self.Conv_13 = _conv(512, 1024, 3, pad=6, dilation=6)  # fc6
        self.Conv_14 = _conv(1024, 1024, 1, pad=0)  # fc7

    def _block(self, x: torch.Tensor, first: int, n: int) -> torch.Tensor:
        for i in range(first, first + n):
            x = F.relu(getattr(self, f"Conv_{i}")(x))
        return x

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        x = _pool(self._block(x, 0, 2))
        x = _pool(self._block(x, 2, 2))
        x = self._block(x, 4, 3)
        x = _pool(x, ceil=x.shape[2] % 2 == 1)  # 75 -> 38 for SSD300
        x = self._block(x, 7, 3)
        conv4_3 = self.L2Norm_0(x).to(x.dtype)
        x = _pool(x)
        x = self._block(x, 10, 3)
        x = F.max_pool2d(x, 3, 1, padding=1)  # pool5
        x = F.relu(self.Conv_13(x))
        return conv4_3, F.relu(self.Conv_14(x))


class ExtraLayers(nn.Module):
    """conv8 .. conv11 (and conv12 for SSD512): 1x1 then 3x3 pairs."""

    def __init__(self, input_size: int = 300):
        super().__init__()
        if input_size == 300:
            specs = [(256, 512, 2, 1), (128, 256, 2, 1), (128, 256, 1, 0), (128, 256, 1, 0)]
        else:
            specs = [(256, 512, 2, 1)] + [(128, 256, 2, 1)] * 4
        c_in = 1024
        self._n = len(specs)
        for i, (mid, out, stride, pad) in enumerate(specs):
            self.add_module(f"Conv_{2 * i}", _conv(c_in, mid, 1, pad=0))
            self.add_module(f"Conv_{2 * i + 1}", _conv(mid, out, 3, stride=stride, pad=pad))
            c_in = out

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        sources = []
        for i in range(self._n):
            x = F.relu(getattr(self, f"Conv_{2 * i}")(x))
            x = F.relu(getattr(self, f"Conv_{2 * i + 1}")(x))
            sources.append(x)
        return sources


class Multibox(nn.Module):
    """Per-scale loc/conf heads -> concatenated (N, K, 4) and (N, K, C+1)
    float32 outputs."""

    def __init__(self, n_fg_class: int, source_channels: Sequence[int], aspect_ratios: Sequence[tuple[int, ...]]):
        super().__init__()
        self.n_fg_class = n_fg_class
        for i, (ch, ars) in enumerate(zip(source_channels, aspect_ratios)):
            n_box = 2 + 2 * len(ars)
            self.add_module(f"Conv_{2 * i}", _conv(ch, n_box * 4, 3))
            self.add_module(f"Conv_{2 * i + 1}", _conv(ch, n_box * (n_fg_class + 1), 3))
        self._n = len(source_channels)

    def forward(self, sources: Sequence[torch.Tensor]) -> tuple[torch.Tensor, torch.Tensor]:
        locs, confs = [], []
        for i, x in enumerate(sources):
            n = x.shape[0]
            loc = getattr(self, f"Conv_{2 * i}")(x).permute(0, 2, 3, 1)  # NHWC, flax's reshape order
            conf = getattr(self, f"Conv_{2 * i + 1}")(x).permute(0, 2, 3, 1)
            locs.append(loc.reshape(n, -1, 4))
            confs.append(conf.reshape(n, -1, self.n_fg_class + 1))
        return torch.cat(locs, dim=1).float(), torch.cat(confs, dim=1).float()


_SSD300_SPEC = dict(
    input_size=300,
    grids=(38, 19, 10, 5, 3, 1),
    steps=(8, 16, 32, 64, 100, 300),
    sizes=(30, 60, 111, 162, 213, 264, 315),
    aspect_ratios=((2,), (2, 3), (2, 3), (2, 3), (2,), (2,)),
    source_channels=(512, 1024, 512, 256, 256, 256),
)
_SSD512_SPEC = dict(
    input_size=512,
    grids=(64, 32, 16, 8, 4, 2, 1),
    steps=(8, 16, 32, 64, 128, 256, 512),
    sizes=(35.84, 76.8, 153.6, 230.4, 307.2, 384.0, 460.8, 537.6),
    aspect_ratios=((2,), (2, 3), (2, 3), (2, 3), (2, 3), (2,), (2,)),
    source_channels=(512, 1024, 512, 256, 256, 256, 256),
)


class SSD(nn.Module):
    """Full SSD: images (N, S, S, 3) RGB in [0, 1], NHWC -> (mb_loc (N, K,
    4), mb_conf (N, K, n_fg_class + 1)), both float32. SSD-VGG has no
    BatchNorm, so train and eval mode compute the same."""

    def __init__(self, n_fg_class: int = 1, input_size: int = 300, dtype: torch.dtype = torch.float32):
        super().__init__()
        if input_size not in (300, 512):
            raise ValueError(f"SSD takes input_size 300 or 512, got {input_size}")
        self.n_fg_class = n_fg_class
        self.input_size = input_size
        self.spec = _SSD300_SPEC if input_size == 300 else _SSD512_SPEC
        self.VGG16Extractor_0 = VGG16Extractor()
        self.ExtraLayers_0 = ExtraLayers(input_size)
        self.Multibox_0 = Multibox(n_fg_class, self.spec["source_channels"], self.spec["aspect_ratios"])
        self.register_buffer("mean", torch.tensor(VGG_MEAN_RGB), persistent=False)
        set_dtypes(self, dtype, torch.float32)

    @property
    def grids(self) -> tuple[int, ...]:
        return self.spec["grids"]

    def default_bbox(self) -> np.ndarray:
        s = self.spec
        return default_boxes(s["input_size"], s["grids"], s["steps"], s["sizes"], s["aspect_ratios"])

    def coder(self) -> MultiboxCoder:
        return MultiboxCoder(self.default_bbox())

    def forward(self, images: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        x = (images * 255.0 - self.mean.to(images.dtype)).permute(0, 3, 1, 2)
        dtype = self.VGG16Extractor_0.Conv_0.compute_dtype
        if dtype is not None:  # the JAX SSD casts before its extractor
            x = x.to(dtype)
        conv4_3, conv7 = self.VGG16Extractor_0(x)
        sources = [conv4_3, conv7] + self.ExtraLayers_0(conv7)
        return self.Multibox_0(sources)


def SSD300(n_fg_class: int = 1, dtype: torch.dtype = torch.float32) -> SSD:
    return SSD(n_fg_class=n_fg_class, input_size=300, dtype=dtype)


def SSD512(n_fg_class: int = 1, dtype: torch.dtype = torch.float32) -> SSD:
    return SSD(n_fg_class=n_fg_class, input_size=512, dtype=dtype)
