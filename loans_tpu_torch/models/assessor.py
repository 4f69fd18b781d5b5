"""Assessor: regresses crop quality (IoU) in [0, 1] (port of
``loans_tpu/models/assessor.py``).

Four pre-activation residual down-blocks at ``ch`` channels, then a
bias-free linear head with sigmoid; no normalization layers. Convs are
bias-free with the JAX package's kernel sizes, strides and pads.

The head flattens in NHWC (h, w, c) order, so its weight rows line up
with the JAX package's ``Dense_0/kernel``; then it scales by
1/sqrt(fan_in) and applies the sigmoid in float32. Unlike flax's Dense,
``nn.Linear`` needs its input width up front, so the assessor is built
for a crop size ``in_size`` (the localizer's ``out_size``).

``forward(x, features=[])`` appends the pre-head features, the (N, h*w*ch)
flattened activations that the JAX package sows as ``features/pre_head``
(the BBoxPlotter's PCA scatter reads them).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from loans_tpu_torch.models.resnet import Conv2d, set_dtypes
from loans_tpu_torch.ops.geometry import Size
from loans_tpu_torch.utils.constants import device_constant


@device_constant
def _fan_in_scale(fan_in: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """1 / sqrt(fan_in) as JAX computes the head's scale: the fan-in, its
    root and reciprocal in the features' dtype, on their device."""
    return 1.0 / torch.sqrt(torch.tensor(float(fan_in), dtype=dtype, device=device))


def _conv(in_ch: int, out_ch: int, kernel: int, stride: int, pad: int) -> Conv2d:
    return Conv2d(in_ch, out_ch, kernel, stride=stride, padding=pad, bias=False)


def _down(size: int) -> int:
    """Spatial size after a 4x4 / stride 2 / pad 1 conv."""
    return (size + 2 - 4) // 2 + 1


class DownResBlock1(nn.Module):
    """Entry down-block: no pre-activation on the raw input."""

    def __init__(self, in_ch: int, ch: int):
        super().__init__()
        self.Conv_0 = _conv(in_ch, ch, 3, 1, 1)
        self.Conv_1 = _conv(ch, ch, 4, 2, 1)
        self.Conv_2 = _conv(in_ch, ch, 4, 2, 1)

    def forward(self, x):
        h1 = self.Conv_0(x)
        return self.Conv_1(F.relu(h1)) + self.Conv_2(x)


class DownResBlock2(nn.Module):
    """Pre-activation down-block."""

    def __init__(self, ch: int):
        super().__init__()
        self.Conv_0 = _conv(ch, ch, 3, 1, 1)
        self.Conv_1 = _conv(ch, ch, 4, 2, 1)
        self.Conv_2 = _conv(ch, ch, 4, 2, 1)

    def forward(self, x):
        h1 = self.Conv_0(F.relu(x))
        return self.Conv_1(F.relu(h1)) + self.Conv_2(x)


class DownResBlock3(nn.Module):
    """Pre-activation identity block."""

    def __init__(self, ch: int):
        super().__init__()
        self.Conv_0 = _conv(ch, ch, 3, 1, 1)
        self.Conv_1 = _conv(ch, ch, 3, 1, 1)

    def forward(self, x):
        h1 = self.Conv_0(F.relu(x))
        return self.Conv_1(F.relu(h1)) + x


class ResnetAssessor(nn.Module):
    """Crop-quality regressor.

    Input: (N, H, W, C) NHWC crops of size ``in_size`` with ``in_ch``
    channels. Output: (N, output_dim) float32 sigmoid scores in [0, 1].
    """

    def __init__(
        self,
        ch: int = 128,
        output_dim: int = 1,
        in_size: Size = Size(75, 75),
        in_ch: int = 3,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.DownResBlock1_0 = DownResBlock1(in_ch, ch)
        self.DownResBlock2_0 = DownResBlock2(ch)
        self.DownResBlock3_0 = DownResBlock3(ch)
        self.DownResBlock3_1 = DownResBlock3(ch)
        h, w = (_down(_down(s)) for s in in_size)
        self.fan_in = h * w * ch
        self.Dense_0 = nn.Linear(self.fan_in, output_dim, bias=False)
        set_dtypes(self, dtype, dtype)

    def forward(self, x, features: list | None = None):
        h = self.DownResBlock1_0(x.permute(0, 3, 1, 2))
        h = self.DownResBlock2_0(h)
        h = self.DownResBlock3_0(h)
        h = self.DownResBlock3_1(h)
        h = F.relu(h).permute(0, 2, 3, 1).flatten(1)  # (h, w, c) order
        if features is not None:
            features.append(h)
        h = F.linear(h * _fan_in_scale(self.fan_in, h.dtype, h.device), self.Dense_0.weight.to(h.dtype))
        return torch.sigmoid(h.float())
