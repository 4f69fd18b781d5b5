"""The LoANs ``ResnetAssessor`` (``Bartzi/loans`` ``common/net.py:70-90``):
four residual down-blocks of bias-free convolutions at ``ch`` channels,
no normalisation, a bias-free linear head over the flattened (h, w, c)
features scaled by 1/sqrt(fan_in), and a sigmoid. NHWC in, (N, 1) out."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def _w(cout: int, cin: int, k: int) -> nn.Parameter:
    return nn.Parameter(torch.empty(cout, cin, k, k))


class _Block(nn.Module):
    """kind 1: h = c0(x); out = c1(relu h) + c2(x)          (entry, down)
    kind 2: h = c0(relu x); out = c1(relu h) + c2(x)     (down)
    kind 3: h = c0(relu x); out = c1(relu h) + x         (identity)"""

    def __init__(self, kind: int, cin: int, ch: int):
        super().__init__()
        self.kind = kind
        self.Conv_0 = nn.Module()
        self.Conv_0.weight = _w(ch, cin, 3)
        self.Conv_1 = nn.Module()
        self.Conv_1.weight = _w(ch, ch, 3 if kind == 3 else 4)
        if kind != 3:
            self.Conv_2 = nn.Module()
            self.Conv_2.weight = _w(ch, cin, 4)

    def forward(self, x):
        a = x if self.kind == 1 else F.relu(x)
        h = F.conv2d(a, self.Conv_0.weight, None, 1, 1)
        if self.kind == 3:
            return F.conv2d(F.relu(h), self.Conv_1.weight, None, 1, 1) + x
        return F.conv2d(F.relu(h), self.Conv_1.weight, None, 2, 1) + F.conv2d(x, self.Conv_2.weight, None, 2, 1)


def _down(size: int) -> int:
    return (size + 2 - 4) // 2 + 1


class Assessor(nn.Module):
    def __init__(self, ch: int, in_size: tuple[int, int], in_ch: int = 3):
        super().__init__()
        self.DownResBlock1_0 = _Block(1, in_ch, ch)
        self.DownResBlock2_0 = _Block(2, ch, ch)
        self.DownResBlock3_0 = _Block(3, ch, ch)
        self.DownResBlock3_1 = _Block(3, ch, ch)
        h, w = (_down(_down(s)) for s in in_size)
        self.fan_in = h * w * ch
        self.Dense_0 = nn.Module()
        self.Dense_0.weight = nn.Parameter(torch.empty(1, self.fan_in))

    def forward(self, x):
        h = x.permute(0, 3, 1, 2)
        for name in ("DownResBlock1_0", "DownResBlock2_0", "DownResBlock3_0", "DownResBlock3_1"):
            h = getattr(self, name)(h)
        h = F.relu(h).permute(0, 2, 3, 1).flatten(1)
        return torch.sigmoid(F.linear(h / math.sqrt(self.fan_in), self.Dense_0.weight))
