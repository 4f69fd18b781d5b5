"""ResNet-50 (He et al., arXiv:1512.03385) in the form the LoANs reference
builds it (chainer's ``ResNet`` of ``Bartzi/loans``): every stage's first
bottleneck has a projection shortcut, the stride sits on the first 1x1
convolution, the stem's max pooling covers the whole input (chainer's
``cover_all``: 224 -> 56), BatchNorm has eps 2e-5. NCHW inside."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

BLOCKS = (3, 4, 6, 3)
MIDS = (64, 128, 256, 512)
OUTS = (256, 512, 1024, 2048)
STRIDES = (1, 2, 2, 2)
BN_EPS = 2e-5


class BatchNorm(nn.Module):
    """Batch statistics in training (biased variance), the stored ones in
    evaluation; the running statistics are never updated here."""

    def __init__(self, ch: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("running_mean", torch.zeros(ch))
        self.register_buffer("running_var", torch.ones(ch))

    def forward(self, x):
        if self.training:
            return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, BN_EPS)
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias, False, 0.0, BN_EPS)


class ConvBN(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, stride: int, pad: int):
        super().__init__()
        self.Conv_0 = nn.Conv2d(cin, cout, k, stride, pad, bias=False)
        self.BatchNorm_0 = BatchNorm(cout)
        self.stride, self.pad = stride, pad

    def forward(self, x):
        return self.BatchNorm_0(F.conv2d(x, self.Conv_0.weight, None, self.stride, self.pad))


class Bottleneck(nn.Module):
    def __init__(self, cin: int, mid: int, cout: int, stride: int, project: bool):
        super().__init__()
        self.ConvBN_0 = ConvBN(cin, mid, 1, stride, 0)
        self.ConvBN_1 = ConvBN(mid, mid, 3, 1, 1)
        self.ConvBN_2 = ConvBN(mid, cout, 1, 1, 0)
        if project:
            self.ConvBN_3 = ConvBN(cin, cout, 1, stride, 0)

    def forward(self, x):
        h = F.relu(self.ConvBN_0(x))
        h = F.relu(self.ConvBN_1(h))
        h = self.ConvBN_2(h)
        short = self.ConvBN_3(x) if hasattr(self, "ConvBN_3") else x
        return F.relu(h + short)


class ResNet50(nn.Module):
    def __init__(self):
        super().__init__()
        self.Conv_0 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.BatchNorm_0 = BatchNorm(64)
        cin = 64
        for s, (n, mid, out, stride) in enumerate(zip(BLOCKS, MIDS, OUTS, STRIDES)):
            stage = nn.Module()
            stage.add_module("BottleNeckA_0", Bottleneck(cin, mid, out, stride, True))
            for b in range(n - 1):
                stage.add_module(f"BottleNeckB_{b}", Bottleneck(out, mid, out, 1, False))
            self.add_module(f"BottleNeckStage_{s}", stage)
            cin = out
        self.feature_dim = cin

    def forward(self, x):
        h = F.relu(self.BatchNorm_0(F.conv2d(x, self.Conv_0.weight, None, 2, 3)))
        h = F.max_pool2d(F.pad(h, (0, 1, 0, 1), value=float("-inf")), 3, 2)
        for s in range(len(BLOCKS)):
            for block in getattr(self, f"BottleNeckStage_{s}").children():
                h = block(h)
        return h
