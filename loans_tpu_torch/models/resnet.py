"""Scratch ResNet family, NCHW (port of ``loans_tpu/models/resnet.py``).

Architectural details kept from the JAX reference:
  * every stage's first block (``BasicA``/``BottleNeckA``) has a
    *projection* shortcut even at stride 1; ``BasicA``'s projection is a
    full 3x3 conv, not 1x1;
  * the stem max-pool is chainer's ``cover_all`` mode (3x3/2 with -inf
    padding on the bottom/right), which yields 56x56 from 224 inputs;
  * BatchNorm uses chainer defaults: eps 2e-5 and running-average weight
    0.9 (torch ``momentum=0.1``); train mode folds the biased batch
    variance into the running variance, as flax does (``BatchNorm2d``);
    eval uses the running statistics;
  * bottleneck downsampling strides live on the first 1x1 conv
    (caffe-style).

VisualBackprop: every ``forward`` takes an optional list ``vbp``; given
one, it appends the channel mean (N, 1, h, w) of each main-branch
convolution's or pooling's input, in call order, at the points where the
JAX modules ``sow`` it into their ``vbp`` collection. The order is
``loans_tpu.insights.visual_backprop.flatten_vbp``'s, and
``resnet_vbp_ladder`` gives each entry's (kind, kernel, stride, pad).
Without the list nothing is recorded and nothing extra is computed.

Submodules carry the flax module names of the JAX package (``Conv_0``,
``BatchNorm_0``, ``ConvBN_1``, ``BottleNeckStage_0``, ...), so a
``state_dict`` key is the flax parameter path with ``/`` replaced by
``.`` (see ``loans_tpu_torch/bridge.py``).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from loans_tpu_torch import parallel

BLOCK_CONFIGS: dict[int, Sequence[int]] = {
    18: (2, 2, 2, 2),
    19: (2, 2, 2, 2),
    20: (2, 2, 2, 2, 2, 2),
    32: (5, 5, 5),
    34: (3, 4, 6, 3),
    44: (7, 7, 7),
    50: (3, 4, 6, 3),
    56: (9, 9, 9),
    101: (3, 4, 23, 3),
    110: (18, 18, 18),
    152: (3, 4, 36, 3),
}

_BASIC = (18, 20, 34)
_SMALL = (32, 44, 56, 110)
_BOTTLENECK = (19, 50, 101, 152)
TRUNCATED_NORMAL_STD = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that can compute in another dtype than its parameters'
    (``set_dtypes``): then its input and its float32 weight are cast to
    ``compute_dtype`` for the call, as flax's ``nn.Conv(dtype=...)`` casts
    them, and the output stays in it. Unset, it is ``nn.Conv2d``."""

    compute_dtype: torch.dtype | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


class Dense(nn.Linear):
    """flax's ``nn.Dense``: a lecun-normal kernel (truncated normal, as
    ``nn.initializers.lecun_normal``) and a zero bias; with
    ``compute_dtype`` set (``set_dtypes``), its input, weight and bias are
    cast to it for the call, as ``nn.Dense(dtype=...)`` casts them."""

    compute_dtype: torch.dtype | None = None

    def __init__(self, in_features: int, out_features: int):
        super().__init__(in_features, out_features)
        std = math.sqrt(1.0 / in_features) / TRUNCATED_NORMAL_STD
        nn.init.trunc_normal_(self.weight, 0.0, std, -2.0 * std, 2.0 * std)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with flax's training statistics and dtypes.

    Train mode normalizes with the biased batch variance, as
    ``nn.BatchNorm2d`` does, and also folds the *biased* variance into
    ``running_var``, as flax's ``BatchNorm`` does (``nn.BatchNorm2d``
    folds the unbiased one, n/(n-1) larger for n = batch*H*W values per
    channel). Eval mode is ``nn.BatchNorm2d``'s.

    While a data-parallel group of more than one process is active
    (``loans_tpu_torch.parallel``), train mode takes the statistics of the
    global batch, as flax's does under the JAX package's sharded step
    (``parallel.global_batch_norm``: the per-channel sum, sum of squares
    and count over (N, H, W) summed over the ranks, flax's biased variance
    E[x²] - E[x]², and a backward that all-reduces its sums too).

    As flax's, it computes in float32 at least: a bfloat16 input is
    promoted. With ``out_dtype`` set (the ``norm_dtype`` of
    ``set_dtypes``) the output is cast to it.
    """

    out_dtype: torch.dtype | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype in (torch.bfloat16, torch.float16):
            x = x.float()
        y = self._normalize(x)
        return y if self.out_dtype is None else y.to(self.out_dtype)

    def _normalize(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if parallel.data_parallel_size() > 1:
            return self._normalize_global(x)
        n = x.numel() // x.shape[1]
        # F.batch_norm leaves momentum * unbiased_var in this zeroed buffer
        # (and updates running_mean itself); rescale it to the biased one.
        var_part = torch.zeros_like(self.running_var)
        y = F.batch_norm(
            x, self.running_mean, var_part, self.weight, self.bias,
            True, self.momentum, self.eps,
        )
        with torch.no_grad():
            self.running_var.mul_(1.0 - self.momentum).add_(var_part, alpha=(n - 1) / n)
            self.num_batches_tracked.add_(1)
        return y

    def _normalize_global(self, x: torch.Tensor) -> torch.Tensor:
        y, mean, var = parallel.global_batch_norm(x, self.weight, self.bias, self.eps)
        with torch.no_grad():
            self.running_mean.mul_(1.0 - self.momentum).add_(mean, alpha=self.momentum)
            self.running_var.mul_(1.0 - self.momentum).add_(var, alpha=self.momentum)
            self.num_batches_tracked.add_(1)
        return y


def set_dtypes(module: nn.Module, dtype: torch.dtype, norm_dtype: torch.dtype) -> nn.Module:
    """Run ``module``'s convolutions (and ``Dense`` layers) in ``dtype`` and give its BatchNorms
    outputs in ``norm_dtype`` (the JAX package's ``dtype`` and
    ``norm_dtype`` module fields); parameters and statistics keep their
    dtype. Both float32 leave the modules as they are, so a float32 model
    can still be moved to another dtype whole (``.double()``)."""
    if dtype == torch.float32 and norm_dtype == torch.float32:
        return module
    for m in module.modules():
        if isinstance(m, (Conv2d, Dense)):
            m.compute_dtype = dtype
        elif isinstance(m, BatchNorm2d):
            m.out_dtype = norm_dtype
    return module


def batch_norm(ch: int) -> BatchNorm2d:
    """BatchNorm with chainer defaults (eps 2e-5, decay 0.9)."""
    return BatchNorm2d(ch, eps=2e-5, momentum=0.1)


def _record(vbp: list | None, x: torch.Tensor) -> None:
    """Append ``x``'s channel mean to ``vbp`` when one is given."""
    if vbp is not None:
        vbp.append(x.mean(dim=1, keepdim=True))


def _add(module: nn.Module, child: nn.Module) -> nn.Module:
    """Register ``child`` under flax's auto name ``<Class>_<k>``."""
    cls = type(child).__name__
    k = sum(1 for name in module._modules if name.startswith(cls + "_"))
    module.add_module(f"{cls}_{k}", child)
    return child


class ConvBN(nn.Module):
    """Conv (no bias) + BatchNorm."""

    def __init__(self, in_ch: int, features: int, kernel: int, stride: int = 1, pad: int = 0):
        super().__init__()
        self.Conv_0 = Conv2d(
            in_ch, features, kernel, stride=stride, padding=pad, bias=False
        )
        self.BatchNorm_0 = batch_norm(features)

    def forward(self, x):
        return self.BatchNorm_0(self.Conv_0(x))


class BasicA(nn.Module):
    """First block of a basic stage: 3x3-3x3 main branch + 3x3 projection
    shortcut."""

    def __init__(self, in_ch: int, ch: int, stride: int = 2):
        super().__init__()
        self.ConvBN_0 = ConvBN(in_ch, ch, 3, stride, 1)
        self.ConvBN_1 = ConvBN(ch, ch, 3, 1, 1)
        self.ConvBN_2 = ConvBN(in_ch, ch, 3, stride, 1)

    def forward(self, x, vbp: list | None = None):
        _record(vbp, x)
        h1 = F.relu(self.ConvBN_0(x))
        _record(vbp, h1)
        h1 = self.ConvBN_1(h1)
        return F.relu(h1 + self.ConvBN_2(x))


class BasicB(nn.Module):
    """Identity basic block."""

    def __init__(self, ch: int):
        super().__init__()
        self.ConvBN_0 = ConvBN(ch, ch, 3, 1, 1)
        self.ConvBN_1 = ConvBN(ch, ch, 3, 1, 1)

    def forward(self, x, vbp: list | None = None):
        _record(vbp, x)
        h = F.relu(self.ConvBN_0(x))
        _record(vbp, h)
        h = self.ConvBN_1(h)
        return F.relu(h + x)


class BottleNeckA(nn.Module):
    """First bottleneck of a stage: 1x1(s)-3x3-1x1 + 1x1(s) projection."""

    def __init__(self, in_ch: int, ch: int, out_ch: int, stride: int = 2):
        super().__init__()
        self.ConvBN_0 = ConvBN(in_ch, ch, 1, stride, 0)
        self.ConvBN_1 = ConvBN(ch, ch, 3, 1, 1)
        self.ConvBN_2 = ConvBN(ch, out_ch, 1, 1, 0)
        self.ConvBN_3 = ConvBN(in_ch, out_ch, 1, stride, 0)

    def forward(self, x, vbp: list | None = None):
        _record(vbp, x)
        h1 = F.relu(self.ConvBN_0(x))
        _record(vbp, h1)
        h1 = F.relu(self.ConvBN_1(h1))
        _record(vbp, h1)
        h1 = self.ConvBN_2(h1)
        return F.relu(h1 + self.ConvBN_3(x))


class BottleNeckB(nn.Module):
    """Identity bottleneck."""

    def __init__(self, ch: int, out_ch: int):
        super().__init__()
        self.ConvBN_0 = ConvBN(out_ch, ch, 1, 1, 0)
        self.ConvBN_1 = ConvBN(ch, ch, 3, 1, 1)
        self.ConvBN_2 = ConvBN(ch, out_ch, 1, 1, 0)

    def forward(self, x, vbp: list | None = None):
        _record(vbp, x)
        h = F.relu(self.ConvBN_0(x))
        _record(vbp, h)
        h = F.relu(self.ConvBN_1(h))
        _record(vbp, h)
        return F.relu(self.ConvBN_2(h) + x)


class BasicStage(nn.Module):
    """Stage of basic blocks."""

    def __init__(self, in_ch: int, n_blocks: int, ch: int, stride: int = 2):
        super().__init__()
        _add(self, BasicA(in_ch, ch, stride))
        for _ in range(n_blocks - 1):
            _add(self, BasicB(ch))
        self.out_ch = ch

    def forward(self, x, vbp: list | None = None):
        for block in self.children():
            x = block(x, vbp)
        return x


class BottleNeckStage(nn.Module):
    """Stage of bottleneck blocks."""

    def __init__(self, in_ch: int, n_blocks: int, ch: int, out_ch: int, stride: int = 2):
        super().__init__()
        _add(self, BottleNeckA(in_ch, ch, out_ch, stride))
        for _ in range(n_blocks - 1):
            _add(self, BottleNeckB(ch, out_ch))
        self.out_ch = out_ch

    def forward(self, x, vbp: list | None = None):
        for block in self.children():
            x = block(x, vbp)
        return x


def cover_all_max_pool(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """chainer ``max_pooling_2d(cover_all=True)``: -inf padding of
    ``stride - 1`` on the bottom/right so every input pixel is covered."""
    x = F.pad(x, (0, stride - 1, 0, stride - 1), value=float("-inf"))
    return F.max_pool2d(x, window, stride)


class ResNet(nn.Module):
    """Configurable scratch ResNet feature extractor / classifier.

    ``forward`` takes NCHW input and returns the res5 (or res4 for the
    small variants) NCHW feature map; ResNet-20 global-pools it, as in the
    JAX package. With ``class_labels`` set it global-pools the map and
    returns the (N, class_labels) logits of ``Dense_0`` (backbone
    pretraining, ``cli/pretrain_backbone.py``).
    """

    def __init__(self, n_layers: int = 18, class_labels: int | None = None):
        super().__init__()
        self.n_layers = n_layers
        self.class_labels = class_labels
        stem_ch = 16 if n_layers in _SMALL else 64
        self.Conv_0 = Conv2d(3, stem_ch, 7, stride=2, padding=3, bias=False)
        self.BatchNorm_0 = batch_norm(stem_ch)
        in_ch = stem_ch
        blocks = BLOCK_CONFIGS[n_layers]
        strides = (1, 2, 2, 2, 2, 2)
        if n_layers in _BOTTLENECK:
            mids, outs = (64, 128, 256, 512), (256, 512, 1024, 2048)
            for b, mid, out, s in zip(blocks, mids, outs, strides):
                in_ch = _add(self, BottleNeckStage(in_ch, b, mid, out, s)).out_ch
        else:
            chs = (16, 32, 64) if n_layers in _SMALL else (64, 128, 256, 512, 512, 512)
            for b, ch, s in zip(blocks, chs, strides):
                in_ch = _add(self, BasicStage(in_ch, b, ch, s)).out_ch
        if class_labels is not None:
            self.Dense_0 = Dense(self.feature_dim, class_labels)

    def forward(self, x, vbp: list | None = None):
        _record(vbp, x)
        h = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        _record(vbp, h)
        h = cover_all_max_pool(h, 3, 2)
        for name, stage in self.named_children():
            if "Stage_" in name:
                h = stage(h, vbp)
        if self.class_labels is not None or self.n_layers == 20:
            h = h.mean(dim=(2, 3))
        if self.class_labels is not None:
            h = self.Dense_0(h)
        return h

    @property
    def feature_dim(self) -> int:
        if self.n_layers in _BASIC or self.n_layers == 20:
            return 512
        if self.n_layers in _SMALL:
            return 64
        return 2048


# (kind, kernel, stride, pad) of each recorded input, input to feature map
STEM_LADDER = (
    ("conv", 7, 2, 3),
    ("pool", 3, 2, 0),
)


def _block_ladder(stride: int, bottleneck: bool) -> list[tuple]:
    if bottleneck:
        return [("conv", 1, stride, 0), ("conv", 3, 1, 1), ("conv", 1, 1, 0)]
    return [("conv", 3, stride, 1), ("conv", 3, 1, 1)]


def stage_ladder(n_blocks: int, stride: int, bottleneck: bool) -> list[tuple]:
    """The ladder of one stage: its first block at ``stride``, the rest at 1."""
    steps = _block_ladder(stride, bottleneck)
    for _ in range(n_blocks - 1):
        steps.extend(_block_ladder(1, bottleneck))
    return steps


def resnet_vbp_ladder(n_layers: int) -> tuple[tuple, ...]:
    """The static (kind, kernel, stride, pad) ladder of a ResNet from its
    input to its feature map along the main branch, one step per recorded
    input (port of ``loans_tpu.models.resnet.resnet_vbp_ladder``)."""
    blocks = BLOCK_CONFIGS[n_layers]
    steps = list(STEM_LADDER)
    if n_layers in _SMALL:
        strides = (1, 2, 2)
    else:
        strides = (1, 2, 2, 2) + (2, 2) * (n_layers == 20)
    for n, s in zip(blocks, strides):
        steps.extend(stage_ladder(n, s, n_layers in _BOTTLENECK))
    return tuple(steps)
