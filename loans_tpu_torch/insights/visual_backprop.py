"""VisualBackprop attention maps (port of
``loans_tpu/insights/visual_backprop.py``).

The models record the channel mean of each main-branch convolution's or
pooling's input when given a list (``Localizer.forward(images, vbp=[])``,
``models/resnet.py``), and ``Localizer.vbp_ladder()`` gives each step's
static (kind, kernel, stride, pad). ``visual_backprop`` walks the ladder
from the deepest feature map down: it upsamples the running relevance map
with a transposed convolution of a ones kernel, multiplies it by the step's
recorded input and min-max normalizes, as the JAX package does with XLA's
ops; here the ops are PyTorch's (``F.conv_transpose2d``).

Padding: ``lax.conv_transpose``'s explicit padding ``pad`` pads the
stride-dilated input before a valid convolution, so a step's output is
``(h - 1) * stride + 2 * pad - kernel + 2`` wide. ``F.conv_transpose2d``'s
``padding`` crops its full output instead; the two agree for ``padding =
kernel - 1 - pad`` (``_ones_deconv``), which is ``pad`` only where ``pad =
(kernel - 1) / 2``.

Tensors are NCHW inside; the heat map is returned NHWC (N, H, W, 1), as the
JAX package returns it. Everything is computed in float32: a bfloat16
model's recorded inputs and anchor are cast first, as in the JAX package.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F


def _minmax_normalize(x: torch.Tensor) -> torch.Tensor:
    lo = x.amin(dim=(1, 2, 3), keepdim=True)
    hi = x.amax(dim=(1, 2, 3), keepdim=True)
    return (x - lo) / torch.clamp(hi - lo, min=1e-12)


def _ones_deconv(rel: torch.Tensor, kernel: int, stride: int, pad: int) -> torch.Tensor:
    """``lax.conv_transpose(rel, ones, stride, [(pad, pad)] * 2)`` of an
    (N, 1, h, w) map."""
    ones = torch.ones(1, 1, kernel, kernel, dtype=rel.dtype, device=rel.device)
    crop = kernel - 1 - pad
    out = F.conv_transpose2d(rel, ones, stride=stride, padding=max(crop, 0))
    if crop < 0:  # more padding than the full output has: zeros around it
        out = F.pad(out, (-crop,) * 4)
    return out


def _fit_to(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Crop or zero-pad the spatial dims to exactly (h, w): a convolution's
    floor rounding can leave the transposed output up to stride - 1 off."""
    x = x[:, :, :h, :w]
    return F.pad(x, (0, w - x.shape[3], 0, h - x.shape[2]))


def visual_backprop(
    anchor: torch.Tensor,
    vbp_inputs: Sequence[torch.Tensor],
    ladder: Sequence[tuple],
) -> torch.Tensor:
    """The attention heat map.

    Args:
      anchor: (N, C, h, w) deepest feature map.
      vbp_inputs: the channel-mean (N, 1, h_i, w_i) input of each ladder
        step, shallowest first (the recording order).
      ladder: the matching (kind, kernel, stride, pad) steps.

    Returns:
      (N, H, W, 1) float32 heat map in [0, 1] at the input's resolution.
    """
    if len(vbp_inputs) != len(ladder):
        raise ValueError(f"{len(vbp_inputs)} recorded inputs vs {len(ladder)} ladder steps")
    rel = _minmax_normalize(anchor.float().mean(dim=1, keepdim=True))
    for (_, kernel, stride, pad), inp in zip(reversed(ladder), reversed(list(vbp_inputs))):
        # convolutions and poolings upsample alike (a ones kernel)
        inp = inp.float()
        rel = _fit_to(_ones_deconv(rel, kernel, stride, pad), inp.shape[2], inp.shape[3])
        rel = _minmax_normalize(rel * inp)
    return rel.permute(0, 2, 3, 1)


@torch.no_grad()
def localizer_visual_backprop(localizer, images: torch.Tensor) -> np.ndarray:
    """Eval-mode forward of ``images`` (N, H, W, 3) and its heat map, on
    the host; the localizer's train/eval mode is restored after."""
    was_training = localizer.training
    recorded: list[torch.Tensor] = []
    try:
        localizer.eval()(images, vbp=recorded)
    finally:
        localizer.train(was_training)
    *inputs, anchor = recorded
    return visual_backprop(anchor, inputs, localizer.vbp_ladder()).cpu().numpy()
