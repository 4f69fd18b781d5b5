"""Localizer regularization losses (port of ``loans_tpu/ops/losses.py``).

Reference semantics: ``common/utils.py`` loss calculators —
``DirectionLossCalculator`` (:163-178), ``OutOfImageLossCalculator``
(:301-316), ``MinAreaLossCalculator`` (:181-198), ``MaxAreaLossCalculator``
(:201-214), ``AspectRatioLossCalculator`` (:217-239),
``TransformParameterRegressionLossCalculator`` (:242-298).

All losses are pure functions of the affine-transform corners
(``geometry.theta_corners``). Reductions (mean vs. sum) follow the
reference exactly, since they set the effective regularizer weight
relative to the assessor MSE term.

Gradients at ties are JAX's: ``torch.maximum``/``torch.minimum`` against
zero pass half the gradient where the two sides are equal, as
``jnp.maximum``/``jnp.minimum`` do (``relu`` and ``clamp`` pass 0 or 1),
and ``_abs`` takes abs'(0) = +1, as ``jnp.abs`` does (``torch.abs``
takes 0). Corners land exactly on such ties, e.g. on the image border at
the identity theta.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from loans_tpu_torch.ops.geometry import (
    Size,
    bbox_iou,
    elementwise_iou,
    scale_corners,
)
from loans_tpu_torch.utils.constants import device_table


def _relu(x: torch.Tensor) -> torch.Tensor:
    """max(x, 0) with JAX's gradient 0.5 at x == 0."""
    return torch.maximum(x, x.new_zeros(()))


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with JAX's gradient +1 at x == 0."""
    return torch.where(x >= 0, x, -x)


def direction_loss(corners: torch.Tensor, image_size: Size) -> torch.Tensor:
    """Penalize upside-down / mirrored sampling regions.

    ``common/utils.py:163-178``: mean(relu(tl_y - bl_y)) +
    mean(relu(tl_x - tr_x)), on pixel-scaled (unclipped) corners.
    """
    px = scale_corners(corners, image_size)
    tl, tr, bl = px[:, 0], px[:, 1], px[:, 2]
    up_down = _relu(tl[:, 1] - bl[:, 1]).mean()
    left_right = _relu(tl[:, 0] - tr[:, 0]).mean()
    return up_down + left_right


def out_of_image_loss(corners: torch.Tensor) -> torch.Tensor:
    """Penalize corner coordinates outside the normalized image [-1, 1].

    ``common/utils.py:301-316``: over the values {tl_x, tl_y, tr_x, bl_y}
    of every sample, sum |min(v + 1, 0)| + max(v - 1, 0). The reference
    reduces with a *sum* (scales with batch size) — preserved.
    """
    tl, tr, bl = corners[:, 0], corners[:, 1], corners[:, 2]
    vals = torch.cat([tl[:, 0], tl[:, 1], tr[:, 0], bl[:, 1]], dim=0)
    low = _abs(torch.minimum(vals + 1.0, vals.new_zeros(())))
    high = _relu(vals - 1.0)
    return low.sum() + high.sum()


def min_area_loss(
    corners: torch.Tensor, image_size: Size, out_size: Size
) -> torch.Tensor:
    """Penalize regions smaller than the crop size.

    ``common/utils.py:181-198``: width/height from pixel-scaled corners;
    sum(relu(out_w - w)) + sum(relu(out_h - h)).
    """
    px = scale_corners(corners, image_size)
    widths = px[:, 1, 0] - px[:, 0, 0]
    heights = px[:, 2, 1] - px[:, 0, 1]
    w_loss = _relu(float(out_size.width) - widths)
    h_loss = _relu(float(out_size.height) - heights)
    return w_loss.sum() + h_loss.sum()


def max_area_loss(corners: torch.Tensor, image_size: Size) -> torch.Tensor:
    """Penalize regions larger than the image (``common/utils.py:201-214``)."""
    px = scale_corners(corners, image_size)
    widths = px[:, 1, 0] - px[:, 0, 0]
    heights = px[:, 2, 1] - px[:, 0, 1]
    w_loss = _relu(widths - float(image_size.width))
    h_loss = _relu(heights - float(image_size.height))
    return w_loss.sum() + h_loss.sum()


def aspect_ratio_loss(corners: torch.Tensor, image_size: Size) -> torch.Tensor:
    """Penalize tall aspect ratios (``common/utils.py:217-239``).

    width/height are euclidean side lengths of the (possibly rotated)
    region; loss = mean(relu(height / max(width, 1) - 0.5)).
    """
    px = scale_corners(corners, image_size)
    tl, tr, bl = px[:, 0], px[:, 1], px[:, 2]
    width = torch.sqrt(torch.sum(torch.square(tr - tl), dim=1))
    height = torch.sqrt(torch.sum(torch.square(bl - tl), dim=1))
    aspect = height / torch.maximum(width, width.new_ones(()))
    return _relu(aspect - 0.5).mean()


def huber_loss(x: torch.Tensor, t: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    """Chainer ``F.huber_loss`` semantics: per-sample sum over last axis."""
    d = x - t
    abs_d = _abs(d)
    quad = 0.5 * torch.square(d)
    lin = delta * (abs_d - 0.5 * delta)
    return torch.where(abs_d <= delta, quad, lin).sum(dim=-1)


def transform_param_regression_loss(
    corners: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_mask: torch.Tensor,
    objectness_scores: torch.Tensor,
    pos_iou_threshold: float = 0.7,
    ignore_iou_low: float = 0.3,
) -> tuple[torch.Tensor, torch.Tensor]:
    """RPN-style anchor-matched regression + objectness loss.

    Static-shape re-design of ``common/utils.py:242-298``: every predicted
    region is matched against every (masked) gt box and contributions are
    masked.

    Args:
      corners: (N, 4, 2) normalized corners of predicted regions.
      gt_boxes: (G, 4) gt boxes as (x_min, y_min, x_max, y_max) in
        normalized [-1, 1] coordinates (the reference compares against
        unscaled corners, ``common/utils.py:245-249``).
      gt_mask: (G,) bool validity mask for padded gt rows.
      objectness_scores: (N, 2) logits.

    Returns:
      (regression_loss, objectness_loss) scalars.
    """
    tl, tr, bl = corners[:, 0], corners[:, 1], corners[:, 2]
    # (x1, y1, x2, y2) exactly as the reference assembles them.
    pred = torch.stack([tl[:, 0], tl[:, 1], tr[:, 0], bl[:, 1]], dim=1)
    n = pred.shape[0]

    ious = bbox_iou(gt_boxes, pred)  # (G, N)
    ious = torch.where(gt_mask[:, None], ious, torch.full_like(ious, -1.0))

    positive = ious >= pos_iou_threshold  # (G, N)
    has_positive = positive.any(dim=1)
    best = F.one_hot(ious.argmax(dim=1), n) > 0
    matched = torch.where(has_positive[:, None], positive, best)
    matched = matched & gt_mask[:, None]

    g = gt_boxes.shape[0]
    per_pair = huber_loss(
        pred[None, :, :].expand(g, n, 4), gt_boxes[:, None, :].expand(g, n, 4)
    )  # (G, N)
    n_matched = matched.sum().clamp(min=1)
    zeros = torch.zeros_like(per_pair)
    reg_loss = torch.where(matched, per_pair, zeros).sum() / n_matched

    is_positive = matched.any(dim=0)  # (N,)
    in_ignore_band = (
        (ious > ignore_iou_low) & (ious < pos_iou_threshold) & gt_mask[:, None]
    ).any(dim=0)
    ignore = in_ignore_band & ~is_positive
    labels = is_positive.long()
    log_probs = F.log_softmax(objectness_scores, dim=-1)
    ce = -log_probs.gather(1, labels[:, None])[:, 0]
    valid = ~ignore
    obj_loss = torch.where(valid, ce, torch.zeros_like(ce)).sum() / valid.sum().clamp(min=1)
    return reg_loss, obj_loss


def iou_loss(pred_boxes: torch.Tensor, gt_boxes: torch.Tensor) -> torch.Tensor:
    """1 - mean elementwise IoU of matched (y1, x1, y2, x2) box pairs
    (the reference's unwired ``IOUCalculator``, ``common/utils.py:21-85``)."""
    return 1.0 - elementwise_iou(pred_boxes, gt_boxes).mean()


def smooth_iou_loss(
    pred_boxes: torch.Tensor, gt_boxes: torch.Tensor, beta: float = 1.0
) -> torch.Tensor:
    """Differentiable IoU with softplus-smoothed intersection clamping
    (``SmoothIOUCalculator``, ``common/utils.py:88-134``)."""
    tl = torch.maximum(pred_boxes[:, :2], gt_boxes[:, :2])
    br = torch.minimum(pred_boxes[:, 2:], gt_boxes[:, 2:])
    z = (br - tl) * beta
    wh = torch.logaddexp(z, torch.zeros_like(z)) / beta  # softplus, as jax.nn
    inter = wh[:, 0] * wh[:, 1]
    area_p = _relu(pred_boxes[:, 2:] - pred_boxes[:, :2]).prod(dim=1)
    area_g = _relu(gt_boxes[:, 2:] - gt_boxes[:, :2]).prod(dim=1)
    union = torch.maximum(area_p + area_g - inter, device_table(1e-6, inter.dtype, inter.device))
    return 1.0 - (inter / union).mean()


def random_pairs(generator: torch.Generator, n: int) -> torch.Tensor:
    """Random index pairing (``common/utils.py:11-18``): a shuffled
    partner index for each of n elements, drawn from ``generator`` on its
    device."""
    return torch.randperm(n, generator=generator, device=generator.device)
