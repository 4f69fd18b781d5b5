"""Affine-grid geometry: corners, boxes, IoU (port of
``loans_tpu/ops/geometry.py``).

Everything is computed directly from ``theta`` (N, 2, 3); the sampling
grid never has to exist. Products are written out elementwise so that no
matmul path (and no TF32) touches them on the card.

Conventions:
  * theta is (N, 2, 3); input point (x_in, y_in) = theta @ (x_out, y_out, 1),
    all coordinates normalized to [-1, 1] ((-1,-1) = top-left corner).
  * boxes are (y_min, x_min, y_max, x_max), pixels, matching chainercv.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from loans_tpu_torch.utils.constants import device_table


class Size(NamedTuple):
    """Image size (height, width)."""

    height: int
    width: int


# Normalized output-space corner coordinates (x, y):
# top-left, top-right, bottom-left, bottom-right.
_CORNER_XY = ((-1.0, -1.0), (1.0, -1.0), (-1.0, 1.0), (1.0, 1.0))


def theta_corners(theta: torch.Tensor) -> torch.Tensor:
    """Corners of the sampling region implied by affine params.

    Args:
      theta: (..., 2, 3) affine transforms.

    Returns:
      (..., 4, 2) corner coordinates (x, y), normalized to [-1, 1], in the
      order [top-left, top-right, bottom-left, bottom-right].
    """
    corners = [
        theta[..., :, 0] * cx + theta[..., :, 1] * cy + theta[..., :, 2]
        for cx, cy in _CORNER_XY
    ]
    return torch.stack(corners, dim=-2)


def scale_corners(corners: torch.Tensor, image_size: Size) -> torch.Tensor:
    """[-1, 1] corner coords -> pixel coords ((g + 1) / 2 * size)."""
    half = (corners + 1.0) / 2.0
    scale = device_table((image_size.width, image_size.height), corners.dtype, corners.device)
    return half * scale


def corners_to_aabb(
    corners: torch.Tensor, image_size: Size, clip: bool = True
) -> torch.Tensor:
    """Axis-aligned bounding box enclosing the (possibly rotated) corners.

    Args:
      corners: (N, 4, 2) normalized corners [tl, tr, bl, br], (x, y).
      image_size: target image size.
      clip: clip pixel coords into the image first (reference behavior).

    Returns:
      (N, 4) boxes (y_min, x_min, y_max, x_max) in pixels.
    """
    px = scale_corners(corners, image_size)
    if clip:
        hi = device_table((image_size.width, image_size.height), px.dtype, px.device)
        px = torch.minimum(px.clamp(min=0.0), hi)
    tl, tr, bl, br = px[:, 0], px[:, 1], px[:, 2], px[:, 3]
    x_min = torch.minimum(tl[:, 0], bl[:, 0])
    y_min = torch.minimum(tl[:, 1], tr[:, 1])
    x_max = torch.maximum(tr[:, 0], br[:, 0])
    y_max = torch.maximum(bl[:, 1], br[:, 1])
    return torch.stack([y_min, x_min, y_max, x_max], dim=1)


def corners_to_bbox(corners: torch.Tensor, image_size: Size) -> torch.Tensor:
    """Diagonal-corner box (top-left and bottom-right corners) without
    clipping; may lie outside the image or be inverted.

    Returns:
      (N, 4) boxes (y_min, x_min, y_max, x_max) in pixels.
    """
    px = scale_corners(corners, image_size)
    tl, br = px[:, 0], px[:, 3]
    return torch.stack([tl[:, 1], tl[:, 0], br[:, 1], br[:, 0]], dim=1)


def box_to_theta(boxes_xyxy: torch.Tensor, image_size: Size) -> torch.Tensor:
    """Axis-aligned theta whose STN crop renders exactly the pixel box.

    Inverse of the sampler's align-corners convention: the crop's
    first/last samples land on pixels x1 and x2 - 1.

    Args:
      boxes_xyxy: (..., 4) pixel boxes (x1, y1, x2, y2), exclusive end.
      image_size: source image size.

    Returns:
      (..., 2, 3) axis-aligned affine params.
    """
    boxes_xyxy = torch.as_tensor(boxes_xyxy, dtype=torch.float32)
    x1, y1, x2, y2 = boxes_xyxy.unbind(-1)
    w1 = max(image_size.width - 1, 1)
    h1 = max(image_size.height - 1, 1)
    sx = (x2 - x1 - 1.0) / w1
    sy = (y2 - y1 - 1.0) / h1
    tx = (x1 + x2 - 1.0) / w1 - 1.0
    ty = (y1 + y2 - 1.0) / h1 - 1.0
    zeros = torch.zeros_like(sx)
    row_x = torch.stack([sx, zeros, tx], dim=-1)
    row_y = torch.stack([zeros, sy, ty], dim=-1)
    return torch.stack([row_x, row_y], dim=-2)


def _iou(tl, br, area_a, area_b):
    wh = (br - tl).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a + area_b - inter
    safe = torch.where(union > 0, union, torch.ones_like(union))
    return torch.where(union > 0, inter / safe, torch.zeros_like(union))


def _area(boxes):
    return (boxes[:, 2:] - boxes[:, :2]).clamp(min=0.0).prod(dim=1)


def bbox_iou(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU matrix, chainercv ``bbox_iou`` semantics.

    Args:
      boxes_a: (N, 4) (y_min, x_min, y_max, x_max).
      boxes_b: (K, 4).

    Returns:
      (N, K) IoU matrix. Degenerate boxes yield 0.
    """
    tl = torch.maximum(boxes_a[:, None, :2], boxes_b[None, :, :2])
    br = torch.minimum(boxes_a[:, None, 2:], boxes_b[None, :, 2:])
    return _iou(tl, br, _area(boxes_a)[:, None], _area(boxes_b)[None, :])


def elementwise_iou(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Per-row IoU of matched box pairs ((N, 4) x (N, 4) -> (N,))."""
    tl = torch.maximum(boxes_a[:, :2], boxes_b[:, :2])
    br = torch.minimum(boxes_a[:, 2:], boxes_b[:, 2:])
    return _iou(tl, br, _area(boxes_a), _area(boxes_b))
