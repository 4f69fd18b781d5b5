"""Tensor ops of the serving path (counterpart of ``loans_tpu.ops``)."""

from loans_tpu_torch.ops.geometry import (
    Size,
    bbox_iou,
    box_to_theta,
    corners_to_aabb,
    corners_to_bbox,
    elementwise_iou,
    scale_corners,
    theta_corners,
)
from loans_tpu_torch.ops.rotation_dropout import rotation_dropout
from loans_tpu_torch.ops.stn import (
    affine_grid,
    sample_grid,
    sample_separable,
    sample_separable_kernel,
    spatial_transform,
)

__all__ = [
    "Size",
    "affine_grid",
    "bbox_iou",
    "box_to_theta",
    "corners_to_aabb",
    "corners_to_bbox",
    "elementwise_iou",
    "rotation_dropout",
    "sample_grid",
    "sample_separable",
    "sample_separable_kernel",
    "scale_corners",
    "spatial_transform",
    "theta_corners",
]
