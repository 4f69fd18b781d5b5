"""Multibox (SSD) machinery: default boxes, encode/decode, multibox loss
(port of ``loans_tpu/ops/multibox.py``).

Encoding of one image's ragged gt runs on the host in numpy
(``MultiboxCoder.encode``, chainercv semantics); the batched device form
is ``data.ssd_device.encode_batch``. Decoding and the loss, with hard
negative mining, are batched torch on the model's device.

Conventions: boxes are (y_min, x_min, y_max, x_max) normalized to [0, 1];
default boxes are (cy, cx, h, w). Variances (0.1, 0.2), chainercv's
defaults.
"""

from __future__ import annotations

import itertools
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from loans_tpu_torch import parallel


def default_boxes(
    image_size: int,
    grids: Sequence[int],
    steps: Sequence[int],
    sizes: Sequence[float],
    aspect_ratios: Sequence[tuple[int, ...]],
) -> np.ndarray:
    """(K, 4) (cy, cx, h, w) default boxes, chainercv's SSD layout: row,
    column, then per cell size s, sqrt(s * s') and a pair of boxes per
    aspect ratio (the multibox head's order, ``models/ssd.py``)."""
    boxes = []
    for k, (grid, step) in enumerate(zip(grids, steps)):
        s = sizes[k] / image_size
        s_next = math.sqrt(s * sizes[k + 1] / image_size)
        for i, j in itertools.product(range(grid), repeat=2):
            cy = (i + 0.5) * step / image_size
            cx = (j + 0.5) * step / image_size
            boxes.append((cy, cx, s, s))
            boxes.append((cy, cx, s_next, s_next))
            for ar in aspect_ratios[k]:
                r = math.sqrt(ar)
                boxes.append((cy, cx, s / r, s * r))
                boxes.append((cy, cx, s * r, s / r))
    return np.asarray(boxes, dtype=np.float32)


def _cychw_to_yxyx(d: np.ndarray) -> np.ndarray:
    tl = d[:, :2] - d[:, 2:] / 2
    br = d[:, :2] + d[:, 2:] / 2
    return np.concatenate([tl, br], axis=1)


class MultiboxCoder:
    """Encode gt boxes to per-anchor targets / decode predictions."""

    def __init__(self, default_bbox: np.ndarray, variance=(0.1, 0.2), iou_thresh: float = 0.5):
        self.default_bbox = np.asarray(default_bbox, dtype=np.float32)
        self.default_yxyx = _cychw_to_yxyx(self.default_bbox)
        self.variance = variance
        self.iou_thresh = iou_thresh

    def encode(self, bbox: np.ndarray, label: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """One image's target assignment on the host (chainercv semantics).

        Args:
          bbox: (R, 4) normalized yxyx gt boxes.
          label: (R,) int class ids (0-based foreground).

        Returns:
          (loc (K, 4) float32, conf (K,) int32): conf 0 is background, gt
          class c becomes c + 1. Each anchor takes its best gt at IoU 0.5
          or more, and each gt's best anchor is forced to it (the later gt
          wins an anchor two gt share). No gt: all zeros.
        """
        from loans_tpu_torch.evaluation.voc import _bbox_iou

        bbox = np.asarray(bbox, dtype=np.float32).reshape(-1, 4)
        k = self.default_bbox.shape[0]
        if bbox.shape[0] == 0:
            return np.zeros((k, 4), dtype=np.float32), np.zeros((k,), dtype=np.int32)
        iou = _bbox_iou(self.default_yxyx, bbox)  # (K, R)
        index = iou.argmax(axis=1)
        masked = iou.max(axis=1) >= self.iou_thresh
        best_anchor = iou.argmax(axis=0)
        masked[best_anchor] = True
        index[best_anchor] = np.arange(bbox.shape[0])

        matched = bbox[index]
        cy = (matched[:, :2] + matched[:, 2:]) / 2
        hw = matched[:, 2:] - matched[:, :2]
        d_cy = self.default_bbox[:, :2]
        d_hw = self.default_bbox[:, 2:]
        loc = np.concatenate(
            [
                (cy - d_cy) / (self.variance[0] * d_hw),
                np.log(np.maximum(hw, 1e-8) / d_hw) / self.variance[1],
            ],
            axis=1,
        ).astype(np.float32)
        conf = np.where(masked, np.asarray(label)[index].astype(np.int32) + 1, 0).astype(np.int32)
        loc = np.where(masked[:, None], loc, 0.0).astype(np.float32)
        return loc, conf

    def decode_batch(self, mb_loc: torch.Tensor) -> torch.Tensor:
        """(N, K, 4) offsets -> (N, K, 4) normalized yxyx boxes, on
        ``mb_loc``'s device. The log-size offset is clipped to [-10, 10]
        before ``exp``, so that untrained outputs cannot overflow into inf
        boxes (e^10 is ~22000 times the anchor). The exp runs in float64."""
        d = torch.from_numpy(self.default_bbox).to(mb_loc.device)
        cy = mb_loc[..., :2] * self.variance[0] * d[:, 2:] + d[:, :2]
        # the exp in float64, cast back: see data.ssd_device.encode_batch
        hw = torch.exp(torch.clip(mb_loc[..., 2:] * self.variance[1], -10.0, 10.0).double()).float() * d[:, 2:]
        return torch.cat([cy - hw / 2, cy + hw / 2], dim=-1)


def smooth_l1(x: torch.Tensor) -> torch.Tensor:
    ax = torch.abs(x)
    return torch.where(ax < 1.0, 0.5 * x * x, ax - 0.5)


def multibox_loss(
    mb_loc: torch.Tensor,
    mb_conf: torch.Tensor,
    gt_loc: torch.Tensor,
    gt_conf: torch.Tensor,
    k: int = 3,
) -> tuple[torch.Tensor, torch.Tensor]:
    """SSD loss with hard negative mining (chainercv's ``multibox_loss``).

    Args:
      mb_loc: (N, K, 4) predicted offsets.
      mb_conf: (N, K, C+1) class logits (0 = background).
      gt_loc: (N, K, 4) encoded targets.
      gt_conf: (N, K) int class targets.
      k: negatives per positive.

    Returns:
      (loc_loss, conf_loss) scalars, each divided by the batch's positives
      (at least 1). The hard negatives of an image are its ``k * n_pos``
      largest background losses, ranked by a stable double argsort as in
      the JAX package: of tied losses the lower anchor index ranks first.

    In data-parallel training the positives are those of the global batch
    (summed over the ranks, outside autograd), and each rank divides its
    sums by their mean over the W ranks: the mean of the ranks' losses is
    then the one-process loss of the global batch, and so is the mean of
    their gradients (``parallel.all_reduce_gradients``).
    """
    positive = gt_conf > 0
    n_pos = parallel.global_sum(positive.sum().float())
    n_pos_f = torch.clamp(n_pos, min=1.0) / parallel.data_parallel_size()

    loc_loss = torch.sum(torch.sum(smooth_l1(mb_loc - gt_loc), dim=-1) * positive) / n_pos_f

    ce = -F.log_softmax(mb_conf, dim=-1)
    conf_all = torch.gather(ce, -1, gt_conf[..., None].long())[..., 0]

    neg_losses = torch.where(positive, -torch.inf, conf_all.detach())
    order = torch.argsort(-neg_losses, dim=1, stable=True)
    rank = torch.argsort(order, dim=1, stable=True)
    n_pos_per_img = positive.sum(dim=1, keepdim=True)
    hard_neg = rank < k * n_pos_per_img

    conf_loss = torch.sum(torch.where(positive | hard_neg, conf_all, 0.0)) / n_pos_f
    return loc_loss, conf_loss
