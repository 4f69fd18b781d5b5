"""Detection metrics on the host (port of ``loans_tpu/evaluation/metrics.py``).

* ``non_maximum_suppression``: greedy NMS, the SSD detector's per-class
  gate (``evaluation/ssd_eval.py``): the rule of the JAX package's Python
  loop ``_nms_python`` (``metrics.py:33-61``), vectorized over the kept
  boxes. The JAX package may run the same rule in its native library
  (``loans_tpu/native``); the port does not load it.
* ``AccuracyAccumulator`` (``metrics.py:90-141``): per image, the best IoU
  of the predicted boxes against the gt boxes is a hit at
  ``iou_threshold`` or above (``evaluate.py:170-195`` of the reference).

The objectness gate of the same JAX module (``postprocess_with_nms``) has
no caller in the port.
"""

from __future__ import annotations

import numpy as np

from loans_tpu_torch.evaluation.voc import _bbox_iou


def non_maximum_suppression(
    bbox: np.ndarray, thresh: float, score: np.ndarray | None = None
) -> np.ndarray:
    """Greedy NMS (chainercv semantics); returns the kept indices.

    ``bbox`` is (N, 4) yxyx; with ``score`` given, boxes are visited in
    descending score order (``argsort()[::-1]``, so of tied scores the one
    numpy's sort places last is visited first), else in index order. A box
    is dropped when its IoU with a kept box exceeds ``thresh``.

    The JAX package's ``_nms_python`` rule and float64 arithmetic, with
    each visited box held against all kept boxes at once instead of one
    by one: the same decisions, in O(N) numpy calls (an untrained SSD
    passes thousands of anchors through the score gate).
    """
    bbox = np.asarray(bbox, dtype=np.float64).reshape(-1, 4)
    if bbox.shape[0] == 0:
        return np.zeros((0,), dtype=np.int64)
    order = (
        np.asarray(score).reshape(-1).argsort()[::-1]
        if score is not None
        else np.arange(bbox.shape[0])
    )
    area = np.prod(bbox[:, 2:] - bbox[:, :2], axis=1)
    selected = np.empty(bbox.shape[0], dtype=np.int64)
    n_kept = 0
    for i in order:
        kept = selected[:n_kept]
        tl = np.maximum(bbox[i, :2], bbox[kept, :2])
        br = np.minimum(bbox[i, 2:], bbox[kept, 2:])
        inter = np.prod(np.clip(br - tl, 0, None), axis=1) * (br > tl).all(axis=1)
        union = area[i] + area[kept] - inter
        with np.errstate(divide="ignore", invalid="ignore"):
            overlap = (union > 0) & (inter / union > thresh)
        if not overlap.any():
            selected[n_kept] = i
            n_kept += 1
    return selected[:n_kept].copy()


class AccuracyAccumulator:
    """Streaming hit/miss and IoU bookkeeping."""

    def __init__(self, iou_threshold: float = 0.5):
        self.iou_threshold = iou_threshold
        self.hits = 0
        self.misses = 0
        self.n_images = 0
        self.ious: list[float] = []
        self.bad_ious: list[float] = []

    def add(self, pred_bboxes: np.ndarray, gt_bboxes: np.ndarray) -> float:
        """Score one image; returns its best IoU."""
        pred = np.asarray(pred_bboxes, dtype=np.float64).reshape(-1, 4)
        gt = np.asarray(gt_bboxes, dtype=np.float64).reshape(-1, 4)
        self.n_images += 1
        if pred.shape[0] == 0 or gt.shape[0] == 0:
            self.misses += 1
            self.bad_ious.append(0.0)
            self.ious.append(0.0)
            return 0.0
        best = float(_bbox_iou(pred, gt).max())
        self.ious.append(best)
        if best >= self.iou_threshold:
            self.hits += 1
        else:
            self.misses += 1
            self.bad_ious.append(best)
        return best

    def summary(self) -> dict:
        precision = self.hits / max(self.n_images, 1)
        recall = self.hits / max(self.hits + self.misses, 1)
        h_mean = (
            2 * precision * recall / (precision + recall)
            if precision + recall > 0
            else 0.0
        )
        return {
            "precision": precision,
            "recall": recall,
            "h_mean": h_mean,
            "mean_iou": float(np.mean(self.ious)) if self.ious else 0.0,
            "bad_iou_mean": float(np.mean(self.bad_ious)) if self.bad_ious else 0.0,
            "hits": self.hits,
            "misses": self.misses,
            "n_images": self.n_images,
        }
