"""Hit accuracy and IoU bookkeeping of the localizer's evaluation (port of
``AccuracyAccumulator``, ``loans_tpu/evaluation/metrics.py:90-141``).

Per image, the best IoU of the predicted boxes against the gt boxes is a
hit at ``iou_threshold`` or above (``evaluate.py:170-195`` of the
reference). Non-maximum suppression and the objectness gate of the same
JAX module serve the SSD pipeline and are not ported with it.
"""

from __future__ import annotations

import numpy as np

from loans_tpu_torch.evaluation.voc import _bbox_iou


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
