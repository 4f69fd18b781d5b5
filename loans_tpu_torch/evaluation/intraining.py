"""In-training validation: mean IoU and VOC mAP on a held-out set (port of
``loans_tpu/evaluation/intraining.py``).

The localizer runs in eval mode on the card (``train.steps.make_eval_step``:
the backbone, the head and the crop, K1's forward kernel); its theta
becomes clipped axis-aligned boxes, and the ragged matching against the
ground truth runs on the host: the mean over images of the best IoU, and
chainercv-style VOC mAP. ``max_batches`` bounds the evaluation
(``FastEvaluator`` of the reference).
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

from loans_tpu_torch.evaluation.metrics import AccuracyAccumulator
from loans_tpu_torch.evaluation.voc import eval_detection_voc
from loans_tpu_torch.ops.geometry import Size, corners_to_aabb, theta_corners
from loans_tpu_torch.train.steps import make_eval_step, to_float01


class MAPEvaluator:
    """Callable evaluator over batches of (images, gt boxes, ...).

    ``bn_warmup`` > 0 re-estimates the BatchNorm running statistics from
    that many eval batches (train-mode forwards of the backbone and head)
    before scoring, and puts the live statistics back afterwards, so
    training never sees the warmed ones. ``forwards`` counts the eval-mode
    forwards, each of which crops once.
    """

    def __init__(
        self,
        image_size: Size,
        iou_thresh: float = 0.5,
        max_batches: int | None = None,
        bn_warmup: int = 0,
    ):
        self.image_size = Size(*image_size)
        self.iou_thresh = iou_thresh
        self.max_batches = max_batches
        self.bn_warmup = bn_warmup
        self.forwards = 0
        self._eval_step = make_eval_step()

    def _theta(self, loc_state, images, assessor) -> tuple[torch.Tensor, torch.Tensor | None]:
        self.forwards += 1
        if assessor is None:
            return self._eval_step(loc_state, images), None
        model = loc_state.model
        was_training = model.training
        try:
            with torch.no_grad():
                rois, theta = model.eval()(to_float01(images))
                scores = assessor.eval()(rois)[:, 0]
        finally:
            model.train(was_training)
        return theta, scores

    @torch.no_grad()
    def _warm(self, model: torch.nn.Module, batches: list) -> None:
        was_training = model.training
        try:
            model.train()
            for batch in batches[: self.bn_warmup]:
                model.predict_theta(to_float01(batch[0]))
        finally:
            model.train(was_training)

    def __call__(self, loc_state, batches: Iterable, assessor: torch.nn.Module | None = None) -> dict:
        """``batches`` yields (images (N, H, W, 3), gt_boxes (N, R, 4), ...):
        images on the model's device, uint8 or float; gt boxes (y_min,
        x_min, y_max, x_max) pixels on the host, rows of zeros padding.
        With ``assessor`` given, the crops are scored too
        (``mean_assessor_score``)."""
        batches = [b for i, b in enumerate(batches) if self.max_batches is None or i < self.max_batches]
        model = loc_state.model
        saved = None
        if self.bn_warmup:
            saved = {k: v.clone() for k, v in model.named_buffers()}
            self._warm(model, batches)
        try:
            return self._evaluate(loc_state, batches, assessor)
        finally:
            if saved is not None:
                with torch.no_grad():
                    for k, v in model.named_buffers():
                        v.copy_(saved[k])

    def _evaluate(self, loc_state, batches: list, assessor) -> dict:
        acc = AccuracyAccumulator(self.iou_thresh)
        pred_bb, pred_lb, pred_sc, gt_bb, gt_lb = [], [], [], [], []
        crop_scores: list[float] = []
        for batch in batches:
            images, gt = batch[0], batch[1]
            theta, scores = self._theta(loc_state, images, assessor)
            if scores is not None:
                crop_scores.extend(scores.cpu().numpy().tolist())
            boxes = corners_to_aabb(theta_corners(theta), self.image_size, clip=True)
            boxes = boxes.cpu().numpy()
            gt = np.asarray(gt)
            for n in range(boxes.shape[0]):
                gt_n = gt[n].reshape(-1, 4)
                gt_n = gt_n[np.abs(gt_n).sum(axis=1) > 0]
                acc.add(boxes[n : n + 1], gt_n)
                pred_bb.append(boxes[n : n + 1])
                pred_lb.append(np.zeros(1, dtype=np.int64))
                pred_sc.append(np.ones(1, dtype=np.float64))
                gt_bb.append(gt_n)
                gt_lb.append(np.zeros(gt_n.shape[0], dtype=np.int64))
        if not pred_bb:
            return {"mean_iou": 0.0, "map": 0.0}
        voc = eval_detection_voc(pred_bb, pred_lb, pred_sc, gt_bb, gt_lb, iou_thresh=self.iou_thresh)
        result = {
            "mean_iou": acc.summary()["mean_iou"],
            "map": voc["map"],
            "ap/object": float(voc["ap"][0]) if len(voc["ap"]) else 0.0,
        }
        if crop_scores:
            result["mean_assessor_score"] = float(np.mean(crop_scores))
        return result
