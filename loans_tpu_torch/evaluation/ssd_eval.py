"""SSD detection evaluation (port of ``loans_tpu/evaluation/ssd_eval.py``;
``DetectionVOCEvaluator`` of the reference, ``schaaaafrichter/train.py:
199-203`` and ``schaaaafrichter/evaluate.py``).

The batched decode and softmax run on the model's device
(``train.ssd_steps.make_ssd_predict_step``); per image and class the
score gate, NMS and VOC mAP run on the host in numpy.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

from loans_tpu_torch.evaluation.metrics import non_maximum_suppression
from loans_tpu_torch.evaluation.voc import eval_detection_voc
from loans_tpu_torch.ops.multibox import MultiboxCoder
from loans_tpu_torch.train.ssd_steps import make_ssd_predict_step
from loans_tpu_torch.train.steps import to_float01


class SSDEvaluator:
    """Detections and VOC mAP of an SSD's train state.

    ``detect`` keeps, per foreground class, the anchors scoring
    ``score_thresh`` or more after a softmax, suppresses overlaps above
    ``nms_thresh`` and scales the boxes by the input size.
    """

    def __init__(
        self,
        input_size: int,
        coder: MultiboxCoder,
        score_thresh: float = 0.6,
        nms_thresh: float = 0.45,
        max_batches: int | None = None,
    ):
        self.input_size = input_size
        self.coder = coder
        self.score_thresh = score_thresh
        self.nms_thresh = nms_thresh
        self.max_batches = max_batches
        self._predict = make_ssd_predict_step(coder)

    def detect(self, state, images: torch.Tensor) -> list[tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """One batch of images (N, S, S, 3) on the model's device, uint8 or
        float in [0, 1] -> per image (boxes (M, 4) pixel yxyx, labels (M,)
        0-based, scores (M,)) on the host."""
        boxes, probs = self._predict(state, to_float01(images))
        boxes, probs = boxes.cpu().numpy(), probs.cpu().numpy()
        out = []
        for n in range(boxes.shape[0]):
            per_img_b, per_img_l, per_img_s = [], [], []
            for cls in range(1, probs.shape[-1]):
                score = probs[n, :, cls]
                mask = score >= self.score_thresh
                b, s = boxes[n][mask], score[mask]
                keep = non_maximum_suppression(b, self.nms_thresh, score=s)
                per_img_b.append(b[keep] * self.input_size)
                per_img_l.append(np.full(len(keep), cls - 1, np.int64))
                per_img_s.append(s[keep])
            out.append((
                np.concatenate(per_img_b, axis=0) if per_img_b else np.zeros((0, 4)),
                np.concatenate(per_img_l),
                np.concatenate(per_img_s),
            ))
        return out

    def __call__(self, state, batches: Iterable) -> dict:
        """VOC mAP over ``batches`` of (images on the model's device, gt
        boxes (N, R, 4) pixels on the host, ...); all-zero gt rows are
        padding. At most ``max_batches`` batches."""
        pred_b, pred_l, pred_s, gt_b, gt_l = [], [], [], [], []
        for i, batch in enumerate(batches):
            if self.max_batches is not None and i >= self.max_batches:
                break
            images, gt = batch[0], batch[1]
            for (b, label, s), gt_n in zip(self.detect(state, images), np.asarray(gt)):
                gt_n = gt_n.reshape(-1, 4)
                gt_n = gt_n[np.abs(gt_n).sum(axis=1) > 0]
                pred_b.append(b)
                pred_l.append(label)
                pred_s.append(s)
                gt_b.append(gt_n)
                gt_l.append(np.zeros(gt_n.shape[0], dtype=np.int64))
        if not pred_b:
            return {"map": 0.0}
        return {"map": eval_detection_voc(pred_b, pred_l, pred_s, gt_b, gt_l)["map"]}
