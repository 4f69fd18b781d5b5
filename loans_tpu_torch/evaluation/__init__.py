"""Evaluation: in-training mean IoU and VOC mAP, the offline snapshot
sweep and its deteval export (counterpart of ``loans_tpu.evaluation``)."""

from loans_tpu_torch.evaluation.deteval import DetEvalWriter
from loans_tpu_torch.evaluation.intraining import MAPEvaluator
from loans_tpu_torch.evaluation.metrics import AccuracyAccumulator
from loans_tpu_torch.evaluation.voc import eval_detection_voc

__all__ = ["AccuracyAccumulator", "DetEvalWriter", "MAPEvaluator", "eval_detection_voc"]
