"""In-training evaluation: mean IoU and VOC mAP (counterpart of
``loans_tpu.evaluation``)."""

from loans_tpu_torch.evaluation.intraining import MAPEvaluator
from loans_tpu_torch.evaluation.metrics import AccuracyAccumulator
from loans_tpu_torch.evaluation.voc import eval_detection_voc

__all__ = ["AccuracyAccumulator", "MAPEvaluator", "eval_detection_voc"]
