"""Inference wrappers (counterpart of ``loans_tpu.inference``)."""

from loans_tpu_torch.inference.localizer import LocalizerInference

__all__ = ["LocalizerInference"]
