"""Inference wrappers (counterpart of ``loans_tpu.inference``)."""

from loans_tpu_torch.inference.async_worker import AsynchronousLocalizer
from loans_tpu_torch.inference.localizer import LocalizerInference
from loans_tpu_torch.inference.ssd import SSDInference, load_inference

__all__ = ["AsynchronousLocalizer", "LocalizerInference", "SSDInference", "load_inference"]
