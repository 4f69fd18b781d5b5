"""Deployable SSD detector and the log-dir dispatch (port of
``loans_tpu/inference/ssd.py``; ``schaaaafrichter/sheeping/
sheep_localizer.py`` of the reference).

``SSDInference`` rebuilds the SSD from ``manifest.json``, restores the
latest ``<SSD300|SSD512>_<iter>.pt`` (or a named snapshot) and serves the
``resize`` / ``preprocess`` / ``localize`` / ``visualize_results``
surface of ``LocalizerInference``, so the image CLI takes either. The
decode runs on ``device``, the score gate and NMS on the host.
``load_inference`` builds the wrapper a log dir needs.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from loans_tpu_torch.evaluation.ssd_eval import SSDEvaluator
from loans_tpu_torch.inference.localizer import LocalizerInference, set_precision
from loans_tpu_torch.train import checkpoint
from loans_tpu_torch.train.state import TrainState
from loans_tpu_torch.utils.registry import build_model


class SSDInference:
    def __init__(
        self,
        log_dir: str,
        device: str | torch.device = "cuda",
        snapshot: str | None = None,
        score_threshold: float = 0.6,
        nms_threshold: float = 0.45,
    ):
        set_precision()
        self.log_dir = log_dir
        self.device = torch.device(device)
        self.manifest = checkpoint.load_manifest(log_dir)
        cfg = self.manifest["localizer"]
        self.model = build_model(cfg["model"], **cfg["kwargs"])
        self.input_size = self.model.input_size
        self.score_threshold = score_threshold
        self._evaluator = SSDEvaluator(
            self.input_size, self.model.coder(), score_thresh=score_threshold, nms_thresh=nms_threshold
        )
        self._load_weights(snapshot)
        self._state = TrainState(model=self.model, optimizer=None)

    def _load_weights(self, snapshot: str | None) -> None:
        """Restore ``snapshot``, by default the latest ``<name>_*.pt`` of
        the manifest's first snapshot name (none raises)."""
        if snapshot is None:
            prefix = self.manifest.get("snapshot_names", ["SSD300"])[0]
            snaps = checkpoint.list_snapshots(self.log_dir, prefix + "_")
            if not snaps:
                raise FileNotFoundError(f"no {prefix}_*.pt snapshots in {self.log_dir}")
            snapshot = snaps[-1][1]
        elif not os.path.isabs(snapshot):
            snapshot = os.path.join(self.log_dir, snapshot)
        self.model.load_state_dict(checkpoint.load_params(snapshot))
        self.model.to(self.device).eval()

    # -- public surface ----------------------------------------------------
    def resize(self, image: np.ndarray):
        """Resize HWC to the model's input; returns (resized, (scale_y,
        scale_x)) for mapping boxes back."""
        import cv2

        h, w = image.shape[:2]
        resized = cv2.resize(image, (self.input_size, self.input_size), interpolation=cv2.INTER_CUBIC)
        return resized, (h / self.input_size, w / self.input_size)

    preprocess = LocalizerInference.preprocess

    def localize_batch(self, images) -> list[tuple[np.ndarray, np.ndarray]]:
        """A stack or list of preprocessed (S, S, 3) frames -> per frame
        (boxes (M, 4) pixel yxyx at model scale, scores (M,)), after the
        score gate and NMS."""
        batch = np.stack(images) if isinstance(images, (list, tuple)) else np.asarray(images)
        batch = torch.as_tensor(batch.astype(np.float32, copy=False)).to(self.device)
        self._evaluator.score_thresh = self.score_threshold
        return [(b, s) for b, _, s in self._evaluator.detect(self._state, batch)]

    def localize(self, image: np.ndarray):
        """One image -> (boxes (M, 4) pixel yxyx at model scale, None,
        scores (M,), None): ``LocalizerInference.localize``'s 4-tuple,
        without crops or a heat map."""
        ((boxes, scores),) = self.localize_batch(np.asarray(image)[None])
        return boxes, None, scores, None

    def scale_boxes(self, boxes: np.ndarray, scale) -> np.ndarray:
        sy, sx = scale
        return np.asarray(boxes, dtype=np.float64).reshape(-1, 4) * np.array([sy, sx, sy, sx])

    visualize_results = LocalizerInference.visualize_results


def load_inference(log_dir: str, **kwargs):
    """The wrapper a log dir needs: ``SSDInference`` for an SSD manifest
    (which takes ``device``, ``snapshot`` and ``score_threshold`` of the
    keyword arguments), else ``LocalizerInference(log_dir, **kwargs)``."""
    manifest = checkpoint.load_manifest(log_dir)
    if manifest["localizer"]["model"].upper().startswith("SSD"):
        allowed = {"device", "snapshot", "score_threshold"}
        return SSDInference(log_dir, **{k: v for k, v in kwargs.items() if k in allowed})
    return LocalizerInference(log_dir, **kwargs)
