"""Deployable localizer: resize / preprocess / localize / visualize (port
of ``loans_tpu/inference/localizer.py``).

The models are rebuilt from ``manifest.json`` through the registry and
restored from the log dir's ``<Name>_<iter>.pt`` snapshots. One forward
(backbone, crop, optional assessor, boxes, optional VisualBackprop heat
map) runs under ``torch.inference_mode()``; assessor gating happens on the
host, as in the JAX package: below ``score_threshold`` a frame's box and
score are zeroed.

Precision: float32 throughout. ``set_precision`` turns off TF32 in both
cuDNN convolutions and cuBLAS matmuls (``torch.backends.cudnn.allow_tf32``,
``torch.backends.cuda.matmul.allow_tf32``), so results on the card match
the JAX reference's float32 results. These are process-wide PyTorch flags;
this is the one place the port sets them.
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import torch

from loans_tpu_torch.insights.rendering import heatmap_to_rgb
from loans_tpu_torch.insights.visual_backprop import visual_backprop
from loans_tpu_torch.ops.geometry import corners_to_aabb, theta_corners
from loans_tpu_torch.train import checkpoint
from loans_tpu_torch.utils.registry import build_assessor, build_model


def set_precision() -> None:
    """Full float32: no TF32 in cuDNN convolutions or cuBLAS matmuls."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _to_host(out) -> list[np.ndarray | None]:
    return [None if t is None else t.cpu().numpy() for t in out]


class LocalizerInference:
    def __init__(
        self,
        log_dir: str,
        device: str | torch.device = "cuda",
        snapshot: str | None = None,
        score_threshold: float = 0.3,
        use_assessor: bool = False,
        use_visual_backprop: bool = False,
    ):
        set_precision()
        self.log_dir = log_dir
        self.device = torch.device(device)
        self.manifest = checkpoint.load_manifest(log_dir)
        loc_cfg = self.manifest["localizer"]
        self.localizer = build_model(loc_cfg["model"], **loc_cfg["kwargs"])
        self.input_size = self.localizer.input_size
        self.score_threshold = score_threshold
        self.use_visual_backprop = use_visual_backprop
        self.use_assessor = use_assessor and "assessor" in self.manifest
        self.assessor = None
        if self.use_assessor:
            # seeded apart from the global stream: these are the parameters
            # served where the log dir holds no assessor snapshot
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(0)
                self.assessor = build_assessor(self.manifest["assessor"], self.localizer)
        self._load_weights(snapshot)

    # -- weights ----------------------------------------------------------
    def _latest(self, name: str) -> str:
        snaps = checkpoint.list_snapshots(self.log_dir, name + "_")
        if not snaps:
            raise FileNotFoundError(f"no {name}_*.pt snapshots in {self.log_dir}")
        return snaps[-1][1]

    def _load_weights(self, snapshot: str | None) -> None:
        """Restore the localizer from ``snapshot`` (default: the latest
        ``<Localizer>_*.pt``; none raises) and the assessor from its latest
        snapshot.

        A log dir with no assessor snapshot is served as the JAX package
        serves it: with the assessor's initial parameters, which ``__init__``
        drew from seed 0 (``torch.manual_seed(0)`` inside
        ``torch.random.fork_rng``, so the global stream is left as it was),
        and a warning. Those parameters are not flax's (``key(0)`` through
        flax's initialisers), so the scores, and the frames they gate,
        differ from the JAX package's; the boxes do not.
        """
        names = self.manifest.get("snapshot_names", ["Localizer", "ResnetAssessor"])
        if snapshot is None:
            snapshot = self._latest(names[0])
        elif not os.path.isabs(snapshot):
            snapshot = os.path.join(self.log_dir, snapshot)
        self.localizer.load_state_dict(checkpoint.load_params(snapshot))
        self.localizer.to(self.device).eval()
        if self.assessor is None:
            return
        snaps = checkpoint.list_snapshots(self.log_dir, names[-1] + "_")
        if snaps:
            self.assessor.load_state_dict(checkpoint.load_params(snaps[-1][1]))
        else:
            warnings.warn(
                f"no {names[-1]}_*.pt snapshots in {self.log_dir}: serving the "
                "assessor's initial parameters (seed 0)",
                stacklevel=3,
            )
        self.assessor.to(self.device).eval()

    # -- forward ----------------------------------------------------------
    @torch.inference_mode()
    def _predict(self, images) -> tuple[torch.Tensor | None, ...]:
        """(rois, boxes, scores, heat) on the device for an NHWC float
        batch; heat (N, H, W, 1) is None without VisualBackprop."""
        batch = torch.as_tensor(np.asarray(images, dtype=np.float32))
        batch = batch.to(self.device)
        recorded = [] if self.use_visual_backprop else None
        rois, theta = self.localizer(batch, vbp=recorded)
        boxes = corners_to_aabb(theta_corners(theta), self.input_size, clip=True)
        if self.assessor is not None:
            scores = self.assessor(rois)[:, 0]
        else:
            scores = torch.ones(batch.shape[0], device=self.device)
        heat = None
        if recorded is not None:
            *inputs, anchor = recorded
            heat = visual_backprop(anchor, inputs, self.localizer.vbp_ladder())
        return rois, boxes, scores, heat

    # -- public API (reference surface) -----------------------------------
    def resize(self, image: np.ndarray):
        """Resize HWC uint8/float to the model input; returns (resized,
        (scale_y, scale_x)) for mapping boxes back."""
        import cv2

        h, w = image.shape[:2]
        resized = cv2.resize(
            image,
            (self.input_size.width, self.input_size.height),
            interpolation=cv2.INTER_CUBIC,
        )
        return resized, (h / self.input_size.height, w / self.input_size.width)

    def preprocess(self, image: np.ndarray, bgr_to_rgb: bool = False) -> np.ndarray:
        """HWC -> float32 [0,1] RGB (cv2 frames pass bgr_to_rgb=True)."""
        arr = np.asarray(image)
        if bgr_to_rgb:
            arr = arr[..., ::-1]
        arr = arr.astype(np.float32)
        if arr.max() > 1.5:
            arr = arr / 255.0
        return arr

    def localize(self, image: np.ndarray):
        """Single-image inference.

        Returns (bboxes (1,4) yxyx pixels at model scale, rois, scores,
        heat map or None): with ``use_visual_backprop``, the (H, W, 3)
        uint8 VisualBackprop heat map at model scale (``heatmap_to_rgb``).
        Below ``score_threshold`` with the assessor enabled, boxes and
        scores are zeroed.
        """
        rois, boxes, scores, heat = _to_host(self._predict(image[None]))
        if self.use_assessor and float(scores[0]) < self.score_threshold:
            boxes = np.zeros_like(boxes)
            scores = np.zeros_like(scores)
        return boxes, rois, scores, None if heat is None else heatmap_to_rgb(heat[0])

    def localize_batch(self, images, sync: bool = True):
        """Batched inference over a list/stack of preprocessed frames.

        With ``sync=False`` the device tensors are returned as soon as the
        work is queued, so the caller can prepare the next batch while
        this one computes; pass them to ``finish_batch`` to collect.
        """
        batch = np.stack(images) if isinstance(images, (list, tuple)) else images
        out = self._predict(batch)
        return out if not sync else self.finish_batch(out)

    def finish_batch(self, out):
        """Collect a ``localize_batch(sync=False)`` result; returns
        (boxes (B,1,4), rois, scores (B,), heat maps) with the assessor
        gating applied per frame; the heat maps are a list of (H, W, 3)
        uint8 images with ``use_visual_backprop``, else None."""
        rois, boxes, scores, heat = _to_host(out)
        if self.use_assessor:
            gated = scores < self.score_threshold
            boxes = np.where(gated[:, None], 0.0, boxes).astype(boxes.dtype)
            scores = np.where(gated, 0.0, scores).astype(scores.dtype)
        heat_imgs = None if heat is None else [heatmap_to_rgb(h) for h in heat]
        return boxes[:, None, :], rois, scores, heat_imgs

    def scale_boxes(self, boxes: np.ndarray, scale) -> np.ndarray:
        sy, sx = scale
        return np.asarray(boxes, dtype=np.float64) * np.array([sy, sx, sy, sx])

    def visualize_results(
        self, image: np.ndarray, bboxes, scores=None, color=(0, 255, 0)
    ) -> np.ndarray:
        """Draw boxes/scores on a (possibly BGR) frame with size-adaptive
        line thickness."""
        import cv2

        out = np.ascontiguousarray(np.asarray(image))
        thickness = max(1, min(out.shape[:2]) // 200)
        font_scale = max(0.4, min(out.shape[:2]) / 600)
        h, w = out.shape[:2]
        flat_scores = None if scores is None else np.ravel(scores)
        for i, (y1, x1, y2, x2) in enumerate(
            np.asarray(bboxes, dtype=np.float64).reshape(-1, 4)
        ):
            if not np.isfinite([y1, x1, y2, x2]).all():
                continue
            x1, x2 = np.clip([x1, x2], -w, 2 * w)
            y1, y2 = np.clip([y1, y2], -h, 2 * h)
            if x2 - x1 <= 0 or y2 - y1 <= 0:
                continue
            cv2.rectangle(out, (int(x1), int(y1)), (int(x2), int(y2)), color, thickness)
            if flat_scores is not None and i < len(flat_scores):
                cv2.putText(
                    out,
                    f"{float(flat_scores[i]):.2f}",
                    (int(x1), max(int(y1) - 4, 10)),
                    cv2.FONT_HERSHEY_SIMPLEX,
                    font_scale,
                    color,
                    thickness,
                )
        return out
