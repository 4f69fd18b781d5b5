"""BBoxPlotter: the per-iteration visual audit of the localizer (port of
``loans_tpu/insights/bbox_plotter.py``).

On one fixed image, one eval-mode forward of the trainer's localizer and
assessor gives the crop, the box, the VisualBackprop heat map, the anchor
feature map and the assessor's pre-head features; they are composed into
the JAX package's canvas: [image with the predicted box (and the gt box) |
the crop | the heat map | the mean feature map | the PCA scatter of the
assessor features], the later tiles resized to the first tile's height as
Pillow's BILINEAR does (``data/image_ops.resize``), and the caption
``assessor: <score>``. The canvas goes to ``<log_dir>/bboxes/<iteration>.png``
and, with ``send_to``, to a progress server (``insights/progress_server``);
a refused connection turns the trainer's ``bbox_vis_enabled`` off until the
``enablebboxvis`` command. The caption is drawn with Pillow's font
(``rendering.draw_text``): without Pillow the plotter is refused by name
when it is made.

The plotter leaves training as it was: no gradient, every module back in
its mode, no BatchNorm statistic updated (eval mode), no draw from a
generator (rotation dropout in eval mode scales, it does not draw) and no
collective (eval-mode BatchNorm; the trainer runs hooks on rank 0 alone).
The forward runs in the models' own dtypes. The PCA runs over the features'
rows, one per image: with one image there is no second component, and the
tile stays white, as in the JAX package.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from loans_tpu_torch.data import image_ops
from loans_tpu_torch.insights.progress_server import ImageClient
from loans_tpu_torch.insights.rendering import (
    COLOR_MAP,
    TEXT_NEEDS_PILLOW,
    draw_boxes_on_image,
    draw_text,
    fill_ellipse,
    heatmap_to_rgb,
    hstack_images,
    pillow_installed,
    write_png,
)
from loans_tpu_torch.insights.visual_backprop import visual_backprop
from loans_tpu_torch.ops.geometry import corners_to_aabb, theta_corners


class BBoxPlotter:
    """A ``Hook`` fn: ``plotter(trainer, iteration)`` returns the HW3
    uint8 canvas it saved."""

    def __init__(
        self,
        image: np.ndarray,
        log_dir: str,
        gt_bbox: np.ndarray | None = None,
        send_to: tuple[str, int] | None = None,
    ):
        if not pillow_installed():
            raise RuntimeError(f"the BBoxPlotter's caption: {TEXT_NEEDS_PILLOW}")
        self.image = np.asarray(image, dtype=np.float32)
        if self.image.max() > 1.5:  # uint8-range input
            self.image = self.image / 255.0
        if self.image.ndim == 3:
            self.image = self.image[None]
        self.gt_bbox = gt_bbox
        self.out_dir = os.path.join(log_dir, "bboxes")
        os.makedirs(self.out_dir, exist_ok=True)
        self.client = ImageClient(*send_to) if send_to else None

    def enable_send(self):
        if self.client is not None:
            self.client.enable_send()

    def forward(self, localizer, assessor) -> tuple:
        """(rois, boxes, score, anchor, heat, feats) of the image on the
        host, from one eval-mode forward without gradients; the modules'
        modes are put back after."""
        modules = [*localizer.modules(), *assessor.modules()]
        modes = [m.training for m in modules]
        device = next(localizer.parameters()).device
        try:
            localizer.eval()
            assessor.eval()
            with torch.no_grad():
                recorded, feats = [], []
                rois, theta = localizer(torch.from_numpy(self.image).to(device), vbp=recorded)
                score = assessor(rois, features=feats)
                boxes = corners_to_aabb(theta_corners(theta), localizer.input_size, clip=True)
                *inputs, anchor = recorded
                heat = visual_backprop(anchor, inputs, localizer.vbp_ladder())
                out = (rois, boxes, score, anchor.float().permute(0, 2, 3, 1), heat, feats[0])
                return tuple(t.float().cpu().numpy() for t in out)
        finally:
            for m, mode in zip(modules, modes):
                m.training = mode

    def __call__(self, trainer, iteration: int) -> np.ndarray:
        canvas = self.compose(*self.forward(trainer.loc_state.model, trainer.ass_state.model))
        write_png(os.path.join(self.out_dir, f"{iteration}.png"), canvas)
        if self.client is not None and getattr(trainer, "bbox_vis_enabled", True):
            if not self.client.send(canvas, title=f"iteration {iteration}"):
                trainer.bbox_vis_enabled = False
        return canvas

    def compose(self, rois, boxes, score, anchor, heat, feats) -> np.ndarray:
        """The canvas of one forward's host arrays (``anchor`` NHWC)."""
        tiles = [draw_boxes_on_image(self.image[0], boxes[:1], gt_boxes=self.gt_bbox)]
        h = tiles[0].shape[0]
        tiles.append(_resize_to_height(_to_img(np.clip(rois[0], 0.0, 1.0)), h))
        tiles.append(_resize_to_height(heatmap_to_rgb(heat[0]), h))
        fmap = anchor[0].mean(axis=-1)
        fmap = (fmap - fmap.min()) / max(fmap.max() - fmap.min(), 1e-12)
        tiles.append(_resize_to_height(heatmap_to_rgb(fmap[..., None]), h))
        tiles.append(_pca_scatter(feats, size=h))
        canvas = hstack_images(tiles)
        draw_text(canvas, (4, canvas.shape[0] - 14), f"assessor: {float(np.ravel(score)[0]):.3f}", COLOR_MAP[0])
        return canvas


def _to_img(arr: np.ndarray) -> np.ndarray:
    a = np.clip(np.asarray(arr, dtype=np.float32), 0, 1)
    if a.ndim == 3 and a.shape[-1] == 1:
        a = np.repeat(a, 3, axis=-1)
    return (a * 255).astype(np.uint8)


def _resize_to_height(img: np.ndarray, h: int) -> np.ndarray:
    w = max(int(round(img.shape[1] * h / img.shape[0])), 1)
    return image_ops.resize(img, (w, h), "bilinear")


def _pca_scatter(feats: np.ndarray, size: int = 224) -> np.ndarray:
    """A white ``size``-square tile with the 2-component PCA of the
    feature rows as dots (the JAX package's rule: nothing drawn with fewer
    than two rows or columns)."""
    x = np.asarray(feats, dtype=np.float64).reshape(feats.shape[0], -1)
    x = x - x.mean(axis=0, keepdims=True)
    img = np.full((size, size, 3), 255, np.uint8)
    if min(x.shape) >= 2:
        u, s, _ = np.linalg.svd(x, full_matrices=False)
        pts = u[:, :2] * s[:2]
        span = np.abs(pts).max() or 1.0
        for i, (px, py) in enumerate(pts):
            cx = int((px / span * 0.45 + 0.5) * size)
            cy = int((py / span * 0.45 + 0.5) * size)
            fill_ellipse(img, cx, cy, COLOR_MAP[i % len(COLOR_MAP)])
    return img
