"""On-device SSD augmentation and multibox encoding, the pooled SSD train
path (port of ``loans_tpu/data/ssd_device.py``).

The scenes stay in device memory (``data.device_data``) and every step
augments and encodes its gathered batch on the device:

* photometric jitter, the label-free transforms of
  ``data.device_augment.photometric``;
* expand + crop + resize as ONE axis-aligned window per image, rendered
  by the separable crop: K1's CUDA forward (``sample_separable_kernel``)
  on CUDA tensors, its plain version (``sample_separable``) on CPU
  tensors. Expand is a window larger than the scene (taps outside the
  scene read 0, and a coverage channel stacked onto the scene fills them
  with the mean), crop a smaller one. The window is the first of V drawn
  candidates that meets a minimum-IoU constraint drawn from chainercv's
  {none, 0.1, 0.3, 0.5, 0.7, 0.9}, else the whole scene;
* horizontal flip of the image and its boxes;
* multibox encoding with chainercv's ``MultiboxCoder.encode`` semantics
  over the batch (``encode_batch``).

The JAX package draws from one PRNG key split eight ways; here
``draw_ssd_augment`` draws the same quantities from a ``torch.Generator``
and ``ssd_augment_batch`` applies given draws, so a test can apply the
JAX package's own draws (seeds are never compared).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from loans_tpu_torch.data.device_augment import Jitter, draw_jitter, draw_rows, photometric
from loans_tpu_torch.ops.geometry import Size, box_to_theta
from loans_tpu_torch.ops.multibox import MultiboxCoder
from loans_tpu_torch.ops.stn import sample_separable, sample_separable_kernel
from loans_tpu_torch.train.ssd_steps import ssd_train_step
from loans_tpu_torch.train.steps import to_float01
from loans_tpu_torch.utils.constants import device_constant, device_table
from loans_tpu_torch.utils.tracing import span

# chainercv's random_crop_with_bbox_constraints menu; -1 = no constraint
CONSTRAINTS = (-1.0, 0.1, 0.3, 0.5, 0.7, 0.9)
MEAN_FILL = (123.0, 117.0, 104.0)  # random_expand's fill, RGB, /255 applied
CANDIDATES = 8  # windows drawn per image


def pairwise_iou_yxyx(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., K, 4) x (..., R, 4) -> (..., K, R) IoU, yxyx; 0 where the
    union is not positive."""
    tl = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    br = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clip(br - tl, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = torch.prod(a[..., 2:] - a[..., :2], dim=-1)
    area_b = torch.prod(b[..., 2:] - b[..., :2], dim=-1)
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / torch.clamp(union, min=1e-12), 0.0)


def encode_batch(
    default_cychw: torch.Tensor,
    default_yxyx: torch.Tensor,
    boxes: torch.Tensor,
    valid: torch.Tensor,
    labels: torch.Tensor | None = None,
    variance=(0.1, 0.2),
    iou_thresh: float = 0.5,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched ``MultiboxCoder.encode`` on the boxes' device.

    Args:
      default_cychw / default_yxyx: (K, 4) anchors in both layouts.
      boxes: (N, R, 4) normalized yxyx gt boxes (padded).
      valid: (N, R) bool mask of real boxes; padding gets IoU -1.
      labels: (N, R) int 0-based classes (default all 0).

    Returns:
      (mb_loc (N, K, 4) float32, mb_conf (N, K) int64). The force-match of
      each valid gt's best anchor runs over the gt boxes in order, so on a
      shared best anchor the later box wins, as the numpy assignment does.
      An image with no valid box gets all-zero targets.
    """
    n, r = boxes.shape[:2]
    if labels is None:
        labels = torch.zeros((n, r), dtype=torch.long, device=boxes.device)
    iou = pairwise_iou_yxyx(default_yxyx, boxes)  # (N, K, R)
    iou = torch.where(valid[:, None, :], iou, -1.0)
    index = iou.argmax(dim=2)  # the first best gt, as jnp.argmax
    best = iou.amax(dim=2)
    masked = best >= iou_thresh
    best_anchor = iou.argmax(dim=1)  # (N, R)
    rows = torch.arange(n, device=boxes.device)
    for i in range(r):
        ba, v = best_anchor[:, i], valid[:, i]
        masked[rows, ba] = masked[rows, ba] | v
        index[rows, ba] = torch.where(v, i, index[rows, ba])

    matched = torch.gather(boxes, 1, index[..., None].expand(n, index.shape[1], 4))
    cy = (matched[..., :2] + matched[..., 2:]) / 2
    hw = matched[..., 2:] - matched[..., :2]
    d_cy, d_hw = default_cychw[:, :2], default_cychw[:, 2:]
    # the log in float64, cast back: on the CPU, the first float32 torch.log
    # after a large multithreaded elementwise op (a weight init is one) can
    # lose about half its bits
    log_hw = torch.log((torch.clamp(hw, min=1e-8) / d_hw).double()).float()
    loc = torch.cat([(cy - d_cy) / (variance[0] * d_hw), log_hw / variance[1]], dim=-1)
    keep = masked & valid.any(dim=1, keepdim=True)
    conf = torch.where(keep, torch.gather(labels.long(), 1, index) + 1, 0)
    loc = torch.where(keep[..., None], loc, 0.0)
    return loc.float(), conf


class SSDDraws(NamedTuple):
    """One batch's random draws (N images, V candidate windows each)."""

    jitter: Jitter  # photometric values, each (N, 1, 1, 1)
    expand: torch.Tensor  # (N, V) bool: the candidate expands
    ratio: torch.Tensor  # (N, V) expand ratio in [1, 4), used where expand
    scale: torch.Tensor  # (N, V) crop scale in [0.3, 1)
    aspect: torch.Tensor  # (N, V) in [0, 1): position in the log aspect range
    uy: torch.Tensor  # (N, V) in [0, 1): window position
    ux: torch.Tensor
    constraint: torch.Tensor  # (N,) int index into CONSTRAINTS
    flip: torch.Tensor  # (N,) bool


def draw_ssd_augment(generator: torch.Generator | None, scenes: torch.Tensor) -> SSDDraws:
    """Draw one batch's augmentation from ``generator`` (on its device),
    with the JAX package's distributions; the tensors land on the scenes'
    device. In data-parallel training each draw is made for the global
    batch and this rank keeps its rows (``device_augment.draw_rows``)."""
    n, v = scenes.shape[0], CANDIDATES

    def uniform(*shape):
        return draw_rows(generator, n, shape, device=scenes.device)

    return SSDDraws(
        jitter=draw_jitter(generator, scenes),
        expand=uniform(v) < 0.5,
        ratio=1.0 + 3.0 * uniform(v),
        scale=0.3 + 0.7 * uniform(v),
        aspect=uniform(v),
        uy=uniform(v),
        ux=uniform(v),
        constraint=draw_rows(generator, n, device=scenes.device, randint=len(CONSTRAINTS)),
        flip=uniform() < 0.5,
    )


@device_constant
def _mean_fill(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``MEAN_FILL / 255`` in ``dtype``, divided on ``device``."""
    return torch.tensor(MEAN_FILL, dtype=dtype, device=device) / 255.0


def augment_windows(draws: SSDDraws, boxes: torch.Tensor, valid: torch.Tensor, s: int) -> torch.Tensor:
    """(N, 4) yxyx window per image in scene pixels: the first candidate
    whose smallest IoU with the valid gt boxes meets the image's
    constraint (an image without a valid box meets any), else the whole
    scene. Window sides are 0.3 to 4.0 times the scene's."""
    n = boxes.shape[0]
    ratio = torch.where(draws.expand, draws.ratio, 1.0)
    cs = draws.scale
    f = cs * ratio
    ar_lo = torch.clamp(cs * cs, min=0.5)
    ar_hi = torch.clamp(1.0 / (cs * cs), max=2.0)
    ar = torch.exp(draws.aspect * (torch.log(ar_hi) - torch.log(ar_lo)) + torch.log(ar_lo))
    ch = f / torch.sqrt(ar) * s
    cw = f * torch.sqrt(ar) * s
    y0 = torch.clamp(s - ch, max=0.0) + draws.uy * torch.abs(s - ch)
    x0 = torch.clamp(s - cw, max=0.0) + draws.ux * torch.abs(s - cw)
    cand = torch.stack([y0, x0, y0 + ch, x0 + cw], dim=-1)  # (N, V, 4)

    con = device_table(CONSTRAINTS, torch.get_default_dtype(), boxes.device)[draws.constraint]
    iou = pairwise_iou_yxyx(cand, boxes)  # (N, V, R)
    iou = torch.where(valid[:, None, :], iou, torch.inf)
    sat = iou.amin(dim=2) >= con[:, None]
    first = sat.int().argmax(dim=1)
    chosen = cand[torch.arange(n, device=boxes.device), first]
    identity = device_table((0.0, 0.0, float(s), float(s)), torch.get_default_dtype(), boxes.device)
    return torch.where(sat.any(dim=1)[:, None], chosen, identity)


def ssd_augment_batch(
    scenes: torch.Tensor,
    boxes: torch.Tensor,
    valid: torch.Tensor,
    out_size: int,
    generator: torch.Generator | None = None,
    draws: SSDDraws | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The SSD augmentation on the scenes' device (``ssd_device.py:125-246``).

    Args:
      scenes: (N, S, S, 3) float32 in [0, 1].
      boxes: (N, R, 4) pixel yxyx gt boxes (padded).
      valid: (N, R) bool.
      out_size: the output side (300 or 512).
      generator, draws: ``draws`` are drawn from ``generator`` where not
        given.

    Returns:
      (images (N, out, out, 3), boxes (N, R, 4) pixel yxyx in the output
      frame, clipped to it, valid (N, R): a box stays valid where its
      centre falls inside the output).
    """
    if draws is None:
        draws = draw_ssd_augment(generator, scenes)
    s = scenes.shape[1]
    scenes = photometric(scenes, draws.jitter)
    win = augment_windows(draws, boxes, valid, s)

    wy0, wx0, wy1, wx1 = win.unbind(-1)
    theta = box_to_theta(torch.stack([wx0, wy0, wx1, wy1], dim=-1), Size(s, s))
    stacked = torch.cat([scenes, torch.ones_like(scenes[..., :1])], dim=-1)
    crop = (sample_separable_kernel if stacked.is_cuda else sample_separable)(
        stacked, theta, Size(out_size, out_size))
    coverage = crop[..., 3:4]
    mean = _mean_fill(scenes.dtype, scenes.device)
    images = crop[..., :3] + (1.0 - coverage) * mean

    # the renderer's align-corners map (box_to_theta): source wy0 -> output
    # 0, wy0 + (h - 1) -> output out - 1
    sy = (out_size - 1) / torch.clamp(wy1 - wy0 - 1.0, min=1e-3)
    sx = (out_size - 1) / torch.clamp(wx1 - wx0 - 1.0, min=1e-3)
    by0 = (boxes[..., 0] - wy0[:, None]) * sy[:, None]
    bx0 = (boxes[..., 1] - wx0[:, None]) * sx[:, None]
    by1 = (boxes[..., 2] - wy0[:, None]) * sy[:, None]
    bx1 = (boxes[..., 3] - wx0[:, None]) * sx[:, None]
    cy, cx = (by0 + by1) / 2, (bx0 + bx1) / 2
    keep = (cy >= 0) & (cy < out_size) & (cx >= 0) & (cx < out_size)  # chainercv: centre inside
    valid_out = valid & keep
    boxes_out = torch.clip(torch.stack([by0, bx0, by1, bx1], dim=-1), 0, out_size)

    flip = draws.flip
    images = torch.where(flip[:, None, None, None], images.flip(2), images)
    flipped = torch.stack(
        [boxes_out[..., 0], out_size - boxes_out[..., 3], boxes_out[..., 2], out_size - boxes_out[..., 1]], dim=-1)
    boxes_out = torch.where(flip[:, None, None], flipped, boxes_out)
    return images, boxes_out, valid_out


class SSDPooledBody:
    """The SSD train step over a raw scene pool, Trainer-shaped for
    ``train.steps.pooled_step`` (port of ``ssd_pooled_body``,
    ``ssd_device.py:249-303``).

    ``body(state, None, batch, generator, config)`` with ``batch =
    {'scenes' (N, S, S, 3) uint8 or float, 'boxes' (N, R, 4) pixel yxyx,
    'valid' (N, R) bool}``: augments (draws from ``generator``) and encodes
    on the device, then one ``train.ssd_steps.ssd_train_step`` of
    ``state``, in place. The augmentation is outside the loss, so the crop
    runs forward only. ``config`` is the pooled step's and unused. Returns
    (state, None, metrics ``loss``, ``loss/loc``, ``loss/conf``).
    """

    def __init__(self, coder: MultiboxCoder, out_size: int, augment: bool = True):
        self.coder = coder
        self.out_size = out_size
        self.augment = augment
        self._defaults: dict[torch.device, tuple[torch.Tensor, torch.Tensor]] = {}

    def defaults(self, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
        """The anchors (cychw, yxyx) on ``device``, uploaded once."""
        if device not in self._defaults:
            self._defaults[device] = (torch.from_numpy(self.coder.default_bbox).to(device),
                                      torch.from_numpy(self.coder.default_yxyx).to(device))
        return self._defaults[device]

    def targets(self, batch: dict[str, torch.Tensor], generator: torch.Generator | None):
        """(images, gt_loc, gt_conf) of a gathered batch, in the span
        ``loans.train.targets``."""
        with span("loans.train.targets"):
            scenes, boxes, valid = to_float01(batch["scenes"]), batch["boxes"], batch["valid"]
            if self.augment:
                images, boxes, valid = ssd_augment_batch(scenes, boxes, valid, self.out_size, generator)
            else:
                images = scenes
            gt_loc, gt_conf = encode_batch(
                *self.defaults(boxes.device), boxes / self.out_size, valid,
                variance=self.coder.variance, iou_thresh=self.coder.iou_thresh,
            )
        return images, gt_loc, gt_conf

    def __call__(self, state, ass_state, batch, generator=None, config=None):
        del ass_state, config
        state, metrics = ssd_train_step(state, self.targets(batch, generator))
        return state, None, metrics
