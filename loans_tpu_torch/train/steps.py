"""The alternating localizer/assessor update (port of
``loans_tpu/train/steps.py``).

One step, as ``alternating_step_body`` in the JAX package:

  * localizer: gradients of MSE(assessor(crops), target) + direction and
    out-of-image losses w.r.t. the *localizer's* parameters only. The
    gradient flows through the assessor into the crops and, through the
    separable sampler's backward, into theta; the assessor runs on
    detached parameters, so it gets no gradient from this loss;
  * assessor: gradients of MSE(assessor(real crops), IoU labels) w.r.t.
    its parameters, on its pre-update parameters (the localizer update
    never touches them). Skipped, but still reported, when the assessor
    is frozen.

The JAX step is one jitted XLA program; here it runs eagerly, updating
both models and their optimizers in place. ``supervised_step`` trains the
localizer alone on gt boxes, and ``pooled_step`` runs K steps of either, or
of the SSD body (``data.ssd_device``), on batches gathered on the device from
resident pools.

Data-parallel training (``loans_tpu_torch.parallel``) runs the same steps on
each rank's slice of the global batch: BatchNorm takes the global batch's
statistics, the reference crops' augmentation draws for the global batch
and keeps the rank's rows, and ``TrainState.apply_gradients`` averages the
gradients over the ranks.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch.func import functional_call

from loans_tpu_torch import parallel
from loans_tpu_torch.data.device_augment import augment_crops
from loans_tpu_torch.ops.geometry import Size, corners_to_aabb, theta_corners
from loans_tpu_torch.ops.losses import direction_loss, huber_loss, out_of_image_loss, smooth_iou_loss
from loans_tpu_torch.train.state import TrainState
from loans_tpu_torch.utils.tracing import span


@dataclasses.dataclass(frozen=True)
class AlternatingConfig:
    """Configuration of the alternating update (fields as in the JAX
    package; see there for their history)."""

    localizer_target: float = 1.0
    freeze_assessor: bool = False
    image_size: Size = Size(224, 224)
    # On-device flip/photometric jitter of the assessor's labeled crops
    # (data/device_augment.py), drawn from the step's generator.
    augment_reference: bool = False
    # EMA decay of the assessor parameters that score the localizer
    # (0 = score with the live parameters, the reference behavior).
    assessor_ema: float = 0.0
    # Step from which the EMA accumulates; before it the shadow equals the
    # live parameters exactly.
    assessor_ema_start: int = 0


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(pred - target))


def to_float01(x: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] -> float32 [0, 1]; float passes through. The same
    operations, in the same order, as the JAX package (x * (1 / 255))."""
    if x.dtype == torch.uint8:
        return x.float() * (1.0 / 255.0)
    return x


def _score(model: torch.nn.Module, rois: torch.Tensor) -> torch.Tensor:
    """``model(rois)`` on detached parameters: the gradient reaches
    ``rois`` but not the model."""
    detached = {k: v.detach() for k, v in model.named_parameters()}
    return functional_call(model, detached, (rois,))


def _ema_update(ema: torch.nn.Module, model: torch.nn.Module, decay: float) -> None:
    """ema = decay * ema + (1 - decay) * params, in place."""
    with torch.no_grad():
        e = list(ema.parameters())
        torch._foreach_mul_(e, decay)
        torch._foreach_add_(e, list(model.parameters()), alpha=1.0 - decay)


def alternating_step(
    loc_state: TrainState,
    ass_state: TrainState,
    batch: dict[str, torch.Tensor],
    generator: torch.Generator | None = None,
    config: AlternatingConfig = AlternatingConfig(),
) -> tuple[TrainState, TrainState, dict[str, torch.Tensor]]:
    """One alternating update (``steps.py:96-187``), in place.

    Args:
      loc_state, ass_state: the localizer's and the assessor's states.
      batch: ``{'real': (N, h, w, c), 'labels': (N, 1), 'unlabeled':
        (N, H, W, 3)}``, uint8 or float in [0, 1], on the models' device.
      generator: rotation dropout's draw (unused at ratio 0) and the
        reference crops' augmentation.
      config: the update's configuration.

    Returns:
      (loc_state, ass_state, metrics): metrics are 0-d device tensors
      ``loss_localizer``, ``loss_dis``, ``y_fake_mean``, ``y_real_mean``.
    """
    real_images = to_float01(batch["real"])
    labels = batch["labels"]
    unlabeled = to_float01(batch["unlabeled"])
    if config.augment_reference:
        real_images = augment_crops(real_images, generator)

    with span("loans.train.localizer.forward"):
        loc = loc_state.model.train()
        loc_state.optimizer.zero_grad(set_to_none=True)
        rois, theta = loc(unlabeled, generator=generator)
        scorer = ass_state.ema if config.assessor_ema > 0 else ass_state.model
        y_fake = _score(scorer, rois)
        loss_localizer = mse(y_fake, torch.full_like(y_fake, config.localizer_target))
        corners = theta_corners(theta)
        loss_localizer = loss_localizer + direction_loss(corners, config.image_size)
        loss_localizer = loss_localizer + _global_out_of_image_loss(corners)
    with span("loans.train.localizer.backward"):
        loss_localizer.backward()
    with span("loans.train.localizer.update"):
        loc_state.apply_gradients()

    with span("loans.train.assessor.forward"):
        ass = ass_state.model.train()
        if config.freeze_assessor:
            with torch.no_grad():
                y_real = ass(real_images)
                loss_dis = mse(y_real, labels)
        else:
            ass_state.optimizer.zero_grad(set_to_none=True)
            y_real = ass(real_images)
            loss_dis = mse(y_real, labels)
    if not config.freeze_assessor:
        with span("loans.train.assessor.backward"):
            loss_dis.backward()
        with span("loans.train.assessor.update"):
            ass_state.apply_gradients()
            if config.assessor_ema > 0:
                decay = config.assessor_ema
                if config.assessor_ema_start > 0 and ass_state.step < config.assessor_ema_start:
                    decay = 0.0  # pins the shadow to the live parameters
                _ema_update(ass_state.ema, ass, decay)

    metrics = {
        "loss_localizer": loss_localizer.detach(),
        "loss_dis": loss_dis.detach(),
        "y_fake_mean": y_fake.detach().mean(),
        "y_real_mean": y_real.detach().mean(),
    }
    return loc_state, ass_state, metrics


def _global_out_of_image_loss(corners: torch.Tensor) -> torch.Tensor:
    """``out_of_image_loss``, a sum over the batch, as this rank's share of
    the global batch's sum: W times its slice's sum in data-parallel
    training, so that the mean over the ranks of the losses, and of their
    gradients (``TrainState.apply_gradients`` averages them), is the
    global sum's, as the mean losses beside it are the global means."""
    return out_of_image_loss(corners) * parallel.data_parallel_size()


def supervised_step(
    loc_state: TrainState,
    ass_state: None,
    batch,
    generator: torch.Generator | None = None,
    config: AlternatingConfig = AlternatingConfig(),
) -> tuple[TrainState, None, dict[str, torch.Tensor]]:
    """One supervised localizer update on gt boxes (port of
    ``supervised_step_body``, ``steps.py:273-331``), in place.

    The loss is Huber on the predicted axis-aligned box (``clip=False``)
    and the gt box, both divided by the larger image side, plus 0.5 times
    the smooth-IoU loss, plus the direction and out-of-image losses. Only
    theta is needed, so the crop does not run (XLA drops it from the JAX
    step for the same reason).

    Args:
      batch: ``(images (N, H, W, 3), gt_boxes (N, 1, 4) yxyx pixels, ...)``
        or a dict with ``'images'`` and ``'boxes'``; uint8 or float images.
      ass_state: unused (the trainer's shape: no assessor).

    Returns:
      (loc_state, None, metrics): ``loss_localizer``, ``loss/box``,
      ``loss/iou``.
    """
    del ass_state
    images, gt = (batch["images"], batch["boxes"]) if isinstance(batch, dict) else batch[:2]
    images = to_float01(images)
    gt = gt.reshape(images.shape[0], -1)[:, :4]
    with span("loans.train.localizer.forward"):
        loc = loc_state.model.train()
        loc_state.optimizer.zero_grad(set_to_none=True)
        theta = loc.predict_theta(images, generator=generator)
        corners = theta_corners(theta)
        boxes = corners_to_aabb(corners, config.image_size, clip=False)
        scale = float(max(config.image_size.height, config.image_size.width))
        reg = torch.mean(huber_loss(boxes / scale, gt / scale))
        iou = smooth_iou_loss(boxes, gt)
        loss = reg + 0.5 * iou
        loss = loss + direction_loss(corners, config.image_size)
        loss = loss + _global_out_of_image_loss(corners)
    with span("loans.train.localizer.backward"):
        loss.backward()
    with span("loans.train.localizer.update"):
        loc_state.apply_gradients()
    metrics = {"loss_localizer": loss.detach(), "loss/box": reg.detach(), "loss/iou": iou.detach()}
    return loc_state, None, metrics


def gather_batch(chunk: dict[str, Any], t: int) -> dict[str, torch.Tensor]:
    """Step ``t``'s batch of a pooled chunk: every group's pools indexed on
    the device by ``chunk['idx'][group][t]``, merged over the groups (in
    sorted group order, as the JAX package merges them)."""
    batch = {}
    for group in sorted(chunk["pools"]):
        ind = chunk["idx"][group][t]
        for key, pool in chunk["pools"][group].items():
            batch[key] = pool.index_select(0, ind)
    return batch


def pooled_step(
    loc_state: TrainState,
    ass_state: TrainState | None,
    chunk: dict[str, Any],
    generator: torch.Generator | None = None,
    steps_per_call: int = 1,
    config: AlternatingConfig = AlternatingConfig(),
    body: Callable = alternating_step,
) -> tuple[TrainState, TrainState | None, dict[str, torch.Tensor]]:
    """``steps_per_call`` steps of ``body`` (``alternating_step``,
    ``supervised_step`` or the SSD body ``data.ssd_device.SSDPooledBody``)
    on batches gathered on the device from resident pools (port of
    ``make_pooled_train_step``, ``steps.py:190-247``).

    ``chunk = {'pools': {group: {key: (N, ...) tensor}}, 'idx': {group:
    (K, B) index tensor}}`` with K = ``steps_per_call``, all on the
    models' device (``data.device_data.device_chunk_batches``). Nothing
    crosses to the host inside the K steps. Metrics are averaged over the
    K steps.

    The call runs in the span ``loans.train.call`` and each step in a
    ``loans.train.step`` inside it (``utils.tracing``).
    """
    for group, idx in chunk["idx"].items():
        if idx.shape[0] != steps_per_call:
            raise ValueError(
                f"chunk index of group {group!r} has {idx.shape[0]} steps, "
                f"expected steps_per_call={steps_per_call}"
            )
    history: dict[str, list[torch.Tensor]] = {}
    with span("loans.train.call"):
        for t in range(steps_per_call):
            with span("loans.train.step"):
                loc_state, ass_state, metrics = body(
                    loc_state, ass_state, gather_batch(chunk, t), generator, config
                )
            for key, value in metrics.items():
                history.setdefault(key, []).append(value)
        means = {key: torch.stack(values).mean() for key, values in history.items()}
    return loc_state, ass_state, means


def make_eval_step():
    """Eval-mode forward: ``(loc_state, images) -> theta`` (N, 2, 3),
    without gradients; the model's train/eval mode is restored after."""

    def eval_step(loc_state: TrainState, images: torch.Tensor) -> torch.Tensor:
        model = loc_state.model
        was_training = model.training
        try:
            with torch.no_grad():
                _, theta = model.eval()(to_float01(images))
        finally:
            model.train(was_training)
        return theta

    return eval_step
