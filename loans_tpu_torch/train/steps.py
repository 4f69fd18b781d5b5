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
both models and their optimizers in place. ``pooled_step`` runs K such
steps on batches gathered on the device from resident pools.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.func import functional_call

from loans_tpu_torch.ops.geometry import Size, theta_corners
from loans_tpu_torch.ops.losses import direction_loss, out_of_image_loss
from loans_tpu_torch.train.state import TrainState


@dataclasses.dataclass(frozen=True)
class AlternatingConfig:
    """Configuration of the alternating update (fields as in the JAX
    package; see there for their history)."""

    localizer_target: float = 1.0
    freeze_assessor: bool = False
    image_size: Size = Size(224, 224)
    # On-device augmentation of the assessor's labeled crops: not ported.
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
      generator: rotation dropout's draw (unused at ratio 0).
      config: the update's configuration.

    Returns:
      (loc_state, ass_state, metrics): metrics are 0-d device tensors
      ``loss_localizer``, ``loss_dis``, ``y_fake_mean``, ``y_real_mean``.
    """
    if config.augment_reference:
        raise NotImplementedError(
            "augment_reference is not ported: data/device_augment.py is "
            "ROADMAP.md Queue 1 item 7 (augment_reference)"
        )
    real_images = to_float01(batch["real"])
    labels = batch["labels"]
    unlabeled = to_float01(batch["unlabeled"])

    loc = loc_state.model.train()
    loc_state.optimizer.zero_grad(set_to_none=True)
    rois, theta = loc(unlabeled, generator=generator)
    scorer = ass_state.ema if config.assessor_ema > 0 else ass_state.model
    y_fake = _score(scorer, rois)
    loss_localizer = mse(y_fake, torch.full_like(y_fake, config.localizer_target))
    corners = theta_corners(theta)
    loss_localizer = loss_localizer + direction_loss(corners, config.image_size)
    loss_localizer = loss_localizer + out_of_image_loss(corners)
    loss_localizer.backward()
    loc_state.apply_gradients()

    ass = ass_state.model.train()
    if config.freeze_assessor:
        with torch.no_grad():
            y_real = ass(real_images)
            loss_dis = mse(y_real, labels)
    else:
        ass_state.optimizer.zero_grad(set_to_none=True)
        y_real = ass(real_images)
        loss_dis = mse(y_real, labels)
        loss_dis.backward()
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
    ass_state: TrainState,
    chunk: dict[str, Any],
    generator: torch.Generator | None = None,
    steps_per_call: int = 1,
    config: AlternatingConfig = AlternatingConfig(),
) -> tuple[TrainState, TrainState, dict[str, torch.Tensor]]:
    """``steps_per_call`` alternating steps on batches gathered on the
    device from resident pools (port of ``make_pooled_train_step``,
    ``steps.py:190-247``).

    ``chunk = {'pools': {group: {key: (N, ...) tensor}}, 'idx': {group:
    (K, B) index tensor}}`` with K = ``steps_per_call``, all on the
    models' device (``data.device_data.device_chunk_batches``). Nothing
    crosses to the host inside the K steps. Metrics are averaged over the
    K steps.
    """
    for group, idx in chunk["idx"].items():
        if idx.shape[0] != steps_per_call:
            raise ValueError(
                f"chunk index of group {group!r} has {idx.shape[0]} steps, "
                f"expected steps_per_call={steps_per_call}"
            )
    history: dict[str, list[torch.Tensor]] = {}
    for t in range(steps_per_call):
        loc_state, ass_state, metrics = alternating_step(
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
