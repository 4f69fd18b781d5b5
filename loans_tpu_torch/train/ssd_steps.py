"""The supervised SSD optimizer, train step and predict step (port of
``loans_tpu/train/ssd_steps.py``).

The optimizer is the JAX package's ``optax.chain(masked(scale(2.0)) on
biases, add_decayed_weights(5e-4) on the rest, adam(lr))`` under
``inject_hyperparams`` (``ssd_steps.py:21-43``; the reference's Adam with
``GradientScaling(2)`` on biases and ``WeightDecay(5e-4)`` on everything
else). The pooled train step over a raw scene pool is
``data.ssd_device.SSDPooledBody``.
"""

from __future__ import annotations

import torch
from torch import nn

from loans_tpu_torch.ops.multibox import MultiboxCoder, multibox_loss
from loans_tpu_torch.train.state import TrainState
from loans_tpu_torch.utils.tracing import span

BIAS_GRAD_SCALE = 2.0
WEIGHT_DECAY = 5e-4


class SSDAdam(torch.optim.Optimizer):
    """Adam by optax's rule, after the SSD gradient transforms, per step t:

    * g = 2 g on a bias (a parameter named ``bias``), g = g + 5e-4 p on
      every other parameter (L2Norm's scale among them);
    * mu = b1 * mu + (1 - b1) * g;  nu = b2 * nu + (1 - b2) * g²
    * p -= lr * (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)

    ``torch.optim.Adam(weight_decay=...)`` adds the decay to every
    parameter and doubles no gradient. Two param groups hold the biases
    and the rest; ``lr`` changes at run time (``TrainState.
    with_learning_rate``) without rebuilding anything, as
    ``inject_hyperparams`` lets the JAX package. A parameter without a
    gradient counts as a zero gradient, as in optax.
    """

    def __init__(self, model: nn.Module, lr: float = 1e-4, betas=(0.9, 0.999), eps: float = 1e-8):
        named = list(model.named_parameters())
        groups = [
            {"params": [p for n, p in named if n.rsplit(".", 1)[-1] == "bias"],
             "grad_scale": BIAS_GRAD_SCALE, "weight_decay": 0.0},
            {"params": [p for n, p in named if n.rsplit(".", 1)[-1] != "bias"],
             "grad_scale": 1.0, "weight_decay": WEIGHT_DECAY},
        ]
        super().__init__(groups, {"lr": lr, "betas": tuple(betas), "eps": eps, "step": 0})

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("SSDAdam.step takes no closure")
        for group in self.param_groups:
            params = group["params"]
            if not params:
                continue
            b1, b2 = group["betas"]
            group["step"] += 1
            t = group["step"]
            grads, mus, nus = [], [], []
            for p in params:
                state = self.state[p]
                if not state:
                    state["mu"] = torch.zeros_like(p)
                    state["nu"] = torch.zeros_like(p)
                grads.append(p.grad if p.grad is not None else torch.zeros_like(p))
                mus.append(state["mu"])
                nus.append(state["nu"])
            if group["grad_scale"] != 1.0:
                grads = torch._foreach_mul(grads, group["grad_scale"])
            if group["weight_decay"]:
                grads = torch._foreach_add(grads, params, alpha=group["weight_decay"])
            torch._foreach_mul_(mus, b1)
            torch._foreach_add_(mus, grads, alpha=1.0 - b1)
            torch._foreach_mul_(nus, b2)
            torch._foreach_addcmul_(nus, grads, grads, value=1.0 - b2)
            denom = torch._foreach_div(nus, 1.0 - b2**t)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, group["eps"])
            update = torch._foreach_div(mus, 1.0 - b1**t)
            torch._foreach_div_(update, denom)
            torch._foreach_add_(params, update, alpha=-group["lr"])


def create_ssd_train_state(model: nn.Module, learning_rate: float = 1e-4) -> TrainState:
    """A TrainState at step 0 with ``SSDAdam`` over ``model``."""
    return TrainState(model=model, optimizer=SSDAdam(model, lr=learning_rate))


def ssd_train_step(state: TrainState, batch) -> tuple[TrainState, dict[str, torch.Tensor]]:
    """One SSD update on encoded targets, in place (``ssd_steps.py:46-76``):
    ``batch = (images (N, S, S, 3), gt_loc (N, K, 4), gt_conf (N, K))``,
    the loss loc + conf with 3 hard negatives a positive. Returns (state,
    metrics ``loss``, ``loss/loc``, ``loss/conf``). In data-parallel
    training the loss counts the global batch's positives
    (``ops.multibox.multibox_loss``) and the update averages the ranks'
    gradients (``TrainState.apply_gradients``)."""
    images, gt_loc, gt_conf = batch
    with span("loans.train.forward"):
        model = state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        mb_loc, mb_conf = model(images)
        loc_loss, conf_loss = multibox_loss(mb_loc, mb_conf, gt_loc, gt_conf)
        loss = loc_loss + conf_loss
    with span("loans.train.backward"):
        loss.backward()
    with span("loans.train.update"):
        state.apply_gradients()
    return state, {"loss": loss.detach(), "loss/loc": loc_loss.detach(), "loss/conf": conf_loss.detach()}


def make_ssd_predict_step(coder: MultiboxCoder):
    """``(state, images) -> (boxes (N, K, 4) yxyx in [0, 1], probs (N, K,
    C+1))`` on the model's device, without gradients (``ssd_steps.py:
    79-96``); NMS runs on the host afterwards."""

    def predict(state: TrainState, images: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        model = state.model
        was_training = model.training
        try:
            with torch.no_grad():
                mb_loc, mb_conf = model.eval()(images)
        finally:
            model.train(was_training)
        return coder.decode_batch(mb_loc), torch.softmax(mb_conf, dim=-1)

    return predict
