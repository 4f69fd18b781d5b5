"""Train state of one network: model, optimizer, step, optional EMA copy
(port of ``loans_tpu/train/state.py``).

The JAX package keeps params, BatchNorm statistics and the optax state as
pytrees in an immutable ``TrainState``. Here the model and the optimizer
hold them and are updated in place; ``TrainState`` ties them together
with the step counter, which ``apply_gradients`` advances, and the
learning rate, which changes at run time without rebuilding anything
(the reference's ``shiftlr`` command).
"""

from __future__ import annotations

import copy
import dataclasses

import torch
from torch import nn

from loans_tpu_torch import parallel


class AdamAmsgrad(torch.optim.Optimizer):
    """Adam with AMSGrad by optax's rule (``optax.amsgrad``), per step t:

    * mu = b1 * mu + (1 - b1) * g;  nu = b2 * nu + (1 - b2) * g²
    * mu_hat = mu / (1 - b1^t);  nu_hat = nu / (1 - b2^t)
    * nu_max = max(nu_max, nu_hat)
    * p -= lr * mu_hat / (sqrt(nu_max) + eps)

    ``torch.optim.Adam(amsgrad=True)`` keeps the max of the *raw* second
    moment and bias-corrects afterwards, which differs in the early steps.
    Defaults are chainer's Adam (``train_sheep_localizer.py:130-136``).
    A parameter without a gradient counts as a zero gradient, as in optax,
    where every parameter has one. ``step`` of each param group counts
    the updates.
    """

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8):
        super().__init__(params, {"lr": lr, "betas": tuple(betas), "eps": eps, "step": 0})

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AdamAmsgrad.step takes no closure")
        for group in self.param_groups:
            params = group["params"]
            if not params:
                continue
            b1, b2 = group["betas"]
            group["step"] += 1
            t = group["step"]
            grads, mus, nus, nu_maxes = [], [], [], []
            for p in params:
                state = self.state[p]
                if not state:
                    state["mu"] = torch.zeros_like(p)
                    state["nu"] = torch.zeros_like(p)
                    state["nu_max"] = torch.zeros_like(p)
                grads.append(p.grad if p.grad is not None else torch.zeros_like(p))
                mus.append(state["mu"])
                nus.append(state["nu"])
                nu_maxes.append(state["nu_max"])
            torch._foreach_mul_(mus, b1)
            torch._foreach_add_(mus, grads, alpha=1.0 - b1)
            torch._foreach_mul_(nus, b2)
            torch._foreach_addcmul_(nus, grads, grads, value=1.0 - b2)
            nu_hat = torch._foreach_div(nus, 1.0 - b2**t)
            torch._foreach_maximum_(nu_maxes, nu_hat)
            denom = torch._foreach_sqrt(nu_maxes)
            torch._foreach_add_(denom, group["eps"])
            update = torch._foreach_div(mus, 1.0 - b1**t)
            torch._foreach_div_(update, denom)
            torch._foreach_add_(params, update, alpha=-group["lr"])


@dataclasses.dataclass
class TrainState:
    """One network's training state.

    ``ema`` is an optional copy of ``model`` whose parameters follow an
    exponential moving average (the assessor's scoring copy, see
    ``train.steps``); it is not saved in snapshots.
    """

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    ema: nn.Module | None = None

    def apply_gradients(self) -> "TrainState":
        """One optimizer update from the parameters' ``.grad``. In
        data-parallel training the gradients are first averaged over the
        ranks (``parallel.all_reduce_gradients``), so every replica takes
        the same update."""
        parallel.all_reduce_gradients(p for group in self.optimizer.param_groups for p in group["params"])
        self.optimizer.step()
        self.step += 1
        return self

    def with_ema(self) -> "TrainState":
        """A state whose ``ema`` is a fresh copy of ``model`` (never an
        alias), with gradients off."""
        ema = copy.deepcopy(self.model).requires_grad_(False)
        return dataclasses.replace(self, ema=ema)

    @property
    def learning_rate(self) -> float:
        return self.optimizer.param_groups[0]["lr"]

    def with_learning_rate(self, lr: float) -> "TrainState":
        """Set the learning rate of every param group (takes effect at the
        next update; nothing is rebuilt)."""
        for group in self.optimizer.param_groups:
            group["lr"] = float(lr)
        return self


def create_train_state(model: nn.Module, learning_rate: float = 1e-3) -> TrainState:
    """A TrainState at step 0 with Adam(amsgrad) over ``model``'s
    parameters, chainer's defaults (alpha=1e-3, beta1=0.9, beta2=0.999,
    eps=1e-8)."""
    return TrainState(model=model, optimizer=AdamAmsgrad(model.parameters(), lr=learning_rate))
