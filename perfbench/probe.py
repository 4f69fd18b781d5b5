"""Readings taken inside the program's pooled step, between its first
steps, for the comparison with the reference: each step's losses, every
leaf's first gradient as its optimiser got it (from Adam's first moment
after one update, mu = (1 - b1) g), the norm of every leaf's optimiser
moments (``moments``, such as AMSGrad's mu and nu_max) after each checked
step, and every leaf's change after the last checked step. It wraps the
step body that the window's call runs; later steps pass through
untouched."""

from __future__ import annotations

import torch


class Probe:
    def __init__(self, states: dict, body, steps: int, loss_keys: tuple[str, ...], moments: tuple[str, ...] = ()):
        """``states``: name prefix -> ``TrainState``; ``body``: the step body
        that ``pooled_step`` calls; ``loss_keys``: the metrics read as the
        step's losses; ``moments``: the keys of the optimiser's per-leaf
        state that are read after each checked step."""
        self.named = {p + n: (s, v) for p, s in states.items() for n, v in s.model.named_parameters()}
        self.start = {k: v.detach().clone() for k, (_, v) in self.named.items()}
        self.body, self.steps, self.loss_keys, self.moments, self.t = body, steps, loss_keys, moments, 0
        self.losses, self.moment_norms, self.grad1, self.change = [], [], None, None

    def __call__(self, *args):
        out = self.body(*args)
        if self.t < self.steps:
            self.t += 1
            metrics = out[2]
            self.losses.append(torch.stack([metrics[k] for k in self.loss_keys]))
            if self.moments:
                self.moment_norms.append(torch.stack([
                    torch.stack([self._moment(s, v, m).norm() for s, v in self.named.values()])
                    for m in self.moments]))
            if self.t == 1:
                self.grad1 = torch.stack([self._first_gradient(s, v).norm() for s, v in self.named.values()])
            if self.t == self.steps:
                self.change = torch.stack([(v.detach() - self.start[k]).norm() for k, (_, v) in self.named.items()])
                self.start = None
        return out

    @staticmethod
    def _moment(state, param, key: str) -> torch.Tensor:
        """The optimiser's ``key`` state of ``param``; zero where it holds
        none (a step that never reached it)."""
        value = state.optimizer.state.get(param, {}).get(key)
        return torch.zeros_like(param) if value is None else value

    @classmethod
    def _first_gradient(cls, state, param) -> torch.Tensor:
        """mu / (1 - b1) after one update."""
        return cls._moment(state, param, "mu") / (1.0 - state.optimizer.param_groups[0]["betas"][0])

    def readings(self) -> dict:
        if self.change is None:
            raise RuntimeError(f"the probe saw {self.t} of its {self.steps} steps")
        names = list(self.named)
        out = {"losses": torch.stack(self.losses).tolist(),
               "grad1": dict(zip(names, self.grad1.tolist())),
               "change": dict(zip(names, self.change.tolist()))}
        if self.moments:
            out["moments"] = [{m: dict(zip(names, row)) for m, row in zip(self.moments, step.tolist())}
                              for step in self.moment_norms]
        return out
