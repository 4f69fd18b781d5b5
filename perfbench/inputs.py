"""Inputs made from ``--seed``: weights, pools, frames and the order in
which a pooled feed draws its rows. The same seed gives the same inputs on
the same device; the program and the reference are handed the same.

The pools are ``loans_tpu_torch/bench.py``'s (uniform uint8 scenes and
crops, uniform IoU labels), drawn on the card by ``torch.Generator``. The
index order is a frozen copy of ``data/device_data.py::IndexSampler``'s
first epoch, so that the reference can work the batches out again.
"""

from __future__ import annotations

import numpy as np
import torch

_MASK = (1 << 63) - 1


def sub_seed(seed: int, tag: str) -> int:
    """A seed for one use of ``seed``, apart from every other tag's."""
    h = 1469598103934665603
    for byte in f"{int(seed)}/{tag}".encode():
        h = ((h ^ byte) * 1099511628211) & _MASK
    return h


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def uint8_pool(seed: int, tag: str, shape, device) -> torch.Tensor:
    """A uint8 pool, uniform over [0, 255], on ``device``."""
    return torch.randint(0, 256, tuple(shape), generator=generator(seed, tag, device),
                         dtype=torch.uint8, device=device)


def uniform_pool(seed: int, tag: str, shape, device) -> torch.Tensor:
    """A float32 pool, uniform over [0, 1), on ``device``."""
    return torch.rand(tuple(shape), generator=generator(seed, tag, device), device=device)


def index_seed(seed: int) -> int:
    """The seed a pooled feed is given (numpy takes any whole number)."""
    return sub_seed(seed, "index") >> 32


def first_epoch_batches(n: int, batch: int, seed: int, steps: int) -> np.ndarray:
    """The first ``steps`` batches of indices that ``IndexSampler(n, batch,
    seed=seed)`` yields: its first epoch's permutation, cut in order."""
    if steps * batch > n:
        raise ValueError(f"{steps} batches of {batch} do not fit in the first epoch of {n}")
    order = np.random.default_rng(seed).permutation(n)
    return order[: steps * batch].reshape(steps, batch)


def seeded_weights(spec, seed: int, tag: str, device) -> dict[str, torch.Tensor]:
    """A state dict from ``spec``: ``[(name, shape, rule)]`` where ``rule``
    is ``("normal", std)`` or ``("const", values)``. The normal leaves come
    from one draw on ``device``, each cut from it in ``spec``'s order and
    scaled by its std."""
    total = sum(int(np.prod(shape)) for _, shape, rule in spec if rule[0] == "normal")
    flat = torch.randn(total, generator=generator(seed, tag, device), device=device)
    out, at = {}, 0
    for name, shape, rule in spec:
        if rule[0] == "normal":
            size = int(np.prod(shape))
            out[name] = flat[at:at + size].view(shape) * rule[1]
            at += size
        else:
            value = torch.as_tensor(rule[1], dtype=torch.float32, device=device)
            out[name] = (value.expand(shape) if value.dim() == 0 else value.reshape(shape)).clone()
    return out
