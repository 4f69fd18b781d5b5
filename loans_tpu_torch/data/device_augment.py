"""On-device, label-preserving augmentation of the assessor's crops (port
of ``loans_tpu/data/device_augment.py``).

A horizontal flip plus brightness/contrast/saturation jitter, vectorized
over the batch on the crops' device; none of them moves the crop window,
so the IoU labels stay true. The draws come from a ``torch.Generator``
(the JAX package's PRNG streams cannot be reproduced); ``augment_crops``
also takes the flips and jitter values explicitly, which is how its
parity with the JAX package is tested.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from loans_tpu_torch import parallel

BRIGHTNESS = (-0.12, 0.12)
CONTRAST = (0.8, 1.25)
SATURATION = (0.7, 1.3)


class Jitter(NamedTuple):
    """Per-image photometric values, each (N, 1, 1, 1)."""

    brightness: torch.Tensor
    contrast: torch.Tensor
    saturation: torch.Tensor


def draw_rows(generator: torch.Generator | None, n: int, shape=(), dtype=torch.float32,
              device: torch.device | None = None, randint: int = 0) -> torch.Tensor:
    """(n, *shape) uniform [0, 1) draws from ``generator`` (integers in
    [0, randint) where ``randint`` is given), on ``device``. In
    data-parallel training the draws are made for the global batch of
    ``n * W`` rows and this rank keeps its own ``n``
    (``parallel.local_rows``), so that W ranks draw what one process draws
    at the global batch."""
    n_global = n * parallel.data_parallel_size()
    where = generator.device if generator is not None else device
    if randint:
        x = torch.randint(randint, (n_global, *shape), generator=generator, device=where)
    else:
        x = torch.rand((n_global, *shape), generator=generator, device=where, dtype=dtype)
    x = parallel.local_rows(x, n)
    return x if device is None else x.to(device)


def _uniform(n: int, bounds, generator, like: torch.Tensor) -> torch.Tensor:
    u = draw_rows(generator, n, (1, 1, 1), like.dtype, like.device)
    return bounds[0] + u * (bounds[1] - bounds[0])


def draw_jitter(generator: torch.Generator | None, images: torch.Tensor) -> Jitter:
    """Brightness in [-0.12, 0.12), contrast in [0.8, 1.25), saturation in
    [0.7, 1.3), uniform per image, as the JAX package draws them."""
    n = images.shape[0]
    return Jitter(*(_uniform(n, b, generator, images) for b in (BRIGHTNESS, CONTRAST, SATURATION)))


def draw_flips(generator: torch.Generator | None, images: torch.Tensor) -> torch.Tensor:
    """(N,) bool, each image flipped with probability 0.5."""
    return draw_rows(generator, images.shape[0], device=images.device) < 0.5


def photometric(images: torch.Tensor, jitter: Jitter) -> torch.Tensor:
    """Brightness/contrast/saturation jitter of (N, H, W, C) float images in
    [0, 1], clipped to [0, 1]; saturation applies to RGB only."""
    mean = images.mean(dim=(1, 2, 3), keepdim=True)
    images = (images - mean) * jitter.contrast + mean + jitter.brightness
    if images.shape[-1] == 3:
        gray = images.mean(dim=-1, keepdim=True)
        images = gray + (images - gray) * jitter.saturation
    return torch.clip(images, 0.0, 1.0)


def augment_crops(
    images: torch.Tensor,
    generator: torch.Generator | None = None,
    flips: torch.Tensor | None = None,
    jitter: Jitter | None = None,
) -> torch.Tensor:
    """Flip and photometrically jitter a batch of float crops (N, H, W, C)
    in [0, 1]. ``flips`` ((N,) bool) and ``jitter`` are drawn from
    ``generator`` where not given."""
    if flips is None:
        flips = draw_flips(generator, images)
    if jitter is None:
        jitter = draw_jitter(generator, images)
    images = torch.where(flips[:, None, None, None], images.flip(2), images)
    return photometric(images, jitter)
