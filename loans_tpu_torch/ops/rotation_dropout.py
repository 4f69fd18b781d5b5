"""Rotation dropout on affine transform parameters (port of
``loans_tpu/ops/rotation_dropout.py``).

Reference semantics:
  * train: one Bernoulli draw per call, shared across the batch; the
    off-diagonal (rotation/shear) entries are kept with probability
    ``ratio`` and zeroed otherwise.
  * eval: the off-diagonals are deterministically scaled by ``ratio``.

At ``ratio=0.0`` (the production config) both modes zero the
off-diagonals with a constant mask, so the transform is axis-aligned and
the separable sampler applies.
"""

from __future__ import annotations

import torch

from loans_tpu_torch.utils.constants import device_table

_OFFDIAG_ZERO = ((1.0, 0.0, 1.0), (0.0, 1.0, 1.0))


def rotation_dropout(
    theta: torch.Tensor,
    ratio: float = 0.5,
    *,
    train: bool = True,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Apply rotation dropout to (N, 2, 3) affine params.

    Args:
      theta: (N, 2, 3) affine parameters.
      ratio: keep-probability of the off-diagonal terms in train mode /
        their deterministic scale in eval mode.
      train: training-mode flag.
      generator: source of the train-mode draw; required when ``train``
        and ``0 < ratio < 1``. It must live on ``theta``'s device.

    Returns:
      (N, 2, 3) masked parameters.
    """
    offdiag_keep = device_table(_OFFDIAG_ZERO, theta.dtype, theta.device)
    if ratio == 0.0:
        return theta * offdiag_keep
    if not train:
        return theta * (offdiag_keep + (1.0 - offdiag_keep) * ratio)
    if ratio >= 1.0:
        return theta
    if generator is None:
        raise ValueError(
            "rotation_dropout(train=True, 0<ratio<1) needs a generator"
        )
    draw = torch.rand((), generator=generator, device=theta.device)
    flag = (draw < ratio).to(theta.dtype)
    return theta * (offdiag_keep + (1.0 - offdiag_keep) * flag)
