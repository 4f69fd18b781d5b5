"""Frozen arithmetic of the benchmark: the peaks of the card, the least
time of a crop call, and the statistics of a run.

The crop's least time is a copy of ``chip_smoke.py::bound`` with its own
copy of the tap arithmetic (``ops/stn.py``'s ``_positions``, ``_offsets``,
``_hat`` and ``_hat_grad`` as they stood when the benchmark was written),
so that the yardstick stays put whatever later implements the crop.
"""

from __future__ import annotations

import math

import torch

# NVIDIA's data sheet, H100 SXM, dense rates at the full 700 W power limit.
FP32_FLOPS_PER_S = 67e12  # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12


def _positions(out_dim: int, device) -> torch.Tensor:
    step = 2.0 / (out_dim - 1) if out_dim > 1 else 0.0
    i = torch.arange(out_dim, dtype=torch.float32, device=device)
    return -1.0 + step * i


def _offsets(scale: torch.Tensor, shift: torch.Tensor, out_dim: int, in_dim: int) -> torch.Tensor:
    """d[n, i, j] = p_i - j: output position i samples input pixel
    p_i = (scale * u_i + shift + 1) * (in - 1) / 2."""
    u = _positions(out_dim, scale.device)
    p = (scale.float()[:, None] * u[None, :] + shift.float()[:, None] + 1.0) * (0.5 * (in_dim - 1))
    j = torch.arange(in_dim, dtype=torch.float32, device=scale.device)
    return p[:, :, None] - j


def _hat(d: torch.Tensor) -> torch.Tensor:
    return (1.0 - d.abs()).clamp(min=0.0)


def _hat_grad(d: torch.Tensor) -> torch.Tensor:
    s = torch.where(d >= 0, 1.0, -1.0)
    a = d.abs()
    grad = torch.where(a < 1.0, -s, torch.where(a == 1.0, -0.5 * s, 0.0))
    return torch.where(torch.isnan(d), d, grad)


def crop_bound_ms(kernel: str, image_shape: tuple[int, int, int, int], theta: torch.Tensor,
                  out_size: tuple[int, int]) -> tuple[float, str]:
    """The least time (ms) the card could take for one call of the
    axis-aligned crop's ``kernel`` ('fwd', 'bwd_theta' or 'bwd_images') at
    these inputs, and whether bytes or operations set it: each input read
    once (of the images, the region that the taps touch), each output
    written once, over the HBM rate; the float32 operations that these
    taps need over the float32 rate."""
    n, h, w, c = image_shape
    ho, wo = out_size
    dy = _offsets(theta[:, 1, 1], theta[:, 1, 2], ho, h)
    dx = _offsets(theta[:, 0, 0], theta[:, 0, 2], wo, w)
    if kernel == "bwd_theta":  # taps where the hat or its derivative is non-zero
        ty = (_hat(dy) != 0) | (_hat_grad(dy) != 0)
        tx = (_hat(dx) != 0) | (_hat_grad(dx) != 0)
    else:
        ty, tx = _hat(dy) != 0, _hat(dx) != 0
    region = float((ty.any(1).sum(1) * tx.any(1).sum(1)).sum()) * c * 4
    ny, nx = ty.sum(-1).double(), tx.sum(-1).double()  # taps per output row / column
    crop_bytes, theta_bytes = n * ho * wo * c * 4, n * 24
    pairs = float((ny.sum(1) * nx.sum(1)).sum()) * c  # (row tap, column tap) pairs
    cols = float(nx.sum() * ho) * c
    if kernel == "fwd":  # read the region, write the crop
        nbytes, flops = region + crop_bytes + theta_bytes, 2 * pairs + 2 * cols
    elif kernel == "bwd_theta":  # read the region and g, write d theta
        nbytes, flops = region + crop_bytes + 2 * theta_bytes, 4 * pairs + 4 * cols + 10 * n * ho * wo * c
    elif kernel == "bwd_images":  # read g, write all of d images
        nbytes, flops = crop_bytes + n * h * w * c * 4 + theta_bytes, 3 * pairs
    else:
        raise ValueError(f"unknown crop kernel {kernel!r}")
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between the
    closest ranks (numpy's default, ``statistics.quantiles``'s
    'inclusive' method)."""
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def union_length(intervals, lo: float, hi: float) -> float:
    """Length of the union of (start, end) intervals, clipped to [lo, hi]."""
    return sum(b - a for a, b in merged(intervals, lo, hi))


def merged(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The union of (start, end) intervals, clipped to [lo, hi], as
    disjoint sorted intervals."""
    out: list[list[float]] = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    out, t = [], lo
    for a, b in merged(intervals, lo, hi):
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out
