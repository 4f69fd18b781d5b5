"""The crop alone on the card: the device time of one call through the
program's public ``ops.stn.spatial_transform``, with the method that the
cell's localizer picks, against the least time of the frozen bound.

Each call is timed by CUDA events on its own, with L2 cold: a spin kernel
holds the card while the host queues a write of twice the L2 cache, the
start event, the call and the end event, so the events see the call's
device time and no host gap before it.
"""

from __future__ import annotations

import statistics

import torch

from perfbench import inputs
from perfbench.yardstick import crop_bound_ms

L2_FLUSH_BYTES = 2 * 50 * 2**20
SPIN_CYCLES = 2_000_000  # ~1 ms: longer than the host takes to queue a call
WARMUP, CALLS = 5, 50


def thetas(seed: int, n: int, device) -> torch.Tensor:
    """Axis-aligned thetas around the localizer's initial transform (a
    centred 0.8-scale crop): scales 0.8 ± 0.1, shifts ± 0.1, uniform."""
    u = inputs.uniform_pool(seed, "crop_theta", (n, 4), device) * 2.0 - 1.0
    theta = torch.zeros(n, 2, 3, device=device)
    theta[:, 0, 0] = 0.8 + 0.1 * u[:, 0]
    theta[:, 1, 1] = 0.8 + 0.1 * u[:, 1]
    theta[:, 0, 2] = 0.1 * u[:, 2]
    theta[:, 1, 2] = 0.1 * u[:, 3]
    return theta


def roofline_percent(ctx, n: int, backward: bool) -> float | None:
    """100 x least time / device time of one call (forward, and with
    ``backward`` d theta), or None off the card."""
    if ctx.device.type != "cuda":
        return None
    from loans_tpu_torch.ops.stn import spatial_transform

    lc = ctx.config["localizer"]
    (h, w), out = lc["input_size"], tuple(lc["out_size"])
    images = inputs.uniform_pool(ctx.seed, "crop_images", (n, h, w, 3), ctx.device)
    theta = thetas(ctx.seed, n, ctx.device)
    grad = inputs.uniform_pool(ctx.seed, "crop_grad", (n, *out, 3), ctx.device)
    method = ctx.program.localizer.sampler_method(images)
    flush = torch.empty(L2_FLUSH_BYTES // 4, device=ctx.device)
    times = []
    for _ in range(WARMUP + CALLS):
        th = theta.clone().requires_grad_(backward)
        begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        flush.zero_()
        begin.record()
        crops = spatial_transform(images, th, out, method=method)
        if backward:
            torch.autograd.grad(crops, th, grad)
        end.record()
        times.append((begin, end))
    torch.cuda.synchronize(ctx.device)
    device_ms = statistics.median(b.elapsed_time(e) for b, e in times[WARMUP:])
    least = crop_bound_ms("fwd", images.shape, theta, out)[0]
    if backward:
        least += crop_bound_ms("bwd_theta", images.shape, theta, out)[0]
    return 100.0 * least / device_ms
