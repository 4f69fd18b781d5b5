"""Sampler comparison on the card (port of ``tools/bench_samplers.py``).

    python -m loans_tpu_torch.cli.bench_samplers [--step] [--batch 128]
        [--rotation-ratio 0.5] [--device cuda]

Prints the card's name and power limit (``nvidia-smi``) first. Then, at
the JAX tool's operating point (batch 64, 224x224 -> 75x75, float32, TF32
off), the forward and forward + backward (d images and d theta of
``sum(crop ** 2)``) of each ``spatial_transform`` method that runs on CUDA
tensors, and ``F.grid_sample`` over ``F.affine_grid`` as the library
yardstick. The JAX tool's theta: axis-aligned for ``separable`` /
``pallas``, rotated for the rest. The plain ``separable`` and ``rotated``
versions are timed forward only: their backward takes CPU tensors only, by
design. Each time is the median of CUDA-event times of single calls after
warm-up, the host's launch path included.

``--step`` also times the full pooled alternating step (``pooled_step``,
R-50 localizer and assessor, float32, Adam(amsgrad)) per method
(``pallas``, ``rotated_pallas``, ``general``) at ``--rotation-ratio``, on
the JAX tool's pools (256 uint8 scenes, 512 uint8 crops, seed 0): 10 steps
per call, 2 warm-up calls, 5 timed calls, reported as ms/iter and images/s.

The JAX tool's scan-and-readback harness and its matmul calibration guard
against a device whose blocking call could return before the work ended;
CUDA events read the card's own timeline and are not ported. Needs a CUDA
card: it refuses another device.
"""

from __future__ import annotations

import argparse
import functools
import statistics
import subprocess

import numpy as np
import torch
import torch.nn.functional as F

from loans_tpu_torch.data.device_data import device_chunk_batches
from loans_tpu_torch.inference.localizer import set_precision
from loans_tpu_torch.models import Localizer, ResnetAssessor
from loans_tpu_torch.ops.geometry import Size
from loans_tpu_torch.ops.stn import spatial_transform
from loans_tpu_torch.train import AlternatingConfig, create_train_state, pooled_step

BATCH = 64
IMG, CROP = Size(224, 224), Size(75, 75)
METHODS = ("separable", "pallas", "rotated", "rotated_pallas", "general")
STEP_METHODS = ("pallas", "rotated_pallas", "general")
PLAIN = ("separable", "rotated")  # backward on CPU tensors only
AXIS_ALIGNED_THETA = ((0.7, 0.0, 0.1), (0.0, 0.6, -0.1))
ROTATED_THETA = ((0.7, 0.15, 0.1), (-0.12, 0.6, -0.1))
STEPS_PER_CALL, WARMUP_CALLS, TIMED_CALLS = 10, 2, 5


def card_name() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def median_ms(fn, warmup: int = 3, reps: int = 25) -> float:
    """Median CUDA-event time of single calls of ``fn``, in ms."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _theta(rows, device) -> torch.Tensor:
    return torch.tensor(rows, dtype=torch.float32, device=device).expand(BATCH, 2, 3).contiguous()


def _fwd_bwd(crop, images, theta):
    """d images and d theta of ``sum(crop(images, theta) ** 2)``."""
    images = images.detach().requires_grad_()
    theta = theta.detach().requires_grad_()
    out = crop(images, theta)
    return torch.autograd.grad((out * out).sum(), (images, theta))


def bench_standalone(device: torch.device) -> None:
    g = np.random.default_rng(0)
    images = torch.from_numpy(g.uniform(size=(BATCH, IMG.height, IMG.width, 3)).astype(np.float32)).to(device)
    axis_aligned, rotated = _theta(AXIS_ALIGNED_THETA, device), _theta(ROTATED_THETA, device)
    for m in METHODS:
        theta = axis_aligned if m in ("separable", "pallas") else rotated
        crop = functools.partial(spatial_transform, out_size=CROP, method=m)
        print(f"{m + ' forward':48s} {median_ms(lambda: crop(images, theta)):8.3f} ms", flush=True)
        if m in PLAIN:
            print(f"{m + ' forward+backward':48s} not timed: the plain backward takes CPU tensors "
                  "only, by design", flush=True)
            continue
        ms = median_ms(lambda: _fwd_bwd(crop, images, theta))
        print(f"{m + ' forward+backward (d/dimg,d/dtheta)':48s} {ms:8.3f} ms", flush=True)

    nchw = images.permute(0, 3, 1, 2).contiguous()

    def library(im, th):  # a yardstick only: the port never calls it
        grid = F.affine_grid(th, (BATCH, 3, CROP.height, CROP.width), align_corners=True)
        return F.grid_sample(im, grid, mode="bilinear", padding_mode="zeros", align_corners=True)

    print(f"{'library grid_sample forward':48s} {median_ms(lambda: library(nchw, rotated)):8.3f} ms", flush=True)
    ms = median_ms(lambda: _fwd_bwd(library, nchw, rotated))
    print(f"{'library grid_sample forward+backward':48s} {ms:8.3f} ms", flush=True)


def bench_step(device: torch.device, batch: int, rotation_ratio: float) -> None:
    """The full pooled alternating step per sampler method."""
    g = np.random.default_rng(0)
    pools = {
        "unlabeled": {"unlabeled": g.integers(0, 256, (256, IMG.height, IMG.width, 3), dtype=np.uint8)},
        "reference": {
            "real": g.integers(0, 256, (512, CROP.height, CROP.width, 3), dtype=np.uint8),
            "labels": g.uniform(size=(512, 1)).astype(np.float32),
        },
    }
    config = AlternatingConfig(image_size=IMG)
    step = functools.partial(pooled_step, steps_per_call=STEPS_PER_CALL, config=config)
    for m in STEP_METHODS:
        torch.manual_seed(0)
        localizer = Localizer(out_size=CROP, n_layers=50, input_size=IMG, sampler=m,
                              rotation_dropout_ratio=rotation_ratio).to(device)
        assessor = ResnetAssessor(in_size=CROP).to(device)
        loc_state, ass_state = create_train_state(localizer), create_train_state(assessor)
        chunks = device_chunk_batches(pools, batch, STEPS_PER_CALL, seed=0, device=device)
        generator = torch.Generator(device=device).manual_seed(1)
        for _ in range(WARMUP_CALLS):
            loc_state, ass_state, metrics = step(loc_state, ass_state, next(chunks), generator)
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(TIMED_CALLS):
            loc_state, ass_state, metrics = step(loc_state, ass_state, next(chunks), generator)
        end.record()
        end.synchronize()
        loss = float(metrics["loss_localizer"])
        ms_per_iter = start.elapsed_time(end) / (TIMED_CALLS * STEPS_PER_CALL)
        print(f"step[{m}] rotation_ratio={rotation_ratio} batch={batch}: {ms_per_iter:.2f} ms/iter, "
              f"{batch / ms_per_iter * 1e3:.1f} img/s (loss_localizer {loss:.5f})", flush=True)
        del localizer, assessor, loc_state, ass_state, chunks
        torch.cuda.empty_cache()


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="compare the crop's samplers on a CUDA card")
    p.add_argument("--step", action="store_true", help="also time the full alternating step per sampler")
    p.add_argument("--batch", type=int, default=128, help="batch of the --step runs")
    p.add_argument("--rotation-ratio", type=float, default=0.5)
    p.add_argument("--device", default="cuda", help="a CUDA device (default: cuda)")
    return p


def main(argv=None) -> None:
    args = get_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise SystemExit(f"bench_samplers times a CUDA card; {args.device!r} is not one here")
    set_precision()
    print(card_name(), flush=True)
    print(f"device {torch.cuda.get_device_name(device)}, torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    bench_standalone(device)
    if args.step:
        bench_step(device, args.batch, args.rotation_ratio)


if __name__ == "__main__":
    main()
