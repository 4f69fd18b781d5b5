#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving and training paths on one CUDA
card.

    python3 chip_smoke.py

Phases, one line or more each; any failure exits non-zero:

1. environment: the card's name and power limit (``nvidia-smi``), the
   torch / CUDA / nvcc versions, and the time to build the CUDA kernels
   from this checkout (one ``nvcc`` per source, all at once);
2. the forward kernel against its plain PyTorch version on the card (TF32
   off), ties, NaN, one-row and one-column crops, an upsampled crop and
   C = 1 and 4 and the CLI's batches of 8 and 256 included, with its time, the plain version's, the library
   yardstick's (``F.grid_sample`` over ``F.affine_grid``) and the bound
   (CUDA events, median of 25 calls; profiler device time, L2-warm and
   L2-cold, one device operation per call);
2b. the two backward kernels (d theta, d images) against the plain
   backward on the card, the same way, with ``F.grid_sample``'s backward
   as the yardstick, ties, NaN, one-row and one-column crops, and for d
   images a zero scale, a flipped scale, an upsampled crop, an infinite
   theta and a huge finite theta included; each bit-identical between two
   runs, one device operation per call, and timed L2-warm and L2-cold;
3. serving: an R-50 224x224 -> 75x75 localizer with the assessor, seeded
   and saved as ``.pt`` snapshots in a temporary log dir, served through
   ``LocalizerInference(device="cuda")``: 2 single-frame requests and 3
   batches of 32 frames, with the forward kernel's launches checked and
   its device time per launch in a traced batch;
4. the same serving models and weights on the CPU against the card;
5. training: ``Trainer`` runs the pooled alternating step (8 steps per
   call, batch 64) on uint8 pools resident on the card, R-50 224->75 and
   the assessor, float32, Adam(amsgrad) lr 1e-3: 1 warm-up chunk and 3
   timed chunks, with each kernel's launches checked, a profiled chunk
   (with the crop kernels' device time per launch there, by name), and
   the last snapshot served through ``LocalizerInference``;
6. two training steps on the card against the CPU from the same weights
   (batch 4, full width);
7. the rotated crop's three kernels (K2: forward, d theta, d images)
   against their plain versions on the card (the forward bit for bit),
   ties, NaN, an upsampled crop, C = 4, a zero scale, a flipped scale, a
   rank-1 and a near-singular theta, an infinite and a huge finite theta
   included, with their times (one device operation per call, L2-warm and
   L2-cold), the plain versions', ``F.grid_sample``'s and the bounds;
8. rotation-dropout training: phase 5 at ``rotation_dropout_ratio=0.5`` on
   ``sampler="rotated_pallas"``, with K2's launches checked and K1's 0,
   the head's off-diagonal bias moved, and the snapshot served through
   K2's forward;
9. two rotated training steps (ratio 1.0) on the card (``rotated_pallas``)
   against the CPU (``rotated``) from the same weights (batch 4, full
   width);
10. the training CLI on the card, float32: first the CLI's own 512 ``stn``
   reference crops rendered by ``render_stn_crops`` (K1's forward, batches
   of 256) against the plain sampler on the same card tensors; then
   ``cli.train_localizer.main`` in this process on synthetic data (256
   scenes, 512 assessor crops rendered by K1's forward, 64 val scenes; one
   asset world), R-50 224->75, batch 64, 96 iterations in calls of 8, mAP
   on 2 val batches at every log entry, the assessor pool regenerated in a
   thread every 16 iterations; K1's launches accounted to the steps, the
   eval forwards and the crop renders, at least one pool swap, and the log
   dir served through ``LocalizerInference`` with boxes equal to the CLI's
   own eval step;
11. the same CLI for 8 ``--supervised`` iterations (no d theta launch) and
   16 ``--bf16`` iterations (every crop still K1's float32 kernel); then
   the bf16 step and the float32 step on phase 5's pools, 3 timed chunks
   each after a warm-up, alternating, and one traced bf16 chunk;
12. offline evaluation: ``cli.evaluate.main`` in this process sweeps phase
   10's three snapshots (iterations 32, 64, 96) on 64 labeled synthetic
   scenes of phase 10's world, batch 32, with the assessor, a BatchNorm
   warm-up of one batch, renders and deteval XML: per snapshot its metrics,
   seconds and eval images/s, K1's forward launched once per batch and pass
   (3 snapshots x 2 batches x 3 passes), nothing else; a second run
   evaluates nothing (resume); the last snapshot scored on the CPU against
   the card (boxes and mean IoU); phase 8's rotated log dir swept the same
   way on K2's forward; the XML and a render read back;
13. VisualBackprop serving: ``LocalizerInference(use_visual_backprop=True)``
   on phase 3's snapshot at batch 32, the heat map card against CPU, and
   serving images/s with and without it (median of 3 batches each, in
   turns);
14. the port's bench (``loans_tpu_torch.bench.measure`` at its operating
   point: R-50 bf16, batch 128, calls of 10 steps), its JSON line with the
   per-call spread and K1's launches.

The line before the last is a JSON object of the six kernels: launches in
phase 10, the CLI (K1), and phase 8 (K2), with the launches of every path
driven (``launches_by_path``), errors from phases 2, 2b and 7, times and
bounds at the training batch: ``ms`` per call (CUDA events, host launch
included), ``device_ms`` (profiler, calls back to back), ``device_cold_ms``
(L2 flushed before each call) and ``device_in_situ_ms`` (per launch in the
traced training chunk; null where the path launches none, as for d images).
The last line is ``{"ok": true, "device": {...}}``. Without a CUDA card it
exits with an error before printing either.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import importlib.util
import json
import os
import statistics
import struct
import subprocess
import tempfile
import time
import xml.etree.ElementTree as ET
import zlib

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from loans_tpu_torch import bench
from loans_tpu_torch.cli import evaluate, train_localizer
from loans_tpu_torch.cli.bench_samplers import FLUSH_BYTES, device_events, device_time, fmt_us
from loans_tpu_torch.data import synthetic
from loans_tpu_torch.data.device_data import device_chunk_batches
from loans_tpu_torch.data.loader import DataLoader, padded_collate
from loans_tpu_torch.evaluation.evaluator import Evaluator
from loans_tpu_torch.inference.localizer import LocalizerInference, set_precision
from loans_tpu_torch.ops import _cuda, stn
from loans_tpu_torch.ops.geometry import Size, box_to_theta, corners_to_aabb, theta_corners
from loans_tpu_torch.ops.stn import sample_rotated_kernel, sample_separable, sample_separable_kernel
from loans_tpu_torch.train import (
    AlternatingConfig,
    MetricsLog,
    Trainer,
    alternating_step,
    checkpoint,
    create_train_state,
    make_eval_step,
    pooled_step,
)
from loans_tpu_torch.utils.registry import build_assessor, build_model

SEED = 0
DEVICE = "cuda"
INPUT, CROP, BATCH = 224, 75, 32
TRAIN_BATCH, STEPS_PER_CALL, TIMED_CHUNKS, LR = 64, 8, 3, 1e-3
POOL_SCENES, POOL_CROPS = 512, 1024
K1_TOL = 1e-5  # absolute, images in [0, 1]
# backward kernels against the plain backward on the card: d theta sums
# ~17k products per image in another order (a fixed tree in the kernel,
# matmuls in the plain version), so relative to its largest entry. d images
# sums a pixel's products in a fixed order in the kernel and in the plain
# version's matmuls or scatter in theirs; a float32 sum of n terms errs by
# up to about n * 2^-24 of their magnitude, in either order. So d images is
# held to the larger of 1e-5 absolute (a few products of cotangents of
# order 1: every crop of 224^2 -> 75^2 at scales of 0.3 and more) and n *
# 2^-24 of its largest entry, n the most products any pixel of this call
# sums (dimages_terms): 51 on the 16x800 crop of a 64^2 image, over 100
# on an upsampled 64^2 -> 200^2 crop. n * 2^-24 is capped at 1e-5 of the
# largest entry, as d theta, where a pixel sums hundreds or thousands (a
# zero scale sends all h_out * w_out = 5625 outputs to a pixel, a rank-1
# theta a line of them).
K1_BWD_TOL = {"dtheta_rel": 1e-5, "dimages_abs": 1e-5, "dimages_rel": 1e-5}
# K2 against its plain version on the card: the forward runs the plain
# version's float32 operations in its order, so it is held bit for bit
# (NaN where the plain version is NaN); d theta sums 5625 pixels' products
# per image in a fixed tree against torch's reductions; d images as K1's
K2_TOL = {"dtheta_rel": 1e-5, "dimages_abs": 1e-5, "dimages_rel": 1e-5}
# degenerate thetas for d images (phases 2b and 7): every output on one
# pixel, negative scales, an infinite theta00 at odd w_out (u = 0 exactly at
# j = 32 of 65, where inf * 0 is NaN: that image's d images all NaN) and
# theta00 = 1e30 (past 2^96, so K2 scans its positions for NaN; none is)
ZERO_SCALE = [[0, 0, -0.21], [0, 0, 0.13]]
FLIP = [[-0.7, 0.2, 0.1], [-0.15, -0.9, 0.05]]
INF_THETA = [[np.inf, 0.1, 0.1], [0.2, 0.5, 0]]
HUGE_THETA = [[1e30, 0.1, 0.1], [0.2, 0.5, 0]]
# card against CPU: float32 on both, sums in another order. The crop is
# held at the card's theta (the kernel against the CPU's plain crop, as in
# phase 2); end to end, a theta error d moves a sample by up to
# 2 * d * (INPUT - 1) / 2 px per axis (scale and shift), and these frames
# step by up to 1.0 between pixels at the rectangles' edges, so the crops
# may differ by 2 * d * (INPUT - 1) on top of rounding (rois_end_to_end).
# the stn renders' uint8 crops, K1 against the plain sampler: the two sum
# in another order, so a float within rounding of a .5 boundary may round to
# the other uint8 value; one step on at most 1e-3 of the pixels, as
# tests/test_torch_synthetic.py holds the port's renders to JAX's
RENDER_TOL = {"steps": 1, "share": 1e-3}
SLICE_TOL = {"theta": 1e-4, "boxes_px": 1e-2, "rois_at_card_theta": 1e-5, "scores": 1e-4}
# two training steps, card against CPU, float32, TF32 off: cuDNN's and the
# CPU's convolutions (and their backwards) sum in another order. Relative
# to each tensor's largest entry: losses 1e-3 (from step 2 on, the
# localizer's loss is mostly the out-of-image sum, linear in theta, which
# follows the R-50 features; serving's theta agrees card vs CPU to ~2e-5
# of its size in phase 4, and step 2 moves theta far off the image, where
# the sum is large); theta's gradient 1e-2: at
# step 1 it is only the assessor's, a sum of ~17k products per image with
# both signs, over a cotangent in which the few ReLUs whose input lies
# within float32 rounding of 0 switch differently on the two devices
# (phase 2b holds the kernel itself to 1e-5 on identical inputs); the
# head's gradient 1e-3; the stem conv's gradient loses digits in float32
# even on one device (0.7% of its largest entry against float64 in the CPU
# tests), so 5e-2; BatchNorm running statistics 1e-4. The crops' cotangent
# itself is printed, not held: a switched ReLU moves a whole receptive
# field's gradient, so its largest elementwise difference is of the order
# of the gradient (each convolution's dgrad alone agrees to 2e-6).
STEP_TOL = {"loss": 1e-3, "dtheta": 1e-2, "head_grad": 1e-3, "stem_grad": 5e-2, "bn_stats": 1e-4}
# phase 12: the evaluation CLI's scenes; card against CPU, the last
# snapshot's boxes after the same BatchNorm warm-up: phase 4's tolerance (the
# same float32 networks, TF32 off; a warm-up on 32 images moves the
# statistics by a float32 sum's error), and its mean IoU by what that moves
EVAL_SCENES = 64
EVAL_TOL = {"boxes_px": SLICE_TOL["boxes_px"]}
# phase 13: the heat map, card against CPU. It multiplies and renormalizes
# the channel means of the 50 recorded maps of R-50, each computed in float32 by cuDNN
# and the CPU in another order (phase 4: theta within ~2e-5 of its size);
# against JAX on the CPU the port's agrees within 1e-6. 1e-3 is a quarter
# of one step of the served uint8 image.
VBP_TOL = 1e-3
# H100 SXM peaks at 700 W (NVIDIA data sheet): HBM bytes/s and float32
# FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
FLUSH_MB = FLUSH_BYTES // 2**20
MANIFEST = {
    "localizer": {
        "model": "Localizer",
        "kwargs": {
            "out_size": [CROP, CROP],
            "n_layers": 50,
            "input_size": [INPUT, INPUT],
            "rotation_dropout_ratio": 0.0,
            "transform_rois_to_grayscale": False,
        },
    },
    "assessor": {"model": "ResnetAssessor", "kwargs": {}},
    "snapshot_names": ["Localizer", "ResnetAssessor"],
}
# rotation-dropout training and serving (phases 8 and 9): the same model
# at the JAX sampler bench's rotation ratio, on the rotated crop's kernels
ROTATED_KWARGS = {"rotation_dropout_ratio": 0.5, "sampler": "rotated_pallas"}
COUNTERS = {"fwd": "launches", "bwd_theta": "launches_bwd_theta", "bwd_images": "launches_bwd_images"}
KERNELS = {"K1": sample_separable_kernel, "K2": sample_rotated_kernel}
LIBRARIES = {"K1": "separable_sampler", "K2": "rotated_sampler"}
NO_LAUNCHES = {"fwd": 0, "bwd_theta": 0, "bwd_images": 0}
# phases 10 and 11: the training CLI at full width (R-50 224->75, batch 64)
# on synthetic data, as a user runs it on one card
# 96 iterations, so that the refresh submitted at chunk 2 (iteration 16) has
# 9 chunk boundaries to be swapped in at: twice the ~4.4 s its 512 crops take
# to generate alone, even at the step's full rate; a snapshot every 32, so
# that phase 12 has a sweep of three to evaluate
CLI_ITERATIONS, CLI_EVAL_BATCHES, CLI_SNAPSHOT_INTERVAL = 96, 2, 32
CLI_ARGV = [
    "synthetic:256", "synthetic:512", "synthetic:64", "--batch-size", str(TRAIN_BATCH),
    "--n-layers", "50", "--target-size", str(INPUT), str(INPUT), "--crop-size", str(CROP), str(CROP),
    "--iterations", str(CLI_ITERATIONS), "--steps-per-call", str(STEPS_PER_CALL),
    "--log-interval", str(STEPS_PER_CALL), "--snapshot-interval", str(CLI_SNAPSHOT_INTERVAL),
    "--eval-batches", str(CLI_EVAL_BATCHES), "--assessor-pipeline", "stn", "--assessor-refresh", "16",
    "--synthetic-assets", "16", "--device", DEVICE,
]


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def reset_launches() -> None:
    for owner in KERNELS.values():
        for attr in COUNTERS.values():
            setattr(owner, attr, 0)


def read_launches() -> dict[str, dict[str, int]]:
    """Launches of each kernel since ``reset_launches``, by crop."""
    return {name: {k: getattr(owner, attr) for k, attr in COUNTERS.items()}
            for name, owner in KERNELS.items()}


def with_kwargs(**kwargs) -> dict:
    """``MANIFEST`` with these localizer kwargs changed."""
    loc = {"model": "Localizer", "kwargs": {**MANIFEST["localizer"]["kwargs"], **kwargs}}
    return {**MANIFEST, "localizer": loc}


def max_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest absolute difference; inf unless both are NaN at the same
    entries, which are left out."""
    nan = torch.isnan(want)
    if not torch.equal(torch.isnan(got), nan):
        return float("inf")
    diff = (got - want)[~nan].abs()
    return float(diff.max()) if diff.numel() else 0.0


def bit_identical(got: torch.Tensor, want: torch.Tensor) -> bool:
    """NaN exactly where ``want`` is NaN, and the same bits everywhere
    else."""
    nan = torch.isnan(want)
    return torch.equal(torch.isnan(got), nan) and torch.equal(
        got[~nan].view(torch.int32), want[~nan].view(torch.int32))


def dimages_terms(theta: torch.Tensor, out_size: Size, h: int, w: int, rotated: bool) -> int:
    """The most products one pixel of d images sums in this call: the
    outputs (i, j) with a non-zero hat on it along both axes."""
    if not rotated:  # (#i reaching row y) * (#j reaching column x)
        rows = (stn._hat(stn._offsets(theta[:, 1, 1], theta[:, 1, 2], out_size.height, h)) > 0).sum(1)
        cols = (stn._hat(stn._offsets(theta[:, 0, 0], theta[:, 0, 2], out_size.width, w)) > 0).sum(1)
        return int((rows.amax(1) * cols.amax(1)).max())
    n = theta.shape[0]
    px, py = stn._rotated_positions(theta, out_size, h, w)
    xs, ys = stn._axis_taps(px, w), stn._axis_taps(py, h)
    counts = torch.zeros(n * h * w, device=theta.device)
    base = torch.arange(n, device=theta.device)[:, None, None] * (h * w)
    for ty in ys:
        for tx in xs:
            live = (ty.hat > 0) & (tx.hat > 0)
            index = (base + ty.index * w + tx.index)[live]
            counts.index_add_(0, index, torch.ones_like(index, dtype=counts.dtype))
    return int(counts.max())


def dimages_tol(tol: dict, terms: int, largest: float) -> float:
    """The d images tolerance of a call whose pixels sum up to ``terms``
    products and whose largest entry is ``largest`` (see K1_BWD_TOL)."""
    return max(tol["dimages_abs"], min(terms * 2.0**-24, tol["dimages_rel"]) * largest)


def cuda_ms(fn, reps: int = 25) -> float:
    """Median CUDA-event time of ``fn`` in ms, after 3 warm-up runs."""
    for _ in range(3):
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


def device_us(fn, match: str = "", cold: bool = False) -> float | None:
    """``device_time``'s µs per call alone."""
    return device_time(fn, match=match, cold=cold).per_call_us


def ms(us: float | None) -> float | None:
    return None if us is None else us / 1e3


def one_kernel_device_times(tag: str, name: str, kernel, n: int, card: str) -> dict:
    """The kernel ``name``'s device time per call, L2-warm and L2-cold, by
    its name; checks that a call is that one kernel and nothing else on the
    card (no fill, no finish, no table pre-pass)."""
    warm = device_time(kernel, match=name)
    cold = device_time(kernel, match=name, cold=True)
    for t in (warm, cold):
        check(len(t.names) == 1 and name in t.names[0] and t.ops_per_call <= 1,
              f"{tag} {name} N={n}: a call ran {t.names}, {t.ops_per_call:g} device operations per call")
    kind = name.split("_sampler_")[1]
    print(f"{tag} {kind} N={n}: device time (profiler, {name}) {fmt_us(warm.per_launch_us)} "
          f"L2-warm, {fmt_us(cold.per_launch_us)} L2-cold (a {FLUSH_MB} MiB copy before each call); "
          f"one device operation per call, {warm.names[0][:60]} ({card})")
    return {"device_ms": ms(warm.per_launch_us), "device_cold_ms": ms(cold.per_launch_us)}


def scenes(rng: np.random.Generator, n: int, size: int) -> np.ndarray:
    """Noise backgrounds, each with one bright rectangle pasted in."""
    frames = rng.uniform(0.0, 0.5, size=(n, size, size, 3)).astype(np.float32)
    for f in frames:
        y, x = rng.integers(0, size // 2, 2)
        h, w = rng.integers(size // 4, size // 2, 2)
        f[y : y + h, x : x + w] = rng.uniform(0.7, 1.0, 3)
    return frames


def on_card(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(DEVICE)


# -- phase 1 --------------------------------------------------------------
def environment() -> str:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card)
    nvcc = subprocess.run(
        [_cuda.nvcc_path(), "--version"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[-1]
    print(f"env: torch {torch.__version__}, CUDA {torch.version.cuda}, nvcc {nvcc}, "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          + ", ".join(f"{m} {'installed' if importlib.util.find_spec(m) else 'absent'}" for m in ("PIL", "cv2", "matplotlib")))
    start = time.perf_counter()
    _cuda.build_all()
    for name in _cuda.SIGNATURES:
        _cuda.load_library(name)
    build_s = time.perf_counter() - start
    print(f"build: {len(_cuda.SIGNATURES)} CUDA libraries in {build_s:.2f} s (one nvcc each, in parallel)")
    for name in _cuda.SIGNATURES:
        log = _cuda.library_path(name).with_suffix(".log").read_text()
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"build: {name}: {line.strip()}")
    return card


# -- bounds and the library yardstick ---------------------------------------
def bound(kernel: str, images: torch.Tensor, theta: torch.Tensor, out_size: Size) -> tuple[float, str]:
    """The least time (ms) the card could take for one call at these
    inputs, and whether bytes or operations set it: each input read once
    (of the images, the region that this run's taps touch), each output
    written once, over the HBM rate; the float32 operations that these
    taps need over the float32 rate."""
    n, h, w, c = images.shape
    ho, wo = out_size
    dy = stn._offsets(theta[:, 1, 1], theta[:, 1, 2], ho, h)
    dx = stn._offsets(theta[:, 0, 0], theta[:, 0, 2], wo, w)
    if kernel == "bwd_theta":  # taps where the hat or its derivative is non-zero
        ty = (stn._hat(dy) != 0) | (stn._hat_grad(dy) != 0)
        tx = (stn._hat(dx) != 0) | (stn._hat_grad(dx) != 0)
    else:
        ty, tx = stn._hat(dy) != 0, stn._hat(dx) != 0
    region = float((ty.any(1).sum(1) * tx.any(1).sum(1)).sum()) * c * 4
    ny, nx = ty.sum(-1).double(), tx.sum(-1).double()  # taps per output row / column
    crop_bytes, theta_bytes = n * ho * wo * c * 4, n * 24
    pairs = float((ny.sum(1) * nx.sum(1)).sum()) * c  # (row tap, column tap) pairs
    cols = float(nx.sum() * ho) * c
    if kernel == "fwd":  # read the region, write the crop
        nbytes, flops = region + crop_bytes + theta_bytes, 2 * pairs + 2 * cols
    elif kernel == "bwd_theta":  # read the region and g, write d theta
        nbytes, flops = region + crop_bytes + 2 * theta_bytes, 4 * pairs + 4 * cols + 10 * n * ho * wo * c
    else:  # read g, write all of d images
        nbytes, flops = crop_bytes + n * h * w * c * 4 + theta_bytes, 3 * pairs
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def library_crop(images_nchw: torch.Tensor, theta: torch.Tensor, out_size: Size) -> torch.Tensor:
    """The same crop as one PyTorch call: ``F.grid_sample`` over
    ``F.affine_grid`` (align corners, zero padding). A yardstick only."""
    grid = F.affine_grid(
        theta, (theta.shape[0], images_nchw.shape[1], out_size.height, out_size.width),
        align_corners=True,
    )
    return F.grid_sample(images_nchw, grid, mode="bilinear", padding_mode="zeros", align_corners=True)


def axis_aligned_theta(rng, n):
    theta = np.zeros((n, 2, 3), dtype=np.float32)
    theta[:, 0, 0] = rng.uniform(0.3, 1.1, n)
    theta[:, 1, 1] = rng.uniform(0.3, 1.1, n)
    theta[:, 0, 2] = rng.uniform(-0.4, 0.4, n)
    theta[:, 1, 2] = rng.uniform(-0.4, 0.4, n)
    return theta


BORDER_THETA = np.array(
    [[[0.6, 0, 0.7], [0, 0.5, 0.8]], [[0.8, 0, -0.9], [0, 0.9, -1.2]],
     [[1.2, 0, 0.0], [0, 1.3, 0.1]], [[0.3, 0, 0.95], [0, 0.3, -0.95]]],
    np.float32,
)


# -- phase 2 --------------------------------------------------------------
def kernel_against_plain(card: str) -> dict:
    rng = np.random.default_rng(SEED)

    def compare(name, images, theta, out_size, expect=None):
        images, theta = on_card(images), on_card(theta)
        got = sample_separable_kernel(images, theta, out_size)
        want = sample_separable(images, theta, out_size)
        torch.cuda.synchronize()
        err = max_err(got, want)
        if expect is not None:
            err = max(err, max_err(got, expect))
        check(err <= K1_TOL, f"K1 {name}: max abs err {err} > {K1_TOL}")
        print(f"K1 {name}: max_abs_err {err:.3e} (tol {K1_TOL})")
        return err, images, theta

    out = Size(CROP, CROP)
    errs, times = [], {}
    for n in (BATCH, TRAIN_BATCH, 128):
        imgs = rng.uniform(size=(n, INPUT, INPUT, 3)).astype(np.float32)
        err, images, theta = compare(f"N={n} {INPUT}^2->{CROP}^2", imgs, axis_aligned_theta(rng, n), out)
        errs.append(err)
        images_nchw = images.permute(0, 3, 1, 2).contiguous()
        kernel = lambda: sample_separable_kernel(images, theta, out)  # noqa: E731
        plain = lambda: sample_separable(images, theta, out)  # noqa: E731
        library = lambda: library_crop(images_nchw, theta, out)  # noqa: E731
        lib_err = float((library().permute(0, 2, 3, 1) - kernel()).abs().max())
        call_ms, plain_ms, lib_ms = cuda_ms(kernel), cuda_ms(plain), cuda_ms(library)
        bound_ms, bound_by = bound("fwd", images, theta, out)
        times[n] = {"ms": call_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by}
        print(f"K1 N={n}: per call (CUDA events, host launch included) kernel "
              f"{call_ms * 1e3:.1f} us, plain bmm {plain_ms * 1e3:.1f} us, library grid_sample "
              f"{lib_ms * 1e3:.1f} us (max abs diff to the kernel {lib_err:.2e}); bound "
              f"{bound_ms * 1e3:.2f} us ({bound_by}) ({card})")
        times[n].update(one_kernel_device_times("K1", "separable_sampler_fwd", kernel, n, card))
        print(f"K1 N={n}: device time (profiler) kernel {fmt_us(times[n]['device_ms'] * 1e3)}, plain bmm "
              f"{fmt_us(device_us(plain))}, library {fmt_us(device_us(library))} ({card})")

    small = rng.uniform(size=(4, CROP, CROP, 3)).astype(np.float32)
    identity = np.tile(np.array([[1, 0, 0], [0, 1, 0]], np.float32), (4, 1, 1))
    errs.append(compare("identity", small, identity, out, expect=on_card(small))[0])
    ties = rng.uniform(size=(4, 129, 129, 3)).astype(np.float32)  # p_i = i: every position a tie
    errs.append(compare("identity 129^2->129^2 (all ties)", ties, identity, Size(129, 129), expect=on_card(ties))[0])
    imgs = rng.uniform(size=(4, INPUT, INPUT, 3)).astype(np.float32)
    off = np.tile(np.array([[0.5, 0, 5.0], [0, 0.5, 5.0]], np.float32), (4, 1, 1))
    errs.append(compare("off-image", imgs, off, out, expect=torch.zeros(4, CROP, CROP, 3, device=DEVICE))[0])
    errs.append(compare("border", imgs, BORDER_THETA, out)[0])
    errs.append(compare("h_out=1", imgs, axis_aligned_theta(rng, 4), Size(1, CROP))[0])
    errs.append(compare("w_out=1", imgs, axis_aligned_theta(rng, 4), Size(CROP, 1))[0])
    nan = axis_aligned_theta(rng, 4)
    nan[1, 1, 1] = np.nan  # NaN py everywhere in image 1: that image's crop NaN
    errs.append(compare("NaN theta", imgs, nan, out)[0])
    # consecutive output rows share input rows
    small = rng.uniform(size=(4, 64, 64, 3)).astype(np.float32)
    errs.append(compare("upsampled 64^2->200^2", small, axis_aligned_theta(rng, 4), Size(200, 200))[0])
    for c in (1, 4):  # not only the three channels of the main path
        imgs = rng.uniform(size=(4, INPUT, INPUT, c)).astype(np.float32)
        errs.append(compare(f"C={c}", imgs, axis_aligned_theta(rng, 4), out)[0])
    # the other batches of the CLI's path: served batches of 8 frames and
    # the stn pipeline's renders of RENDER_BATCH crops
    for n in (8, synthetic.RENDER_BATCH):
        imgs = rng.uniform(size=(n, INPUT, INPUT, 3)).astype(np.float32)
        errs.append(compare(f"N={n} {INPUT}^2->{CROP}^2", imgs, axis_aligned_theta(rng, n), out)[0])
    return {"max_abs_err": max(errs), "times": times}


# -- phase 2b -------------------------------------------------------------
def backward_against_plain(card: str) -> dict:
    rng = np.random.default_rng(SEED + 3)
    errs = {"bwd_theta": 0.0, "bwd_images": 0.0}

    def compare(name, images, theta, out_size, theta_defined=True):
        """``theta_defined`` false: an infinite or huge theta, whose d theta
        is not compared (only d images)."""
        images, theta = on_card(images), on_card(theta)
        shape = (images.shape[0], out_size.height, out_size.width, images.shape[3])
        g = on_card(rng.normal(size=shape).astype(np.float32))
        want_img, want_theta = stn.sample_separable_bwd(images, theta, g, out_size)
        got_theta = stn.separable_sampler_bwd_theta(images, theta, g)
        again = stn.separable_sampler_bwd_theta(images, theta, g)
        got_img = stn.separable_sampler_bwd_images(theta, g, tuple(images.shape))
        again_img = stn.separable_sampler_bwd_images(theta, g, tuple(images.shape))
        torch.cuda.synchronize()
        check(torch.equal(got_theta.view(torch.int32), again.view(torch.int32)),
              f"K1 bwd_theta {name}: two runs differ")
        check(torch.equal(got_img.view(torch.int32), again_img.view(torch.int32)),
              f"K1 bwd_images {name}: two runs differ")
        e_t = max_err(got_theta, want_theta) if theta_defined else 0.0
        e_i = max_err(got_img, want_img)
        s_t = float(want_theta.nan_to_num().abs().max())
        s_i = float(want_img.nan_to_num().abs().max())
        terms = dimages_terms(theta, out_size, images.shape[1], images.shape[2], rotated=False)
        tol_i = dimages_tol(K1_BWD_TOL, terms, s_i)
        print(f"K1 bwd {name}: " + (f"dtheta max_abs_err {e_t:.3e}, max_rel_err {e_t / max(s_t, 1e-30):.3e} "
                                    f"(tol {K1_BWD_TOL['dtheta_rel']:g} of max |dtheta| {s_t:.4g}); "
                                    if theta_defined else "dtheta not compared; ")
              + f"dimages max_abs_err {e_i:.3e}, max_rel_err {e_i / max(s_i, 1e-30):.3e} (tol {tol_i:.3g}, "
              f"up to {terms} products a pixel, max |dimages| {s_i:.4g}, NaN in {int(torch.isnan(got_img).flatten(1).all(1).sum())} images "
              f"throughout, as the plain version); both bit-identical between two runs")
        check(e_t <= K1_BWD_TOL["dtheta_rel"] * s_t, f"K1 bwd_theta {name}: {e_t} > tol")
        check(e_i <= tol_i, f"K1 bwd_images {name}: {e_i} > {tol_i}")
        errs["bwd_theta"] = max(errs["bwd_theta"], e_t)
        errs["bwd_images"] = max(errs["bwd_images"], e_i)
        return images, theta, g

    out = Size(CROP, CROP)
    times = {}
    for n in (TRAIN_BATCH, 128):
        imgs = rng.uniform(size=(n, INPUT, INPUT, 3)).astype(np.float32)
        images, theta, g = compare(f"N={n} {INPUT}^2->{CROP}^2", imgs, axis_aligned_theta(rng, n), out)
        images_nchw, g_nchw = (t.permute(0, 3, 1, 2).contiguous() for t in (images, g))
        theta_req = theta.clone().requires_grad_()
        lib_out_t = library_crop(images_nchw, theta_req, out)
        images_req = images_nchw.clone().requires_grad_()
        lib_out_i = library_crop(images_req, theta, out)
        calls = {
            "bwd_theta": (
                lambda: stn.separable_sampler_bwd_theta(images, theta, g),
                lambda: stn.sample_separable_bwd(images, theta, g, out, need_images=False),
                lambda: torch.autograd.grad(lib_out_t, theta_req, g_nchw, retain_graph=True),
            ),
            "bwd_images": (
                lambda: stn.separable_sampler_bwd_images(theta, g, tuple(images.shape)),
                lambda: stn.sample_separable_bwd(images, theta, g, out, need_theta=False),
                lambda: torch.autograd.grad(lib_out_i, images_req, g_nchw, retain_graph=True),
            ),
        }
        used = (slice(None), [0, 0, 1, 1], [0, 2, 1, 2])  # the entries the crop reads
        lib_dtheta = calls["bwd_theta"][2]()[0][used]
        plain_dtheta = calls["bwd_theta"][1]()[1][used]
        print(f"K1 bwd N={n}: library grid_sample dtheta (scales and shifts) against the plain "
              f"backward: max rel diff "
              f"{float((lib_dtheta - plain_dtheta).abs().max() / plain_dtheta.abs().max()):.2e}")
        for name, (kernel, plain, library) in calls.items():
            call_ms, plain_ms, lib_ms = cuda_ms(kernel), cuda_ms(plain), cuda_ms(library)
            bound_ms, bound_by = bound(name, images, theta, out)
            t = {"ms": call_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                 "bound_ms": bound_ms, "bound_by": bound_by}
            print(f"K1 {name} N={n}: per call (CUDA events, host launch included) kernel "
                  f"{call_ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us, library grid_sample backward "
                  f"{lib_ms * 1e3:.1f} us; bound {bound_ms * 1e3:.2f} us ({bound_by}) ({card})")
            t.update(one_kernel_device_times("K1", f"separable_sampler_{name}", kernel, n, card))
            times.setdefault(name, {})[n] = t
            print(f"K1 {name} N={n}: device time (profiler) kernel {fmt_us(t['device_ms'] * 1e3)}, "
                  f"plain {fmt_us(device_us(plain))}, library {fmt_us(device_us(library))} ({card})")

    ties = rng.uniform(size=(4, 129, 129, 3)).astype(np.float32)  # p_i = i: every position a tie
    compare("identity 129^2->129^2 (all ties)", ties,
            np.tile(np.array([[1, 0, 0], [0, 1, 0]], np.float32), (4, 1, 1)), Size(129, 129))
    imgs = rng.uniform(size=(4, INPUT, INPUT, 3)).astype(np.float32)
    compare("off-image", imgs, np.tile(np.array([[0.5, 0, 5.0], [0, 0.5, 5.0]], np.float32), (4, 1, 1)), out)
    compare("border", imgs, BORDER_THETA, out)
    compare("h_out=1", imgs, axis_aligned_theta(rng, 4), Size(1, CROP))
    compare("w_out=1", imgs, axis_aligned_theta(rng, 4), Size(CROP, 1))
    nan = axis_aligned_theta(rng, 4)
    nan[1, 1, 1] = np.nan  # NaN py everywhere in image 1: its four used entries NaN
    compare("NaN theta", imgs, nan, out)
    compare("zero scale", imgs, np.tile(np.float32(ZERO_SCALE), (4, 1, 1)), out)
    compare("flipped scale", imgs, np.tile(np.float32(FLIP), (4, 1, 1)), out)
    small = rng.uniform(size=(4, 64, 64, 3)).astype(np.float32)  # several outputs per input row
    compare("upsampled 64^2->200^2", small, axis_aligned_theta(rng, 4), Size(200, 200))
    # 800 output columns over a 64-pixel row: the g window of an output row
    # that reaches it (2,400 floats) is wider than the kernel stages in
    # shared memory (kDimgGRow), so the column sums read g from global memory
    wide = np.tile(np.float32([[0.5, 0, 0.05], [0, 0.5, -0.05]]), (4, 1, 1))
    compare("upsampled 64^2->16x800 (g window past the stage)", small, wide, Size(16, 800))
    for what, rows, size in (("infinite theta00, w_out=65", INF_THETA, Size(CROP, 65)),
                             ("huge theta00 1e30", HUGE_THETA, out)):
        theta = axis_aligned_theta(rng, 4)
        theta[1] = rows
        compare(what, imgs, theta, size, theta_defined=False)
    return {"max_abs_err": errs, "times": times}


# -- phase 7 --------------------------------------------------------------
def rotated_bound(kernel: str, images: torch.Tensor, theta: torch.Tensor, out_size: Size) -> tuple[float, str]:
    """``bound`` for the rotated crop (K2): the region read is the union
    of this run's live 4-tap sets (a tap is live where its hat weight is
    non-zero; hat' is non-zero only there), not a rows x columns product.
    Operations per live tap and channel: a multiply and an add in its row,
    and the row's weight (forward); hat and hat' products and their sums,
    and g's (d theta); two products and the add (d images)."""
    n, h, w, c = images.shape
    px, py = stn._rotated_positions(theta, out_size, h, w)
    xs, ys = stn._axis_taps(px, w), stn._axis_taps(py, h)
    touched = torch.zeros(n * h * w, dtype=torch.bool, device=images.device)
    base = torch.arange(n, device=images.device)[:, None, None] * (h * w)
    taps = 0.0
    for ty in ys:
        for tx in xs:
            live = (ty.hat != 0) & (tx.hat != 0)
            touched[(base + ty.index * w + tx.index)[live]] = True
            taps += float(live.sum())
    region = float(touched.sum()) * c * 4
    pixels = n * out_size.height * out_size.width
    crop_bytes, theta_bytes = pixels * c * 4, n * 24
    if kernel == "fwd":  # read the region, write the crop
        nbytes, flops = region + crop_bytes + theta_bytes, 4 * taps * c
    elif kernel == "bwd_theta":  # read the region and g, write d theta
        nbytes, flops = region + crop_bytes + 2 * theta_bytes, 8 * taps * c + 4 * pixels * c + 12 * pixels
    else:  # read g, write all of d images
        nbytes, flops = crop_bytes + n * h * w * c * 4 + theta_bytes, 3 * taps * c
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def rotated_theta(rng, n):
    theta = axis_aligned_theta(rng, n)
    theta[:, 0, 1] = rng.uniform(-0.3, 0.3, n)
    theta[:, 1, 0] = rng.uniform(-0.3, 0.3, n)
    return theta


def rotated_against_plain(card: str) -> dict:
    """K2's forward, d theta and d images against ``sample_rotated`` and
    ``sample_rotated_bwd`` on the card."""
    rng = np.random.default_rng(SEED + 7)
    errs = {"fwd": 0.0, "bwd_theta": 0.0, "bwd_images": 0.0}

    def compare(name, images, theta, out_size, ties=False, theta_defined=True):
        """``theta_defined`` as in phase 2b."""
        images, theta = on_card(images), on_card(theta)
        shape = (images.shape[0], out_size.height, out_size.width, images.shape[3])
        g = on_card(rng.normal(size=shape).astype(np.float32))
        got = sample_rotated_kernel(images, theta, out_size)
        want = stn.sample_rotated(images, theta, out_size)
        want_img, want_theta = stn.sample_rotated_bwd(images, theta, g, out_size)
        got_theta = stn.rotated_sampler_bwd_theta(images, theta, g)
        again = stn.rotated_sampler_bwd_theta(images, theta, g)
        got_img = stn.rotated_sampler_bwd_images(theta, g, tuple(images.shape))
        again_img = stn.rotated_sampler_bwd_images(theta, g, tuple(images.shape))
        torch.cuda.synchronize()
        check(torch.equal(got_theta.view(torch.int32), again.view(torch.int32)),
              f"K2 bwd_theta {name}: two runs differ")
        check(torch.equal(got_img.view(torch.int32), again_img.view(torch.int32)),
              f"K2 bwd_images {name}: two runs differ")
        e_f, e_i = max_err(got, want), max_err(got_img, want_img)
        e_t = max_err(got_theta, want_theta) if theta_defined else 0.0
        s_t = float(want_theta.nan_to_num().abs().max())
        s_i = float(want_img.nan_to_num().abs().max())
        terms = dimages_terms(theta, out_size, images.shape[1], images.shape[2], rotated=True)
        tol_i = dimages_tol(K2_TOL, terms, s_i)
        print(f"K2 {name}: fwd max_abs_err {e_f:.3e} (bit-identical: {bit_identical(got, want)}); "
              + (f"dtheta max_abs_err {e_t:.3e}, max_rel_err {e_t / max(s_t, 1e-30):.3e} (tol "
                 f"{K2_TOL['dtheta_rel']:g} of max |dtheta| {s_t:.4g}); " if theta_defined else "dtheta not compared; ")
              + f"dimages max_abs_err {e_i:.3e} (tol {tol_i:.3g}, up to {terms} products a pixel, "
              f"max |dimages| {s_i:.4g}, NaN in "
              f"{int(torch.isnan(got_img).flatten(1).all(1).sum())} images throughout, as the plain version); "
              "d theta and d images bit-identical between two runs")
        check(bit_identical(got, want), f"K2 fwd {name}: not bit-identical to the plain version (max abs err {e_f})")
        check(e_t <= K2_TOL["dtheta_rel"] * s_t, f"K2 bwd_theta {name}: {e_t} > tol")
        check(e_i <= tol_i, f"K2 bwd_images {name}: {e_i} > {tol_i}")
        if ties:  # every position on a pixel: the dense VJP's rule moves nothing
            check(not got_theta.any() and not want_theta.any(), f"K2 {name}: d theta not exactly 0")
            print(f"K2 {name}: d theta exactly 0 in the kernel and the plain version")
        for k, e in (("fwd", e_f), ("bwd_theta", e_t), ("bwd_images", e_i)):
            errs[k] = max(errs[k], e)
        return images, theta, g

    out = Size(CROP, CROP)
    times = {}
    for n in (BATCH, TRAIN_BATCH, 128):
        imgs = rng.uniform(size=(n, INPUT, INPUT, 3)).astype(np.float32)
        images, theta, g = compare(f"N={n} {INPUT}^2->{CROP}^2", imgs, rotated_theta(rng, n), out)
        if n == BATCH:
            continue
        images_nchw, g_nchw = (t.permute(0, 3, 1, 2).contiguous() for t in (images, g))
        theta_req = theta.clone().requires_grad_()
        lib_out_t = library_crop(images_nchw, theta_req, out)
        images_req = images_nchw.clone().requires_grad_()
        lib_out_i = library_crop(images_req, theta, out)
        lib_err = float((library_crop(images_nchw, theta, out).permute(0, 2, 3, 1)
                         - sample_rotated_kernel(images, theta, out)).abs().max())
        lib_dtheta = torch.autograd.grad(lib_out_t, theta_req, g_nchw, retain_graph=True)[0]
        plain_dtheta = stn.sample_rotated_bwd(images, theta, g, out, need_images=False)[1]
        print(f"K2 N={n}: library grid_sample against the kernel: crop max abs diff {lib_err:.2e}, "
              f"dtheta max rel diff {float((lib_dtheta - plain_dtheta).abs().max() / plain_dtheta.abs().max()):.2e}")
        calls = {
            "fwd": (
                lambda: sample_rotated_kernel(images, theta, out),
                lambda: stn.sample_rotated(images, theta, out),
                lambda: library_crop(images_nchw, theta, out),
            ),
            "bwd_theta": (
                lambda: stn.rotated_sampler_bwd_theta(images, theta, g),
                lambda: stn.sample_rotated_bwd(images, theta, g, out, need_images=False),
                lambda: torch.autograd.grad(lib_out_t, theta_req, g_nchw, retain_graph=True),
            ),
            "bwd_images": (
                lambda: stn.rotated_sampler_bwd_images(theta, g, tuple(images.shape)),
                lambda: stn.sample_rotated_bwd(images, theta, g, out, need_theta=False),
                lambda: torch.autograd.grad(lib_out_i, images_req, g_nchw, retain_graph=True),
            ),
        }
        for name, (kernel, plain, library) in calls.items():
            call_ms, plain_ms, lib_ms = cuda_ms(kernel), cuda_ms(plain), cuda_ms(library)
            bound_ms, bound_by = rotated_bound(name, images, theta, out)
            t = {"ms": call_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                 "bound_ms": bound_ms, "bound_by": bound_by}
            print(f"K2 {name} N={n}: per call (CUDA events, host launch included) kernel "
                  f"{call_ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us, library grid_sample "
                  f"{lib_ms * 1e3:.1f} us; bound {bound_ms * 1e3:.2f} us ({bound_by}) ({card})")
            t.update(one_kernel_device_times("K2", f"rotated_sampler_{name}", kernel, n, card))
            times.setdefault(name, {})[n] = t
            print(f"K2 {name} N={n}: device time (profiler) kernel {fmt_us(t['device_ms'] * 1e3)}, "
                  f"plain {fmt_us(device_us(plain))}, library {fmt_us(device_us(library))} ({card})")

    ties = rng.uniform(size=(4, 129, 129, 3)).astype(np.float32)  # p = pixel: every position a tie
    compare("identity 129^2->129^2 (all ties)", ties,
            np.tile(np.array([[1, 0, 0], [0, 1, 0]], np.float32), (4, 1, 1)), Size(129, 129), ties=True)
    imgs = rng.uniform(size=(4, INPUT, INPUT, 3)).astype(np.float32)
    border = BORDER_THETA.copy()
    border[:, 0, 1], border[:, 1, 0] = [0.2, -0.25, 0.3, 0.1], [0.15, 0.2, -0.3, -0.1]
    compare("border", imgs, border, out)
    compare("off-image", imgs, np.tile(np.array([[0.5, 0.1, 5.0], [0.1, 0.5, 5.0]], np.float32), (4, 1, 1)), out)
    compare("h_out=1", imgs, rotated_theta(rng, 4), Size(1, CROP))
    compare("w_out=1", imgs, rotated_theta(rng, 4), Size(CROP, 1))
    nan = rotated_theta(rng, 4)
    nan[1, 0, 1], nan[2, 1, 1] = np.nan, np.nan  # NaN px everywhere in image 1, NaN py in image 2
    compare("NaN theta", imgs, nan, out)
    small = rng.uniform(size=(4, 64, 64, 3)).astype(np.float32)  # neighbouring pixels share taps
    compare("upsampled 64^2->200^2", small, rotated_theta(rng, 4), Size(200, 200))
    imgs = rng.uniform(size=(4, INPUT, INPUT, 4)).astype(np.float32)  # the generic-C instance
    compare("C=4", imgs, rotated_theta(rng, 4), out)
    # singular and degenerate maps: d images takes every output as a
    # candidate of each tile there and scans those with a tap on it
    imgs = rng.uniform(size=(4, INPUT, INPUT, 3)).astype(np.float32)
    compare("zero scale", imgs, np.tile(np.float32(ZERO_SCALE), (4, 1, 1)), out)
    compare("flipped scale", imgs, np.tile(np.float32(FLIP), (4, 1, 1)), out)
    compare("rank-1 theta", imgs, np.tile(np.float32([[0.6, 0.3, 0.1], [0.4, 0.2, -0.1]]), (4, 1, 1)), out)
    compare("near-singular theta", imgs, np.tile(np.float32([[0.6, 0.3, 0.1], [0.4, 0.2001, -0.1]]), (4, 1, 1)),
            out)
    for what, rows, size in (("infinite theta00, w_out=65", INF_THETA, Size(CROP, 65)),
                             ("huge theta00 1e30", HUGE_THETA, out)):
        theta = rotated_theta(rng, 4)
        theta[1] = rows
        compare(what, imgs, theta, size, theta_defined=False)
    return {"max_abs_err": errs, "times": times}


# -- phase 3 --------------------------------------------------------------
def write_log_dir(log_dir: str, calib: np.ndarray) -> None:
    """Seeded port models as ``.pt`` snapshots. BatchNorm statistics are
    taken from one batch of scenes (random weights with unit statistics
    give activations far from unit scale), and the head is drawn so that
    theta is [0.8, 0, 0, 0, 0.8, 0] plus per-image offsets of about 0.15
    on that batch (the reference's zero head gives every frame the same
    crop)."""
    checkpoint.save_manifest(log_dir, MANIFEST)
    torch.manual_seed(SEED)
    loc = build_model("Localizer", **MANIFEST["localizer"]["kwargs"]).to(DEVICE)
    ass = build_assessor(MANIFEST["assessor"], loc)
    x = torch.from_numpy(calib).to(DEVICE)
    bns = [m for m in loc.modules() if isinstance(m, nn.BatchNorm2d)]
    with torch.no_grad():
        for bn in bns:
            bn.momentum = 1.0  # running statistics = this batch's
        loc.train().features(x)
        for bn in bns:
            bn.momentum = 0.1
        feats = loc.eval().features(x).mean(dim=(2, 3))
        mu, sd = feats.mean(0), feats.std(0).mean()
        gen = torch.Generator(device=DEVICE).manual_seed(SEED)
        w = torch.randn(6, feats.shape[1], generator=gen, device=DEVICE)
        w *= 0.15 / (feats.shape[1] ** 0.5 * sd)
        loc.param_predictor.weight.copy_(w)
        loc.param_predictor.bias.copy_(torch.tensor([0.8, 0, 0, 0, 0.8, 0], device=DEVICE) - w @ mu)
    checkpoint.save_params(f"{log_dir}/Localizer_1.pt", loc.state_dict())
    checkpoint.save_params(f"{log_dir}/ResnetAssessor_1.pt", ass.state_dict())


def serve(inf: LocalizerInference, frames: np.ndarray, card: str) -> dict:
    inf.localize_batch(frames[:BATCH])  # warm-up: cuDNN and allocator
    torch.cuda.synchronize()
    reset_launches()
    n_forward = 0
    for frame in frames[:2]:
        boxes, rois, scores, _ = inf.localize(frame)
        n_forward += 1
        check(boxes.shape == (1, 4) and rois.shape == (1, CROP, CROP, 3)
              and scores.shape == (1,), "localize shapes")
        check(np.isfinite(boxes).all() and np.isfinite(rois).all(), "localize finite")
    rates, kept_boxes = [], []
    for b in range(3):
        batch = frames[2 + b * BATCH : 2 + (b + 1) * BATCH]
        start = time.perf_counter()
        raw = inf.localize_batch(batch, sync=False)
        boxes, rois, scores, _ = inf.finish_batch(raw)
        rates.append(BATCH / (time.perf_counter() - start))
        n_forward += 1
        raw_scores = raw[2].cpu().numpy()
        check(boxes.shape == (BATCH, 1, 4) and rois.shape == (BATCH, CROP, CROP, 3)
              and scores.shape == (BATCH,), "localize_batch shapes")
        check(np.isfinite(boxes).all() and np.isfinite(rois).all(), "localize_batch finite")
        check(((raw_scores > 0) & (raw_scores < 1)).all(), "scores in (0, 1)")
        gated = raw_scores < inf.score_threshold
        check(np.array_equal(scores == 0, gated) and (boxes[gated] == 0).all(), "gating")
        kept_boxes.append(boxes[~gated, 0])
    launches = read_launches()
    check(launches == {"K1": {**NO_LAUNCHES, "fwd": n_forward}, "K2": NO_LAUNCHES},
          f"serving launched {launches} for {n_forward} forwards")
    launches = launches["K1"]
    profile_batch(inf, frames[2 : 2 + BATCH], card)
    spread = float(np.concatenate(kept_boxes)[:, 3].std())
    print(f"slice: {n_forward} forwards (2 x localize, 3 x localize_batch({BATCH})), "
          f"K1 launches {launches['fwd']}, x_max spread {spread:.1f} px")
    print(f"slice: localize_batch({BATCH}) images/s "
          f"{statistics.median(rates):.1f} (median; runs {', '.join(f'{r:.1f}' for r in rates)}) "
          f"({card})")
    return {"launches": launches["fwd"], "images_per_s": statistics.median(rates)}


def print_trace(prof, what: str, wall_ms: float, card: str, top: int = 8) -> None:
    events = device_events(prof)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    print(f"trace: {what} wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms, "
          f"idle share {max(0.0, 1 - busy_ms / wall_ms):.3f} ({card})")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"trace:   {e.self_device_time_total / 1e3:8.3f} ms x{e.count:<5d} {e.key[:90]}")


def profile_batch(inf: LocalizerInference, batch: np.ndarray, card: str) -> None:
    """One traced ``localize_batch``: wall time, device busy time, the
    device time of the largest kernels and copies, and K1's forward's
    device time per launch, by name."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        start = time.perf_counter()
        inf.localize_batch(batch)
        wall_ms = (time.perf_counter() - start) * 1e3
    print_trace(prof, f"localize_batch({len(batch)})", wall_ms, card)
    fwd = [e for e in device_events(prof) if "separable_sampler_fwd_kernel" in e.key]
    launches = sum(e.count for e in fwd)
    us = sum(e.self_device_time_total for e in fwd) / launches if launches else None
    print(f"trace: in the traced localize_batch({len(batch)}), separable_sampler_fwd {fmt_us(us)} "
          f"device time per launch ({launches} launches) ({card})")


# -- phase 4 --------------------------------------------------------------
def card_against_cpu(log_dir: str, inf: LocalizerInference, frames: np.ndarray) -> dict:
    cpu = LocalizerInference(log_dir, device="cpu", use_assessor=True, score_threshold=0.0)
    inf.score_threshold = 0.0
    two = frames[:2]
    with torch.inference_mode():
        rois_g, theta_g = inf.localizer(torch.from_numpy(two).to(DEVICE))
        rois_c, theta_c = cpu.localizer(torch.from_numpy(two))
        rois_at_card_theta = sample_separable(torch.from_numpy(two), theta_g.cpu(), Size(CROP, CROP))
    bg, _, sg, _ = inf.localize_batch(two)
    bc, _, sc, _ = cpu.localize_batch(two)
    errs = {
        "theta": float((theta_g.cpu() - theta_c).abs().max()),
        "boxes_px": float(np.abs(bg - bc).max()),
        "rois_at_card_theta": float((rois_g.cpu() - rois_at_card_theta).abs().max()),
        "scores": float(np.abs(sg - sc).max()),
    }
    tol = dict(SLICE_TOL, rois_end_to_end=1e-5 + 2 * errs["theta"] * (INPUT - 1))
    errs["rois_end_to_end"] = float((rois_g.cpu() - rois_c).abs().max())
    print("card vs CPU: " + ", ".join(
        f"{k} {v:.3e} (tol {tol[k]:.3g})" for k, v in errs.items()))
    for k, v in errs.items():
        check(v <= tol[k], f"card vs CPU {k}: {v} > {tol[k]}")
    return errs


# -- phases 5 and 8 ---------------------------------------------------------
def training_pools() -> dict:
    """The pools ``bench.py`` trains on: uint8 scenes and crops, uniform
    IoU labels (seed 0)."""
    gen = np.random.default_rng(SEED)
    return {
        "unlabeled": {"unlabeled": gen.integers(0, 256, (POOL_SCENES, INPUT, INPUT, 3), dtype=np.uint8)},
        "reference": {
            "real": gen.integers(0, 256, (POOL_CROPS, CROP, CROP, 3), dtype=np.uint8),
            "labels": gen.uniform(size=(POOL_CROPS, 1)).astype(np.float32),
        },
    }


def build_pair(device, manifest: dict = MANIFEST) -> tuple[nn.Module, nn.Module]:
    loc = build_model("Localizer", **manifest["localizer"]["kwargs"])
    return loc.to(device), build_assessor(manifest["assessor"], loc).to(device)


def train_slice(pools: dict, card: str, manifest: dict = MANIFEST, log_dir: str | None = None) -> dict:
    """``Trainer`` over ``pooled_step`` with ``manifest``'s models; checks
    that the crop's kernels (K2 at a non-zero rotation ratio, else K1)
    carried every step and the other crop's never ran, then serves the last
    snapshot on the card. The log dir is kept at ``log_dir`` when one is
    given."""
    rotated = manifest["localizer"]["kwargs"]["rotation_dropout_ratio"] > 0
    used, unused = ("K2", "K1") if rotated else ("K1", "K2")
    tag = "train rotated" if rotated else "train"
    torch.manual_seed(SEED)
    loc, ass = build_pair(DEVICE, manifest)
    loc_state, ass_state = create_train_state(loc, LR), create_train_state(ass, LR)
    head0 = loc.param_predictor.bias.detach().clone()
    ass0 = ass.Dense_0.weight.detach().clone()
    config = AlternatingConfig(image_size=Size(INPUT, INPUT))
    step_fn = functools.partial(pooled_step, steps_per_call=STEPS_PER_CALL, config=config)
    chunks = device_chunk_batches(pools, TRAIN_BATCH, STEPS_PER_CALL, seed=SEED, device=DEVICE)
    n_steps = STEPS_PER_CALL * (1 + TIMED_CHUNKS)
    nbytes = sum(t.numel() * t.element_size() for g in next(chunks)["pools"].values() for t in g.values())
    print(f"{tag}: pools on the card {nbytes / 2**20:.1f} MiB ({POOL_SCENES} scenes, {POOL_CROPS} crops, uint8); "
          f"localizer {manifest['localizer']['kwargs']}")
    generator = torch.Generator(device=DEVICE).manual_seed(SEED)
    with contextlib.nullcontext(log_dir) if log_dir else tempfile.TemporaryDirectory() as log_dir:
        checkpoint.save_manifest(log_dir, manifest)
        trainer = Trainer(
            step_fn, loc_state, ass_state, chunks, log_dir, max_iterations=n_steps, generator=generator,
            config={"batch_size": TRAIN_BATCH, "steps_per_call": STEPS_PER_CALL, "device": card},
            log_interval=STEPS_PER_CALL, steps_per_call=STEPS_PER_CALL, print_report=False,
        )
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        start = time.perf_counter()
        loc_state, ass_state = trainer.run()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - start
        launches = read_launches()
        check(launches == {used: {"fwd": n_steps, "bwd_theta": n_steps, "bwd_images": 0}, unused: NO_LAUNCHES},
              f"training launched {launches} for {n_steps} steps")
        log = MetricsLog.read(log_dir)
        check(len(log) == 1 + TIMED_CHUNKS, f"{len(log)} log entries")
        for e in log:
            check(np.isfinite(e["loss_localizer"]) and np.isfinite(e["loss_dis"]), f"losses finite: {e}")
        bias = loc.param_predictor.bias.detach()
        check(not torch.equal(bias, head0), "the head's bias moved")
        check(not torch.equal(ass.Dense_0.weight, ass0), "the assessor's head weight moved")
        # theta01 and theta10: only the rotated crop's d theta reaches them
        # (rotation dropout at ratio 0 zeroes them with a constant mask)
        off_diagonal = bias[[1, 3]]
        check(bool((off_diagonal != 0).all()) if rotated else not off_diagonal.any(),
              f"the head's off-diagonal bias {off_diagonal.tolist()} after training")
        rates = [e["images_per_sec"] for e in log[1:]]
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        for e in log:
            print(f"{tag}: iteration {e['iteration']} loss_localizer {e['loss_localizer']:.5f} "
                  f"loss_dis {e['loss_dis']:.5f} y_fake_mean {e['y_fake_mean']:.4f} "
                  f"y_real_mean {e['y_real_mean']:.4f} images/s {e['images_per_sec']:.1f}")
        print(f"{tag}: {n_steps} steps ({1 + TIMED_CHUNKS} chunks of {STEPS_PER_CALL}, batch {TRAIN_BATCH}) "
              f"in {wall_s:.2f} s; {used} launches {launches[used]}, {unused} launches {launches[unused]}; "
              f"peak memory {peak_gib:.2f} GiB; head off-diagonal bias {off_diagonal.tolist()}")
        print(f"{tag}: images/s at batch {TRAIN_BATCH}, timed chunks: "
              f"{', '.join(f'{r:.1f}' for r in rates)} (median {statistics.median(rates):.1f}) ({card})")
        in_situ = profile_chunk(loc_state, ass_state, next(chunks), step_fn, generator, card)
        for kernel in (f"{LIBRARIES[used]}_fwd", f"{LIBRARIES[used]}_bwd_theta"):
            us, count = in_situ.get(kernel, (None, 0))
            print(f"{tag}: in the traced chunk, {kernel} {fmt_us(us)} device time per launch "
                  f"({count} launches) ({card})")
        check(not {k for k in in_situ if not k.startswith(LIBRARIES[used])},
              f"{tag}: the traced chunk ran {sorted(in_situ)}")

        inf = LocalizerInference(log_dir, device=DEVICE, use_assessor=True)
        last = checkpoint.list_snapshots(log_dir, "Localizer_")[-1][0]
        check(last == n_steps, f"the last snapshot is Localizer_{last}.pt")
        frames = pools["unlabeled"]["unlabeled"][:8].astype(np.float32) / 255.0
        before = read_launches()[used]["fwd"]
        boxes, rois, scores, _ = inf.localize_batch(frames)
        served = read_launches()[used]["fwd"] - before
        check(served == 1, f"serving one batch launched the {used} forward {served} times")
        check(boxes.shape == (8, 1, 4) and rois.shape == (8, CROP, CROP, 3) and scores.shape == (8,),
              "trained snapshot: serving shapes")
        check(np.isfinite(boxes).all() and np.isfinite(rois).all() and np.isfinite(scores).all(),
              "trained snapshot: serving finite")
        print(f"{tag}: served Localizer_{n_steps}.pt through LocalizerInference on {DEVICE} "
              f"(sampler {inf.localizer.sampler_method(torch.from_numpy(frames).to(DEVICE))}, "
              f"{used} forward launches +{served}): 8 frames, mean score {float(np.mean(scores)):.4f}")
    return {"launches": launches[used], "images_per_s": statistics.median(rates),
            "device_in_situ_ms": {k: ms(us) for k, (us, _) in in_situ.items()}}


def profile_chunk(loc_state, ass_state, chunk, step_fn, generator, card: str) -> dict[str, tuple[float, int]]:
    """One traced chunk of ``STEPS_PER_CALL`` steps (after the counted run).
    Returns the crop kernels' device time per launch in µs and their
    launches there, by entry point (``<library>_fwd``, ...)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        start = time.perf_counter()
        _, _, metrics = step_fn(loc_state, ass_state, chunk, generator)
        float(metrics["loss_localizer"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    print_trace(prof, f"pooled_step({STEPS_PER_CALL} x batch {TRAIN_BATCH})", wall_ms, card, top=12)
    entries = [f"{library}_{kind}" for library in LIBRARIES.values() for kind in COUNTERS]
    return {entry: (e.self_device_time_total / e.count, e.count)
            for e in device_events(prof) for entry in entries if f"{entry}_kernel" in e.key}


# -- phases 6 and 9 ---------------------------------------------------------
def step_against_cpu(pools: dict, manifest: dict = MANIFEST, samplers: dict | None = None) -> dict:
    """Two alternating steps on the card and on the CPU from the same
    weights and batches (batch 4). Step 1's backbone gradient is exactly 0
    behind the zero-initialised head, so step 2 is compared too.
    ``samplers`` names each device's crop where the two differ; then d
    theta's off-diagonal entries are held on their own too."""
    tag = "train card vs CPU" if samplers is None else "train rotated card vs CPU"
    torch.manual_seed(SEED + 4)
    models = {"cpu": build_pair("cpu", manifest)}
    models[DEVICE] = tuple(copy.deepcopy(m).to(DEVICE) for m in models["cpu"])
    for device, sampler in (samplers or {}).items():
        models[device][0].sampler = sampler
    rng = np.random.default_rng(SEED + 5)
    batches = []
    for _ in range(2):
        si = rng.choice(POOL_SCENES, 4, replace=False)
        ci = rng.choice(POOL_CROPS, 4, replace=False)
        batches.append({"unlabeled": pools["unlabeled"]["unlabeled"][si],
                        "real": pools["reference"]["real"][ci],
                        "labels": pools["reference"]["labels"][ci]})
    config = AlternatingConfig(image_size=Size(INPUT, INPUT))
    out = {}
    for device, (loc, ass) in models.items():
        dthetas, rois_grads = [], []

        def capture(module, inputs, output, dthetas=dthetas, rois_grads=rois_grads):
            output[0].register_hook(lambda g: rois_grads.append(g.detach().cpu()))
            output[1].register_hook(lambda g: dthetas.append(g.detach().cpu()))

        hook = loc.register_forward_hook(capture)
        states = (create_train_state(loc, LR), create_train_state(ass, LR))
        metrics = []
        for batch in batches:
            *states, m = alternating_step(*states, {k: torch.from_numpy(v).to(device) for k, v in batch.items()},
                                          None, config)
            metrics.append({k: float(v) for k, v in m.items()})
        hook.remove()
        out[device] = {
            "metrics": metrics, "dtheta": dthetas, "rois_grad": rois_grads,
            "head_grad": loc.param_predictor.weight.grad.detach().cpu(),
            "stem_grad": loc.feature_extractor.Conv_0.weight.grad.detach().cpu(),
            "stats": {k: v.detach().cpu() for k, v in loc.state_dict().items() if "running" in k},
        }
    cpu, card = out["cpu"], out[DEVICE]

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))

    off_diagonal = (slice(None), [0, 1], [1, 0])
    diffs = {}
    for s in range(2):
        for k in ("loss_localizer", "loss_dis"):
            diffs[f"step{s + 1} {k}"] = ("loss", abs(card["metrics"][s][k] - cpu["metrics"][s][k])
                                         / max(abs(cpu["metrics"][s][k]), 1e-30))
        diffs[f"step{s + 1} dtheta"] = ("dtheta", rel(card["dtheta"][s], cpu["dtheta"][s]))
        if samplers is not None:
            diffs[f"step{s + 1} dtheta off-diagonals"] = (
                "dtheta", rel(card["dtheta"][s][off_diagonal], cpu["dtheta"][s][off_diagonal]))
    diffs["step2 head grad"] = ("head_grad", rel(card["head_grad"], cpu["head_grad"]))
    diffs["step2 stem conv grad"] = ("stem_grad", rel(card["stem_grad"], cpu["stem_grad"]))
    diffs["step2 BN running stats"] = ("bn_stats", max(rel(card["stats"][k], v) for k, v in cpu["stats"].items()))
    print(f"{tag} (relative): " + ", ".join(
        f"{name} {v:.3e} (tol {STEP_TOL[kind]:g})" for name, (kind, v) in diffs.items()))
    print(f"{tag}, crops' cotangent (not held, see STEP_TOL): " + ", ".join(
        f"step{s + 1} max {rel(card['rois_grad'][s], cpu['rois_grad'][s]):.3e}, L2 "
        f"{float((card['rois_grad'][s] - cpu['rois_grad'][s]).norm() / cpu['rois_grad'][s].norm()):.3e}"
        for s in range(2)))
    for name, (kind, v) in diffs.items():
        check(v <= STEP_TOL[kind], f"{tag} {name}: {v} > {STEP_TOL[kind]}")
    check(float(cpu["dtheta"][0].abs().max()) > 0, "theta gets a gradient")
    if samplers is not None:
        check(float(cpu["dtheta"][0][off_diagonal].abs().max()) > 0, "theta's off-diagonals get a gradient")
    return {name: v for name, (_, v) in diffs.items()}


# -- phases 10 and 11 ---------------------------------------------------------
def cli_run(tag: str, argv: list[str], card: str, log_root: str | None = None) -> dict:
    """``train_localizer.main(argv)`` in this process with every launch
    count at 0; checks the log, the launches of each kind, and serves the
    log dir. Returns the launches, the log, the accounting and the log dir,
    which is kept under ``log_root`` when one is given."""
    args = train_localizer.get_parser().parse_args(argv)
    iterations = args.iterations
    with contextlib.nullcontext(log_root) if log_root else tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        reset_launches()
        synthetic.render_stn_crops.batches = 0
        device_chunk_batches.swaps = 0
        start = time.perf_counter()
        log_dir = train_localizer.main(argv + ["--log-dir", tmp])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - start
        launches = read_launches()
        renders, swaps = synthetic.render_stn_crops.batches, device_chunk_batches.swaps
        log = MetricsLog.read(log_dir)
        check(len(log) == iterations // args.log_interval, f"{tag}: {len(log)} log entries")
        losses = ["loss_localizer"] + ([] if args.supervised else ["loss_dis"])
        for e in log:
            check(all(np.isfinite(e[k]) for k in losses + ["mean_iou", "map"]), f"{tag}: finite: {e}")
        n_val = train_localizer._synthetic_n(args.val_file, 64)
        n_val_batches = min(args.eval_batches, n_val // max(args.batch_size // 2, 1))
        evals = len(log) * n_val_batches
        steps = 0 if args.supervised else iterations  # supervised steps do not crop
        check(launches["K1"]["fwd"] == steps + evals + renders,
              f"{tag}: K1 forward launches {launches['K1']['fwd']} != {steps} steps + {evals} eval "
              f"forwards + {renders} render batches")
        check(launches["K1"]["bwd_theta"] == steps and launches["K1"]["bwd_images"] == 0,
              f"{tag}: K1 launches {launches['K1']} for {steps} alternating steps")
        check(launches["K2"] == NO_LAUNCHES, f"{tag}: K2 launches {launches['K2']}")
        snaps = sorted(os.listdir(log_dir))
        written = list(range(args.snapshot_interval, iterations + 1, args.snapshot_interval))
        want = {"manifest.json", "log"} | {f"Localizer_{i}.pt" for i in written}
        if not args.supervised:
            want |= {f"ResnetAssessor_{i}.pt" for i in written}
        check(want <= set(snaps), f"{tag}: the log dir holds {snaps}")
        # a snapshot is written after the log entry of its iteration, so the
        # next entry's interval holds the write (the last one follows the run)
        with_writes = [e["iteration"] for e in log if e["iteration"] - args.log_interval in written]
        for e in log:
            print(f"{tag}: iteration {int(e['iteration'])} images_per_sec {e['images_per_sec']:.1f} "
                  + " ".join(f"{k} {e[k]:.5f}" for k in losses + ["mean_iou", "map"]))
        print(f"{tag}: {iterations} iterations in {wall_s:.2f} s of wall time (data generation included); "
              f"K1 launches {launches['K1']}: forward = {steps} steps + {evals} eval forwards "
              f"+ {renders} render batches of {synthetic.RENDER_BATCH}; pool swaps {swaps}; log dir {snaps}")
        print(f"{tag}: snapshots at iterations {written}; the log entries at iterations "
              f"{[int(i) for i in with_writes]} include a snapshot write in their interval")
        served = serve_cli_log_dir(tag, log_dir, args)
    rates = [e["images_per_sec"] for e in log[1:] or log]
    return {"launches": launches["K1"], "swaps": swaps, "log": log, "served": served,
            "images_per_s": statistics.median(rates), "log_dir": log_dir}


def render_against_plain(argv: list[str]) -> None:
    """The CLI's own reference pool of ``--assessor-pipeline stn`` (its
    scenes and boxes: the same seed, size and asset world) rendered by
    ``render_stn_crops`` on the card, K1's forward in batches of
    ``RENDER_BATCH``, against the plain sampler on the same card tensors:
    the float crops at K1_TOL, the uint8 crops within RENDER_TOL. Before
    the counted run, so these launches are not the path's."""
    args = train_localizer.get_parser().parse_args(argv)
    img, crop = tuple(args.target_size), tuple(args.crop_size)
    n = train_localizer._synthetic_n(args.reference_file, 1024)
    triples = synthetic.assessor_triples(
        n, output_size=crop, image_size=img, seed=args.seed + 1,
        low_iou_fraction=args.assessor_low_iou, **train_localizer.build_asset_kw(args))
    got = np.stack(synthetic.render_stn_crops(triples, crop, device=DEVICE)).astype(np.int16)
    want, err = [], 0.0
    for start in range(0, n, synthetic.RENDER_BATCH):  # the renders' batches, unpadded
        part = triples[start : start + synthetic.RENDER_BATCH]
        scenes = torch.from_numpy(np.stack([t[0] for t in part])).to(DEVICE).float() / 255.0
        size = Size(*part[0][0].shape[:2])
        theta = box_to_theta(torch.from_numpy(np.stack([t[1] for t in part])).to(DEVICE), size)
        plain = sample_separable(scenes, theta, Size(*crop))
        err = max(err, max_err(sample_separable_kernel(scenes, theta, Size(*crop)), plain))
        want.append(torch.clip(torch.round(plain * 255.0), 0, 255).to(torch.uint8).cpu().numpy())
    diff = np.abs(got - np.concatenate(want).astype(np.int16))
    share = float((diff > 0).mean())
    check(err <= K1_TOL, f"cli renders: K1 against the plain sampler max abs err {err} > {K1_TOL}")
    check(int(diff.max()) <= RENDER_TOL["steps"] and share <= RENDER_TOL["share"],
          f"cli renders: uint8 crops differ by up to {int(diff.max())} on {share:.2e} of the pixels")
    print(f"cli renders: the CLI's {n} stn crops ({img[0]}^2->{crop[0]}^2, batches of "
          f"{synthetic.RENDER_BATCH}) through render_stn_crops (K1) against the plain sampler on the "
          f"same card tensors: floats max abs err {err:.3e} (tol {K1_TOL}), uint8 max diff "
          f"{int(diff.max())} on {share:.2e} of the pixels (tol {RENDER_TOL['steps']} step on "
          f"{RENDER_TOL['share']:g})")


def serve_cli_log_dir(tag: str, log_dir: str, args) -> float:
    """Serve the CLI's last snapshot through ``LocalizerInference`` on the
    card and hold its boxes against the CLI's own eval step
    (``make_eval_step``) on the same snapshot and val frames."""
    val = synthetic.SyntheticLocalizerDataset(
        8, image_size=tuple(args.target_size), seed=args.seed + 2, labeled=True, output_dtype="uint8",
        **train_localizer.build_asset_kw(args))
    frames = np.stack([val.items[i][0] for i in range(len(val))])
    inf = LocalizerInference(log_dir, device=DEVICE, use_assessor=True, score_threshold=0.0)
    boxes, rois, scores, _ = inf.localize_batch(frames.astype(np.float32) / 255.0)
    manifest = checkpoint.load_manifest(log_dir)
    loc = build_model("Localizer", **manifest["localizer"]["kwargs"])
    snap = checkpoint.list_snapshots(log_dir, "Localizer_")[-1][1]
    loc.load_state_dict(checkpoint.load_params(snap))
    state = create_train_state(loc.to(DEVICE))
    theta = make_eval_step()(state, torch.from_numpy(frames).to(DEVICE))
    want = corners_to_aabb(theta_corners(theta), Size(*args.target_size), clip=True).cpu().numpy()
    err = float(np.abs(boxes[:, 0] - want).max())
    check(np.isfinite(boxes).all() and np.isfinite(scores).all(), f"{tag}: served boxes finite")
    check(err <= SLICE_TOL["boxes_px"], f"{tag}: served boxes differ from the eval step's by {err} px")
    print(f"{tag}: served {os.path.basename(snap)} through LocalizerInference on {DEVICE}: 8 val frames, "
          f"boxes against the CLI's eval step max {err:.3e} px (tol {SLICE_TOL['boxes_px']:g}), "
          f"mean score {float(np.mean(scores)):.4f}")
    return err


def cli_phases(card: str, f32_step_rate: float, log_root: str) -> dict:
    """Phase 10 (float32, with the pool refresh; its log dir kept under
    ``log_root`` for phase 12) and phase 11 (``--supervised``, ``--bf16``,
    and the bf16 step timed beside the float32 one)."""
    render_against_plain(CLI_ARGV)
    f32 = cli_run("cli", CLI_ARGV, card, log_root)
    check(f32["swaps"] >= 1, f"cli: no assessor pool swap in {CLI_ITERATIONS} iterations")
    rates = ", ".join(f"{e['images_per_sec']:.1f}" for e in f32["log"][1:])
    print(f"cli: images/s at batch {TRAIN_BATCH}, float32, log entries after the first (each one interval "
          f"of {STEPS_PER_CALL} steps with the previous entry's eval; a smoke value): {rates} "
          f"(median {f32['images_per_s']:.1f}) ({card})")
    short = ["--iterations", "8", "--snapshot-interval", "8", "--supervised"]
    cli_run("cli supervised", CLI_ARGV + short, card)
    bf16 = cli_run("cli bf16", CLI_ARGV + ["--iterations", "16", "--snapshot-interval", "16", "--bf16"], card)
    print(f"cli bf16: images/s at batch {TRAIN_BATCH} {bf16['images_per_s']:.1f} (the one interval after the "
          f"first, a smoke value) ({card})")
    bf16_step(card, f32_step_rate)
    return f32


def bf16_step(card: str, f32_step_rate: float) -> None:
    """The ``--bf16`` step (convolutions and BatchNorm outputs in bfloat16)
    and the float32 step on phase 5's pools, each after a warm-up chunk:
    images/s of ``TIMED_CHUNKS`` chunks of ``STEPS_PER_CALL`` steps each,
    the two alternating, median; then one traced bf16 chunk: where its
    device time goes, and its idle share."""
    kwargs = MANIFEST["localizer"]["kwargs"]
    config = AlternatingConfig(image_size=Size(INPUT, INPUT))
    step_fn = functools.partial(pooled_step, steps_per_call=STEPS_PER_CALL, config=config)
    pools = training_pools()
    runs = {}
    for name, dtype in {"float32": torch.float32, "bf16": torch.bfloat16}.items():
        torch.manual_seed(SEED)
        loc = build_model("Localizer", **kwargs, dtype=dtype, norm_dtype=dtype).to(DEVICE)
        ass = build_model("ResnetAssessor", in_size=loc.out_size, dtype=dtype).to(DEVICE)
        runs[name] = {
            "states": (create_train_state(loc, LR), create_train_state(ass, LR)),
            "chunks": device_chunk_batches(pools, TRAIN_BATCH, STEPS_PER_CALL, seed=SEED, device=DEVICE),
            "generator": torch.Generator(device=DEVICE).manual_seed(SEED),
            "rates": [],
        }

    def chunk(run) -> float:
        torch.cuda.synchronize()
        start = time.perf_counter()
        _, _, metrics = step_fn(*run["states"], next(run["chunks"]), run["generator"])
        check(np.isfinite(float(metrics["loss_localizer"])), "bf16 step: loss finite")
        torch.cuda.synchronize()
        return STEPS_PER_CALL * TRAIN_BATCH / (time.perf_counter() - start)

    for run in runs.values():
        chunk(run)  # warm-up
    for _ in range(TIMED_CHUNKS):
        for run in runs.values():
            run["rates"].append(chunk(run))
    med = {name: statistics.median(run["rates"]) for name, run in runs.items()}
    for name, run in runs.items():
        print(f"cli bf16: {name} step images/s at batch {TRAIN_BATCH}, {TIMED_CHUNKS} chunks of "
              f"{STEPS_PER_CALL} after a warm-up (phase 5's pools, the two alternating): "
              f"{', '.join(f'{r:.1f}' for r in run['rates'])} (median {med[name]:.1f}) ({card})")
    print(f"cli bf16: bf16 step {med['bf16']:.1f} against float32 {med['float32']:.1f} images/s "
          f"({med['bf16'] / med['float32']:.2f}x; phase 5's float32 Trainer median {f32_step_rate:.1f}) ({card})")
    print("cli bf16: one traced chunk of the bf16 step (phase 5's pools, after the timed chunks):")
    run = runs["bf16"]
    in_situ = profile_chunk(*run["states"], next(run["chunks"]), step_fn, run["generator"], card)
    for kernel in ("separable_sampler_fwd", "separable_sampler_bwd_theta"):
        us, count = in_situ.get(kernel, (None, 0))
        print(f"cli bf16: in the traced chunk, {kernel} {fmt_us(us)} device time per launch ({count} launches)")


# -- phase 12 ---------------------------------------------------------------
def read_png(path: str) -> np.ndarray:
    """An 8-bit RGB PNG of ``insights.rendering.write_png`` (no filter, no
    interlace) as an HW3 uint8 array: the card's machine has no Pillow."""
    with open(path, "rb") as f:
        data = f.read()
    check(data[:8] == b"\x89PNG\r\n\x1a\n", f"{path}: not a PNG")
    pos, idat, header = 8, b"", None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        kind, body = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + length]
        check(zlib.crc32(kind + body) == struct.unpack(">I", data[pos + 8 + length : pos + 12 + length])[0],
              f"{path}: bad CRC in {kind!r}")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + length
    w, h, depth, color = header[:4]
    check(depth == 8 and color == 2, f"{path}: depth {depth}, color type {color}")
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * 3)
    check(not rows[:, 0].any(), f"{path}: a row is filtered")
    return rows[:, 1:].reshape(h, w, 3)


def eval_argv(log_dir: str, out: str) -> list[str]:
    """The evaluation CLI on phase 10's world (the train CLI's val seed and
    asset seed: ``evaluate``'s defaults for a run at seed 0), batch 32."""
    return [f"synthetic:{EVAL_SCENES}", log_dir, "-b", str(BATCH), "-a", "--bn-warmup", "1",
            "--deteval", f"{out}/deteval", "--save-predictions", f"{out}/renders",
            "--synthetic-assets", "16", "--device", DEVICE]


def sweep_on_card(tag: str, log_dir: str, out: str, used: str, card: str) -> dict:
    """``cli.evaluate.main`` on the card with every count at 0: checks that
    each batch of each pass (scoring, renders, deteval) launched ``used``'s
    forward once and nothing else ran, the entries, the deteval XML and
    one render; then runs the CLI again, which must evaluate nothing."""
    snaps = checkpoint.list_snapshots(log_dir, "Localizer_")
    torch.cuda.synchronize()
    reset_launches()
    start = time.perf_counter()
    results = evaluate.main(eval_argv(log_dir, out))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - start
    launches = read_launches()
    n_batches = EVAL_SCENES // BATCH
    passes = 3  # scoring, renders, deteval
    want = len(snaps) * n_batches * passes
    other = "K1" if used == "K2" else "K2"
    check(launches == {used: {**NO_LAUNCHES, "fwd": want}, other: NO_LAUNCHES},
          f"{tag}: launches {launches} for {len(snaps)} snapshots x {n_batches} batches x {passes} passes")
    names = [os.path.basename(p) for _, p in snaps]
    check([e["snapshot_name"] for e in results.entries] == names, f"{tag}: entries {results.entries}")
    for e in results.entries:
        t = results.timings[e["snapshot_name"]]
        check(all(np.isfinite(e[k]) for k in ("map", "mean_iou", "ap/object", "mean_assessor_score")),
              f"{tag}: {e}")
        check(0.0 <= e["mean_iou"] <= 1.0 and 0.0 <= e["mean_assessor_score"] <= 1.0, f"{tag}: {e}")
        print(f"{tag}: {e['snapshot_name']} map {e['map']:.4f} mean_iou {e['mean_iou']:.4f} "
              f"mean_assessor_score {e['mean_assessor_score']:.4f}; {t['seconds']:.3f} s for the snapshot "
              f"(restore, warm-up, 3 passes), scoring {t['images'] / t['score_seconds']:.1f} images/s "
              f"({t['images']} images, batch {BATCH}) ({card})")
    print(f"{tag}: {len(snaps)} snapshots in {wall_s:.2f} s of wall time (data generation included); "
          f"{used} forward launches {launches[used]['fwd']} = {len(snaps)} snapshots x {n_batches} batches "
          f"x {passes} passes, {other} {launches[other]}")
    for iteration, _ in snaps:  # the deteval XML and the renders read back
        root = ET.parse(f"{out}/deteval/deteval_{iteration}.xml").getroot()
        images = root.findall("image")
        check(len(images) == n_batches * BATCH and all(len(i.find("taggedRectangles")) == 1 for i in images),
              f"{tag}: deteval_{iteration}.xml holds {len(images)} images")
        renders = sorted(os.listdir(f"{out}/renders/{iteration}"))
        check(len(renders) == n_batches * BATCH, f"{tag}: {len(renders)} renders of iteration {iteration}")
    png = read_png(f"{out}/renders/{iteration}/0.png")
    check(png.shape == (INPUT, INPUT, 3), f"{tag}: a render of shape {png.shape}")
    check(bool((png == 255).all(-1).any()), f"{tag}: no white gt outline in the render")
    print(f"{tag}: deteval XML of {n_batches * BATCH} images per snapshot and {len(renders)} renders per "
          f"snapshot read back; render 0 of iteration {iteration} {png.shape} {png.dtype}")
    reset_launches()
    again = evaluate.main(eval_argv(log_dir, out))
    launches = read_launches()
    check(not again.timings and len(again.entries) == len(snaps), f"{tag}: the second run evaluated {again.timings}")
    check(launches == {"K1": NO_LAUNCHES, "K2": NO_LAUNCHES}, f"{tag}: the second run launched {launches}")
    print(f"{tag}: a second run evaluated nothing (resume): {len(again.entries)} entries, no launch")
    return {"results": results, "launches": want}


def evaluation_phase(card: str, cli_log_dir: str, rotated_log_dir: str, out: str) -> dict:
    """Phase 12: phase 10's sweep on the card, its last snapshot on the CPU
    against the card, and phase 8's rotated log dir on K2."""
    k1 = sweep_on_card("evaluate", cli_log_dir, f"{out}/cli", "K1", card)
    # the last snapshot again, on the card and on the CPU, with the same
    # warm-up: the scores, and the boxes of every eval image
    args = evaluate.get_parser().parse_args(eval_argv(cli_log_dir, out))
    ds = evaluate.build_dataset(args, Size(INPUT, INPUT))

    def batches():
        return iter(DataLoader(ds, BATCH, shuffle=False, drop_last=True, collate=padded_collate))

    last = checkpoint.list_snapshots(cli_log_dir, "Localizer_")[-1][1]
    prefix = os.path.basename(last)[: -len(".pt")]
    boxes, entries = {}, {}
    for device in (DEVICE, "cpu"):
        ev = Evaluator(cli_log_dir, snapshot_prefix=prefix, results_name=f"eval_last_{device}.json",
                       use_assessor=True, device=device)
        if device == DEVICE:  # traced: where a snapshot's warm-up and scoring pass spend their time
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                start = time.perf_counter()
                entries[device] = ev.sweep(batches, bn_warmup=1).entries[-1]
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - start) * 1e3
            print_trace(prof, f"Evaluator.sweep of {prefix}.pt (restore, warm-up, scoring; batch {BATCH})",
                        wall_ms, card, top=10)
        else:
            entries[device] = ev.sweep(batches, bn_warmup=1).entries[-1]
        boxes[device] = np.concatenate([ev.predict(torch.from_numpy(b[0]).to(device)) for b in batches()])
    gt = np.concatenate([b[1][:, 0] for b in batches()])
    sides = np.concatenate([boxes["cpu"][:, 2:] - boxes["cpu"][:, :2], gt[:, 2:] - gt[:, :2]]).ravel()
    min_side = float(sides[sides > 0].min())
    box_err = float(np.abs(boxes[DEVICE] - boxes["cpu"]).max())
    iou_err = abs(entries[DEVICE]["mean_iou"] - entries["cpu"]["mean_iou"])
    # a box corner moved by e px moves an IoU by at most 2 e / (the smaller
    # side it meets); four corners: 8 e over the smallest side of any box
    iou_tol = 8 * EVAL_TOL["boxes_px"] / min_side
    print(f"evaluate card vs CPU ({prefix}.pt, {len(gt)} images, BatchNorm warm-up on each device): boxes max "
          f"{box_err:.3e} px (tol {EVAL_TOL['boxes_px']:g}), mean_iou {iou_err:.3e} (tol {iou_tol:.3g}: "
          f"8 x the box tol over the smallest box side, {min_side:.1f} px), map card "
          f"{entries[DEVICE]['map']:.4f} CPU {entries['cpu']['map']:.4f}, mean_assessor_score diff "
          f"{abs(entries[DEVICE]['mean_assessor_score'] - entries['cpu']['mean_assessor_score']):.3e}")
    check(box_err <= EVAL_TOL["boxes_px"], f"evaluate card vs CPU: boxes {box_err} px")
    check(iou_err <= iou_tol, f"evaluate card vs CPU: mean_iou {iou_err} > {iou_tol}")
    k2 = sweep_on_card("evaluate rotated", rotated_log_dir, f"{out}/rotated", "K2", card)
    return {"K1": k1["launches"], "K2": k2["launches"]}


# -- phase 13 ---------------------------------------------------------------
def vbp_phase(card: str, serve_log_dir: str, frames: np.ndarray) -> int:
    """VisualBackprop served on the card at batch 32: the heat map against
    the CPU's, and images/s with and without it, in turns."""
    batch = frames[2 : 2 + BATCH]
    served = {vbp: LocalizerInference(serve_log_dir, device=DEVICE, use_assessor=True, use_visual_backprop=vbp)
              for vbp in (True, False)}
    cpu = LocalizerInference(serve_log_dir, device="cpu", use_assessor=True, use_visual_backprop=True)
    for inf in served.values():
        inf.localize_batch(batch)  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    rates = {True: [], False: []}
    for _ in range(3):
        for vbp, inf in served.items():
            start = time.perf_counter()
            boxes, rois, scores, heat = inf.localize_batch(batch)
            rates[vbp].append(BATCH / (time.perf_counter() - start))
            check(np.isfinite(boxes).all() and (heat is None) != vbp, "vbp serving outputs")
            if vbp:
                check(len(heat) == BATCH and heat[0].shape == (INPUT, INPUT, 3) and heat[0].dtype == np.uint8,
                      "vbp heat maps")
                check(int(np.ptp(np.stack(heat))) > 100, "vbp heat maps are not constant")
    launches = read_launches()
    check(launches == {"K1": {**NO_LAUNCHES, "fwd": 6}, "K2": NO_LAUNCHES},
          f"vbp: 6 batches launched {launches}")
    card_heat = served[True]._predict(batch)[3].cpu()
    cpu_heat = cpu._predict(batch)[3]
    err = float((card_heat - cpu_heat).abs().max())
    print(f"vbp card vs CPU: heat map max abs err {err:.3e} (tol {VBP_TOL:g}) over {BATCH} frames "
          f"{INPUT}^2, {len(served[True].localizer.vbp_ladder())} ladder steps")
    check(err <= VBP_TOL, f"vbp card vs CPU: {err} > {VBP_TOL}")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:  # after the timed batches
        start = time.perf_counter()
        served[True].localize_batch(batch)
        wall_ms = (time.perf_counter() - start) * 1e3
    print_trace(prof, f"localize_batch({BATCH}) with VisualBackprop", wall_ms, card, top=10)
    med = {vbp: statistics.median(r) for vbp, r in rates.items()}
    print(f"vbp: localize_batch({BATCH}) images/s with VisualBackprop "
          f"{', '.join(f'{r:.1f}' for r in rates[True])} (median {med[True]:.1f}), without "
          f"{', '.join(f'{r:.1f}' for r in rates[False])} (median {med[False]:.1f}), in turns; "
          f"{med[True] / med[False]:.3f}x; K1 forward launches {launches['K1']['fwd']} ({card})")
    return launches["K1"]["fwd"]


# -- phase 14 ---------------------------------------------------------------
def bench_phase(card: str) -> dict:
    """The port's bench at its operating point, with K1's launches."""
    torch.cuda.synchronize()
    reset_launches()
    run = bench.measure()
    launches = read_launches()
    steps = bench.STEPS_PER_CALL * (bench.WARMUP_CALLS + bench.CALLS)
    check(launches == {"K1": {**NO_LAUNCHES, "fwd": steps, "bwd_theta": steps}, "K2": NO_LAUNCHES},
          f"bench: {steps} steps launched {launches}")
    line = bench.result_line(run, bench.BATCH)
    print(json.dumps(line))
    calls = sorted(run["call_ms"])
    print(f"bench: {bench.CALLS} timed calls of {bench.STEPS_PER_CALL} steps at batch {bench.BATCH} "
          f"(bf16, after {bench.WARMUP_CALLS} warm-up calls): {run['images_per_sec']:.2f} images/s; per call "
          f"(CUDA events) min {calls[0]:.2f} ms, median {statistics.median(calls):.2f} ms, max {calls[-1]:.2f} ms; "
          f"loss_localizer {run['loss_localizer']:.5f}; K1 launches {launches['K1']} ({card})")
    return {"fwd": steps, "bwd_theta": steps}


def kernel_entry(name: str, source: str, replaces: str, launches: int, err: float, t: dict,
                 in_situ: dict, by_path: dict) -> dict:
    return {
        "name": name,
        "route": "cuda",
        "source": f"loans_tpu_torch/ops/csrc/{source}",
        "replaces": replaces,
        "launches": launches,
        "launches_by_path": by_path,
        "max_abs_err": err,
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": t["library_ms"],
        "device_ms": t["device_ms"],
        "device_cold_ms": t.get("device_cold_ms"),
        "device_in_situ_ms": in_situ.get(name),
    }


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke FAILED: torch.cuda.is_available() is false")
    set_precision()
    card = environment()
    k1 = kernel_against_plain(card)
    k1_bwd = backward_against_plain(card)
    frames = scenes(np.random.default_rng(SEED + 1), 2 + 3 * BATCH, INPUT)
    calib = scenes(np.random.default_rng(SEED + 2), BATCH, INPUT)
    with tempfile.TemporaryDirectory() as work:  # log dirs that phases 12 and 13 read again
        serve_dir, rotated_dir = f"{work}/serve", f"{work}/rotated"
        write_log_dir(serve_dir, calib)
        inf = LocalizerInference(serve_dir, device=DEVICE, use_assessor=True)
        serving = serve(inf, frames, card)
        card_against_cpu(serve_dir, inf, frames)
        pools = training_pools()
        k1_train = train_slice(pools, card)
        step_against_cpu(pools)
        k2 = rotated_against_plain(card)
        k2_train = train_slice(pools, card, with_kwargs(**ROTATED_KWARGS), rotated_dir)
        step_against_cpu(pools, with_kwargs(rotation_dropout_ratio=1.0),
                         samplers={DEVICE: "rotated_pallas", "cpu": "rotated"})
        cli = cli_phases(card, k1_train["images_per_s"], f"{work}/cli")
        evaluated = evaluation_phase(card, cli["log_dir"], rotated_dir, f"{work}/evaluate")
        vbp_launches = vbp_phase(card, serve_dir, frames)
        bench_launches = bench_phase(card)
    k1_src, k2_src = "separable_sampler.cu", "rotated_sampler.cu"
    launches1, launches2 = cli["launches"], k2_train["launches"]
    in_situ = {**k1_train["device_in_situ_ms"], **k2_train["device_in_situ_ms"]}
    k1_paths = {
        "fwd": {"serve": serving["launches"], "train": k1_train["launches"]["fwd"], "train_cli": launches1["fwd"],
                "evaluate": evaluated["K1"], "serve_vbp": vbp_launches, "bench": bench_launches["fwd"]},
        "bwd_theta": {"train": k1_train["launches"]["bwd_theta"], "train_cli": launches1["bwd_theta"],
                      "evaluate": 0, "bench": bench_launches["bwd_theta"]},
        "bwd_images": {"train": 0, "train_cli": launches1["bwd_images"], "evaluate": 0, "bench": 0},
    }
    k2_paths = {
        "fwd": {"train_rotated": launches2["fwd"], "evaluate_rotated": evaluated["K2"]},
        "bwd_theta": {"train_rotated": launches2["bwd_theta"], "evaluate_rotated": 0},
        "bwd_images": {"train_rotated": launches2["bwd_images"], "evaluate_rotated": 0},
    }
    print(json.dumps({"kernels": [
        kernel_entry("separable_sampler_fwd", k1_src, "loans_tpu/ops/stn.py:421", launches1["fwd"],
                     k1["max_abs_err"], k1["times"][TRAIN_BATCH], in_situ, k1_paths["fwd"]),
        kernel_entry("separable_sampler_bwd_theta", k1_src, "loans_tpu/ops/stn.py:641", launches1["bwd_theta"],
                     k1_bwd["max_abs_err"]["bwd_theta"], k1_bwd["times"]["bwd_theta"][TRAIN_BATCH], in_situ,
                     k1_paths["bwd_theta"]),
        kernel_entry("separable_sampler_bwd_images", k1_src, "loans_tpu/ops/stn.py:641", launches1["bwd_images"],
                     k1_bwd["max_abs_err"]["bwd_images"], k1_bwd["times"]["bwd_images"][TRAIN_BATCH], in_situ,
                     k1_paths["bwd_images"]),
        kernel_entry("rotated_sampler_fwd", k2_src, "loans_tpu/ops/stn.py:474", launches2["fwd"],
                     k2["max_abs_err"]["fwd"], k2["times"]["fwd"][TRAIN_BATCH], in_situ, k2_paths["fwd"]),
        kernel_entry("rotated_sampler_bwd_theta", k2_src, "loans_tpu/ops/stn.py:256", launches2["bwd_theta"],
                     k2["max_abs_err"]["bwd_theta"], k2["times"]["bwd_theta"][TRAIN_BATCH], in_situ,
                     k2_paths["bwd_theta"]),
        kernel_entry("rotated_sampler_bwd_images", k2_src, "loans_tpu/ops/stn.py:256", launches2["bwd_images"],
                     k2["max_abs_err"]["bwd_images"], k2["times"]["bwd_images"][TRAIN_BATCH], in_situ,
                     k2_paths["bwd_images"]),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
