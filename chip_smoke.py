#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving path on one CUDA card.

    python3 chip_smoke.py

Phases, one line or more each; any failure exits non-zero:

1. environment: the card's name and power limit (``nvidia-smi``), the
   torch / CUDA / nvcc versions, and the time to build the CUDA kernels
   from this checkout;
2. each kernel against its plain PyTorch version on the card (TF32 off),
   with its time and the plain version's (CUDA events, median of 25 runs);
3. the slice: an R-50 224x224 -> 75x75 localizer with the assessor,
   seeded and saved as ``.pt`` snapshots in a temporary log dir, served
   through ``LocalizerInference(device="cuda")``: 2 single-frame requests
   and 3 batches of 32 frames, with each kernel's launch count checked;
4. the same models and weights on the CPU (plain sampler) against the
   card on 2 frames.

The line before the last is a JSON object of the kernels, with their
launch counts in phase 3, errors and times; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA card it exits with an
error before printing either.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import tempfile
import time

import numpy as np
import torch
from torch import nn

from loans_tpu_torch.inference.localizer import LocalizerInference, set_precision
from loans_tpu_torch.ops import _cuda
from loans_tpu_torch.ops.geometry import Size
from loans_tpu_torch.ops.stn import sample_separable, sample_separable_kernel
from loans_tpu_torch.train import checkpoint
from loans_tpu_torch.utils.registry import build_assessor, build_model

SEED = 0
DEVICE = "cuda"
INPUT, CROP, BATCH = 224, 75, 32
K1_TOL = 1e-5  # absolute, images in [0, 1]
# card against CPU: float32 on both, sums in another order; a theta error d
# moves samples by d * 111.5 px on frames whose pixels step by up to ~0.5
SLICE_TOL = {"theta": 1e-4, "boxes_px": 1e-2, "rois": 1e-3, "scores": 1e-4}
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


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {what}")


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


def device_us(fn, reps: int = 20, match: str = "") -> float | None:
    """Device time per call of ``fn`` in µs from a ``torch.profiler``
    trace: the summed self device time of the kernels and copies whose
    name contains ``match``, over ``reps`` calls. None when the trace
    holds no device time."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in device_events(prof) if match in e.key)
    return total / reps if total > 0 else None


def device_events(prof) -> list:
    """Kernels, copies and memsets on the card in a profiler trace."""
    return [
        e for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and e.self_device_time_total > 0 and "Activity Buffer" not in e.key
    ]


def fmt_us(us: float | None) -> str:
    return "not measured" if us is None else f"{us:.1f} us"


def scenes(rng: np.random.Generator, n: int, size: int) -> np.ndarray:
    """Noise backgrounds, each with one bright rectangle pasted in."""
    frames = rng.uniform(0.0, 0.5, size=(n, size, size, 3)).astype(np.float32)
    for f in frames:
        y, x = rng.integers(0, size // 2, 2)
        h, w = rng.integers(size // 4, size // 2, 2)
        f[y : y + h, x : x + w] = rng.uniform(0.7, 1.0, 3)
    return frames


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
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    start = time.perf_counter()
    for name in _cuda.SIGNATURES:
        _cuda.load_library(name)
    build_s = time.perf_counter() - start
    print(f"build: {len(_cuda.SIGNATURES)} CUDA libraries in {build_s:.2f} s")
    for name in _cuda.SIGNATURES:
        log = _cuda.library_path(name).with_suffix(".log").read_text()
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"build: {name}: {line.strip()}")
    return card


# -- phase 2 --------------------------------------------------------------
def axis_aligned_theta(rng, n):
    theta = np.zeros((n, 2, 3), dtype=np.float32)
    theta[:, 0, 0] = rng.uniform(0.3, 1.1, n)
    theta[:, 1, 1] = rng.uniform(0.3, 1.1, n)
    theta[:, 0, 2] = rng.uniform(-0.4, 0.4, n)
    theta[:, 1, 2] = rng.uniform(-0.4, 0.4, n)
    return theta


def kernel_against_plain(card: str) -> dict:
    rng = np.random.default_rng(SEED)
    dev = torch.device(DEVICE)

    def on_card(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def compare(name, images, theta, out_size, expect=None):
        images, theta = on_card(images), on_card(theta)
        got = sample_separable_kernel(images, theta, out_size)
        want = sample_separable(images, theta, out_size)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if expect is not None:
            err = max(err, float((got - expect).abs().max()))
        check(err <= K1_TOL, f"K1 {name}: max abs err {err} > {K1_TOL}")
        print(f"K1 {name}: max_abs_err {err:.3e} (tol {K1_TOL})")
        return err, images, theta

    out = Size(CROP, CROP)
    errs, times = [], {}
    for n in (BATCH, 128):
        imgs = rng.uniform(size=(n, INPUT, INPUT, 3)).astype(np.float32)
        err, images, theta = compare(f"N={n} {INPUT}^2->{CROP}^2", imgs, axis_aligned_theta(rng, n), out)
        errs.append(err)
        kernel = lambda: sample_separable_kernel(images, theta, out)  # noqa: E731
        plain = lambda: sample_separable(images, theta, out)  # noqa: E731
        ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
        times[n] = (ms, plain_ms)
        print(f"K1 N={n}: per call (CUDA events, host launch included) kernel "
              f"{ms * 1e3:.1f} us, plain bmm {plain_ms * 1e3:.1f} us ({card})")
        print(f"K1 N={n}: device time (profiler) kernel "
              f"{fmt_us(device_us(kernel, match='separable_sampler'))}, plain bmm "
              f"{fmt_us(device_us(plain))} ({card})")

    small = rng.uniform(size=(4, CROP, CROP, 3)).astype(np.float32)
    identity = np.tile(np.array([[1, 0, 0], [0, 1, 0]], np.float32), (4, 1, 1))
    errs.append(compare("identity", small, identity, out, expect=on_card(small))[0])
    imgs = rng.uniform(size=(4, INPUT, INPUT, 3)).astype(np.float32)
    off = np.tile(np.array([[0.5, 0, 5.0], [0, 0.5, 5.0]], np.float32), (4, 1, 1))
    errs.append(compare("off-image", imgs, off, out, expect=torch.zeros(4, CROP, CROP, 3, device=dev))[0])
    border = np.array(
        [[[0.6, 0, 0.7], [0, 0.5, 0.8]], [[0.8, 0, -0.9], [0, 0.9, -1.2]],
         [[1.2, 0, 0.0], [0, 1.3, 0.1]], [[0.3, 0, 0.95], [0, 0.3, -0.95]]],
        np.float32,
    )
    errs.append(compare("border", imgs, border, out)[0])
    errs.append(compare("h_out=1", imgs, axis_aligned_theta(rng, 4), Size(1, CROP))[0])
    errs.append(compare("w_out=1", imgs, axis_aligned_theta(rng, 4), Size(CROP, 1))[0])
    return {"max_abs_err": max(errs), "times": times}


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
            bn.reset_running_stats()
            bn.momentum = None  # cumulative average: one batch's statistics
        loc.train()
        feats = loc.feature_extractor((x * 255.0 - loc.mean).permute(0, 3, 1, 2))
        for bn in bns:
            bn.momentum = 0.1
        loc.eval()
        feats = loc.feature_extractor((x * 255.0 - loc.mean).permute(0, 3, 1, 2)).mean(dim=(2, 3))
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
    sample_separable_kernel.launches = 0
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
    launches = sample_separable_kernel.launches
    check(launches == n_forward, f"K1 launched {launches} times for {n_forward} forwards")
    profile_batch(inf, frames[2 : 2 + BATCH], card)
    spread = float(np.concatenate(kept_boxes)[:, 3].std())
    print(f"slice: {n_forward} forwards (2 x localize, 3 x localize_batch({BATCH})), "
          f"K1 launches {launches}, x_max spread {spread:.1f} px")
    print(f"slice: localize_batch({BATCH}) images/s "
          f"{statistics.median(rates):.1f} (median; runs {', '.join(f'{r:.1f}' for r in rates)}) "
          f"({card})")
    return {"launches": launches, "images_per_s": statistics.median(rates)}


def profile_batch(inf: LocalizerInference, batch: np.ndarray, card: str) -> None:
    """One traced ``localize_batch``: wall time, device busy time and the
    device time of the largest kernels and copies."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        start = time.perf_counter()
        inf.localize_batch(batch)
        wall_ms = (time.perf_counter() - start) * 1e3
    events = device_events(prof)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    print(f"trace: localize_batch({len(batch)}) wall {wall_ms:.2f} ms, device busy "
          f"{busy_ms:.2f} ms, idle share {max(0.0, 1 - busy_ms / wall_ms):.3f} ({card})")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"trace:   {e.self_device_time_total / 1e3:8.3f} ms x{e.count:<4d} {e.key[:90]}")


# -- phase 4 --------------------------------------------------------------
def card_against_cpu(log_dir: str, inf: LocalizerInference, frames: np.ndarray) -> dict:
    cpu = LocalizerInference(log_dir, device="cpu", use_assessor=True, score_threshold=0.0)
    inf.score_threshold = 0.0
    two = frames[:2]
    with torch.inference_mode():
        rois_g, theta_g = inf.localizer(torch.from_numpy(two).to(DEVICE))
        rois_c, theta_c = cpu.localizer(torch.from_numpy(two))
    bg, _, sg, _ = inf.localize_batch(two)
    bc, _, sc, _ = cpu.localize_batch(two)
    errs = {
        "theta": float((theta_g.cpu() - theta_c).abs().max()),
        "boxes_px": float(np.abs(bg - bc).max()),
        "rois": float((rois_g.cpu() - rois_c).abs().max()),
        "scores": float(np.abs(sg - sc).max()),
    }
    print("card vs CPU: " + ", ".join(
        f"{k} {v:.3e} (tol {SLICE_TOL[k]:g})" for k, v in errs.items()))
    for k, v in errs.items():
        check(v <= SLICE_TOL[k], f"card vs CPU {k}: {v} > {SLICE_TOL[k]}")
    return errs


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke FAILED: torch.cuda.is_available() is false")
    set_precision()
    card = environment()
    k1 = kernel_against_plain(card)
    frames = scenes(np.random.default_rng(SEED + 1), 2 + 3 * BATCH, INPUT)
    calib = scenes(np.random.default_rng(SEED + 2), BATCH, INPUT)
    with tempfile.TemporaryDirectory() as log_dir:
        write_log_dir(log_dir, calib)
        inf = LocalizerInference(log_dir, device=DEVICE, use_assessor=True)
        served = serve(inf, frames, card)
        card_against_cpu(log_dir, inf, frames)
    ms, plain_ms = k1["times"][BATCH]
    print(json.dumps({"kernels": [{
        "name": "separable_sampler_fwd",
        "route": "cuda",
        "source": "loans_tpu_torch/ops/csrc/separable_sampler.cu",
        "replaces": "loans_tpu/ops/stn.py:421",
        "launches": served["launches"],
        "max_abs_err": k1["max_abs_err"],
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
