"""Training-throughput benchmark of the port (counterpart of the root
``bench.py``), at the same operating point.

    python -m loans_tpu_torch.bench            # one CUDA card
    python -m loans_tpu_torch.bench --device cpu

The alternating weakly supervised step as the training CLI runs it:
``pooled_step`` over uint8 pools resident on the device (512 scenes 224²
and 1024 crops 75² with uniform IoU labels, from
``numpy.random.default_rng(0)``), calls of 10 steps at batch 128, the
ResNet-50 localizer and the assessor in bfloat16 (convolutions and
BatchNorm outputs; parameters, optimizer and the crop in float32), K1's
forward and d theta kernels cropping on the card. Two warm-up calls, then
10 timed calls on the host clock, stopped after a device sync.

Prints one JSON line with the root bench's keys (``metric``, ``value``,
``unit``, ``vs_baseline``, ``batch``) plus ``backend``, the PyTorch build
and the device it ran on. ``LOANS_BENCH_BATCH64`` set adds the rate at
batch 64. Without a CUDA card it fails unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import time

import numpy as np
import torch

# the root bench's north star: 5 x an estimated 80 images/s of the
# reference on a GPU of its era; vs_baseline >= 1.0 meets it
BASELINE_IMAGES_PER_SEC = 5 * 80.0
BATCH = 128
STEPS_PER_CALL = 10
WARMUP_CALLS = 2
CALLS = 10
POOL_SCENES = 512
POOL_CROPS = 1024


def measure(
    batch: int = BATCH,
    *,
    device: str | torch.device = "cuda",
    n_layers: int = 50,
    image_size: int = 224,
    crop_size: int = 75,
    steps_per_call: int = STEPS_PER_CALL,
    warmup_calls: int = WARMUP_CALLS,
    calls: int = CALLS,
    pool_scenes: int = POOL_SCENES,
    pool_crops: int = POOL_CROPS,
) -> dict:
    """Images/s of the pooled bf16 alternating step at ``batch``.

    Returns ``images_per_sec`` (``batch * steps_per_call * calls`` over the
    host seconds of the timed calls, after a device sync), ``call_ms``
    (each timed call on the device's timeline: CUDA events between calls on
    a card, the host clock on the CPU), the last call's ``loss_localizer``
    and the ``device`` name."""
    from loans_tpu_torch.data.device_data import device_chunk_batches
    from loans_tpu_torch.inference.localizer import set_precision
    from loans_tpu_torch.models import Localizer, ResnetAssessor
    from loans_tpu_torch.ops.geometry import Size
    from loans_tpu_torch.train import AlternatingConfig, create_train_state, pooled_step

    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (torch.cuda.is_available() is false); pass device='cpu'")
    set_precision()
    img, crop = Size(image_size, image_size), Size(crop_size, crop_size)
    torch.manual_seed(0)
    localizer = Localizer(out_size=crop, n_layers=n_layers, input_size=img,
                          dtype=torch.bfloat16, norm_dtype=torch.bfloat16).to(device)
    assessor = ResnetAssessor(in_size=crop, dtype=torch.bfloat16).to(device)
    loc_state, ass_state = create_train_state(localizer), create_train_state(assessor)
    gen = np.random.default_rng(0)
    groups = {
        "unlabeled": {"unlabeled": gen.integers(0, 256, (pool_scenes, image_size, image_size, 3), dtype=np.uint8)},
        "reference": {
            "real": gen.integers(0, 256, (pool_crops, crop_size, crop_size, 3), dtype=np.uint8),
            "labels": gen.uniform(size=(pool_crops, 1)).astype(np.float32),
        },
    }
    chunks = device_chunk_batches(groups, batch, steps_per_call, seed=0, device=device)
    step = functools.partial(pooled_step, steps_per_call=steps_per_call,
                             config=AlternatingConfig(image_size=img))
    generator = torch.Generator(device=device).manual_seed(1)

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    def mark():
        if not cuda:
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    try:
        for _ in range(warmup_calls):
            loc_state, ass_state, metrics = step(loc_state, ass_state, next(chunks), generator)
        sync()
        start = time.perf_counter()
        marks = [mark()]
        for _ in range(calls):
            loc_state, ass_state, metrics = step(loc_state, ass_state, next(chunks), generator)
            marks.append(mark())
        sync()
        seconds = time.perf_counter() - start
    finally:
        chunks.close()
    if cuda:
        call_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    else:
        call_ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    loss = float(metrics["loss_localizer"])
    if not np.isfinite(loss):
        raise RuntimeError(f"the bench's loss_localizer is {loss}")
    return {
        "images_per_sec": batch * steps_per_call * calls / seconds,
        "call_ms": call_ms,
        "loss_localizer": loss,
        "device": torch.cuda.get_device_name(device) if cuda else "cpu",
    }


def result_line(run: dict, batch: int) -> dict:
    """The root bench's JSON keys for ``measure``'s result, plus
    ``backend``."""
    rate = run["images_per_sec"]
    return {
        "metric": "localizer_train_images_per_sec_per_chip",
        "value": round(rate, 2),
        "unit": "images/sec/chip",
        "vs_baseline": round(rate / BASELINE_IMAGES_PER_SEC, 3),
        "batch": batch,
        "backend": f"pytorch {torch.__version__} on {run['device']}",
    }


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = p.parse_args(argv)
    out = result_line(measure(BATCH, device=args.device), BATCH)
    if os.environ.get("LOANS_BENCH_BATCH64"):
        out["batch64_images_per_sec_per_chip"] = round(measure(64, device=args.device)["images_per_sec"], 2)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
