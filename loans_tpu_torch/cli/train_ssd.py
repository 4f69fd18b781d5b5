"""Supervised SSD training CLI (port of ``loans_tpu/cli/train_ssd.py``).

    python -m loans_tpu_torch.cli.train_ssd synthetic:256 synthetic:32 --model ssd300 -b 32

SSD300 or SSD512 with one foreground class, trained on the multibox loss
with Adam, doubled bias gradients and weight decay
(``train.ssd_steps.SSDAdam``), on the synthetic world or a gt json. With
device data (``--device-data on``, or ``auto`` on synthetic train data)
the labeled train scenes, made at the model's input size, are uploaded
to the device once as a uint8 pool with their gt boxes, and each call of
K steps (``train.steps.pooled_step`` over ``data.ssd_device.SSDPooledBody``)
gathers its batches there, augments them on the device (the expand, crop
and resize window is K1's forward on the card) and encodes the multibox
targets. With ``--device-data off`` (a gt json always runs so) a
thread-pooled host loader (``--num-workers``) runs the host transform
(``data.ssd_augment.SSDTransform``: cv2's augmentation, or with
``--no-augment`` a resize without cv2) and the encoder, and
``data.loader.device_prefetch`` feeds ``train.ssd_steps.ssd_train_step``
one step a call. VOC mAP of the labeled val scenes (synthetic, or a gt
json resized as OpenCV resizes) is logged at every ``--eval-interval``.
``<log_dir>/<timestamp>_<name>`` receives ``manifest.json``, the metrics
``log`` and ``<SSD300|SSD512>_<iter>.pt`` snapshots, which
``inference.SSDInference`` serves and ``cli.evaluate`` sweeps.

``--plot-interval N`` draws the detections and their scores over the gt
boxes of the first val scene at iteration 0 and every N iterations
(``SSDPlotHook``, ``<log_dir>/bboxes/<iteration>.png``); the scores are
drawn with Pillow's font, so without Pillow the flag is refused by name
(``REFUSED``).

The flags are the JAX CLI's, plus ``--device`` (default ``cuda``;
``--device cpu`` runs the plain PyTorch crop).

Data-parallel over N GPUs as ``cli.train_localizer``:
``torchrun --standalone --nproc_per_node=N -m loans_tpu_torch.cli.train_ssd ...``
with a global ``--batch-size`` that N divides.
"""

from __future__ import annotations

import argparse
import functools

import numpy as np
import torch

from loans_tpu_torch import parallel

# flag -> why the port refuses it
REFUSED = {
    "plot_interval": "--plot-interval: the SSD plot hook draws scores with Pillow's font, and Pillow is not "
                     "installed",
}
# the JAX CLI's own message: the device path augments a raw scene pool
DEVICE_DATA_FILES = "--device-data on requires synthetic train data (raw scene pool); use --device-data off for gt json"


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="train a supervised SSD (PyTorch/CUDA)")
    p.add_argument("train_file", help="gt json, or 'synthetic[:N]' for generated labeled scenes")
    p.add_argument("val_file", help="gt json, or 'synthetic[:N]' for generated labeled scenes")
    p.add_argument("--model", choices=["ssd300", "ssd512"], default="ssd300")
    p.add_argument("--batch-size", "-b", type=int, default=8)
    p.add_argument("--learning-rate", "-lr", type=float, default=1e-4)
    p.add_argument("--iterations", "-it", type=int, default=1000)
    p.add_argument("--log-dir", "-l", default="logs")
    p.add_argument("--log-name", "-ln", default="ssd_training")
    p.add_argument("--log-interval", type=int, default=100)
    p.add_argument("--snapshot-interval", "-si", type=int, default=5000)
    p.add_argument("--eval-interval", type=int, default=1000)
    p.add_argument("--eval-batches", type=int, default=8)
    p.add_argument("--resume", default=None, help="a training snapshot (.pt) of this model")
    p.add_argument("--pretrained-model", default=None,
                   help="a port .pt snapshot whose matching entries are loaded")
    p.add_argument("--no-augment", action="store_true")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 convolutions (parameters, the optimizer, L2Norm and the crop stay float32)")
    p.add_argument("--plot-interval", type=int, default=0,
                   help="draw the detections on the first val scene every N iterations (0 = off)")
    p.add_argument("--num-workers", type=int, default=None, help="host loader threads (--device-data off)")
    p.add_argument("--device-data", choices=["auto", "on", "off"], default="auto",
                   help="keep the scene pool in device memory and augment there (auto: on for synthetic "
                   "train data; off: the host transform and loader)")
    p.add_argument("--steps-per-call", type=int, default=0,
                   help="train iterations per step call with device data (0 = 8; 1 without)")
    p.add_argument("--synthetic-assets", type=int, default=0, metavar="N",
                   help="share one procedural asset world (asset seed = seed + 9973) between synthetic "
                   "train and val")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="torch device to train on (default cuda)")
    return p


def refusals(args) -> list[str]:
    """Why this run cannot be served by the port (empty when it can)."""
    from loans_tpu_torch.cli.train_localizer import _is_synthetic
    from loans_tpu_torch.insights.rendering import pillow_installed

    out = []
    if args.plot_interval > 0 and not pillow_installed():
        out.append(REFUSED["plot_interval"])
    if args.device_data == "on" and not _is_synthetic(args.train_file):
        out.append(DEVICE_DATA_FILES)
    return out


def build_model(args, device: torch.device):
    """The SSD of ``--model`` on ``device``, its weights drawn from
    ``--seed``."""
    from loans_tpu_torch.models import SSD300, SSD512

    torch.manual_seed(args.seed)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    return (SSD300 if args.model == "ssd300" else SSD512)(n_fg_class=1, dtype=dtype).to(device)


def _asset_kw(args) -> dict:
    if args.synthetic_assets:
        return dict(asset_seed=args.seed + 9973, n_assets=args.synthetic_assets)
    return {}


def build_pool(args, size: int) -> dict[str, np.ndarray]:
    """The train pool ``{'scenes' (N, S, S, 3) uint8, 'boxes' (N, 1, 4)
    pixel yxyx, 'valid' (N, 1)}`` of synthetic scenes at the model's input
    size, as the JAX CLI builds it (``train_ssd.py:204-226, 257-274``)."""
    from loans_tpu_torch.cli.train_localizer import _synthetic_n
    from loans_tpu_torch.data.synthetic import SyntheticLocalizerDataset

    raw = SyntheticLocalizerDataset(
        _synthetic_n(args.train_file, 256), image_size=(size, size), seed=args.seed, labeled=True,
        output_dtype="uint8", **_asset_kw(args),
    )
    examples = [raw.get_example(i) for i in range(len(raw))]
    return {
        "scenes": np.stack([e[0] for e in examples]),
        "boxes": np.stack([e[1][0] for e in examples])[:, None, :].astype(np.float32),
        "valid": np.ones((len(raw), 1), bool),
    }


class SSDPlotHook:
    """A ``Hook`` fn: the detections and their scores (``evaluator.detect``)
    drawn over the gt boxes of one fixed image, saved as
    ``<log_dir>/bboxes/<iteration>.png``."""

    def __init__(self, evaluator, image, gt, log_dir):
        import os

        self.evaluator = evaluator
        self.image = np.asarray(image, dtype=np.float32)
        self.gt = np.asarray(gt, dtype=np.float32).reshape(-1, 4)
        self.out_dir = os.path.join(log_dir, "bboxes")
        os.makedirs(self.out_dir, exist_ok=True)

    def __call__(self, trainer, iteration) -> np.ndarray:
        import os

        from loans_tpu_torch.insights.rendering import draw_boxes_on_image, write_png

        state = trainer.loc_state
        device = next(state.model.parameters()).device
        ((boxes, _, scores),) = self.evaluator.detect(state, torch.from_numpy(self.image[None]).to(device))
        gt = self.gt[np.abs(self.gt).sum(axis=1) > 0]
        canvas = draw_boxes_on_image((self.image * 255).astype(np.uint8), boxes, gt_boxes=gt, scores=scores)
        write_png(os.path.join(self.out_dir, f"{iteration}.png"), canvas)
        return canvas


class SyntheticSSDAdapter:
    """Labeled synthetic scenes -> encoded SSD train tuples on the host
    (``--device-data off`` on synthetic data)."""

    def __init__(self, n, size, coder, seed=0, augment=True, asset_kw=None, augment_seed=None):
        from loans_tpu_torch.data.ssd_augment import SSDTransform
        from loans_tpu_torch.data.synthetic import SyntheticLocalizerDataset

        self.scenes = SyntheticLocalizerDataset(n, image_size=(size, size), seed=seed, labeled=True,
                                                output_dtype="uint8", **(asset_kw or {}))
        self.transform = SSDTransform(coder, size, seed=seed if augment_seed is None else augment_seed,
                                      augment=augment)

    def __len__(self):
        return len(self.scenes)

    def get_example(self, i):
        img, bbox, _ = self.scenes.get_example(i)
        return self.transform(img, bbox)


class ValAdapter:
    """A gt json -> (image float32 at the SSD's size, gt boxes padded to
    ``max_boxes`` rows), resized as OpenCV's ``cv2.resize`` does."""

    def __init__(self, source, size, max_boxes=16):
        from loans_tpu_torch.data.datasets import read_bbox_json

        self.pairs = read_bbox_json(source)
        self.size = size
        self.max_boxes = max_boxes

    def __len__(self):
        return len(self.pairs)

    def get_example(self, i):
        from loans_tpu_torch.data.cv_resize import resize_linear
        from loans_tpu_torch.data.datasets import load_image

        path, flat = self.pairs[i]
        img = load_image(path, "RGB")
        h, w = img.shape[:2]
        img = resize_linear(img, (self.size, self.size)).astype(np.float32) / 255.0
        bbox = np.asarray(flat, np.float32).reshape(-1, 4) * np.array([self.size / h, self.size / w] * 2,
                                                                      dtype=np.float32)
        out = np.zeros((self.max_boxes, 4), dtype=np.float32)
        out[: min(len(bbox), self.max_boxes)] = bbox[: self.max_boxes]
        return img, out


def build_val(args, size: int):
    """The val dataset: synthetic labeled scenes (seed + 1) or a gt json."""
    from loans_tpu_torch.cli.train_localizer import _is_synthetic, _synthetic_n
    from loans_tpu_torch.data.synthetic import SyntheticLocalizerDataset

    if _is_synthetic(args.val_file):
        return SyntheticLocalizerDataset(_synthetic_n(args.val_file, 32), image_size=(size, size),
                                         seed=args.seed + 1, labeled=True, **_asset_kw(args))
    return ValAdapter(args.val_file, size)


def build_train(args, size: int, coder):
    """The host train dataset of ``--device-data off``: synthetic scenes
    or a gt json through the host transform. The transform's draws are
    seeded with ``--seed`` plus the rank, so that the ranks of a
    data-parallel run augment independently."""
    from loans_tpu_torch.cli.train_localizer import _is_synthetic, _synthetic_n
    from loans_tpu_torch.data.ssd_augment import SSDDataset

    augment_seed = args.seed + parallel.rank()
    if _is_synthetic(args.train_file):
        return SyntheticSSDAdapter(_synthetic_n(args.train_file, 256), size, coder, seed=args.seed,
                                   augment=not args.no_augment, asset_kw=_asset_kw(args),
                                   augment_seed=augment_seed)
    return SSDDataset(args.train_file, coder, size, seed=augment_seed, augment=not args.no_augment)


def host_step(state, ass_state, batch, generator=None):
    """``ssd_train_step`` in the Trainer's shape, for host batches."""
    from loans_tpu_torch.train import ssd_train_step

    del ass_state, generator
    state, metrics = ssd_train_step(state, batch)
    return state, None, metrics


def main(argv=None) -> str:
    """Train; returns the run's log dir."""
    from loans_tpu_torch.cli.train_localizer import start_devices

    args = get_parser().parse_args(argv)
    refused = refusals(args)
    if refused:
        raise SystemExit("the port cannot run this: " + "; ".join(refused))
    with parallel.process_group(torch.device(args.device).type):
        return train(args, start_devices(args))


def train(args, device: torch.device) -> str:
    """The training run of ``main`` on ``device``."""
    from loans_tpu_torch.cli.train_localizer import _is_synthetic, run_log_dir
    from loans_tpu_torch.data.device_data import device_chunk_batches, device_eval_batches
    from loans_tpu_torch.data.loader import DataLoader, device_prefetch, images_to
    from loans_tpu_torch.data.ssd_device import SSDPooledBody
    from loans_tpu_torch.evaluation.ssd_eval import SSDEvaluator
    from loans_tpu_torch.inference.localizer import set_precision
    from loans_tpu_torch.train import Hook, Trainer, checkpoint, create_ssd_train_state, pooled_step

    set_precision()

    model = build_model(args, device)
    size = model.input_size
    coder = model.coder()
    main_rank = parallel.is_main()
    log_dir = run_log_dir(args)
    model_name = args.model.upper()
    config = dict(vars(args))
    if main_rank:
        checkpoint.save_manifest(log_dir, {
            "localizer": {"model": model_name, "kwargs": {"n_fg_class": 1}},
            "snapshot_names": [model_name],
            "config": config,
        })
    state = create_ssd_train_state(model, args.learning_rate)
    if args.pretrained_model:
        checkpoint.restore_params(args.pretrained_model, model)

    use_device_data = args.device_data == "on" or (args.device_data == "auto" and _is_synthetic(args.train_file))
    val_ds = build_val(args, size)
    eval_batch_size = max(args.batch_size // 2, 1)
    if use_device_data:
        pool = build_pool(args, size)
        steps_per_call = args.steps_per_call or 8
        device_batches = device_chunk_batches(
            {"train": pool}, args.batch_size, steps_per_call, seed=args.seed, device=device)
        body = SSDPooledBody(coder, size, augment=not args.no_augment)
        step = functools.partial(pooled_step, steps_per_call=steps_per_call, body=body)
        print(f"data: pool on {device} {sum(a.nbytes for a in pool.values()) / 2**20:.1f} MiB (uint8 scenes)")
        val_batches = device_eval_batches(val_ds, eval_batch_size, device)

        def val_iter():
            return iter(val_batches)
    else:
        steps_per_call = 1
        loader = DataLoader(build_train(args, size, coder), args.batch_size, repeat=True,
                            num_workers=args.num_workers, seed=args.seed, shard=True)
        device_batches = device_prefetch(iter(loader), device)
        step = host_step
        val_loader = DataLoader(val_ds, eval_batch_size, shuffle=False, drop_last=True,
                                num_workers=args.num_workers)

        def val_iter():
            return images_to(val_loader, device, args.eval_batches)

    evaluator = SSDEvaluator(size, coder, max_batches=args.eval_batches)
    last_eval = [0]  # bucket 0 = before the first --eval-interval point

    def eval_fn(trainer, iteration):
        if not args.eval_interval:
            return {}
        bucket = iteration // args.eval_interval
        if bucket == last_eval[0]:
            return {}
        last_eval[0] = bucket
        return evaluator(trainer.loc_state, val_iter())

    hooks = []
    if args.plot_interval > 0 and main_rank:
        plot_img, plot_gt = val_ds.get_example(0)[:2]
        hooks.append(Hook(SSDPlotHook(evaluator, plot_img, plot_gt, log_dir), every=args.plot_interval,
                          at_zero=True, name="ssd_plotter"))

    trainer = Trainer(
        step,
        state,
        None,
        device_batches,
        log_dir,
        max_iterations=args.iterations,
        generator=torch.Generator(device=device).manual_seed(args.seed + 17),
        config=config,
        snapshot_interval=args.snapshot_interval,
        log_interval=args.log_interval,
        eval_fn=eval_fn,
        hooks=hooks,
        snapshot_names=(model_name,),
        steps_per_call=steps_per_call,
    )
    try:
        if args.resume:
            trainer.resume(loc_path=args.resume)
        parallel.replicate(trainer.loc_state.model)
        if main_rank:
            print(f"training {model_name} in {log_dir} on {device}, {parallel.world_size()} process(es)")
        trainer.run()
    finally:
        device_batches.close()
    print(f"done at iteration {trainer.iteration}; log dir: {log_dir}")
    return log_dir


if __name__ == "__main__":
    main()
