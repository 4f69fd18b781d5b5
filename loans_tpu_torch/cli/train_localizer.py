"""Weakly supervised localizer+assessor training CLI (port of
``loans_tpu/cli/train_localizer.py``).

    python -m loans_tpu_torch.cli.train_localizer synthetic:512 synthetic:1024 synthetic:64 ...

The same flags, log dir and metric keys as the JAX package's CLI, plus
``--device`` (default ``cuda``; ``--device cpu`` runs the plain PyTorch
versions of the kernels). It builds the unlabeled train scenes, the
labeled assessor ("reference") crops and the labeled validation scenes,
each from ``synthetic[:N]`` or from files (an image list, a labeled csv,
a labeled csv or json: ``data.datasets``), and trains the localizer and
the assessor with two Adam(amsgrad) optimizers, evaluating mean IoU and
VOC mAP at every log interval. With device data (``--device-data on``, or
``auto`` when every split is synthetic) the datasets live in device
memory and each call runs K steps on batches gathered there
(``train.steps.pooled_step``); with ``--device-data off`` a thread-pooled
host loader (``--num-workers`` threads) decodes and resizes the files,
``data.loader.device_prefetch`` copies each batch to the device while the
step before it runs, and each call runs one step.
``<log_dir>/<timestamp>_<name>`` receives ``manifest.json``, the metrics
``log`` and ``<Name>_<iter>.pt`` snapshots, which
``inference.LocalizerInference`` serves.

``--plot-interval N`` runs the BBoxPlotter (``insights.bbox_plotter``) at
iteration 0 and every N iterations on ``--plot-image`` or the first val
scene, writing ``<log_dir>/bboxes/<iteration>.png`` and, with
``--send-bboxes HOST:PORT``, streaming each canvas to a progress server
(``cli.show_progress``); its caption needs Pillow, so without Pillow the
flag is refused by name. ``--profile START STEPS`` writes a
``torch.profiler`` trace of those iterations under ``<log_dir>/profile``
(``train.profiling.ProfileHook``). ``--dump-graph`` is refused
(``REFUSED``): the port has no graph to dump.

Data-parallel over N GPUs, one process each (``loans_tpu_torch.parallel``)::

    torchrun --standalone --nproc_per_node=N -m loans_tpu_torch.cli.train_localizer ...

``--batch-size`` is the global batch; it must divide by N. Each process
trains on ``cuda:LOCAL_RANK`` (``--device cpu``: gloo on the CPU) on its
slice of every batch, and rank 0 writes the log dir.
"""

from __future__ import annotations

import argparse
import datetime
import functools
import os
import time

import numpy as np
import torch

from loans_tpu_torch import parallel

# flag -> why the port refuses it
REFUSED = {
    "dump_graph": "--dump-graph writes the JAX step's StableHLO; the port has no graph to dump",
    "plot_pillow": "--plot-interval: the BBoxPlotter's caption is drawn with Pillow's font, and Pillow is not "
                   "installed",
    "plot_supervised": "--plot-interval with --supervised: the BBoxPlotter scores the crop with the assessor, "
                       "which --supervised does not train",
}


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="train a localizer with an assessor (LoANs, PyTorch/CUDA)"
    )
    p.add_argument("train_file", help="image list, or 'synthetic[:N]' for generated scenes")
    p.add_argument("reference_file", help="IoU-labeled csv, or 'synthetic[:N]' for generated crops")
    p.add_argument("val_file", help="labeled csv/json, or 'synthetic[:N]' for generated labeled scenes")
    p.add_argument("--batch-size", "-b", type=int, default=16)
    p.add_argument("--target-size", type=int, nargs=2, default=[224, 224], help="input size (h w)")
    p.add_argument("--crop-size", type=int, nargs=2, default=[75, 75], help="assessor crop size (h w)")
    p.add_argument("--n-layers", type=int, default=50, choices=[18, 34, 50], help="localizer backbone depth")
    p.add_argument("--learning-rate", "-lr", type=float, default=1e-3)
    p.add_argument("--epochs", "-e", type=int, default=0, help="epochs over the train set (0 = use --iterations)")
    p.add_argument("--iterations", "-it", type=int, default=1000)
    p.add_argument("--log-dir", "-l", default="logs")
    p.add_argument("--log-name", "-ln", default="training")
    p.add_argument("--log-interval", type=int, default=100)
    p.add_argument("--snapshot-interval", "-si", type=int, default=1000)
    p.add_argument("--keep-snapshots", type=int, default=0, help="keep only the N newest snapshots (0 = all)")
    p.add_argument("--localizer-target", type=float, default=1.0)
    p.add_argument("--supervised", action="store_true",
                   help="train the localizer directly on gt boxes; no assessor")
    p.add_argument("--resume-localizer", "-rl", default=None)
    p.add_argument("--resume-discriminator", "-rd", default=None,
                   help="resume the assessor AND freeze it (reference --rd)")
    p.add_argument("--no-freeze", action="store_true", help="do not freeze the assessor when resuming it")
    p.add_argument("--pretrained-model", default=None,
                   help="a port .pt snapshot whose backbone is loaded (head skipped)")
    p.add_argument("--rotation-dropout-ratio", type=float, default=0.0)
    p.add_argument("--assessor-refresh", type=int, default=0, metavar="N",
                   help="regenerate the synthetic assessor pool every ~N iterations in a "
                   "background thread (0 = fixed pool)")
    p.add_argument("--assessor-ema", type=float, default=0.0, metavar="DECAY",
                   help="score the localizer against an EMA of the assessor params (0 = live params)")
    p.add_argument("--assessor-ema-start", type=int, default=0, metavar="ITER",
                   help="iteration at which --assessor-ema starts accumulating")
    p.add_argument("--assessor-low-iou", type=float, default=0.0, metavar="FRAC",
                   help="fraction of synthetic assessor crops drawn as unconstrained random crops")
    p.add_argument("--assessor-augment", action="store_true",
                   help="on-device flip/photometric augmentation of the assessor's labeled crops")
    p.add_argument("--synthetic-cache", default=None, metavar="DIR",
                   help="disk-cache generated synthetic datasets in DIR, keyed by their config")
    p.add_argument("--synthetic-assets", type=int, default=0, metavar="N",
                   help="share ONE procedural asset world (N stamps + N backgrounds) across the "
                   "synthetic datasets (0 = per-dataset assets, 16 each)")
    p.add_argument("--benchmark", choices=["default", "hard"], default="default",
                   help="synthetic world: 'hard' adds distractors, cluttered backgrounds and wider "
                   "stamp scales")
    p.add_argument("--base-bboxes", default=None, metavar="JSON",
                   help="bbox-annotation json; stamps take the real gt box-size distribution")
    p.add_argument("--assessor-pipeline", choices=["pil", "stn"], default="pil",
                   help="render synthetic assessor crops as the reference tool does ('pil', "
                   "Pillow's arithmetic) or with the localizer's own crop ('stn', K1 on the card)")
    p.add_argument("--grayscale-rois", action="store_true")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute (convs AND batchnorm outputs; params, optimizer and the "
                   "crop stay float32)")
    p.add_argument("--bn-f32", action="store_true", help="keep BatchNorm outputs float32 under --bf16")
    p.add_argument("--plot-image", default=None, help="image rendered by the BBoxPlotter (default: val scene 0)")
    p.add_argument("--plot-interval", type=int, default=0, help="BBoxPlotter cadence (0 = off; reference: 1)")
    p.add_argument("--send-bboxes", default=None, metavar="HOST:PORT",
                   help="stream the BBoxPlotter's canvases to a show_progress viewer")
    p.add_argument("--interactive", action="store_true", help="stdin REPL (shiftlr/setlr/quit/...)")
    p.add_argument("--eval-bn-warmup", type=int, default=0, metavar="N",
                   help="re-estimate BatchNorm stats from N val batches before each in-training eval")
    p.add_argument("--eval-batches", type=int, default=8, help="bounded in-training eval")
    p.add_argument("--num-workers", type=int, default=None, help="host loader threads (--device-data off)")
    p.add_argument("--device-data", choices=["auto", "on", "off"], default="auto",
                   help="keep the datasets in device memory and gather batches by index "
                   "(auto: on when every split is synthetic; off: the host loader)")
    p.add_argument("--steps-per-call", type=int, default=0,
                   help="train iterations per step call with device data (0 = 8; 1 without)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--lr-shift", type=float, nargs=4, default=None,
                   metavar=("START_LR", "TARGET_LR", "START_IT", "END_IT"),
                   help="piecewise-linear LR schedule")
    p.add_argument("--lr-decay", type=float, nargs=2, default=None, metavar=("FACTOR", "EVERY"),
                   help="multiply LR by FACTOR every EVERY iterations")
    p.add_argument("--dump-graph", action="store_true", help="not ported (a JAX StableHLO dump)")
    p.add_argument("--profile", type=int, nargs=2, default=None, metavar=("START", "STEPS"),
                   help="write a torch.profiler trace of STEPS iterations from START to <log_dir>/profile")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default cuda; under torchrun cuda:LOCAL_RANK)")
    return p


def start_devices(args) -> torch.device:
    """The device of this process, after the process group of ``torchrun``
    (if any) is up: ``--device``, ``cuda:LOCAL_RANK`` under ``torchrun``.
    Refuses a missing card and a global batch that the world size does
    not divide, in the JAX CLI's words."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda but torch.cuda.is_available() is false; pass --device cpu")
    device = parallel.bind_device(device)
    world = parallel.world_size()
    if args.batch_size % world:
        raise SystemExit(f"--batch-size {args.batch_size} not divisible by {world} devices")
    return device


def run_log_dir(args) -> str:
    """``<log_dir>/<timestamp>_<log_name>``, rank 0's timestamp on every
    rank; rank 0 creates it."""
    timestamp = parallel.broadcast_object(datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S"))
    log_dir = os.path.join(args.log_dir, f"{timestamp}_{args.log_name}")
    if parallel.is_main():
        os.makedirs(log_dir, exist_ok=True)
    return log_dir


def _is_synthetic(spec: str) -> bool:
    return spec.startswith("synthetic") or spec == "mnist"


def _synthetic_n(spec: str, default: int) -> int:
    if ":" in spec:
        return int(spec.split(":", 1)[1])
    return default


def refusals(args) -> list[str]:
    """Why this run cannot be served by the port (empty when it can)."""
    from loans_tpu_torch.insights.rendering import pillow_installed

    out = []
    if args.dump_graph:
        out.append(REFUSED["dump_graph"])
    if args.plot_interval > 0 and not pillow_installed():
        out.append(REFUSED["plot_pillow"])
    if args.plot_interval > 0 and args.supervised:
        out.append(REFUSED["plot_supervised"])
    return out


def uses_device_data(args) -> bool:
    """The JAX CLI's rule: ``on``, or ``auto`` when every split this run
    reads is ``synthetic[:N]``."""
    synthetic = (_is_synthetic(args.train_file) and _is_synthetic(args.val_file)
                 and (args.supervised or _is_synthetic(args.reference_file)))
    return args.device_data == "on" or (args.device_data == "auto" and synthetic)


def build_asset_kw(args):
    """Synthetic-world kwargs (asset seed, hard mode, base bboxes), one
    function for every synthetic dataset of a run, so a flag never applies
    to one split and not another."""
    from loans_tpu_torch.data.synthetic import load_base_bbox_sizes

    asset_kw = {}
    if args.synthetic_assets:
        asset_kw = dict(asset_seed=args.seed + 9973, n_assets=args.synthetic_assets)
    if args.benchmark == "hard":
        asset_kw["hard"] = True
    if args.base_bboxes:
        asset_kw["base_bboxes"] = load_base_bbox_sizes(args.base_bboxes)
    return asset_kw


def _timed(what: str, build):
    start = time.perf_counter()
    out = build()
    print(f"data: {what} in {time.perf_counter() - start:.2f} s (host)")
    return out


def build_datasets(args):
    """(train scenes, reference crops, labeled val scenes), as the JAX
    CLI builds them: ``synthetic[:N]`` with the same seeds, cache keys and
    worlds (uint8), or files (float32 in [0, 1]: an image list resized to
    ``--target-size``, an IoU-labeled csv resized to ``--crop-size``, a
    labeled csv or json resized to ``--target-size``)."""
    from loans_tpu_torch.data.datasets import ImageDataset, LabeledImageDataset, read_labeled_csv
    from loans_tpu_torch.data.synthetic import (
        SyntheticAssessorDataset,
        SyntheticLocalizerDataset,
        cached_synthetic,
    )

    img = tuple(args.target_size)
    crop = tuple(args.crop_size)
    asset_kw = build_asset_kw(args)
    key_kw = {k: str(v) for k, v in asset_kw.items()}
    cache = args.synthetic_cache
    if _is_synthetic(args.train_file):
        n_train = _synthetic_n(args.train_file, 512)
        train = _timed(f"{n_train} train scenes", lambda: cached_synthetic(
            cache, "scenes",
            lambda items: SyntheticLocalizerDataset(
                n_train, image_size=img, seed=args.seed, output_dtype="uint8", items=items, **asset_kw,
            ),
            n=n_train, image_size=list(img), seed=args.seed, labeled=False, **key_kw,
        ))
    else:
        train = ImageDataset(args.train_file, image_size=img, seed=args.seed)
    if _is_synthetic(args.reference_file):
        n_ref = _synthetic_n(args.reference_file, 1024)
        pipeline = args.assessor_pipeline
        reference = _timed(f"{n_ref} reference crops ({pipeline})", lambda: cached_synthetic(
            cache, "crops",
            lambda items: SyntheticAssessorDataset(
                n_ref, output_size=crop, image_size=img, seed=args.seed + 1, output_dtype="uint8",
                crop_pipeline=pipeline, low_iou_fraction=args.assessor_low_iou, items=items,
                device=args.device, **asset_kw,
            ),
            n=n_ref, crop=list(crop), image_size=list(img), seed=args.seed + 1, pipeline=pipeline,
            low_iou=args.assessor_low_iou, **key_kw,
        ))
    else:
        reference = LabeledImageDataset(read_labeled_csv(args.reference_file), image_size=crop)
    if _is_synthetic(args.val_file):
        n_val = _synthetic_n(args.val_file, 64)
        val = _timed(f"{n_val} val scenes", lambda: cached_synthetic(
            cache, "scenes",
            lambda items: SyntheticLocalizerDataset(
                n_val, image_size=img, seed=args.seed + 2, labeled=True, output_dtype="uint8",
                items=items, **asset_kw,
            ),
            n=n_val, image_size=list(img), seed=args.seed + 2, labeled=True, **key_kw,
        ))
    else:
        val = LabeledImageDataset(args.val_file, image_size=img)
    return train, reference, val


def build_supervised_datasets(args):
    """(labeled train scenes, labeled val scenes) for ``--supervised``."""
    from loans_tpu_torch.data.datasets import LabeledImageDataset
    from loans_tpu_torch.data.synthetic import SyntheticLocalizerDataset

    if _is_synthetic(args.train_file):
        n_train = _synthetic_n(args.train_file, 512)
        train = _timed(f"{n_train} labeled train scenes", lambda: SyntheticLocalizerDataset(
            n_train, image_size=tuple(args.target_size), seed=args.seed, labeled=True,
            output_dtype="uint8", **build_asset_kw(args),
        ))
    else:
        train = LabeledImageDataset(args.train_file, image_size=tuple(args.target_size))
    # the assessor's reference set is not used: generate one crop
    val_args = argparse.Namespace(**vars(args))
    val_args.reference_file = "synthetic:1"
    _, _, val = build_datasets(val_args)
    return train, val


def _dtypes(args) -> tuple[torch.dtype, torch.dtype]:
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    norm_dtype = torch.float32 if (args.bn_f32 or not args.bf16) else dtype
    return dtype, norm_dtype


def build_states(args, device: torch.device):
    """The localizer's and the assessor's train states on ``device``, the
    models' parameters drawn from ``--seed``."""
    from loans_tpu_torch.models import Localizer, ResnetAssessor
    from loans_tpu_torch.ops.geometry import Size
    from loans_tpu_torch.train import create_train_state

    dtype, norm_dtype = _dtypes(args)
    torch.manual_seed(args.seed)
    localizer = Localizer(
        out_size=Size(*args.crop_size),
        n_layers=args.n_layers,
        input_size=Size(*args.target_size),
        rotation_dropout_ratio=args.rotation_dropout_ratio,
        transform_rois_to_grayscale=args.grayscale_rois,
        dtype=dtype,
        norm_dtype=norm_dtype,
    )
    assessor = ResnetAssessor(
        in_size=Size(*args.crop_size), in_ch=1 if args.grayscale_rois else 3, dtype=dtype
    )
    return (
        create_train_state(localizer.to(device), args.learning_rate),
        create_train_state(assessor.to(device), args.learning_rate),
    )


def manifest(args) -> dict:
    """The log dir's ``manifest.json``: the JAX CLI's, with this run's
    flags (``--device`` among them) as ``config``."""
    return {
        "localizer": {
            "model": "Localizer",
            "kwargs": {
                "out_size": list(args.crop_size),
                "n_layers": args.n_layers,
                "input_size": list(args.target_size),
                "rotation_dropout_ratio": args.rotation_dropout_ratio,
                "transform_rois_to_grayscale": args.grayscale_rois,
            },
        },
        "assessor": {"model": "ResnetAssessor", "kwargs": {}},
        "snapshot_names": ["Localizer", "ResnetAssessor"],
        "config": dict(vars(args)),
    }


def _device_pools(args, train_ds, ref_ds, steps_per_call: int, device: torch.device):
    """``--device-data on``: the datasets (synthetic or files) materialized
    into pools on ``device``, chunks of ``steps_per_call`` index batches
    (``data.device_data.device_chunk_batches``); a synthetic reference pool
    regenerated every ``--assessor-refresh`` iterations."""
    from loans_tpu_torch.data.device_data import device_chunk_batches, materialize
    from loans_tpu_torch.data.synthetic import SyntheticAssessorDataset

    refresh = None
    if ref_ds is None:
        images, boxes, scores = materialize(train_ds)
        groups = {"train": {"images": images, "boxes": boxes, "scores": scores}}
    else:
        crops, labels = materialize(ref_ds)[:2]
        groups = {
            "unlabeled": {"unlabeled": materialize(train_ds)[0]},
            "reference": {"real": crops, "labels": labels},
        }
        if args.assessor_refresh and _is_synthetic(args.reference_file):
            n_ref = _synthetic_n(args.reference_file, 1024)
            asset_kw_refresh = build_asset_kw(args)

            def regen_reference(generation: int):
                ds = SyntheticAssessorDataset(
                    n_ref, output_size=tuple(args.crop_size), image_size=tuple(args.target_size),
                    seed=args.seed + 1 + 104729 * generation, output_dtype="uint8",
                    crop_pipeline=args.assessor_pipeline, low_iou_fraction=args.assessor_low_iou,
                    device=device, **asset_kw_refresh,
                )
                c, lb = materialize(ds)[:2]
                return {"real": c, "labels": lb}

            refresh = {"reference": (regen_reference, max(args.assessor_refresh // steps_per_call, 1))}
    pool_mib = sum(a.nbytes for tree in groups.values() for a in tree.values()) / 2**20
    print(f"data: pools on {device} {pool_mib:.1f} MiB")
    return device_chunk_batches(groups, args.batch_size, steps_per_call, seed=args.seed, device=device,
                                refresh=refresh)


def _host_batches(args, train_ds, ref_ds):
    """``--device-data off``: host batches from ``DataLoader``s that repeat
    (``--num-workers`` threads, epochs shuffled from ``--seed``): the
    labeled train batches (``--supervised``), or the train and reference
    streams zipped into ``{'real', 'labels', 'unlabeled'}``, as the JAX
    CLI zips them."""
    from loans_tpu_torch.data.loader import DataLoader

    loader_kw = dict(repeat=True, num_workers=args.num_workers, seed=args.seed, shard=True)
    train_loader = DataLoader(train_ds, args.batch_size, **loader_kw)
    if ref_ds is None:
        yield from train_loader
        return
    ref_loader = DataLoader(ref_ds, args.batch_size, **loader_kw)
    for unlabeled, ref in zip(train_loader, ref_loader):
        if isinstance(unlabeled, tuple):
            unlabeled = unlabeled[0]
        yield {"real": ref[0], "labels": ref[1], "unlabeled": unlabeled}


def build_hooks(args, val_ds, log_dir: str) -> list:
    """The BBoxPlotter (``--plot-interval``, at iteration 0 too) and the
    profiler (``--profile``) as the JAX CLI wires them."""
    from loans_tpu_torch.train import Hook

    hooks = []
    if args.plot_interval > 0:
        from loans_tpu_torch.insights.bbox_plotter import BBoxPlotter

        gt = None
        if args.plot_image:
            from loans_tpu_torch.data.datasets import load_image, resize_image

            plot_img = resize_image(load_image(args.plot_image), tuple(args.target_size)) / 255.0
        else:
            plot_img, gt_box = val_ds.get_example(0)[:2]
            gt = np.asarray(gt_box).reshape(-1, 4)
        send_to = None
        if args.send_bboxes:
            host, port = args.send_bboxes.rsplit(":", 1)
            send_to = (host, int(port))
        plotter = BBoxPlotter(plot_img, log_dir, gt_bbox=gt, send_to=send_to)
        hooks.append(Hook(plotter, every=args.plot_interval, at_zero=True, name="bbox_plotter"))
    if args.profile:
        from loans_tpu_torch.train.profiling import ProfileHook

        hooks.append(Hook(ProfileHook(log_dir, args.profile[0], args.profile[1]), every=1, name="profiler"))
    return hooks


def main(argv=None) -> str:
    """Train; returns the run's log dir."""
    args = get_parser().parse_args(argv)
    refused = refusals(args)
    if refused:
        raise SystemExit("the port cannot run this: " + "; ".join(refused))
    with parallel.process_group(torch.device(args.device).type):
        return train(args, start_devices(args))


def train(args, device: torch.device) -> str:
    """The training run of ``main`` on ``device``."""
    from loans_tpu_torch.data.device_data import device_eval_batches
    from loans_tpu_torch.data.loader import DataLoader, device_prefetch, images_to, padded_collate
    from loans_tpu_torch.evaluation import MAPEvaluator
    from loans_tpu_torch.inference.localizer import set_precision
    from loans_tpu_torch.ops.geometry import Size
    from loans_tpu_torch.train import (
        AlternatingConfig,
        CommandChannel,
        Trainer,
        alternating_step,
        checkpoint,
        multiplicative_lr_decay,
        pooled_step,
        supervised_step,
        two_state_lr_shifter,
    )

    set_precision()
    img = Size(*args.target_size)
    main_rank = parallel.is_main()
    log_dir = run_log_dir(args)

    # -- models + states ---------------------------------------------------
    loc_state, ass_state = build_states(args, device)
    if args.assessor_ema:
        ass_state = ass_state.with_ema()
    if args.pretrained_model:
        checkpoint.restore_params(args.pretrained_model, loc_state.model, skip_prefixes=("param_predictor",))
    config = dict(vars(args))
    if main_rank:
        checkpoint.save_manifest(log_dir, manifest(args))

    # -- data --------------------------------------------------------------
    if args.supervised:
        train_ds, val_ds = build_supervised_datasets(args)
        ass_state = None
    else:
        train_ds, ref_ds, val_ds = build_datasets(args)
    device_data = uses_device_data(args)
    steps_per_call = (args.steps_per_call or 8) if device_data else 1
    if device_data:
        device_batches = _device_pools(args, train_ds, None if args.supervised else ref_ds, steps_per_call, device)
    else:
        device_batches = device_prefetch(_host_batches(args, train_ds, None if args.supervised else ref_ds),
                                         device)

    # -- eval --------------------------------------------------------------
    eval_batch_size = max(args.batch_size // 2, 1)
    map_eval = MAPEvaluator(img, max_batches=args.eval_batches, bn_warmup=args.eval_bn_warmup)
    if device_data:
        val_batches = device_eval_batches(val_ds, eval_batch_size, device)
        if args.eval_batches:
            val_batches = val_batches[: args.eval_batches]

        def eval_fn(trainer, iteration):
            return map_eval(trainer.loc_state, iter(val_batches))
    else:
        val_loader = DataLoader(val_ds, eval_batch_size, shuffle=False, drop_last=True,
                                num_workers=args.num_workers, collate=padded_collate)

        def eval_fn(trainer, iteration):
            return map_eval(trainer.loc_state, images_to(val_loader, device, args.eval_batches))

    # -- iterations and the step -------------------------------------------
    iterations = args.iterations
    if args.epochs:
        iterations = args.epochs * (len(train_ds) // args.batch_size)
    step_config = AlternatingConfig(
        localizer_target=args.localizer_target,
        freeze_assessor=bool(args.resume_discriminator) and not args.no_freeze,
        image_size=img,
        augment_reference=args.assessor_augment,
        assessor_ema=args.assessor_ema,
        assessor_ema_start=args.assessor_ema_start,
    )
    body = supervised_step if args.supervised else alternating_step
    if device_data:
        step = functools.partial(pooled_step, steps_per_call=steps_per_call, config=step_config, body=body)
    else:
        step = functools.partial(body, config=step_config)
    lr_schedule = None
    if args.lr_shift:
        lr_schedule = two_state_lr_shifter(
            args.lr_shift[0], args.lr_shift[1], int(args.lr_shift[2]), int(args.lr_shift[3])
        )
    elif args.lr_decay:
        lr_schedule = multiplicative_lr_decay(args.lr_decay[0], int(args.lr_decay[1]), args.learning_rate)
    trainer = Trainer(
        step,
        loc_state,
        ass_state,
        device_batches,
        log_dir,
        max_iterations=iterations,
        generator=torch.Generator(device=device).manual_seed(args.seed + 17),
        config=config,
        snapshot_interval=args.snapshot_interval,
        log_interval=args.log_interval,
        eval_fn=eval_fn,
        lr_schedule=lr_schedule,
        hooks=build_hooks(args, val_ds, log_dir) if main_rank else (),
        control=CommandChannel(log_dir, use_stdin=args.interactive) if main_rank else None,
        keep_snapshots=args.keep_snapshots,
        steps_per_call=steps_per_call,
    )
    try:
        trainer.resume(args.resume_localizer, args.resume_discriminator)
        for state in (trainer.loc_state, trainer.ass_state):
            if state is not None:
                parallel.replicate(state.model)
        if args.assessor_ema and trainer.ass_state is not None:
            # the EMA copy is not in snapshots: start it from the restored
            # live parameters
            trainer.ass_state = trainer.ass_state.with_ema()
        if main_rank:
            print(f"training in {log_dir} on {device}, {parallel.world_size()} process(es)")
        trainer.run()
    finally:
        device_batches.close()  # waits for a running pool refresh
    print(f"done at iteration {trainer.iteration}; log dir: {log_dir}")
    return log_dir


if __name__ == "__main__":
    main()
