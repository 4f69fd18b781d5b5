"""Offline snapshot-sweep evaluation CLI (port of ``loans_tpu/cli/evaluate.py``).

    python -m loans_tpu_torch.cli.evaluate <gt> <log_dir> [prefix] --device cuda

Sweeps every ``<prefix>*.pt`` snapshot of a training log dir (a localizer's
or an SSD's; an SSD's prefix defaults to its model name, ``SSD300_``)
against a labeled dataset, resumably (scored snapshots are skipped;
``--force-reset`` starts again), then plots the metric curves and reports
the best snapshot. The flags and defaults are the JAX CLI's, plus
``--device`` (default ``cuda``; ``--device cpu`` runs the plain PyTorch
versions of the kernels). The ground truth is ``synthetic[:N]`` or a
labeled csv or json (``data.datasets.LabeledImageDataset``, resized to
the model's input size). Renders of an SSD log dir draw each detection's
score with Pillow's font: without Pillow they are refused by name.
"""

from __future__ import annotations

import argparse

import torch


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="evaluate localizer snapshots")
    p.add_argument("gt", help="labeled dataset (csv/json), or 'synthetic[:N]'")
    p.add_argument("model_dir", help="training log dir (with manifest.json)")
    p.add_argument("snapshot_prefix", nargs="?", default="Localizer_")
    p.add_argument("--batch-size", "-b", type=int, default=8, help="eval batch")
    p.add_argument("--iou-threshold", type=float, default=0.5)
    p.add_argument("--force-reset", action="store_true",
                   help="discard eval_results.json and re-evaluate all")
    p.add_argument("--assessor", "-a", action="store_true",
                   help="also score predicted crops with the assessor")
    p.add_argument("--save-predictions", default=None, metavar="DIR",
                   help="render per-sample predictions (+gt) to DIR/<iter>/")
    p.add_argument("--deteval", default=None, metavar="DIR",
                   help="write deteval XML per snapshot to DIR")
    p.add_argument("--num-workers", type=int, default=None)
    p.add_argument("--bn-warmup", type=int, default=0, metavar="N",
                   help="re-estimate BatchNorm running stats from N train-mode batches "
                   "before scoring each snapshot (rescues short runs with unwarmed stats)")
    p.add_argument("--seed", type=int, default=2,
                   help="seed for 'synthetic:N' gt (default 2 = the train CLI's val split, "
                   "seed+2 with seed 0)")
    p.add_argument("--synthetic-assets", type=int, default=0, metavar="N",
                   help="shared procedural asset world: N assets (0 = legacy per-dataset assets)")
    p.add_argument("--benchmark", choices=["default", "hard"], default="default",
                   help="synthetic world difficulty (must match the train run's --benchmark)")
    p.add_argument("--base-bboxes", default=None, metavar="JSON",
                   help="stamp sizes drawn from this bbox-annotation JSON's gt distribution "
                   "(must match the train run's --base-bboxes)")
    p.add_argument("--asset-seed", type=int, default=None,
                   help="asset-world seed; a train run with seed S and --synthetic-assets used "
                   "S + 9973 (default: --seed - 2 + 9973, the localizer val convention)")
    p.add_argument("--device", default="cuda", help="torch device to evaluate on (default cuda)")
    return p


def build_dataset(args, image_size):
    """The labeled scenes of ``args.gt``, as the JAX CLI builds them: a
    labeled csv or json resized to ``image_size``, or synthetic scenes (the
    same seed and asset-seed conventions)."""
    from loans_tpu_torch.cli.train_localizer import _is_synthetic, _synthetic_n
    from loans_tpu_torch.data.datasets import LabeledImageDataset
    from loans_tpu_torch.data.synthetic import SyntheticLocalizerDataset, load_base_bbox_sizes

    if not _is_synthetic(args.gt):
        return LabeledImageDataset(args.gt, image_size=tuple(image_size))

    asset_kw = {}
    if args.synthetic_assets:
        # the training CLI's val split: seed + 2, asset seed seed + 9973
        seed = args.asset_seed if args.asset_seed is not None else args.seed - 2 + 9973
        asset_kw = dict(asset_seed=seed, n_assets=args.synthetic_assets)
    if args.benchmark == "hard":
        asset_kw["hard"] = True
    if args.base_bboxes:
        asset_kw["base_bboxes"] = load_base_bbox_sizes(args.base_bboxes)
    return SyntheticLocalizerDataset(
        _synthetic_n(args.gt, 64), image_size=tuple(image_size), seed=args.seed, labeled=True, **asset_kw
    )


def main(argv=None):
    """Sweep; returns the ``EvalResults``."""
    from loans_tpu_torch.data.loader import DataLoader, padded_collate
    from loans_tpu_torch.evaluation.evaluator import SSD_RENDERS_REFUSED, Evaluator
    from loans_tpu_torch.insights.rendering import pillow_installed

    args = get_parser().parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda but torch.cuda.is_available() is false; pass --device cpu")
    evaluator = Evaluator(
        args.model_dir,
        snapshot_prefix=args.snapshot_prefix,
        iou_threshold=args.iou_threshold,
        force_reset=args.force_reset,
        use_assessor=args.assessor,
        device=args.device,
    )
    if evaluator.is_ssd and args.save_predictions and not pillow_installed():
        raise SystemExit(f"the port cannot run this: {SSD_RENDERS_REFUSED}")
    ds = build_dataset(args, evaluator.image_size)

    def batches_factory():
        return iter(DataLoader(ds, args.batch_size, shuffle=False, drop_last=True,
                               num_workers=args.num_workers, collate=padded_collate))

    evaluator.sweep(
        batches_factory,
        save_predictions=args.save_predictions,
        deteval_dir=args.deteval,
        bn_warmup=args.bn_warmup,
    )
    evaluator.plot()
    return evaluator.results


if __name__ == "__main__":
    main()
