"""Offline dataset and snapshot tools (port of
``loans_tpu/cli/dataset_tools.py``).

    python -m loans_tpu_torch.cli.dataset_tools <cmd> ...

The eleven subcommands of the JAX package's CLI, with the same names and
flags:

* ``paste_and_crop``: the assessor-data compositor
  (``data.synthetic.generate_dataset``): ``images/<i>.png`` and a
  tab-separated ``images.csv`` of IoU labels;
* ``extract_frames``: a video to ``<i:06d>.png`` frames and ``gt.csv``,
  decoded with cv2, resized with Pillow's LANCZOS in numpy
  (``data.image_ops``), written by the port's PNG writer;
* ``blend_videos``: alpha-blend two equal-length videos (cv2);
* ``filter_single``: keep only the single-box entries of a gt json;
* ``label_histogram`` and ``plot_log``: a histogram of IoU labels and a
  training log's metric curves (matplotlib);
* ``strip_params``, ``average_snapshots`` (SWA) and ``convert_snapshot``:
  edits of the port's ``.pt`` snapshots (``train.checkpoint``);
* ``generate_scenes``: stamps pasted into annotated background boxes,
  ``train_info.json`` / ``test_info.json``, Pillow's masked paste in numpy.

cv2 and matplotlib are imported by the subcommands that need them, which
are refused by name where they are not installed; none needs Pillow (other
image formats than PNG go through ``data.datasets.load_image``, which
reads them with Pillow where it is installed) or a card.
"""

from __future__ import annotations

import argparse
import csv
import importlib
import json
import os

import numpy as np
import torch


def _require(module: str, what: str):
    """``module``, or a ``SystemExit`` that names ``what`` needs it."""
    library = {"cv2": "OpenCV (cv2)", "matplotlib.pyplot": "matplotlib"}[module]
    try:
        if module == "matplotlib.pyplot":
            importlib.import_module("matplotlib").use("Agg")
        return importlib.import_module(module)
    except ImportError:
        raise SystemExit(f"{what} needs {library}, which is not installed") from None


def _load(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


def _params(payload: dict) -> dict:
    """The model ``state_dict`` of a snapshot: a training snapshot's
    ``params``, or the payload of a ``save_params`` file."""
    from loans_tpu_torch.train.checkpoint import _is_training_snapshot

    return payload["params"] if _is_training_snapshot(payload) else payload


def cmd_paste_and_crop(args):
    from loans_tpu_torch.data.synthetic import generate_dataset

    out = generate_dataset(
        args.destination,
        args.num_samples,
        stamps=args.stamps,
        background_dir=args.backgrounds,
        image_size=tuple(args.image_size),
        output_size=tuple(args.output_size),
        zoom_mode=not args.no_zoom,
        seed=args.seed,
        low_iou_fraction=args.low_iou,
        base_bboxes=args.base_bboxes,
    )
    print(f"wrote {out}")


def cmd_extract_frames(args):
    from loans_tpu_torch.data import image_ops
    from loans_tpu_torch.insights.rendering import write_png

    cv2 = _require("cv2", "extract_frames (decoding the video)")
    os.makedirs(args.destination, exist_ok=True)
    cap = cv2.VideoCapture(args.video)
    if not cap.isOpened():
        raise SystemExit(f"could not open {args.video}")
    paths = []
    i = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        img = np.ascontiguousarray(np.asarray(frame)[..., ::-1])  # BGR -> RGB
        if args.resize:
            h, w = img.shape[:2]
            scale = args.resize / max(w, h)
            img = image_ops.resize(img, (int(w * scale), int(h * scale)), "lanczos")
        name = f"{i:06d}.png"
        write_png(os.path.join(args.destination, name), img)
        paths.append(name)
        i += 1
    cap.release()
    with open(os.path.join(args.destination, "gt.csv"), "w") as f:
        csv.writer(f, delimiter="\t").writerows([[p] for p in paths])
    print(f"extracted {i} frames to {args.destination}")


def cmd_blend_videos(args):
    cv2 = _require("cv2", "blend_videos")
    cap1, cap2 = cv2.VideoCapture(args.video1), cv2.VideoCapture(args.video2)
    n1 = int(cap1.get(cv2.CAP_PROP_FRAME_COUNT))
    n2 = int(cap2.get(cv2.CAP_PROP_FRAME_COUNT))
    if n1 != n2:
        raise SystemExit(f"frame counts differ: {n1} vs {n2}")
    fps = cap1.get(cv2.CAP_PROP_FPS) or 24.0
    w = int(cap1.get(cv2.CAP_PROP_FRAME_WIDTH))
    h = int(cap1.get(cv2.CAP_PROP_FRAME_HEIGHT))
    writer = cv2.VideoWriter(
        args.output, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h)
    )
    n = 0
    while True:
        ok1, f1 = cap1.read()
        ok2, f2 = cap2.read()
        if not (ok1 and ok2):
            break
        if f2.shape != f1.shape:
            f2 = cv2.resize(f2, (w, h))
        writer.write(
            cv2.addWeighted(f1, args.alpha, f2, 1.0 - args.alpha, 0)
        )
        n += 1
    for c in (cap1, cap2, writer):
        c.release()
    print(f"blended {n} frames -> {args.output}")


def cmd_filter_single(args):
    with open(args.gt) as f:
        data = json.load(f)
    kept = [d for d in data if len(d.get("bounding_boxes", [])) == 1]
    with open(args.output, "w") as f:
        json.dump(kept, f, indent=2)
    print(f"kept {len(kept)}/{len(data)} single-bbox entries")


def cmd_label_histogram(args):
    plt = _require("matplotlib.pyplot", "label_histogram")
    labels = []
    with open(args.csv) as f:
        for row in csv.reader(f, delimiter="\t"):
            if len(row) > 1:
                labels.append(float(row[1]))
    fig, ax = plt.subplots()
    ax.hist(labels, bins=args.bins)
    ax.set_xlabel("IoU label")
    fig.savefig(args.output, dpi=120)
    print(f"{len(labels)} labels -> {args.output}")


def cmd_strip_params(args):
    """Delete the entries under each prefix (a module path, ``.`` or ``/``
    joined, as ``checkpoint.restore_params`` takes it: ``param_predictor``
    strips ``param_predictor.weight`` and ``.bias``) from the model
    ``state_dict`` of a snapshot, a training snapshot's ``params`` or a
    ``save_params`` file; everything else stays as it is."""
    payload = _load(args.snapshot)
    params = _params(payload)
    prefixes = tuple(p.replace("/", ".") for p in args.prefixes if p)
    for key in [k for k in params if any(k == p or k.startswith(p + ".") for p in prefixes)]:
        del params[key]
    torch.save(payload, args.output)
    print(f"wrote {args.output} (stripped {args.prefixes})")


def cmd_average_snapshots(args):
    """Average the weights of several training snapshots (SWA).

    Each floating tensor of the model ``state_dict`` (BatchNorm's
    ``running_mean`` and ``running_var`` among them, as JAX averages its
    ``batch_stats``) is summed in float64 over the snapshots in iteration
    order and divided by their count, then cast back. Integer buffers
    (``num_batches_tracked``), the step and the optimizer state come from
    the last snapshot, so the strict ``checkpoint.restore_state`` still
    loads the file. BatchNorm statistics are best re-estimated afterwards
    (the evaluator's ``--bn-warmup``). The default output,
    ``<prefix>swa.pt``, lies outside the numbered-snapshot namespace, so it
    never becomes a log dir's latest snapshot; ``--out-iteration N`` writes
    ``<prefix>N.pt``, which the resumable sweep then picks up.
    """
    from loans_tpu_torch.train import checkpoint

    snaps = checkpoint.list_snapshots(args.log_dir, args.prefix)
    snaps = [
        (it, p)
        for it, p in snaps
        if it >= args.min_iteration
        and (args.max_iteration is None or it <= args.max_iteration)
    ]
    if len(snaps) < 2:
        raise SystemExit(
            f"need >=2 snapshots with prefix {args.prefix!r} in "
            f"[{args.min_iteration}, {args.max_iteration}], "
            f"found {len(snaps)}"
        )
    acc: dict[str, torch.Tensor] = {}
    payload = None
    for _, path in snaps:
        payload = _load(path)
        for key, value in _params(payload).items():
            if value.is_floating_point():
                value = value.to(torch.float64)
                acc[key] = acc[key] + value if key in acc else value
    n = len(snaps)
    params = _params(payload)
    for key, value in params.items():
        if value.is_floating_point():
            params[key] = (acc[key] / n).to(value.dtype)

    if args.output:
        out = args.output
    elif args.out_iteration is not None:
        out = os.path.join(args.log_dir, f"{args.prefix}{args.out_iteration}.pt")
    else:
        out = os.path.join(args.log_dir, f"{args.prefix}swa.pt")
    tmp = out + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, out)
    print(
        f"wrote SWA of {n} snapshots "
        f"({snaps[0][0]}..{snaps[-1][0]}) -> {out}"
    )


def cmd_plot_log(args):
    """Plot train/eval metric curves from a training log."""
    from loans_tpu_torch.train.logger import MetricsLog

    plt = _require("matplotlib.pyplot", "plot_log")
    entries = MetricsLog.read(args.log)
    entries = [e for e in entries if "iteration" in e]
    if not entries:
        raise SystemExit("no metric entries in log")
    keys = args.keys or [
        k
        for k in entries[-1]
        if k not in ("iteration", "elapsed_time", "lr")
        and isinstance(entries[-1][k], (int, float))
    ]
    n = len(keys)
    fig, axes = plt.subplots(
        (n + 1) // 2, 2, figsize=(11, 3 * ((n + 1) // 2)), squeeze=False
    )
    its = [e["iteration"] for e in entries]
    for ax, key in zip(axes.flat, keys):
        ax.plot(its, [e.get(key, float("nan")) for e in entries])
        ax.set_title(key)
        ax.set_xlabel("iteration")
    fig.tight_layout()
    fig.savefig(args.output, dpi=120)
    print(f"plotted {keys} -> {args.output}")


def cmd_convert_snapshot(args):
    """Training snapshot -> model-only snapshot: its ``state_dict`` (the
    JAX package's params and batch_stats), without the step and the
    optimizer state, as ``checkpoint.save_params`` writes it."""
    from loans_tpu_torch.train import checkpoint

    checkpoint.save_params(args.output, _params(_load(args.snapshot)))
    print(f"wrote model-only snapshot {args.output}")


def cmd_generate_scenes(args):
    """Paste stamps into annotated background boxes, emit
    ``train_info.json``/``test_info.json`` (fixed seed). The draws, the
    pixels and the records are the JAX package's: one ``choice`` of a
    stamp per box, LANCZOS-resized as RGBA and pasted through its own
    alpha, boxes of a non-positive side skipped, the records shuffled."""
    import random

    from loans_tpu_torch.data import image_ops
    from loans_tpu_torch.data.datasets import load_image
    from loans_tpu_torch.insights.rendering import write_png

    with open(args.annotations) as f:
        backgrounds = json.load(f)
    stamps = [load_image(s, "RGBA") for s in args.stamps]
    rng = random.Random(args.seed)
    os.makedirs(os.path.join(args.destination, "images"), exist_ok=True)
    records = []
    idx = 0
    for bg_entry in backgrounds:
        bg = load_image(bg_entry["image"], "RGB")
        for _ in range(args.per_background):
            canvas = bg.copy()
            boxes = []
            for y1, x1, y2, x2 in bg_entry.get("bounding_boxes", []):
                stamp = rng.choice(stamps)
                w, h = int(x2 - x1), int(y2 - y1)
                if w <= 0 or h <= 0:
                    continue
                resized = image_ops.resize(stamp, (w, h), "lanczos")
                image_ops.paste(canvas, resized, (int(x1), int(y1)), mask=resized)
                boxes.append([float(y1), float(x1), float(y2), float(x2)])
            name = f"images/{idx}.png"
            write_png(os.path.join(args.destination, name), canvas)
            records.append({"image": name, "bounding_boxes": boxes})
            idx += 1
    rng.shuffle(records)
    split = int(len(records) * (1 - args.test_fraction))
    for fname, recs in (
        ("train_info.json", records[:split]),
        ("test_info.json", records[split:]),
    ):
        with open(os.path.join(args.destination, fname), "w") as f:
            json.dump(recs, f, indent=2)
    print(
        f"generated {len(records)} scenes "
        f"({split} train / {len(records) - split} test)"
    )


def get_parser():
    p = argparse.ArgumentParser(description="loans_tpu_torch dataset tools")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("paste_and_crop", help="synthesize assessor data")
    s.add_argument("--low-iou", type=float, default=0.0,
                   help="fraction of unconstrained random crops (mostly "
                   "IoU~0; object-free assessor coverage)")
    s.add_argument("destination")
    s.add_argument("num_samples", type=int)
    s.add_argument("--stamps", nargs="+", default=None)
    s.add_argument("--backgrounds", default=None)
    s.add_argument("--image-size", type=int, nargs=2, default=[224, 224])
    s.add_argument("--output-size", type=int, nargs=2, default=[75, 75])
    s.add_argument("--no-zoom", action="store_true")
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--base-bboxes", default=None, metavar="JSON",
                   help="bbox-annotation json; stamps are resized to the "
                   "real gt box-size distribution")
    s.set_defaults(fn=cmd_paste_and_crop)

    s = sub.add_parser("extract_frames", help="video -> frame PNGs + gt.csv")
    s.add_argument("video")
    s.add_argument("destination")
    s.add_argument("--resize", type=int, default=0,
                   help="longest-side resize")
    s.set_defaults(fn=cmd_extract_frames)

    s = sub.add_parser("blend_videos", help="alpha-blend two videos")
    s.add_argument("video1")
    s.add_argument("video2")
    s.add_argument("output")
    s.add_argument("--alpha", type=float, default=0.5)
    s.set_defaults(fn=cmd_blend_videos)

    s = sub.add_parser("filter_single", help="keep single-bbox gt entries")
    s.add_argument("gt")
    s.add_argument("output")
    s.set_defaults(fn=cmd_filter_single)

    s = sub.add_parser("label_histogram", help="IoU label histogram")
    s.add_argument("csv")
    s.add_argument("output")
    s.add_argument("--bins", type=int, default=17)
    s.set_defaults(fn=cmd_label_histogram)

    s = sub.add_parser("strip_params", help="delete param groups")
    s.add_argument("snapshot")
    s.add_argument("output")
    s.add_argument("--prefixes", nargs="+", default=["param_predictor"])
    s.set_defaults(fn=cmd_strip_params)

    s = sub.add_parser("average_snapshots",
                       help="SWA-average snapshot weights in a log dir")
    s.add_argument("log_dir")
    s.add_argument("--prefix", default="Localizer_")
    s.add_argument("--min-iteration", type=int, default=0)
    s.add_argument("--max-iteration", type=int, default=None)
    s.add_argument("--out-iteration", type=int, default=None,
                   help="write the output under this iteration number in "
                   "the numbered-snapshot namespace (default: "
                   "<prefix>swa.pt, OUTSIDE the namespace so the SWA "
                   "file never becomes the implicit latest snapshot)")
    s.add_argument("--output", default=None,
                   help="explicit output path (overrides naming scheme)")
    s.set_defaults(fn=cmd_average_snapshots)

    s = sub.add_parser("plot_log", help="plot metric curves from a log")
    s.add_argument("log", help="log file or training log dir")
    s.add_argument("output")
    s.add_argument("--keys", nargs="+", default=None)
    s.set_defaults(fn=cmd_plot_log)

    s = sub.add_parser("convert_snapshot",
                       help="strip optimizer state from a snapshot")
    s.add_argument("snapshot")
    s.add_argument("output")
    s.set_defaults(fn=cmd_convert_snapshot)

    s = sub.add_parser("generate_scenes",
                       help="paste stamps into annotated background bboxes")
    s.add_argument("annotations", help="json [{'image','bounding_boxes'}]")
    s.add_argument("destination")
    s.add_argument("--stamps", nargs="+", required=True)
    s.add_argument("--per-background", type=int, default=1)
    s.add_argument("--test-fraction", type=float, default=0.2)
    s.add_argument("--seed", type=int, default=42)
    s.set_defaults(fn=cmd_generate_scenes)
    return p


def main(argv=None):
    args = get_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
