"""Image inference CLI (port of ``loans_tpu/cli/image_inference.py``).

Iterate images (globs or a JSON list), localize each, draw the results
and save them to ``--output-dir``, optionally gated by the assessor
score, and with ``-v`` each frame's VisualBackprop heat map, resized to
the frame, as ``<stem>_visual_backprop<ext>``. An SSD log dir is served by
``SSDInference`` (``inference.load_inference``), which draws every
detection over ``--score-threshold``. The log dir needs the port's ``.pt``
snapshots (``tools/export_torch_snapshot.py`` writes them from a JAX
training run).

    python -m loans_tpu_torch.cli.image_inference <log_dir> -i 'imgs/*.png' -a
"""

from __future__ import annotations

import argparse
import glob
import json
import os


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="localize objects in images")
    p.add_argument("model_dir", help="training log dir")
    p.add_argument("--images", "-i", nargs="+", default=[],
                   help="image paths/globs")
    p.add_argument("--json", "-j", default=None,
                   help="json list of {'image': path} entries")
    p.add_argument("--output-dir", "-o", default="sheeped_images")
    p.add_argument("--snapshot", default=None)
    p.add_argument("--assessor", "-a", action="store_true",
                   help="gate results by assessor score")
    p.add_argument("--score-threshold", type=float, default=0.3)
    p.add_argument("--visual-backprop", "-v", action="store_true",
                   help="also save VisualBackprop attention heat maps")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda)")
    return p


def iter_image_paths(args):
    for pattern in args.images:
        hits = sorted(glob.glob(pattern))
        yield from hits if hits else [pattern]
    if args.json:
        with open(args.json) as f:
            for entry in json.load(f):
                yield entry["image"] if isinstance(entry, dict) else entry


def main(argv=None):
    import cv2

    from loans_tpu_torch.inference import load_inference

    args = get_parser().parse_args(argv)
    localizer = load_inference(
        args.model_dir,
        device=args.device,
        snapshot=args.snapshot,
        score_threshold=args.score_threshold,
        use_assessor=args.assessor,
        use_visual_backprop=args.visual_backprop,
    )
    os.makedirs(args.output_dir, exist_ok=True)
    for path in iter_image_paths(args):
        frame = cv2.imread(path)
        if frame is None:
            print(f"could not read {path}")
            continue
        resized, scale = localizer.resize(frame)
        boxes, _rois, scores, heat = localizer.localize(
            localizer.preprocess(resized, bgr_to_rgb=True)
        )
        vis = localizer.visualize_results(
            frame, localizer.scale_boxes(boxes, scale), scores
        )
        base = os.path.basename(path)
        cv2.imwrite(os.path.join(args.output_dir, base), vis)
        if heat is not None:
            stem, ext = os.path.splitext(base)
            cv2.imwrite(
                os.path.join(args.output_dir, f"{stem}_visual_backprop{ext}"),
                cv2.resize(heat[..., ::-1], (frame.shape[1], frame.shape[0])),
            )
        if len(boxes):
            print(f"{path}: box={boxes[0].tolist()} score={float(scores[0]):.3f}")
        else:
            print(f"{path}: no detections")


if __name__ == "__main__":
    main()
