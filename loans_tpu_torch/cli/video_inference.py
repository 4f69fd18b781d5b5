"""Video inference CLI (port of ``loans_tpu/cli/video_inference.py``).

    python -m loans_tpu_torch.cli.video_inference <log_dir> -i clip.mp4 -a -v

Localizes every frame of a video and writes it with the box drawn (and
with ``-a`` the assessor's score, frames under ``--score-threshold`` left
unboxed) to ``<input>_sheeped.<ext>`` or ``--output``, with the source's
codec, rate and size; ``-v`` writes the VisualBackprop heat maps to a
second video, ``<output stem>_visual_backprop<ext>``. The same flags as
the JAX package's CLI, plus ``--device`` (default ``cuda``).

Frames go to the card ``--batch-size`` at a time (one crop, K1's forward,
a batch; the tail batch padded with its last frame to the batch's size)
in a double-buffered loop (``localize_frames``): batch t + 1 is decoded
while the card computes batch t, and batch t is written while batch t + 1
computes. ``--no-pipeline`` waits for the card after each launch (the
serial schedule, for comparison). Every 96 frames a progress line, and at
the end the frame rate after the first batch (``sustained fps
(post-compile)``).

Decoding and writing need OpenCV (cv2): without it the CLI refuses by
name. A log dir of an SSD is refused: the JAX package's CLI batches through
``localize_batch(sync=False)``, which its ``SSDInference`` lacks, and fails
there; serve an SSD's frames with ``cli.image_inference`` or
``cli.live_inference``.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Iterable, Iterator

import numpy as np
import torch

NEEDS_CV2 = "the video CLI decodes and writes video with OpenCV (cv2), which is not installed"
SSD_REFUSED = ("{}: an SSD log dir; the video CLI batches frames through LocalizerInference.localize_batch"
               "(sync=False), which SSDInference lacks (the JAX package's video CLI fails there too): "
               "serve it with cli.image_inference or cli.live_inference")


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="localize objects in a video")
    p.add_argument("model_dir", help="training log dir")
    p.add_argument("--input", "-i", required=True, help="input video")
    p.add_argument("--output", "-o", default=None, help="output video (default: <input>_sheeped.<ext>)")
    p.add_argument("--snapshot", default=None)
    p.add_argument("--assessor", "-a", action="store_true")
    p.add_argument("--score-threshold", type=float, default=0.3)
    p.add_argument("--visual-backprop", "-v", action="store_true")
    p.add_argument("--max-frames", type=int, default=0)
    p.add_argument("--batch-size", "-b", type=int, default=8,
                   help="frames per device call; 1 = one frame at a time")
    p.add_argument("--no-pipeline", action="store_true",
                   help="wait for the card after each batch (no decode/compute overlap; for comparison)")
    p.add_argument("--device", default="cuda", help="torch device to run on (default: cuda)")
    return p


def output_paths(args) -> tuple[str, str]:
    """(the output video, the VisualBackprop video)."""
    if args.output:
        out = args.output
    else:
        stem, ext = os.path.splitext(args.input)
        out = f"{stem}_sheeped{ext or '.mp4'}"
    stem, ext = os.path.splitext(out)
    return out, f"{stem}_visual_backprop{ext}"


def localize_frames(
    localizer, frames: Iterable[np.ndarray], batch_size: int = 8, pipeline: bool = True
) -> Iterator[tuple[list[np.ndarray], tuple]]:
    """(frames, result) per batch of ``batch_size`` BGR frames, in order:
    ``result`` is ``localizer.finish_batch``'s (boxes (B, 1, 4) at model
    scale, rois, scores (B,), heat maps or None) of the batch padded to
    ``batch_size`` with its last frame; ``frames`` holds the batch's own
    frames. Double-buffered: batch t + 1 is read, resized and launched
    before batch t is fetched, so the caller's work on batch t overlaps
    the card's on batch t + 1. Without ``pipeline`` each launch is waited
    for."""
    size = max(batch_size, 1)
    it = iter(frames)
    pending = None  # (frames, the device tensors of their un-fetched result)
    while True:
        batch, inputs = [], []
        for frame in it:
            batch.append(frame)
            inputs.append(localizer.preprocess(localizer.resize(frame)[0], bgr_to_rgb=True))
            if len(batch) == size:
                break
        handle = None
        if batch:
            inputs += [inputs[-1]] * (size - len(inputs))  # the tail, padded
            handle = localizer.localize_batch(inputs, sync=False)
            if not pipeline and localizer.device.type == "cuda":
                torch.cuda.synchronize(localizer.device)
        if pending is not None:
            yield pending[0], localizer.finish_batch(pending[1])
        if handle is None:
            return
        pending = (batch, handle)


def read_frames(cap, max_frames: int = 0) -> Iterator[np.ndarray]:
    """The frames of an open ``cv2.VideoCapture``, at most ``max_frames``
    (0: all)."""
    n = 0
    while not max_frames or n < max_frames:
        ok, frame = cap.read()
        if not ok:
            return
        n += 1
        yield frame


def annotate(localizer, frame: np.ndarray, boxes: np.ndarray, scores: np.ndarray, heat) -> tuple:
    """(the frame with its box and score drawn, the heat map resized to
    the frame with the same drawn, or None)."""
    import cv2

    h, w = frame.shape[:2]
    scaled = localizer.scale_boxes(boxes, (h / localizer.input_size.height, w / localizer.input_size.width))
    drawn = localizer.visualize_results(frame, scaled, scores)
    if heat is None:
        return drawn, None
    heat_bgr = np.ascontiguousarray(cv2.resize(heat[..., ::-1], (w, h)))
    return drawn, localizer.visualize_results(heat_bgr, scaled, scores)


def main(argv=None) -> dict:
    """Localize the video; returns {"frames", "fps" (sustained, None with
    one batch), "output", "boxes" ((frames, 4) at model scale)}."""
    try:
        import cv2
    except ImportError:
        raise SystemExit(NEEDS_CV2) from None
    from loans_tpu_torch.inference import LocalizerInference
    from loans_tpu_torch.train import checkpoint

    args = get_parser().parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda but torch.cuda.is_available() is false; pass --device cpu")
    if checkpoint.load_manifest(args.model_dir)["localizer"]["model"].upper().startswith("SSD"):
        raise SystemExit(SSD_REFUSED.format(args.model_dir))
    localizer = LocalizerInference(
        args.model_dir,
        device=args.device,
        snapshot=args.snapshot,
        score_threshold=args.score_threshold,
        use_assessor=args.assessor,
        use_visual_backprop=args.visual_backprop,
    )
    cap = cv2.VideoCapture(args.input)
    if not cap.isOpened():
        raise SystemExit(f"could not open {args.input}")
    fps = cap.get(cv2.CAP_PROP_FPS) or 24.0
    w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    fourcc = int(cap.get(cv2.CAP_PROP_FOURCC)) or cv2.VideoWriter_fourcc(*"mp4v")
    out_path, vbp_path = output_paths(args)
    writer = cv2.VideoWriter(out_path, fourcc, fps, (w, h))
    vbp_writer = cv2.VideoWriter(vbp_path, fourcc, fps, (w, h)) if args.visual_backprop else None
    for path, opened in ((out_path, writer), (vbp_path, vbp_writer)):
        if opened is not None and not opened.isOpened():  # cv2 would drop every frame silently
            cap.release()
            raise SystemExit(f"could not open {path} for writing")

    n, t_warm, n_warm, boxes_out = 0, None, 0, []
    try:
        for frames, (boxes, _rois, scores, heats) in localize_frames(
            localizer, read_frames(cap, args.max_frames), args.batch_size, not args.no_pipeline
        ):
            for i, frame in enumerate(frames):
                drawn, heat_drawn = annotate(localizer, frame, boxes[i], scores[i : i + 1],
                                             None if heats is None else heats[i])
                writer.write(drawn)
                if vbp_writer is not None:
                    vbp_writer.write(heat_drawn)
            boxes_out.append(boxes[: len(frames), 0])
            n += len(frames)
            if t_warm is None:
                t_warm, n_warm = time.time(), n  # the first batch: warm-up excluded
            if n % 96 < len(frames):
                print(f"{n} frames", flush=True)
    finally:
        cap.release()
        writer.release()
        if vbp_writer is not None:
            vbp_writer.release()
    rate = None
    if t_warm is not None and n > n_warm:
        rate = (n - n_warm) / (time.time() - t_warm)
        print(f"sustained fps (post-compile): {rate:.1f}")
    print(f"wrote {n} frames to {out_path}")
    return {"frames": n, "fps": rate, "output": out_path,
            "boxes": np.concatenate(boxes_out) if boxes_out else np.zeros((0, 4))}


if __name__ == "__main__":
    main()
