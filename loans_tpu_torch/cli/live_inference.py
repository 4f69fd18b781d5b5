"""Live camera demo CLI (port of ``loans_tpu/cli/live_inference.py``).

    python -m loans_tpu_torch.cli.live_inference <log_dir> -c 0 -a

Capture, mirror, resize and submit each frame to an
``AsynchronousLocalizer`` (frames are dropped while the model is busy),
draw the newest result and the worker's fps, and show the frame in an
OpenCV window. Keys: ESC quits, ``+``/``=`` and ``-`` move the score
threshold by 0.05 within [0, 1], ``b`` toggles the sound of ``--audio``
(played on a detection). ``--camera`` takes a device index or a video
file's path. An SSD log dir is served through ``SSDInference.localize``,
as in the JAX package. The same flags as the JAX package's CLI, plus
``--device`` (default ``cuda``). Needs OpenCV (cv2): without it the CLI
refuses by name.
"""

from __future__ import annotations

import argparse

import torch

NEEDS_CV2 = "the live CLI captures and shows frames with OpenCV (cv2), which is not installed"


def camera_source(value: str) -> int | str:
    """A device index, or else a video file's path."""
    return int(value) if value.isdigit() else value


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="live webcam localization")
    p.add_argument("model_dir", help="training log dir")
    p.add_argument("--camera", "-c", type=camera_source, default=0, help="device index or video file")
    p.add_argument("--snapshot", default=None)
    p.add_argument("--assessor", "-a", action="store_true")
    p.add_argument("--score-threshold", type=float, default=0.3)
    p.add_argument("--audio", default=None, help="wav to play on detection")
    p.add_argument("--device", default="cuda", help="torch device to run on (default: cuda)")
    return p


def main(argv=None):
    try:
        import cv2
    except ImportError:
        raise SystemExit(NEEDS_CV2) from None
    import numpy as np

    from loans_tpu_torch.inference import AsynchronousLocalizer, load_inference
    from loans_tpu_torch.inference.camera import AudioRenderer, Camera

    args = get_parser().parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda but torch.cuda.is_available() is false; pass --device cpu")
    localizer = load_inference(
        args.model_dir,
        device=args.device,
        snapshot=args.snapshot,
        score_threshold=args.score_threshold,
        use_assessor=args.assessor,
    )
    worker = AsynchronousLocalizer(localizer).start_localization_worker()
    audio = AudioRenderer(args.audio) if args.audio else None
    last = None
    try:
        with Camera(args.camera) as cam:
            while True:
                frame = cv2.flip(cam.get_frame(), 1)
                resized, scale = localizer.resize(frame)
                worker.submit(localizer.preprocess(resized, bgr_to_rgb=True))
                result = worker.get_result()
                if result is not None:
                    last = result
                if last is not None:
                    boxes, _, scores, _ = last
                    frame = localizer.visualize_results(frame, localizer.scale_boxes(boxes, scale), scores)
                    if audio and len(np.ravel(scores)) and float(np.ravel(scores)[0]) > 0:
                        audio.play()
                cv2.putText(frame, f"{worker.fps:.1f} fps", (10, 24), cv2.FONT_HERSHEY_SIMPLEX, 0.7,
                            (0, 255, 0), 2)
                cv2.imshow("loans-tpu live", frame)
                key = cv2.waitKey(1) & 0xFF
                if key == 27:
                    break
                elif key in (ord("+"), ord("=")):
                    localizer.score_threshold = min(localizer.score_threshold + 0.05, 1.0)
                elif key == ord("-"):
                    localizer.score_threshold = max(localizer.score_threshold - 0.05, 0.0)
                elif key == ord("b") and audio:
                    audio.toggle()
    finally:
        worker.shutdown()
        if audio:
            audio.shutdown()
        cv2.destroyAllWindows()


if __name__ == "__main__":
    main()
