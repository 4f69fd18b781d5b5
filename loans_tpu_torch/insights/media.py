"""GIF and video of the per-iteration bbox renders (port of
``loans_tpu/insights/media.py``).

``list_frames`` orders a directory's PNGs by the number in their names
(``bboxes/<iteration>.png``). ``make_gif`` reads them with ``data/png.py``
and encodes the GIF with Pillow (imported when it runs; GIF encoding needs
it), as the JAX package does. ``make_video`` writes an mp4v video with cv2
(imported when it runs); frames are cut to even sizes as the JAX package
cuts them, with Pillow's BICUBIC resize computed by ``data/image_ops.py``,
so it needs no Pillow.
"""

from __future__ import annotations

import os
import re

from loans_tpu_torch.data import image_ops
from loans_tpu_torch.data.png import read_png

_NUM_RE = re.compile(r"(\d+)")


def _numeric_key(name: str):
    m = _NUM_RE.search(os.path.basename(name))
    return int(m.group(1)) if m else -1


def list_frames(frame_dir: str) -> list[str]:
    """Every PNG of ``frame_dir``, by the number in its name."""
    files = [os.path.join(frame_dir, f) for f in os.listdir(frame_dir) if f.endswith(".png")]
    return sorted(files, key=_numeric_key)


def make_gif(
    frame_dir: str,
    dest: str,
    fps: int = 10,
    max_frames: int | None = None,
    resize_to: tuple[int, int] | None = None,
) -> str:
    """A looping GIF of the frames (at most ``max_frames``, evenly
    strided; ``resize_to`` (width, height) with Pillow's BILINEAR)."""
    from PIL import Image

    frames = list_frames(frame_dir)
    if max_frames and len(frames) > max_frames:
        stride = len(frames) / max_frames
        frames = [frames[int(i * stride)] for i in range(max_frames)]
    if not frames:
        raise ValueError(f"no frames in {frame_dir}")
    images = []
    for path in frames:
        arr = read_png(path, "RGB")
        if resize_to:
            arr = image_ops.resize(arr, resize_to, "bilinear")
        images.append(Image.fromarray(arr))
    images[0].save(dest, save_all=True, append_images=images[1:], duration=int(1000 / fps), loop=0, optimize=True)
    return dest


def make_video(frame_dir: str, dest: str, fps: int = 24) -> str:
    """An mp4v video of the frames at the first frame's size cut to even
    width and height."""
    import cv2

    frames = list_frames(frame_dir)
    if not frames:
        raise ValueError(f"no frames in {frame_dir}")
    first = read_png(frames[0], "RGB")
    size = (first.shape[1] // 2 * 2, first.shape[0] // 2 * 2)  # even, for the codec
    writer = cv2.VideoWriter(dest, cv2.VideoWriter_fourcc(*"mp4v"), fps, size)
    try:
        for path in frames:
            writer.write(image_ops.resize(read_png(path, "RGB"), size, "bicubic")[..., ::-1])  # RGB -> BGR
    finally:
        writer.release()
    return dest
