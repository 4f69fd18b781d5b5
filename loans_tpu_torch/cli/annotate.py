"""GUI annotation and dataset viewer, tkinter (port of
``loans_tpu/cli/annotate.py``).

    python -m loans_tpu_torch.cli.annotate annotate "backgrounds/*.png" out.json
    python -m loans_tpu_torch.cli.annotate view gt.json

``annotate``: drag boxes over background images; the annotations json
(``[{"image": <absolute path>, "bounding_boxes": [[y1, x1, y2, x2], ...]}]``,
images without boxes left out) feeds ``dataset_tools generate_scenes``. An
existing json at the output path is loaded and extended. ``view``: browse
a gt json with its boxes drawn.

Keys (both modes): n/right = next image, p/left = previous, q = quit.
Annotate mode: drag to draw a box (kept if larger than 2 px each way),
u = undo last box, s = save; q saves too.

The record-keeping (``Annotations``) and the viewer's canvas
(``view_canvas``) are plain Python and numpy, apart from the widgets.
Images are decoded by ``data.datasets.load_image`` and handed to tkinter
as PNG (``insights.rendering.encode_png``), boxes drawn as Pillow's
``rectangle(width=2)`` (``insights.rendering.draw_rectangle``): no Pillow
needed for PNG files. Without tkinter or a display the CLI refuses by name.
"""

from __future__ import annotations

import argparse
import base64
import glob
import json
import os

import numpy as np

from loans_tpu_torch.data.datasets import load_image
from loans_tpu_torch.insights.rendering import draw_rectangle, encode_png

NEEDS_TK = "the annotator's window needs tkinter, which is not installed"
NEEDS_DISPLAY = "the annotator's window needs a display, and tkinter could not open one: {}"
RED = (255, 0, 0)


class Annotations:
    """The annotator's records: boxes (yxyx, floats) per image, keyed by
    absolute path; the current image's index."""

    def __init__(self, images: list[str], out_path: str):
        self.images = images
        self.out_path = out_path
        self.index = 0
        entries = []
        if os.path.exists(out_path):
            with open(out_path) as f:
                entries = json.load(f)
        self.records = {os.path.abspath(e["image"]): e.get("bounding_boxes", []) for e in entries}

    @property
    def path(self) -> str:
        return self.images[self.index]

    def boxes(self) -> list[list[float]]:
        return self.records.setdefault(os.path.abspath(self.path), [])

    def move(self, step: int) -> None:
        self.index = (self.index + step) % len(self.images)

    @staticmethod
    def drag_box(start: tuple[int, int], end: tuple[int, int]) -> list[float] | None:
        """The yxyx box of a drag from ``start`` to ``end`` ((x, y) canvas
        points), or None unless it is larger than 2 px each way."""
        (x1, y1), (x2, y2) = start, end
        box = [float(min(y1, y2)), float(min(x1, x2)), float(max(y1, y2)), float(max(x1, x2))]
        return box if box[2] - box[0] > 2 and box[3] - box[1] > 2 else None

    def add_drag(self, start: tuple[int, int], end: tuple[int, int]) -> list[float] | None:
        box = self.drag_box(start, end)
        if box is not None:
            self.boxes().append(box)
        return box

    def undo(self) -> None:
        if self.boxes():
            self.boxes().pop()

    def save(self) -> int:
        """Write the images that have boxes; returns their count."""
        records = [{"image": path, "bounding_boxes": boxes} for path, boxes in self.records.items() if boxes]
        with open(self.out_path, "w") as f:
            json.dump(records, f, indent=2)
        print(f"saved {len(records)} annotated images -> {self.out_path}")
        return len(records)


def view_canvas(entry: dict, root_dir: str) -> tuple[np.ndarray, str]:
    """The viewer's image of a gt entry (its path relative to ``root_dir``
    unless absolute) with the boxes drawn in red, 2 px wide; and the path."""
    p = entry["image"]
    p = p if os.path.isabs(p) else os.path.join(root_dir, p)
    img = load_image(p, "RGB").copy()
    for y1, x1, y2, x2 in entry.get("bounding_boxes", []):
        draw_rectangle(img, [x1, y1, x2, y2], RED, width=2)
    return img, p


def open_window(title: str):
    """(tkinter, its root window), or a ``SystemExit`` that says which is
    missing."""
    try:
        import tkinter as tk
    except ImportError:
        raise SystemExit(NEEDS_TK) from None
    try:
        root = tk.Tk()
    except tk.TclError as e:
        raise SystemExit(NEEDS_DISPLAY.format(e)) from None
    root.title(title)
    return tk, root


def photo_image(tk, img: np.ndarray):
    """A tkinter ``PhotoImage`` of an HW3 uint8 array, passed as PNG."""
    return tk.PhotoImage(data=base64.b64encode(encode_png(img)).decode("ascii"))


def _bind_navigation(root, move, quit_fn) -> None:
    for key, step in (("n", 1), ("<Right>", 1), ("p", -1), ("<Left>", -1)):
        root.bind(key, lambda _e, s=step: move(s))
    root.bind("q", lambda _e: quit_fn())


class Annotator:
    """The annotation window over ``Annotations``."""

    def __init__(self, images: list[str], out_path: str):
        self.notes = Annotations(images, out_path)
        self.tk, self.root = open_window("annotate backgrounds")
        self.canvas = self.tk.Canvas(self.root)
        self.canvas.pack(fill="both", expand=True)
        self.canvas.bind("<ButtonPress-1>", self.on_press)
        self.canvas.bind("<B1-Motion>", self.on_drag)
        self.canvas.bind("<ButtonRelease-1>", self.on_release)
        _bind_navigation(self.root, self.move, self.quit)
        self.root.bind("u", lambda _e: self.undo())
        self.root.bind("s", lambda _e: self.notes.save())
        self._drag = None
        self.show()

    def show(self):
        img = load_image(self.notes.path, "RGB")
        self.photo = photo_image(self.tk, img)
        self.canvas.config(width=img.shape[1], height=img.shape[0])
        self.redraw()
        self.root.title(f"[{self.notes.index + 1}/{len(self.notes.images)}] {os.path.basename(self.notes.path)}")

    def redraw(self):
        self.canvas.delete("all")
        self.canvas.create_image(0, 0, anchor="nw", image=self.photo)
        for y1, x1, y2, x2 in self.notes.boxes():
            self.canvas.create_rectangle(x1, y1, x2, y2, outline="red", width=2)

    def move(self, step: int):
        self.notes.move(step)
        self.show()

    def on_press(self, ev):
        self._drag = (ev.x, ev.y)

    def on_drag(self, ev):
        if self._drag:
            self.redraw()
            self.canvas.create_rectangle(self._drag[0], self._drag[1], ev.x, ev.y, outline="yellow", width=2)

    def on_release(self, ev):
        if self._drag:
            start, self._drag = self._drag, None
            self.notes.add_drag(start, (ev.x, ev.y))
            self.redraw()

    def undo(self):
        self.notes.undo()
        self.redraw()

    def quit(self):
        self.notes.save()
        self.root.destroy()

    def run(self):
        self.root.mainloop()


def view(gt_path: str):
    with open(gt_path) as f:
        entries = json.load(f)
    root_dir = os.path.dirname(os.path.abspath(gt_path))
    idx = [0]
    tk, root = open_window("view")
    label = tk.Label(root)
    label.pack()

    def show():
        img, p = view_canvas(entries[idx[0]], root_dir)
        photo = photo_image(tk, img)
        label.configure(image=photo)
        label.image = photo
        root.title(f"[{idx[0] + 1}/{len(entries)}] {os.path.basename(p)}")

    def move(d):
        idx[0] = (idx[0] + d) % len(entries)
        show()

    _bind_navigation(root, move, root.destroy)
    show()
    root.mainloop()


def main(argv=None):
    p = argparse.ArgumentParser(description="annotation / viewing tools")
    sub = p.add_subparsers(dest="cmd", required=True)
    a = sub.add_parser("annotate")
    a.add_argument("images", help="glob of background images")
    a.add_argument("output", help="annotations json")
    v = sub.add_parser("view")
    v.add_argument("gt", help="gt json to browse")
    args = p.parse_args(argv)
    if args.cmd == "annotate":
        images = sorted(glob.glob(args.images))
        if not images:
            raise SystemExit(f"no images match {args.images!r}")
        Annotator(images, args.output).run()
    else:
        view(args.gt)


if __name__ == "__main__":
    main()
