"""The port's annotator (``loans_tpu_torch/cli/annotate.py``) without a
display, against the JAX package's (``loans_tpu/cli/annotate.py``):

* the record-keeping (``Annotations``): an existing json loaded by
  absolute path, drags turned into yxyx boxes kept only above 2 px each
  way, undo, navigation, and a save of the images that have boxes, which
  reloads; the same drags through JAX's ``Annotator`` methods (its widgets
  stubbed) give the same json;
* the viewer's canvas against Pillow's ``ImageDraw.rectangle(width=2)``
  as JAX's ``view`` draws it, pixel for pixel (float and clipped boxes);
* the refusal by name without tkinter and without a display.
"""

import json
import os
import sys
import types

import numpy as np
import pytest
from PIL import Image, ImageDraw

from loans_tpu.cli import annotate as jax_annotate
from loans_tpu_torch.cli import annotate

DRAGS = [((3, 4), (20, 30)), ((5, 5), (7, 20)), ((30, 2), (10, 12)), ((0, 0), (3, 3)), ((8, 9), (11, 12))]


@pytest.fixture
def images(tmp_path):
    rng = np.random.default_rng(0)
    paths = []
    for i in range(3):
        paths.append(str(tmp_path / f"bg{i}.png"))
        Image.fromarray(rng.integers(0, 256, (24 + 4 * i, 32, 3), dtype=np.uint8)).save(paths[-1])
    return paths


def drive(notes_like, press, release, undo, move):
    """Three drags on image 0, an undo, two drags on image 2."""
    for start, end in DRAGS[:3]:
        press(start), release(end)
    undo()
    move(2)
    for start, end in DRAGS[3:]:
        press(start), release(end)


def test_records_match_jax_and_reload(images, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    existing = [{"image": os.path.basename(images[1]), "bounding_boxes": [[1.0, 2.0, 9.0, 12.0]]}]
    for name in ("port.json", "jax.json"):
        with open(tmp_path / name, "w") as f:
            json.dump(existing, f)

    notes = annotate.Annotations(images, str(tmp_path / "port.json"))
    assert notes.records == {images[1]: [[1.0, 2.0, 9.0, 12.0]]}
    drag = {}
    drive(notes, lambda p: drag.update(start=p), lambda p: notes.add_drag(drag["start"], p), notes.undo,
          notes.move)
    assert notes.index == 2 and notes.path == images[2]
    assert notes.records[images[0]] == [[4.0, 3.0, 30.0, 20.0]]  # (5,5)->(7,20) is 2 px wide: dropped
    assert notes.records[images[2]] == [[0.0, 0.0, 3.0, 3.0], [9.0, 8.0, 12.0, 11.0]]  # 3 px each way: kept
    assert annotate.Annotations.drag_box((0, 0), (2, 9)) is None
    assert annotate.Annotations.drag_box((0, 0), (3, 3)) == [0.0, 0.0, 3.0, 3.0]
    assert notes.save() == 3

    # JAX's Annotator on the same drags, its widgets stubbed
    ja = types.SimpleNamespace(images=images, out_path=str(tmp_path / "jax.json"), index=0, _drag=None,
                               records={os.path.abspath(e["image"]): e["bounding_boxes"] for e in existing},
                               redraw=lambda: None, show=lambda: None)
    ja.boxes = lambda: jax_annotate.Annotator.boxes(ja)
    event = lambda p: types.SimpleNamespace(x=p[0], y=p[1])  # noqa: E731

    def move(step):
        for _ in range(step):
            jax_annotate.Annotator.next(ja)

    drive(ja, lambda p: jax_annotate.Annotator.on_press(ja, event(p)),
          lambda p: jax_annotate.Annotator.on_release(ja, event(p)), lambda: jax_annotate.Annotator.undo(ja), move)
    jax_annotate.Annotator.save(ja)
    assert json.load(open(tmp_path / "port.json")) == json.load(open(tmp_path / "jax.json"))

    again = annotate.Annotations(images, str(tmp_path / "port.json"))
    assert again.records == {k: v for k, v in notes.records.items() if v}
    again.move(-1)
    assert again.index == 2 and again.boxes() == [[0.0, 0.0, 3.0, 3.0], [9.0, 8.0, 12.0, 11.0]]


def test_view_canvas_matches_pillow(images, tmp_path):
    entry = {"image": os.path.basename(images[2]),
             "bounding_boxes": [[2.6, 3.4, 20.5, 25.9], [-3, -2, 5, 6], [10, 20, 40, 45], [4, 4, 5, 5]]}
    got, path = annotate.view_canvas(entry, str(tmp_path))
    assert path == images[2]
    want = Image.open(images[2]).convert("RGB")
    draw = ImageDraw.Draw(want)
    for y1, x1, y2, x2 in entry["bounding_boxes"]:
        draw.rectangle([x1, y1, x2, y2], outline=(255, 0, 0), width=2)
    assert np.array_equal(got, np.asarray(want))
    assert not np.array_equal(got, np.asarray(Image.open(images[2])))


def test_refusals_without_tkinter_or_display(images, tmp_path, monkeypatch):
    gt = tmp_path / "gt.json"
    gt.write_text(json.dumps([{"image": images[0], "bounding_boxes": []}]))
    monkeypatch.delenv("DISPLAY", raising=False)
    with pytest.raises(SystemExit, match="needs a display"):
        annotate.main(["view", str(gt)])
    with pytest.raises(SystemExit, match="needs a display"):
        annotate.main(["annotate", str(tmp_path / "bg*.png"), str(tmp_path / "out.json")])
    monkeypatch.setitem(sys.modules, "tkinter", None)
    with pytest.raises(SystemExit, match="needs tkinter, which is not installed"):
        annotate.main(["view", str(gt)])
    with pytest.raises(SystemExit, match="no images match"):
        annotate.main(["annotate", str(tmp_path / "none*.png"), str(tmp_path / "out.json")])
    assert not (tmp_path / "out.json").exists()
