"""Synthetic assessor/localizer data: the paste-and-crop compositor (port
of ``loans_tpu/data/synthetic.py``).

An RGBA "stamp" is pasted onto a background at a random size and position;
a crop whose IoU with the pasted box is known supervises the assessor, and
the full scene with its box trains and validates the localizer. Stamps and
backgrounds are procedural, so the whole path runs without downloads.

The random streams (``random.Random`` and numpy generators), their seeds
and the order of every draw are the JAX package's; the Pillow operations
there are ``data.image_ops`` here, which computes the same integers. So
for the same arguments the port's scenes and ``pil``-pipeline crops equal
the JAX package's byte for byte. The ``stn`` pipeline renders its crops
with ``spatial_transform``'s axis-aligned crop (K1's forward kernel on
the card), the localizer's own operator.

As in the JAX package, ``_parallel_generate`` splits the work into
``4 * min(8, os.cpu_count())`` chunks, each with its own stream, so the
data depend on the host's CPU count. ``generate_dataset`` writes a dataset
to PNG files and an ``images.csv``, with stamps and backgrounds from image
files where given; its pixels are the JAX tool's.
"""

from __future__ import annotations

import contextlib
import copy
import csv
import hashlib
import json
import os
import random
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from loans_tpu_torch.data import image_ops
from loans_tpu_torch.ops.geometry import Size, box_to_theta

IOU_RANGE = [v / 100 for v in range(20, 105, 5)]
RENDER_BATCH = 256  # crops rendered per sampler call (tail padded)


def _bbox_iou_xyxy(a, b) -> float:
    x1 = max(a[0], b[0])
    y1 = max(a[1], b[1])
    x2 = min(a[2], b[2])
    y2 = min(a[3], b[3])
    inter = max(0, x2 - x1) * max(0, y2 - y1)
    area_a = max(0, a[2] - a[0]) * max(0, a[3] - a[1])
    area_b = max(0, b[2] - b[0]) * max(0, b[3] - b[1])
    union = area_a + area_b - inter
    return inter / union if union > 0 else 0.0


def make_procedural_stamp(rng: random.Random, size: int = 64) -> np.ndarray:
    """Random colored blob with alpha, (size, size, 4) uint8."""
    arr = np.zeros((size, size, 4), dtype=np.uint8)
    color = [rng.randint(60, 255) for _ in range(3)]
    n_blobs = rng.randint(2, 4)
    yy, xx = np.mgrid[0:size, 0:size]
    mask = np.zeros((size, size), dtype=bool)
    for _ in range(n_blobs):
        cy, cx = rng.randint(size // 4, 3 * size // 4), rng.randint(size // 4, 3 * size // 4)
        ry, rx = rng.randint(size // 6, size // 3), rng.randint(size // 6, size // 3)
        mask |= ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
    for c in range(3):
        arr[..., c] = color[c]
    arr[..., 3] = mask.astype(np.uint8) * 255
    return arr


def make_procedural_distractor(rng: random.Random, size: int = 64) -> np.ndarray:
    """Wrong-class stamp (ring, bar or triangle), never labeled; pasted
    into the scenes of the hard world only."""
    arr = np.zeros((size, size, 4), dtype=np.uint8)
    color = [rng.randint(60, 255) for _ in range(3)]
    yy, xx = np.mgrid[0:size, 0:size]
    cy, cx = rng.randint(size // 3, 2 * size // 3), rng.randint(size // 3, 2 * size // 3)
    kind = rng.choice(["ring", "bar", "tri"])
    if kind == "ring":
        r_out = rng.randint(size // 4, size // 2 - 2)
        r_in = rng.randint(r_out // 2, max(r_out - 3, r_out // 2 + 1))
        d2 = (yy - cy) ** 2 + (xx - cx) ** 2
        mask = (d2 <= r_out**2) & (d2 >= r_in**2)
    elif kind == "bar":
        ang = rng.random() * np.pi
        thick = rng.randint(size // 10, size // 4)
        half_len = rng.randint(size // 3, size // 2)
        u = (xx - cx) * np.cos(ang) + (yy - cy) * np.sin(ang)
        v = -(xx - cx) * np.sin(ang) + (yy - cy) * np.cos(ang)
        mask = (np.abs(v) <= thick / 2) & (np.abs(u) <= half_len)
    else:  # triangle: intersection of three half-planes around (cy, cx)
        r = rng.randint(size // 3, size // 2 - 1)
        angles = sorted(rng.random() * 2 * np.pi for _ in range(3))
        pts = [(cx + r * np.cos(a), cy + r * np.sin(a)) for a in angles]
        mask = np.ones((size, size), dtype=bool)
        for (x0, y0), (x1, y1) in zip(pts, pts[1:] + pts[:1]):
            gx = sum(p[0] for p in pts) / 3 - x0
            gy = sum(p[1] for p in pts) / 3 - y0
            ex, ey = x1 - x0, y1 - y0
            side = ex * (yy - y0) - ey * (xx - x0)
            mask &= (side * (ex * gy - ey * gx)) >= 0
    for c in range(3):
        arr[..., c] = color[c]
    arr[..., 3] = mask.astype(np.uint8) * 255
    return arr


def make_hard_background(rng: random.Random, size: tuple[int, int] = (256, 256)) -> np.ndarray:
    """Cluttered high-frequency RGBA background (hard world): colored noise
    at stamp-like frequency plus a fine speckle."""
    w, h = size
    nprng = np.random.default_rng(rng.randrange(2**31))
    coarse = nprng.integers(0, 256, size=(24, 24, 3), dtype=np.uint8)
    mean = coarse.mean(axis=-1, keepdims=True)
    coarse = (0.3 * mean + 0.7 * coarse).astype(np.uint8)
    img = image_ops.resize(coarse, (w, h), "bilinear").astype(np.float32)
    speckle = nprng.normal(0.0, 28.0, size=(h, w, 1)).astype(np.float32)
    img = np.clip(img + speckle, 0, 255).astype(np.uint8)
    return image_ops.to_rgba(img)


def load_base_bbox_sizes(path: str) -> list[tuple[int, int]]:
    """(w, h) sizes of every valid gt box in a bbox-annotation JSON (a list
    of ``{"image": ..., "bounding_boxes": [[y1, x1, y2, x2], ...]}``);
    degenerate boxes dropped, duplicates collapsed, sorted."""
    with open(path) as handle:
        data = json.load(handle)
    sizes = set()
    for item in data:
        for box in item.get("bounding_boxes", []):
            w, h = box[3] - box[1], box[2] - box[0]
            if w > 0 and h > 0:
                sizes.add((int(w), int(h)))
    if not sizes:
        raise ValueError(f"no valid bounding boxes in {path}")
    return sorted(sizes)


def make_procedural_background(rng: random.Random, size: tuple[int, int] = (256, 256)) -> np.ndarray:
    """Low-frequency muted RGBA background (no object-like structure)."""
    w, h = size
    base = rng.randint(70, 150)
    small = np.stack(
        [
            np.asarray(
                [[max(0, min(255, base + rng.randint(-35, 35))) for _ in range(8)] for _ in range(8)],
                dtype=np.uint8,
            )
            for _ in range(3)
        ],
        axis=-1,
    )
    mean = small.mean(axis=-1, keepdims=True)
    small = (0.6 * mean + 0.4 * small).astype(np.uint8)
    return image_ops.to_rgba(image_ops.resize(small, (w, h), "bilinear"))


def iou_crop_box(rng: random.Random, image_size, bbox, crop_width: int, crop_height: int,
                 desired_iou: float) -> tuple[int, int, int, int]:
    """A crop box (x1, y1, x2, y2) near the paste box ``bbox``."""
    width, height = image_size
    if desired_iou < 0.0:
        crop_x = rng.randint(0, max(0, width - crop_width))
        crop_y = rng.randint(0, max(0, height - crop_height))
    else:
        dev_w = int(crop_width // 2 * (1.0 - desired_iou))
        dev_h = int(crop_height // 2 * (1.0 - desired_iou))
        lo_x = max(int(bbox[0]) - dev_w, 0)
        hi_x = min(int(bbox[0]) + dev_w, width - crop_width)
        lo_y = max(int(bbox[1]) - dev_h, 0)
        hi_y = min(int(bbox[1]) + dev_h, height - crop_height)
        crop_x = rng.randint(lo_x, max(lo_x, hi_x))
        crop_y = rng.randint(lo_y, max(lo_y, hi_y))
    return crop_x, crop_y, min(crop_x + crop_width, width), min(crop_y + crop_height, height)


@dataclass
class PasteResult:
    image: np.ndarray  # composited RGBA scene, (H, W, 4) uint8
    paste_bbox: np.ndarray  # (x1, y1, x2, y2) of the stamp


def _size(arr: np.ndarray) -> tuple[int, int]:
    """(width, height), as Pillow's ``Image.size``."""
    return arr.shape[1], arr.shape[0]


class PasteAndCropGenerator:
    """IoU-labeled crop sampler and scene compositor.

    ``sample()`` composites a stamp on a background and returns (crop
    uint8 HWC, IoU label), stratified over ``IOU_RANGE`` with a 30%
    naive-zoom mixture and ``low_iou_fraction`` unconstrained crops.
    ``asset_seed`` draws the stamps and backgrounds from a stream of their
    own, so generators with one asset seed share one visual world.
    ``stamps`` and ``backgrounds`` (RGBA uint8 arrays) replace the
    procedural ones, which are then not drawn.
    """

    def __init__(
        self,
        stamps: list[np.ndarray] | None = None,
        backgrounds: list[np.ndarray] | None = None,
        image_size: tuple[int, int] = (224, 224),
        output_size: tuple[int, int] = (75, 75),
        seed: int = 0,
        n_procedural: int = 16,
        asset_seed: int | None = None,
        low_iou_fraction: float = 0.0,
        hard: bool = False,
        base_bboxes: list[tuple[int, int]] | None = None,
    ):
        self.rng = random.Random(seed)
        asset_rng = random.Random(asset_seed) if asset_seed is not None else self.rng
        self.hard = hard
        self.base_bboxes = base_bboxes
        self.stamps = stamps or [make_procedural_stamp(asset_rng) for _ in range(n_procedural)]
        make_bg = make_hard_background if hard else make_procedural_background
        self.backgrounds = backgrounds or [make_bg(asset_rng) for _ in range(n_procedural)]
        self.distractors = (
            [make_procedural_distractor(asset_rng) for _ in range(n_procedural)] if hard else []
        )
        self.image_size = tuple(image_size)
        self.low_iou_fraction = low_iou_fraction
        self.output_size = tuple(output_size)
        self._iou_index = -1
        # every scene resizes its background to image_size, always to the
        # same pixels: computed once per background, shared by the spawns
        self._resized_backgrounds: dict[int, np.ndarray] = {}

    def spawn(self, seed) -> "PasteAndCropGenerator":
        """A copy that shares the assets but draws from its own stream."""
        clone = copy.copy(self)
        clone.rng = random.Random(seed)
        clone._iou_index = clone.rng.randrange(len(IOU_RANGE))
        return clone

    # -- compositing ------------------------------------------------------
    def _stamp_size(self, background: np.ndarray) -> tuple[int, int]:
        """Target stamp size in scene pixels: a real (w, h) from
        ``base_bboxes`` mapped through the background's resize, or a
        uniform draw ([w/15, w/2]; [w/20, w/1.8] in the hard world)."""
        rng = self.rng
        w, h = self.image_size
        if self.base_bboxes is not None:
            bw, bh = rng.choice(self.base_bboxes)
            fx = w / background.shape[1]
            fy = h / background.shape[0]
            sw = max(2, min(int(bw * fx), w))
            sh = max(2, min(int(bh * fy), h))
            return sw, sh
        if self.hard:
            return rng.randint(w // 20, int(w / 1.8)), rng.randint(h // 20, int(h / 1.8))
        return rng.randint(w // 15, w // 2), rng.randint(h // 15, h // 2)

    def _resized_background(self, background: np.ndarray) -> np.ndarray:
        key = id(background)
        out = self._resized_backgrounds.get(key)
        if out is None:
            out = image_ops.resize(background, self.image_size, "lanczos")
            out.flags.writeable = False
            self._resized_backgrounds[key] = out
        return out

    def paste(self, stamp_index: int | None = None) -> PasteResult:
        """Composite one scene; ``stamp_index`` pins the stamp, which is
        then not drawn (classifier pretraining labels a scene by its stamp,
        ``cli/pretrain_backbone.py``)."""
        rng = self.rng
        background = rng.choice(self.backgrounds)
        stamp = self.stamps[stamp_index] if stamp_index is not None else rng.choice(self.stamps)
        if rng.random() >= 0.5:
            stamp = image_ops.flip_lr(stamp)
        w, h = self.image_size
        stamp = image_ops.resize(stamp, self._stamp_size(background), "lanczos")
        image = self._resized_background(background)
        sw, sh = _size(stamp)
        paste_x = rng.randint(0, w - sw)
        paste_y = rng.randint(0, h - sh)
        bbox = np.array([paste_x, paste_y, paste_x + sw, paste_y + sh])
        if self.distractors:
            # wrong-class clutter under the target, kept off the gt box
            layer = np.zeros_like(image)
            for _ in range(rng.randint(1, 3)):
                d = rng.choice(self.distractors)
                d = image_ops.resize(
                    d, (rng.randint(w // 20, w // 2), rng.randint(h // 20, h // 2)), "lanczos"
                )
                dw, dh = _size(d)
                for _ in range(10):
                    dx = rng.randint(0, w - dw)
                    dy = rng.randint(0, h - dh)
                    dbox = [dx, dy, dx + dw, dy + dh]
                    if _bbox_iou_xyxy(dbox, bbox) < 0.15:
                        image_ops.paste(layer, d, (dx, dy))
                        break
            image = image_ops.alpha_composite(image, layer)
        # the stamp's layer is transparent outside the stamp, where the
        # composite passes the scene through: composite that region only
        out = image.copy()
        region = (slice(paste_y, paste_y + sh), slice(paste_x, paste_x + sw))
        out[region] = image_ops.alpha_composite(image[region], stamp)
        return PasteResult(out, bbox)

    # -- crops ------------------------------------------------------------
    def _next_desired_iou(self) -> float:
        self._iou_index = (self._iou_index + 1) % len(IOU_RANGE)
        return min(IOU_RANGE[self._iou_index], 1.0)

    def iou_crop_sample(self, scene: PasteResult):
        """Rejection-sample a crop box matching the next stratified IoU;
        returns (box, iou). The loop runs on Python ints (the JAX package
        runs it on numpy ints: the same values and draws)."""
        rng = self.rng
        desired = self._next_desired_iou()
        bbox = tuple(int(v) for v in scene.paste_bbox)
        bw, bh = bbox[2] - bbox[0], bbox[3] - bbox[1]
        sw, sh = _size(scene.image)
        max_dev = 1.0 - desired
        for _ in range(400):
            if desired < 0.3:
                cw = int(min(bw + (1 - desired) * 10 * bw, sw))
                ch = int(min(bh + (1 - desired) * 10 * bh, sh))
            else:
                cw = rng.randint(max(int(bw - bw * max_dev), 1), int(bw + bw * max_dev))
                ch = rng.randint(max(int(bh - bh * max_dev), 1), int(bh + bh * max_dev))
            cw, ch = min(cw, sw), min(ch, sh)
            crop = iou_crop_box(rng, (sw, sh), bbox, cw, ch, desired)
            iou = _bbox_iou_xyxy(crop, bbox)
            if desired - 0.05 < iou <= desired:
                return np.array(crop), iou
        return np.array(crop), iou  # the last attempt

    def naive_zoom_sample(self, scene: PasteResult):
        """Random zoom box containing the stamp; returns (box, iou), the
        IoU of the un-rounded box."""
        rng = self.rng
        bbox = scene.paste_bbox
        bw, bh = bbox[2] - bbox[0], bbox[3] - bbox[1]
        sw, sh = _size(scene.image)
        zoom = rng.random() * 10 + 0.3
        cw = min(bw + zoom * bw, sw)
        ch = min(bh + zoom * bh, sh)
        ins_max = [min(bbox[0], sw - cw), min(bbox[1], sh - ch)]
        ins_min = [max(bbox[2] - cw, 0), max(bbox[3] - ch, 0)]
        for i in range(2):
            if ins_max[i] < ins_min[i]:
                ins_max[i] = ins_min[i]
        point = [int(mi + rng.random() * (ma - mi)) for mi, ma in zip(ins_min, ins_max)]
        crop = [point[0], point[1], point[0] + cw, point[1] + ch]
        iou = _bbox_iou_xyxy(crop, bbox)
        return np.array([int(v) for v in crop]), iou

    def random_crop_sample(self, scene: PasteResult):
        """Unconstrained random crop box, mostly IoU ~ 0 (background)."""
        rng = self.rng
        sw, sh = _size(scene.image)
        cw = rng.randint(max(sw // 10, 2), int(sw * 0.9))
        ch = rng.randint(max(sh // 10, 2), int(sh * 0.9))
        x = rng.randint(0, sw - cw)
        y = rng.randint(0, sh - ch)
        crop = np.array([x, y, x + cw, y + ch])
        return crop, _bbox_iou_xyxy(crop, scene.paste_bbox)

    def _choose_crop(self, scene: PasteResult):
        r = self.rng.random()
        if r < self.low_iou_fraction:
            return self.random_crop_sample(scene)
        if r < self.low_iou_fraction + 0.3 * (1 - self.low_iou_fraction):
            return self.naive_zoom_sample(scene)
        return self.iou_crop_sample(scene)

    def sample_box(self) -> tuple[np.ndarray, np.ndarray, float]:
        """One scene (RGB uint8), a crop box (float32 xyxy) and its IoU
        label; the crop is rendered later by the sampler (``stn``)."""
        scene = self.paste()
        box, iou = self._choose_crop(scene)
        return image_ops.to_rgb(scene.image), np.asarray(box, dtype=np.float32), float(iou)

    def sample(self) -> tuple[np.ndarray, float]:
        """One crop, cut and resized as Pillow does (``pil``), and its IoU."""
        scene = self.paste()
        box, iou = self._choose_crop(scene)
        crop = image_ops.crop(scene.image, tuple(int(v) for v in box))
        crop = image_ops.resize(image_ops.to_rgb(crop), self.output_size, "bilinear")
        return crop, float(iou)

    def scene_with_bbox(self) -> tuple[np.ndarray, np.ndarray]:
        """Full scene (RGB uint8) and its gt box (y1, x1, y2, x2) float32."""
        scene = self.paste()
        x1, y1, x2, y2 = scene.paste_bbox
        return image_ops.to_rgb(scene.image), np.array([y1, x1, y2, x2], dtype=np.float32)


def _parallel_generate(base: PasteAndCropGenerator, n: int, seed, fn):
    """Thread-parallel generation that does not depend on scheduling: the
    work splits into ``4 * min(8, os.cpu_count())`` chunks, each drawn by
    its own spawn of ``base``."""
    workers = min(8, os.cpu_count() or 1)
    chunks = np.array_split(np.arange(n), workers * 4)

    def run(chunk_id):
        g = base.spawn(hash((seed, int(chunk_id))) & 0x7FFFFFFF)
        return [fn(g) for _ in range(len(chunks[chunk_id]))]

    with ThreadPoolExecutor(workers) as pool:
        parts = list(pool.map(run, range(len(chunks))))
    return [item for part in parts for item in part]


def _cache_key(kind: str, **kw) -> str:
    blob = json.dumps({"kind": kind, **kw}, sort_keys=True)
    return f"{kind}-{hashlib.sha1(blob.encode()).hexdigest()[:16]}.npz"


def cached_synthetic(cache_dir: str | None, kind: str, build, **kw):
    """Disk-cache a synthetic dataset's arrays under ``cache_dir``, keyed by
    ``kind`` and ``kw`` (every value the data depend on). ``build(items=
    None)`` generates; on a hit it is called with the stored items.
    ``cache_dir=None`` disables the cache. The files are the JAX
    package's: either package reads the other's.

    A miss writes the entry through a temporary file of this process and
    thread, then renames it into place, so writers of one entry at once
    (the ranks of a ``torchrun`` run on a cold cache) never share a
    temporary file; each rename is atomic, and the last one wins."""
    if not cache_dir:
        return build(items=None)
    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir, _cache_key(kind, **kw))
    if os.path.exists(path):
        with np.load(path, allow_pickle=False) as z:
            cols = [list(z[f"col{i}"]) for i in range(int(z["ncols"]))]
        return build(items=list(zip(*cols)))
    ds = build(items=None)
    cols = list(zip(*ds.items))
    arrays = {"ncols": np.asarray(len(cols))}
    for i, col in enumerate(cols):
        arrays[f"col{i}"] = np.stack([np.asarray(v) for v in col])
    tmp = f"{path}.{os.getpid()}-{threading.get_ident()}.tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)
    return ds


class SyntheticAssessorDataset:
    """Fixed-size dataset of generated (crop, IoU) pairs.

    ``crop_pipeline='pil'`` cuts and resizes each crop as the reference
    tool does (Pillow's arithmetic, ``data.image_ops``); ``'stn'`` renders
    the crops with the localizer's own axis-aligned crop on ``device``
    (K1's forward kernel on the card, its plain version on the CPU).
    ``output_dtype='uint8'`` keeps raw bytes.
    """

    def __init__(self, n: int, output_size=(75, 75), image_size=(224, 224), seed=0,
                 output_dtype="float32", crop_pipeline="pil",
                 asset_seed=None, n_assets=16, low_iou_fraction=0.0,
                 hard=False, base_bboxes=None, items=None, device="cuda"):
        self.output_dtype = output_dtype
        if items is not None:  # pre-generated (cached_synthetic)
            self.items = items
            return
        world = dict(output_size=output_size, image_size=image_size, seed=seed, asset_seed=asset_seed,
                     n_assets=n_assets, low_iou_fraction=low_iou_fraction, hard=hard,
                     base_bboxes=base_bboxes)
        if crop_pipeline == "stn":
            triples = assessor_triples(n, **world)
            crops = render_stn_crops(triples, (output_size[0], output_size[1]), device)
            self.items = [(crop, iou) for crop, (_, _, iou) in zip(crops, triples)]
        elif crop_pipeline == "pil":
            self.items = _parallel_generate(_assessor_generator(**world), n, seed, lambda g: g.sample())
        else:
            raise ValueError(f"unknown crop_pipeline: {crop_pipeline!r}")

    def __len__(self):
        return len(self.items)

    def get_example(self, i):
        img, iou = self.items[i]
        if self.output_dtype == "float32":
            img = img.astype(np.float32) / 255.0
        return img, np.asarray([iou], dtype=np.float32)

    def __getitem__(self, i):
        return self.get_example(i)


def _assessor_generator(output_size, image_size, seed, asset_seed, n_assets, low_iou_fraction,
                        hard, base_bboxes) -> PasteAndCropGenerator:
    return PasteAndCropGenerator(
        image_size=image_size,
        output_size=(output_size[1], output_size[0]),
        seed=seed,
        asset_seed=asset_seed,
        n_procedural=n_assets,
        low_iou_fraction=low_iou_fraction,
        hard=hard,
        base_bboxes=base_bboxes,
    )


def assessor_triples(n: int, output_size=(75, 75), image_size=(224, 224), seed=0, asset_seed=None,
                     n_assets=16, low_iou_fraction=0.0, hard=False, base_bboxes=None) -> list:
    """The ``stn`` pipeline's ``n`` (scene, box, IoU) triples before they
    are rendered: ``SyntheticAssessorDataset(crop_pipeline='stn')`` with
    the same arguments renders these."""
    gen = _assessor_generator(output_size, image_size, seed, asset_seed, n_assets, low_iou_fraction,
                              hard, base_bboxes)
    return _parallel_generate(gen, n, seed, lambda g: g.sample_box())


def render_stn_crops(triples, out_hw, device="cuda") -> list[np.ndarray]:
    """Render (scene, box) pairs to uint8 crops with the localizer's
    axis-aligned crop, ``RENDER_BATCH`` at a time (the tail padded with
    its last pair, as the JAX package pads it for one static shape).

    On the card the crop is K1's forward kernel (``method='pallas'``),
    launched on a CUDA stream of this call's own, which is synchronized
    before the crops are returned: the call may run in a thread beside
    training on the default stream. Each call adds its sampler calls to
    ``render_stn_crops.batches``. On the CPU the crop is K1's plain
    version.
    """
    from loans_tpu_torch.ops.stn import spatial_transform

    device = torch.device(device)
    h, w = out_hw
    size = Size(*triples[0][0].shape[:2])
    method = "pallas" if device.type == "cuda" else "separable"
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    out: list[np.ndarray] = []
    with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
        for start in range(0, len(triples), RENDER_BATCH):
            part = triples[start : start + RENDER_BATCH]
            pad = RENDER_BATCH - len(part)
            scenes = np.stack([t[0] for t in part] + [part[-1][0]] * pad)
            boxes = np.stack([t[1] for t in part] + [part[-1][1]] * pad)
            scenes = torch.from_numpy(scenes).to(device).float() / 255.0
            theta = box_to_theta(torch.from_numpy(boxes).to(device), size)
            crops = spatial_transform(scenes, theta, Size(h, w), method=method)
            crops = torch.clip(torch.round(crops * 255.0), 0, 255).to(torch.uint8)
            with _RENDER_LOCK:
                render_stn_crops.batches += 1
            out.extend(crops[: len(part)].cpu().numpy())
        if stream is not None:
            stream.synchronize()
    return out


_RENDER_LOCK = threading.Lock()
render_stn_crops.batches = 0


class SyntheticLocalizerDataset:
    """Fixed-size dataset of full scenes (+ gt boxes when labeled)."""

    def __init__(self, n: int, image_size=(224, 224), seed=0, labeled=False,
                 output_dtype="float32", asset_seed=None, n_assets=16,
                 hard=False, base_bboxes=None, items=None):
        self.labeled = labeled
        self.output_dtype = output_dtype
        if items is not None:  # pre-generated (cached_synthetic)
            self.items = items
            return
        gen = PasteAndCropGenerator(
            image_size=image_size, seed=seed,
            asset_seed=asset_seed, n_procedural=n_assets,
            hard=hard, base_bboxes=base_bboxes,
        )
        self.items = _parallel_generate(gen, n, seed, lambda g: g.scene_with_bbox())

    def __len__(self):
        return len(self.items)

    def get_example(self, i):
        img, bbox = self.items[i]
        if self.output_dtype == "float32":
            img = img.astype(np.float32) / 255.0
        if self.labeled:
            return img, bbox[None, :], np.zeros((1,), dtype=np.float32)
        return img

    def __getitem__(self, i):
        return self.get_example(i)


def generate_dataset(
    destination: str,
    num_samples: int,
    stamps: list[str] | None = None,
    background_dir: str | None = None,
    image_size=(224, 224),
    output_size=(75, 75),
    zoom_mode: bool = True,
    seed: int = 0,
    low_iou_fraction: float = 0.0,
    base_bboxes: str | None = None,
) -> str:
    """Write ``images/<i>.png`` and a tab-separated ``images.csv`` under
    ``destination``; returns the csv's path. ``zoom_mode``: IoU-labeled
    crops (labels as ``format(label, '.4f')``); else unlabeled crops of the
    stamp's box. ``stamps`` and ``background_dir``: image files of the
    stamps and backgrounds (read as RGBA), else procedural ones;
    ``base_bboxes``: a bbox json whose box sizes the stamps take. Sizes
    are (width, height). The pixels are the JAX package's tool's."""
    from loans_tpu_torch.data.datasets import load_image
    from loans_tpu_torch.insights.rendering import write_png

    stamp_imgs = [load_image(s, "RGBA") for s in stamps] if stamps else None
    bg_imgs = None
    if background_dir:
        bg_imgs = [load_image(os.path.join(background_dir, f), "RGBA") for f in sorted(os.listdir(background_dir))]
    gen = PasteAndCropGenerator(
        stamps=stamp_imgs,
        backgrounds=bg_imgs,
        image_size=tuple(image_size),
        output_size=tuple(output_size),
        seed=seed,
        low_iou_fraction=low_iou_fraction,
        base_bboxes=load_base_bbox_sizes(base_bboxes) if base_bboxes else None,
    )
    img_dir = os.path.join(destination, "images")
    os.makedirs(img_dir, exist_ok=True)
    rows = []
    for i in range(num_samples):
        if zoom_mode:
            arr, label = gen.sample()
            rows.append([f"images/{i}.png", format(label, ".4f")])
        else:
            scene = gen.paste()
            crop = image_ops.to_rgb(image_ops.crop(scene.image, tuple(int(v) for v in scene.paste_bbox)))
            arr = image_ops.resize(crop, tuple(output_size), "bilinear")
            rows.append([f"images/{i}.png"])
        write_png(os.path.join(img_dir, f"{i}.png"), arr)
    path = os.path.join(destination, "images.csv")
    with open(path, "w") as handle:
        csv.writer(handle, delimiter="\t").writerows(rows)
    return path
