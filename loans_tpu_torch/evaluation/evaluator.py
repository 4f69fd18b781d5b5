"""Offline snapshot sweep with resume (port of
``loans_tpu/evaluation/evaluator.py``, localizer log dirs).

``Evaluator`` scores every ``<prefix><iteration>.pt`` snapshot of a
training log dir against a labeled dataset, in iteration order: mean IoU,
VOC mAP and AP of the object class (``MAPEvaluator``), and with the
assessor the mean score of the predicted crops. Results go to
``eval_results.json``, rewritten atomically after each snapshot; a
snapshot already there is skipped unless ``force_reset``. A snapshot that
fails is reported with its traceback and the sweep goes on. Optionally each
snapshot's predictions are rendered over the gt boxes as PNGs and written
as deteval XML. ``plot`` draws the metric curves (with matplotlib, where
installed) and reports the best snapshot.

The models are rebuilt from ``manifest.json`` and run on ``device``; each
pass over the data (scoring, renders, deteval) runs one eval-mode forward
per batch, each of which crops once (K1's forward kernel on the card, or
K2's for a ``sampler="rotated_pallas"`` localizer). SSD log dirs are
ROADMAP.md Queue 1 item 12 and are refused.
"""

from __future__ import annotations

import importlib
import json
import os
import time
import traceback
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

from loans_tpu_torch.evaluation.deteval import DetEvalWriter
from loans_tpu_torch.evaluation.intraining import MAPEvaluator
from loans_tpu_torch.inference.localizer import set_precision
from loans_tpu_torch.insights.rendering import draw_boxes_on_image, write_png
from loans_tpu_torch.ops.geometry import corners_to_aabb, theta_corners
from loans_tpu_torch.train import checkpoint
from loans_tpu_torch.train.state import create_train_state
from loans_tpu_torch.train.steps import make_eval_step, to_float01
from loans_tpu_torch.utils.registry import build_assessor, build_model


class EvalResults:
    """Resumable ``eval_results.json`` (a list of per-snapshot dicts).

    ``timings`` maps each snapshot scored in this process to its wall
    ``seconds`` (restore, warm-up, scoring, renders and deteval), its
    scoring pass's ``score_seconds`` and that pass's ``images``; it is not
    written to the file."""

    def __init__(self, path: str, force_reset: bool = False):
        self.path = path
        self.timings: dict[str, dict] = {}
        self.entries: list[dict] = []
        if not force_reset and os.path.exists(path):
            with open(path) as f:
                self.entries = json.load(f)

    def evaluated_snapshots(self) -> set[str]:
        return {e.get("snapshot_name", "") for e in self.entries}

    def append(self, entry: dict) -> None:
        self.entries.append(entry)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.entries, f, indent=2)
        os.replace(tmp, self.path)

    def best(self, key: str = "map") -> dict | None:
        scored = [e for e in self.entries if key in e]
        return max(scored, key=lambda e: e[key]) if scored else None


class Evaluator:
    """Snapshot sweep over a training log dir.

    With ``use_assessor`` and an assessor in the manifest, the assessor's
    last snapshot is restored once and scores every sweep's crops; with no
    assessor snapshot, no crop is scored (unlike ``LocalizerInference``,
    which serves the initial parameters).
    """

    def __init__(
        self,
        log_dir: str,
        snapshot_prefix: str = "Localizer_",
        iou_threshold: float = 0.5,
        force_reset: bool = False,
        results_name: str = "eval_results.json",
        use_assessor: bool = False,
        device: str | torch.device = "cuda",
    ):
        set_precision()
        self.log_dir = log_dir
        self.device = torch.device(device)
        self.manifest = checkpoint.load_manifest(log_dir)
        loc_cfg = self.manifest["localizer"]
        if loc_cfg["model"].upper().startswith("SSD"):
            raise NotImplementedError(
                f"{log_dir} holds an SSD model ({loc_cfg['model']}); SSD evaluation is not "
                "ported yet (ROADMAP.md Queue 1 item 12)"
            )
        self.localizer = build_model(loc_cfg["model"], **loc_cfg["kwargs"]).to(self.device)
        self.image_size = self.localizer.input_size
        self.assessor = None
        if use_assessor and "assessor" in self.manifest:
            names = self.manifest.get("snapshot_names", [])
            prefix = names[-1] if len(names) > 1 else "ResnetAssessor"
            snaps = checkpoint.list_snapshots(log_dir, prefix + "_")
            if snaps:
                assessor = build_assessor(self.manifest["assessor"], self.localizer)
                assessor.load_state_dict(checkpoint.load_params(snaps[-1][1]))
                self.assessor = assessor.to(self.device).eval()
        self.map_eval = MAPEvaluator(self.image_size, iou_thresh=iou_threshold)
        self._eval_step = make_eval_step()
        self.state = create_train_state(self.localizer)
        self.snapshot_prefix = snapshot_prefix
        self.results = EvalResults(os.path.join(log_dir, results_name), force_reset=force_reset)

    def _on_device(self, batches: Iterable) -> Iterator[tuple]:
        """(images on the device, gt boxes on the host, ...) per batch."""
        for batch in batches:
            images = torch.as_tensor(np.asarray(batch[0])).to(self.device)
            yield (images, *batch[1:])

    def load_snapshot(self, path: str, batches_factory: Callable[[], Iterable], bn_warmup: int = 0) -> None:
        """Restore the localizer from ``path``; with ``bn_warmup`` > 0,
        re-estimate its BatchNorm running statistics from the first
        ``bn_warmup`` batches of a fresh ``batches_factory()`` (train-mode
        forwards of the backbone) and keep them for this snapshot's
        scoring, renders and deteval: short runs snapshot statistics that
        lag their weights."""
        model = self.localizer
        # read on the host: a training snapshot also holds the optimizer's
        # state, which would otherwise cross to the card and be dropped
        model.load_state_dict(checkpoint.load_params(path))
        if bn_warmup <= 0:
            return
        model.train()
        try:
            with torch.no_grad():
                for i, batch in enumerate(self._on_device(batches_factory())):
                    if i >= bn_warmup:
                        break
                    model.features(to_float01(batch[0]))
        finally:
            model.eval()

    def predict(self, images: torch.Tensor) -> np.ndarray:
        """Clipped (N, 4) yxyx boxes of a batch on the device, on the host."""
        theta = self._eval_step(self.state, images)
        return corners_to_aabb(theta_corners(theta), self.image_size, clip=True).cpu().numpy()

    def sweep(
        self,
        batches_factory: Callable[[], Iterable],
        save_predictions: str | None = None,
        deteval_dir: str | None = None,
        bn_warmup: int = 0,
    ) -> EvalResults:
        """Evaluate every snapshot not yet in ``eval_results.json``.

        ``batches_factory()`` returns a fresh iterable of (images (N, H, W,
        3) float in [0, 1], gt boxes (N, R, 4), ...) numpy batches. With
        ``save_predictions``, renders go to ``<dir>/<iteration>/<i>.png``;
        with ``deteval_dir``, ``deteval_<iteration>.xml`` is written there.
        """
        done = self.results.evaluated_snapshots()
        for iteration, path in checkpoint.list_snapshots(self.log_dir, self.snapshot_prefix):
            name = os.path.basename(path)
            if name in done:
                continue
            try:
                start = time.perf_counter()
                self.load_snapshot(path, batches_factory, bn_warmup)
                images = [0]

                def counted(batches):
                    for batch in batches:
                        images[0] += batch[0].shape[0]
                        yield batch

                score_start = time.perf_counter()
                metrics = self.map_eval(self.state, counted(self._on_device(batches_factory())), self.assessor)
                score_s = time.perf_counter() - score_start
                entry = {"snapshot_name": name, "iteration": iteration,
                         **{k: float(v) for k, v in metrics.items()}}
                self.results.append(entry)
                if save_predictions:
                    self._render_predictions(batches_factory(), iteration, save_predictions)
                if deteval_dir:
                    self._write_deteval(batches_factory(), iteration, deteval_dir)
                seconds = time.perf_counter() - start
                self.results.timings[name] = {"seconds": seconds, "score_seconds": score_s, "images": images[0]}
                print(f"{name}: map={entry.get('map', 0):.4f} mean_iou={entry.get('mean_iou', 0):.4f} "
                      f"({seconds:.2f} s; scoring {images[0] / score_s:.1f} images/s on {self.device})")
            except Exception:
                print(f"evaluation of {name} failed:")
                traceback.print_exc()
        return self.results

    def _write_deteval(self, batches: Iterable, iteration: int, out_dir: str) -> None:
        writer = DetEvalWriter()
        idx = 0
        for batch in self._on_device(batches):
            boxes = self.predict(batch[0])
            for n in range(boxes.shape[0]):
                writer.add_image(f"{idx}.png", boxes[n : n + 1])
                idx += 1
        os.makedirs(out_dir, exist_ok=True)
        writer.write(os.path.join(out_dir, f"deteval_{iteration}.xml"))

    def _render_predictions(self, batches: Iterable, iteration: int, out_dir: str) -> None:
        dest = os.path.join(out_dir, str(iteration))
        os.makedirs(dest, exist_ok=True)
        idx = 0
        for batch in batches:
            images, gt = np.asarray(batch[0]), np.asarray(batch[1])
            boxes = self.predict(torch.as_tensor(images).to(self.device))
            for n in range(boxes.shape[0]):
                gt_n = gt[n].reshape(-1, 4)
                gt_n = gt_n[np.abs(gt_n).sum(axis=1) > 0]
                canvas = draw_boxes_on_image((images[n] * 255).astype(np.uint8), boxes[n : n + 1], gt_boxes=gt_n)
                write_png(os.path.join(dest, f"{idx}.png"), canvas)
                idx += 1

    def plot(self, out_name: str = "plot.png", keys=("map", "mean_iou")) -> str | None:
        """Metric curves over iterations (``<log_dir>/<out_name>``, with
        matplotlib) and the best snapshot by mAP. Without matplotlib the
        report is printed and one line says that no curve was drawn."""
        entries = sorted((e for e in self.results.entries if "iteration" in e), key=lambda e: e["iteration"])
        if not entries:
            return None
        path = None
        try:
            matplotlib = importlib.import_module("matplotlib")
        except ImportError:
            print("no metric curve drawn: matplotlib is not installed")
        else:
            matplotlib.use("Agg")
            plt = importlib.import_module("matplotlib.pyplot")
            fig, ax = plt.subplots(figsize=(8, 5))
            its = [e["iteration"] for e in entries]
            for key in keys:
                ax.plot(its, [e.get(key, 0.0) for e in entries], label=key)
            ax.set_xlabel("iteration")
            ax.legend()
            path = os.path.join(self.log_dir, out_name)
            fig.savefig(path, dpi=120)
            plt.close(fig)
        best = self.results.best("map")
        if best:
            print(f"best snapshot: {best['snapshot_name']} (map={best['map']:.4f})")
        return path
