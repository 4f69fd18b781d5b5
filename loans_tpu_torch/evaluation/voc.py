"""PASCAL-VOC detection evaluation, chainercv semantics (a copy of
``loans_tpu/evaluation/voc.py``, which has no JAX in it but sits in a
package that imports JAX).

Reimplements ``chainercv.evaluations.eval_detection_voc`` as consumed by
the reference (``sheep/sheep_evaluator.py:57-66``, ``evaluate.py:286``,
``schaaaafrichter/evaluate.py``): greedy per-image matching of
score-sorted predictions against ground truth at ``iou_thresh``, each gt
box matched at most once, AP by continuous area-under-PR (default) or
the 11-point VOC2007 metric. Boxes are ``(y_min, x_min, y_max, x_max)``.

Host-side numpy: eval batches are small and ragged (variable #boxes per
image); the model forward that produces the boxes runs on the card
(``evaluation/intraining.py``).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Iterable

import numpy as np


def _bbox_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU, (N,4)x(M,4) -> (N,M), yxyx convention."""
    if a.size == 0 or b.size == 0:
        return np.zeros((a.shape[0], b.shape[0]), dtype=np.float64)
    tl = np.maximum(a[:, None, :2], b[None, :, :2])
    br = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.prod(np.clip(br - tl, 0, None), axis=2) * (br > tl).all(axis=2)
    area_a = np.prod(a[:, 2:] - a[:, :2], axis=1)
    area_b = np.prod(b[:, 2:] - b[:, :2], axis=1)
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def calc_detection_voc_prec_rec(
    pred_bboxes: Iterable[np.ndarray],
    pred_labels: Iterable[np.ndarray],
    pred_scores: Iterable[np.ndarray],
    gt_bboxes: Iterable[np.ndarray],
    gt_labels: Iterable[np.ndarray],
    gt_difficults: Iterable[np.ndarray] | None = None,
    iou_thresh: float = 0.5,
):
    """Per-class precision/recall curves (chainercv-compatible)."""
    n_pos: dict[int, int] = defaultdict(int)
    score: dict[int, list] = defaultdict(list)
    match: dict[int, list] = defaultdict(list)

    gt_bboxes = list(gt_bboxes)
    if gt_difficults is None:
        gt_difficults = [None] * len(gt_bboxes)

    for pred_bbox, pred_label, pred_score, gt_bbox, gt_label, gt_diff in zip(
        pred_bboxes, pred_labels, pred_scores, gt_bboxes, gt_labels,
        gt_difficults,
    ):
        pred_bbox = np.asarray(pred_bbox, dtype=np.float64).reshape(-1, 4)
        pred_label = np.asarray(pred_label, dtype=np.int64).reshape(-1)
        pred_score = np.asarray(pred_score, dtype=np.float64).reshape(-1)
        gt_bbox = np.asarray(gt_bbox, dtype=np.float64).reshape(-1, 4)
        gt_label = np.asarray(gt_label, dtype=np.int64).reshape(-1)
        if gt_diff is None:
            gt_diff = np.zeros(gt_bbox.shape[0], dtype=bool)
        else:
            gt_diff = np.asarray(gt_diff, dtype=bool).reshape(-1)

        for lb in np.unique(
            np.concatenate((pred_label, gt_label)).astype(np.int64)
        ):
            pred_mask = pred_label == lb
            pb = pred_bbox[pred_mask]
            ps = pred_score[pred_mask]
            order = ps.argsort()[::-1]
            pb, ps = pb[order], ps[order]

            gt_mask = gt_label == lb
            gb = gt_bbox[gt_mask]
            gd = gt_diff[gt_mask]

            n_pos[lb] += int(np.logical_not(gd).sum())
            score[lb].extend(ps)
            if len(pb) == 0:
                continue
            if len(gb) == 0:
                match[lb].extend((0,) * pb.shape[0])
                continue

            # chainercv offsets br by -1 for the pixel convention
            pb = pb.copy()
            pb[:, 2:] += 1
            gb = gb.copy()
            gb[:, 2:] += 1

            iou = _bbox_iou(pb, gb)
            gt_index = iou.argmax(axis=1)
            gt_index[iou.max(axis=1) < iou_thresh] = -1

            selec = np.zeros(gb.shape[0], dtype=bool)
            for gt_idx in gt_index:
                if gt_idx >= 0:
                    if gd[gt_idx]:
                        match[lb].append(-1)
                    elif not selec[gt_idx]:
                        match[lb].append(1)
                        selec[gt_idx] = True
                    else:
                        match[lb].append(0)
                else:
                    match[lb].append(0)

    n_fg_class = max(n_pos.keys(), default=-1) + 1
    prec = [None] * n_fg_class
    rec = [None] * n_fg_class
    for lb in n_pos.keys():
        score_l = np.asarray(score[lb])
        match_l = np.asarray(match[lb], dtype=np.int8)
        order = score_l.argsort()[::-1]
        match_l = match_l[order]
        tp = np.cumsum(match_l == 1)
        fp = np.cumsum(match_l == 0)
        prec[lb] = tp / np.maximum(fp + tp, 1e-12)
        rec[lb] = tp / n_pos[lb] if n_pos[lb] > 0 else None
    return prec, rec


def calc_detection_voc_ap(prec, rec, use_07_metric: bool = False):
    """AP per class from precision/recall curves."""
    n_fg_class = len(prec)
    ap = np.empty(n_fg_class)
    for lb in range(n_fg_class):
        if prec[lb] is None or rec[lb] is None:
            ap[lb] = np.nan
            continue
        if use_07_metric:
            ap[lb] = 0.0
            for t in np.arange(0.0, 1.1, 0.1):
                if np.sum(rec[lb] >= t) == 0:
                    p = 0.0
                else:
                    p = np.max(np.nan_to_num(prec[lb])[rec[lb] >= t])
                ap[lb] += p / 11
        else:
            mpre = np.concatenate(([0], np.nan_to_num(prec[lb]), [0]))
            mrec = np.concatenate(([0], rec[lb], [1]))
            mpre = np.maximum.accumulate(mpre[::-1])[::-1]
            i = np.where(mrec[1:] != mrec[:-1])[0]
            ap[lb] = np.sum((mrec[i + 1] - mrec[i]) * mpre[i + 1])
    return ap


def eval_detection_voc(
    pred_bboxes,
    pred_labels,
    pred_scores,
    gt_bboxes,
    gt_labels,
    gt_difficults=None,
    iou_thresh: float = 0.5,
    use_07_metric: bool = False,
):
    """Full VOC eval -> {'ap': per-class array, 'map': scalar}."""
    prec, rec = calc_detection_voc_prec_rec(
        pred_bboxes,
        pred_labels,
        pred_scores,
        gt_bboxes,
        gt_labels,
        gt_difficults,
        iou_thresh=iou_thresh,
    )
    ap = calc_detection_voc_ap(prec, rec, use_07_metric=use_07_metric)
    return {"ap": ap, "map": float(np.nanmean(ap))}
