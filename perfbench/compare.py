"""The comparisons that decide ``correct``: each number compared is worked
out here from the program's readings and the reference's, and is held to
the limit that the cell's workload file states.

Training (``train``): each of the first steps' losses, the norm of each
leaf's first gradient (as the optimiser got it), and the norm of each
leaf's change over those steps, each gap taken by the worst leaf against
the reference's norm of that leaf or of the median leaf, whichever is
larger. Leaves whose first gradient in the reference is under a thousandth
of the median leaf's move by round-off alone and are left out of the
change. Where the readings hold the optimiser's moments (AMSGrad's mu and
nu_max), the norm of each leaf's moment after each step is compared the
same way, over every leaf.

Serving (``serve``): the boxes, the crops and the assessor scores of each
sampled frame, and the gate. A frame whose reference score lies within
``margin`` of the threshold may fall on either side of it; every other
frame's gate has to agree, and boxes are compared where both sides left the
frame ungated.
"""

from __future__ import annotations

import statistics

import numpy as np

SMALL_GRADIENT = 1e-3


def _leaf_gaps(prog: dict[str, float], ref: dict[str, float], keys) -> list[float]:
    keys = list(keys)
    median = statistics.median(ref[k] for k in keys)
    return [abs(prog[k] - ref[k]) / max(ref[k], median) for k in keys]


def _rel(a, b) -> float:
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), np.finfo(np.float32).tiny)))


def train(prog: dict, ref: dict) -> dict[str, float]:
    """``loss<k>_rel``: the k-th step's two losses, relative; ``grad1_gap``
    and ``change_gap``: the worst leaf; ``grad1_median_gap`` and
    ``change_median_gap``: the median leaf's gap; ``<moment><k>_gap`` and
    ``<moment><k>_median_gap``: the same for a moment after the k-th step;
    ``left_out``: how many leaves the change leaves out."""
    losses_p, losses_r = np.asarray(prog["losses"], float), np.asarray(ref["losses"], float)
    if losses_p.shape != losses_r.shape:
        raise ValueError(f"loss readings of shapes {losses_p.shape} and {losses_r.shape}")
    median_g = statistics.median(ref["grad1"].values())
    moved = [k for k, g in ref["grad1"].items() if g >= SMALL_GRADIENT * median_g]
    grad = _leaf_gaps(prog["grad1"], ref["grad1"], ref["grad1"])
    change = _leaf_gaps(prog["change"], ref["change"], moved)
    out = {f"loss{k + 1}_rel": _rel(losses_p[k], losses_r[k]) for k in range(len(losses_r))}
    out.update(grad1_gap=max(grad), grad1_median_gap=statistics.median(grad),
               change_gap=max(change), change_median_gap=statistics.median(change),
               left_out=float(len(ref["grad1"]) - len(moved)))
    if "moments" in prog and "moments" in ref:
        for k, (mp, mr) in enumerate(zip(prog["moments"], ref["moments"], strict=True)):
            for m in mr:
                gaps = _leaf_gaps(mp[m], mr[m], mr[m])
                out[f"{m}{k + 1}_gap"], out[f"{m}{k + 1}_median_gap"] = max(gaps), statistics.median(gaps)
    return out


def serve(prog: dict, ref: dict, threshold: float, margin: float) -> dict[str, float]:
    """``prog``: the served, gated (N, 4) boxes, (N, h, w, c) crops and (N,)
    scores; ``ref``: the reference's ungated ones, numpy arrays."""
    score_r = ref["scores"]
    sure = np.abs(score_r - threshold) > margin
    gate_r = score_r < threshold
    gate_p = (prog["scores"] == 0) & np.all(prog["boxes"] == 0, axis=1)
    open_both = ~gate_r & ~gate_p
    score_gap = np.abs(prog["scores"] - score_r)[~gate_p]
    box_gap = np.abs(prog["boxes"] - ref["boxes"])[open_both]
    return {
        "gate_flips": float(np.sum((gate_p != gate_r) & sure)),
        "boxes_px": float(box_gap.max()) if box_gap.size else 0.0,
        "crops_abs": float(np.max(np.abs(prog["rois"] - ref["rois"]))),
        "scores_abs": float(score_gap.max()) if score_gap.size else 0.0,
    }


def verdict(numbers: dict[str, float], limits: dict[str, float]) -> bool:
    """Every number at or under its limit (a NaN fails)."""
    missing = set(limits) - set(numbers)
    if missing:
        raise KeyError(f"no reading for the limits {sorted(missing)}")
    return all(numbers[k] <= limits[k] for k in limits)
