"""Receptive-field arithmetic over static conv ladders (port of
``loans_tpu/utils/receptive_field.py``; pure arithmetic).

A ladder is the ``(kind, kernel, stride, pad)`` steps from a network's
input to a feature map, as ``models/resnet.py::resnet_vbp_ladder`` and
``Localizer.vbp_ladder()`` give them for VisualBackprop.
``calculate_receptive_fields`` gives each depth's receptive field and
``bbox_to_feature_coords`` maps an input-pixel box onto the deepest
feature map.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence


@dataclass(frozen=True)
class ReceptiveField:
    """The receptive field of one ladder depth: its size, its total stride
    and the center of feature (0, 0) in input pixels."""

    size: int
    stride: int
    offset: float


def calculate_receptive_fields(ladder: Sequence[tuple]) -> list[ReceptiveField]:
    """The cumulative receptive field after each ladder step, by the
    recurrence r' = r + (k - 1) j, j' = j s, start' = start + ((k - 1) / 2 - p) j."""
    out = []
    r, j, start = 1, 1, 0.5
    for _kind, k, s, p in ladder:
        r = r + (k - 1) * j
        start = start + ((k - 1) / 2 - p) * j
        j = j * s
        out.append(ReceptiveField(size=r, stride=j, offset=start))
    return out


def bbox_to_feature_coords(bbox, ladder: Sequence[tuple]) -> tuple[float, float, float, float]:
    """An input-pixel (y1, x1, y2, x2) box in the coordinates of the
    ladder's deepest feature map."""
    rf = calculate_receptive_fields(ladder)[-1]
    y1, x1, y2, x2 = (float(v) for v in bbox)
    return tuple((v - rf.offset) / rf.stride for v in (y1, x1, y2, x2))
