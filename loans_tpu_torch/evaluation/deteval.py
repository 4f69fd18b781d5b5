"""DetEval XML export (a copy of ``loans_tpu/evaluation/deteval.py``).

Accumulates one ``<image>`` element per evaluated sample with predicted
``taggedRectangles`` and writes the deteval-compatible XML document.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET

import numpy as np


class DetEvalWriter:
    def __init__(self):
        self.root = ET.Element("tagset")

    def add_image(
        self,
        image_name: str,
        boxes: np.ndarray,
        scores=None,
    ) -> None:
        """``boxes`` are (N, 4) (y_min, x_min, y_max, x_max) pixels."""
        img_el = ET.SubElement(self.root, "image")
        ET.SubElement(img_el, "imageName").text = str(image_name)
        rects = ET.SubElement(img_el, "taggedRectangles")
        for i, (y1, x1, y2, x2) in enumerate(
            np.asarray(boxes, dtype=np.float64).reshape(-1, 4)
        ):
            attrib = {
                "x": f"{x1:.2f}",
                "y": f"{y1:.2f}",
                "width": f"{x2 - x1:.2f}",
                "height": f"{y2 - y1:.2f}",
            }
            if scores is not None and i < len(scores):
                attrib["modelType"] = f"{float(scores[i]):.4f}"
            ET.SubElement(rects, "taggedRectangle", attrib)

    def write(self, path: str) -> str:
        ET.indent(ET.ElementTree(self.root))
        ET.ElementTree(self.root).write(
            path, encoding="utf-8", xml_declaration=True
        )
        return path
