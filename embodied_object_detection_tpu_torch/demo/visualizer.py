"""Detections and the semantic map, drawn on the host.

Counterpart of the JAX package's `demo/visualizer.py` (ref:
Detic/detic/visualizer.py and the map and legend rendering of
custom_rcnn.py:986-1015 / robot_demo.py:571-601), for what the demos and
the predictor draw: detection boxes with labels, the class map, a legend.
numpy on the host; cv2 is imported in each drawing method that needs it.
Detections may hold numpy arrays or CPU tensors.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..structures import Detections


def color_palette(n: int) -> np.ndarray:
    """[n, 3] uint8 class colours: 20 fixed, then seeded random ones."""
    base = np.array([
        [230, 25, 75], [60, 180, 75], [255, 225, 25], [0, 130, 200],
        [245, 130, 48], [145, 30, 180], [70, 240, 240], [240, 50, 230],
        [210, 245, 60], [250, 190, 212], [0, 128, 128], [220, 190, 255],
        [170, 110, 40], [255, 250, 200], [128, 0, 0], [170, 255, 195],
        [128, 128, 0], [255, 215, 180], [0, 0, 128], [128, 128, 128]],
        np.uint8)
    if n <= len(base):
        return base[:n]
    rng = np.random.RandomState(3)
    return np.concatenate([base, rng.randint(0, 255, (n - len(base), 3),
                                             dtype=np.int64).astype(np.uint8)])


class Visualizer:
    """Draws detections, the semantic map and a legend in one palette."""

    def __init__(self, class_names: Sequence[str]):
        self.class_names = list(class_names)
        self.palette = color_palette(len(class_names))

    def _color(self, cls: int):
        return tuple(int(x) for x in self.palette[cls % len(self.palette)])

    def draw_detections(self, image_rgb: np.ndarray, dets: Detections,
                        score_thresh: float = 0.3) -> np.ndarray:
        """Boxes and "name score" labels of the valid detections at or
        above `score_thresh`, highest score first, on an RGB uint8 copy."""
        import cv2
        img = np.array(image_rgb, np.uint8, copy=True)
        boxes = np.asarray(dets.boxes)
        scores = np.asarray(dets.scores)
        classes = np.asarray(dets.classes)
        valid = np.asarray(dets.valid)
        hh, ww = img.shape[:2]
        for i in np.argsort(-scores):
            if not valid[i] or scores[i] < score_thresh:
                continue
            if not np.all(np.isfinite(boxes[i])):
                continue
            color = self._color(int(classes[i]))
            b = np.clip(boxes[i], [-ww, -hh, -ww, -hh],
                        [2 * ww, 2 * hh, 2 * ww, 2 * hh]).astype(int)
            cv2.rectangle(img, (b[0], b[1]), (b[2], b[3]), color, 2)
            name = self.class_names[int(classes[i]) % len(self.class_names)]
            cv2.putText(img, f"{name} {scores[i]:.2f}",
                        (b[0], max(b[1] - 4, 10)), cv2.FONT_HERSHEY_SIMPLEX,
                        0.5, color, 1, cv2.LINE_AA)
        return img

    def draw_semmap(self, semmap_classes: np.ndarray, scale: int = 4
                    ) -> np.ndarray:
        """[H, W] int32 class map (-1 unobserved) -> RGB image, each cell
        a scale x scale block."""
        semmap_classes = np.asarray(semmap_classes)
        h, w = semmap_classes.shape
        img = np.zeros((h, w, 3), np.uint8)
        obs = semmap_classes >= 0
        img[obs] = self.palette[semmap_classes[obs] % len(self.palette)]
        return np.kron(img, np.ones((scale, scale, 1), np.uint8))

    def legend(self, height: int = 480, width: int = 200) -> np.ndarray:
        """Colour legend strip (ref: custom_rcnn.py:992-1009)."""
        import cv2
        img = np.zeros((height, width, 3), np.uint8)
        block = max(height // max(len(self.class_names), 1), 1)
        for i, name in enumerate(self.class_names):
            y0, y1 = i * block, min((i + 1) * block, height)
            img[y0:y1] = self.palette[i % len(self.palette)]
            cv2.putText(img, name, (4, y0 + block // 2 + 4),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.4, (255, 255, 255), 1,
                        cv2.LINE_AA)
        return img
