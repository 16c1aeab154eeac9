"""Detections and the semantic map, drawn on the host.

Counterpart of the JAX package's `demo/visualizer.py` (ref:
Detic/detic/visualizer.py and the map and legend rendering of
custom_rcnn.py:986-1015 / robot_demo.py:571-601): detection boxes with
labels (and mask overlays), ground-truth boxes, mask contours, the class
map, a legend, and the CenterNet debug dumps (heatmap overlays of each
level, ref: centernet/modeling/debug.py). numpy on the host; cv2 and PIL
are imported in each function that needs them. Detections may hold numpy
arrays or CPU tensors.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

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
                        score_thresh: float = 0.3,
                        masks: Optional[np.ndarray] = None) -> np.ndarray:
        """Boxes and "name score" labels of the valid detections at or
        above `score_thresh`, highest score first, on an RGB uint8 copy;
        with `masks` [N, H, W], each drawn detection's mask blended half
        into its colour first."""
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
            if masks is not None:
                m = np.asarray(masks[i], bool)
                overlay = img.copy()
                overlay[m] = (0.5 * np.array(color) +
                              0.5 * img[m]).astype(np.uint8)
                img = overlay
            cv2.rectangle(img, (b[0], b[1]), (b[2], b[3]), color, 2)
            name = self.class_names[int(classes[i]) % len(self.class_names)]
            cv2.putText(img, f"{name} {scores[i]:.2f}",
                        (b[0], max(b[1] - 4, 10)), cv2.FONT_HERSHEY_SIMPLEX,
                        0.5, color, 1, cv2.LINE_AA)
        return img

    def draw_ground_truth(self, image_rgb: np.ndarray, boxes: np.ndarray,
                          classes: np.ndarray,
                          valid: Optional[np.ndarray] = None) -> np.ndarray:
        """The valid GT boxes, 1 px in their class colour, on a copy."""
        import cv2
        img = np.array(image_rgb, np.uint8, copy=True)
        valid = np.ones(len(boxes), bool) if valid is None else valid
        for b, c, v in zip(np.asarray(boxes), np.asarray(classes), valid):
            if not v:
                continue
            b = b.astype(int)
            cv2.rectangle(img, (b[0], b[1]), (b[2], b[3]),
                          self._color(int(c)), 1)
        return img

    def draw_mask_boundaries(self, image_rgb: np.ndarray, masks: np.ndarray,
                             classes: Optional[np.ndarray] = None,
                             valid: Optional[np.ndarray] = None,
                             thickness: int = 1) -> np.ndarray:
        """Each valid instance mask's outer contours in its class colour
        (the reference Visualizer's polygon edges, detic/visualizer.py)."""
        import cv2
        img = np.array(image_rgb, np.uint8, copy=True)
        masks = np.asarray(masks, bool)
        n = masks.shape[0]
        classes = np.zeros(n, np.int32) if classes is None else classes
        valid = np.ones(n, bool) if valid is None else valid
        for i in range(n):
            if not valid[i]:
                continue
            contours, _ = cv2.findContours(masks[i].astype(np.uint8),
                                           cv2.RETR_EXTERNAL,
                                           cv2.CHAIN_APPROX_SIMPLE)
            cv2.drawContours(img, contours, -1, self._color(int(classes[i])),
                             thickness)
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


def heatmap_color_image(heatmap: np.ndarray) -> np.ndarray:
    """[H, W] in [0, 1] -> RGB uint8 on a red-to-yellow ramp (ref:
    centernet/modeling/debug.py _get_color_image; an agnostic map takes
    one ramp)."""
    h = np.clip(np.asarray(heatmap, np.float32), 0, 1)
    img = np.zeros((*h.shape, 3), np.float32)
    img[..., 0] = 255 * h
    img[..., 1] = 255 * np.clip(2 * h - 1, 0, 1)
    return img.astype(np.uint8)


def blend_heatmap(image_rgb: np.ndarray, heatmap: np.ndarray,
                  alpha: float = 0.7) -> np.ndarray:
    """A level's heatmap resized (bilinear) to the image and blended over
    it, each pixel by alpha times its heat (ref: debug.py _blend_image)."""
    import cv2
    img = np.asarray(image_rgb, np.uint8)
    hm_up = cv2.resize(np.asarray(heatmap, np.float32),
                       (img.shape[1], img.shape[0]),
                       interpolation=cv2.INTER_LINEAR)
    color = heatmap_color_image(hm_up).astype(np.float32)
    w = alpha * np.clip(hm_up, 0, 1)[..., None]
    return (img.astype(np.float32) * (1 - w) + color * w).astype(np.uint8)


def debug_train_dump(image_rgb: np.ndarray, agn_heatmaps, gt_boxes,
                     gt_classes, gt_valid, class_names, out_dir: str,
                     prefix: str = "train") -> List[str]:
    """Each level's heatmap ([H_l, W_l] or [H_l, W_l, 1] in [0, 1]: the
    targets or the sigmoid outputs) over the image with its GT boxes,
    saved as `{prefix}_hm_l{level}.png` in `out_dir` (ref: debug.py
    debug_train:73-139). Returns the paths."""
    from PIL import Image
    os.makedirs(out_dir, exist_ok=True)
    boxed = Visualizer(class_names).draw_ground_truth(
        image_rgb, gt_boxes, gt_classes, gt_valid)
    paths = []
    for lvl, hm in enumerate(agn_heatmaps):
        p = os.path.join(out_dir, f"{prefix}_hm_l{lvl}.png")
        Image.fromarray(blend_heatmap(boxed, np.asarray(hm).reshape(
            hm.shape[0], hm.shape[1]))).save(p)
        paths.append(p)
    return paths


def debug_test_dump(image_rgb: np.ndarray, agn_heatmaps, dets: Detections,
                    class_names, out_dir: str, prefix: str = "test",
                    vis_thresh: float = 0.3) -> List[str]:
    """The detections (`{prefix}_dets.png`) and each level's agnostic
    heatmap over the image (`{prefix}_agn_l{level}.png`) in `out_dir`
    (ref: debug.py debug_test:141-216). Returns the paths."""
    from PIL import Image
    os.makedirs(out_dir, exist_ok=True)
    p0 = os.path.join(out_dir, f"{prefix}_dets.png")
    Image.fromarray(Visualizer(class_names).draw_detections(
        image_rgb, dets, score_thresh=vis_thresh)).save(p0)
    paths = [p0]
    for lvl, hm in enumerate(agn_heatmaps):
        p = os.path.join(out_dir, f"{prefix}_agn_l{lvl}.png")
        Image.fromarray(blend_heatmap(image_rgb, np.asarray(hm).reshape(
            hm.shape[0], hm.shape[1]))).save(p)
        paths.append(p)
    return paths


def legend_strip(class_names: Sequence[str], height: int = 480,
                 width: int = 200) -> np.ndarray:
    """`Visualizer(class_names).legend(height, width)`."""
    return Visualizer(class_names).legend(height, width)
