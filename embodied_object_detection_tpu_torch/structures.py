"""Padded, fixed-shape detection containers and box helpers.

Conventions follow the JAX package: boxes are XYXY float32 in image pixels,
shape [..., N, 4]; a `valid` bool mask marks live rows, padded rows hold
zeros.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Detections(NamedTuple):
    """A padded set of (proposal or final) detections for one image."""
    boxes: torch.Tensor       # [N, 4] xyxy
    scores: torch.Tensor      # [N]
    classes: torch.Tensor     # [N] int32 (0 for class-agnostic proposals)
    valid: torch.Tensor       # [N] bool

    @property
    def capacity(self) -> int:
        return self.boxes.shape[-2]

    def num_valid(self) -> torch.Tensor:
        """Live rows a set, int32 [...] (no host sync)."""
        return self.valid.sum(dim=-1, dtype=torch.int32)


class GroundTruth(NamedTuple):
    """Padded ground-truth boxes of one frame, or of a batch with a
    leading [B] axis."""
    boxes: torch.Tensor       # [G, 4] xyxy
    classes: torch.Tensor     # [G] int32
    valid: torch.Tensor       # [G] bool


class MemoryState(NamedTuple):
    """The recurrent spatial memory carry.

    features:  [max_cells, D] float32 running sum of projected features
    obs_count: [max_cells] float32 per-cell observation counts
    """
    features: torch.Tensor
    obs_count: torch.Tensor

    @staticmethod
    def zeros(max_cells: int, dim: int = 512,
              device: "torch.device | str" = "cuda") -> "MemoryState":
        return MemoryState(
            features=torch.zeros((max_cells, dim), dtype=torch.float32,
                                 device=device),
            obs_count=torch.zeros((max_cells,), dtype=torch.float32,
                                  device=device))


def pad_boxes(boxes: np.ndarray, classes: np.ndarray,
              capacity: int) -> GroundTruth:
    """On the host: variable-length GT padded to `capacity` rows, as a
    `GroundTruth` of numpy arrays (f32 boxes, int32 classes, bool valid);
    rows beyond `capacity` are dropped."""
    boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
    classes = np.asarray(classes, np.int32).reshape(-1)
    n = min(len(boxes), capacity)
    out_b = np.zeros((capacity, 4), np.float32)
    out_c = np.zeros((capacity,), np.int32)
    out_v = np.zeros((capacity,), bool)
    out_b[:n] = boxes[:n]
    out_c[:n] = classes[:n]
    out_v[:n] = True
    return GroundTruth(boxes=out_b, classes=out_c, valid=out_v)


def area(boxes: torch.Tensor) -> torch.Tensor:
    return (boxes[..., 2] - boxes[..., 0]).clamp(min=0) * \
        (boxes[..., 3] - boxes[..., 1]).clamp(min=0)


def pairwise_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU matrix between two XYXY box sets: [N, M]; 0 where the union is
    empty (padded all-zero boxes)."""
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area(a)[:, None] + area(b)[None, :] - inter
    return torch.where(union > 0, inter / union.clamp(min=1e-12),
                       torch.zeros_like(inter))


def giou_xyxy(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise generalized IoU between broadcast XYXY box arrays."""
    ix1 = torch.maximum(a[..., 0], b[..., 0])
    iy1 = torch.maximum(a[..., 1], b[..., 1])
    ix2 = torch.minimum(a[..., 2], b[..., 2])
    iy2 = torch.minimum(a[..., 3], b[..., 3])
    inter = (ix2 - ix1).clamp(min=0) * (iy2 - iy1).clamp(min=0)
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    union = area_a + area_b - inter
    iou = inter / union.clamp(min=1e-7)
    cx1 = torch.minimum(a[..., 0], b[..., 0])
    cy1 = torch.minimum(a[..., 1], b[..., 1])
    cx2 = torch.maximum(a[..., 2], b[..., 2])
    cy2 = torch.maximum(a[..., 3], b[..., 3])
    area_c = (cx2 - cx1) * (cy2 - cy1)
    return iou - (area_c - union) / area_c.clamp(min=1e-7)


def clip_boxes(boxes: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Clip XYXY boxes to the image bounds."""
    return torch.stack([boxes[..., 0].clamp(0, width),
                        boxes[..., 1].clamp(0, height),
                        boxes[..., 2].clamp(0, width),
                        boxes[..., 3].clamp(0, height)], dim=-1)


def nonempty(boxes: torch.Tensor, threshold: float = 0.0) -> torch.Tensor:
    """bool mask of boxes with positive extent."""
    return ((boxes[..., 2] - boxes[..., 0]) > threshold) & \
        ((boxes[..., 3] - boxes[..., 1]) > threshold)
