"""Padded, fixed-shape detection containers and box helpers.

Conventions follow the JAX package: boxes are XYXY float32 in image pixels,
shape [..., N, 4]; a `valid` bool mask marks live rows, padded rows hold
zeros.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Detections(NamedTuple):
    """A padded set of (proposal or final) detections for one image."""
    boxes: torch.Tensor       # [N, 4] xyxy
    scores: torch.Tensor      # [N]
    classes: torch.Tensor     # [N] int32 (0 for class-agnostic proposals)
    valid: torch.Tensor       # [N] bool


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
