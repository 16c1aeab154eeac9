"""CenterNet proposal generator (ONLY_PROPOSAL + WITH_AGN_HM mode).

Counterpart of the JAX package's `models/centernet.py`: a bbox tower of
3x3 conv + GroupNorm(32) + ReLU shared across the five levels, an f32
agnostic-heatmap conv and an f32 ltrb regression conv scaled per level,
and a fixed-shape decode (per-level top-k, a candidate cap, NMS at 0.9;
the training settings take 4000 -> 2000 proposals).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import CenterNetConfig
from ..ops.nms import NEG_INF, nms_padded, sort_desc, topk_padded
from ..structures import Detections
from .layers import GroupNorm, conv, nchw, nhwc


class Scale(nn.Module):
    """Per-level learnable scalar."""

    def __init__(self):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.scale.to(x.dtype)


class CenterNetHead(nn.Module):

    def __init__(self, num_levels: int = 5, in_channels: int = 256,
                 num_box_convs: int = 4,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.num_box_convs = num_box_convs
        for i in range(num_box_convs):
            self.add_module(f"bbox_tower_conv{i}", nn.Conv2d(
                in_channels, in_channels, 3, 1, 1))
            self.add_module(f"bbox_tower_gn{i}", GroupNorm(32, in_channels))
        self.agn_hm = nn.Conv2d(in_channels, 1, 3, 1, 1)
        self.bbox_pred = nn.Conv2d(in_channels, 4, 3, 1, 1)
        for i in range(num_levels):
            self.add_module(f"scale{i}", Scale())

    def forward(self, features: Sequence[torch.Tensor]
                ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """Per-level [H, W, C] -> (heatmap logits [H, W, 1], regressions
        [H, W, 4]) per level, both f32."""
        agn_hms, regs = [], []
        for lvl, feat in enumerate(features):
            x = nchw(feat)
            for i in range(self.num_box_convs):
                x = conv(x, getattr(self, f"bbox_tower_conv{i}"), self.dtype)
                x = getattr(self, f"bbox_tower_gn{i}")(x).to(self.dtype)
                x = F.relu(x)
            agn_hms.append(nhwc(conv(x, self.agn_hm), batched=False))
            reg = getattr(self, f"scale{lvl}")(conv(x, self.bbox_pred))
            regs.append(nhwc(F.relu(reg), batched=False))
        return agn_hms, regs


def level_grids(shapes: Sequence[Tuple[int, int]], strides: Sequence[int],
                device: "torch.device | str" = "cpu") -> List[torch.Tensor]:
    """Per-level [H*W, 2] grid centres: index * stride + stride // 2."""
    grids = []
    for (h, w), s in zip(shapes, strides):
        xs = torch.arange(w, dtype=torch.float32, device=device) * s + s // 2
        ys = torch.arange(h, dtype=torch.float32, device=device) * s + s // 2
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        grids.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1))
    return grids


def decode_proposals(agn_hms: Sequence[torch.Tensor],
                     regs: Sequence[torch.Tensor],
                     cfg: CenterNetConfig, training: bool = False
                     ) -> Detections:
    """Heatmaps + regressions -> top-k NMS'd proposals (fixed shape):
    per-level top `pre_nms_topk`, boxes = grid -/+ reg * stride with at
    least 0.01 extent, score = sqrt(sigmoid), class-agnostic NMS (none
    with `not_nms`), top `post_nms_topk`; the train or test settings."""
    if training:
        pre_topk, post_topk = cfg.pre_nms_topk_train, cfg.post_nms_topk_train
        nms_thresh = cfg.nms_thresh_train
    else:
        pre_topk, post_topk = cfg.pre_nms_topk_test, cfg.post_nms_topk_test
        nms_thresh = cfg.nms_thresh_test
    shapes = [(hm.shape[0], hm.shape[1]) for hm in agn_hms]
    grids = level_grids(shapes, cfg.strides, device=agn_hms[0].device)

    all_boxes, all_scores, all_valid = [], [], []
    for hm, reg, grid, stride in zip(agn_hms, regs, grids, cfg.strides):
        scores = torch.sigmoid(hm.reshape(-1).float())
        reg = reg.reshape(-1, 4).float() * stride
        top_scores, top_idx = sort_desc(scores, min(pre_topk, scores.shape[0]))
        g, r = grid[top_idx], reg[top_idx]
        x1 = g[:, 0] - r[:, 0]
        y1 = g[:, 1] - r[:, 1]
        x2 = torch.maximum(g[:, 0] + r[:, 2], x1 + 0.01)
        y2 = torch.maximum(g[:, 1] + r[:, 3], y1 + 0.01)
        all_boxes.append(torch.stack([x1, y1, x2, y2], dim=-1))
        all_scores.append(torch.sqrt(top_scores))
        all_valid.append(top_scores > cfg.score_thresh)
    boxes = torch.cat(all_boxes)
    scores = torch.cat(all_scores)
    valid = torch.cat(all_valid)

    cap = cfg.nms_candidate_cap
    if cap:
        # a cost cap only: never below the requested output size
        cap = max(cap, post_topk)
    if cap and cap < boxes.shape[0]:
        key = torch.where(valid, scores, scores.new_full((), NEG_INF))
        _, keep = sort_desc(key, cap)
        boxes, scores, valid = boxes[keep], scores[keep], valid[keep]
    if cfg.not_nms:
        key = torch.where(valid, scores, scores.new_full((), NEG_INF))
        top_scores, out_valid, (top_boxes,) = topk_padded(key, post_topk,
                                                          boxes)
        zero = torch.zeros((), device=boxes.device)
        return Detections(
            boxes=torch.where(out_valid[:, None], top_boxes, zero),
            scores=torch.where(out_valid, top_scores, zero),
            classes=torch.zeros((post_topk,), dtype=torch.int32,
                                device=boxes.device),
            valid=out_valid)
    return nms_padded(boxes, scores, valid, nms_thresh, post_topk,
                      ml_nms_semantics=True)
