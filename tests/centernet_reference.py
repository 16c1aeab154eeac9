"""The CenterNet decode as the port computed it level by level (five
stable descending sorts, a gather and the box ops a level), kept as the
yardstick of the one-sort decode (`models/centernet.py:_decode`), and
seeded head outputs at a frame's level shapes. Imports nothing of JAX, so
the card tests use it too."""

from typing import List, Sequence, Tuple

import numpy as np
import torch

from embodied_object_detection_tpu_torch.config import CenterNetConfig
from embodied_object_detection_tpu_torch.models.centernet import level_grids
from embodied_object_detection_tpu_torch.ops.nms import (
    NEG_INF, nms_padded, sort_desc, topk_padded)
from embodied_object_detection_tpu_torch.structures import Detections

# p3..p7 of a 480 x 640 frame, and of the 64 x 96 miniature
FULL_LEVELS = ((60, 80), (30, 40), (15, 20), (8, 10), (4, 5))
MINI_LEVELS = ((8, 12), (4, 6), (2, 3), (1, 2), (1, 1))


def decode_per_level(agn_hms: Sequence[torch.Tensor],
                     regs: Sequence[torch.Tensor], cfg: CenterNetConfig,
                     training: bool = False) -> Detections:
    """Per level: sigmoid, a stable descending sort and its top
    `pre_nms_topk`, the grid and regressions gathered, the boxes; then the
    candidate cap and the NMS."""
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


def head_outputs(shapes: Sequence[Tuple[int, int]], seed: int,
                 device: str = "cpu", constant: bool = False
                 ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Seeded heatmap logits [H, W, 1] (N(-3, 2), so that some fall under
    the score threshold; all 0 with `constant`, every score tied) and
    rectified regressions [H, W, 4] (|N(0, 3)|, a tenth of them 0, so
    that some boxes take the 0.01 minimum extent)."""
    rng = np.random.RandomState(seed)
    hms, regs = [], []
    for h, w in shapes:
        hm = np.zeros((h, w, 1), np.float32) if constant else \
            (rng.randn(h, w, 1) * 2 - 3).astype(np.float32)
        reg = np.abs(rng.randn(h, w, 4) * 3).astype(np.float32)
        reg[rng.rand(h, w, 4) < 0.1] = 0.0
        hms.append(torch.from_numpy(hm).to(device))
        regs.append(torch.from_numpy(reg).to(device))
    return hms, regs
