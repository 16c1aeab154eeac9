"""Padded greedy NMS on the device.

The greedy keep set is computed as the fixpoint of

    keep[j] = valid[j] and no kept i with score_i > score_j and IoU(i,j) > t

over a static [N, N] suppression mask, iterated until it stops changing
(counterpart of the JAX package's `ops/nms.py`). Orders follow the JAX
package's tie rules: `jnp.argsort` is stable and `lax.top_k` puts the
lower index first, so every sort here is `torch.sort(..., stable=True)`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..structures import Detections, pairwise_iou

NEG_INF = -1e10


def sort_desc(x: torch.Tensor, k: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest entries, ties in index order."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    if k is not None:
        vals, idx = vals[:k], idx[:k]
    return vals, idx


def topk_padded(kept_scores: torch.Tensor, topk: int, *rows: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor,
                           Tuple[torch.Tensor, ...]]:
    """Top-k that tolerates topk > N by padding with NEG_INF rows; returns
    (top_scores, out_valid, the rows gathered in that order)."""
    n = kept_scores.shape[0]
    pad = max(0, topk - n)
    if pad:
        kept_scores = torch.cat([kept_scores, kept_scores.new_full(
            (pad,), NEG_INF)])
        rows = tuple(torch.cat([r, r.new_zeros((pad,) + r.shape[1:])])
                     for r in rows)
    top_scores, top_idx = sort_desc(kept_scores, topk)
    out_valid = top_scores > NEG_INF / 2
    return top_scores, out_valid, tuple(r[top_idx] for r in rows)


def _greedy_keep(iou_mask: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Fixpoint of greedy suppression; iou_mask[i, j] is True iff i (the
    higher score) suppresses j. The suppression chain is at most N deep;
    one host check per iteration."""
    active = valid
    for _ in range(valid.shape[0]):
        suppressed = (iou_mask & active[:, None]).any(dim=0)
        new = valid & ~suppressed
        if torch.equal(new, active):
            break
        active = new
    return active


def _nms_core(boxes, scores, valid, classes, iou_threshold,
              ml_nms_semantics=False):
    """Sort by score, run greedy NMS. Returns (order, keep, sorted boxes,
    scores, classes)."""
    n = boxes.shape[0]
    scores = torch.where(valid, scores, scores.new_full((), NEG_INF))
    _, order = sort_desc(scores)
    boxes_s, scores_s = boxes[order], scores[order]
    valid_s, classes_s = valid[order], classes[order]
    iou = pairwise_iou(boxes_s, boxes_s)
    same_class = classes_s[:, None] == classes_s[None, :]
    upper = torch.ones((n, n), dtype=torch.bool,
                       device=boxes.device).triu(diagonal=1)
    iou_mask = (iou > iou_threshold) & same_class & upper & \
        valid_s[:, None] & valid_s[None, :]
    if ml_nms_semantics and not iou_threshold > 0:
        # ml_nms treats a threshold <= 0 as "NMS disabled"
        iou_mask = torch.zeros_like(iou_mask)
    keep = _greedy_keep(iou_mask, valid_s)
    return order, keep, boxes_s, scores_s, classes_s


def nms_padded(boxes: torch.Tensor, scores: torch.Tensor,
               valid: torch.Tensor, iou_threshold: float, topk: int,
               classes: Optional[torch.Tensor] = None,
               ml_nms_semantics: bool = False) -> Detections:
    """Greedy NMS over padded candidates, top-`topk` by score. With
    `classes`, suppression stays within a class."""
    n = boxes.shape[0]
    if classes is None:
        classes = torch.zeros((n,), dtype=torch.int32, device=boxes.device)
    _, keep, boxes_s, scores_s, classes_s = _nms_core(
        boxes, scores, valid, classes, iou_threshold,
        ml_nms_semantics=ml_nms_semantics)
    kept_scores = torch.where(keep, scores_s, scores_s.new_full((), NEG_INF))
    top_scores, out_valid, (top_boxes, top_classes) = topk_padded(
        kept_scores, topk, boxes_s, classes_s)
    zero = torch.zeros((), device=boxes.device)
    return Detections(
        boxes=torch.where(out_valid[:, None], top_boxes, zero),
        scores=torch.where(out_valid, top_scores, zero),
        classes=torch.where(out_valid, top_classes,
                            torch.zeros_like(top_classes)).to(torch.int32),
        valid=out_valid)


def multiclass_nms(boxes: torch.Tensor, scores: torch.Tensor,
                   valid: torch.Tensor, score_thresh: float,
                   iou_threshold: float, topk: int,
                   candidate_cap: int = 2048
                   ) -> Tuple[Detections, torch.Tensor]:
    """`fast_rcnn_inference` for class-agnostic boxes: drop the background
    column, flatten (box, class) pairs above `score_thresh`, keep the top
    `candidate_cap`, per-class NMS, global top-`topk`.

    Returns (Detections[topk], kept proposal rows [topk] int32, -1 where
    invalid)."""
    r = boxes.shape[0]
    c = scores.shape[1] - 1
    device = boxes.device
    fg = scores[:, :c]
    flat_valid = ((fg > score_thresh) & valid[:, None]).reshape(-1)
    flat_scores = fg.reshape(-1)
    flat_classes = torch.arange(c, dtype=torch.int32,
                                device=device).repeat(r)
    flat_rows = torch.arange(r, dtype=torch.int32,
                             device=device).repeat_interleave(c)
    flat_boxes = boxes.repeat_interleave(c, dim=0)
    if candidate_cap and candidate_cap < flat_boxes.shape[0]:
        key = torch.where(flat_valid, flat_scores,
                          flat_scores.new_full((), NEG_INF))
        _, keep_idx = sort_desc(key, candidate_cap)
        flat_boxes = flat_boxes[keep_idx]
        flat_scores = flat_scores[keep_idx]
        flat_valid = flat_valid[keep_idx]
        flat_classes = flat_classes[keep_idx]
        flat_rows = flat_rows[keep_idx]

    order, keep, boxes_s, scores_s, classes_s = _nms_core(
        flat_boxes, flat_scores, flat_valid, flat_classes, iou_threshold)
    rows_s = flat_rows[order]
    kept_scores = torch.where(keep, scores_s, scores_s.new_full((), NEG_INF))
    top_scores, out_valid, (top_boxes, top_classes, top_rows) = topk_padded(
        kept_scores, topk, boxes_s, classes_s, rows_s)
    zero = torch.zeros((), device=device)
    det = Detections(
        boxes=torch.where(out_valid[:, None], top_boxes, zero),
        scores=torch.where(out_valid, top_scores, zero),
        classes=torch.where(out_valid, top_classes,
                            torch.zeros_like(top_classes)).to(torch.int32),
        valid=out_valid)
    kept_rows = torch.where(out_valid, top_rows, torch.full_like(top_rows, -1))
    return det, kept_rows
