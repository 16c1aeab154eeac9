"""OpenImages-challenge detection evaluation (the OIDEvaluator analog).

Counterpart of the JAX package's `evaluation/oid_eval.py` (ref: Detic/
detic/evaluation/oideval.py, re-derived without lvis-api or pycocotools):
  * federated filtering: detections of classes neither in an image's
    positive nor in its negative (verified-absent) labels are dropped
    (oideval.py:187-207)
  * per (image, class) greedy matching at IoU >= 0.5 in score order, each
    plain GT matched at most once (compute_match_iou, :327-338)
  * group-of boxes match by intersection over the detection's area >=
    0.5; the detections matched to a group collapse into at most one
    pseudo-TP with their largest score and are no false positives
    (compute_match_ioa, :340-374)
  * per-class AP is the VOC area under the monotone PR curve
    (compute_average_precision, :35-77), recall over all the class's GT
    boxes (:383)
  * optionally each detection is repeated for every ancestor class of the
    label hierarchy (:110-149)
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Optional, Sequence, Set

import numpy as np


def voc_average_precision(precision: np.ndarray, recall: np.ndarray) -> float:
    """ref: oideval.py:35-77."""
    if precision.size == 0:
        return 0.0
    recall = np.concatenate([[0.0], recall, [1.0]])
    precision = np.concatenate([[0.0], precision, [0.0]])
    for i in range(len(precision) - 2, -1, -1):
        precision[i] = max(precision[i], precision[i + 1])
    idx = np.where(recall[1:] != recall[:-1])[0] + 1
    return float(np.sum((recall[idx] - recall[idx - 1]) * precision[idx]))


def _iou_ioa(dets: np.ndarray, gts: np.ndarray, ioa: bool) -> np.ndarray:
    """[D, G]: IoU, or intersection/det-area when ioa (the pycocotools
    iscrowd convention used for group-of boxes)."""
    if len(dets) == 0 or len(gts) == 0:
        return np.zeros((len(dets), len(gts)))
    ix = np.maximum(0, np.minimum(dets[:, None, 2], gts[None, :, 2]) -
                    np.maximum(dets[:, None, 0], gts[None, :, 0]))
    iy = np.maximum(0, np.minimum(dets[:, None, 3], gts[None, :, 3]) -
                    np.maximum(dets[:, None, 1], gts[None, :, 1]))
    inter = ix * iy
    d_area = ((dets[:, 2] - dets[:, 0]) * (dets[:, 3] - dets[:, 1]))[:, None]
    if ioa:
        return np.where(d_area > 0, inter / np.maximum(d_area, 1e-12), 0.0)
    g_area = ((gts[:, 2] - gts[:, 0]) * (gts[:, 3] - gts[:, 1]))[None, :]
    union = d_area + g_area - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


class OIDEvaluator:
    """Streaming evaluator; boxes are XYXY pixels."""

    def __init__(self, category_ids: Sequence[int],
                 category_names: Optional[Sequence[str]] = None,
                 hierarchy_parents: Optional[Dict[int, Set[int]]] = None,
                 expand_pred_label: bool = False,
                 iou_thresh: float = 0.5):
        self.category_ids = list(category_ids)
        self.category_names = list(category_names) if category_names else \
            [str(c) for c in category_ids]
        self.parents = hierarchy_parents or {}
        self.expand_pred_label = expand_pred_label
        self.iou_thresh = iou_thresh
        self._gt = defaultdict(list)        # (img, cat) -> [(box, group_of)]
        self._dt = defaultdict(list)        # (img, cat) -> [(box, score)]
        self._pos: Dict[int, Set[int]] = {}
        self._neg: Dict[int, Set[int]] = {}

    def add_image(self, image_id: int, pos_category_ids: Sequence[int],
                  neg_category_ids: Sequence[int] = ()):
        # union on repeat calls (per-frame label streaming), matching
        # COCOEvaluator.add_image — replacing would drop earlier labels
        self._pos.setdefault(image_id, set()).update(pos_category_ids)
        self._neg.setdefault(image_id, set()).update(neg_category_ids)

    def add_ground_truth(self, image_id: int, boxes_xyxy, classes,
                         group_of=None):
        boxes_xyxy = np.asarray(boxes_xyxy, np.float64).reshape(-1, 4)
        classes = np.asarray(classes).reshape(-1)
        group_of = np.zeros(len(classes), bool) if group_of is None \
            else np.asarray(group_of, bool)
        for b, c, g in zip(boxes_xyxy, classes, group_of):
            self._gt[image_id, int(c)].append((b, bool(g)))

    def add_detections(self, image_id: int, boxes_xyxy, scores, classes):
        boxes_xyxy = np.asarray(boxes_xyxy, np.float64).reshape(-1, 4)
        scores = np.asarray(scores, np.float64).reshape(-1)
        classes = np.asarray(classes).reshape(-1)
        for b, s, c in zip(boxes_xyxy, scores, classes):
            cats = [int(c)]
            if self.expand_pred_label:
                cats += sorted(self.parents.get(int(c), ()))
            for cat in cats:
                self._dt[image_id, cat].append((b, float(s)))

    def _federated_drop(self, img_id: int, cat: int) -> bool:
        """Federated filtering (ref: oideval.py:203-207): detections of
        classes neither positively annotated nor verified-absent are
        ignored. Evaluated at evaluate() time, not add time — _pos/_neg may
        not be complete yet when detections stream in, which would make the
        API order-dependent (same rationale as COCOEvaluator)."""
        return (cat not in self._pos.get(img_id, set())
                and cat not in self._neg.get(img_id, set()))

    def _evaluate_img_cat(self, img_id: int, cat: int):
        """ref: evaluate_img_google (oideval.py:289-384)."""
        gt = self._gt.get((img_id, cat), [])
        dt = [] if self._federated_drop(img_id, cat) else sorted(
            self._dt.get((img_id, cat), []), key=lambda e: -e[1])
        if not gt and not dt:
            return None
        if not dt:
            return np.zeros(0), np.zeros(0), len(gt)
        d_boxes = np.array([e[0] for e in dt]).reshape(-1, 4)
        scores = np.array([e[1] for e in dt])
        plain = np.array([e[0] for e in gt if not e[1]]).reshape(-1, 4)
        groups = np.array([e[0] for e in gt if e[1]]).reshape(-1, 4)

        nd = len(d_boxes)
        tp = np.zeros(nd, bool)
        matched_group = np.zeros(nd, bool)

        iou = _iou_ioa(d_boxes, plain, ioa=False)
        if iou.shape[1] > 0:
            best = np.argmax(iou, axis=1)
            gt_taken = np.zeros(iou.shape[1], bool)
            for i in range(nd):
                g = best[i]
                if (not tp[i] and iou[i, g] >= self.iou_thresh and
                        not matched_group[i] and not gt_taken[g]):
                    tp[i] = True
                    gt_taken[g] = True

        ioa = _iou_ioa(d_boxes, groups, ioa=True)
        g_scores = np.zeros(ioa.shape[1])
        g_matched = np.zeros(ioa.shape[1], bool)
        if ioa.shape[1] > 0:
            best = np.argmax(ioa, axis=1)
            for i in range(nd):
                g = best[i]
                if (not tp[i] and ioa[i, g] >= self.iou_thresh and
                        not matched_group[i]):
                    matched_group[i] = True
                    g_matched[g] = True
                    g_scores[g] = max(g_scores[g], scores[i])
        # boolean mask, not score>0: a score-0.0 detection matching a group
        # must still yield the group's pseudo-TP
        sel = g_matched

        keep = ~matched_group
        out_scores = np.concatenate([scores[keep], g_scores[sel]])
        out_tp = np.concatenate([tp[keep].astype(float), np.ones(sel.sum())])
        return out_scores, out_tp, len(gt)

    def evaluate(self) -> Dict[str, float]:
        """Images = union of registered (add_image) and any image that
        carries GT — GT on an unregistered image must still count in the
        recall denominator."""
        aps = {}
        # image set is category-independent: build it once, not per category
        gt_imgs = {i for (i, _c) in self._gt}
        img_ids = sorted(set(self._pos) | gt_imgs)
        for cat, name in zip(self.category_ids, self.category_names):
            all_scores, all_tp, n_gt = [], [], 0
            for img_id in img_ids:
                r = self._evaluate_img_cat(img_id, cat)
                if r is None:
                    continue
                s, t, n = r
                all_scores.append(s)
                all_tp.append(t)
                n_gt += n
            if n_gt == 0:
                continue
            scores = np.concatenate(all_scores) if all_scores else np.zeros(0)
            tps = np.concatenate(all_tp) if all_tp else np.zeros(0)
            order = np.argsort(-scores, kind="mergesort")
            tps = tps[order]
            tp_cum = np.cumsum(tps)
            fp_cum = np.cumsum(1 - tps)
            recall = tp_cum / n_gt
            precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-12)
            aps[name] = voc_average_precision(precision, recall)
        mean = float(np.mean(list(aps.values()))) * 100 if aps else float("nan")
        out = {"AP50": mean}
        out.update({f"AP50-{k}": v * 100 for k, v in aps.items()})
        return out


def hierarchy_parent_map(hierarchy: dict, freebase2id: Dict[str, int]
                         ) -> Dict[int, Set[int]]:
    """Parse the challenge label hierarchy json into child -> ancestor ids
    (ref: oideval.py:117-130)."""
    parents: Dict[int, Set[int]] = defaultdict(set)

    def dfs(node, cur_id):
        all_children = set()
        for sub in node.get("Subcategory", []):
            all_children.update(dfs(sub, freebase2id[sub["LabelName"]]))
        if cur_id != -1:
            for c in all_children:
                parents[c].add(cur_id)
        all_children.add(cur_id)
        return all_children

    dfs(hierarchy, -1)
    return dict(parents)
