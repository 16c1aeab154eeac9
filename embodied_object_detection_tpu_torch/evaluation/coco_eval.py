"""COCO-style bbox mAP evaluation on the host (numpy, with a C++ core).

The port's own copy of the JAX package's `evaluation/coco_eval.py`: the
pycocotools COCOeval semantics the reference's detectron2 COCOEvaluator
uses for bbox (ref: Detic/train_mp3d.py:429-443), re-derived without
pycocotools:

  * IoU thresholds 0.5:0.95:0.05, recall grid 0:1:0.01 (101 points)
  * area ranges all/small/medium/large over the *annotation* `area` field
    (the reference writes area=0 for every GT, train_mp3d.py:237 -- so only
    the 'all' range is populated, exactly as in the reference runs)
  * maxDets 100 for AP
  * greedy per-image matching in descending score order, ignore handling,
    monotone precision envelope, 101-point interpolation

It evaluates image-id subsets (the temporal-quartile protocol,
train_mp3d.py:300-330), the LVIS-style federated mode, and the seen /
unseen category split of the generalized zero-shot COCO protocol. The matching
sweep runs in the port's `native/eval_core.cc` when g++ can build it, else
in numpy.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Optional, Sequence

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNGS = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}


def _native_core():
    """The port's compiled eval core (native/eval_core.cc, the pycocotools
    C analog); None -> the numpy path."""
    from .. import native
    return native.eval_core


def _iou_xywh(dets: np.ndarray, gts: np.ndarray) -> np.ndarray:
    """Pairwise IoU of xywh boxes, [D, G] (pycocotools maskUtils.iou,
    iscrowd=0)."""
    if len(dets) == 0 or len(gts) == 0:
        return np.zeros((len(dets), len(gts)))
    core = _native_core()
    if core is not None:
        return core.iou_xywh(dets, gts)
    dx1, dy1 = dets[:, 0], dets[:, 1]
    dx2, dy2 = dets[:, 0] + dets[:, 2], dets[:, 1] + dets[:, 3]
    gx1, gy1 = gts[:, 0], gts[:, 1]
    gx2, gy2 = gts[:, 0] + gts[:, 2], gts[:, 1] + gts[:, 3]
    ix = np.maximum(0, np.minimum(dx2[:, None], gx2[None]) -
                    np.maximum(dx1[:, None], gx1[None]))
    iy = np.maximum(0, np.minimum(dy2[:, None], gy2[None]) -
                    np.maximum(dy1[:, None], gy1[None]))
    inter = ix * iy
    da = (dets[:, 2] * dets[:, 3])[:, None]
    ga = (gts[:, 2] * gts[:, 3])[None]
    union = da + ga - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


class COCOEvaluator:
    """Streaming bbox evaluator.

    add_ground_truth / add_detections take XYXY pixel boxes; internal storage
    is COCO xywh. `area` can be given explicitly to reproduce the reference's
    area=0 annotations (train_mp3d.py:237).
    """

    def __init__(self, category_ids: Sequence[int],
                 category_names: Optional[Sequence[str]] = None,
                 max_dets: int = 100, federated: bool = False,
                 first_ann_id: int = 1):
        """federated=True gives LVIS-style evaluation (detectron2
        LVISEvaluator analog, ref: train_mp3d.py:423): detections for
        categories that are neither positively annotated nor in an image's
        negative list are dropped (the detector isn't penalized for
        unverified classes), and max_dets should be 300."""
        self.category_ids = list(category_ids)
        self.category_names = list(category_names) if category_names else \
            [str(c) for c in category_ids]
        self.max_dets = max_dets
        self.federated = federated
        self._pos: Dict[int, set] = {}
        self._neg: Dict[int, set] = {}
        self._seen_ids: set = set()
        self._gt: Dict[int, Dict[int, list]] = defaultdict(lambda: defaultdict(list))
        self._dt: Dict[int, Dict[int, list]] = defaultdict(lambda: defaultdict(list))
        # global annotation id counter. pycocotools stores gt['id'] in
        # dtm, where 0 doubles as "unmatched" — so when ids start at 0 the
        # detection matched to annotation 0 accumulates as a false
        # positive. Standard COCO jsons are 1-based (no quirk, the
        # default); the mp3d embodied protocol assembles GT with ids from
        # 0 (train_mp3d.py:149) and passes first_ann_id=0 so its reported
        # numbers keep the reference quirk.
        self._first_ann_id = int(first_ann_id)
        self._next_ann_id = self._first_ann_id
        self._last_precisions = None

    def reset(self):
        self._gt.clear()
        self._dt.clear()
        self._seen_ids.clear()
        self._next_ann_id = self._first_ann_id
        self._pos.clear()
        self._neg.clear()
        self._last_precisions = None

    def add_image(self, image_id: int,
                  neg_category_ids: Sequence[int] = ()):
        self._seen_ids.add(image_id)
        if self.federated:
            self._pos.setdefault(image_id, set())
            self._neg.setdefault(image_id, set()).update(neg_category_ids)

    def add_ground_truth(self, image_id: int, boxes_xyxy: np.ndarray,
                         classes: np.ndarray,
                         areas: Optional[np.ndarray] = None):
        boxes_xyxy = np.asarray(boxes_xyxy, np.float64).reshape(-1, 4)
        classes = np.asarray(classes).reshape(-1)
        for i in range(len(boxes_xyxy)):
            x1, y1, x2, y2 = boxes_xyxy[i]
            area = float(areas[i]) if areas is not None else \
                float((x2 - x1) * (y2 - y1))
            self._gt[image_id][int(classes[i])].append(
                ((x1, y1, x2 - x1, y2 - y1), area, self._next_ann_id))
            self._next_ann_id += 1
            if self.federated:
                self._pos.setdefault(image_id, set()).add(int(classes[i]))

    def add_detections(self, image_id: int, boxes_xyxy: np.ndarray,
                       scores: np.ndarray, classes: np.ndarray):
        boxes_xyxy = np.asarray(boxes_xyxy, np.float64).reshape(-1, 4)
        scores = np.asarray(scores, np.float64).reshape(-1)
        classes = np.asarray(classes).reshape(-1)
        for i in range(len(boxes_xyxy)):
            c = int(classes[i])
            x1, y1, x2, y2 = boxes_xyxy[i]
            self._dt[image_id][c].append(
                ((x1, y1, x2 - x1, y2 - y1), float(scores[i])))

    # ------------------------------------------------------------------
    def _federated_drop(self, img_id: int, cat: int) -> bool:
        """LVIS federated protocol: detections of classes neither
        positively annotated nor in the image's negative list are ignored
        (the detector isn't penalized for unverified classes). Evaluated
        HERE — at add time _pos may not be complete yet, which would make
        the streaming API order-dependent."""
        return (self.federated
                and cat not in self._pos.get(img_id, set())
                and cat not in self._neg.get(img_id, set()))

    def _evaluate_img_cat(self, img_id: int, cat: int, area_rng, n_thrs: int):
        """Greedy matching for one (image, category); mirrors
        COCOeval.evaluateImg."""
        # .get on the outer dicts: plain [img_id] on the defaultdicts would
        # insert empty per-image entries on this read path
        gt_entries = self._gt.get(img_id, {}).get(cat, [])
        dt_entries = [] if self._federated_drop(img_id, cat) else sorted(
            self._dt.get(img_id, {}).get(cat, []),
            key=lambda e: -e[1])[: self.max_dets]
        if not gt_entries and not dt_entries:
            return None
        g_boxes = np.array([e[0] for e in gt_entries], np.float64).reshape(-1, 4)
        g_areas = np.array([e[1] for e in gt_entries], np.float64)
        g_ids = np.array([e[2] for e in gt_entries], np.int64)
        g_ignore = (g_areas < area_rng[0]) | (g_areas > area_rng[1])
        # sort gts: non-ignored first (COCOeval gtind)
        gt_order = np.argsort(g_ignore, kind="stable")
        g_boxes = g_boxes[gt_order]
        g_ignore = g_ignore[gt_order]
        g_ids = g_ids[gt_order]

        d_boxes = np.array([e[0] for e in dt_entries], np.float64).reshape(-1, 4)
        d_scores = np.array([e[1] for e in dt_entries], np.float64)

        ious = _iou_xywh(d_boxes, g_boxes)
        nd, ng = len(d_boxes), len(g_boxes)
        # evaluate() reaches this numpy matching only without the core
        # dt_m stores the matched gt's GLOBAL annotation id, exactly like
        # pycocotools (dtm[t,d] = gt['id']); 0 doubles as "unmatched", so
        # with ids starting at 0 (train_mp3d.py:149) the det matched to
        # annotation 0 accumulates as FP — quirk kept for number parity
        dt_m = np.zeros((n_thrs, nd), np.int64)
        gt_m = np.zeros((n_thrs, ng), np.int64)
        dt_ig = np.zeros((n_thrs, nd), bool)
        for t, thr in enumerate(IOU_THRS[:n_thrs]):
            for d in range(nd):
                best_iou = min(thr, 1 - 1e-10)
                best_g = -1
                for g in range(ng):
                    if gt_m[t, g] > 0:
                        continue
                    if best_g > -1 and not g_ignore[best_g] \
                            and g_ignore[g]:
                        break
                    if ious[d, g] < best_iou:
                        continue
                    best_iou = ious[d, g]
                    best_g = g
                if best_g == -1:
                    continue
                dt_ig[t, d] = g_ignore[best_g]
                dt_m[t, d] = g_ids[best_g]
                gt_m[t, best_g] = d + 1
        # unmatched detections outside the area range are ignored
        d_areas = d_boxes[:, 2] * d_boxes[:, 3]
        out_of_rng = (d_areas < area_rng[0]) | (d_areas > area_rng[1])
        dt_ig = dt_ig | ((dt_m == 0) & out_of_rng[None, :])
        return dict(scores=d_scores, dt_m=dt_m, dt_ig=dt_ig,
                    n_gt=int(np.sum(~g_ignore)))

    def evaluate(self, img_ids: Optional[Sequence[int]] = None,
                 area: str = "all") -> Dict[str, float]:
        """Returns {'AP', 'AP50', 'AP75', 'AP-<cat>': ...} (percentages,
        detectron2-style)."""
        # dedup AND sort like COCOeval's p.imgIds = np.unique(...):
        # mergesort breaks exact score ties by evaluation order, so image
        # order must be deterministic for the serial and sharded paths to
        # produce identical AP under bit-equal scores
        ids = sorted(set(img_ids)) if img_ids is not None \
            else sorted(self._seen_ids)
        area_rng = AREA_RNGS[area]
        n_thrs = len(IOU_THRS)
        ap_per_cat = {}
        precisions = np.full((n_thrs, len(REC_THRS), len(self.category_ids)),
                             -1.0)
        core = _native_core()
        for ci, cat in enumerate(self.category_ids):
            if core is not None:
                # whole-category sweep in one native call (one ctypes
                # round-trip per category, not per image)
                g_boxes, g_areas, g_ids, g_off = [], [], [], [0]
                d_boxes, d_scores, d_off = [], [], [0]
                any_entries = False
                for i in ids:
                    for box, ar, gid in self._gt.get(i, {}).get(cat, []):
                        g_boxes.append(box)
                        g_areas.append(ar)
                        g_ids.append(gid)
                        any_entries = True
                    g_off.append(len(g_boxes))
                    if not self._federated_drop(i, cat):
                        for box, sc in self._dt.get(i, {}).get(cat, []):
                            d_boxes.append(box)
                            d_scores.append(sc)
                            any_entries = True
                    d_off.append(len(d_boxes))
                if not any_entries:
                    continue
                scores, dt_m, dt_ig, n_gt = core.evaluate_category(
                    np.asarray(g_boxes, np.float64).reshape(-1, 4),
                    np.asarray(g_areas, np.float64),
                    np.asarray(g_ids, np.int64),
                    np.asarray(g_off, np.int64),
                    np.asarray(d_boxes, np.float64).reshape(-1, 4),
                    np.asarray(d_scores, np.float64),
                    np.asarray(d_off, np.int64),
                    np.asarray(IOU_THRS[:n_thrs]), area_rng, self.max_dets)
                if n_gt == 0:
                    continue
            else:
                per_img = [self._evaluate_img_cat(i, cat, area_rng, n_thrs)
                           for i in ids]
                per_img = [r for r in per_img if r is not None]
                if not per_img:
                    continue
                n_gt = sum(r["n_gt"] for r in per_img)
                if n_gt == 0:
                    continue
                scores = np.concatenate([r["scores"] for r in per_img])
                dt_m = np.concatenate([r["dt_m"] for r in per_img], axis=1)
                dt_ig = np.concatenate([r["dt_ig"] for r in per_img], axis=1)
            order = np.argsort(-scores, kind="mergesort")
            dt_m = dt_m[:, order]
            dt_ig = dt_ig[:, order]
            tps = (dt_m > 0) & ~dt_ig
            fps = (dt_m == 0) & ~dt_ig
            tp_sum = np.cumsum(tps, axis=1).astype(np.float64)
            fp_sum = np.cumsum(fps, axis=1).astype(np.float64)
            for t in range(n_thrs):
                tp = tp_sum[t]
                fp = fp_sum[t]
                if core is not None:
                    precisions[t, :, ci] = core.precision_at_recall(
                        tp, fp, n_gt, np.asarray(REC_THRS))
                    continue
                rc = tp / n_gt
                pr = tp / np.maximum(tp + fp, np.spacing(1))
                # monotone envelope from the right (COCOeval accumulate)
                for i in range(len(pr) - 1, 0, -1):
                    if pr[i] > pr[i - 1]:
                        pr[i - 1] = pr[i]
                inds = np.searchsorted(rc, REC_THRS, side="left")
                q = np.zeros(len(REC_THRS))
                for ri, pi in enumerate(inds):
                    if pi < len(pr):
                        q[ri] = pr[pi]
                precisions[t, :, ci] = q
            valid = precisions[:, :, ci] > -1
            ap_per_cat[self.category_names[ci]] = float(
                np.mean(precisions[:, :, ci][valid])) if valid.any() else float("nan")

        def _mean(p):
            p = p[p > -1]
            return float(np.mean(p)) * 100 if p.size else float("nan")

        results = {
            "AP": _mean(precisions),
            "AP50": _mean(precisions[0]),
            "AP75": _mean(precisions[5]),
        }
        for name, ap in ap_per_cat.items():
            results[f"AP-{name}"] = ap * 100
        self._last_precisions = precisions
        return results

    def evaluate_split(self, seen_ids: Sequence[int],
                       img_ids: Optional[Sequence[int]] = None
                       ) -> Dict[str, float]:
        """`evaluate` plus the AP over a 'seen' category subset and its
        'unseen' complement, the generalized zero-shot COCO protocol
        (CustomCOCOEvaluator analog; ref:
        Detic/detic/evaluation/custom_coco_eval.py:28)."""
        base = self.evaluate(img_ids)
        precisions = self._last_precisions          # [T, R, C]
        seen_set = set(seen_ids)
        seen = [i for i, c in enumerate(self.category_ids) if c in seen_set]
        unseen = [i for i in range(len(self.category_ids)) if i not in seen]

        def _mean(ixs, t=None):
            p = precisions[:, :, ixs] if t is None else precisions[t][:, ixs]
            p = p[p > -1]
            return float(np.mean(p)) * 100 if p.size else float("nan")

        base["AP-seen"] = _mean(seen)
        base["AP50-seen"] = _mean(seen, 0)
        base["AP-unseen"] = _mean(unseen)
        base["AP50-unseen"] = _mean(unseen, 0)
        return base


def coco_ap(gt_by_img, dt_by_img, category_ids) -> Dict[str, float]:
    """Convenience wrapper: gt_by_img[i] = (boxes_xyxy, classes);
    dt_by_img[i] = (boxes_xyxy, scores, classes)."""
    ev = COCOEvaluator(category_ids)
    for img_id, (b, c) in gt_by_img.items():
        ev.add_image(img_id)
        ev.add_ground_truth(img_id, b, c)
    for img_id, (b, s, c) in dt_by_img.items():
        # det-only images must be registered too, or their false positives
        # silently vanish from the sweep (add_image dedups repeats)
        ev.add_image(img_id)
        ev.add_detections(img_id, b, s, c)
    return ev.evaluate()
