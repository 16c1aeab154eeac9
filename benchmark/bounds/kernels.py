"""The bytes and operations each launch of a port kernel (`eodt::*`)
needs, from that launch's own arguments, and the least time they take on
the card (`peaks.bound_s`).

The counts are `chip_smoke.py`'s (cited per kernel), which PERF.md's
kernel table states: each input byte read once and each output byte
written once, and where the work depends on the data, what these inputs
need (the ROIAlign taps count only the level positions they read, the
segment-sum only the rows with a cell id in range, NMS only the IoU pairs
of one class)."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..reference.detic_plain.ops.roi_align import roi_align_taps
from .peaks import bound_s

TILE_COLS = 32          # the paste kernel's tile width (ops/mask_paste.py)


def segment_sum(w, idx, num_cells):
    """chip_smoke.py:2633: live rows and their ids read, the table
    written; an add a nonzero entry of a live row."""
    rows, lanes = w.shape
    keep = (idx >= 0) & (idx < num_cells)
    live = int(keep.sum())
    added = int(((w != 0) & keep[:, None]).sum())
    return live * lanes * 4 + rows * 4 + num_cells * lanes * 4, added


def _read(features, obs, proj, pool):
    """chip_smoke.py:2666 (and :2825 batched): the distinct cells'
    rows, the counts and ids read, the pooled image written; 16 taps x
    (multiply, add) + a divide an output element."""
    d = features.shape[-1]
    projs = proj if proj.dim() == 3 else proj[None]
    rows = sum(int(torch.unique(p).numel()) for p in projs)
    h, w = proj.shape[-2:]
    out = projs.shape[0] * (h // pool) * (w // pool) * d
    return (rows * d * 4 + obs.numel() * 4 + proj.numel() * 4 + out * 4,
            out * (16 * 2 + 1))


def memory_read(features, obs, proj, pool):
    return _read(features, obs, proj, pool)


def memory_read_batched(features, obs, proj, pool):
    return _read(features, obs, proj, pool)


def nms_keep(boxes_s, classes_s, valid_s, iou_threshold, disabled):
    """chip_smoke.py:2723: boxes, classes, flags read, keep written; 13
    operations an IoU of two valid boxes of one class."""
    n = boxes_s.shape[0]
    pairs = 0
    if not disabled:
        _, per_class = torch.unique(classes_s[valid_s], return_counts=True)
        pairs = sum(k * (k - 1) // 2 for k in per_class.tolist())
    return n * (16 + 4 + 1) + n, 13 * pairs


def _taps(features, boxes, lvl, strides, size, ratio):
    shapes = [tuple(f.shape[:2]) for f in features]
    return roi_align_taps(shapes, boxes.float(), tuple(strides), size, ratio,
                          lvl)


def roi_align(features, boxes, lvl, strides, size, ratio, stats=None):
    """chip_smoke.py:2756 and :1131: the level positions the taps read
    with a nonzero weight, each once, the boxes and level ids, the pooled
    output written; 4 taps x 8 + 1 operations an output element."""
    rows, wgt = _taps(features, boxes, lvl, strides, size, ratio)
    c = features[0].shape[-1]
    row_bytes = c * features[0].element_size()
    read = int(torch.unique(rows[wgt != 0]).numel()) * row_bytes
    out = boxes.shape[0] * size * size * c
    return (read + boxes.shape[0] * 20 + out * features[0].element_size(),
            out * (4 * 8 + 1))


def roi_align_backward(features, boxes, lvl, strides, size, ratio):
    """chip_smoke.py:2792 and :1115: the output gradient, boxes and
    level ids read, every level's gradient written; a multiply and an add
    a nonzero tap contribution of a channel."""
    rows, wgt = _taps(features, boxes, lvl, strides, size, ratio)
    c = features[0].shape[-1]
    e = features[0].element_size()
    r = boxes.shape[0]
    contributions = int((wgt != 0).sum()) * c
    return (r * size * size * c * e + r * 20 +
            sum(f.numel() * e for f in features), 2 * contributions)


def paste_masks_observed(masks, boxes, valid, height, width, threshold):
    """chip_smoke.py:2935: the masks, boxes and flags read, the
    pixel-major masks, the observed flags and the tile counts written; 10
    operations a (pixel, mask)."""
    n, m, _ = masks.shape
    tiles = -(-width // TILE_COLS)
    return (n * m * m * 4 + n * 16 + n + height * width * n +
            height * width + height * tiles * 4, height * width * n * 10)


def write_select(masks_pm, det_valid, proj, subsample, observed,
                 row_counts, out):
    """chip_smoke.py:2885: the flags and counts read, each selected
    pixel's masks and id read, the slots' ids and weight rows written; an
    operation a (selected pixel, mask)."""
    h, w, n = masks_pm.shape
    slots = h * -(-w // subsample)
    filled = int((out[0] >= 0).sum())
    return (observed.numel() + row_counts.numel() * 4 + n +
            filled * (n + 4) + slots * 4 + slots * (n + 1) * 4, filled * n)


COUNTED = {"segment_sum": segment_sum, "memory_read": memory_read,
           "memory_read_batched": memory_read_batched, "nms_keep": nms_keep,
           "roi_align": roi_align,
           "paste_masks_observed": paste_masks_observed}


def _roi_with_backward(args):
    return roi_align_backward(*args[:6])


class RecordBounds(TorchDispatchMode):
    """Inside it every `eodt::*` call runs as usual and its bound is
    counted from its arguments (and, for the selection, its output):
    `calls` is [(kernel, seconds of bound)]. With `backward`, each
    ROIAlign forward also counts the bound of its backward (kernel 4b),
    which runs as an autograd function and not as a custom op."""

    def __init__(self, backward: bool = False):
        super().__init__()
        self.backward = backward
        self.calls: List[Tuple[str, float]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace != "eodt":
            return out
        name = func.__name__.split(".")[0]
        with torch.no_grad():
            if name == "write_select":
                counts = write_select(*args, out)
            elif name in COUNTED:
                counts = COUNTED[name](*args)
            else:           # a kernel with no count: its time, no bound
                self.calls.append((name, 0.0))
                return out
            self.calls.append((name, bound_s(*counts)))
            if name == "roi_align" and self.backward:
                self.calls.append(("roi_align_backward",
                                   bound_s(*_roi_with_backward(args))))
        return out

    def totals(self) -> Dict[str, Tuple[int, float]]:
        out: Dict[str, Tuple[int, float]] = {}
        for name, s in self.calls:
            n, t = out.get(name, (0, 0.0))
            out[name] = (n + 1, t + s)
        return out
