"""Multilevel ROIAlignV2 (aligned=True) over an FPN pyramid, the plain
PyTorch version of the port's kernel 4 (its backward, kernel 4b, is
torch autograd of the same form).

Counterpart of the JAX package's `ops/roi_align.py`: detectron2 level
assignment, a fixed `sampling_ratio`, and the CUDA ROIAlign clamp rules (a
sample strictly outside [-1, size] contributes 0; inside, coords clamp to
[0, size-1], so the border bands read the border pixel at full weight).
`impl` picks the form:

  impl="v4"  separable hat-weight matmuls (the JAX default): per level,
             pooled = Ry @ level @ Rx^T with the s x s window mean folded
             into the weight rows; every ROI against every level, the
             assigned level selected
  impl="v1"  the bilinear tap form: four gathered taps per sample from one
             flattened table of all levels, then the window mean (the
             math the port's kernel computes on the card for every impl)
  impl="v2"  the tap form with each weight cast to the features' type, so
             the products and sums stay in it, then the window summed
             and scaled by 1/s^2 (JAX's `_bilinear_flat(cast_weights=
             True)`); "v3" is the same arithmetic in the same order
             (`_roi_align_taps` says why)
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

IMPLS = ("v1", "v2", "v3", "v4")


def assign_levels(boxes: torch.Tensor, min_level: int, max_level: int,
                  canonical_box_size: int = 224,
                  canonical_level: int = 4) -> torch.Tensor:
    """detectron2 assign_boxes_to_levels: boxes [R, 4] -> level ids [R]."""
    area = (boxes[:, 2] - boxes[:, 0]).clamp(min=0) * \
        (boxes[:, 3] - boxes[:, 1]).clamp(min=0)
    lvl = torch.floor(canonical_level + torch.log2(
        torch.sqrt(area) / canonical_box_size + 1e-8))
    return lvl.clamp(min_level, max_level).to(torch.int32)


def _hat_rows(coords: torch.Tensor, size: int) -> torch.Tensor:
    """coords [..., P] -> [..., P, size] bilinear tap weights along one
    axis: (1-l) at floor and l at floor+1 (clamped), zero outside
    [-1, size]."""
    valid = (coords >= -1.0) & (coords <= float(size))
    c = coords.clamp(0.0, size - 1.0)
    c0 = torch.floor(c)
    frac = c - c0
    c0i = c0.long()
    c1i = (c0i + 1).clamp(max=size - 1)
    k = torch.arange(size, device=coords.device)
    okf = valid.float()
    return ((k == c0i[..., None]) * ((1.0 - frac) * okf)[..., None] +
            (k == c1i[..., None]) * (frac * okf)[..., None])


def _roi_align_matmul(features: Sequence[torch.Tensor], boxes: torch.Tensor,
                      strides: Tuple[int, ...], output_size: int,
                      sampling_ratio: int, lvl_of_roi: torch.Tensor
                      ) -> torch.Tensor:
    r = boxes.shape[0]
    s = sampling_ratio
    grid = (torch.arange(output_size * s, dtype=torch.float32,
                         device=boxes.device) + 0.5) / s
    out = None
    for li, f in enumerate(features):
        h, w, c = f.shape
        stride = float(strides[li])
        x1 = boxes[:, 0] / stride
        y1 = boxes[:, 1] / stride
        bin_w = (boxes[:, 2] / stride - x1) / output_size
        bin_h = (boxes[:, 3] / stride - y1) / output_size
        sx = x1[:, None] + grid[None, :] * bin_w[:, None] - 0.5    # [R, P]
        sy = y1[:, None] + grid[None, :] * bin_h[:, None] - 0.5
        rx = _hat_rows(sx, w).reshape(r, output_size, s, w).mean(2)
        ry = _hat_rows(sy, h).reshape(r, output_size, s, h).mean(2)
        dt = f.dtype
        tmpx = torch.einsum("rtw,hwc->rhtc", rx.to(dt), f)
        pooled = torch.einsum("rsh,rhtc->rstc", ry.to(dt), tmpx)
        sel = (lvl_of_roi == li)[:, None, None, None]
        pooled = torch.where(sel, pooled, torch.zeros((), dtype=dt,
                                                      device=f.device))
        out = pooled if out is None else out + pooled
    return out


def _bilinear_taps(x, y, h, w, base):
    """The four bilinear taps of each sample with the CUDA ROIAlign clamp
    rules: (flat row of the level table [..., 4], weight [..., 4]); x, y,
    h, w, base broadcast over the sample lattice."""
    hf, wf = h.to(x.dtype), w.to(x.dtype)
    valid = (x >= -1.0) & (x <= wf) & (y >= -1.0) & (y <= hf)
    x = torch.minimum(torch.maximum(x, torch.zeros_like(x)), wf - 1.0)
    y = torch.minimum(torch.maximum(y, torch.zeros_like(y)), hf - 1.0)
    x0, y0 = torch.floor(x), torch.floor(y)
    lx, ly = x - x0, y - y0
    x0i, y0i = x0.long(), y0.long()
    x1i = torch.minimum(x0i + 1, w - 1)
    y1i = torch.minimum(y0i + 1, h - 1)
    okf = valid.to(x.dtype)
    rows = torch.stack([base + y0i * w + x0i, base + y0i * w + x1i,
                        base + y1i * w + x0i, base + y1i * w + x1i], -1)
    weights = torch.stack([(1 - ly) * (1 - lx) * okf, (1 - ly) * lx * okf,
                           ly * (1 - lx) * okf, ly * lx * okf], -1)
    return rows, weights


def roi_align_taps(shapes, boxes, strides, output_size, sampling_ratio,
                   lvl_of_roi):
    """Every sample's taps of the tap form: (rows [R, S, s, S, s, 4] of
    the levels flattened one after another, weights of the same shape)
    for levels of [H_l, W_l] `shapes`."""
    device = boxes.device
    lvl = lvl_of_roi.long()
    # per-ROI level shape, flat offset and stride, selected from Python
    # ints (no host-to-device copy of a list)
    roi_h, roi_w, roi_base = (torch.zeros_like(lvl) for _ in range(3))
    roi_stride = torch.zeros_like(boxes[:, 0])
    base = 0
    for li, (h, w) in enumerate(shapes):
        on = lvl == li
        roi_h = torch.where(on, h, roi_h)
        roi_w = torch.where(on, w, roi_w)
        roi_base = torch.where(on, base, roi_base)
        roi_stride = torch.where(on, float(strides[li]), roi_stride)
        base += h * w
    r = boxes.shape[0]
    x1 = boxes[:, 0] / roi_stride
    y1 = boxes[:, 1] / roi_stride
    bin_w = (boxes[:, 2] / roi_stride - x1) / output_size
    bin_h = (boxes[:, 3] / roi_stride - y1) / output_size
    s = sampling_ratio
    p = output_size * s
    grid = (torch.arange(p, dtype=torch.float32, device=device) + 0.5) / s
    sx = x1[:, None] + grid[None, :] * bin_w[:, None]               # [R, P]
    sy = y1[:, None] + grid[None, :] * bin_h[:, None]
    sxx = sx[:, None, :].expand(r, p, p) - 0.5
    syy = sy[:, :, None].expand(r, p, p) - 0.5
    lattice = (r, p, p)
    rows, weights = _bilinear_taps(sxx, syy,
                                   roi_h[:, None, None].expand(lattice),
                                   roi_w[:, None, None].expand(lattice),
                                   roi_base[:, None, None].expand(lattice))
    shape = (r, output_size, s, output_size, s, 4)
    return rows.reshape(shape), weights.reshape(shape)


def _roi_align_taps(features, boxes, strides, output_size, sampling_ratio,
                    lvl_of_roi, cast_weights=False):
    """The tap form (v1): four taps a sample, then the window mean. With
    `cast_weights`, the JAX package's v2: each tap weight cast to the
    features' type, so every product and sum stays in that type, then the
    s x s window summed sample by sample (row-major) and scaled by 1/s^2
    (a power of two, exact). Its v3 reads the same four taps from a
    neighbour-packed table in the same order, and a tap past the border
    there reads a zero pad where v2 reads the border pixel, both at weight
    exactly 0: the same result, so v3 runs v2's code."""
    c = features[0].shape[-1]
    flat = torch.cat([f.reshape(-1, c) for f in features], dim=0)
    rows, weights = roi_align_taps([f.shape[:2] for f in features], boxes,
                                   strides, output_size, sampling_ratio,
                                   lvl_of_roi)
    if cast_weights:
        weights = weights.to(flat.dtype)
    taps = flat[rows] * weights[..., None]
    vals = taps[..., 0, :] + taps[..., 1, :] + taps[..., 2, :] + \
        taps[..., 3, :]                                  # [R, S, s, S, s, C]
    if not cast_weights:
        return vals.mean(dim=(2, 4))
    s = sampling_ratio
    acc = vals[:, :, 0, :, 0]
    for ki in range(s):
        for kj in range(s):
            if ki or kj:
                acc = acc + vals[:, :, ki, :, kj]
    return acc * (1.0 / (s * s))


def multilevel_roi_align(features: Sequence[torch.Tensor],
                         boxes: torch.Tensor, strides: Tuple[int, ...],
                         output_size: int, sampling_ratio: int = 2,
                         canonical_box_size: int = 224,
                         canonical_level: int = 4,
                         impl: str = "v1") -> torch.Tensor:
    """features: per-level [H_l, W_l, C]; boxes [R, 4] xyxy in image pixels
    -> [R, output_size, output_size, C]."""
    lvls = [int(math.log2(s)) for s in strides]
    if tuple(2 ** lv for lv in lvls) != tuple(strides) or \
            lvls != list(range(lvls[0], lvls[0] + len(features))):
        raise ValueError(
            f"multilevel_roi_align needs contiguous power-of-two strides "
            f"(e.g. (8, 16, 32)); got {strides}")
    if impl not in IMPLS:
        raise ValueError(f"unknown ROIAlign impl {impl!r} (one of {IMPLS})")
    lvl_of_roi = assign_levels(boxes, lvls[0], lvls[-1], canonical_box_size,
                               canonical_level) - lvls[0]
    if impl == "v4":
        return _roi_align_matmul(features, boxes, strides, output_size,
                                 sampling_ratio, lvl_of_roi)
    return _roi_align_taps(features, boxes, strides, output_size,
                           sampling_ratio, lvl_of_roi,
                           cast_weights=impl in ("v2", "v3"))
