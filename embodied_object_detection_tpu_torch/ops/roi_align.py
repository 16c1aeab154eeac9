"""Multilevel ROIAlignV2 (aligned=True) over an FPN pyramid (kernel 4 of
the port, and its backward, kernel 4b).

Counterpart of the JAX package's `ops/roi_align.py`: detectron2 level
assignment, a fixed `sampling_ratio`, and the CUDA ROIAlign clamp rules (a
sample strictly outside [-1, size] contributes 0; inside, coords clamp to
[0, size-1], so the border bands read the border pixel at full weight).

On a CUDA tensor `multilevel_roi_align` assigns the levels in PyTorch
(`assign_levels`, bit-equal to the JAX package's) and launches
`csrc/roi_align.cu`, which computes the tap form (`impl="v1"`) for every
`impl`: the v1 math, accumulated in f32 and written in the features'
type, each ROI's tap grid staged in shared memory. The JAX default
`impl="v4"` is that math re-associated, with bf16 weights and a bf16
intermediate in a bf16 config (ARCHITECTURE.md
divergence 3b), so on the card `impl` has no effect. Under autograd the
card's call is `RoiAlignFunction`, whose backward launches the second
kernel of `csrc/roi_align.cu`: the tap form's transpose over the same
staged tap grid, each distinct position's sum added once with float4
atomics into one f32 buffer a level, cast once to the levels' type. Boxes
take no gradient (the JAX package stops it). On a CPU tensor `impl` picks the
plain form, differentiated by torch autograd:

  impl="v4"  separable hat-weight matmuls (the JAX default): per level,
             pooled = Ry @ level @ Rx^T with the s x s window mean folded
             into the weight rows; every ROI against every level, the
             assigned level selected
  impl="v1"  the bilinear tap form: four gathered taps per sample from one
             flattened table of all levels, then the window mean

The forward wrapper `roi_align_cuda` is the custom op `eodt::roi_align`
(`torch.library`), whose fake implementation gives its output shape, so
that `serve/export.py` can export a frame that calls it;
`RoiAlignFunction` wraps it for training.
"""

from __future__ import annotations

import ctypes
import math
from typing import List, Optional, Sequence, Tuple

import torch

from ..kernels import build

IMPLS = ("v1", "v4")


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
                    lvl_of_roi):
    c = features[0].shape[-1]
    flat = torch.cat([f.reshape(-1, c) for f in features], dim=0)
    rows, weights = roi_align_taps([f.shape[:2] for f in features], boxes,
                                   strides, output_size, sampling_ratio,
                                   lvl_of_roi)
    taps = flat[rows] * weights[..., None]
    vals = taps[..., 0, :] + taps[..., 1, :] + taps[..., 2, :] + \
        taps[..., 3, :]
    return vals.mean(dim=(2, 4))


@torch.library.custom_op("eodt::roi_align", mutates_args=("stats",))
def _roi_align_op(features: List[torch.Tensor], boxes: torch.Tensor,
                  lvl_of_roi: torch.Tensor, strides: List[int],
                  output_size: int, sampling_ratio: int,
                  stats: Optional[torch.Tensor]) -> torch.Tensor:
    dtype = features[0].dtype
    c = features[0].shape[-1]
    r = boxes.shape[0]
    if dtype not in (torch.bfloat16, torch.float32) or c % 8 or \
            len(features) > 4:
        raise ValueError(f"roi_align: up to 4 levels of bf16 or f32 with a "
                         f"channel count divisible by 8, got "
                         f"{len(features)} levels of {dtype} with C={c}")
    for f in features:
        if f.dtype != dtype or f.dim() != 3 or f.shape[-1] != c or \
                not f.is_contiguous() or f.device != boxes.device or \
                max(f.shape[:2]) > 1024:
            raise ValueError(f"roi_align: every level must be a contiguous "
                             f"[H, W, {c}] {dtype} tensor on {boxes.device} "
                             f"with H, W <= 1024, got {f.dtype} "
                             f"{tuple(f.shape)} on {f.device}")
    if boxes.dtype != torch.float32 or boxes.shape != (r, 4) or \
            not boxes.is_contiguous():
        raise ValueError(f"roi_align: boxes must be contiguous float32 "
                         f"[R, 4], got {boxes.dtype} {tuple(boxes.shape)}")
    if lvl_of_roi.dtype != torch.int32 or lvl_of_roi.shape != (r,) or \
            not lvl_of_roi.is_contiguous() or \
            lvl_of_roi.device != boxes.device:
        raise ValueError(f"roi_align: level ids must be contiguous int32 "
                         f"[{r}] on {boxes.device}, got {lvl_of_roi.dtype} "
                         f"{tuple(lvl_of_roi.shape)}")
    if output_size * sampling_ratio ** 2 > 256 or \
            output_size * sampling_ratio > 64:
        raise ValueError(f"roi_align: output_size * sampling_ratio^2 must be "
                         f"<= 256 and output_size * sampling_ratio <= 64, "
                         f"got {output_size} and {sampling_ratio}")
    if stats is not None and (stats.dtype != torch.int32 or
                              stats.shape != (r, 3) or
                              not stats.is_contiguous() or
                              stats.device != boxes.device):
        raise ValueError(f"roi_align: stats must be a contiguous int32 "
                         f"[{r}, 3] tensor on {boxes.device}")
    launch = build.load("roi_align")
    if stats is not None:
        stats.zero_()
    if any(f.data_ptr() % 16 for f in features):
        raise ValueError("roi_align: every level must start on a 16-byte "
                         "boundary (the kernel copies 16-byte vectors)")
    out = torch.empty((r, output_size, output_size, c), dtype=dtype,
                      device=boxes.device)
    if r == 0:
        return out
    nl = len(features)
    ptrs = (ctypes.c_void_p * nl)(*[f.data_ptr() for f in features])
    heights = (ctypes.c_int * nl)(*[f.shape[0] for f in features])
    widths = (ctypes.c_int * nl)(*[f.shape[1] for f in features])
    strides_c = (ctypes.c_int * nl)(*strides)
    build.check_launch(
        launch(ptrs, heights, widths, strides_c, nl, boxes.data_ptr(),
               lvl_of_roi.data_ptr(), out.data_ptr(), r, c, output_size,
               sampling_ratio, int(dtype == torch.bfloat16),
               0 if stats is None else stats.data_ptr(),
               build.stream_handle()), "roi_align")
    roi_align_cuda.launches += 1
    return out


@_roi_align_op.register_fake
def _(features, boxes, lvl_of_roi, strides, output_size, sampling_ratio,
      stats):
    return boxes.new_empty((boxes.shape[0], output_size, output_size,
                            features[0].shape[-1]), dtype=features[0].dtype)


def roi_align_cuda(features: Sequence[torch.Tensor], boxes: torch.Tensor,
                   lvl_of_roi: torch.Tensor, strides: Tuple[int, ...],
                   output_size: int, sampling_ratio: int,
                   stats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The tap form on the card (`csrc/roi_align.cu`): features per-level
    [H_l, W_l, C] bf16 or f32, boxes [R, 4] f32, lvl_of_roi [R] int32 in
    [0, levels) -> [R, S, S, C] in the features' type. Each block stages
    its ROI's distinct tap rows x distinct tap columns in shared memory,
    in bands of output rows when they do not fit; `stats`, an int32 [R, 3]
    tensor on the card, is zeroed and then receives each ROI's largest
    staged grid (positions), the positions all its bands staged, and its
    bands beyond one a block (0 where no band split)."""
    return _roi_align_op(list(features), boxes, lvl_of_roi, list(strides),
                         output_size, sampling_ratio, stats)


roi_align_cuda.launches = 0


def roi_align_backward_cuda(grad_out: torch.Tensor, shapes,
                            boxes: torch.Tensor, lvl_of_roi: torch.Tensor,
                            strides: Tuple[int, ...], sampling_ratio: int,
                            dtype: torch.dtype) -> Tuple[torch.Tensor, ...]:
    """The tap form's transpose on the card (`csrc/roi_align.cu`):
    grad_out [R, S, S, C] bf16 or f32 -> the gradient of each [H_l, W_l,
    C] level of `shapes`, accumulated in f32 and cast once to `dtype`.
    Each block sums a ROI's contributions to each distinct position of its
    tap grid in registers, then adds them to the level with one float4
    atomic per position and 4 channels."""
    r, size, _, c = grad_out.shape
    if grad_out.dtype not in (torch.bfloat16, torch.float32) or c % 8 or \
            grad_out.shape != (r, size, size, c) or \
            not grad_out.is_contiguous() or len(shapes) > 4 or \
            any(max(hw) > 1024 for hw in shapes):
        raise ValueError(f"roi_align_backward: grad_out must be contiguous "
                         f"bf16 or f32 [R, S, S, C] with C % 8 == 0 over up "
                         f"to 4 levels of sides <= 1024, got "
                         f"{grad_out.dtype} {tuple(grad_out.shape)} over "
                         f"{[tuple(hw) for hw in shapes]}")
    if boxes.dtype != torch.float32 or boxes.shape != (r, 4) or \
            not boxes.is_contiguous() or boxes.device != grad_out.device:
        raise ValueError(f"roi_align_backward: boxes must be contiguous "
                         f"float32 [{r}, 4] on {grad_out.device}, got "
                         f"{boxes.dtype} {tuple(boxes.shape)}")
    if lvl_of_roi.dtype != torch.int32 or lvl_of_roi.shape != (r,) or \
            not lvl_of_roi.is_contiguous() or \
            lvl_of_roi.device != grad_out.device:
        raise ValueError(f"roi_align_backward: level ids must be contiguous "
                         f"int32 [{r}], got {lvl_of_roi.dtype} "
                         f"{tuple(lvl_of_roi.shape)}")
    if size * sampling_ratio ** 2 > 256 or size * sampling_ratio > 64 or \
            size > 20:
        raise ValueError(f"roi_align_backward: output_size * "
                         f"sampling_ratio^2 must be <= 256, output_size * "
                         f"sampling_ratio <= 64 and output_size <= 20 (its "
                         f"gradient slab is staged in shared memory), got "
                         f"{size} and {sampling_ratio}")
    launch = build.load("roi_align_backward")
    if grad_out.data_ptr() % 16:
        grad_out = grad_out.clone()     # the kernel reads 16-byte vectors
    grads = [torch.zeros((h, w, c), dtype=torch.float32,
                         device=grad_out.device) for h, w in shapes]
    if r:
        nl = len(shapes)
        ptrs = (ctypes.c_void_p * nl)(*[g.data_ptr() for g in grads])
        heights = (ctypes.c_int * nl)(*[h for h, _ in shapes])
        widths = (ctypes.c_int * nl)(*[w for _, w in shapes])
        strides_c = (ctypes.c_int * nl)(*strides)
        build.check_launch(
            launch(ptrs, heights, widths, strides_c, nl, boxes.data_ptr(),
                   lvl_of_roi.data_ptr(), grad_out.data_ptr(), r, c, size,
                   sampling_ratio, int(grad_out.dtype == torch.bfloat16),
                   build.stream_handle()), "roi_align_backward")
        roi_align_backward_cuda.launches += 1
    return tuple(g.to(dtype) for g in grads)


roi_align_backward_cuda.launches = 0


class RoiAlignFunction(torch.autograd.Function):
    """`roi_align_cuda` with `roi_align_backward_cuda` as its gradient;
    the boxes and level ids take none."""

    @staticmethod
    def forward(ctx, boxes, lvl_of_roi, strides, output_size,
                sampling_ratio, *features):
        ctx.save_for_backward(boxes, lvl_of_roi)
        ctx.geometry = (tuple(tuple(f.shape[:2]) for f in features),
                        strides, sampling_ratio, features[0].dtype)
        return roi_align_cuda(features, boxes, lvl_of_roi, strides,
                              output_size, sampling_ratio)

    @staticmethod
    def backward(ctx, grad_out):
        boxes, lvl_of_roi = ctx.saved_tensors
        shapes, strides, sampling_ratio, dtype = ctx.geometry
        grads = roi_align_backward_cuda(grad_out.contiguous(), shapes, boxes,
                                        lvl_of_roi, strides, sampling_ratio,
                                        dtype)
        return (None, None, None, None, None) + grads


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
        raise ValueError(f"unknown ROIAlign impl {impl!r} (the port has v1, "
                         "v4)")
    lvl_of_roi = assign_levels(boxes, lvls[0], lvls[-1], canonical_box_size,
                               canonical_level) - lvls[0]
    if build.on_card(boxes):
        features = [f.contiguous() for f in features]
        boxes = boxes.detach().contiguous()
        if torch.is_grad_enabled() and any(f.requires_grad
                                           for f in features):
            return RoiAlignFunction.apply(boxes, lvl_of_roi, tuple(strides),
                                          output_size, sampling_ratio,
                                          *features)
        return roi_align_cuda(features, boxes, lvl_of_roi, tuple(strides),
                              output_size, sampling_ratio)
    if impl == "v4":
        return _roi_align_matmul(features, boxes, strides, output_size,
                                 sampling_ratio, lvl_of_roi)
    return _roi_align_taps(features, boxes, strides, output_size,
                           sampling_ratio, lvl_of_roi)
