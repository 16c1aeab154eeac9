"""Paste predicted instance masks into the image plane (kernel 5 of the
port).

Bilinear grid sampling (grid_sample, align_corners=False, zero padding)
is separable, so the pasted image of one detection is R_y @ mask @ R_x^T
with R_y [H, M] / R_x [W, M] the 1-D hat weights of every image row and
column against the mask grid. Counterpart of the JAX package's
`ops/mask_paste.py`; f32 throughout (callers disable TF32), because mask
probabilities near the 0.5 threshold feed the memory write.

On a CUDA tensor `paste_masks` launches `csrc/mask_paste.cu`, a direct
2 x 2-tap evaluation per output element with the same hat weights; on a
CPU tensor it takes the plain version, the two batched products. The two
sum the four taps in another order, so a value within f32 rounding of the
threshold may land on the other side of it. `paste_masks_observed` is the
exact memory write's form: the same paste, pixel-major, with the write's
observed flags and per-row counts written by the same kernel.

Both wrappers are custom ops (`eodt::paste_masks`,
`eodt::paste_masks_observed`; `torch.library`) whose fake implementations
give their output shapes, so that `serve/export.py` can export a frame
that calls them.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..kernels import build

TILE_COLS = 32        # the paste kernel's tile width: one count a tile row


def _hat_weights(src: torch.Tensor, m: int) -> torch.Tensor:
    """src [..., P] source coords -> [..., P, M] bilinear weights, zero
    outside [0, M-1]."""
    taps = torch.arange(m, dtype=torch.float32, device=src.device)
    return (1.0 - (src[..., None] - taps).abs()).clamp(min=0.0)


def paste_masks_plain(masks: torch.Tensor, boxes: torch.Tensor, height: int,
                      width: int, threshold: float = 0.5, x_stride: int = 1,
                      pixel_major: bool = False) -> torch.Tensor:
    """The plain PyTorch version of `paste_masks`: the two batched
    products. x_stride > 1 evaluates only every x_stride-th column."""
    n, m, _ = masks.shape
    device = masks.device
    xs = torch.arange(0, width, x_stride, dtype=torch.float32,
                      device=device) + 0.5
    ys = torch.arange(height, dtype=torch.float32, device=device) + 0.5
    x0, y0, x1, y1 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    bw = (x1 - x0).clamp(min=1e-4)[:, None]
    bh = (y1 - y0).clamp(min=1e-4)[:, None]
    gx = (xs[None, :] - x0[:, None]) / bw * 2.0 - 1.0     # [N, W]
    gy = (ys[None, :] - y0[:, None]) / bh * 2.0 - 1.0     # [N, H]
    sx = ((gx + 1.0) * m - 1.0) / 2.0
    sy = ((gy + 1.0) * m - 1.0) / 2.0
    rx = _hat_weights(sx, m)                              # [N, W, M]
    ry = _hat_weights(sy, m)                              # [N, H, M]
    out = torch.bmm(torch.bmm(ry, masks.float()), rx.transpose(1, 2))
    if threshold >= 0:
        out = out >= threshold
    return out.permute(1, 2, 0).contiguous() if pixel_major else out


def _paste_launch(masks, boxes, height, width, threshold, x_stride,
                  pixel_major, valid=None):
    """Check the inputs of the paste kernel and launch it; with `valid`
    also its observed-flag epilogue. Returns (out, observed, counts), the
    last two None without `valid`."""
    masks = masks.float().contiguous()
    n, m, m2 = masks.shape
    if m != m2 or boxes.dtype != torch.float32 or boxes.shape != (n, 4) \
            or not boxes.is_contiguous() or boxes.device != masks.device:
        raise ValueError(f"paste_masks: masks must be [N, M, M] and boxes "
                         f"contiguous float32 [N, 4] on {masks.device}, got "
                         f"{tuple(masks.shape)} and {boxes.dtype} "
                         f"{tuple(boxes.shape)} on {boxes.device}")
    if x_stride < 1 or height < 0 or width < 0:
        raise ValueError(f"paste_masks: x_stride must be >= 1 and the image "
                         f"size >= 0, got {x_stride}, {height}x{width}")
    if valid is not None and (valid.dtype != torch.bool or
                              valid.shape != (n,) or
                              not valid.is_contiguous() or
                              valid.device != masks.device):
        raise ValueError(f"paste_masks_observed: valid must be contiguous "
                         f"bool [{n}] on {masks.device}, got {valid.dtype} "
                         f"{tuple(valid.shape)} on {valid.device}")
    launch = build.load("mask_paste")
    out_w = -(-width // x_stride)
    shape = (height, out_w, n) if pixel_major else (n, height, out_w)
    out = torch.empty(shape, dtype=torch.bool if threshold >= 0
                      else torch.float32, device=masks.device)
    observed = counts = None
    if valid is not None:
        # every flag and count is written by the kernel; with no masks
        # there is nothing to launch and nothing observed
        make = torch.zeros if n == 0 else torch.empty
        observed = make((height, out_w), dtype=torch.bool,
                        device=masks.device)
        counts = make((height, -(-out_w // TILE_COLS)), dtype=torch.int32,
                      device=masks.device)
    if out.numel() == 0:
        return out, observed, counts
    build.check_launch(
        launch(masks.data_ptr(), boxes.data_ptr(), out.data_ptr(), n, m,
               height, width, x_stride, float(threshold), int(pixel_major),
               0 if valid is None else valid.data_ptr(),
               0 if valid is None else observed.data_ptr(),
               0 if valid is None else counts.data_ptr(),
               build.stream_handle()), "mask_paste")
    paste_masks.launches += 1
    return out, observed, counts


@torch.library.custom_op("eodt::paste_masks", mutates_args=())
def _paste_masks_op(masks: torch.Tensor, boxes: torch.Tensor, height: int,
                    width: int, threshold: float, x_stride: int,
                    pixel_major: bool) -> torch.Tensor:
    if not build.on_card(masks):
        return paste_masks_plain(masks, boxes, height, width, threshold,
                                 x_stride, pixel_major)
    return _paste_launch(masks, boxes, height, width, threshold, x_stride,
                         pixel_major)[0]


@_paste_masks_op.register_fake
def _(masks, boxes, height, width, threshold, x_stride, pixel_major):
    n, out_w = masks.shape[0], -(-width // x_stride)
    shape = (height, out_w, n) if pixel_major else (n, height, out_w)
    return masks.new_empty(shape, dtype=torch.bool if threshold >= 0
                           else torch.float32)


def paste_masks(masks: torch.Tensor, boxes: torch.Tensor, height: int,
                width: int, threshold: float = 0.5, x_stride: int = 1,
                pixel_major: bool = False) -> torch.Tensor:
    """masks [N, M, M] probabilities, boxes [N, 4] xyxy ->
    [N, H, W//x_stride] (or [H, W//x_stride, N] with pixel_major);
    booleans `>= threshold` when threshold >= 0, else the f32 values.
    The kernel on the card, the plain version on a CPU tensor."""
    return _paste_masks_op(masks, boxes, height, width, float(threshold),
                           x_stride, pixel_major)


paste_masks.launches = 0


@torch.library.custom_op("eodt::paste_masks_observed", mutates_args=())
def _paste_masks_observed_op(masks: torch.Tensor, boxes: torch.Tensor,
                             valid: torch.Tensor, height: int, width: int,
                             threshold: float
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    if not build.on_card(masks):
        out = paste_masks_plain(masks, boxes, height, width, threshold,
                                pixel_major=True)
        observed = (out & valid).any(dim=-1)
        return out, observed, observed.sum(dim=1, keepdim=True,
                                           dtype=torch.int32)
    return _paste_launch(masks, boxes, height, width, threshold, 1, True,
                         valid)


@_paste_masks_observed_op.register_fake
def _(masks, boxes, valid, height, width, threshold):
    cols = -(-width // TILE_COLS) if masks.device.type == "cuda" else 1
    return (masks.new_empty((height, width, masks.shape[0]),
                            dtype=torch.bool),
            masks.new_empty((height, width), dtype=torch.bool),
            masks.new_empty((height, cols), dtype=torch.int32))


def paste_masks_observed(masks: torch.Tensor, boxes: torch.Tensor,
                         valid: torch.Tensor, height: int, width: int,
                         threshold: float = 0.5
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The exact memory write's paste: `paste_masks(..., pixel_major=True)`
    and the write's observed flags in one pass. masks [N, M, M], boxes
    [N, 4], valid [N] bool -> (masks [H, W, N] bool, observed [H, W] bool
    = any_n(masks & valid), counts [H, K] int32, row y summing to row y's
    observed pixels). On the card the paste kernel writes the flags and
    one count per (row, 32-column tile), K = ceil(W / 32), as it stores
    the masks (counted as one `paste_masks` launch); on a CPU tensor the
    plain paste, its flags and K = 1."""
    if threshold < 0:
        raise ValueError(f"paste_masks_observed: the flags need boolean "
                         f"masks (threshold >= 0), got {threshold}")
    return _paste_masks_observed_op(masks, boxes, valid, height, width,
                                    float(threshold))
