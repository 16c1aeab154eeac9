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
threshold may land on the other side of it.
"""

from __future__ import annotations

import torch

from ..kernels import build


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


def paste_masks(masks: torch.Tensor, boxes: torch.Tensor, height: int,
                width: int, threshold: float = 0.5, x_stride: int = 1,
                pixel_major: bool = False) -> torch.Tensor:
    """masks [N, M, M] probabilities, boxes [N, 4] xyxy ->
    [N, H, W//x_stride] (or [H, W//x_stride, N] with pixel_major);
    booleans `>= threshold` when threshold >= 0, else the f32 values.
    The kernel on the card, the plain version on a CPU tensor."""
    if not build.on_card(masks):
        return paste_masks_plain(masks, boxes, height, width, threshold,
                                 x_stride, pixel_major)
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
    launch = build.load("mask_paste")
    out_w = -(-width // x_stride)
    shape = (height, out_w, n) if pixel_major else (n, height, out_w)
    out = torch.empty(shape, dtype=torch.bool if threshold >= 0
                      else torch.float32, device=masks.device)
    if out.numel() == 0:
        return out
    build.check_launch(
        launch(masks.data_ptr(), boxes.data_ptr(), out.data_ptr(), n, m,
               height, width, x_stride, float(threshold), int(pixel_major),
               build.stream_handle()), "mask_paste")
    paste_masks.launches += 1
    return out


paste_masks.launches = 0
