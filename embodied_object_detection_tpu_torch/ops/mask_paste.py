"""Paste predicted instance masks into the image plane, plain PyTorch.

Bilinear grid sampling (grid_sample, align_corners=False, zero padding)
is separable, so the pasted image of one detection is R_y @ mask @ R_x^T
with R_y [H, M] / R_x [W, M] the 1-D hat weights of every image row and
column against the mask grid. Counterpart of the JAX package's
`ops/mask_paste.py`; f32 throughout (callers disable TF32), because mask
probabilities near the 0.5 threshold feed the memory write.
"""

from __future__ import annotations

import torch


def _hat_weights(src: torch.Tensor, m: int) -> torch.Tensor:
    """src [..., P] source coords -> [..., P, M] bilinear weights, zero
    outside [0, M-1]."""
    taps = torch.arange(m, dtype=torch.float32, device=src.device)
    return (1.0 - (src[..., None] - taps).abs()).clamp(min=0.0)


def paste_masks(masks: torch.Tensor, boxes: torch.Tensor, height: int,
                width: int, threshold: float = 0.5, x_stride: int = 1,
                pixel_major: bool = False) -> torch.Tensor:
    """masks [N, M, M] probabilities, boxes [N, 4] xyxy ->
    [N, H, W//x_stride] (or [H, W//x_stride, N] with pixel_major);
    booleans `>= threshold` when threshold >= 0, else the float values.
    x_stride > 1 evaluates only every x_stride-th column."""
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
