"""The zero-padded bilinear sampler of deformable sampling.

Counterpart of the JAX package's `ops/deform_conv.py:bilinear_sample_zero_pad`,
the grid_sample-style sampler that `ops/ms_deform_attn.py` shares. The
modulated deformable convolution of that module (DCNv2), which no model of
either package calls, is still to port (ROADMAP queue 2g): it needs a
kernel written for the card, not only this plain sampler.
"""

from __future__ import annotations

import torch


def bilinear_sample_zero_pad(img: torch.Tensor, y: torch.Tensor,
                             x: torch.Tensor) -> torch.Tensor:
    """img [H, W, C]; y, x [...] continuous coords -> [..., C] with zero
    padding outside [0, H-1] x [0, W-1]: the four hat-weight taps, each
    gathered at its index clipped into the image, its validity folded into
    its scalar weight (cheaper than masking the gathered [..., C] rows).
    A batch of images [B, H, W, C] takes y, x [B, ...], the JAX package's
    `vmap` over the leading axis written out, and gives [B, ..., C]."""
    h, w = img.shape[-3:-1]
    if img.dim() == 4:
        batch = torch.arange(img.shape[0], device=img.device).view(
            -1, *([1] * (y.dim() - 1)))
    y0 = torch.floor(y)
    x0 = torch.floor(x)
    ly = y - y0
    lx = x - x0
    y0i = y0.long()
    x0i = x0.long()

    def tap(yi, xi, wgt):
        ok = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        at = (yi.clamp(0, h - 1), xi.clamp(0, w - 1))
        v = img[(batch,) + at] if img.dim() == 4 else img[at]
        return v * (wgt * ok.to(wgt.dtype))[..., None]

    return (tap(y0i, x0i, (1 - ly) * (1 - lx)) +
            tap(y0i, x0i + 1, (1 - ly) * lx) +
            tap(y0i + 1, x0i, ly * (1 - lx)) +
            tap(y0i + 1, x0i + 1, ly * lx))
