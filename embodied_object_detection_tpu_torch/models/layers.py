"""Shared layers and layout helpers.

The port's public functions keep the JAX package's channels-last layout
([H, W, C], or [B, H, W, C] for a batch). Convolutions take NCHW tensors;
`nchw` views a channels-last tensor as NCHW without a copy (the view has
PyTorch's channels_last strides, which cuDNN runs natively) and `nhwc`
undoes it, also without a copy for a channels_last result.

Parameters are f32, as the JAX package keeps them; a layer that computes
in bf16 casts its weights at each use (`as_dtype`), so autograd sums
every use's gradient into the f32 parameter in f32. Outside autograd
(the eval frame runs under `torch.no_grad()`) the cast copy is cached on
the parameter and made again only after the parameter changes, so a frame
does not pay a cast per weight.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def nchw(x: torch.Tensor) -> torch.Tensor:
    """[H, W, C] or [B, H, W, C] -> [B, C, H, W] view."""
    if x.dim() == 3:
        x = x[None]
    return x.permute(0, 3, 1, 2)


def nhwc(x: torch.Tensor, batched: bool) -> torch.Tensor:
    """[B, C, H, W] -> [B, H, W, C] view, or [H, W, C] when not batched."""
    x = x.permute(0, 2, 3, 1)
    return x if batched else x[0]


def as_dtype(p: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """`p` in `dtype`: a differentiable cast when autograd records it or
    `torch.export` traces it (the exported program casts at each call),
    else a copy cached on `p` until `p` is changed in place or moved."""
    if p.dtype == dtype:
        return p
    if (torch.is_grad_enabled() and p.requires_grad) or \
            torch.compiler.is_compiling():
        return p.to(dtype)
    key = (dtype, p.device, p.data_ptr(), p._version)
    cached = getattr(p, "_cast_cache", None)
    if cached is None or cached[0] != key:
        cached = (key, p.detach().to(dtype))
        p._cast_cache = cached
    return cached[1]


def conv(x: torch.Tensor, layer: nn.Conv2d,
         dtype: "torch.dtype | None" = None) -> torch.Tensor:
    """Apply `layer` to an NCHW tensor in `dtype` (default: the layer's
    own), its weight and bias cast to it."""
    dtype = dtype or layer.weight.dtype
    if dtype == layer.weight.dtype:
        return layer(x.to(dtype))
    bias = None if layer.bias is None else as_dtype(layer.bias, dtype)
    return layer._conv_forward(x.to(dtype), as_dtype(layer.weight, dtype),
                               bias)


def linear(x: torch.Tensor, layer: nn.Linear,
           dtype: torch.dtype) -> torch.Tensor:
    """Apply `layer` in `dtype`, its weight and bias (if any) cast to
    it."""
    bias = None if layer.bias is None else as_dtype(layer.bias, dtype)
    return F.linear(x.to(dtype), as_dtype(layer.weight, dtype), bias)


class GroupNorm(nn.Module):
    """GroupNorm over one image: statistics over all spatial positions and
    the channels of each group, in f32, in the JAX package's arithmetic
    (its unbatched `GroupNorm`): the mean, then the mean of the squared
    deviations, the deviations times rsqrt(var + eps), then the affine
    map, in 8 ops. `F.group_norm`'s CPU variance loses digits where a
    group's mean lies far above its spread; a group of one value
    normalises to 0."""

    def __init__(self, num_groups: int, channels: int, eps: float = 1e-5):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [N, C, H, W] -> f32 [N, C, H, W], each image on its own."""
        xf = x.float().reshape(x.shape[0], self.num_groups, -1)
        xc = xf - xf.mean(-1, keepdim=True)
        xn = xc * torch.rsqrt(xc.square().mean(-1, keepdim=True) + self.eps)
        return torch.addcmul(self.bias[:, None, None], xn.view(x.shape),
                             self.weight[:, None, None])


class LayerNorm(nn.Module):
    """LayerNorm over the last axis in f32, in the JAX package's arithmetic
    (its `nn.LayerNorm`, epsilon 1e-6 by default): the mean and the
    mean of the squares in one pass, var = max(0, E[x^2] - E[x]^2), then
    (x - mean) * (rsqrt(var + eps) * weight) + bias. `F.layer_norm`
    computes the variance in two passes and rounds otherwise. Returns f32
    whatever the input's type."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = (xf * xf).mean(-1, keepdim=True) - mean * mean
        mul = torch.rsqrt(var.clamp(min=0.0) + self.eps) * self.weight
        return (xf - mean) * mul + self.bias
