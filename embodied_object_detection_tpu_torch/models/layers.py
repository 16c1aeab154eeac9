"""Shared layers and layout helpers.

The port's public functions keep the JAX package's channels-last layout
([H, W, C], or [B, H, W, C] for a batch). Convolutions take NCHW tensors;
`nchw` views a channels-last tensor as NCHW without a copy (the view has
PyTorch's channels_last strides, which cuDNN runs natively) and `nhwc`
undoes it, also without a copy for a channels_last result.
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


def conv(x: torch.Tensor, layer: nn.Conv2d) -> torch.Tensor:
    """Apply `layer` to an NCHW tensor in the layer's own dtype."""
    return layer(x.to(layer.weight.dtype))


class GroupNorm(nn.Module):
    """GroupNorm over one image: statistics over all spatial positions and
    the channels of each group, in f32 (the JAX package's unbatched
    `GroupNorm`, which matches torch.nn.GroupNorm on a batch of one)."""

    def __init__(self, num_groups: int, channels: int, eps: float = 1e-5):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [1, C, H, W] -> f32 [1, C, H, W]."""
        return F.group_norm(x.float(), self.num_groups, self.weight,
                            self.bias, self.eps)
