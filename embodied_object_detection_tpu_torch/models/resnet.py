"""ResNet-50 trunk (timm `resnet50_in21k` layout) with frozen batch norm.

Counterpart of the JAX package's `models/resnet.py`; module names match
its parameter tree (conv1, bn1, layer{stage}_{i}.conv{1..3} / bn{1..3} /
downsample_conv / downsample_bn). Convolutions hold f32 weights and run in
the compute dtype; FrozenBN keeps f32 statistics and applies the folded
scale and bias in the activation dtype, as the JAX package does.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import conv, nchw, nhwc


class FrozenBN(nn.Module):
    """y = (x - mean) / sqrt(var + eps) * gamma + beta, never trained."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(channels))
        self.register_buffer("bias", torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        bias = self.bias - self.running_mean * scale
        return x * scale.to(x.dtype)[:, None, None] + \
            bias.to(x.dtype)[:, None, None]


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 x4, FrozenBN, residual."""

    def __init__(self, in_ch: int, planes: int, stride: int, downsample: bool,
                 dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(in_ch, planes, 1, bias=False)
        self.bn1 = FrozenBN(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = FrozenBN(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = FrozenBN(planes * 4)
        if downsample:
            self.downsample_conv = nn.Conv2d(in_ch, planes * 4, 1, stride,
                                             bias=False)
            self.downsample_bn = FrozenBN(planes * 4)
        else:
            self.downsample_conv = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        out = F.relu(self.bn1(conv(x, self.conv1, dt)))
        out = F.relu(self.bn2(conv(out, self.conv2, dt)))
        out = self.bn3(conv(out, self.conv3, dt))
        if self.downsample_conv is not None:
            x = self.downsample_bn(conv(x, self.downsample_conv, dt))
        return F.relu(out + x)


class ResNet50(nn.Module):
    """Returns the stride-8/16/32 stage outputs (C3, C4, C5)."""

    def __init__(self, depths: Sequence[int] = (3, 4, 6, 3),
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.out_channels = (512, 1024, 2048)
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = FrozenBN(64)
        self.stages = []
        in_ch = 64
        for stage, (depth, planes) in enumerate(
                zip(depths, (64, 128, 256, 512))):
            blocks = []
            for i in range(depth):
                block = Bottleneck(in_ch, planes,
                                   (1 if stage == 0 else 2) if i == 0 else 1,
                                   downsample=(i == 0), dtype=dtype)
                self.add_module(f"layer{stage + 1}_{i}", block)
                blocks.append(block)
                in_ch = planes * 4
            self.stages.append(blocks)

    def stem_to_c4(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """NCHW image -> (C3 stride 8, C4 stride 16), NCHW."""
        x = F.relu(self.bn1(conv(x, self.conv1, self.dtype)))
        x = F.max_pool2d(x, 3, 2, 1)
        outs = []
        for blocks in self.stages[:3]:
            for b in blocks:
                x = b(x)
            outs.append(x)
        return outs[1], outs[2]

    def res5(self, x: torch.Tensor) -> torch.Tensor:
        for b in self.stages[3]:
            x = b(x)
        return x

    def forward(self, image: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Normalised image [H, W, 3] or [B, H, W, 3] -> (C3, C4, C5) in
        the same layout (512, 1024, 2048 channels)."""
        batched = image.dim() == 4
        c3, c4 = self.stem_to_c4(nchw(image))
        c5 = self.res5(c4)
        return tuple(nhwc(c, batched) for c in (c3, c4, c5))
