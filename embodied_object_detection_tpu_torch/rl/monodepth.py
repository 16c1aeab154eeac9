"""Monocular depth estimation net for the SLAM agents (PyTorch).

Counterpart of the JAX package's `rl/monodepth.py` (ref:
habitat_baselines/slambased/monodepth.py: the "Revisiting Single Image
Depth Estimation" net of Hu et al. 2018): a ResNet-50 encoder whose four
stage outputs feed (a) a decoder of four UpProjections (bilinear
upsample, then two conv branches summed) and (b) an MFF block fusing all
four scales at 16 channels each, concatenated and refined to a
one-channel depth map (model/D/MFF/R, monodepth.py:263-499).

The encoder reuses the detector's `models/resnet.py` `FrozenBN` and
`Bottleneck` in f32. Every resize on the path is an upsample (at
228 x 304: b1..b4 are 57 x 76 .. 8 x 10, the decoder's output 114 x 152,
the estimator's last resize back to 228 x 304), so
`F.interpolate(size=..., mode="bilinear", align_corners=False)` computes
what `jax.image.resize(..., "linear")` does; the size is always passed
as `size=`. Module names mirror the JAX parameter tree (conv1, bn1,
layer{s}_{i}, d_conv, d_up{i}, mff_up{i}, r_conv{i}, ...), so
`convert.from_jax.load_jax_params` carries its weights over;
`convert_monodepth_torch` maps the reference checkpoint's
`module.E/D/MFF/R` names onto them.
"""

from __future__ import annotations

import re
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models.detector import resolve_device
from ..models.resnet import Bottleneck, FrozenBN
from .policy import full_f32

__all__ = ["UpProjection", "MonoDepthNet", "MonoDepthEstimator",
           "convert_monodepth_torch"]


def _resize(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=False)


class UpProjection(nn.Module):
    """_UpProjection (monodepth.py:288-330): bilinear upsample ->
    [5x5 conv + BN + relu -> 3x3 conv + BN] + [5x5 conv + BN] -> relu(sum)."""

    def __init__(self, in_ch: int, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, features, 5, 1, 2, bias=False)
        self.bn1 = FrozenBN(features)
        self.conv1_2 = nn.Conv2d(features, features, 3, 1, 1, bias=False)
        self.bn1_2 = FrozenBN(features)
        self.conv2 = nn.Conv2d(in_ch, features, 5, 1, 2, bias=False)
        self.bn2 = FrozenBN(features)

    def forward(self, x: torch.Tensor, size) -> torch.Tensor:
        x = _resize(x, size)
        b1 = self.bn1_2(self.conv1_2(F.relu(self.bn1(self.conv1(x)))))
        b2 = self.bn2(self.conv2(x))
        return F.relu(b1 + b2)


class MonoDepthNet(nn.Module):
    """The encoder-decoder depth net (monodepth.py `model`, R50 encoder):
    normalised RGB [H, W, 3] or [B, H, W, 3] -> depth at half resolution,
    [H/2, W/2] or [B, H/2, W/2]."""

    def __init__(self, depths: Sequence[int] = (3, 4, 6, 3),
                 num_features: int = 2048,
                 block_channel: Sequence[int] = (256, 512, 1024, 2048)):
        super().__init__()
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
                                   downsample=(i == 0), dtype=torch.float32)
                self.add_module(f"layer{stage + 1}_{i}", block)
                blocks.append(block)
                in_ch = planes * 4
            self.stages.append(blocks)
        nf = num_features
        self.d_conv = nn.Conv2d(nf, nf // 2, 1, bias=False)
        self.d_bn = FrozenBN(nf // 2)
        for i in range(4):
            self.add_module(f"d_up{i + 1}",
                            UpProjection(nf // (2 << i), nf // (4 << i)))
            self.add_module(f"mff_up{i + 1}",
                            UpProjection(block_channel[i], 16))
        self.mff_conv = nn.Conv2d(64, 64, 5, 1, 2, bias=False)
        self.mff_bn = FrozenBN(64)
        rf = 64 + block_channel[3] // 32
        self.r_conv0 = nn.Conv2d(rf, rf, 5, 1, 2, bias=False)
        self.r_bn0 = FrozenBN(rf)
        self.r_conv1 = nn.Conv2d(rf, rf, 5, 1, 2, bias=False)
        self.r_bn1 = FrozenBN(rf)
        self.r_conv2 = nn.Conv2d(rf, 1, 5, 1, 2)

    @full_f32()
    def forward(self, image: torch.Tensor) -> torch.Tensor:
        batched = image.dim() == 4
        x = (image if batched else image[None]).permute(0, 3, 1, 2).float()
        # encoder (E_resnet, monodepth.py:333-357)
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        feats = []
        for blocks in self.stages:
            for b in blocks:
                x = b(x)
            feats.append(x)
        b1, b2, b3, b4 = feats
        # decoder D (monodepth.py:360-404)
        d = F.relu(self.d_bn(self.d_conv(b4)))
        d = self.d_up1(d, b3.shape[2:])
        d = self.d_up2(d, b2.shape[2:])
        d = self.d_up3(d, b1.shape[2:])
        d = self.d_up4(d, (b1.shape[2] * 2, b1.shape[3] * 2))
        # MFF (monodepth.py:407-447)
        size = d.shape[2:]
        m = torch.cat([up(b, size) for up, b in zip(
            (self.mff_up1, self.mff_up2, self.mff_up3, self.mff_up4),
            (b1, b2, b3, b4))], dim=1)
        m = F.relu(self.mff_bn(self.mff_conv(m)))
        # refinement R (monodepth.py:450-499)
        y = torch.cat([d, m], dim=1)
        y = F.relu(self.r_bn0(self.r_conv0(y)))
        y = F.relu(self.r_bn1(self.r_conv1(y)))
        out = self.r_conv2(y)[:, 0]
        return out if batched else out[0]


# -------------------------------------------------------------- converter

_UP = re.compile(r"(D|MFF)\.up(\d)\.(conv1|conv1_2|conv2|bn1|bn1_2|bn2)"
                 r"\.(.*)")
_RULES = (
    (re.compile(r"E\.(conv1|bn1)\.(.*)"), r"\1.\2"),
    (re.compile(r"E\.layer(\d)\.(\d+)\.(conv\d|bn\d)\.(.*)"),
     r"layer\1_\2.\3.\4"),
    (re.compile(r"E\.layer(\d)\.(\d+)\.downsample\.0\.(.*)"),
     r"layer\1_\2.downsample_conv.\3"),
    (re.compile(r"E\.layer(\d)\.(\d+)\.downsample\.1\.(.*)"),
     r"layer\1_\2.downsample_bn.\3"),
    (re.compile(r"D\.conv\.(.*)"), r"d_conv.\1"),
    (re.compile(r"D\.bn\.(.*)"), r"d_bn.\1"),
    (re.compile(r"MFF\.conv\.(.*)"), r"mff_conv.\1"),
    (re.compile(r"MFF\.bn\.(.*)"), r"mff_bn.\1"),
    (re.compile(r"R\.(conv\d|bn\d)\.(.*)"), r"r_\1.\2"),
)


def convert_monodepth_torch(state_dict) -> Dict[str, torch.Tensor]:
    """The reference checkpoint's state_dict (monodepth.py:636-662:
    `module.` prefixes; E.<resnet>, D.conv/bn/up{1-4}, MFF.up{1-4}/conv/bn,
    R.conv0/bn0/conv1/bn1/conv2) -> state dict of `MonoDepthNet`. The
    torch layouts carry over as they are; `num_batches_tracked` is
    dropped."""
    out = {}
    for name, value in state_dict.items():
        name = name.replace("module.", "")
        if "num_batches" in name:
            continue
        m = _UP.fullmatch(name)
        if m:
            prefix = "d_up" if m.group(1) == "D" else "mff_up"
            key = f"{prefix}{m.group(2)}.{m.group(3)}.{m.group(4)}"
        else:
            key = next((rx.sub(rep, name) for rx, rep in _RULES
                        if rx.fullmatch(name)), None)
            if key is None:
                continue
        out[key] = torch.from_numpy(np.array(value, np.float32))
    return out


class MonoDepthEstimator:
    """Preprocess + predict + resize (MonoDepthEstimator,
    monodepth.py:636-678): ImageNet-normalise the RGB frame, run the net on
    `device` (the card unless the caller asks for the CPU), resize the
    half-resolution prediction back to the input size."""

    MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
    STD = np.asarray([0.229, 0.224, 0.225], np.float32)

    def __init__(self, net: "MonoDepthNet | None" = None,
                 depths=(3, 4, 6, 3), device: "torch.device | str" = "cuda"):
        self.device = resolve_device(device)
        self.net = (net or MonoDepthNet(depths=depths)).to(self.device).eval()

    def init(self, seed: int = 0) -> None:
        """Seeded weights: He-normal convolutions, FrozenBN statistics near
        the identity (scale 1 + U(-0.1, 0.1), shift N(0, 0.01))."""
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for m in self.net.modules():
                if isinstance(m, nn.Conv2d):
                    w = torch.randn(m.weight.shape, generator=gen) / \
                        np.sqrt(m.weight[0].numel())
                    m.weight.copy_(w)
                    if m.bias is not None:
                        m.bias.zero_()
                elif isinstance(m, FrozenBN):
                    c = m.weight.numel()
                    m.weight.copy_(1 + 0.2 * (torch.rand(c, generator=gen)
                                              - 0.5))
                    m.bias.copy_(0.01 * torch.randn(c, generator=gen))

    @torch.no_grad()
    def predict(self, rgb_uint8: np.ndarray) -> torch.Tensor:
        """[H, W, 3] uint8 -> [H, W] depth on the device."""
        x = rgb_uint8.astype(np.float32) / 255.0
        x = (x - self.MEAN) / self.STD
        pred = self.net(torch.from_numpy(x).to(self.device))
        return _resize(pred[None, None], rgb_uint8.shape[:2])[0, 0]

    def compute_depth(self, rgb_uint8: np.ndarray) -> np.ndarray:
        return self.predict(rgb_uint8).cpu().numpy()
