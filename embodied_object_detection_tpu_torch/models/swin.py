"""Swin Transformer trunk (Swin-B), the alternative to ResNet-50.

Counterpart of the JAX package's `models/swin.py` (ref: Detic/detic/
modeling/backbone/swintransformer.py, the SwinB_896b32 configs). Module
names mirror the JAX parameter tree (patch_embed, patch_norm,
stage{s}_block{b}.{norm1, attn.{qkv, proj, relative_position_bias_table},
norm2, mlp_fc1, mlp_fc2}, out_norm{s}, merge_norm{s},
merge_reduction{s}), so `convert/from_jax.py:load_jax_params` carries
its weights. Tensors are channels-last, [H, W, C] or a batch [B, H, W,
C]; the stride-8/16/32 stage outputs feed the FPN as ResNet-50's do.

Arithmetic follows the JAX package, not the upstream Swin:
  * every LayerNorm is the JAX package's (f32, epsilon 1e-6;
    `layers.LayerNorm`), its result cast to the compute dtype;
  * attention logits are f32 (the product of the compute-dtype q * scale
    and k accumulated and kept in f32), the relative position bias and
    the shift mask (-100 across regions) are added in f32, the softmax
    is f32 and its result is cast to the compute dtype before the
    product with v; GELU is the exact erf form;
  * each stage pads its input once, before its blocks, to a multiple of
    the window, so the padded tokens pass through every block's norms,
    MLP and attention and the shift mask is built on the padded size
    (the upstream Swin re-pads with zeros after norm1 in every block);
  * stochastic depth keeps one coin a frame and a residual branch (a
    block's attention and MLP branches are dropped independently, as
    each of JAX's `_drop_path` calls draws its own key), the kept branch
    scaled by 1 / keep, the rates rising linearly over all blocks to
    `drop_path_rate`. The coins are drawn before the trunk runs
    (`SwinTransformer.draw_coins`) and passed in, so that a trunk
    recomputed in the backward (`backbone.train_remat`) sees the same
    coins.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import LayerNorm, conv, linear, nchw


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """[B, H, W, C] -> [B * nW, ws * ws, C], windows in row-major order
    within each image."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)


def window_reverse(windows: torch.Tensor, ws: int, h: int,
                   w: int) -> torch.Tensor:
    """[B * nW, ws * ws, C] -> [B, H, W, C]."""
    c = windows.shape[-1]
    x = windows.reshape(-1, h // ws, w // ws, ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, h, w, c)


def relative_position_index(ws: int) -> np.ndarray:
    """The torch Swin's relative_position_index [ws * ws, ws * ws]."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[..., 0] += ws - 1
    rel[..., 1] += ws - 1
    rel[..., 0] *= 2 * ws - 1
    return rel.sum(-1)


def shift_mask(h: int, w: int, ws: int, shift: int,
               device: "torch.device | str" = "cpu") -> torch.Tensor:
    """[nW, ws * ws, ws * ws] f32: -100 between tokens of a shifted window
    that come from different regions of the rolled image, else 0 (the
    torch Swin's img_mask), built on `device` (no host copy)."""
    img = torch.zeros((1, h, w, 1), device=device)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[0, hs, wsl] = cnt
            cnt += 1
    win = window_partition(img, ws)[..., 0]                      # [nW, N]
    diff = win[:, None, :] - win[:, :, None]
    return torch.where(diff != 0, -100.0, 0.0)


def drop_path_rates(rate: float, total_blocks: int) -> List[float]:
    """Each block's stochastic-depth rate: 0 at the first, `rate` at the
    last, linear between (the torch Swin's linspace)."""
    return [rate * i / max(total_blocks - 1, 1) for i in range(total_blocks)]


class WindowAttention(nn.Module):
    """Multi-head self-attention within each window, with the relative
    position bias."""

    def __init__(self, dim: int, num_heads: int, window_size: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_heads = num_heads
        self.window_size = window_size
        self.dtype = dtype
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.register_buffer("relative_position_index", torch.from_numpy(
            relative_position_index(window_size).reshape(-1)),
            persistent=False)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B * nW, N, C]; mask [nW, N, N] (one image's windows) or
        None -> [B * nW, N, C] in the compute dtype."""
        nw, n, c = x.shape
        h = self.num_heads
        dt = self.dtype
        qkv = linear(x, self.qkv, dt).reshape(nw, n, 3, h, c // h)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)                # [B*nW, h, N, d]
        attn = torch.matmul((q * (c // h) ** -0.5).float(),
                            k.float().transpose(-2, -1))
        bias = self.relative_position_bias_table[
            self.relative_position_index].reshape(n, n, h).permute(2, 0, 1)
        attn = attn + bias[None].float()
        if mask is not None:
            m = mask.shape[0]
            attn = (attn.reshape(-1, m, h, n, n) +
                    mask[None, :, None]).reshape(nw, h, n, n)
        attn = torch.softmax(attn, dim=-1)
        out = torch.matmul(attn.to(dt), v)
        return linear(out.transpose(1, 2).reshape(nw, n, c), self.proj, dt)


class SwinBlock(nn.Module):
    """norm1 -> (shifted) window attention -> residual, norm2 -> MLP ->
    residual, each branch under stochastic depth in train mode."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 7,
                 shift: int = 0, mlp_ratio: float = 4.0,
                 drop_path: float = 0.0,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.window_size = window_size
        self.shift = shift
        self.drop_path = drop_path
        self.dtype = dtype
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, num_heads, window_size, dtype)
        self.norm2 = LayerNorm(dim)
        hidden = int(dim * mlp_ratio)
        self.mlp_fc1 = nn.Linear(dim, hidden)
        self.mlp_fc2 = nn.Linear(hidden, dim)

    def _drop_path(self, y: torch.Tensor,
                   coin: Optional[torch.Tensor]) -> torch.Tensor:
        if coin is None or self.drop_path <= 0.0:
            return y
        keep = 1.0 - self.drop_path
        return torch.where(coin[:, None, None, None], y / keep,
                           torch.zeros_like(y))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                coin: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, H, W, C] (H, W multiples of the window); mask the shift
        mask of this size (shifted blocks); coin [B, 2] bool, the
        attention branch's and the MLP branch's, or None (eval mode)."""
        _, h, w, _ = x.shape
        ws, s, dt = self.window_size, self.shift, self.dtype
        y = self.norm1(x).to(dt)
        if s:
            y = torch.roll(y, (-s, -s), dims=(1, 2))
        y = window_reverse(self.attn(window_partition(y, ws),
                                     mask if s else None), ws, h, w)
        if s:
            y = torch.roll(y, (s, s), dims=(1, 2))
        x = x + self._drop_path(y, None if coin is None else coin[:, 0])
        z = linear(self.norm2(x).to(dt), self.mlp_fc1, dt)
        z = linear(F.gelu(z), self.mlp_fc2, dt)
        return x + self._drop_path(z, None if coin is None else coin[:, 1])


class SwinTransformer(nn.Module):
    """Swin-B by default: embed 128, depths (2, 2, 18, 2), heads (4, 8, 16,
    32), window 7, patch 4. Returns the stride-8/16/32 stage outputs
    (C3, C4, C5) of `out_channels`."""

    def __init__(self, embed_dim: int = 128,
                 depths: Sequence[int] = (2, 2, 18, 2),
                 num_heads: Sequence[int] = (4, 8, 16, 32),
                 window_size: int = 7, drop_path_rate: float = 0.2,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.depths = tuple(depths)
        self.window_size = window_size
        self.dtype = dtype
        self.rates = drop_path_rates(drop_path_rate, sum(self.depths))
        self.register_buffer("keep_prob", 1.0 - torch.tensor(
            self.rates, dtype=torch.float32), persistent=False)
        self._masks = {}
        self.patch_embed = nn.Conv2d(3, embed_dim, 4, 4)
        self.patch_norm = LayerNorm(embed_dim)
        dim = embed_dim
        for stage, depth in enumerate(self.depths):
            for blk in range(depth):
                self.add_module(f"stage{stage}_block{blk}", SwinBlock(
                    dim, num_heads[stage], window_size,
                    0 if blk % 2 == 0 else window_size // 2,
                    drop_path=self.rates[sum(self.depths[:stage]) + blk],
                    dtype=dtype))
            self.add_module(f"out_norm{stage}", LayerNorm(dim))
            if stage < len(self.depths) - 1:
                self.add_module(f"merge_norm{stage}", LayerNorm(4 * dim))
                self.add_module(f"merge_reduction{stage}",
                                nn.Linear(4 * dim, 2 * dim, bias=False))
                dim *= 2
        self.out_channels = tuple(embed_dim * 2 ** s for s in (1, 2, 3))

    def _shift_mask(self, h: int, w: int,
                    device: torch.device) -> torch.Tensor:
        """The shift mask of a padded stage of h x w tokens, built once
        a size and device."""
        key = (h, w, str(device))
        if key not in self._masks:
            ws = self.window_size
            self._masks[key] = shift_mask(h, w, ws, ws // 2, device)
        return self._masks[key]

    def draw_coins(self, batch: int, generator: torch.Generator
                   ) -> Optional[torch.Tensor]:
        """[batch, blocks, 2] bool stochastic-depth coins, one
        Bernoulli(1 - rate) a frame, a block and a residual branch
        (attention, MLP), drawn from `generator` on the trunk's device (no
        host copy); None, drawing nothing, when no rate is above 0."""
        if max(self.rates, default=0.0) <= 0.0:
            return None
        u = torch.rand((batch, len(self.rates), 2), generator=generator,
                       device=self.keep_prob.device)
        return u < self.keep_prob[:, None]

    def forward(self, x: torch.Tensor, coins: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Normalised image [H, W, 3] or [B, H, W, 3] (H, W multiples of
        32) -> (C3, C4, C5) in the same layout. `coins` [B, blocks, 2] bool
        (or [blocks, 2] for one image) turns on stochastic depth; None is
        eval mode."""
        batched = x.dim() == 4
        if coins is not None and coins.dim() == 2:
            coins = coins[None]
        dt, ws = self.dtype, self.window_size
        x = conv(nchw(x), self.patch_embed, dt).permute(0, 2, 3, 1)
        x = self.patch_norm(x).to(dt)
        outs = []
        first = 0
        for stage, depth in enumerate(self.depths):
            _, h, w, _ = x.shape
            xp = F.pad(x, (0, 0, 0, (-w) % ws, 0, (-h) % ws))
            mask = self._shift_mask(xp.shape[1], xp.shape[2], x.device) \
                if depth > 1 else None
            for blk in range(depth):
                xp = getattr(self, f"stage{stage}_block{blk}")(
                    xp, mask, None if coins is None
                    else coins[:, first + blk])
            first += depth
            x = xp[:, :h, :w]
            if stage:
                outs.append(getattr(self, f"out_norm{stage}")(x).to(dt))
            if stage < len(self.depths) - 1:
                merged = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                                    x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)
                merged = getattr(self, f"merge_norm{stage}")(merged).to(dt)
                x = linear(merged, getattr(self, f"merge_reduction{stage}"),
                           dt)
        return tuple(o if batched else o[0] for o in outs)
