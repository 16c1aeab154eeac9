"""DD-PPO ResNet PointNav policy (PyTorch).

Counterpart of the JAX package's `rl/resnet_policy.py` (ref:
habitat_baselines/rl/ddppo/policy/resnet_policy.py:31-375 and the
GroupNorm ResNet family of rl/ddppo/policy/resnet.py:229-313: narrow
resnet18/50 with baseplanes=32):

- `FlaxGroupNorm` is the JAX package's normaliser, Flax's `nn.GroupNorm`:
  epsilon 1e-6 and the one-pass variance max(0, E[x^2] - E[x]^2), over
  each image's positions and the group's channels, then
  (x - mean) * (rsqrt(var + eps) * scale) + bias. The detector's
  `models/layers.py:GroupNorm` (two passes, eps 1e-5) is another
  function.
- Convolutions run in NCHW; the compression output flattens in HWC order,
  as the JAX package's NHWC module does, so one fc weight serves both.
- Max pooling pads with -inf, as Flax's `max_pool` does.
- The previous-action and goal embeddings and the masked GRU follow
  `rl/policy.py`.

Module names mirror the JAX parameter tree (`net.visual_encoder.Conv_0`,
`GroupNorm_0`, `BasicBlock_{i}` / `Bottleneck_{i}`, `Dense_0`,
`net.tgt_embed`, `net.prev_action_embed`, `net.GRUStateEncoder_0`), so
`convert.from_jax.load_jax_params` carries its weights over.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .policy import (GOAL_UUID, GRUStateEncoder, action_outputs, full_f32,
                     init_orthogonal, sequence_outputs)

__all__ = ["FlaxGroupNorm", "ResNetEncoder", "PointNavResNetNet",
           "PointNavResNetPolicy"]


class FlaxGroupNorm(nn.Module):
    """Flax's `nn.GroupNorm` (use_fast_variance, epsilon 1e-6) over each
    image of [N, C, H, W]."""

    def __init__(self, num_groups: int, channels: int, eps: float = 1e-6):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c = x.shape[:2]
        g = x.float().reshape(n, self.num_groups, -1)
        mean = g.mean(-1, keepdim=True)
        var = ((g * g).mean(-1, keepdim=True) - mean * mean).clamp(min=0.0)
        per_channel = (n, self.num_groups, c // self.num_groups)
        mean = mean.expand(per_channel).reshape(n, c, 1, 1)
        mul = torch.rsqrt(var + self.eps).expand(per_channel).reshape(
            n, c, 1, 1) * self.weight[:, None, None]
        return (x - mean) * mul + self.bias[:, None, None]


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_ch: int, planes: int, stride: int, ngroups: int):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_ch, planes, 3, stride, 1, bias=False)
        self.GroupNorm_0 = FlaxGroupNorm(ngroups, planes)
        self.Conv_1 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.GroupNorm_1 = FlaxGroupNorm(ngroups, planes)
        self.down = stride != 1 or in_ch != planes
        if self.down:
            self.Conv_2 = nn.Conv2d(in_ch, planes, 1, stride, bias=False)
            self.GroupNorm_2 = FlaxGroupNorm(ngroups, planes)

    def forward(self, x):
        y = F.relu(self.GroupNorm_0(self.Conv_0(x)))
        y = self.GroupNorm_1(self.Conv_1(y))
        identity = self.GroupNorm_2(self.Conv_2(x)) if self.down else x
        return F.relu(y + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_ch: int, planes: int, stride: int, ngroups: int):
        super().__init__()
        out_ch = planes * self.expansion
        self.Conv_0 = nn.Conv2d(in_ch, planes, 1, bias=False)
        self.GroupNorm_0 = FlaxGroupNorm(ngroups, planes)
        self.Conv_1 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.GroupNorm_1 = FlaxGroupNorm(ngroups, planes)
        self.Conv_2 = nn.Conv2d(planes, out_ch, 1, bias=False)
        self.GroupNorm_2 = FlaxGroupNorm(ngroups, out_ch)
        self.down = stride != 1 or in_ch != out_ch
        if self.down:
            self.Conv_3 = nn.Conv2d(in_ch, out_ch, 1, stride, bias=False)
            self.GroupNorm_3 = FlaxGroupNorm(ngroups, out_ch)

    def forward(self, x):
        y = F.relu(self.GroupNorm_0(self.Conv_0(x)))
        y = F.relu(self.GroupNorm_1(self.Conv_1(y)))
        y = self.GroupNorm_2(self.Conv_2(y))
        identity = self.GroupNorm_3(self.Conv_3(x)) if self.down else x
        return F.relu(y + identity)


_BACKBONES = {
    # name -> (block, layers); resnet.py:229-313
    "resnet18": (BasicBlock, (2, 2, 2, 2)),
    "resnet50": (Bottleneck, (3, 4, 6, 3)),
}


def _down(size: int, kernel: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - kernel) // stride + 1


class ResNetEncoder(nn.Module):
    """GroupNorm ResNet visual encoder + spatial compression
    (resnet_policy.py:60-180); ngroups defaults to baseplanes // 2."""

    def __init__(self, backbone: str = "resnet18", baseplanes: int = 32,
                 ngroups: int = 0, output_size: int = 512,
                 in_channels: int = 3, image_hw: Sequence[int] = (64, 64)):
        super().__init__()
        ngroups = ngroups or max(1, baseplanes // 2)
        block, layers = _BACKBONES[backbone]
        name = block.__name__
        self.Conv_0 = nn.Conv2d(in_channels, baseplanes, 7, 2, 3, bias=False)
        self.GroupNorm_0 = FlaxGroupNorm(ngroups, baseplanes)
        h, w = (_down(s, 7, 2, 3) for s in image_hw)
        h, w = _down(h, 3, 2, 1), _down(w, 3, 2, 1)
        self.blocks = []
        in_ch, planes, k = baseplanes, baseplanes, 0
        for i, n in enumerate(layers):
            for j in range(n):
                stride = 2 if (i > 0 and j == 0) else 1
                b = block(in_ch, planes, stride, ngroups)
                self.add_module(f"{name}_{k}", b)
                self.blocks.append(b)
                if stride == 2:
                    h, w = _down(h, 3, 2, 1), _down(w, 3, 2, 1)
                in_ch, k = planes * block.expansion, k + 1
            planes *= 2
        self.Conv_1 = nn.Conv2d(in_ch, output_size // 4, 3, 1, 1, bias=False)
        self.GroupNorm_1 = FlaxGroupNorm(ngroups, output_size // 4)
        self.Dense_0 = nn.Linear(output_size // 4 * h * w, output_size)

    def forward(self, observations: Dict[str, torch.Tensor]) -> torch.Tensor:
        """{"rgb": [B, H, W, 3], "depth": [B, H, W, 1]} (either or both)
        -> [B, output_size]."""
        inputs = []
        if "rgb" in observations:
            inputs.append(observations["rgb"].float() / 255.0)
        if "depth" in observations:
            inputs.append(observations["depth"].float())
        if not inputs:
            raise ValueError("ResNetEncoder needs rgb and/or depth")
        x = torch.cat(inputs, dim=-1).permute(0, 3, 1, 2)
        x = F.relu(self.GroupNorm_0(self.Conv_0(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        for b in self.blocks:
            x = b(x)
        x = F.relu(self.GroupNorm_1(self.Conv_1(x)))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # HWC order
        return F.relu(self.Dense_0(x))


class PointNavResNetNet(nn.Module):
    """Visual embed + goal embed + prev-action embed -> masked GRU
    (resnet_policy.py:183-280)."""

    def __init__(self, hidden_size: int = 512, backbone: str = "resnet18",
                 baseplanes: int = 32, dim_actions: int = 4,
                 goal_uuid: str = GOAL_UUID, in_channels: int = 3,
                 image_hw: Sequence[int] = (64, 64)):
        super().__init__()
        self.goal_uuid = goal_uuid
        self.tgt_embed = nn.Linear(3, 32)
        self.prev_action_embed = nn.Embedding(dim_actions + 1, 32)
        self.visual_encoder = ResNetEncoder(
            backbone, baseplanes, output_size=hidden_size,
            in_channels=in_channels, image_hw=image_hw)
        self.GRUStateEncoder_0 = GRUStateEncoder(hidden_size + 64,
                                                 hidden_size)

    def forward(self, observations, hidden, prev_actions, masks):
        tgt = observations[self.goal_uuid].float()
        # rho, cos/sin(-phi) featurisation (resnet_policy.py:216-222)
        tgt = torch.cat([tgt[..., :1], torch.cos(-tgt[..., 1:2]),
                         torch.sin(-tgt[..., 1:2])], dim=-1)
        goal_emb = self.tgt_embed(tgt)
        # prev_action + 1 with start token 0 (resnet_policy.py:236-241)
        pa = torch.where(masks > 0, prev_actions.long() + 1,
                         torch.zeros_like(prev_actions.long()))
        act_emb = self.prev_action_embed(pa)
        lead = tgt.shape[:-1]
        vis_obs = {k: v.reshape((-1,) + tuple(v.shape[len(lead):]))
                   for k, v in observations.items() if k in ("rgb", "depth")}
        vis = self.visual_encoder(vis_obs).reshape(lead + (-1,))
        x = torch.cat([vis, goal_emb, act_emb], dim=-1)
        return self.GRUStateEncoder_0(x, hidden, masks)


class PointNavResNetPolicy(nn.Module):
    """Actor-critic over PointNavResNetNet; the same act / get_value /
    evaluate_actions surface as `rl.policy.PointNavPolicy`.
    `sensors` names the visual inputs ("rgb", "depth") and `image_hw`
    their size."""

    def __init__(self, dim_actions: int, hidden_size: int = 512,
                 backbone: str = "resnet18", baseplanes: int = 32,
                 goal_uuid: str = GOAL_UUID,
                 sensors: Sequence[str] = ("rgb",),
                 image_hw: Sequence[int] = (64, 64), seed: int = 0):
        super().__init__()
        self.dim_actions = dim_actions
        self.hidden_size = hidden_size
        self.blind = False
        in_channels = 3 * ("rgb" in sensors) + ("depth" in sensors)
        self.net = PointNavResNetNet(hidden_size, backbone, baseplanes,
                                     dim_actions, goal_uuid, in_channels,
                                     image_hw)
        self.action_head = nn.Linear(hidden_size, dim_actions)
        self.critic = nn.Linear(hidden_size, 1)
        self.reset_parameters(seed)

    def reset_parameters(self, seed: int) -> None:
        """Orthogonal heads, GRU and visual fc (gains as the JAX
        initialisers), He-normal convolutions, normal(0, 1) embeddings;
        GroupNorm scale 1, bias 0."""
        gen = torch.Generator().manual_seed(seed)
        for name, m in self.named_modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                with torch.no_grad():
                    m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                                   / math.sqrt(fan_in))
            elif isinstance(m, nn.Linear):
                gain = {"action_head": 0.01}.get(
                    name, math.sqrt(2.0) if name.endswith("Dense_0")
                    else 1.0)
                init_orthogonal(m, gen, gain)
            elif isinstance(m, nn.Embedding):
                with torch.no_grad():
                    m.weight.copy_(torch.randn(m.weight.shape, generator=gen))

    @full_f32()
    def forward(self, observations, hidden, prev_actions, masks):
        feats, hidden = self.net(observations, hidden, prev_actions, masks)
        return self.action_head(feats), self.critic(feats)[..., 0], hidden

    def act(self, observations, hidden, prev_actions, masks,
            generator: Optional[torch.Generator] = None,
            deterministic: bool = False):
        logits, value, hidden = self(observations, hidden, prev_actions,
                                     masks)
        return action_outputs(logits, value, generator, deterministic) + \
            (hidden,)

    def get_value(self, observations, hidden, prev_actions, masks):
        return self(observations, hidden, prev_actions, masks)[1]

    def evaluate_actions(self, observations, hidden, prev_actions, masks,
                         actions):
        logits, values, _ = self(observations, hidden, prev_actions, masks)
        return sequence_outputs(logits, values, actions)
