"""Actor-critic policy for PointNav PPO (PyTorch).

Counterpart of the JAX package's `rl/policy.py` (ref: habitat_baselines
rl/ppo/policy.py:21-181, rl/models/simple_cnn.py and the mask-resetting
rl/models/rnn_state_encoder.py):

- `SimpleCNN` runs its three convolutions in NCHW and flattens the last
  map in HWC order, as the JAX package's NHWC module does, so that one
  fc weight serves both packages.
- `GRUCell` keeps torch's r/z/n gate order in two `Linear`s, `ih` and
  `hh`, named as the JAX parameter tree so that `convert.from_jax.
  load_jax_params` carries its weights over. A single step multiplies
  the hidden state by the done-mask and runs the cell; a sequence loops
  over T with the mask applied to the carry (rnn_state_encoder.py:66).
- `act` samples by Gumbel-max from an explicit `torch.Generator`, as
  `jax.random.categorical` does (no host sync); `deterministic` takes
  the argmax.

Module names mirror the JAX tree (`net.SimpleCNN_0.Conv_0`,
`net.GRUStateEncoder_0.GRUCell_0.ih`, `action_head`, `critic`). Weights
are drawn from `seed` on the CPU (orthogonal, zero biases, as the JAX
initialisers), so a policy is the same on every device and rank.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["SimpleCNN", "GRUCell", "GRUStateEncoder", "PointNavBaselineNet",
           "PointNavPolicy", "make_policy", "full_f32", "init_orthogonal",
           "sample_actions", "action_outputs", "sequence_outputs"]

GOAL_UUID = "pointgoal_with_gps_compass"


@contextlib.contextmanager
def full_f32():
    """TF32 off inside, the caller's setting back on exit: the RL
    forwards, updates and maps run under it (as a decorator), so that
    their f32 convolutions and products on the card run in full f32, as
    on the CPU and in the JAX package, without touching other models."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def init_orthogonal(module: nn.Module, gen: torch.Generator,
                    gain: float = 1.0) -> None:
    """Orthogonal weight (over its flattened fan-in), zero bias."""
    w = module.weight
    flat = torch.empty(w.shape[0], w[0].numel())
    nn.init.orthogonal_(flat, gain=gain, generator=gen)
    with torch.no_grad():
        w.copy_(flat.view_as(w))
        if getattr(module, "bias", None) is not None:
            module.bias.zero_()


def _conv_out(size: int, kernel: int, stride: int) -> int:
    return (size - kernel) // stride + 1


class SimpleCNN(nn.Module):
    """3-conv visual encoder (simple_cnn.py:44-99): [..., H, W, 3] uint8
    or float RGB -> [..., output_size]."""

    def __init__(self, image_hw: Sequence[int] = (64, 64),
                 output_size: int = 512):
        super().__init__()
        h, w = image_hw
        for k, s in ((8, 4), (4, 2), (3, 1)):
            h, w = _conv_out(h, k, s), _conv_out(w, k, s)
        self.Conv_0 = nn.Conv2d(3, 32, 8, 4)
        self.Conv_1 = nn.Conv2d(32, 64, 4, 2)
        self.Conv_2 = nn.Conv2d(64, 32, 3, 1)
        self.Dense_0 = nn.Linear(32 * h * w, output_size)

    def forward(self, rgb: torch.Tensor) -> torch.Tensor:
        lead = rgb.shape[:-3]
        x = (rgb.float() / 255.0).reshape((-1,) + tuple(rgb.shape[-3:]))
        x = x.permute(0, 3, 1, 2)
        x = F.relu(self.Conv_0(x))
        x = F.relu(self.Conv_1(x))
        x = self.Conv_2(x)
        x = x.permute(0, 2, 3, 1).reshape(lead + (-1,))    # HWC order
        return F.relu(self.Dense_0(x))


class GRUCell(nn.Module):
    """h' = (1 - z) * n + z * h, n = tanh(W_in x + r * (W_hn h + b_hn))."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.ih = nn.Linear(input_size, 3 * hidden_size)
        self.hh = nn.Linear(hidden_size, 3 * hidden_size)

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        i_r, i_z, i_n = self.ih(x).chunk(3, dim=-1)
        h_r, h_z, h_n = self.hh(h).chunk(3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        return (1.0 - z) * n + z * h


class GRUStateEncoder(nn.Module):
    """Masked recurrent state encoder.

    Single step: x [N, D], h [N, H], masks [N] -> (feat [N, H], h').
    Sequence:    x [T, N, D], h0 [N, H], masks [T, N] -> ([T, N, H], hT),
    mask 0 zeroing the carried hidden state (an episode start)."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.GRUCell_0 = GRUCell(input_size, hidden_size)

    def forward(self, x, h, masks):
        if x.dim() == 2:
            h = self.GRUCell_0(x, h * masks[:, None])
            return h, h
        feats = []
        for t in range(x.shape[0]):
            h = self.GRUCell_0(x[t], h * masks[t][:, None])
            feats.append(h)
        return torch.stack(feats), h


class PointNavBaselineNet(nn.Module):
    """CNN (unless blind) + goal vector concat + GRU (policy.py:117-181)."""

    def __init__(self, hidden_size: int = 512, blind: bool = True,
                 goal_uuid: str = GOAL_UUID, goal_dim: int = 2,
                 image_hw: Sequence[int] = (64, 64)):
        super().__init__()
        self.blind = blind
        self.goal_uuid = goal_uuid
        if not blind:
            self.SimpleCNN_0 = SimpleCNN(image_hw, hidden_size)
        self.GRUStateEncoder_0 = GRUStateEncoder(
            goal_dim + (0 if blind else hidden_size), hidden_size)

    def forward(self, observations: Dict[str, torch.Tensor], hidden, masks):
        xs = [observations[self.goal_uuid].float()]
        if not self.blind:
            xs = [self.SimpleCNN_0(observations["rgb"])] + xs
        return self.GRUStateEncoder_0(torch.cat(xs, dim=-1), hidden, masks)


def sample_actions(logits: torch.Tensor,
                   generator: Optional[torch.Generator]) -> torch.Tensor:
    """One categorical draw a row by Gumbel-max (the form
    `jax.random.categorical` takes), from `generator` on the logits'
    device; no host sync."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(u.clamp(min=tiny)))
    return torch.argmax(logits + gumbel, dim=-1)


def action_outputs(logits, values, generator, deterministic: bool):
    """(value, action, log_prob) of one step's logits [N, A]."""
    log_probs = F.log_softmax(logits, dim=-1)
    action = torch.argmax(logits, dim=-1) if deterministic else \
        sample_actions(logits, generator)
    lp = log_probs.gather(-1, action[:, None])[:, 0]
    return values, action, lp


def sequence_outputs(logits, values, actions):
    """(values, log_probs of `actions`, mean entropy) of [T, N, A]."""
    log_probs = F.log_softmax(logits, dim=-1)
    lp = log_probs.gather(-1, actions.long()[..., None])[..., 0]
    entropy = -(log_probs.exp() * log_probs).sum(-1).mean()
    return values, lp, entropy


class PointNavPolicy(nn.Module):
    """Actor-critic with a categorical action head (policy.py:21-75);
    heads initialised as CategoricalNet (gain 0.01) and CriticHead."""

    def __init__(self, dim_actions: int, hidden_size: int = 512,
                 blind: bool = True, goal_uuid: str = GOAL_UUID,
                 goal_dim: int = 2, image_hw: Sequence[int] = (64, 64),
                 seed: int = 0):
        super().__init__()
        self.dim_actions = dim_actions
        self.hidden_size = hidden_size
        self.blind = blind
        self.net = PointNavBaselineNet(hidden_size, blind, goal_uuid,
                                       goal_dim, image_hw)
        self.action_head = nn.Linear(hidden_size, dim_actions)
        self.critic = nn.Linear(hidden_size, 1)
        self.reset_parameters(seed)

    def reset_parameters(self, seed: int) -> None:
        gen = torch.Generator().manual_seed(seed)
        for name, m in self.named_modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                gain = {"action_head": 0.01, "critic": 1.0}.get(
                    name, math.sqrt(2.0) if "SimpleCNN" in name else 1.0)
                init_orthogonal(m, gen, gain)

    @full_f32()
    def forward(self, observations, hidden, masks):
        feats, hidden = self.net(observations, hidden, masks)
        return self.action_head(feats), self.critic(feats)[..., 0], hidden

    def act(self, observations, hidden, prev_actions, masks,
            generator: Optional[torch.Generator] = None,
            deterministic: bool = False):
        """One env step: (value [N], action [N], log_prob [N], hidden')."""
        del prev_actions              # the baseline net ignores them
        logits, value, hidden = self(observations, hidden, masks)
        return action_outputs(logits, value, generator, deterministic) + \
            (hidden,)

    def get_value(self, observations, hidden, prev_actions, masks):
        del prev_actions
        return self(observations, hidden, masks)[1]

    def evaluate_actions(self, observations, hidden, prev_actions, masks,
                         actions) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
        """Sequence forward over [T, N]: values, log-probs of `actions`,
        mean entropy (policy.py:62-75)."""
        del prev_actions
        logits, values, _ = self(observations, hidden, masks)
        return sequence_outputs(logits, values, actions)


def make_policy(obs_space, dim_actions: int, hidden_size: int,
                blind: bool = True, seed: int = 0) -> PointNavPolicy:
    """A `PointNavPolicy` sized from an observation space: the goal
    vector's width and, unless blind, the RGB frame's height and width."""
    spaces = obs_space.spaces
    image_hw = tuple(spaces["rgb"].shape[:2]) if "rgb" in spaces else (64, 64)
    return PointNavPolicy(dim_actions, hidden_size, blind,
                          goal_dim=int(spaces[GOAL_UUID].shape[-1]),
                          image_hw=image_hw, seed=seed)
