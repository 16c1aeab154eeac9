"""Habitat PPO checkpoint -> the port's PointNav policy.

Counterpart of the JAX package's `rl/convert.py`: the reference trainer's
torch `state_dict` (habitat_baselines PointNavBaselinePolicy:
`net.visual_encoder.cnn.*`, `net.state_encoder.rnn.*`,
`action_distribution.linear`, `critic.fc`; ppo_trainer.py stores it under
"state_dict" with an `actor_critic.` prefix) onto `rl/policy.py`'s module
names. torch's own layouts need no transposes here: conv [O, I, kh, kw],
linear [O, I], and the GRU's packed r|z|n rows, which `GRUCell.ih` /
`GRUCell.hh` keep.

The visual fc (`net.visual_encoder.cnn.6.weight`) is loaded as it is, as
the JAX package loads it: the reference flattens its last conv map in
CHW order, `SimpleCNN` flattens it in HWC order, and neither package
reorders the fc's columns. A reference RGB checkpoint therefore does not
reproduce the reference's forward in either package; the port keeps the
JAX package's behaviour (a divergence of the JAX package from the
reference, not fixed here). Blind checkpoints are exact.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

__all__ = ["convert_pointnav_policy", "load_habitat_checkpoint"]

_GRU = "net.GRUStateEncoder_0.GRUCell_0"


def convert_pointnav_policy(state_dict: Dict[str, np.ndarray],
                            blind: bool = True) -> Dict[str, torch.Tensor]:
    """torch state_dict -> state dict of `rl.policy.PointNavPolicy`."""
    sd = {k.replace("actor_critic.", ""): np.asarray(v, np.float32)
          for k, v in state_dict.items()}
    out = {}

    def put(name, value):
        out[name] = torch.from_numpy(np.array(value))

    for gate in ("ih", "hh"):
        put(f"{_GRU}.{gate}.weight",
            sd[f"net.state_encoder.rnn.weight_{gate}_l0"])
        put(f"{_GRU}.{gate}.bias", sd[f"net.state_encoder.rnn.bias_{gate}_l0"])
    if not blind:
        # SimpleCNN (net.visual_encoder.cnn.{0,2,4} convs + .6 linear)
        for i, torch_i in ((0, 0), (1, 2), (2, 4)):
            for leaf in ("weight", "bias"):
                put(f"net.SimpleCNN_0.Conv_{i}.{leaf}",
                    sd[f"net.visual_encoder.cnn.{torch_i}.{leaf}"])
        for leaf in ("weight", "bias"):
            put(f"net.SimpleCNN_0.Dense_0.{leaf}",
                sd[f"net.visual_encoder.cnn.6.{leaf}"])
    for leaf in ("weight", "bias"):
        put(f"action_head.{leaf}", sd[f"action_distribution.linear.{leaf}"])
        put(f"critic.{leaf}", sd[f"critic.fc.{leaf}"])
    return out


def load_habitat_checkpoint(path: str,
                            blind: bool = True) -> Dict[str, torch.Tensor]:
    """Load a habitat ppo_trainer checkpoint (.pth) and convert."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    sd = blob.get("state_dict", blob)
    sd = {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v)
          for k, v in sd.items()}
    return convert_pointnav_policy(sd, blind=blind)
