"""Checkpoint and resume.

Counterpart of the checkpoint half of the JAX package's
`engine/checkpoint.py`: `ckpt_%07d` files under the output directory that
hold the model's state dict, the optimizer's state and the step, written
with `torch.save` to a temporary name and renamed, so a crash mid-write
leaves no checkpoint that `latest_checkpoint` would pick. The memory h5
snapshots wait for the h5 dataset.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from ..parallel.train_step import TrainState


def save_checkpoint(directory: str, step: int, state: TrainState) -> str:
    """Write `state` as `<directory>/ckpt_<step>`, replacing one of the
    same step."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.abspath(os.path.join(directory, f"ckpt_{step:07d}"))
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save({"model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "step": int(state.step)}, tmp)
    os.replace(tmp, path)
    return path


def restore_checkpoint(path: str, template: TrainState) -> TrainState:
    """Load the checkpoint at `path` into the model and optimizer of
    `template` (in place, on their device) and return its state."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    template.model.load_state_dict(ckpt["model"])
    template.optimizer.load_state_dict(ckpt["optimizer"])
    return template._replace(step=int(ckpt["step"]))


def latest_checkpoint(directory: str) -> Optional[str]:
    if not os.path.isdir(directory):
        return None
    cands = sorted(x for x in os.listdir(directory)
                   if x.startswith("ckpt_") and "tmp" not in x)
    return os.path.join(directory, cands[-1]) if cands else None


class PeriodicCheckpointer:
    """Save every `period` iterations (never when period <= 0) and at the
    last iteration."""

    def __init__(self, directory: str, period: int, max_iter: int):
        self.directory = directory
        self.period = period
        self.max_iter = max_iter

    def step(self, iteration: int, state: TrainState) -> None:
        periodic = self.period > 0 and (iteration + 1) % self.period == 0
        if periodic or iteration + 1 == self.max_iter:
            save_checkpoint(self.directory, iteration + 1, state)
